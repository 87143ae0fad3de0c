"""The port's multi-process entry point
(``bayesbridge_tpu_torch.parallel.distributed``) on the CPU.

Two processes join one gloo process group, build the 2-entry global mesh,
hand over only their own rows (``host_local_to_global``: the design's row
block, the outcome's rows) and run 3 Gibbs iterations of a float64 logit
chain. Both must hold the same bits, equal to one process running the
same two shards (``shard_model`` on ``[cpu, cpu]``), and within 1e-10 of
the unsharded chain. This file is its own worker: run as a script it is
one process of the job,

    python tests/test_torch_distributed.py RANK WORLD_SIZE PORT

In one process, ``initialize_multihost()`` does nothing and the entry
points' 2-d options raise.
"""

import hashlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bayesbridge_tpu_torch import (  # noqa: E402
    BayesBridge, RegressionCoefPrior,
)
from bayesbridge_tpu_torch.design import SparseDesignMatrix  # noqa: E402
from bayesbridge_tpu_torch.design.sharded import row_bounds  # noqa: E402
from bayesbridge_tpu_torch.models.logistic import LogisticModel  # noqa: E402
from bayesbridge_tpu_torch.parallel import (  # noqa: E402
    distributed, make_mesh, shard_model,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

N_OBS, N_ITER, SEED = 96, 3, 5
# Each worker's own limit; the rendezvous is retried with a fresh port.
WORKER_TIMEOUT_S = 120


def _data():
    """The same design and outcome in every process (a shared input
    pipeline; each process then keeps its rows)."""
    import scipy.sparse as sps
    rng = np.random.default_rng(0)
    bits = (rng.uniform(size=(N_OBS, 12)) < .3).astype(np.float64)
    vals = rng.standard_normal((N_OBS, 6)) * (rng.uniform(size=(N_OBS, 6))
                                              < .5)
    X = sps.csr_matrix(np.hstack([bits, vals]))
    beta = np.zeros(X.shape[1])
    beta[:3] = 1.
    y = (rng.uniform(size=N_OBS) < 1 / (1 + np.exp(-(X @ beta)))) * 1.
    design = SparseDesignMatrix(X, center_predictor=True, dtype=np.float64,
                                device='cpu')
    return design, y


def _run(model):
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    samples, _ = bridge.gibbs(N_ITER, seed=SEED, coef_sampler_type='cg',
                              params_to_save=('coef', 'logp'))
    return samples


def _digest(samples):
    h = hashlib.sha256()
    for key in sorted(samples):
        h.update(np.ascontiguousarray(samples[key]).tobytes())
    return h.hexdigest()


def _worker(rank, world, port):
    distributed.initialize_multihost(f'tcp://127.0.0.1:{port}', world, rank,
                                     device='cpu')
    distributed.initialize_multihost(f'tcp://127.0.0.1:{port}', world, rank,
                                     device='cpu')  # idempotent
    print(f'WORKER_STAGE rank={rank} rendezvous-done', flush=True)
    mesh = distributed.global_mesh()
    assert mesh.size == world and mesh.local_indices() == [rank]
    design, y = _data()
    r0, r1 = row_bounds(N_OBS, world)[rank]
    sharded = distributed.host_local_to_global(design.row_block(r0, r1),
                                               mesh)
    assert sharded.shards[rank] is not None
    assert all(s is None for i, s in enumerate(sharded.shards) if i != rank)
    y_all = distributed.host_local_to_global(y[r0:r1], mesh)
    assert isinstance(y_all, np.ndarray) and np.array_equal(y_all, y)
    samples = _run(LogisticModel(y_all, np.ones(N_OBS), sharded))
    coef = samples['coef'][:, -1]
    print(f'WORKER_OK rank={rank} digest={_digest(samples)} '
          f'coef={",".join(repr(float(c)) for c in coef)}', flush=True)
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _two_workers():
    env = {k: v for k, v in os.environ.items()
           if k not in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK')}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), '2',
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return procs, outs


def test_two_process_gloo_run_gives_every_rank_the_same_bits():
    # A rendezvous can flake on a loaded host (both workers must connect
    # within gloo's window): retried with a fresh port and a backoff.
    for attempt in range(3):
        try:
            procs, outs = _two_workers()
        except subprocess.TimeoutExpired:
            if attempt == 2:
                raise
            time.sleep(5 * (attempt + 1))
            continue
        if all(p.returncode == 0 for p in procs) or attempt == 2:
            break
        time.sleep(5 * (attempt + 1))
    lines = {}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {rank} failed:\n{out[-4000:]}'
        line = [ln for ln in out.splitlines()
                if f'WORKER_OK rank={rank}' in ln]
        assert line, out[-4000:]
        lines[rank] = dict(kv.split('=', 1) for kv in
                           line[0].split('WORKER_OK ')[1].split())
    assert lines[0]['digest'] == lines[1]['digest']

    design, y = _data()
    one = LogisticModel(y, np.ones(N_OBS), design)
    two = shard_model(LogisticModel(y, np.ones(N_OBS), design),
                      make_mesh(devices=[torch.device('cpu')] * 2))
    # One process running the same two shards: the same bits.
    assert _digest(_run(two)) == lines[0]['digest']
    ref = _run(one)['coef'][:, -1]
    got = np.array([float(c) for c in lines[0]['coef'].split(',')])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_single_process_entry_points():
    distributed.initialize_multihost()  # nothing to join: a no-op
    assert not torch.distributed.is_initialized()
    mesh = distributed.global_mesh(local_devices=[torch.device('cpu')] * 2)
    assert mesh.size == 2 and mesh.group is None
    with pytest.raises(NotImplementedError, match='15b'):
        distributed.global_mesh(pred_shards=2)
    design, y = _data()
    sharded = distributed.host_local_to_global(design, mesh)
    assert sharded.n_shards == 2 and sharded.shape == design.shape
    assert distributed.host_local_to_global(y, mesh) is y
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='is_available'):
            distributed.initialize_multihost('tcp://127.0.0.1:1', 1, 0)
        assert not torch.distributed.is_initialized()


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
