"""The port's multi-process entry point
(``bayesbridge_tpu_torch.parallel.distributed``) on the CPU.

Two processes join one gloo process group, build the 2-entry global mesh,
hand over only their own rows (``host_local_to_global``: the design's row
block, the outcome's rows) and run 3 Gibbs iterations of a float64 logit
chain. Both must hold the same bits, equal to one process running the
same two shards (``shard_model`` on ``[cpu, cpu]``), and within 1e-10 of
the unsharded chain. The same on a (2, 2) obs x pred grid
(``global_mesh(pred_shards=2)``, each process bringing two entries, one
mesh row: its rows cut into two column pieces): every rank's bits equal
one process holding all four pieces. This file is its own worker: run as
a script it is one process of the job,

    python tests/test_torch_distributed.py RANK WORLD_SIZE PORT [2d]

In one process, ``initialize_multihost()`` does nothing and
``global_mesh`` builds the mesh over the local devices.
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


def _worker(rank, world, port, two_d=False):
    distributed.initialize_multihost(f'tcp://127.0.0.1:{port}', world, rank,
                                     device='cpu')
    distributed.initialize_multihost(f'tcp://127.0.0.1:{port}', world, rank,
                                     device='cpu')  # idempotent
    print(f'WORKER_STAGE rank={rank} rendezvous-done', flush=True)
    design, y = _data()
    r0, r1 = row_bounds(N_OBS, world)[rank]
    if two_d:
        cpu = torch.device('cpu')
        mesh = distributed.global_mesh(pred_shards=2,
                                       local_devices=[cpu, cpu])
        assert mesh.grid == (world, 2)
        assert mesh.local_indices() == [2 * rank, 2 * rank + 1]
        sharded = distributed.host_local_to_global(
            design.row_block(r0, r1), mesh)
        assert len(sharded.col_pieces) == 2
        mine = [2 * rank, 2 * rank + 1]
    else:
        mesh = distributed.global_mesh()
        assert mesh.size == world and mesh.local_indices() == [rank]
        sharded = distributed.host_local_to_global(
            design.row_block(r0, r1), mesh)
        mine = [rank]
    assert all(sharded.shards[i] is not None for i in mine)
    assert all(s is None for i, s in enumerate(sharded.shards)
               if i not in mine)
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


def _two_workers(extra=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK')}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), '2',
         str(port), *extra], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for rank in range(2)]
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


def _job(extra=()):
    """The two workers' WORKER_OK fields, by rank. A rendezvous can flake
    on a loaded host (both workers must connect within gloo's window):
    retried with a fresh port and a backoff."""
    for attempt in range(3):
        try:
            procs, outs = _two_workers(extra)
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
    return lines


def test_two_process_gloo_run_gives_every_rank_the_same_bits():
    lines = _job()
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


def test_two_process_2d_grid_gives_every_rank_the_one_process_bits():
    """A (2, 2) grid, each process one mesh row of two column pieces:
    both ranks hold the bits of one process holding all four pieces,
    within 1e-10 of the unsharded chain."""
    lines = _job(('2d',))
    assert lines[0]['digest'] == lines[1]['digest']
    design, y = _data()
    grid = make_mesh((2, 2), devices=[torch.device('cpu')] * 4)
    four = shard_model(LogisticModel(y, np.ones(N_OBS), design), grid,
                       pred_axis='pred')
    assert _digest(_run(four)) == lines[0]['digest']
    ref = _run(LogisticModel(y, np.ones(N_OBS), design))['coef'][:, -1]
    got = np.array([float(c) for c in lines[0]['coef'].split(',')])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_single_process_entry_points():
    distributed.initialize_multihost()  # nothing to join: a no-op
    assert not torch.distributed.is_initialized()
    mesh = distributed.global_mesh(local_devices=[torch.device('cpu')] * 2)
    assert mesh.size == 2 and mesh.group is None
    grid = distributed.global_mesh(pred_shards=2, local_devices=[
        torch.device('cpu')] * 4)
    assert grid.shape == {'shard': 2, 'pred': 2} and grid.group is None
    with pytest.raises(ValueError, match='do not divide'):
        distributed.global_mesh(pred_shards=3, local_devices=[
            torch.device('cpu')] * 4)
    design, y = _data()
    sharded = distributed.host_local_to_global(design, mesh)
    assert sharded.n_shards == 2 and sharded.shape == design.shape
    assert distributed.host_local_to_global(y, mesh) is y
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='is_available'):
            distributed.initialize_multihost('tcp://127.0.0.1:1', 1, 0)
        assert not torch.distributed.is_initialized()


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4:] == ['2d'])
