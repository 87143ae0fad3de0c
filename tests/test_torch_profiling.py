"""``bayesbridge_tpu_torch.utils.profiling`` on the CPU: ``trace`` writes
its Chrome trace (and a nested call records nothing of its own),
``annotate`` names a region, and ``op_stats_from_trace`` reads the
capture back into rows with the JAX package's keys
(bayesbridge_tpu/utils/profiling.py:54-118); torch's profiler measures no
FLOP rate, bandwidth or bound, so those are None, and a CPU run has no
device rows."""

import json
import os

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch.utils.profiling import (
    TRACE_FILE, annotate, op_stats_from_trace, trace,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

ROW_KEYS = {'device', 'type', 'name', 'occurrences', 'total_us', 'self_us',
            'flop_rate_gflops', 'memory_bw_gbps', 'bound_by'}


def test_trace_writes_artifacts_and_rows(tmp_path):
    outer, inner = tmp_path / 'outer', tmp_path / 'inner'
    with trace(str(outer)) as prof:
        assert prof is not None
        with trace(str(inner)) as nested:
            assert nested is None  # reentrant: the outer block records
        with annotate('test-region'):
            for _ in range(3):
                torch.ones((32, 32)) @ torch.ones((32, 32))
    assert os.path.exists(outer / TRACE_FILE) and not inner.exists()
    with open(outer / TRACE_FILE) as f:
        assert json.load(f)['traceEvents']
    rows = op_stats_from_trace(str(outer), device_only=False)
    assert rows and all(set(r) == ROW_KEYS for r in rows)
    assert all(r['flop_rate_gflops'] is r['memory_bw_gbps'] is r['bound_by']
               is None for r in rows)
    by_name = {r['name']: r for r in rows}
    assert by_name['test-region']['occurrences'] == 1
    mm = by_name['aten::mm']
    assert mm['occurrences'] == 3 and not mm['device']
    assert 0 <= mm['self_us'] <= mm['total_us']
    region = by_name['test-region']
    # The region's own time excludes the ops nested in it.
    assert region['self_us'] < region['total_us']
    assert op_stats_from_trace(str(outer)) == []  # no device rows here
    assert [r['total_us'] for r in rows] == sorted(
        (r['total_us'] for r in rows), reverse=True)


def test_trace_of_a_gibbs_window(tmp_path):
    """A sampler window traced as chip_smoke.py traces its windows."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome,
    )
    X = simulate_design(100, 10, binary_frac=.7, seed=1)
    beta = np.zeros(10)
    beta[:2] = 1.0
    model = RegressionModel(simulate_outcome(X, beta, 'logit', seed=2), X,
                            family='logit', device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    _, info = bridge.gibbs(3, seed=0, coef_sampler_type='cg')
    with trace(str(tmp_path)):
        with annotate('window'):
            bridge.gibbs_resume(info, 2)
    rows = op_stats_from_trace(str(tmp_path), device_only=False)
    names = {r['name'] for r in rows}
    assert 'window' in names and any(n.startswith('aten::') for n in names)


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        op_stats_from_trace(str(tmp_path))
