"""The hand-written CUDA kernels on the card (marker ``cuda``).

These need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on a
machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
tensors: rtol 1e-4 of max|plain| (the two sum in different orders), and
a small chain on the card must resume exactly.
"""

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch.kernels import layout, launch_counts, \
    reset_launch_counts
from bayesbridge_tpu_torch.kernels.ne_sweep import ne_sweep, ne_sweep_plain
from bayesbridge_tpu_torch.kernels.tdots_sweep import (
    tdots_sweep, tdots_sweep_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels cannot run on the CPU)")
    return torch.device('cuda')


def _assert_close(got, ref):
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize('mid', ['ne', 'logit', 'linear'])
def test_ne_sweep_kernel_matches_plain(dev, dtype, mid):
    g = torch.Generator(device=dev).manual_seed(0)
    n, pe, pf = 333, 1000, 77
    Xe = (torch.randn((n, layout.padded_width(pe)), generator=g,
                      device=dev) * 2).round().to(dtype)
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    vs = [torch.randn(p, generator=g, device=dev) for p in (pe, pf)]
    a = (torch.rand(n, generator=g, device=dev) < .5).float()
    b = torch.rand(n, generator=g, device=dev) + .5
    c = torch.randn((), generator=g, device=dev)
    blocks = [(Xe, vs[0]), (Xf, vs[1])]
    a_ = None if mid == 'ne' else a
    lp = mid != 'ne'
    reset_launch_counts()
    got = ne_sweep(blocks, c, a_, b, mid, lp)
    assert launch_counts()[f'ne_sweep[{mid}]'] == 1
    ref = ne_sweep_plain(blocks, c, a_, b, mid, lp)
    _assert_close(got[0], ref[0])
    _assert_close([got[1]], [ref[1]])
    if lp:
        _assert_close([got[2]], [ref[2]])


def test_tdots_kernel_matches_plain_and_is_deterministic(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    n, pe, pf = 5000, 3000, 100
    Xe = (torch.rand((n, layout.padded_width(pe)), generator=g,
                     device=dev) < .1).to(torch.int8)
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    us = [torch.randn(n, generator=g, device=dev) for _ in range(3)]
    got = tdots_sweep([Xe, Xf], [pe, pf], *us)
    again = tdots_sweep([Xe, Xf], [pe, pf], *us)
    ref = tdots_sweep_plain([Xe, Xf], [pe, pf], *us)
    flat = [o for blk in got for o in blk]
    _assert_close(flat, [o for blk in ref for o in blk])
    for x, y in zip(flat, [o for blk in again for o in blk]):
        assert torch.equal(x, y)


def test_chain_resumes_exactly_on_card(dev):
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome,
    )
    X = simulate_design(500, 60, binary_frac=.9, seed=1)
    outcome = simulate_outcome(X, np.r_[np.ones(3), np.zeros(57)], 'logit',
                               seed=2)
    bridge = BayesBridge(RegressionModel(outcome, X, family='logit'),
                         RegressionCoefPrior(bridge_exponent=.5))
    full, _ = bridge.gibbs(12, seed=0, coef_sampler_type='cg',
                           params_to_save='all')
    part, info = bridge.gibbs(7, seed=0, coef_sampler_type='cg',
                              params_to_save='all')
    merged, _ = bridge.gibbs_resume(info, 5, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
