"""The hand-written CUDA kernels on the card (marker ``cuda``).

These need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on a
machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
tensors: rtol 1e-4 of max|plain| (the two sum in different orders), and
a small chain on the card must resume exactly, on the hybrid backend and
on the bitpack and winell backends' composed path.
"""

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch.kernels import layout, launch_counts, \
    reset_launch_counts
from bayesbridge_tpu_torch.kernels.bitlut import bitlut, bitlut_plain
from bayesbridge_tpu_torch.kernels.winell import winell, winell_plain
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


@pytest.mark.parametrize('g_pad,m_pad,n_out', [(8, 128, 1), (40, 384, 300),
                                                (200, 8320, 8200)])
@pytest.mark.parametrize('tag', ['dot', 'tdot'])
def test_bitlut_kernel_matches_plain(dev, g_pad, m_pad, n_out, tag):
    """Ragged shapes: byte-groups not a multiple of 32, outputs not a
    multiple of 128; two launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(2)
    bits = torch.randint(0, 256, (g_pad, m_pad), generator=g, device=dev,
                         dtype=torch.uint8)
    v = torch.randn(8 * g_pad, generator=g, device=dev)
    reset_launch_counts()
    got = bitlut(bits, v, n_out, tag)
    again = bitlut(bits, v, n_out, tag)
    assert launch_counts()[f'bitlut[{tag}]'] == 2
    _assert_close([got], [bitlut_plain(bits, v, n_out)])
    assert torch.equal(got, again)


@pytest.mark.parametrize('square', [False, True])
@pytest.mark.parametrize('transpose', [False, True])
def test_winell_kernel_matches_plain(dev, transpose, square):
    """A packing with overfull cells (its spill is the design's, not the
    kernel's) and a ragged output tile."""
    import scipy.sparse as sps
    from bayesbridge_tpu_torch.design.winell import pack_winell, \
        plan_windows
    rng = np.random.default_rng(3)
    n, p = 1037, 613
    X = rng.standard_normal((n, p)) * (rng.random((n, p)) < .03)
    X[::50, :200] = rng.standard_normal((len(range(0, n, 50)), 200))
    X[:300, ::40] = rng.standard_normal((300, len(range(0, p, 40))))
    X = sps.csr_matrix(X.T if transpose else X)
    n_out, n_in = X.shape
    W, K = plan_windows(n_in, n_out, X.nnz)
    idx, val, spill = pack_winell(X, W, K)
    assert spill is not None
    idx, val = torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)
    v = torch.from_numpy(rng.standard_normal(n_in).astype(np.float32)).to(dev)
    got = winell(idx, val, v, n_out, W, K, square)
    again = winell(idx, val, v, n_out, W, K, square)
    _assert_close([got], [winell_plain(idx, val, v, n_out, W, K, square)])
    assert torch.equal(got, again)


def _chain_problem():
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome,
    )
    X = simulate_design(500, 60, binary_frac=.9, seed=1)
    outcome = simulate_outcome(X, np.r_[np.ones(3), np.zeros(57)], 'logit',
                               seed=2)
    return X, outcome


@pytest.mark.parametrize('backend', ['hybrid', 'bitpack', 'winell'])
def test_chain_resumes_exactly_on_card(dev, backend):
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    X, outcome = _chain_problem()
    bridge = BayesBridge(RegressionModel(outcome, X, family='logit',
                                         backend=backend),
                         RegressionCoefPrior(bridge_exponent=.5))
    reset_launch_counts()
    full, _ = bridge.gibbs(12, seed=0, coef_sampler_type='cg',
                           params_to_save='all')
    counts = launch_counts()
    kern = {'hybrid': 'ne_sweep', 'bitpack': 'bitlut',
            'winell': 'winell'}[backend]
    if backend == 'hybrid':
        assert counts['ne_sweep[ne]'] > 12 and counts['tdots_sweep'] == 12
    else:
        assert counts[f'{kern}[dot]'] > 12 and counts[f'{kern}[tdot]'] > 12
    part, info = bridge.gibbs(7, seed=0, coef_sampler_type='cg',
                              params_to_save='all')
    merged, _ = bridge.gibbs_resume(info, 5, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
