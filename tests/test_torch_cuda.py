"""The hand-written CUDA kernels on the card (marker ``cuda``).

These need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on a
machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
tensors: rtol 1e-4 of max|plain| (the two sum in different orders), and
a small chain on the card must resume exactly, on the hybrid backend
(composed, its default, and fused) and on the bitpack and winell
backends' composed path.
"""

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch.kernels import layout, launch_counts, \
    reset_launch_counts
from bayesbridge_tpu_torch.kernels.bitlut import (
    bitlut, bitlut_plain, bitlut_variant, byte_lut_plain,
)
from bayesbridge_tpu_torch.kernels.wincsr import wincsr, wincsr_plain
from bayesbridge_tpu_torch.kernels.winell import winell, winell_plain
from bayesbridge_tpu_torch.kernels.ne_onepass import (
    A_MODES, B_MODES, ne_onepass, ne_onepass_plain,
)
from bayesbridge_tpu_torch.kernels.ne_oneread import (
    block_plan, ne_oneread, ne_oneread_link,
)
from bayesbridge_tpu_torch.kernels.ne_sweep import (
    colpass, colpass_plain, ne_rows, ne_rows_plain, ne_sweep, ne_sweep_plain,
)
from bayesbridge_tpu_torch.kernels.stream_probe import (
    stream_probe, stream_probe_plain,
)
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
    # The two-pass kernel: mode 'ne' takes the one-read route by default.
    got = ne_sweep(blocks, c, a_, b, mid, lp, route='twopass')
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


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize('two', [False, True])
def test_row_and_column_pass_entries_match_plain(dev, dtype, two):
    """The composed products' kernels: ne_rows (t = X v + c) and colpass
    (X' u), one and two blocks, garbage in the padding columns."""
    g = torch.Generator(device=dev).manual_seed(5)
    n, pe, pf = 1037, 4097, 513
    Xe = (torch.randn((n, layout.padded_width(pe)), generator=g,
                      device=dev) * 2).round().to(dtype)
    Xe[:, pe:] = 7 if dtype == torch.int8 else float('nan')
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    Xf[:, pf:] = float('nan')
    Xs, ps = ([Xe, Xf], [pe, pf]) if two else ([Xe], [pe])
    blocks = [(X, torch.randn(p, generator=g, device=dev))
              for X, p in zip(Xs, ps)]
    c = torch.randn(n, generator=g, device=dev)
    u = torch.randn(n, generator=g, device=dev)
    reset_launch_counts()
    t = ne_rows(blocks, c)
    outs = colpass(Xs, ps, u)
    assert launch_counts()['ne_sweep[rows]'] == 1
    assert launch_counts()['ne_sweep[cols]'] == 1
    _assert_close([t], [ne_rows_plain(blocks, c)])
    _assert_close(outs, colpass_plain(Xs, ps, u))
    assert torch.equal(torch.cat(outs), torch.cat(colpass(Xs, ps, u)))


def test_tdots_fifth_reduction_matches_plain(dev):
    """tdots_sweep with the warm-start column u4 (five reductions)."""
    g = torch.Generator(device=dev).manual_seed(6)
    n, pe, pf = 5000, 3000, 100
    Xe = torch.randint(-3, 4, (n, layout.padded_width(pe)), generator=g,
                       device=dev, dtype=torch.int8)
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    us = [torch.randn(n, generator=g, device=dev) for _ in range(4)]
    reset_launch_counts()
    got = tdots_sweep([Xe, Xf], [pe, pf], *us)
    assert launch_counts()['tdots_sweep[u4]'] == 1
    ref = tdots_sweep_plain([Xe, Xf], [pe, pf], *us)
    assert all(len(blk) == 5 for blk in got)
    _assert_close([o for blk in got for o in blk],
                  [o for blk in ref for o in blk])


@pytest.mark.parametrize('cvt', [False, True])
@pytest.mark.parametrize('b_mode', sorted(B_MODES))
@pytest.mark.parametrize('a_mode', sorted(A_MODES))
def test_ne_onepass_matches_plain(dev, a_mode, b_mode, cvt):
    """Every variant of the one-read sweep, at a ragged shape whose rows
    span many row panels (small panels) and at the default panel; two
    launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(7)
    n, pe, pf = 1037, 4097, 513
    Xe = torch.randint(-3, 4, (n, layout.padded_width(pe)), generator=g,
                       device=dev, dtype=torch.int8)
    Xe[:, pe:] = 5
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    Xf[:, pf:] = float('nan')
    ve = torch.randn(pe, generator=g, device=dev)
    vf = torch.randn(pf, generator=g, device=dev)
    c = torch.randn(n, generator=g, device=dev)
    w = torch.rand(n, generator=g, device=dev) + .1
    ref = ne_onepass_plain(Xe, Xf, ve, vf, c, w, a_mode, b_mode, cvt)
    for panel_bytes in (2048, 64 * 1024):
        reset_launch_counts()
        got = ne_onepass(Xe, Xf, ve, vf, c, w, a_mode, b_mode, cvt,
                         panel_bytes=panel_bytes)
        again = ne_onepass(Xe, Xf, ve, vf, c, w, a_mode, b_mode, cvt,
                           panel_bytes=panel_bytes)
        assert launch_counts()['ne_onepass'] == 2
        _assert_close(got[:2], ref[:2])
        _assert_close([got[2]], [ref[2]])
        for x, y in zip(got, again):
            assert torch.equal(x, y)
    one = ne_onepass(Xe, None, ve, None, c, w, a_mode, b_mode, cvt)
    ref1 = ne_onepass_plain(Xe, None, ve, None, c, w, a_mode, b_mode, cvt)
    assert one[1] is None
    _assert_close([one[0], one[2]], [ref1[0], ref1[2]])


@pytest.mark.parametrize('kind', ['i32', 'cvt', 'mul'])
def test_stream_probe_matches_plain(dev, kind):
    g = torch.Generator(device=dev).manual_seed(8)
    n, p = 96, 2048
    X8 = torch.randint(-128, 128, (n, p), generator=g, device=dev,
                       dtype=torch.int8)
    X = X8.view(torch.int32) if kind == 'i32' else X8
    v = torch.randn(p, generator=g, device=dev) if kind == 'mul' else None
    seed = torch.tensor(3.0, device=dev)
    reset_launch_counts()
    got = stream_probe(X, seed, kind, v)
    assert launch_counts()[f'stream_probe[{kind}]'] == 1
    ref = stream_probe_plain(X, seed, kind, v)
    # i32: the wrapped row sums are exact, their float32 total is summed in
    # another order (rows up to 2**31 each).
    scale = n * 2.0 ** 31 if kind == 'i32' else max(abs(float(ref)), 1.0)
    assert abs(float(got) - float(ref)) <= 1e-6 * scale


@pytest.mark.parametrize('g_pad,m_pad,n_out', [(8, 128, 1), (40, 384, 300),
                                                (200, 8320, 8200),
                                                (23_000, 8320, 8200)])
@pytest.mark.parametrize('tag', ['dot', 'tdot'])
def test_bitlut_kernel_matches_plain(dev, g_pad, m_pad, n_out, tag):
    """Ragged shapes: byte-groups not a multiple of 32, outputs not a
    multiple of 128, and (23,000 groups) more table chunks per block than
    the stage ring holds; two launches give the same bits."""
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


@pytest.mark.parametrize('mode', ['byte', 'nibble_l2'])
def test_bitlut_modes_match_plain(dev, mode):
    """The source's other modes compute the same function: the first
    design's byte tables (in their own order) and the nibble tables read
    from L2; no launch is counted."""
    g = torch.Generator(device=dev).manual_seed(9)
    g_pad, m_pad, n_out = 2000, 8320, 8200
    bits = torch.randint(0, 256, (g_pad, m_pad), generator=g, device=dev,
                         dtype=torch.uint8)
    v = torch.randn(8 * g_pad, generator=g, device=dev)
    reset_launch_counts()
    got = bitlut_variant(bits, v, n_out, mode)
    assert launch_counts()['bitlut[dot]'] == 0
    tables = byte_lut_plain if mode == 'byte' else None
    ref = bitlut_plain(bits, v, n_out, *([tables] if tables else []))
    _assert_close([got], [ref])
    assert torch.equal(got, bitlut_variant(bits, v, n_out, mode))


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


@pytest.mark.parametrize('square', [False, True])
@pytest.mark.parametrize('window', [None, 64])
@pytest.mark.parametrize('transpose', [False, True])
def test_wincsr_kernel_matches_plain(dev, transpose, window, square):
    """Ragged rows (empty ones too), one window or many (64 inputs); two
    runs give the same bits."""
    import scipy.sparse as sps
    from bayesbridge_tpu_torch.design.wincsr import build_wincsr
    rng = np.random.default_rng(7)
    n, p = 1037, 613
    X = rng.standard_normal((n, p)) * (rng.random((n, p)) < .03)
    X[::50, :200] = rng.standard_normal((len(range(0, n, 50)), 200))
    X[100:140] = 0.0
    X = sps.csr_matrix(X.T if transpose else X)
    m = build_wincsr(X, window).to(dev)
    v = torch.from_numpy(rng.standard_normal(X.shape[1]).astype(np.float32))
    v = v.to(dev)
    reset_launch_counts()
    got = wincsr(m, v, square, 'tdot')
    again = wincsr(m, v, square, 'tdot')
    assert launch_counts()['wincsr[tdot]'] == 2
    _assert_close([got], [wincsr_plain(m, v, square)])
    assert torch.equal(got, again)


@pytest.mark.parametrize('pair', ['int8+f32', 'bf16+f32', 'int8', 'f32'])
def test_ne_oneread_matches_plain(dev, pair):
    """Every block pair of the hybrid design, ragged rows (the last panel
    partial) and columns, NaN in the float padding; two runs give the
    same bits, and ne_sweep('ne') routes here."""
    g = torch.Generator(device=dev).manual_seed(5)
    n, pe, pf = 1037, 4097, 513
    kinds = pair.split('+')
    dtypes = {'int8': torch.int8, 'bf16': torch.bfloat16,
              'f32': torch.float32}
    blocks = []
    for kind, p in zip(kinds, (pe, pf)):
        X = (torch.randn((n, layout.padded_width(p)), generator=g,
                         device=dev) * 2).round()
        if kind != 'int8':
            X[:, p:] = float('nan')
        blocks.append((X.to(dtypes[kind]),
                       torch.randn(p, generator=g, device=dev)))
    c = torch.randn(n, generator=g, device=dev)
    w = torch.rand(n, generator=g, device=dev) + .5
    assert block_plan(blocks) is not None
    reset_launch_counts()
    got = ne_oneread(blocks, c, w)
    again = ne_oneread(blocks, c, w)
    routed = ne_sweep(blocks, c, None, w, 'ne')
    counts = launch_counts()
    assert counts['ne_oneread'] == 3 and counts['ne_sweep[ne]'] == 0
    ref = ne_sweep_plain(blocks, c, None, w, 'ne')
    _assert_close(got[0], ref[0])
    _assert_close([got[1]], [ref[1]])
    assert all(torch.equal(x, y) for x, y in zip(got[0], again[0]))
    assert torch.equal(got[1], again[1])
    assert all(torch.equal(x, y) for x, y in zip(got[0], routed[0]))
    two = ne_sweep(blocks, c, None, w, 'ne', route='twopass')
    assert launch_counts()['ne_sweep[ne]'] == 1
    _assert_close(two[0], ref[0])


@pytest.mark.parametrize('logp', [False, True])
@pytest.mark.parametrize('mid', ['logit', 'linear'])
@pytest.mark.parametrize('pair', ['int8+f32', 'bf16+f32', 'int8', 'f32'])
def test_ne_oneread_link_matches_plain(dev, pair, mid, logp):
    """The link modes of the one-read kernel on every block pair, ragged
    rows and columns, NaN in the float padding; two runs give the same
    bits, and ne_sweep routes the mode here."""
    g = torch.Generator(device=dev).manual_seed(11)
    n, pe, pf = 1037, 4097, 513
    kinds = pair.split('+')
    dtypes = {'int8': torch.int8, 'bf16': torch.bfloat16,
              'f32': torch.float32}
    blocks = []
    for kind, p in zip(kinds, (pe, pf)):
        X = (torch.randn((n, layout.padded_width(p)), generator=g,
                         device=dev) * 2).round()
        if kind != 'int8':
            X[:, p:] = float('nan')
        blocks.append((X.to(dtypes[kind]),
                       0.03 * torch.randn(p, generator=g, device=dev)))
    c = torch.randn(n, generator=g, device=dev)
    a = (torch.rand(n, generator=g, device=dev) < .5).float()
    b = torch.rand(n, generator=g, device=dev) + .5
    reset_launch_counts()
    got = ne_oneread_link(blocks, c, a, b, mid, logp)
    again = ne_oneread_link(blocks, c, a, b, mid, logp)
    routed = ne_sweep(blocks, c, a, b, mid, logp)
    counts = launch_counts()
    assert counts[f'ne_oneread[{mid}]'] == 3
    assert counts[f'ne_sweep[{mid}]'] == 0 and counts['ne_oneread'] == 0
    ref = ne_sweep_plain(blocks, c, a, b, mid, logp)
    _assert_close(got[0], ref[0])
    _assert_close([got[1]], [ref[1]])
    if logp:
        _assert_close([got[2]], [ref[2]])
        assert torch.equal(got[2], again[2])
    else:
        assert got[2] is None
    assert all(torch.equal(x, y) for x, y in zip(got[0], again[0]))
    assert torch.equal(got[1], again[1])
    assert all(torch.equal(x, y) for x, y in zip(got[0], routed[0]))


def test_map_search_launches_oneread_link(dev):
    """The fused hybrid design's MAP search runs one one-read link sweep
    per objective evaluation and no two-pass one; composed, neither."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    X, outcome = _chain_problem()
    for fused in ('1', '0'):
        bridge = BayesBridge(RegressionModel(outcome, X, family='logit',
                                             fused=fused),
                             RegressionCoefPrior(bridge_exponent=.5))
        bridge.rg.set_seed(0)
        reset_launch_counts()
        info = bridge.initialize_chain({'global_scale': 0.1}, 0.5)[5]
        counts = launch_counts()
        n_eval = info['n_design_matvec'] // 2
        assert n_eval > 0 and counts['ne_sweep[logit]'] == 0
        assert counts['ne_oneread[logit]'] == (n_eval if fused == '1'
                                               else 0)


def _chain_problem():
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome,
    )
    X = simulate_design(500, 60, binary_frac=.9, seed=1)
    outcome = simulate_outcome(X, np.r_[np.ones(3), np.zeros(57)], 'logit',
                               seed=2)
    return X, outcome


@pytest.mark.parametrize('backend', ['hybrid', 'hybrid_fused', 'bitpack',
                                     'winell'])
def test_chain_resumes_exactly_on_card(dev, backend):
    """'hybrid' runs the composed path (the default policy), 'hybrid_fused'
    the fused sweeps (fused='1')."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    X, outcome = _chain_problem()
    fused = '1' if backend == 'hybrid_fused' else None
    bridge = BayesBridge(RegressionModel(outcome, X, family='logit',
                                         backend=backend.split('_')[0],
                                         fused=fused),
                         RegressionCoefPrior(bridge_exponent=.5))
    reset_launch_counts()
    full, _ = bridge.gibbs(12, seed=0, coef_sampler_type='cg',
                           params_to_save='all')
    counts = launch_counts()
    kern = {'bitpack': 'bitlut', 'winell': 'wincsr'}.get(backend)
    if backend == 'hybrid':
        assert counts['ne_sweep[rows]'] > 12 and counts['ne_sweep[cols]'] > 12
        assert counts['tdots_sweep[u4]'] == 12
        assert counts['ne_sweep[ne]'] == counts['tdots_sweep'] == 0
        assert counts['ne_oneread'] == 0
    elif backend == 'hybrid_fused':
        assert counts['ne_oneread'] > 12 and counts['tdots_sweep'] == 12
        assert counts['ne_sweep[ne]'] == 0
    else:
        assert counts[f'{kern}[dot]'] > 12 and counts[f'{kern}[tdot]'] > 12
    part, info = bridge.gibbs(7, seed=0, coef_sampler_type='cg',
                              params_to_save='all')
    merged, _ = bridge.gibbs_resume(info, 5, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
