"""The hand-written CUDA kernels on the card (marker ``cuda``).

These need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on a
machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
tensors: rtol 1e-4 of max|plain| (the two sum in different orders), and
a small chain on the card must resume exactly, on the hybrid backend
(composed, its default, and fused), on the bitpack and winell backends'
composed path and on the dense design (Cholesky and CG, float32 and
float64). A float64 tensor at a kernel wrapper raises, and the float32
Gram stays full float32 with TF32 allowed. The chain-batched kernels
(``ne_rows_k``, ``colpass_k``, ``tdots_sweep_k``) must equal k
single-vector launches bit for bit (``torch.equal``) and their plain
versions to the same tolerance, and chain c of ``gibbs_chains`` on the
card must equal the chain run alone, for the Cox model under HMC and NUTS
too (whose likelihood, gradient, Hessian matvec and leapfrog trajectory
on the card match the CPU's within the kernels' tolerance); the linear
and logit models run HMC and NUTS and the Newton MAP searches there.
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
    colpass, colpass_k, colpass_k_plain, colpass_plain, ne_rows, ne_rows_k,
    ne_rows_k_plain, ne_rows_plain, ne_sweep, ne_sweep_plain,
)
from bayesbridge_tpu_torch.kernels.stream_probe import (
    stream_probe, stream_probe_plain,
)
from bayesbridge_tpu_torch.kernels.tdots_sweep import (
    tdots_sweep, tdots_sweep_k, tdots_sweep_k_plain, tdots_sweep_plain,
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


@pytest.mark.parametrize('k', [2, 3, 5, 8])
@pytest.mark.parametrize('pair', ['int8+f32', 'bf16+f32', 'f32'])
def test_batched_kernels_equal_single_launches(dev, pair, k):
    """ne_rows_k, colpass_k and tdots_sweep_k (four and five reductions)
    for k chains (ragged k included: launches of up to bb_max_chains
    chains) against k single-vector launches, bit for bit, and against
    their plain versions."""
    g = torch.Generator(device=dev).manual_seed(10 + k)
    n, widths = 1037, (4097, 513)
    Xs = []
    for kind, p in zip(pair.split('+'), widths):
        X = torch.randn((n, layout.padded_width(p)), generator=g,
                        device=dev)
        if kind == 'int8':
            X = (X * 2).round().to(torch.int8)
            X[:, p:] = 7
        else:
            X = X.to(torch.bfloat16 if kind == 'bf16' else torch.float32)
            X[:, p:] = float('nan')
        Xs.append(X)
    ps = list(widths[:len(Xs)])
    Vs = [torch.randn((k, p), generator=g, device=dev) for p in ps]
    Us = [torch.randn((k, n), generator=g, device=dev) for _ in range(4)]
    c = torch.randn(k, generator=g, device=dev)
    blocks = list(zip(Xs, Vs))
    reset_launch_counts()
    T = ne_rows_k(blocks, c)
    cols = colpass_k(Xs, ps, Us[0])
    four = tdots_sweep_k(Xs, ps, *Us[:3])
    five = tdots_sweep_k(Xs, ps, *Us)
    counts = launch_counts()
    assert counts['ne_rows_k'] >= 1 and counts['colpass_k'] >= 1
    assert counts['tdots_sweep_k'] >= 1 and counts['tdots_sweep_k[u4]'] >= 1
    assert counts['ne_sweep[rows]'] == counts['tdots_sweep'] == 0
    for i in range(k):
        assert torch.equal(T[i], ne_rows([(X, V[i]) for X, V in blocks],
                                         c[i]))
        for got, one in zip(cols, colpass(Xs, ps, Us[0][i])):
            assert torch.equal(got[i], one)
        for b4, b5, one in zip(four, five, tdots_sweep(
                Xs, ps, *(u[i] for u in Us))):
            for r in range(5):
                assert torch.equal(b5[r][i], one[r])
            for r in range(4):
                assert torch.equal(b4[r][i], one[r])
    _assert_close([T], [ne_rows_k_plain(blocks, c)])
    _assert_close(cols, colpass_k_plain(Xs, ps, Us[0]))
    _assert_close([o for blk in five for o in blk],
                  [o for blk in tdots_sweep_k_plain(Xs, ps, *Us)
                   for o in blk])


def test_chains_on_card_equal_single_chains(dev):
    """gibbs_chains on the hybrid composed path (the batched kernels):
    chain c equals the one-chain run from its generator, and a resumed
    run equals the uninterrupted one."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel, gibbs_chains,
    )
    from bayesbridge_tpu_torch import step as step_mod
    from bayesbridge_tpu_torch.multichain import (
        _stack_chain_inits, gibbs_chains_resume,
    )
    X, outcome = _chain_problem()
    bridge = BayesBridge(RegressionModel(outcome, X, family='logit'),
                         RegressionCoefPrior(bridge_exponent=.5))
    init = {'coef': np.zeros(bridge.n_pred), 'global_scale': 0.1,
            'local_scale': np.ones(bridge.n_pred - 1)}
    reset_launch_counts()
    full, info = gibbs_chains(bridge, 6, 3, seed=5, init=dict(init),
                              coef_sampler_type='cg')
    counts = launch_counts()
    assert counts['ne_rows_k'] > 6 and counts['colpass_k'] > 6
    assert counts['tdots_sweep_k[u4]'] == 6
    cfg = bridge._step_config(bridge._resolve_options('cg', None))
    bridge.rg.set_seed(5)
    starts = _stack_chain_inits(bridge, dict(init), 3)
    gens = bridge.rg.spawn(3)
    for c in range(3):
        carry = step_mod.init_carry('cuda', *(s[c] for s in (
            starts[0], starts[1], starts[3], starts[2])))
        _, out = step_mod.run_chain(cfg, bridge.model, gens[c], carry, 0,
                                    6, 1, 0, save_keys=('coef',))
        alone = np.stack([v.cpu().numpy() for v in out['coef']], -1)
        np.testing.assert_allclose(full['coef'][c], alone, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(
            info['_reg_coef_sampling_info']['n_cg_iter'][c],
            out['n_cg_iter'])
    part, p_info = gibbs_chains(bridge, 4, 3, seed=5, init=dict(init),
                                coef_sampler_type='cg')
    merged, _ = gibbs_chains_resume(bridge, p_info, 2, merge=True,
                                    prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])


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


@pytest.mark.parametrize('p_main', [100, 4000])
def test_dense_design_launches_kernels_and_matches_plain(dev, p_main):
    """The float32 dense design under fused='1' on the card: the CG
    operator and the MAP objective on the one-read kernel, the pre-solve
    on tdots_sweep (lone block, zero row offset; p + 1 columns stored in
    whole 16-byte rows), each against the same design's products on the
    CPU (the plain versions)."""
    from bayesbridge_tpu_torch.design import DenseDesignMatrix
    rng = np.random.default_rng(p_main)
    X = rng.standard_normal((700, p_main)).astype(np.float32)
    gpu = DenseDesignMatrix(X, center_predictor=True, fused='1')
    cpu = DenseDesignMatrix(X, center_predictor=True, fused='1',
                            device='cpu')
    assert gpu.X.shape[1] % 4 == 0 and gpu.X.shape[1] >= p_main + 1
    v = torch.from_numpy(rng.standard_normal(p_main + 1).astype(np.float32))
    w, a = (torch.from_numpy(x.astype(np.float32)) for x in (
        rng.exponential(size=700) + .1, rng.uniform(size=700) < .4))
    us = [torch.from_numpy(rng.standard_normal(700).astype(np.float32))
          for _ in range(3)]
    reset_launch_counts()
    got = [gpu.quad_matvec(v.to(dev), w.to(dev))]
    ref = [cpu.quad_matvec(v, w)]
    lp, grad = gpu.fused_link_grad(v.to(dev), a.to(dev), w.to(dev), 'logit')
    lp_c, grad_c = cpu.fused_link_grad(v, a, w, 'logit')
    got += list(gpu.presolve_reductions(*(u.to(dev) for u in us)))
    ref += list(cpu.presolve_reductions(*us))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts['ne_oneread'] == 1 and counts['ne_oneread[logit]'] == 1
    assert counts['tdots_sweep'] == 1 and counts['ne_sweep[ne]'] == 0
    for g, r in zip(got + [grad], ref + [grad_c]):
        _assert_close([g.cpu()], [r])
    assert abs(float(lp) - float(lp_c)) <= 1e-4 * abs(float(lp_c))


def test_kernel_wrappers_refuse_float64(dev):
    """A float64 tensor at a kernel wrapper raises: no wrapper converts
    it to float32 (float64 designs run torch.matmul instead)."""
    n, p = 64, 12
    X64 = torch.randn((n, 16), dtype=torch.float64, device=dev)
    X32 = X64.float()
    v64 = torch.randn(p, dtype=torch.float64, device=dev)
    w64 = torch.rand(n, dtype=torch.float64, device=dev)
    zero = torch.zeros((), device=dev)
    with pytest.raises((TypeError, ValueError)):
        ne_oneread([(X64, v64.float())], zero, w64.float())
    with pytest.raises((TypeError, ValueError)):
        ne_oneread([(X32, v64)], zero, w64.float())
    with pytest.raises((TypeError, ValueError)):
        ne_sweep([(X32, v64.float())], zero, None, w64, 'ne')
    with pytest.raises((TypeError, ValueError)):
        ne_oneread_link([(X32, v64.float())], zero, w64, w64.float(),
                        'linear')
    with pytest.raises((TypeError, ValueError)):
        tdots_sweep([X64], [p], w64.float(), w64.float(), w64.float())
    with pytest.raises((TypeError, ValueError)):
        tdots_sweep([X32], [p], w64, w64, w64)


def test_float32_gram_ignores_tf32(dev):
    """With TF32 allowed for the whole process, the dense and the hybrid
    design's float32 Fisher information stays within 1e-5 (relative to
    its largest entry) of the float64 one: the Gram runs in full
    float32 whatever the global setting, which it restores."""
    from bayesbridge_tpu_torch.design import (
        DenseDesignMatrix, SparseDesignMatrix,
    )
    from bayesbridge_tpu_torch.utils.simulate_data import simulate_design
    rng = np.random.default_rng(0)
    Xd = rng.standard_normal((3000, 300))
    Xs = simulate_design(3000, 300, binary_frac=.8, seed=1)
    w = rng.exponential(size=3000) + .1
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        for cls, X in ((DenseDesignMatrix, Xd), (SparseDesignMatrix, Xs)):
            g32 = cls(X, center_predictor=True).compute_fisher_info(
                torch.as_tensor(w, dtype=torch.float32, device=dev))
            g64 = cls(X, center_predictor=True, dtype=np.float64) \
                .compute_fisher_info(torch.as_tensor(w, device=dev))
            assert torch.get_float32_matmul_precision() == 'high'
            err = float((g32.double() - g64).abs().max())
            assert err <= 1e-5 * float(g64.abs().max()), (cls, err)
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize('family,sampler,dtype', [
    ('linear', 'cholesky', np.float32), ('linear', 'cholesky', np.float64),
    ('logit', 'cholesky', np.float32), ('linear', 'cg', np.float32),
    ('linear', 'cg', np.float64)])
def test_dense_and_linear_chains_resume_on_card(dev, family, sampler,
                                                dtype):
    """The dense design's chains on the card, float32 and float64: resume
    is exact; the float32 CG chain under fused='1' runs the one-read
    kernel and tdots_sweep on the lone block, the float64 one neither."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    from bayesbridge_tpu_torch.utils.simulate_data import simulate_outcome
    rng = np.random.default_rng(4)
    X = rng.standard_normal((400, 40))
    beta = np.r_[np.ones(3), np.zeros(37)]
    outcome = simulate_outcome(X, beta, family, seed=5)
    bridge = BayesBridge(RegressionModel(outcome, X, family=family,
                                         dtype=dtype, fused='1'),
                         RegressionCoefPrior(bridge_exponent=.5))
    reset_launch_counts()
    full, _ = bridge.gibbs(10, seed=0, coef_sampler_type=sampler,
                           params_to_save='all')
    counts = launch_counts()
    f32_cg = sampler == 'cg' and dtype == np.float32
    assert (counts['ne_oneread'] > 10) == f32_cg
    assert (counts['tdots_sweep'] == 10) == f32_cg
    assert full['coef'].dtype == dtype
    part, info = bridge.gibbs(6, seed=0, coef_sampler_type=sampler,
                              params_to_save='all')
    merged, _ = bridge.gibbs_resume(info, 4, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])


def _cox_problem(device, n=3000, p=600):
    """A small Cox model on the hybrid backend (int8 + float32 blocks)."""
    import warnings
    from bayesbridge_tpu_torch import RegressionModel
    from bayesbridge_tpu_torch.models import CoxModel
    from bayesbridge_tpu_torch.utils.simulate_data import simulate_design
    X = simulate_design(n, p, binary_frac=.9, seed=3)
    beta = np.zeros(p)
    beta[:5] = 1.0
    event, censor = CoxModel.simulate_outcome(X, beta, censoring_frac=.8,
                                              seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return RegressionModel((event, censor), X, family='cox',
                               device=device)


def test_cox_on_card_matches_cpu(dev):
    """The Cox model's loglik, gradient and Hessian matvec on the card
    (the row and column passes) against the CPU's plain versions within
    the kernels' tolerance, and an HMC trajectory from the same q0, p0,
    dt and step count (the transition's deterministic core; the CPU and
    card generators differ) within 1e-4 of its scale."""
    from bayesbridge_tpu_torch.ops import hmc
    from bayesbridge_tpu_torch.ops.reg_coef import (
        make_precond_logp_and_grad,
    )
    models = {d: _cox_problem(d) for d in ('cpu', dev)}
    rng = np.random.default_rng(5)
    p = models['cpu'].n_pred
    beta = rng.standard_normal(p) * 0.05
    v = rng.standard_normal(p)
    out = {}
    reset_launch_counts()
    for d, model in models.items():
        b = torch.as_tensor(beta, dtype=torch.float32, device=d)
        lp, grad = model.compute_loglik_and_gradient(b)
        hv = model.get_hessian_matvec_operator(b)(
            torch.as_tensor(v, dtype=torch.float32, device=d))
        scale = torch.full((p,), 0.5, device=d)
        f = make_precond_logp_and_grad(model, scale, torch.ones_like(scale))
        q0 = b / scale
        lp0, g0 = f(q0)
        traj = hmc.simulate_dynamics(
            f, 0.02, 8, q0, torch.as_tensor(v, dtype=torch.float32,
                                            device=d), lp0, g0)
        out[d] = [x.cpu() for x in (lp, grad, hv, traj[0], traj[1])]
    counts = launch_counts()
    assert counts['ne_sweep[rows]'] > 0 and counts['ne_sweep[cols]'] > 0
    for got, ref in zip(out[dev], out['cpu']):
        _assert_close([got.reshape(-1)], [ref.reshape(-1)])


def test_cox_chains_on_card_equal_chains_alone(dev):
    """Cox under HMC and NUTS on the card: 2 chains of ``gibbs_chains``
    (the batched row and column passes) equal the chains run alone bit
    for bit, and a resumed single chain equals the uninterrupted one."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, gibbs_chains,
    )
    from bayesbridge_tpu_torch import step as step_mod
    from bayesbridge_tpu_torch.multichain import _stack_chain_inits
    model = _cox_problem(dev)
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    init = {'coef': np.zeros(model.n_pred), 'global_scale': 0.1,
            'local_scale': np.ones(model.n_pred)}
    for sampler in ('hmc', 'nuts'):
        reset_launch_counts()
        samples, info = gibbs_chains(bridge, 3, 2, seed=7, init=dict(init),
                                     coef_sampler_type=sampler)
        counts = launch_counts()
        assert counts['ne_rows_k'] > 0 and counts['colpass_k'] > 0
        cfg = bridge._step_config(bridge._resolve_options(sampler, None))
        bridge.rg.set_seed(7)
        starts = _stack_chain_inits(bridge, dict(init), 2)
        gens = bridge.rg.spawn(2)
        for c in range(2):
            coef, obs_prec, lscale, gscale = (s[c] for s in starts)
            carry = step_mod.init_carry(dev, coef, obs_prec, gscale, lscale,
                                        cfg=cfg)
            _, out = step_mod.run_chain(cfg, model, gens[c], carry, 0, 3, 1,
                                        0, save_keys=('coef',))
            alone = np.stack([x.cpu().numpy() for x in out['coef']], -1)
            np.testing.assert_array_equal(samples['coef'][c], alone)
        full, _ = bridge.gibbs(5, seed=1, init=dict(init),
                               coef_sampler_type=sampler,
                               params_to_save='all')
        part, p_info = bridge.gibbs(3, seed=1, init=dict(init),
                                    coef_sampler_type=sampler,
                                    params_to_save='all')
        merged, _ = bridge.gibbs_resume(p_info, 2, merge=True,
                                        prev_samples=part)
        for key in full:
            np.testing.assert_array_equal(merged[key], full[key])


def test_ne_oneread_small_plan_reruns_give_the_same_bits(dev):
    """A block pair whose plan has four consumer warps (20,000 rows of
    9,001 int8 and 999 f32 columns), small enough that two CTAs would
    share an SM but for a pair's shared-memory floor: twenty runs on the
    same inputs give the same bits, within the kernels' tolerance of the
    plain version."""
    g = torch.Generator(device=dev).manual_seed(9)
    n, pe, pf = 20_000, 9_001, 999
    Xe = (torch.rand((n, layout.padded_width(pe)), generator=g, device=dev)
          < 0.1).to(torch.int8)
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    blocks = [(Xe, torch.randn(pe, generator=g, device=dev) * 0.01),
              (Xf, torch.randn(pf, generator=g, device=dev) * 0.01)]
    c = torch.zeros((), device=dev)
    w = torch.ones(n, device=dev)
    runs = [torch.cat(ne_oneread(blocks, c, w)[0]) for _ in range(20)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    _assert_close([runs[0]],
                  [torch.cat(ne_sweep_plain(blocks, c, None, w, 'ne')[0])])


def test_prefix_sum_gives_the_same_bits_every_run(dev):
    """The Cox model's risk-set prefix sums (``utils.chains.prefix_sum``)
    at the flagship's 100,000 rows: twenty runs give the same bits, within
    float32 rounding of the float64 prefix sum."""
    from bayesbridge_tpu_torch.utils.chains import prefix_sum
    x = torch.rand(100_000, generator=torch.Generator(device=dev)
                   .manual_seed(3), device=dev)
    first = prefix_sum(x)
    for _ in range(19):
        assert torch.equal(prefix_sum(x), first)
    ref = torch.cumsum(x.double(), 0)
    assert float(((first.double() - ref).abs() / ref).max()) < 1e-5


@pytest.mark.parametrize('family', ['linear', 'logit'])
def test_hmc_nuts_and_newton_search_on_card(dev, family):
    """The linear and logit models under HMC and NUTS on the card (finite
    draws, exact resume), and the Newton-CG and trust-ncg MAP searches
    there against the CPU's, within 1e-3 of max|MAP| (float32 products
    summed in other orders)."""
    import warnings
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    from bayesbridge_tpu_torch.ops.reg_coef import search_mode
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome,
    )
    X = simulate_design(2000, 300, binary_frac=.9, seed=5)
    beta = np.zeros(300)
    beta[:4] = 1.0
    y = simulate_outcome(X, beta, family, seed=6)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        models = {d: RegressionModel(y, X, family=family, device=d)
                  for d in ('cpu', dev)}
    bridge = BayesBridge(models[dev], RegressionCoefPrior(bridge_exponent=.5))
    init = {'coef': np.zeros(301), 'global_scale': 0.1,
            'local_scale': np.ones(300)}
    for sampler in ('hmc', 'nuts'):
        full, info = bridge.gibbs(4, seed=2, init=dict(init),
                                  coef_sampler_type=sampler,
                                  params_to_save='all')
        assert np.all(np.isfinite(full['coef']))
        assert np.all(info['_reg_coef_sampling_info']['n_grad_evals'] >= 1)
        part, p_info = bridge.gibbs(2, seed=2, init=dict(init),
                                    coef_sampler_type=sampler,
                                    params_to_save='all')
        merged, _ = bridge.gibbs_resume(p_info, 2, merge=True,
                                        prev_samples=part)
        for key in full:
            np.testing.assert_array_equal(merged[key], full[key])
    obs_prec = 1.0 if family == 'linear' else None
    for trust in (False, True):
        maps = [search_mode(np.zeros(301), np.ones(300), 0.3, obs_prec,
                            models[d], np.array([2.0]), 2.0,
                            use_newton_method=True,
                            require_trust_region=trust)[0]
                for d in ('cpu', dev)]
        assert np.abs(maps[1] - maps[0]).max() \
            <= 1e-3 * np.abs(maps[0]).max()
