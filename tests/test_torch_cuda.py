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
and logit models run HMC and NUTS and the Newton MAP searches there. The
ell backend's gather kernel (``ell_matvec_k``, float32 and float64, 1-8
vectors a launch) must equal its plain version (rtol 1e-4 / 1e-12 of
max|plain|), its single launches bit for bit, and itself on a rerun; its
windowed traversal of a sorted col-ELL and its staged traversal of a
row-ELL (whole and partial stages) must give the first traversal's bits;
the hybrid and bitpack blocks built on the card must equal the host's.
The nibble modes of the row pass, the column pass and the pre-solve over
a packed int4 block (``layout.pack_int4``) must equal
their plain versions to the same tolerance, the int8 modes on the same
values and themselves on a rerun bit for bit, one and two blocks at
ragged widths, and a chain on an int4 design must resume exactly. On a
(2, 2) obs x pred mesh of one card, each backend's pieces (int8 and int4
cut at 32 columns, bitpack at 8, the ell row and column pieces) must
give the CPU grid's products, their own bits on a rerun, and the int4
pieces the int8 pieces' bits. The Polya-Gamma and tilted-stable kernels
(``pg_draw``, ``ts_draw``) must match their plain rounds in law (KS, p >
1e-4) and the closed-form moments at fixed-tilt grids in float32 and
float64, report the plain version's per-lane method, give a rerun's bits
and each chain's bits alone, run with no host sync, and carry a logit
chain whose resumes stay exact; their Philox4x32-10 must equal curand's.
The CG loop's kernels (``cg_start``, ``cg_update``) must match their
plain versions (rtol 1e-4 of max|plain|, 1e-12 in float64), leave a
chain whose flag is clear untouched and give each chain its bits alone;
on every backend the device loop serves, the solve as one graph launch
must give the host-driven loop's n_cg_iter and, within the same
tolerance, its coef, a rerun's bits from the cached graph with one host
read, launch counters at the captured iteration's launches times
max(n_iter), and each chain's bits alone; a Gibbs run on the card takes
one graph for all its solves.
"""

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch.kernels import layout, launch_counts, \
    load_library, reset_launch_counts
from bayesbridge_tpu_torch.kernels.bitlut import (
    bitlut, bitlut_plain, bitlut_variant, byte_lut_plain,
)
from bayesbridge_tpu_torch.kernels import ell as ell_mod
from bayesbridge_tpu_torch.kernels.ell import (
    EllLayout, ell_matvec_k, ell_matvec_k_plain, win_launch, win_plan,
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
    tdots_sweep, tdots_sweep_k, tdots_sweep_k_plain,
    tdots_sweep_plain,
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


# (n, widths) of the batched kernels' checks: the first crosses the row
# pass's 96- and 128-row panels and 512-column chunks of v and the
# pre-solve's tiles (256 to 2048 columns) and panels; the second crosses
# f32 chunk and tile edges (1025 columns) with n one past a 32-row
# panel's multiple; 'f32@4001' is the dense design's lone f32 block.
BATCHED_SHAPES = {'int8+f32': (1037, (4097, 513)),
                  'bf16+f32': (1037, (4097, 513)),
                  'f32': (1037, (4097,)),
                  'int8+f32@2113': (2113, (2049, 1025)),
                  'f32@4001': (2500, (4001,))}


def _batched_inputs(dev, pair, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n, widths = BATCHED_SHAPES[pair]
    Xs = []
    for kind, p in zip(pair.split('@')[0].split('+'), widths):
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
    return Xs, ps, Vs, Us, c


@pytest.mark.parametrize('k', [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize('pair', list(BATCHED_SHAPES))
def test_batched_kernels_equal_single_launches(dev, pair, k):
    """ne_rows_k, colpass_k and tdots_sweep_k (four and five reductions)
    for k chains in one launch each, against k single-vector launches,
    bit for bit, and against their plain versions."""
    Xs, ps, Vs, Us, c = _batched_inputs(dev, pair, k, 10 + k)
    blocks = list(zip(Xs, Vs))
    reset_launch_counts()
    T = ne_rows_k(blocks, c)
    cols = colpass_k(Xs, ps, Us[0])
    four = tdots_sweep_k(Xs, ps, *Us[:3])
    five = tdots_sweep_k(Xs, ps, *Us)
    counts = launch_counts()
    assert counts['ne_rows_k'] == counts['colpass_k'] == 1
    assert counts['tdots_sweep_k'] == counts['tdots_sweep_k[u4]'] == 1
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


@pytest.mark.parametrize('k', [2, 4, 8])
def test_batched_kernels_reruns_give_the_same_bits(dev, k):
    """20 launches of each batched kernel on the same inputs give the same
    bits, at a shape whose grids put several CTAs on each SM at once
    (20,000 rows of 9,001 int8 and 999 f32 columns)."""
    g = torch.Generator(device=dev).manual_seed(21)
    n, pe, pf = 20_000, 9_001, 999
    Xe = (torch.rand((n, layout.padded_width(pe)), generator=g,
                     device=dev) < .1).to(torch.int8)
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    Xs, ps = [Xe, Xf], [pe, pf]
    Vs = [torch.randn((k, p), generator=g, device=dev) for p in ps]
    Us = [torch.randn((k, n), generator=g, device=dev) for _ in range(4)]
    c = torch.randn(k, generator=g, device=dev)
    calls = [lambda: [ne_rows_k(list(zip(Xs, Vs)), c)],
             lambda: colpass_k(Xs, ps, Us[0]),
             lambda: [o for blk in tdots_sweep_k(Xs, ps, *Us) for o in blk],
             lambda: [o for blk in tdots_sweep_k(Xs, ps, *Us[:3])
                      for o in blk]]
    for call in calls:
        first = call()
        for _ in range(19):
            assert all(torch.equal(a, b) for a, b in zip(call(), first))


def test_batched_plan_matches_the_kernels(dev):
    """layout.batched_plan's chains and shared memory are the library's
    (bb_max_chains, bb_batched_smem) for every kind, storage type and k;
    the pre-solve's CTAs share an SM as designed."""
    kl = load_library()
    for kind, code in layout.BATCHED_KINDS.items():
        for dtype, dt in layout.DTYPE_CODE.items():
            if dtype == layout.INT4:  # no chain-batched nibble mode
                continue
            for k in range(1, 9):
                plan = layout.batched_plan(kind, [dtype, torch.float32], k)
                assert kl.lib.bb_max_chains(code, dt) == plan.chains == 8
                assert kl.lib.bb_batched_smem(code, dt, k) \
                    == plan.smem_bytes
                assert kl.lib.bb_batched_occupancy(code, dt, k) >= 1
    assert kl.lib.bb_batched_occupancy(5, 2, 8) >= 2


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('k', [1, 2, 3, 5, 8, 11])
@pytest.mark.parametrize('power', [1, 2])
def test_ell_kernel_matches_plain(dev, dtype, k, power):
    """Ragged row-ELL arrays (45 slots a row, not a multiple of 32; rows
    of padding only; padding at index 0, value 0) and k vectors: the
    plain version's values, each vector's single launch bit for bit,
    the same bits on a rerun, ceil(k / 8) launches."""
    g = torch.Generator(device=dev).manual_seed(k + 10 * power)
    m, width, n_in = 333, 45, 1000
    idx = torch.randint(0, n_in, (m, width), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.randn((m, width), generator=g, device=dev, dtype=dtype)
    lens = torch.randint(0, width + 1, (m,), generator=g, device=dev)
    lens[50:60] = 0
    pad = torch.arange(width, device=dev)[None, :] >= lens[:, None]
    idx[pad] = 0
    val[pad] = 0.0
    X = torch.randn((k, n_in), generator=g, device=dev, dtype=dtype)
    reset_launch_counts()
    got = ell_matvec_k(idx, val, X, power, tag='tdot')
    assert launch_counts()['ell[tdot]'] == -(-k // 8)
    assert launch_counts()['ell[dot]'] == 0
    ref = ell_matvec_k_plain(idx, val, X, power)
    scale = float(ref.abs().max())
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    assert got.dtype == dtype and got.shape == (k, m)
    assert float((got - ref).abs().max()) <= rtol * scale
    assert torch.all(got[:, 50:60] == 0)
    assert torch.equal(got, ell_matvec_k(idx, val, X, power, tag='tdot'))
    for c in range(k):
        assert torch.equal(got[c], ell_matvec_k(idx, val, X[c], power))


def _sorted_col_ell(g, dev, dtype, m, n_in):
    """A col-ELL of m rows over n_in inputs with ascending indices: ragged
    rows (some spanning several windows, one 70 slots long in a single
    window, empty rows), padded with (0, 0.0), an explicit zero inside."""
    lens = torch.randint(0, 300, (m,), generator=g, device=dev)
    lens[10:15] = 0
    lens[20] = 70
    width = int(lens.max()) + 3
    keys = torch.rand((m, width), generator=g, device=dev)
    idx = (keys * n_in).long().sort(dim=1).values.int()
    idx[20] = torch.arange(width, device=dev, dtype=torch.int32) // 2 + 1500
    val = torch.randn((m, width), generator=g, device=dev, dtype=dtype)
    val[30, 5] = 0.0
    pad = torch.arange(width, device=dev)[None, :] >= lens[:, None]
    idx[pad] = 0
    val[pad] = 0.0
    return idx.contiguous(), val.contiguous()


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('k', [1, 2, 3, 4, 5, 6, 7, 8, 11])
@pytest.mark.parametrize('power', [1, 2])
def test_ell_windowed_traversal_gives_the_first_ones_bits(dev, dtype, k,
                                                          power,
                                                          monkeypatch):
    """On sorted col-ELL arrays with ragged, padded and empty rows and
    inputs spanning many windows, the windowed traversal (forced for every
    k) gives the first traversal's bits, each vector its single launch's,
    the same bits on a rerun; its counter advances, the first one's not."""
    g = torch.Generator(device=dev).manual_seed(k + 10 * power)
    m, n_in = 700, 70_000
    idx, val = _sorted_col_ell(g, dev, dtype, m, n_in)
    lay = EllLayout.from_numpy(idx.cpu().numpy(), val.cpu().numpy(), n_in,
                               dev)
    assert lay.ascending
    X = torch.randn((k, n_in), generator=g, device=dev, dtype=dtype)
    first = ell_matvec_k(idx, val, X, power, tag='tdot')
    monkeypatch.setattr(ell_mod, 'takes_window', lambda *args: True)
    reset_launch_counts()
    got = ell_matvec_k(idx, val, X, power, tag='tdot', layout=lay)
    counts = launch_counts()
    assert counts['ell[tdot_win]'] == -(-k // 8)
    assert counts['ell[tdot]'] == counts['ell[dot]'] == 0
    assert torch.equal(got, first)
    assert torch.equal(got, ell_matvec_k(idx, val, X, power, 'tdot', lay))
    for c in range(k):
        assert torch.equal(got[c], ell_matvec_k(idx, val, X[c], power,
                                                'tdot', lay))
    ref = ell_matvec_k_plain(idx, val, X, power)
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())
    assert torch.all(got[:, 10:15] == 0)


def test_ell_windowed_plan_matches_the_kernel(dev):
    """The kernel takes the wrapper's plan for every k (its rows a CTA,
    its windows' shared memory), refuses more rows a CTA than it has, and
    an unsorted layout keeps the first traversal."""
    kl = load_library()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(2)
    idx, val = _sorted_col_ell(g, dev, torch.float64, 300, 40_000)
    lay = EllLayout.from_numpy(idx.cpu().numpy(), val.cpu().numpy(),
                               40_000, dev)
    for dtype in (torch.float32, torch.float64):
        v = val.to(dtype)
        for k in range(1, 9):
            rows = kl.lib.bb_ell_win_rows(k, int(dtype == torch.float64))
            assert 1 <= rows <= 128
            assert lay.card(dtype, k) == (n_sm, rows)
            plan = win_plan(dtype, k, 300, 40_000, n_sm, rows)
            assert plan['smem_bytes'] <= ell_mod.MAX_SMEM
            X = torch.randn((k, 40_000), generator=g, device=dev,
                            dtype=dtype)
            out = torch.empty((k, 300), dtype=dtype, device=dev)
            win_launch(kl, idx, v, lay, X, 1, out, rows_max=rows)
            assert torch.equal(out, ell_matvec_k(idx, v, X, 1, 'tdot'))
            Xt = torch.zeros((plan['n_pad'], k), dtype=dtype, device=dev)
            assert kl.lib.bb_ell_win(
                idx.data_ptr(), v.data_ptr(), 300, idx.shape[1],
                lay.win_ptr.data_ptr(), lay.win_ptr.shape[1], plan['stride'],
                Xt.data_ptr(), k, 1, int(dtype == torch.float64),
                plan['window'], plan['n_win'], rows + 1, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream) != 0
    assert kl.lib.bb_ell_win_rows(9, 1) == 0
    g = torch.Generator(device=dev).manual_seed(3)
    idx, val = _sorted_col_ell(g, dev, torch.float64, 50, 5000)
    idx = idx.flip(1).contiguous()
    val = val.flip(1).contiguous()
    lay = EllLayout.from_numpy(idx.cpu().numpy(), val.cpu().numpy(), 5000,
                               dev)
    assert not lay.ascending and lay.win_ptr is None
    X = torch.randn((2, 5000), generator=g, device=dev, dtype=torch.float64)
    reset_launch_counts()
    got = ell_matvec_k(idx, val, X, 1, 'tdot', lay)
    assert launch_counts()['ell[tdot]'] == 1
    assert launch_counts()['ell[tdot_win]'] == 0
    assert torch.equal(got, ell_matvec_k(idx, val, X, 1, 'tdot'))


def _ragged_row_ell(g, dev, dtype, m, width, n_in):
    """Row-ELL arrays of m rows over n_in inputs: ragged rows padded with
    (0, 0.0) (a row of padding only every so often), unsorted indices."""
    idx = torch.randint(0, n_in, (m, width), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.randn((m, width), generator=g, device=dev, dtype=dtype)
    lens = torch.randint(0, width + 1, (m,), generator=g, device=dev)
    lens[50:60] = 0
    lens[61] = width
    pad = torch.arange(width, device=dev)[None, :] >= lens[:, None]
    idx[pad] = 0
    val[pad] = 0.0
    return idx, val


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('k', [1, 2, 3, 4, 5, 6, 7, 8, 11])
@pytest.mark.parametrize('power', [1, 2])
def test_ell_staged_traversal_gives_the_first_ones_bits(dev, dtype, k,
                                                        power, monkeypatch):
    """Ragged row-ELL arrays (333 rows of 45 slots and 1,000 of 300, rows
    of padding only) over 20,003 inputs: the staged traversal, forced
    through the dispatch for every k, gives the first traversal's bits,
    each vector its single launch's, the same bits on a rerun, within rtol
    of the plain version, with one launch per 8 vectors on its own
    counter; so does every other stage launched directly (all the
    vectors, a third of them, 4 KB of them)."""
    g = torch.Generator(device=dev).manual_seed(k + 10 * power)
    n_in = 20_003
    rtol = 1e-4 if dtype == torch.float32 else 1e-12
    item = 8 if dtype == torch.float64 else 4
    kl = load_library()
    for m, width in ((333, 45), (1000, 300)):
        idx, val = _ragged_row_ell(g, dev, dtype, m, width, n_in)
        X = torch.randn((k, n_in), generator=g, device=dev, dtype=dtype)
        monkeypatch.setattr(ell_mod, 'takes_stage', lambda *args: False)
        reset_launch_counts()
        first = ell_matvec_k(idx, val, X, power)
        assert launch_counts()['ell[dot]'] == -(-k // 8)
        monkeypatch.setattr(ell_mod, 'takes_stage', lambda *args: True)
        reset_launch_counts()
        got = ell_matvec_k(idx, val, X, power)
        counts = launch_counts()
        assert counts['ell[dot_st]'] == -(-k // 8)
        assert counts['ell[dot]'] == counts['ell[tdot_st]'] == 0
        assert torch.equal(got, first)
        assert torch.equal(got, ell_matvec_k(idx, val, X, power))
        for c in range(k):
            assert torch.equal(got[c], ell_matvec_k(idx, val, X[c], power))
        ref = ell_matvec_k_plain(idx, val, X, power)
        assert float((got - ref).abs().max()) \
            <= rtol * float(ref.abs().max())
        assert torch.all(got[:, 50:60] == 0)
        kk = min(k, 8)
        for budget in (ell_mod.STAGE_BYTES, n_in * kk * item // 3, 4096):
            plan = ell_mod.stage_plan(dtype, kk, n_in, budget)
            out = torch.empty((kk, m), dtype=dtype, device=dev)
            ell_mod.stage_launch(kl, idx, val, X[:kk], power, out, plan)
            assert torch.equal(out, first[:kk]), plan
            again = torch.full_like(out, float('nan'))
            ell_mod.stage_launch(kl, idx, val, X[:kk], power, again, plan)
            assert torch.equal(again, out), plan


def test_ell_stage_plan_fits_the_card(dev):
    """Every stage at the ell slice's 16,384 inputs and at the flagship's
    50,000 fits an SM, and the kernel refuses a stage past the shared
    memory a CTA may take or not of whole 16-byte units."""
    kl = load_library()
    for dtype in (torch.float32, torch.float64):
        f64 = int(dtype == torch.float64)
        for n_in in (16_384, 50_000):
            for k in range(1, 9):
                plan = ell_mod.stage_plan(dtype, k, n_in)
                assert plan['smem_bytes'] <= ell_mod.STAGE_BYTES
                assert kl.lib.bb_ell_st_fit(k, f64, plan['n_staged']) >= 1
    too_big = ell_mod.STAGE_BYTES // 8 + 4
    assert kl.lib.bb_ell_st_fit(1, 1, too_big) < 1
    idx = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    val = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    xt = torch.zeros((too_big * 2, 1), dtype=torch.float32, device=dev)
    out = torch.empty((1, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for n_staged in (too_big * 2, 3):  # too many bytes; 12 bytes
        assert kl.lib.bb_ell_st(idx.data_ptr(), val.data_ptr(), 4, 4,
                                xt.data_ptr(), 1, 1, 0, n_staged, 1,
                                out.data_ptr(), stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize('case', ['int8', 'int4', 'bf16', 'float64',
                                  'bitpack'])
def test_blocks_built_on_the_card_equal_the_hosts(dev, case, monkeypatch):
    """The hybrid design's blocks (int8, packed int4, bf16 and float64
    tiers) and bitpack's float block, scattered on the card from the CSR
    after the tiers' column masks were taken there, equal the ones numpy
    builds on the host bit for bit, as do the column splits; a CSR with
    duplicate entries is densified on the host."""
    from bayesbridge_tpu_torch.design import SparseDesignMatrix
    from bayesbridge_tpu_torch.design import sparse as sparse_mod
    import scipy.sparse as sps
    X, _ = _chain_problem()
    if case == 'bf16':  # bf16-exact values outside int8: the bf16 tier
        X = X.copy()
        X.data = X.data * 256.0
    if case == 'int4':
        monkeypatch.setenv('BB_HYBRID_INT4', '1')
    dtype = np.float64 if case == 'float64' else np.float32
    backend = 'bitpack' if case == 'bitpack' else 'hybrid'
    assert X.has_canonical_format
    on = SparseDesignMatrix(X, backend=backend, dtype=dtype, device=dev)
    host = SparseDesignMatrix(X, backend=backend, dtype=dtype, device='cpu')
    blocks = ('X_float',) if backend == 'bitpack' else ('X_exact', 'X_float')
    for name in blocks:
        a, b = getattr(on, name), getattr(host, name)
        assert a.device.type == 'cuda', name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.cpu().contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8)), name
    for name in ('exact_cols', 'float_cols', 'bin_cols'):
        if hasattr(host, name):  # the tiers' column masks agree
            assert torch.equal(getattr(on, name).cpu(), getattr(host, name))
    if backend == 'hybrid':
        assert 'densify' in on.build_seconds
        want = {'int8': torch.int8, 'int4': torch.uint8,
                'bf16': torch.bfloat16, 'float64': torch.float64}[case]
        block = on.X_float if case == 'float64' else on.X_exact
        assert block.dtype == want and block.shape[1] > 0
    # row 0's first entry twice: not canonical, densified on the host
    dup = sps.csr_matrix(
        (np.r_[X.data[:1], X.data], np.r_[X.indices[:1], X.indices],
         np.r_[0, X.indptr[1:] + 1]), shape=X.shape)
    assert not sparse_mod._on_card(dup, dev)
    assert sparse_mod._on_card(X, dev) and not sparse_mod._on_card(X, 'cpu')


@pytest.mark.parametrize('backend', ['hybrid', 'hybrid_fused', 'bitpack',
                                     'winell', 'ell'])
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
    kern = {'bitpack': 'bitlut', 'winell': 'wincsr',
            'ell': 'ell'}.get(backend)
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
    if backend == 'ell':  # u (500 values) fits L1: the first traversal
        assert counts['ell[tdot_win]'] == 0
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


def _sharded_pair(dev, backend, fused=None, dtype=np.float32):
    """(unsharded design, the same sharded over [dev] * 4) of
    _chain_problem's X."""
    from bayesbridge_tpu_torch.design import SparseDesignMatrix
    from bayesbridge_tpu_torch.parallel import make_mesh, shard_design
    X, _ = _chain_problem()
    design = SparseDesignMatrix(X, center_predictor=True, backend=backend,
                                fused=fused, dtype=dtype, device=dev)
    return design, shard_design(design, make_mesh(devices=[dev] * 4))


@pytest.mark.parametrize('case', ['hybrid_fused', 'hybrid', 'bitpack',
                                  'winell', 'ell32', 'ell64'])
def test_sharded_products_on_card(dev, case):
    """A 4-shard mesh on one card (row views of the stored blocks): every
    product equals the unsharded design's within rtol 1e-4 of max (float64
    1e-12), the same bits on a rerun, and each call launches each kernel
    once per shard."""
    backend = {'hybrid_fused': 'hybrid', 'ell32': 'ell',
               'ell64': 'ell'}.get(case, case)
    dtype = np.float64 if case == 'ell64' else np.float32
    design, sd = _sharded_pair(dev, backend, '1' if case == 'hybrid_fused'
                               else '0', dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tol = 1e-12 if dtype == np.float64 else 1e-4
    g = torch.Generator(device=dev).manual_seed(5)
    n, p = design.shape
    v = torch.randn(p, generator=g, device=dev, dtype=tdt)
    u = torch.randn(n, generator=g, device=dev, dtype=tdt)
    w = torch.rand(n, generator=g, device=dev, dtype=tdt) + .5
    V = torch.randn((3, p), generator=g, device=dev, dtype=tdt)

    def close(got, ref):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol * scale

    kern = {'bitpack': 'bitlut', 'winell': 'wincsr',
            'ell': 'ell'}.get(backend)
    for name, fn in (('dot', lambda d: d.dot(v)),
                     ('Tdot', lambda d: d.Tdot(u)),
                     ('quad', lambda d: d.quad_matvec(v, w)),
                     ('diag', lambda d: d.compute_fisher_diag(w)),
                     ('dot3', lambda d: d.dot(V))):
        ref = fn(design)
        reset_launch_counts()
        got = fn(sd)
        torch.cuda.synchronize()
        counts = launch_counts()
        close(got, ref)
        assert torch.equal(fn(sd), got), name
        if name == 'quad' and case == 'hybrid_fused':
            assert counts['ne_oneread'] + counts['ne_sweep[ne]'] == 4
        elif name == 'dot' and backend == 'hybrid':
            assert counts['ne_sweep[rows]'] == 4
        elif name == 'Tdot' and backend == 'hybrid':
            assert counts['ne_sweep[cols]'] == 4
        elif name == 'dot' and kern is not None:
            assert counts[f'{kern}[dot]'] == 4
        elif name == 'Tdot' and kern == 'ell':
            assert counts['ell[tdot]'] + counts['ell[tdot_win]'] == 4
        elif name == 'Tdot' and kern is not None:
            assert counts[f'{kern}[tdot]'] == 4
    if backend == 'hybrid':
        lo = sd.presolve_reductions(u, u * w, w)
        for got, ref in zip(lo, design.presolve_reductions(u, u * w, w)):
            close(got, ref)


def _ragged_2d_design(case, device):
    """A 1,037-row design of ragged widths for the 2-d mesh: 70 columns
    of values in [-8, 7] (0/1 for bitpack: 37 columns, so its pieces cut
    at 8 leave a ragged last byte-group) beside 13 normal ones; the
    hybrid's exact pieces cut at 32 columns, the last 6 wide."""
    from bayesbridge_tpu_torch.design import (
        DenseDesignMatrix, SparseDesignMatrix,
    )
    import scipy.sparse as sps
    rng = np.random.default_rng(3)
    n = 1037
    if case == 'bitpack':
        exact = (rng.uniform(size=(n, 37)) < .3) * 1.
    else:
        exact = rng.integers(-8, 8, size=(n, 70)) * (rng.uniform(
            size=(n, 70)) < .4)
    X = np.hstack([exact, rng.standard_normal((n, 13)) * (rng.uniform(
        size=(n, 13)) < .5)])
    dtype = np.float64 if case == 'ell64' else np.float32
    if case == 'dense':
        return DenseDesignMatrix(X, center_predictor=True, device=device)
    backend = {'ell32': 'ell', 'ell64': 'ell', 'int4': 'hybrid',
               'int8': 'hybrid'}.get(case, case)
    return SparseDesignMatrix(sps.csr_matrix(X), center_predictor=True,
                              backend=backend, fused='0', dtype=dtype,
                              device=device)


@pytest.mark.parametrize('case', ['int8', 'int4', 'bitpack', 'dense',
                                  'ell32', 'ell64'])
def test_2d_pieces_on_card(dev, case, monkeypatch):
    """The design on a (2, 2) mesh of [dev] * 4 (each piece a copy at
    ragged widths): every product equals the same grid's on the CPU (the
    kernels' plain versions) within rtol 1e-4 of max (float64 1e-12),
    the same bits on a rerun, each piece's kernel launched once a call;
    the int4 pieces equal the int8 pieces bit for bit."""
    from bayesbridge_tpu_torch.design import sparse as sparse_mod
    from bayesbridge_tpu_torch.parallel import make_mesh, shard_design
    if case == 'int4':
        monkeypatch.setenv('BB_HYBRID_INT4', '1')
        monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    on = {}
    for where in ('cpu', dev):
        design = _ragged_2d_design(case, where)
        if case in ('int8', 'int4'):
            assert layout.is_int4(design.X_exact) == (case == 'int4')
        on[str(where)] = shard_design(
            design, make_mesh((2, 2), devices=[torch.device(where)] * 4),
            pred_axis='pred')
    plain, sd = on['cpu'], on[str(dev)]
    assert len(sd.col_pieces) == 2
    tdt = sd.dtype
    tol = 1e-12 if tdt == torch.float64 else 1e-4
    g = torch.Generator().manual_seed(6)
    n, p = sd.shape
    v, u = torch.randn(p, generator=g, dtype=tdt), torch.randn(
        n, generator=g, dtype=tdt)
    w = torch.rand(n, generator=g, dtype=tdt) + .5
    V = torch.randn((3, p), generator=g, dtype=tdt)
    calls = {'dot': lambda d, t: d.dot(t(v)), 'Tdot': lambda d, t: d.Tdot(
        t(u)), 'quad': lambda d, t: d.quad_matvec(t(v), t(w)),
        'diag': lambda d, t: d.compute_fisher_diag(t(w)),
        'dot3': lambda d, t: d.dot(t(V))}
    if sd.has_presolve_reductions():
        calls['presolve'] = lambda d, t: d.presolve_reductions(
            t(u), t(u * w), t(w), t(w * v[0]))
    kern = {'int8': ('ne_sweep[rows]', 'ne_sweep[cols]'),
            'int4': ('ne_rows_i4', 'colpass_i4'),
            'bitpack': ('bitlut[dot]', 'bitlut[tdot]')}.get(case)
    got = {}
    for name, fn in calls.items():
        ref = fn(plain, lambda x: x)
        reset_launch_counts()
        out = fn(sd, lambda x: x.to(dev))
        torch.cuda.synchronize()
        counts = launch_counts()
        ref, out = (ref, out) if isinstance(ref, tuple) else ((ref,), (out,))
        scale = max(float(r.abs().max()) for r in ref)
        for a, b in zip(out, ref):
            assert float((a.cpu() - b).abs().max()) <= tol * scale, name
        again = fn(sd, lambda x: x.to(dev))
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, b) for a, b in zip(out, again)), name
        if kern and name == 'dot':
            assert counts[kern[0]] == 4, counts
        if kern and name == 'Tdot':
            assert counts[kern[1]] == 4, counts
        if case.startswith('ell') and name == 'dot':
            assert counts['ell[dot]'] + counts['ell[dot_st]'] == 2, counts
        if case.startswith('ell') and name == 'Tdot':
            assert counts['ell[tdot]'] + counts['ell[tdot_win]'] == 2, counts
        got[name] = out
    if case == 'int4':
        monkeypatch.delenv('BB_HYBRID_INT4')
        s8 = shard_design(
            _ragged_2d_design('int8', dev),
            make_mesh((2, 2), devices=[dev] * 4), pred_axis='pred')
        for name, fn in calls.items():
            out = fn(s8, lambda x: x.to(dev))
            out = out if isinstance(out, tuple) else (out,)
            assert all(torch.equal(a, b) for a, b in zip(out, got[name])), \
                name


def _int4_blocks(g, dev, n, pe, pf, binary):
    """(X8, X4, Xf): an int8 block of values in [-8, 7] (0/1 with
    `binary`), its packed int4 form with random padding nibbles, an f32
    block (None without pf)."""
    w = layout.padded_width(pe, int4=True)
    if binary:
        X8 = (torch.rand((n, w), generator=g, device=dev) < .2).to(
            torch.int8)
    else:
        X8 = torch.randint(-8, 8, (n, w), generator=g, device=dev,
                           dtype=torch.int8)
    X4 = layout.pack_int4(X8)
    X8[:, pe:] = 0
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g,
                     device=dev) if pf else None
    return X8, X4, Xf


def _nibble_calls(g, dev, n, pe, pf):
    ps = [pe, pf] if pf else [pe]
    vs = [torch.randn(p, generator=g, device=dev) for p in ps]
    c = torch.randn(n, generator=g, device=dev)
    us = [torch.randn(n, generator=g, device=dev) for _ in range(4)]

    def flat(r):
        return [o for blk in r for o in blk]
    return {
        'rows': (lambda Xs: [ne_rows(list(zip(Xs, vs)), c)],
                 lambda Xs: [ne_rows_plain(list(zip(Xs, vs)), c)]),
        'cols': (lambda Xs: colpass(Xs, ps, us[0]),
                 lambda Xs: colpass_plain(Xs, ps, us[0])),
        'tdots4': (lambda Xs: flat(tdots_sweep(Xs, ps, *us[:3])),
                   lambda Xs: flat(tdots_sweep_plain(Xs, ps, *us[:3]))),
        'tdots5': (lambda Xs: flat(tdots_sweep(Xs, ps, *us)),
                   lambda Xs: flat(tdots_sweep_plain(Xs, ps, *us))),
    }


@pytest.mark.parametrize('binary', [False, True])
@pytest.mark.parametrize('n,pe,pf', [(1037, 4097, 513), (1037, 45, 0),
                                     (3001, 8191, 100)])
def test_nibble_modes_match_plain_and_int8(dev, n, pe, pf, binary):
    """Each nibble mode against its plain version, the int8 mode on the
    same values (bit for bit: the int8 kernels' tiles, segments and
    per-lane order) and a rerun; logical widths not a multiple of 32, one
    and two blocks (a two-block plan at ragged widths)."""
    g = torch.Generator(device=dev).manual_seed(31 + n + pe)
    X8, X4, Xf = _int4_blocks(g, dev, n, pe, pf, binary)
    rest = [Xf] if pf else []
    counters = {'rows': 'ne_rows_i4', 'cols': 'colpass_i4',
                'tdots4': 'tdots_i4', 'tdots5': 'tdots_i4[u4]'}
    for mode, (kern, plain) in _nibble_calls(g, dev, n, pe, pf).items():
        reset_launch_counts()
        got = kern([X4] + rest)
        assert launch_counts()[counters[mode]] == 1, mode
        again = kern([X4] + rest)
        _assert_close(got, plain([X4] + rest))
        i8 = kern([X8] + rest)
        for x, y, z in zip(got, again, i8):
            assert torch.equal(x, y) and torch.equal(x, z), mode


@pytest.mark.parametrize('binary', [False, True])
@pytest.mark.parametrize('n,pe,pf', [(1045, 4097, 513), (1045, 45, 0),
                                     (2999, 8191, 100),
                                     (200_003, 4097, 513)])
def test_nibble_presolve_modes(dev, n, pe, pf, binary):
    """The nibble pre-solve, four and five reductions, on values in
    [-8, 7] and (binary) on 0/1 values in both its modes: against its
    plain version, a rerun and the int8 mode, the last two bit for bit.
    Logical widths not a multiple of 32, one and two blocks, row segments
    not a multiple of the 16 rows a lane loads at once (at 200,003 rows,
    longer than the 1,024 rows of u staged at a time)."""
    g = torch.Generator(device=dev).manual_seed(41 + n + pe)
    X8, X4, Xf = _int4_blocks(g, dev, n, pe, pf, binary)
    rest = [Xf] if pf else []
    ps = [pe, pf] if pf else [pe]
    us = [torch.randn(n, generator=g, device=dev) for _ in range(4)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = layout.presolve_i4_plan(n, pe, pf, sms)
    assert plan.rows_per_seg % 16, plan

    def flat(r):
        return [o for blk in r for o in blk]
    for k in (4, 5):
        u = us[:k - 1]
        i8 = flat(tdots_sweep([X8] + rest, ps, *u))
        ref = flat(tdots_sweep_plain([X4] + rest, ps, *u))
        for mode in ((False, True) if binary else (False,)):
            tag = ','.join(t for t, on in (('u4', k == 5), ('bin', mode))
                           if on)
            reset_launch_counts()
            got = flat(tdots_sweep([X4] + rest, ps, *u, binary=mode))
            assert launch_counts()['tdots_i4' + (f'[{tag}]' if tag
                                                 else '')] == 1
            again = flat(tdots_sweep([X4] + rest, ps, *u, binary=mode))
            _assert_close(got, ref)
            for w, x, y in zip(got, again, i8):
                assert torch.equal(w, x) and torch.equal(w, y), (k, mode)


def test_nibble_presolve_plan_matches_library(dev):
    """kernels.layout's mirror of the nibble pre-solve's geometry equals
    the library's (bb_tdots_i4_plan)."""
    lib = load_library().lib
    mirror = layout.presolve_i4_plan(1, 1, 1, 1)
    assert [lib.bb_tdots_i4_plan(f) for f in range(6)] == [
        layout.PRESOLVE_I4['urows'], *mirror.tile_columns,
        mirror.min_blocks, mirror.smem_bytes, -1]


def test_nibble_chain_batches_run_single_launches(dev):
    """ne_rows_k, colpass_k and tdots_sweep_k over an int4 block: one
    single-vector launch per chain, counted apart, each chain its single
    launch's bits."""
    g = torch.Generator(device=dev).manual_seed(7)
    n, pe, pf, k = 2000, 1500, 70, 3
    _, X4, Xf = _int4_blocks(g, dev, n, pe, pf, True)
    Xs, ps = [X4, Xf], [pe, pf]
    V = [torch.randn((k, p), generator=g, device=dev) for p in ps]
    c = torch.randn(k, generator=g, device=dev)
    U = torch.randn((k, n), generator=g, device=dev)
    reset_launch_counts()
    T = ne_rows_k(list(zip(Xs, V)), c)
    C = colpass_k(Xs, ps, U)
    R = tdots_sweep_k(Xs, ps, U, U, U, U)
    counts = launch_counts()
    assert counts['ne_rows_i4[chains]'] == counts['colpass_i4[chains]'] \
        == counts['tdots_i4[u4,chains]'] == k
    assert counts['ne_rows_k'] == counts['colpass_k'] == 0
    for i in range(k):
        assert torch.equal(T[i], ne_rows(list(zip(Xs, [v[i] for v in V])),
                                         c[i]))
        for b, o in enumerate(colpass(Xs, ps, U[i])):
            assert torch.equal(C[b][i], o)
        for b, blk in enumerate(tdots_sweep(Xs, ps, U[i], U[i], U[i],
                                            U[i])):
            for r, o in enumerate(blk):
                assert torch.equal(R[b][r][i], o)


def test_int4_design_chain_resumes_exactly_on_card(dev, monkeypatch):
    """The int4 tier on the card: the probe asks the library, 'auto'
    stores a packed block, a chain runs the nibble modes only (no fused
    sweep) and resumes exactly."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    from bayesbridge_tpu_torch.design import sparse as sparse_mod
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    assert sparse_mod._int4_supported(dev) is True
    X, outcome = _chain_problem()
    model = RegressionModel(outcome, X, family='logit')
    assert layout.is_int4(model.design.X_exact)
    assert model.design.fused_ne_mode('link') is None
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    reset_launch_counts()
    full, _ = bridge.gibbs(12, seed=0, coef_sampler_type='cg',
                           params_to_save='all')
    counts = launch_counts()
    assert counts['ne_rows_i4'] > 12 and counts['colpass_i4'] > 12
    # A 0/1 packed block: the pre-solve's binary mode.
    assert model.design.int4_binary
    assert counts['tdots_i4[u4,bin]'] == 12 and counts['tdots_i4[u4]'] == 0
    assert counts['ne_sweep[rows]'] == counts['ne_oneread[logit]'] == 0
    part, info = bridge.gibbs(7, seed=0, coef_sampler_type='cg',
                              params_to_save='all')
    merged, _ = bridge.gibbs_resume(info, 5, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])


# The rejection draws on the card (csrc/polya_gamma.cu,
# csrc/tilted_stable.cu): the kernels against the plain rounds in law.
# The closed forms are those of tests/test_torch_random.py (which imports
# jax, so they are restated here): tilted stable with Laplace transform
# exp(-s^alpha), E = alpha t^(alpha-1), Var = alpha (1-alpha) t^(alpha-2);
# PG(b, z), E = b tanh(z/2) / (2z), Var = b (tanh(z/2) - (z/2) /
# cosh(z/2)^2) / (2 z^3) (at z = 0: b / 4 and b / 24).

DRAW_N = 100_000


def _ts_moments(alpha, tilt):
    return alpha * tilt ** (alpha - 1.0), \
        alpha * (1.0 - alpha) * tilt ** (alpha - 2.0)


def _pg_moments(b, z):
    if z == 0:
        return b / 4.0, b / 24.0
    mean = b * np.tanh(z / 2.0) / (2.0 * z)
    var = b * (np.tanh(z / 2.0) - (z / 2.0) / np.cosh(z / 2.0) ** 2) \
        / (2.0 * z ** 3)
    return mean, var


def _check_mean_var(draws, mean, var, check_var=True):
    """Mean within 6 standard errors, variance within 10% + 6 var /
    sqrt(n) (tests/test_torch_random.py's limits)."""
    n = draws.size
    assert np.all(np.isfinite(draws)) and np.all(draws > 0)
    assert abs(draws.mean() - mean) < 6 * np.sqrt(var / n), \
        f"mean {draws.mean():.6g} vs expected {mean:.6g}"
    if check_var:
        assert abs(draws.var() - var) < 0.1 * var + 6 * var / np.sqrt(n), \
            f"var {draws.var():.6g} vs expected {var:.6g}"


def _gens(dev, seeds):
    return [torch.Generator(device=dev).manual_seed(s) for s in seeds]


def test_philox_matches_curand_and_plain(dev):
    """csrc/philox.cuh's Philox4x32-10 equals curand_Philox4x32_10 and
    the plain torch version on random counters and keys; a lane's stream
    takes the words of counters (lane, 0, block, 0) in order, its
    uniforms are (k + 1/2) 2^-23 of the top 23 bits (float) or 53 bits
    of two words times 2^-53 (double), and its normals Box-Muller's
    cosine branch."""
    from bayesbridge_tpu_torch.kernels.draws import philox_plain
    kl = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    n = 4096
    ctr = rng.integers(0, 2 ** 32, (n, 4), dtype=np.uint64)
    ctr[:2] = [[0, 0, 0, 0], [2 ** 32 - 1] * 4]
    key = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64)
    key[:2] = [[0, 0], [2 ** 32 - 1] * 2]
    as32 = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))
    c32, k32 = as32(ctr).to(dev), as32(key).to(dev)
    ours = torch.empty((n, 4), dtype=torch.int32, device=dev)
    theirs = torch.empty_like(ours)
    kl.check(kl.lib.bb_philox_check(c32.data_ptr(), k32.data_ptr(),
                                    ours.data_ptr(), theirs.data_ptr(), n,
                                    stream), 'philox_check')
    assert torch.equal(ours, theirs)
    plain = philox_plain(torch.from_numpy(ctr.astype(np.int64)).to(dev),
                         torch.from_numpy(key.astype(np.int64)).to(dev))
    assert torch.equal(ours.to(torch.int64) & 0xFFFFFFFF, plain)
    # ours[0] is Random123's known answer for zero counter and key.
    assert [hex(int(w) & 0xFFFFFFFF) for w in ours[0]] == [
        '0x6627e8d5', '0xe169c58d', '0xbc57ac4c', '0x9b00dbd8']
    key64, lane, n_words, n_draws = 0x243F6A8885A308D3, 77, 40, 64
    for dtype in (torch.float32, torch.float64):
        words = torch.empty(n_words, dtype=torch.int32, device=dev)
        unif = torch.empty(n_draws, dtype=dtype, device=dev)
        norm = torch.empty(n_draws, dtype=dtype, device=dev)
        kl.check(kl.lib.bb_philox_stream(
            int(dtype == torch.float64), key64, lane, words.data_ptr(),
            n_words, unif.data_ptr(), norm.data_ptr(), n_draws, stream),
            'philox_stream')

        def stream_words(ln, count):
            blocks = torch.tensor([[ln, 0, b, 0] for b in range(
                -(-count // 4))], dtype=torch.int64)
            k = torch.tensor([[key64 & 0xFFFFFFFF, key64 >> 32]] *
                             blocks.shape[0], dtype=torch.int64)
            return philox_plain(blocks, k).reshape(-1)[:count]
        assert torch.equal(words.cpu().to(torch.int64) & 0xFFFFFFFF,
                           stream_words(lane, n_words))
        def uniforms(ln, count):
            if dtype == torch.float32:
                w = stream_words(ln, count)
                return (((w >> 9).double() + 0.5) * 2.0 ** -23).float()
            w = stream_words(ln, 2 * count).view(-1, 2)
            u = ((w[:, 0] << 21) | (w[:, 1] >> 11)).double() * 2.0 ** -53
            return u.clamp_min(torch.finfo(dtype).tiny)
        ref = uniforms(lane + 1, n_draws)
        assert torch.equal(unif.cpu(), ref)
        assert 0 < float(ref.min()) and float(ref.max()) < 1
        g = uniforms(lane + 2, 2 * n_draws).double().view(-1, 2)
        box = torch.sqrt(-2 * torch.log(g[:, 0])) * torch.cos(
            2 * np.pi * g[:, 1])
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert float((norm.cpu().double() - box).abs().max()) < tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_polya_gamma_kernel_matches_plain(dev, dtype):
    """PG(1, z) at z in {0, 0.1, 1, 4, 20, 40} (100,000 lanes each, one
    launch): the kernel against the plain rounds by KS (p > 1e-4) and
    against the closed-form moments; integer shapes 1, 2, 5 against
    theirs; no capped lane."""
    from scipy.stats import ks_2samp
    from bayesbridge_tpu_torch.kernels import draws
    from bayesbridge_tpu_torch.random.polya_gamma import (
        sample_polya_gamma_chains, sample_polya_gamma_plain,
    )
    zs = [0.0, 0.1, 1.0, 4.0, 20.0, 40.0]
    z = torch.tensor(np.repeat(zs, DRAW_N), dtype=dtype, device=dev)[None]
    before = draws.capped_lanes(dev)
    reset_launch_counts()
    kern = sample_polya_gamma_chains(_gens(dev, [1]), None, z)
    assert launch_counts()['pg_draw'] == 1
    plain = sample_polya_gamma_plain(_gens(dev, [2]), None, z)
    assert launch_counts()['pg_draw'] == 1
    assert kern.dtype == dtype
    kern = kern.double().cpu().numpy().reshape(len(zs), DRAW_N)
    plain = plain.double().cpu().numpy().reshape(len(zs), DRAW_N)
    for i, zi in enumerate(zs):
        assert ks_2samp(kern[i], plain[i]).pvalue > 1e-4, zi
        _check_mean_var(kern[i], *_pg_moments(1.0, zi))
    shapes = np.tile(np.array([1, 2, 5], dtype=np.int64), 30_000)
    b = torch.as_tensor(shapes, dtype=torch.int32, device=dev)
    tilt = torch.full((1, shapes.size), 1.3, dtype=dtype, device=dev)
    got = sample_polya_gamma_chains(_gens(dev, [3]), b, tilt)
    got = got.double().cpu().numpy()[0]
    for bi in (1, 2, 5):
        sel = got[shapes == bi]
        mean, var = _pg_moments(float(bi), 1.3)
        assert abs(sel.mean() - mean) < 6 * np.sqrt(var / sel.size)
    assert draws.capped_lanes(dev)[0] == before[0]


TS_CASES = [(0.25, 16.0)] + [(a, t) for a in (0.25, 0.5)
                             for t in (1e-30, 1e-6, 0.1, 1.0, 100.0, 1e4)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_tilted_stable_kernel_matches_plain(dev, dtype):
    """Tilted stable at alpha 0.25 and 0.5 with tilts on both sides of the
    crossover (16 at alpha = 0.25, its edge; 1e-30 to 1e4), 100,000 lanes
    each: the kernel against the plain rounds by KS (p > 1e-4), its mean
    against the closed form (its variance from a tilt of 0.1 up: below
    it the sample variance is too heavy-tailed to test at this size); the
    forced methods against each other; no capped lane. (The moments are
    the kernel's: the plain rounds' float32 uniform is torch.rand's,
    clamped at zero once in 2^24 draws, where divide-and-conquer accepts
    a partition draw however large: a rare outlier that KS does not see
    but a mean can, csrc/philox.cuh.)"""
    from scipy.stats import ks_2samp
    from bayesbridge_tpu_torch.kernels import draws
    from bayesbridge_tpu_torch.random.tilted_stable import (
        sample_tilted_stable_chains, sample_tilted_stable_plain,
    )
    before = draws.capped_lanes(dev)
    for alpha in (0.25, 0.5):
        tilts = [t for a, t in TS_CASES if a == alpha]
        x = torch.tensor(np.repeat(tilts, DRAW_N), dtype=dtype,
                         device=dev)[None]
        kern = sample_tilted_stable_chains(_gens(dev, [4]), alpha, x)
        plain = sample_tilted_stable_plain(_gens(dev, [5]), alpha, x)
        assert kern.dtype == dtype
        kern = kern.double().cpu().numpy().reshape(len(tilts), DRAW_N)
        plain = plain.double().cpu().numpy().reshape(len(tilts), DRAW_N)
        for i, t in enumerate(tilts):
            assert ks_2samp(kern[i], plain[i]).pvalue > 1e-4, (alpha, t)
            _check_mean_var(kern[i], *_ts_moments(alpha, t),
                            check_var=t >= 0.1)
    x = torch.full((1, DRAW_N), 2.5, dtype=dtype, device=dev)
    dc = sample_tilted_stable_chains(_gens(dev, [6]), 0.4, x,
                                     method='divide-conquer')
    dr = sample_tilted_stable_chains(_gens(dev, [7]), 0.4, x,
                                     method='double-rejection')
    dc, dr = (d.double().cpu().numpy()[0] for d in (dc, dr))
    assert ks_2samp(dc, dr).pvalue > 1e-4
    for d in (dc, dr):
        _check_mean_var(d, *_ts_moments(0.4, 2.5))
    assert draws.capped_lanes(dev)[1] == before[1]


def test_tilted_stable_kernel_plan_and_forced_partitions(dev):
    """The kernel's per-lane plan (m partitions, 0 for double rejection)
    equals the plain version's (``lane_plan``), for each method, on tilts
    whose tilt**alpha lies away from an integer; forced
    divide-and-conquer with 50 partitions gives the full sum (mean
    against the closed form)."""
    from bayesbridge_tpu_torch.kernels.draws import tilted_stable_draw
    from bayesbridge_tpu_torch.random.tilted_stable import lane_plan
    alpha = 0.5
    rng = np.random.default_rng(3)
    tp = np.floor(rng.uniform(0, 40, 20_000)) + rng.uniform(0.05, 0.95,
                                                             20_000)
    x = torch.tensor(tp ** (1 / alpha), dtype=torch.float32,
                     device=dev)[None]
    for method in (None, 'divide-conquer', 'double-rejection'):
        plan = torch.empty(x.shape, dtype=torch.int32, device=dev)
        tilted_stable_draw(_gens(dev, [8]), alpha, x, method, plan=plan)
        assert torch.equal(plan, lane_plan(alpha, x, method)), method
    n, tilt = 30_000, 2500.0
    x = torch.full((1, n), tilt, device=dev)
    plan = torch.empty(x.shape, dtype=torch.int32, device=dev)
    d = tilted_stable_draw(_gens(dev, [9]), alpha, x, 'divide-conquer',
                           plan=plan)
    assert int(plan.min()) == int(plan.max()) == 50
    d = d.double().cpu().numpy()[0]
    mean, var = _ts_moments(alpha, tilt)
    assert np.all(d > 0)
    assert abs(d.mean() - mean) < 6 * np.sqrt(var / n) + 0.02 * mean


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_draws_rerun_and_chains_alone_bit_for_bit(dev, dtype):
    """Both kernels: a rerun from the same generator states gives the same
    bits, and for k = 1, 3, 8 chains row c equals chain c drawn alone
    (one key per chain, lane j of chain c on the stream (key_c, j))."""
    from bayesbridge_tpu_torch.random.polya_gamma import (
        sample_polya_gamma_chains,
    )
    from bayesbridge_tpu_torch.random.tilted_stable import (
        sample_tilted_stable_chains,
    )
    g = torch.Generator(device=dev).manual_seed(10)
    n = 5_000
    for k in (1, 3, 8):
        z = torch.randn((k, n), generator=g, device=dev, dtype=dtype) * 4
        t = torch.exp(torch.randn((k, n), generator=g, device=dev,
                                  dtype=dtype) * 6)
        b = torch.randint(1, 4, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        seeds = [100 * k + c for c in range(k)]
        cases = [
            (lambda gs, x, b=b: sample_polya_gamma_chains(gs, b, x), z),
            (lambda gs, x: sample_polya_gamma_chains(gs, None, x), z),
            (lambda gs, x: sample_tilted_stable_chains(gs, 0.25, x), t)]
        for draw, x in cases:
            gens = _gens(dev, seeds)
            first = draw(gens, x)
            assert torch.equal(first, draw(_gens(dev, seeds), x))
            for c in range(k):
                alone = draw(_gens(dev, [seeds[c]]), x[c:c + 1])
                assert torch.equal(first[c:c + 1], alone)
            # The generators moved on: the next call differs.
            assert not torch.equal(first, draw(gens, x))


def test_draws_take_no_host_sync(dev):
    """Both dispatch points on the card complete under
    torch.cuda.set_sync_debug_mode('error') (after a warm-up call that
    builds the library and makes the capped-lane counter)."""
    from bayesbridge_tpu_torch.random.polya_gamma import (
        sample_polya_gamma_chains,
    )
    from bayesbridge_tpu_torch.random.tilted_stable import (
        sample_tilted_stable_chains,
    )
    z = torch.randn((2, 10_000), device=dev)
    b = torch.full((10_000,), 2, dtype=torch.int32, device=dev)
    gens = _gens(dev, [11, 12])
    sample_polya_gamma_chains(gens, None, z)
    sample_tilted_stable_chains(gens, 0.5, z * z)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for method in (None, 'divide-conquer', 'double-rejection'):
            sample_tilted_stable_chains(gens, 0.5, z * z, method)
        sample_polya_gamma_chains(gens, None, z)
        sample_polya_gamma_chains(gens, b, z.double())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_logit_chain_draws_on_the_kernels_and_resumes(dev):
    """A logit chain on the card draws every Polya-Gamma and local-scale
    variate on the kernels (pg_draw and ts_draw at least once an
    iteration), with trial counts above 1 held on the card, and
    gibbs_resume and gibbs_chains_resume stay exact."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel, gibbs_chains,
    )
    from bayesbridge_tpu_torch.multichain import gibbs_chains_resume
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome,
    )
    X = simulate_design(500, 40, binary_frac=.8, seed=1)
    beta = np.zeros(40)
    beta[:3] = 1.0
    n_trial = 1 + np.random.default_rng(2).binomial(4, .5, 500)
    outcome = simulate_outcome(X, beta, 'logit', n_trial=n_trial, seed=3)
    model = RegressionModel(outcome, X, family='logit')
    assert model.pg_shape.device.type == 'cuda'
    assert torch.equal(model.pg_shape.cpu(),
                       torch.as_tensor(n_trial, dtype=torch.int32))
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    reset_launch_counts()
    full, _ = bridge.gibbs(8, seed=0, coef_sampler_type='cg',
                           params_to_save='all')
    counts = launch_counts()
    assert counts['pg_draw'] >= 8 and counts['ts_draw'] >= 8, counts
    part, info = bridge.gibbs(5, seed=0, coef_sampler_type='cg',
                              params_to_save='all')
    merged, _ = bridge.gibbs_resume(info, 3, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
    chains, _ = gibbs_chains(bridge, 6, 3, seed=4, coef_sampler_type='cg')
    part, p_info = gibbs_chains(bridge, 4, 3, seed=4,
                                coef_sampler_type='cg')
    merged, _ = gibbs_chains_resume(bridge, p_info, 2, merge=True,
                                    prev_samples=part)
    for key in chains:
        np.testing.assert_array_equal(merged[key], chains[key])


# -- the CG solve's device loop ------------------------------------------- #

CG_CASES = ['hybrid', 'hybrid_auto', 'hybrid_fused', 'int4', 'dense',
            'dense_fused', 'bitpack', 'winell', 'ell32', 'ell64', 'sharded']


def _cg_design(case, dev, monkeypatch):
    """_chain_problem's X as `case`'s design on the card: the hybrid
    block-ordered ('0'), under 'auto' and fused ('1'), its int4 tier, the
    dense design composed and fused, bitpack, winell, ell in float32 and
    float64, and the hybrid on a 4-shard mesh of the one card."""
    from bayesbridge_tpu_torch.design import (
        DenseDesignMatrix, SparseDesignMatrix,
    )
    from bayesbridge_tpu_torch.parallel import make_mesh, shard_design
    X, _ = _chain_problem()
    if case.startswith('dense'):
        return DenseDesignMatrix(X.toarray(), center_predictor=True,
                                 fused='1' if case == 'dense_fused' else None,
                                 device=dev)
    if case == 'int4':
        monkeypatch.setenv('BB_HYBRID_INT4', '1')
    backend = {'ell32': 'ell', 'ell64': 'ell', 'bitpack': 'bitpack',
               'winell': 'winell'}.get(case, 'hybrid')
    fused = {'hybrid': '0', 'hybrid_fused': '1', 'sharded': '0'}.get(case)
    design = SparseDesignMatrix(
        X, center_predictor=True, backend=backend, fused=fused,
        dtype=np.float64 if case == 'ell64' else np.float32, device=dev)
    if case == 'sharded':
        design = shard_design(design, make_mesh(devices=[dev] * 4))
    return design


def _cg_inputs(design, k, seed, warm=False, lin=False):
    """The (k, .) inputs of ops.cg.host_solve / device_solve: random
    weights, prior scales, right-hand sides and starts, the Jacobi
    preconditioner; the last chain's residual starts at 0 (0
    iterations)."""
    n, p = design.shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=design.dtype, device=design.device)

    w = t(rng.exponential(size=(k, n)) * .25 + .05)
    pps = rng.uniform(.3, 3., size=(k, p))
    pps[:, 0] = 1e-3
    pps = t(pps)
    z = design.Tdot(t(rng.standard_normal((k, n))) * w)
    pert = t(rng.standard_normal((k, p)) * 2)
    coef = t(rng.standard_normal((k, p)) * .1)
    for v in (z, pert, coef):
        v[-1] = 0
    s = 1 / torch.sqrt(pps ** 2 + design.compute_fisher_diag(w))
    inp = {'z': z, 'pert': pert, 'pps': pps, 's': s, 'w': w, 'coef': coef}
    if warm:
        lin0 = design.dot(coef)
        inp['warm'] = design.Tdot(w * lin0)
        if lin:
            inp['lin0'] = lin0
    return inp


def _count_reads(mp):
    """Count reads from the card to the host (Tensor.cpu, .item, .tolist,
    .numpy, bool/int/float of a CUDA tensor) while `mp` holds."""
    reads = [0]
    for name in ('cpu', 'item', 'tolist', 'numpy', '__bool__', '__int__',
                 '__float__'):
        def wrap(self, *args, _orig=getattr(torch.Tensor, name), **kw):
            if self.device.type == 'cuda':
                reads[0] += 1
            return _orig(self, *args, **kw)
        mp.setattr(torch.Tensor, name, wrap)
    return reads


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_cg_update_kernels_match_plain(dev, dtype):
    """cg_start and cg_update against their plain versions one step at a
    time from the same state (rtol 1e-4 of max|plain|, 1e-12 in float64;
    the flags and counts equal), a chain whose flag is clear untouched bit
    for bit, each chain of the batch equal to the chain alone bit for bit,
    and a rerun's bits."""
    from bayesbridge_tpu_torch.kernels.cg_loop import (
        CgState, cg_start, cg_start_plain, cg_update, cg_update_plain,
    )
    k, m, n = 5, 3001, 1777
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    names = ('x', 'r', 'p', 'sp', 'b', 's', 'd', 'y', 'rs', 'thresh',
             'atol', 'n_iter', 'running')

    def copy(dst, src, rows=slice(None)):
        for name in names:
            s = getattr(src, name)
            getattr(dst, name).copy_(s if name == 'atol' else s[rows])

    st = CgState(k, m, n, dtype, dev, maxiter=9)
    for name in ('x', 'r', 'b', 'y'):
        getattr(st, name).copy_(rnd(*getattr(st, name).shape))
    st.s.copy_(rnd(k, m).abs() + .1)
    st.d.copy_(rnd(k, m).abs() + .1)
    st.atol.fill_(1e-3)
    plain = CgState(k, m, n, dtype, dev, maxiter=9)
    copy(plain, st)
    cg_start(st)
    cg_start_plain(plain)
    vec = ('x', 'r', 'p', 'sp', 'y', 'rs', 'thresh')

    def agree():
        for name in vec:
            got, ref = getattr(st, name), getattr(plain, name)
            assert float((got - ref).abs().max()) \
                <= tol * float(ref.abs().max()), name
        assert torch.equal(st.n_iter, plain.n_iter)
        assert torch.equal(st.running, plain.running)

    agree()
    assert int(st.running.sum()) == k
    st.running[1] = 0
    for _ in range(3):
        copy(plain, st)
        out, t = rnd(k, m), rnd(k, n)
        frozen = {name: getattr(st, name)[1].clone() for name in vec}
        start = CgState(k, m, n, dtype, dev, maxiter=9)
        copy(start, st)
        cg_update(st, out, t)
        cg_update_plain(plain, out, t)
        agree()
        for name in vec:
            assert torch.equal(getattr(st, name)[1], frozen[name]), name
        again = CgState(k, m, n, dtype, dev, maxiter=9)
        copy(again, start)
        cg_update(again, out, t)
        for c in range(k):
            one = CgState(1, m, n, dtype, dev, maxiter=9)
            copy(one, start, slice(c, c + 1))
            cg_update(one, out[c:c + 1], t[c:c + 1])
            for name in vec:
                assert torch.equal(getattr(one, name)[0],
                                   getattr(st, name)[c]), (name, c)
                assert torch.equal(getattr(again, name),
                                   getattr(st, name)), name
    assert torch.equal(st.n_iter[[0, 2, 3, 4]],
                       torch.full((4,), 3, dtype=torch.int32, device=dev))


@pytest.mark.parametrize('warm,lin', [(False, False), (False, True),
                                      (True, True)])
@pytest.mark.parametrize('case', CG_CASES)
def test_cg_device_loop_matches_host_loop(dev, case, warm, lin,
                                            monkeypatch):
    """The solve as one graph launch against the host-driven loop on the
    card, for every backend the device loop serves: the same n_cg_iter
    (chains of different counts, one that starts converged) and
    convergence flags, coef and the linear predictor within rtol 1e-4 of
    max|host| (1e-12 in float64); a rerun's bits, with the graph taken
    from the cache (no recapture) and one host read; the launch counters
    at the captured iteration's launches times max(n_iter); each chain
    of the batch equal to the chain alone bit for bit; maxiter stops
    both loops alike."""
    from bayesbridge_tpu_torch.ops import cg
    design = _cg_design(case, dev, monkeypatch)
    assert cg.takes_device_loop(design, dev)
    tol = 1e-12 if design.dtype == torch.float64 else 1e-4
    inp = _cg_inputs(design, 4, 11, warm, lin)
    atol = 1e-5 * np.sqrt(design.shape[1])
    ref = cg.host_solve(design, inp, 500, atol, lin)
    got = cg.device_solve(design, inp, 500, atol, lin)
    for key in ('n_cg_iter', 'cg_converged'):
        np.testing.assert_array_equal(got[2][key], ref[2][key])
    n_iter = ref[2]['n_cg_iter']
    assert n_iter[-1] == 0 and (n_iter[:-1] > 2).all(), n_iter
    assert ref[2]['cg_converged'].all()
    assert (ref[1] is None) == (not lin)
    for g_, r_ in zip(got[:2], ref[:2]):
        if r_ is not None:
            assert float((g_ - r_).abs().max()) \
                <= tol * float(r_.abs().max())
    loops = dict(cg._loops_of(design))
    assert len(loops) == 1
    (loop,) = loops.values()
    reset_launch_counts()
    with monkeypatch.context() as mp:
        reads = _count_reads(mp)
        again = cg.device_solve(design, inp, 500, atol, lin)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert reads[0] <= 1, reads[0]
    assert cg._loops_of(design) == loops
    for g_, a_ in zip(got[:2], again[:2]):
        assert g_ is None or torch.equal(g_, a_)
    iters = int(n_iter.max())
    assert counts['cg_update'] == iters and counts['cg_start'] == 1
    want = {}
    for rec, times in zip(loop.graph.counts, (1, iters)):
        for counter, key, n in rec:
            cell = want.setdefault((id(counter), key), [counter, key, 0])
            cell[2] += n * times
    # The dense design composes on torch.matmul (no kernel of ours).
    cublas = case == 'dense' or case == 'dense_fused' and lin
    assert len(want) >= (2 if cublas else 3), want
    for counter, key, n in want.values():
        assert counter[key] == n, (key, counter[key], n)
    for c in range(4):
        one = {key: v[c:c + 1] for key, v in inp.items()}
        alone = cg.device_solve(design, one, 500, atol, lin)
        assert alone[2]['n_cg_iter'][0] == n_iter[c]
        for g_, a_ in zip(got[:2], alone[:2]):
            assert g_ is None or torch.equal(a_[0], g_[c]), c
    capped = cg.device_solve(design, inp, 3, atol, lin)
    ref3 = cg.host_solve(design, inp, 3, atol, lin)
    np.testing.assert_array_equal(capped[2]['n_cg_iter'], [3, 3, 3, 0])
    np.testing.assert_array_equal(capped[2]['cg_converged'],
                                  ref3[2]['cg_converged'])
    assert not capped[2]['cg_converged'][:3].any()


def test_cg_device_loop_on_a_copy_of_the_design(dev, monkeypatch):
    """A copy of a design that has run a solve captures its own graph
    under the same key: the int8 design's int4 tier (with_exact_tier, a
    shallow copy under the same policy), solved after the int8 design is
    dropped, launches the nibble kernels and none of int8's, and agrees
    with the host loop."""
    import gc
    from bayesbridge_tpu_torch.ops import cg
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    d8 = _cg_design('hybrid', dev, monkeypatch)
    inp = _cg_inputs(d8, 4, 11)
    atol = 1e-5 * np.sqrt(d8.shape[1])
    cg.device_solve(d8, inp, 500, atol, False)
    (first,) = cg._loops_of(d8).values()
    d4 = d8.with_exact_tier('int4')
    del d8
    gc.collect()
    torch.cuda.empty_cache()
    ref = cg.host_solve(d4, inp, 500, atol, False)
    reset_launch_counts()
    got = cg.device_solve(d4, inp, 500, atol, False)
    torch.cuda.synchronize()
    counts = launch_counts()
    (loop,) = cg._loops_of(d4).values()
    assert loop is not first
    nibble = sum(n for key, n in counts.items() if '_i4' in key)
    assert nibble > 0, counts
    assert counts['ne_rows_k'] == counts['colpass_k'] == 0, counts
    np.testing.assert_array_equal(got[2]['n_cg_iter'], ref[2]['n_cg_iter'])
    assert float((got[0] - ref[0]).abs().max()) \
        <= 1e-4 * float(ref[0].abs().max())


def test_gibbs_takes_the_device_loop(dev):
    """A logit chain on the card runs every CG solve as the device loop:
    one graph for the run (captured on the first iteration, then taken
    from the cache), cg_update launched max(n_cg_iter) times a solve, and
    at most one host read in each solve."""
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel,
    )
    from bayesbridge_tpu_torch.ops import cg
    X, outcome = _chain_problem()
    model = RegressionModel(outcome, X, family='logit')
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    _, info = bridge.gibbs(3, seed=0, coef_sampler_type='cg')
    assert len(cg._loops_of(model.design)) == 1
    reset_launch_counts()
    reads = []
    solve = cg.device_solve

    def counted(*args, **kw):
        with pytest.MonkeyPatch.context() as mp:
            r = _count_reads(mp)
            out = solve(*args, **kw)
        reads.append(r[0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cg, 'device_solve', counted)
        _, more = bridge.gibbs_resume(info, 4)
    n_cg = more['_reg_coef_sampling_info']['n_cg_iter']
    assert reads == [1] * 4, reads
    assert launch_counts()['cg_update'] == int(np.sum(n_cg))
    assert len(cg._loops_of(model.design)) == 1


def test_cg_device_loop_from_threads(dev):
    """Threads solving on one design at once (gibbs_chains(mesh=) drives a
    chain group a thread, several on one card) get the serial solves'
    bits: one capture of the key's graph, each solve under its lock."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    from bayesbridge_tpu_torch.ops import cg
    design = _cg_design('hybrid', dev, None)
    inps = [_cg_inputs(design, 2, seed, True, True) for seed in range(6)]
    atol = 1e-5 * np.sqrt(design.shape[1])
    serial = [cg.device_solve(design, inp, 500, atol, True) for inp in inps]
    fresh = _cg_design('hybrid', dev, None)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(cg.device_solve, fresh, inp, 500, atol,
                                   True) for inp in inps * 2]
            got = [f.result(timeout=300) for f in futures]
    finally:
        sys.setswitchinterval(switch)
    assert len(cg._loops_of(fresh)) == 1
    for g, s in zip(got, serial * 2):
        assert torch.equal(g[0], s[0]) and torch.equal(g[1], s[1])
        np.testing.assert_array_equal(g[2]['n_cg_iter'], s[2]['n_cg_iter'])
