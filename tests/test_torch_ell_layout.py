"""The ell backend's col-ELL layout, the windowed traversal's host side
(``kernels.ell.EllLayout``, ``col_layout``, ``win_plan``, the dispatch by
bytes ``takes_window``), the staged traversal's (``stage_plan``,
``takes_stage``) and the harness's cluster copy's plan, on the CPU.

* the layout's valid slots, ascending flag and window pointers against
  scipy's CSC of the same matrix: on the fresh build, on the arrays of the
  JAX design (``bayesbridge_tpu.design.ell.dual_ell_from_scipy``) carried
  over by ``convert.packed_design_from_numpy``, with explicit zeros, empty
  columns and an input CSR whose indices are unsorted;
* which layout the design keeps (``col_layout``): none on the CPU, window
  pointers only where they pay on the card and stay within their share
  of the arrays' bytes;
* the launch plan: whole windows of GRAIN inputs, shared memory within
  the H100's 232,448 bytes, bulk copies in multiples of 16 bytes, CTAs
  covering the rows within the kernel's rows a CTA (read from
  ``csrc/ell.cu``); the dispatch against the traversal that ran faster
  in the timings in turns at the ell slice's shapes;
* the windowed traversal's order, emulated: each lane adds the same slots
  in the same order as in the first traversal, so the sums are the same
  bits;
* ``ell_matvec_k`` through the layout against the JAX ell design's `Tdot`
  and Fisher diagonal (float32 1e-5, float64 1e-12 of max|JAX|);
* the staged traversal's stage: whole 16-byte units within the shared
  memory a CTA may take, at the ell slice's 16,384 inputs, the
  flagship's 50,000 and ragged counts; the dispatch against the harness's
  turns; its order, emulated, the first traversal's sums;
* the harness's cluster copy (``baselines/ell_variants.py``
  ``cluster_plan``): the smallest cluster whose CTAs hold the vectors,
  partial stages, every staged input found where that kernel looks.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu_torch import convert
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.design.ell import dual_ell_from_scipy
from bayesbridge_tpu_torch.design.sparse import PACKED_ARRAYS
from bayesbridge_tpu_torch.kernels import build
from bayesbridge_tpu_torch.kernels import ell as ell_mod
from bayesbridge_tpu_torch.baselines.ell_variants import (
    CHUNK, CLUSTERS, cluster_plan,
)
from bayesbridge_tpu_torch.kernels.ell import (
    GRAIN, EllLayout, col_layout, ell_matvec_k, stage_plan, takes_stage,
    takes_window, win_plan,
)

torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _kernel_rows(dtype, k):
    """The windowed kernel's most ELL rows a CTA for k vectors, read from
    csrc/ell.cu (kWinWarps times the kRowsF64 / kRowsF32 entry), as
    ``bb_ell_win_rows`` returns them on the card."""
    src = (build.CSRC / 'ell.cu').read_text()
    warps = int(re.search(r'constexpr int kWinWarps = (\d+);', src)[1])
    table = 'kRowsF64' if dtype == torch.float64 else 'kRowsF32'
    rows = re.search(rf'constexpr int {table}\[kMaxVectors \+ 1\] = '
                     rf'\{{([^}}]*)\}}', src)[1].split(',')
    return warps * int(rows[k])


def _h100(dtype, k):
    """The card as ``kernels.ell.card_of`` gives it for an H100 (132 SMs)."""
    return 132, _kernel_rows(dtype, k)


def _matrix(seed=0, n=3000, p=40, unsorted=False):
    """Normal values at 3% density over n rows spanning several windows of
    GRAIN inputs; empty columns, a dense column, explicit zeros (one at
    row 0 alone in its column, one inside a column); with `unsorted` the
    CSR's indices are reversed within each row."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)) * (rng.random((n, p)) < .03)
    X[:, [4, 9]] = 0.0
    X[:, 11] = rng.standard_normal(n)
    X[:, 20] = 0.0
    X = sps.csr_matrix(X)
    X = sps.csr_matrix((np.r_[X.data, 0.0, 0.0],
                        (np.r_[np.repeat(np.arange(n), np.diff(X.indptr)),
                               0, 17],
                         np.r_[X.indices, 20, 11])), shape=(n, p))
    X.sum_duplicates()  # the two zeros stay explicit entries
    if unsorted:
        for r in range(n):
            a, b = X.indptr[r], X.indptr[r + 1]
            X.indices[a:b] = X.indices[a:b][::-1].copy()
            X.data[a:b] = X.data[a:b][::-1].copy()
        X.has_sorted_indices = False
    return X


def _expected(X):
    """(valid, pointers) of X's columns from scipy's CSC: the entries less
    any trailing (row 0, value 0) ones, and per column the first entry at
    or past each multiple of GRAIN rows."""
    C = X.tocsc()
    n = X.shape[0]
    n_grains = -(-n // GRAIN)
    valid, ptr = [], []
    for j in range(X.shape[1]):
        rows = C.indices[C.indptr[j]:C.indptr[j + 1]]
        vals = C.data[C.indptr[j]:C.indptr[j + 1]]
        v = len(rows)
        while v and rows[v - 1] == 0 and vals[v - 1] == 0:
            v -= 1
        valid.append(v)
        p = np.searchsorted(rows[:v], np.arange(n_grains + 1) * GRAIN)
        p[-1] = v
        ptr.append(p)
    return np.array(valid), np.array(ptr)


def _kept(X):
    """X without the columns a design drops (no non-zero value)."""
    return X[:, np.flatnonzero(abs(X).sum(axis=0))]


def _check_layout(lay, X):
    valid, ptr = _expected(X)
    assert lay.ascending and lay.n_in == X.shape[0]
    np.testing.assert_array_equal(lay.valid.numpy(), valid)
    assert lay.win_ptr.dtype == torch.int32
    np.testing.assert_array_equal(lay.win_ptr.numpy(), ptr)


@pytest.mark.parametrize('unsorted', [False, True])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_layout_matches_scipy_csc(dtype, unsorted):
    """Fresh build: the design's col-ELL layout, and the arrays' own."""
    X = _matrix(seed=1 + unsorted, unsorted=unsorted)
    assert X.tocsc().has_sorted_indices
    (ri, rv), (ci, cv) = dual_ell_from_scipy(X, dtype)
    assert np.any(ci == 0) and np.any(cv == 0)  # padding and zeros present
    _check_layout(EllLayout.from_numpy(ci, cv, X.shape[0]), X)
    # The row-ELL of an unsorted CSR keeps its order: no windowed layout.
    rows = EllLayout.from_numpy(ri, rv, X.shape[1])
    assert rows.ascending is not unsorted
    assert (rows.win_ptr is None) is unsorted
    with pytest.warns(UserWarning, match='Intercept'):
        td = SparseDesignMatrix(X, add_intercept=False, backend='ell',
                                dtype=dtype, device='cpu')
    assert td.col_layout is None  # the CPU runs the plain version
    _check_layout(EllLayout.from_numpy(td.col_idx.numpy(),
                                       td.col_val.numpy(), X.shape[0]),
                  _kept(X))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_layout_from_jax_design_arrays(dtype):
    """The JAX design's dual ELL arrays carried over: the same layout."""
    from bayesbridge_tpu.design.ell import (
        dual_ell_from_scipy as jax_dual_ell,
    )
    X = _matrix(seed=3)
    (_, _), (ci, cv) = jax_dual_ell(X, dtype)
    _check_layout(EllLayout.from_numpy(np.asarray(ci), np.asarray(cv),
                                       X.shape[0]), X)
    with pytest.warns(UserWarning, match='Intercept'):
        jd = JaxDesign(X, add_intercept=False, backend='ell', dtype=dtype)
    kept = _kept(X)
    td = convert.packed_design_from_numpy(
        'ell', {name: np.asarray(getattr(jd, name))
                for name in PACKED_ARRAYS['ell']},
        None, np.zeros(kept.shape[1]), kept.shape, kept.nnz,
        add_intercept=False, device='cpu')
    assert td.col_layout is None
    _check_layout(EllLayout.from_numpy(td.col_idx.numpy(),
                                       td.col_val.numpy(), X.shape[0]),
                  kept)


def test_layout_refuses_indices_out_of_range():
    idx = np.array([[0, 5, 12]], np.int32)
    val = np.ones((1, 3))
    with pytest.raises(ValueError, match='outside'):
        EllLayout.from_numpy(idx, val, 12)
    lay = EllLayout.from_numpy(idx, val, 13)
    assert lay.ascending and int(lay.valid[0]) == 3


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('k', range(1, 9))
def test_plan_fits_the_card(dtype, k):
    """Every launch of the ell slice's col-ELL, and of small and ragged
    shapes: whole windows of GRAIN inputs covering the inputs, shared
    memory within the H100's 232,448 bytes, bulk copies of whole 16-byte
    units, CTAs covering the rows within the kernel's rows a CTA."""
    item = 8 if dtype == torch.float64 else 4
    for m, n_in in ((16_384, 262_144), (333, 1000), (1, 1), (700, 70_000),
                    (50_000, 1_000_003)):
        plan = win_plan(dtype, k, m, n_in, *_h100(dtype, k))
        w = plan['window']
        assert w % GRAIN == 0 and plan['stride'] == w // GRAIN
        assert w * k * item <= ell_mod.WIN_BYTES[k - 1] or w == GRAIN
        assert plan['n_pad'] == plan['n_win'] * w >= n_in
        assert (plan['n_win'] - 1) * w < n_in
        assert plan['copy_bytes'] == w * k * item
        assert plan['copy_bytes'] % 16 == 0
        assert plan['smem_bytes'] == ell_mod.STAGES * plan['copy_bytes']
        assert plan['smem_bytes'] <= ell_mod.MAX_SMEM == 232_448
        assert 1 <= plan['rows_cta'] <= _kernel_rows(dtype, k)
        assert plan['n_cta'] * plan['rows_cta'] >= m
        assert (plan['n_cta'] - 1) * plan['rows_cta'] < m
    plan = win_plan(dtype, k, 16_384, 262_144, *_h100(dtype, k))
    rows = _kernel_rows(dtype, k)
    assert plan['n_cta'] == (132 if rows >= 125 else -(-16_384 // rows))


# The ell slice's design (262,144 x 16,384) at 164, 40 and 16 entries a
# row (its valid slots): the traversal that ran faster at each k = 1..8
# at its col-ELL and row-ELL in the timings in turns on the H100
# (baselines/ell_variants.py --per-row; PERF.md section 6).
_VALID = {164: 42_778_622, 40: 10_473_160, 16: 4_192_363}
_FASTER = {(164, 'col', torch.float64): 'wwwwwwwf',
           (164, 'col', torch.float32): 'wwwwwwww',
           (164, 'row', torch.float64): 'ffwfwfwf',
           (164, 'row', torch.float32): 'ffffwwwf',
           (40, 'col', torch.float64): 'ffffffff',
           (40, 'col', torch.float32): 'wwwfffff'}
_FASTER.update({(16, o, d): 'ffffffff' for o in ('col', 'row')
                for d in (torch.float64, torch.float32)})
_FASTER.update({(40, 'row', d): 'ffffffff'
                for d in (torch.float64, torch.float32)})
# where the rule and the timings part: the windowed traversal slower by
# 25%, 2% and 20% on the row-ELL, which no design gives a layout, and
# faster by 3% at float32 k = 3
_RULE_MISSES = {(164, 'row', torch.float64, 4), (164, 'row', torch.float64, 6),
                (164, 'row', torch.float32, 8), (40, 'col', torch.float32, 3)}


def test_dispatch_table():
    """The dispatch by bytes picks the traversal that ran faster at each
    timed design, dtype and k, but where the records name a miss (float64
    k = 8 and every sparser float64 col-ELL on the first traversal);
    vectors within L1 keep the first traversal; an unsorted layout has no
    pointers and never takes the windowed one; a layout serves only the
    col-ELL's tag and only its own arrays."""
    shapes = {'col': (16_384, 262_144), 'row': (262_144, 16_384)}
    for (per_row, orient, dtype), faster in _FASTER.items():
        m, n_in = shapes[orient]
        for k in range(1, 9):
            got = takes_window(dtype, k, m, n_in, _VALID[per_row],
                               *_h100(dtype, k))
            want = faster[k - 1] == 'w'
            if (per_row, orient, dtype, k) in _RULE_MISSES:
                want = not want
            assert got == want, (per_row, orient, dtype, k)
    for dtype in (torch.float32, torch.float64):
        n_in = ell_mod.L1_BYTES // (8 if dtype == torch.float64 else 4)
        assert not takes_window(dtype, 1, 16_384, n_in, 10 ** 9,
                                *_h100(dtype, 1))
    X = _matrix(seed=4)
    (ri, rv), (ci, cv) = dual_ell_from_scipy(X, np.float64)
    lay = EllLayout.from_numpy(ci, cv, X.shape[0], card=lambda d, k: (1, 8))
    unsorted = EllLayout.from_numpy(ci[:, ::-1].copy(), cv[:, ::-1].copy(),
                                    X.shape[0], card=lambda d, k: (1, 8))
    assert not unsorted.ascending and unsorted.win_ptr is None
    assert not any(unsorted.windowed(d, k)
                   for d in (torch.float32, torch.float64)
                   for k in range(1, 9))
    idx, val = torch.from_numpy(ci), torch.from_numpy(cv)
    u = torch.ones(X.shape[0], dtype=torch.float64)
    with pytest.raises(ValueError, match='col-ELL'):
        ell_matvec_k(idx, val, u, 1, 'dot', lay)
    with pytest.raises(ValueError, match='other arrays'):
        ell_matvec_k(idx, val, u[:-1], 1, 'tdot', lay)


def test_sectors_per_gather():
    """The 32-byte sectors one index's k values span in the interleaved
    vectors, counted over the indices of one period."""
    for k in range(1, 9):
        for item in (4, 8):
            span = k * item
            counts = [(j * span + span - 1) // 32 - (j * span) // 32 + 1
                      for j in range(32)]
            assert ell_mod.sectors_per_gather(k, item) == np.mean(counts)
    assert ell_mod.sectors_per_gather(1, 8) == 1.0
    assert ell_mod.sectors_per_gather(3, 8) == 1.5
    assert ell_mod.sectors_per_gather(8, 8) == 2.0


def _tall(seed, n, p, density, dtype=np.float64):
    """(X, col_idx, col_val): a tall n x p CSR with normal values at
    `density` and its col-ELL."""
    rng = np.random.default_rng(seed)
    X = sps.random(n, p, density, format='csr', random_state=rng,
                   data_rvs=rng.standard_normal)
    (_, _), (ci, cv) = dual_ell_from_scipy(X, dtype)
    return X, ci, cv


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_col_layout_keeps_pointers_where_they_pay(dtype):
    """The design's layout: none on the CPU; window pointers (equal to
    scipy's) where the windowed traversal pays on the card, here one SM
    whose CTA takes every row of a half-filled design; none where staging
    outweighs the gathers (3% filled, 132 SMs, a row a CTA), where the pointers would outgrow their share
    of the arrays' bytes (one entry a column over 400,000 rows), or where
    the rows do not ascend."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    X, ci, cv = _tall(9, 70_000, 8, .5, npd)
    assert col_layout(ci, cv, X.shape[0], dtype, 'cpu') is None
    one_sm = lambda d, k: (1, 128)  # noqa: E731
    lay = col_layout(ci, cv, X.shape[0], dtype, 'cpu', card=one_sm)
    _check_layout(lay, X)
    assert lay.windowed(dtype, 1)
    assert lay.n_valid == X.nnz
    Xt, ct, vt = _tall(11, 70_000, 8, .03, npd)
    lay = col_layout(ct, vt, Xt.shape[0], dtype, 'cpu',
                     card=lambda d, k: (132, 128))
    assert lay.win_ptr is None and not lay.windowed(dtype, 1)
    np.testing.assert_array_equal(lay.valid.numpy(),
                                  np.diff(Xt.tocsc().indptr))
    Xs, cs, vs = _tall(10, 400_000, 4, 2.5e-6, npd)
    assert ell_mod.pointer_bytes(4, 400_000) \
        > ell_mod.POINTER_SHARE * cs.size * (4 + np.dtype(npd).itemsize)
    lay = col_layout(cs, vs, Xs.shape[0], dtype, 'cpu',
                     card=lambda d, k: (1, 10 ** 6))
    assert lay.ascending and lay.win_ptr is None
    lay = col_layout(ci[:, ::-1].copy(), cv[:, ::-1].copy(), X.shape[0],
                     dtype, 'cpu', card=one_sm)
    assert not lay.ascending and lay.win_ptr is None


def test_auto_rule_counts_the_pointers(monkeypatch):
    """choose_backend's ell bytes hold the col-ELL's window pointers: past
    the hybrid budget, a float64 design whose dense bytes lie between the
    ELL arrays' and the arrays' plus the pointers' stays hybrid."""
    import warnings
    from bayesbridge_tpu_torch.design import sparse as sparse_mod
    monkeypatch.setattr(sparse_mod, '_HYBRID_MAX_BYTES', 0)
    n, p, nnz = 102_400, 10, 341_300
    pointers = ell_mod.pointer_bytes(p, n)
    assert pointers <= ell_mod.POINTER_SHARE * nnz * 12
    assert 2 * nnz * 12 <= n * p * 8 < 2 * nnz * 12 + pointers
    rng = np.random.default_rng(0)
    flat = rng.choice(n * p, nnz, replace=False)
    X = sps.csr_matrix((rng.standard_normal(nnz), (flat // p, flat % p)),
                       shape=(n, p))
    none = np.zeros(p, bool)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        assert sparse_mod.choose_backend(X, none, none, none,
                                         torch.float64) == 'hybrid'


def _lane_sums_first(idx, val, x, power):
    """The first traversal, emulated: lane l adds slots l, l + 32, ... in
    order; (m, 32) partial sums."""
    m, width = idx.shape
    acc = np.zeros((m, 32))
    for r in range(m):
        for s in range(width):
            a = val[r, s] ** power
            acc[r, s % 32] = acc[r, s % 32] + a * x[idx[r, s]]
    return acc


def _lane_sums_windowed(idx, val, x, power, lay, plan, unroll):
    """The windowed traversal, emulated as csrc/ell.cu runs it: for each
    window, each row's aligned 32-slot groups from its first slot in the
    window, `unroll` at a time, lane l adding slot 32 t + l of group t
    when it lies in the row's slots of the window."""
    m = idx.shape[0]
    ptr = lay.win_ptr.numpy()
    last = ptr.shape[1] - 1
    W, stride = plan['window'], plan['stride']
    acc = np.zeros((m, 32))
    for r in range(m):
        a = 0
        for w in range(plan['n_win']):
            b = int(ptr[r, min((w + 1) * stride, last)])
            g = a & ~31
            while g < b:
                for u in range(unroll):
                    for lane in range(32):
                        s = g + 32 * u + lane
                        if a <= s < b:
                            assert w * W <= idx[r, s] < (w + 1) * W
                            acc[r, lane] = acc[r, lane] \
                                + val[r, s] ** power * x[idx[r, s]]
                g += 32 * unroll
            a = b
        assert a == int(lay.valid[r])
    return acc


@pytest.mark.parametrize('unroll', [1, 2, 4])
@pytest.mark.parametrize('power', [1, 2])
def test_windowed_order_gives_the_same_sums(power, unroll):
    """Each lane's partial sum of the windowed traversal is the first
    traversal's, bit for bit (the trailing padding adds exact zeros), over
    windows of 1, 2 and 4 grains."""
    X = _matrix(seed=5 + power, n=5000, p=24)
    (_, _), (ci, cv) = dual_ell_from_scipy(X, np.float64)
    lay = EllLayout.from_numpy(ci, cv, X.shape[0])
    x = np.random.default_rng(power).standard_normal(X.shape[0])
    first = _lane_sums_first(ci, cv, x, power)
    for k_bytes in (GRAIN * 8, 2 * GRAIN * 8, 4 * GRAIN * 8):
        plan = win_plan(torch.float64, 1, ci.shape[0], X.shape[0], 132,
                        128, win_bytes=k_bytes)
        got = _lane_sums_windowed(ci, cv, x, power, lay, plan, unroll)
        assert np.array_equal(got, first)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_layout_products_match_jax(dtype):
    """X' U and the Fisher diagonal's moment through the layout (k = 1 and
    3 vectors) against the JAX ell design's Tdot and Fisher diagonal."""
    X = _kept(_matrix(seed=7))
    jd = JaxDesign(X, add_intercept=False, backend='ell', dtype=dtype)
    td = SparseDesignMatrix(X, add_intercept=False, backend='ell',
                            dtype=dtype, device='cpu')
    rng = np.random.default_rng(8)
    U = rng.standard_normal((3, X.shape[0])).astype(dtype)
    w = rng.uniform(.1, 2., X.shape[0]).astype(dtype)
    args = (td.col_idx, td.col_val)
    lay = EllLayout.from_numpy(td.col_idx.numpy(), td.col_val.numpy(),
                               X.shape[0])

    def close(got, ref):
        ref = np.asarray(ref, np.float64)
        err = np.abs(np.asarray(got, np.float64) - ref).max()
        assert err <= RTOL[dtype] * np.abs(ref).max()

    got = ell_matvec_k(*args, torch.from_numpy(U), 1, 'tdot',
                       lay)
    for c in range(3):
        close(got[c].numpy(), jd.Tdot(jnp.asarray(U[c])))
    close(ell_matvec_k(*args, torch.from_numpy(U[0]), 1, 'tdot',
                       lay).numpy(), jd.Tdot(jnp.asarray(U[0])))
    close(ell_matvec_k(*args, torch.from_numpy(w), 2, 'tdot',
                       lay).numpy(),
          jd.compute_fisher_info(jnp.asarray(w), diag_only=True))


_H100_CL = {'n_sm': 132, 'max_cluster': 16}  # as cluster_card gives it


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('k', range(1, 9))
def test_cluster_plan_holds_the_vectors(dtype, k):
    """The harness's cluster copy's default plan: the smallest cluster
    whose CTAs stage every chunk within the shared memory a CTA may take,
    in bulk copies of whole 16-byte units, the padded vectors covering
    every CTA's chunks; None past 16 CTAs' shared memory (or 8 where the
    card allows no more)."""
    item = 8 if dtype == torch.float64 else 4
    for n_in in (16_384, 50_000, 20_003, 1000, 1):
        for card in (_H100_CL, {'n_sm': 132, 'max_cluster': 8}):
            plan = cluster_plan(dtype, k, n_in, card)
            n_chunks = -(-n_in // CHUNK)
            fits = [c for c in CLUSTERS if c <= card['max_cluster']
                    and -(-n_chunks // c) * CHUNK * k * item
                    <= ell_mod.STAGE_BYTES]
            if not fits:
                assert plan is None
                assert k * n_in * item > card['max_cluster'] * 200_000
                continue
            c = plan['cluster']
            assert c == fits[0] and plan['log2c'] == c.bit_length() - 1
            assert plan['chunk_bytes'] == CHUNK * k * item
            assert plan['chunk_bytes'] % 16 == 0
            assert plan['smem_bytes'] == plan['chunks_cta'] \
                * plan['chunk_bytes'] <= ell_mod.STAGE_BYTES
            assert plan['chunks_cta'] * c >= n_chunks
            assert (plan['chunks_cta'] - 1) * c < n_chunks
            assert plan['n_staged'] == n_in and plan['staged'] == 1
            assert plan['n_pad'] == plan['chunks_cta'] * c * CHUNK >= n_in
            if c > 1:  # a smaller cluster would not hold the vectors
                assert -(-n_chunks // (c // 2)) * plan['chunk_bytes'] \
                    > ell_mod.STAGE_BYTES
    # the ell slice's row-ELL and the flagship's 50,000 inputs
    want = {(torch.float64, 16_384): {2: 2, 4: 4, 8: 8},
            (torch.float32, 16_384): {2: 1, 4: 2, 8: 4},
            (torch.float64, 50_000): {1: 2, 2: 4, 4: 8, 8: 16}}
    for (d, n_in), by_k in want.items():
        if d == dtype and k in by_k:
            assert cluster_plan(dtype, k, n_in, _H100_CL)['cluster'] \
                == by_k[k]
    if dtype == torch.float64 and k == 8:
        assert cluster_plan(dtype, k, 50_000,
                            {'n_sm': 132, 'max_cluster': 8}) is None


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_cluster_partial_stages(dtype):
    """The harness's cluster copy: a forced cluster too small for the
    vectors stages a prefix of whole chunks within the shared memory a CTA
    may take; the rest of the inputs is gathered through L2."""
    item = 8 if dtype == torch.float64 else 4
    for k, n_in in ((4, 16_384), (8, 16_384), (2, 50_000), (3, 20_003)):
        for c in CLUSTERS:
            plan = cluster_plan(dtype, k, n_in, _H100_CL, cluster=c)
            assert plan['cluster'] == c
            assert plan['smem_bytes'] <= ell_mod.STAGE_BYTES
            assert plan['n_staged'] == min(n_in, plan['chunks_cta'] * c
                                           * CHUNK)
            assert plan['n_pad'] >= max(n_in, plan['chunks_cta'] * c * CHUNK)
            assert plan['n_pad'] % CHUNK == 0
            if plan['staged'] < 1:
                assert plan['chunks_cta'] == ell_mod.STAGE_BYTES \
                    // (CHUNK * k * item)
    with pytest.raises(ValueError, match='cluster'):
        cluster_plan(torch.float64, 1, 1000, _H100_CL, cluster=3)


def _cluster_gather(plan, xt, j):
    """Where the cluster traversal reads index j's k values: rank and
    local chunk as ``ell_cl_kernel`` computes them, in CTA-local staged
    copies built as its bulk copies fill them (chunk t * C + rank at
    local chunk t); past n_staged, xt itself."""
    c, k = plan['cluster'], xt.shape[1]
    if j >= plan['n_staged']:
        return xt[j]
    g = j // CHUNK
    rank, local = g % c, (g // c) * CHUNK + j % CHUNK
    smem = np.concatenate([xt[(t * c + rank) * CHUNK:
                              (t * c + rank + 1) * CHUNK]
                           for t in range(plan['chunks_cta'])])
    assert smem.shape == (plan['chunks_cta'] * CHUNK, k)
    return smem[local]


def test_cluster_staging_finds_every_input():
    """Every input's k values lie where the harness's cluster copy gathers
    them: in its
    owner CTA's staged chunks, or past the stage in the padded vectors."""
    rng = np.random.default_rng(0)
    for n_in, k, kw in ((5000, 3, {}), (20_003, 2, {'cluster': 4}),
                        (20_003, 8, {'cluster': 2}), (3000, 1, {})):
        plan = cluster_plan(torch.float64, k, n_in, _H100_CL, **kw)
        xt = np.full((plan['n_pad'], k), np.nan)
        xt[:n_in] = rng.standard_normal((n_in, k))
        for j in list(range(0, n_in, 97)) + [n_in - 1]:
            assert np.array_equal(_cluster_gather(plan, xt, j), xt[j])


def _lane_sums_grouped(idx, val, x, power, unroll):
    """The staged traversal's row walk, emulated: a row's 32-slot runs in
    groups of `unroll`, lane l adding slot g 32 unroll + 32 u + l of group
    g where it lies within the row's width."""
    m, width = idx.shape
    acc = np.zeros((m, 32))
    groups = -(-width // (32 * unroll))
    for r in range(m):
        for g in range(groups):
            for u in range(unroll):
                for lane in range(32):
                    s = g * 32 * unroll + 32 * u + lane
                    if s < width:
                        acc[r, lane] = acc[r, lane] \
                            + val[r, s] ** power * x[idx[r, s]]
    return acc


@pytest.mark.parametrize('unroll', [1, 2, 4, 6])
@pytest.mark.parametrize('power', [1, 2])
def test_staged_order_gives_the_same_sums(power, unroll):
    """Each lane's partial sum of the staged traversal's grouped walk is
    the first traversal's, bit for bit, on a row-ELL of ragged rows."""
    X = _matrix(seed=9 + power, n=300, p=2000)
    (ri, rv), _ = dual_ell_from_scipy(X.T.tocsr(), np.float64)
    x = np.random.default_rng(power).standard_normal(X.shape[0])
    assert ri.shape[1] > 32 * min(unroll, 4)
    assert np.array_equal(_lane_sums_grouped(ri, rv, x, power, unroll),
                          _lane_sums_first(ri, rv, x, power))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('k', range(1, 9))
def test_stage_plan_fits_a_cta(dtype, k):
    """The staged traversal's stage: a prefix of whole 16-byte units of
    the interleaved vectors within the shared memory a CTA may take (or
    within a smaller budget), all of them where they fit, the padded
    vectors covering the stage; at the ell slice's and the flagship's
    inputs and ragged counts."""
    item = 8 if dtype == torch.float64 else 4
    for n_in in (16_384, 50_000, 20_003, 1001, 1):
        for budget in (ell_mod.STAGE_BYTES, 114_688, 4096):
            if budget < 4 * k * item:
                continue
            plan = stage_plan(dtype, k, n_in, budget)
            n_st = plan['n_staged']
            assert n_st % 4 == 0 and n_st >= 4
            assert plan['smem_bytes'] == n_st * k * item
            assert plan['smem_bytes'] % 16 == 0
            assert plan['smem_bytes'] <= min(budget, ell_mod.STAGE_BYTES)
            assert ell_mod.STAGE_BYTES <= ell_mod.MAX_SMEM - 1024
            assert plan['n_pad'] >= max(n_in, n_st)
            if n_in * k * item <= budget - 4 * k * item:  # it all fits
                assert plan['staged'] == 1 and n_st < n_in + 4
            else:  # as much as fits
                assert (n_st + 4) * k * item \
                    > min(budget, ell_mod.STAGE_BYTES)
                assert plan['staged'] == n_st / n_in
    with pytest.raises(ValueError, match='stage'):
        stage_plan(dtype, k, 1000, 4 * k * item - 1)
    # the ell slice's row-ELL: the share each k's stage holds
    share = stage_plan(dtype, k, 16_384)['staged']
    assert share == min(1.0, ell_mod.STAGE_BYTES // (k * item) // 4 * 4
                        / 16_384)


def test_harness_copies_edit_the_sources():
    """``baselines/ell_variants.py`` builds csrc/ell.cu with the cluster
    copy appended; each named copy changes exactly the line it names (or
    cuts the one gather it cuts), and plan routes build no copy."""
    from bayesbridge_tpu_torch.baselines import ell_variants as ev
    names = ['stwarps32', 'stahead3', 'SU64k4=2', 'CU32k8=4', 'warps24',
             'cluster-local', 'cut-l1', 'cluster-c4', 'stage-b114688']
    src = ev.variants(names)
    base = src['base']
    assert set(src) == {'base'} | set(names[:-2])
    assert base == (build.CSRC / 'ell.cu').read_text() + '\n' \
        + ev.CLUSTER_SRC.read_text()
    for kernel in ('ell_kernel', 'ell_win_kernel', 'ell_st_kernel',
                   'ell_cl_kernel'):
        assert f' {kernel}(' in base
    want = {'stwarps32': 'constexpr int kStWarps = 32;',
            'stahead3': 'constexpr int kStAhead = 3;',
            'SU64k4=2': 'constexpr int kStUnrollF64[kMaxVectors + 1] = '
                        '{0, 6, 6, 4, 2,',
            'CU32k8=4': ', 2, 4};',
            'warps24': 'constexpr int kWinWarps = 24;',
            'cluster-local': '(uint32_t)rank),',
            'cut-l1': '& (int)(131072 / '}
    lines = base.splitlines()
    for name, text in want.items():
        assert text in src[name] and text not in base, name
        changed = [a for a, b in zip(lines, src[name].splitlines()) if a != b]
        assert len(changed) == 1, (name, changed)
    with pytest.raises(ValueError, match='no copy'):
        ev.variants(['SU64k9=2'])


# The traversal that ran faster on the row-ELL of the ell slice's design
# (262,144 rows, 164 draws a row) at 16,384 and 50,000 inputs, k = 1..8
# ('s' staged, 'f' first; 50,000 inputs timed at k = 1..4 only), in the
# timings in turns on the H100 (baselines/ell_variants.py; PERF.md).
_STAGE_FASTER = {(torch.float64, 16_384): 'fssssssf',
                 (torch.float32, 16_384): 'ffssssss',
                 (torch.float64, 50_000): 'ssff',
                 (torch.float32, 50_000): 'ssss'}


def test_stage_dispatch_table():
    """takes_stage picks the traversal that ran faster at each timed
    dtype, width and k: the first one where the vectors take at most
    STAGE_MIN_BYTES (its gathers hit L1) or the stage holds less than
    STAGE_SHARE of them; never at the col-ELL's 262,144 inputs."""
    for (dtype, n_in), faster in _STAGE_FASTER.items():
        for k, want in enumerate(faster, 1):
            assert takes_stage(dtype, k, n_in) == (want == 's'), \
                (dtype, n_in, k)
    for dtype in (torch.float32, torch.float64):
        item = 8 if dtype == torch.float64 else 4
        n_small = ell_mod.STAGE_MIN_BYTES // item
        assert not takes_stage(dtype, 1, n_small)
        assert takes_stage(dtype, 1, n_small + 4)
        assert not any(takes_stage(dtype, k, 262_144) for k in range(1, 9))
        for k in range(1, 9):
            n_in = 10 ** 6 // k
            assert takes_stage(dtype, k, n_in) == (
                stage_plan(dtype, k, n_in)['staged'] >= ell_mod.STAGE_SHARE)
