"""The windowed-CSR layout and product (the winell backend on the card)
against the JAX package's winell backend.

The JAX package multiplies its windowed-ELL packing by the Pallas kernel
(interpret mode) and adds its spill matrix; the port stores a windowed
CSR of the same matrix and multiplies it by ``wincsr`` (its plain
version on the CPU). Checked:

* the layout densifies back to X exactly, its segments are padded to
  whole 8-entry vectors, and the windowed-ELL packing plus spill
  rebuilds the same matrix;
* products against ``winell_matvec`` plus spill and against the JAX
  design's dot / Tdot / Fisher diagonal, ``square`` off and on, with
  windows forced to 64 inputs so that several windows are used, on the
  spill-heavy design of tests/test_torch_winell.py and on a design with
  empty rows and columns and n not a multiple of 128;
* ``convert.packed_design_from_numpy`` from the JAX arrays.

Tolerance rtol 2e-5 / atol 2e-5 * max|ref|, as in
tests/test_torch_winell.py (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.design import winell as jax_winell
from bayesbridge_tpu_torch import convert
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.design import wincsr as wincsr_mod
from bayesbridge_tpu_torch.design.sparse import PACKED_ARRAYS
from bayesbridge_tpu_torch.kernels.wincsr import wincsr, wincsr_plain

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _spill_heavy(seed=0, n=300, p=70, density=0.08):
    """tests/test_torch_winell.py's design: a few rows and columns dense
    in their first window, so cells overflow in both orientations."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)) * (rng.random((n, p)) < density)
    X[::37, :40] = rng.standard_normal((len(range(0, n, 37)), 40))
    X[:100, ::17] = rng.standard_normal((100, len(range(0, p, 17))))
    return sps.csr_matrix(X)


def _holes(seed=1, n=333, p=150):
    """Empty rows and columns, n not a multiple of 128."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)) * (rng.random((n, p)) < 0.1)
    X[40:75] = 0.0
    X[:, 10:30] = 0.0
    X[:, -5:] = 0.0
    return sps.csr_matrix(X)


DESIGNS = {'spill': _spill_heavy, 'holes': _holes}


def _close(got, ref, rtol=2e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize('window', [None, 64, 8])
@pytest.mark.parametrize('transpose', [False, True])
@pytest.mark.parametrize('name', sorted(DESIGNS))
def test_layout_densifies_exactly(name, transpose, window):
    X = DESIGNS[name]()
    if transpose:
        X = X.T.tocsr()
    m = wincsr_mod.build_wincsr(X, window)
    assert m.window == (wincsr_mod.plan_window(X.shape[1])
                        if window is None else window)
    assert m.n_win == -(-X.shape[1] // m.window)
    ptr = m.ptr.numpy()
    assert ptr[0] == 0 and np.all(ptr % wincsr_mod.ALIGN == 0)
    assert np.all(np.diff(ptr) >= 0) and ptr[-1] == m.idx.shape[0]
    assert m.idx.shape[0] < X.nnz + wincsr_mod.ALIGN * m.n_win * m.n_out
    assert (m.idx.numpy().view(np.uint16) < m.window).all()
    np.testing.assert_array_equal(m.to_scipy().toarray(), X.toarray()
                                  .astype(np.float32))
    # Padding entries are (0, 0.0): the stored values are X's and zeros.
    assert np.count_nonzero(m.val.numpy()) == X.nnz


@pytest.mark.parametrize('square', [False, True])
@pytest.mark.parametrize('orient', ['dot', 'tdot'])
@pytest.mark.parametrize('window', [None, 64])
@pytest.mark.parametrize('name', sorted(DESIGNS))
def test_product_matches_jax_winell_plus_spill(name, window, orient,
                                               square):
    X = DESIGNS[name]()
    X.sort_indices()
    if orient == 'tdot':
        X = X.T.tocsr()
        X.sort_indices()
    n_out, n_in = X.shape
    W, K = jax_winell.plan_windows(n_in, n_out, X.nnz)
    idx, val, spill = jax_winell.pack_winell(X, W, K)
    v = np.random.default_rng(4).standard_normal(n_in).astype(np.float32)
    ref = np.asarray(jax_winell.winell_matvec(
        idx, val, jnp.asarray(v), n_out, W, K, square=square,
        interpret=True), np.float64)
    if spill is not None:
        data = spill.data ** 2 if square else spill.data
        ref = ref + sps.csr_matrix((data, spill.indices, spill.indptr),
                                   shape=spill.shape) @ v
    m = wincsr_mod.build_wincsr(X, window)
    got = wincsr(m, torch.from_numpy(v), square, tag=orient)
    _close(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), wincsr_plain(m, torch.from_numpy(v), square).numpy())


def test_packing_plus_spill_rebuilds_the_matrix():
    X = _spill_heavy(seed=2)
    X.sort_indices()
    W, K = jax_winell.plan_windows(X.shape[1], X.shape[0], X.nnz)
    idx, val, spill = jax_winell.pack_winell(X, W, K)
    assert spill is not None and spill.nnz > 0
    from bayesbridge_tpu_torch.design.ell import csr_to_ell
    ell_idx, ell_val = csr_to_ell(spill.indptr, spill.indices,
                                  spill.data.astype(np.float32),
                                  spill.shape[1])
    got = wincsr_mod.csr_from_winell(idx, val, ell_idx, ell_val, X.shape,
                                     W, K)
    np.testing.assert_array_equal(got.toarray(),
                                  X.toarray().astype(np.float32))


@pytest.mark.parametrize('source', ['build', 'convert'])
@pytest.mark.parametrize('window', [None, 64])
@pytest.mark.parametrize('name', sorted(DESIGNS))
def test_design_products_match_jax(monkeypatch, name, window, source):
    """dot, Tdot, the Fisher diagonal (square) and quad_matvec of the
    winell design, centered with an intercept, fresh or carried across
    from the JAX arrays; the card's layouts are the windowed CSR of X."""
    if window is not None:
        monkeypatch.setattr(wincsr_mod, 'MAX_WINDOW', window)
    X = DESIGNS[name]()
    jd = JaxDesign(X, center_predictor=True, add_intercept=True,
                   backend='winell', dtype=np.float32)
    if source == 'build':
        td = SparseDesignMatrix(X, center_predictor=True, add_intercept=True,
                                backend='winell', device='cpu')
    else:
        td = convert.packed_design_from_numpy(
            'winell', {k: np.asarray(getattr(jd, k))
                       for k in PACKED_ARRAYS['winell']},
            jd._winell_meta, np.asarray(jd.column_offset), jd._shape_main,
            add_intercept=True, center_predictor=True, device='cpu')
    # Empty columns are constant: both designs drop them.
    X = X[:, np.flatnonzero(X.getnnz(0))]
    n, p = X.shape
    assert td.shape == jd.shape == (n, p + 1)
    assert td.wc_dot.window == min(wincsr_mod.MAX_WINDOW, -(-p // 8) * 8)
    if window is not None:
        assert td.wc_dot.n_win > 1 and td.wc_tdot.n_win > 1
    np.testing.assert_array_equal(td.wc_dot.to_scipy().toarray(),
                                  X.toarray().astype(np.float32))
    np.testing.assert_array_equal(td.wc_tdot.to_scipy().toarray(),
                                  X.T.toarray().astype(np.float32))
    assert td.storage_bytes() == td.wc_dot.nbytes() + td.wc_tdot.nbytes()
    rng = np.random.default_rng(12)
    v = rng.standard_normal(p + 1).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)
    _close(td.dot(v).numpy(), jd.dot(v))
    _close(td.Tdot(u).numpy(), jd.Tdot(u))
    _close(td.quad_matvec(v, w).numpy(), jd.quad_matvec(v, w))
    _close(td.compute_fisher_info(w, diag_only=True).numpy(),
           jd.compute_fisher_info(w, diag_only=True))


def test_winell_arrays_stay_on_the_host():
    """The design stores only the windowed CSR; the windowed-ELL packing
    is packed on the host on demand, element for element the JAX
    design's, from a fresh build and from a design carried across."""
    X = _spill_heavy(seed=3)
    jd = JaxDesign(X, backend='winell', dtype=np.float32)
    td = SparseDesignMatrix(X, backend='winell', device='cpu')
    carried = convert.packed_design_from_numpy(
        'winell', {k: np.asarray(getattr(jd, k))
                   for k in PACKED_ARRAYS['winell']},
        jd._winell_meta, np.asarray(jd.column_offset), jd._shape_main,
        device='cpu')
    for design in (td, carried):
        assert not any(hasattr(design, k) for k in PACKED_ARRAYS['winell'])
        assert design._winell_meta == tuple(jd._winell_meta[:6])
        packing = design.winell_packing()
        for name in PACKED_ARRAYS['winell']:
            np.testing.assert_array_equal(packing[name],
                                          np.asarray(getattr(jd, name)))


@pytest.mark.parametrize('entries,segments,lanes', [
    (0, 10, 4), (80, 10, 4), (160, 1, 16), (1336 * 8, 1, 32),
    (167 * 131_072, 131_072, 16), (10 ** 9, 1, 32)])
def test_lanes_per_row(entries, segments, lanes):
    assert wincsr_mod.lanes_per_row(entries, segments) == lanes


def test_plan_window():
    assert wincsr_mod.plan_window(16_384) == 16_384
    assert wincsr_mod.plan_window(131_072) == wincsr_mod.MAX_WINDOW
    assert wincsr_mod.plan_window(70) == 72
    assert wincsr_mod.plan_window(0) == wincsr_mod.ALIGN
    with pytest.raises(ValueError):
        wincsr_mod.build_wincsr(_holes(), window=100)


def test_wrapper_validates_inputs():
    m = wincsr_mod.build_wincsr(_holes())
    with pytest.raises(ValueError):
        wincsr(m, torch.zeros(m.n_in + 1))
    with pytest.raises(ValueError):
        wincsr(m, torch.zeros(m.n_in, dtype=torch.float64))
    with pytest.raises(ValueError):
        wincsr(m, torch.zeros(m.n_in), tag='other')
