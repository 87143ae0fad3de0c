"""The port's winell backend against the JAX package's.

Both packages build a winell design from the same scipy CSR matrix
(n=300, p=70, general values; a few rows and columns are dense in
their first window, so some cells overflow their K slots and spill in
both orientations);
the JAX windowed-ELL kernel runs in interpret mode, the port's
``winell`` as its plain version on the CPU. Checked:

* ``plan_windows``, ``estimate_bytes`` and ``pack_winell`` give the JAX
  package's arrays exactly, spill included, and the design's stored
  packings and spill ELL arrays are the JAX design's;
* the plain ``winell`` equals ``winell_matvec`` on the same packing,
  both orientations, ``square`` off and on: rtol 1e-5 (float32 sums in
  another order);
* dot, Tdot, ``quad_matvec(return_t=True)`` and the Fisher diagonal
  match the JAX design, with centering and intercept on and off, for a
  fresh build and for the JAX arrays carried over by
  ``convert.packed_design_from_numpy``: rtol 2e-5, atol 2e-5 * max|ref|.
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
from bayesbridge_tpu_torch.design import winell as port_winell
from bayesbridge_tpu_torch.design.sparse import PACKED_ARRAYS
from bayesbridge_tpu_torch.kernels.winell import winell, winell_plain

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _design_data(seed=0, n=300, p=70, density=0.08):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)) * (rng.random((n, p)) < density)
    X[::37, :40] = rng.standard_normal((len(range(0, n, 37)), 40))
    X[:100, ::17] = rng.standard_normal((100, len(range(0, p, 17))))
    return sps.csr_matrix(X)


def _pair(X, centered=False, intercept=True):
    jd = JaxDesign(X, center_predictor=centered, add_intercept=intercept,
                   backend='winell', dtype=np.float32)
    td = SparseDesignMatrix(X, center_predictor=centered,
                            add_intercept=intercept, backend='winell',
                            device='cpu')
    return jd, td


def _close(got, ref, rtol=2e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize('n_in,n_out,nnz', [
    (70, 300, 1700), (300, 70, 1700), (16_384, 131_072, 21_500_000),
    (50, 10, 500), (10_000, 100, 100)])
def test_plans_identical(n_in, n_out, nnz):
    assert port_winell.plan_windows(n_in, n_out, nnz) \
        == jax_winell.plan_windows(n_in, n_out, nnz)
    assert port_winell.tile_block(n_out) == jax_winell._tile_block(n_out)
    assert port_winell.estimate_bytes((n_out, n_in), nnz) \
        == jax_winell.estimate_bytes((n_out, n_in), nnz)


@pytest.mark.parametrize('transpose', [False, True])
def test_pack_winell_identical(transpose):
    X = _design_data(seed=1)
    if transpose:
        X = X.T.tocsr()
    X.sort_indices()
    n_out, n_in = X.shape
    W, K = port_winell.plan_windows(n_in, n_out, X.nnz)
    got = port_winell.pack_winell(X, W, K)
    ref = jax_winell.pack_winell(X, W, K)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] is not None and got[2].nnz > 0
    assert (got[2] != ref[2]).nnz == 0


def test_design_packing_identical():
    X = _design_data(seed=2)
    jd, td = _pair(X)
    assert td._winell_meta == tuple(jd._winell_meta[:6])
    assert td._winell_meta[4] and td._winell_meta[5]  # both spill
    for name in PACKED_ARRAYS['winell']:
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    np.testing.assert_allclose(td.toarray(), jd.toarray(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.toarray()[:, 1:], X.toarray(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('square', [False, True])
@pytest.mark.parametrize('orient', ['dot', 'tdot'])
def test_plain_winell_matches_jax_kernel(orient, square):
    X = _design_data(seed=3)
    jd, _ = _pair(X)
    w_dot, k_dot, w_tdot, k_tdot = jd._winell_meta[:4]
    n, p = X.shape
    if orient == 'dot':
        idx, val, n_in, n_out, W, K = (jd.widx_dot, jd.wval_dot, p, n,
                                       w_dot, k_dot)
    else:
        idx, val, n_in, n_out, W, K = (jd.widx_tdot, jd.wval_tdot, n, p,
                                       w_tdot, k_tdot)
    v = np.random.default_rng(4).standard_normal(n_in).astype(np.float32)
    ref = np.asarray(jax_winell.winell_matvec(
        idx, val, jnp.asarray(v), n_out, W, K, square=square,
        interpret=True), np.float64)
    idx_t = torch.from_numpy(np.asarray(idx).copy())
    val_t = torch.from_numpy(np.asarray(val).copy())
    got = winell(idx_t, val_t, torch.from_numpy(v), n_out, W, K, square,
                 tag=orient)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        got.numpy(), winell_plain(idx_t, val_t, torch.from_numpy(v), n_out,
                                  W, K, square).numpy())


@pytest.mark.parametrize('source', ['build', 'convert'])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('intercept', [False, True])
def test_products_match_jax(source, centered, intercept):
    X = _design_data(seed=5 + 2 * centered + intercept)
    jd, td = _pair(X, centered, intercept)
    if source == 'convert':
        td = convert.packed_design_from_numpy(
            'winell', {k: np.asarray(getattr(jd, k))
                       for k in PACKED_ARRAYS['winell']},
            jd._winell_meta, np.asarray(jd.column_offset), jd._shape_main,
            add_intercept=intercept, center_predictor=centered,
            device='cpu')
    assert td.backend == 'winell' and td.fused_ne_mode() is None
    n, p = td.shape
    assert (n, p) == jd.shape
    rng = np.random.default_rng(11)
    v = rng.standard_normal(p).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)

    _close(td.dot(v).numpy(), jd.dot(v))
    _close(td.Tdot(u).numpy(), jd.Tdot(u))
    out, t = td.quad_matvec(v, w, return_t=True)
    out_j, t_j = jd.quad_matvec(v, w, return_t=True)
    _close(out.numpy(), out_j)
    _close(t.numpy(), t_j)
    _close(td.compute_fisher_info(w, diag_only=True).numpy(),
           jd.compute_fisher_info(w, diag_only=True))
    assert not td.has_presolve_reductions()
    assert td.fused_link_grad(v, w, w, 'logit') is None
