"""The torch port's hybrid design against the JAX package's.

Both packages build a hybrid design from the same scipy CSR matrix with
``fused='1'``: the JAX one runs its Pallas sweeps in interpret mode
off-TPU, the port's the plain versions of its sweeps on the CPU. Checked: the
exact/float column split and storage dtypes, ``convert.design_from_numpy``
on the JAX design's arrays, and dot, Tdot, quad_matvec,
presolve_reductions, the Fisher diagonal and fused_link_grad with
centering and intercept on and off.

Tolerances: dot rtol 2e-5 / atol 2e-4 * max|ref| (row sums in another
order); the column reductions rtol 2e-4 / atol 2e-4 * max|ref|, as in
tests/test_fusedne.py; the log-likelihood rtol 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu_torch import convert
from bayesbridge_tpu_torch.design import SparseDesignMatrix

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _design_data(seed=3, n=47, binary_only=False, bf16=False):
    rng = np.random.default_rng(seed)
    binary = (rng.uniform(size=(n, 9)) < .3).astype(np.float64)
    if bf16:  # bf16-exact but not integer: the exact tier is bf16
        binary = binary * rng.choice([0.5, 1.25, -2.0], size=binary.shape)
    parts = [binary] if binary_only \
        else [binary, rng.standard_normal((n, 4)) * 1.3]
    return sps.csr_matrix(np.hstack(parts))


def _pair(monkeypatch, X, centered, intercept):
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    jd = JaxDesign(X, center_predictor=centered, add_intercept=intercept,
                   backend='hybrid', dtype=np.float32, fused='1')
    td = SparseDesignMatrix(X, center_predictor=centered,
                            add_intercept=intercept, dtype=np.float32,
                            fused='1', device='cpu')
    return jd, td


def _close(got, ref, rtol=2e-4):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=2e-4 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize('bf16', [False, True])
def test_column_split_and_converter(monkeypatch, bf16):
    """Same exact/float split and storage dtypes from the CSR as the JAX
    design; the JAX design's arrays carried over by design_from_numpy
    give the same stored blocks as the port's own build."""
    X = _design_data(bf16=bf16)
    jd, td = _pair(monkeypatch, X, centered=True, intercept=True)
    np.testing.assert_array_equal(td.exact_cols.numpy(),
                                  np.asarray(jd.exact_cols))
    np.testing.assert_array_equal(td.float_cols.numpy(),
                                  np.asarray(jd.float_cols))
    want = torch.bfloat16 if bf16 else torch.int8
    assert str(jd.X_exact.dtype) == ('bfloat16' if bf16 else 'int8')
    assert td.X_exact.dtype == want and td.X_float.dtype == torch.float32
    assert td.exact_is_binary == jd.exact_is_binary
    assert td.X_exact.shape[1] % 16 == 0 and td.X_float.shape[1] % 16 == 0

    cd = convert.design_from_numpy(
        np.asarray(jd.X_exact), np.asarray(jd.X_float),
        np.asarray(jd.exact_cols), np.asarray(jd.float_cols),
        np.asarray(jd.column_offset), jd._shape_main,
        add_intercept=True, center_predictor=True,
        exact_is_binary=jd.exact_is_binary, device='cpu')
    assert cd.X_exact.dtype == want
    assert torch.equal(cd.X_exact, td.X_exact)
    assert torch.equal(cd.X_float, td.X_float)
    np.testing.assert_allclose(cd.column_offset.numpy(),
                               td.column_offset.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(cd.toarray(), td.toarray())
    np.testing.assert_allclose(td.toarray(), jd.toarray(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('intercept', [False, True])
def test_products_match_jax(monkeypatch, centered, intercept):
    X = _design_data(seed=5 + 2 * centered + intercept)
    jd, td = _pair(monkeypatch, X, centered, intercept)
    rng = np.random.default_rng(11)
    n, p = td.shape
    assert (n, p) == jd.shape
    v = rng.standard_normal(p).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)

    _close(td.dot(v).numpy(), jd.dot(v), rtol=2e-5)
    _close(td.Tdot(u).numpy(), jd.Tdot(u))
    assert jd.fused_ne_mode('quad') is not None
    _close(td.quad_matvec(v, w).numpy(), jd.quad_matvec(v, w))

    got = td.presolve_reductions(u, u * 0.5 + 1.0, w)
    ref = jd.presolve_reductions(u, u * 0.5 + 1.0, w)
    assert len(got) == 3
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    got4 = td.presolve_reductions(u, u, w, u4=w * 2)
    _close(got4[3].numpy(), jd.Tdot(w * 2))
    _close(td.compute_fisher_info(w, diag_only=True).numpy(),
           jd.compute_fisher_info(w, diag_only=True))

    a = rng.integers(0, 2, size=n).astype(np.float32)
    b = np.ones(n, np.float32)
    lp_t, g_t = td.fused_link_grad(v * 0.3, a, b, 'logit')
    lp_j, g_j = jd.fused_link_grad(v * 0.3, a, b, 'logit')
    np.testing.assert_allclose(float(lp_t), float(lp_j), rtol=1e-5)
    _close(g_t.numpy(), g_j)


def test_presolve_binary_block_keeps_square_moment(monkeypatch):
    """A 0/1 exact block: the fused reduction computes (X.X)'u3 from the
    values (equal to X'u3 there) — compare with the JAX fused path and
    the dense formula."""
    X = _design_data(seed=9, binary_only=True)
    jd, td = _pair(monkeypatch, X, centered=True, intercept=True)
    assert td.exact_is_binary and td.n_float == 0
    rng = np.random.default_rng(2)
    n = td.shape[0]
    u1, u2 = rng.standard_normal((2, n)).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    got = td.presolve_reductions(u1, u2, w)
    for g, r in zip(got, jd.presolve_reductions(u1, u2, w)):
        _close(g.numpy(), r)
    dense = td.toarray().astype(np.float64)
    _close(got[2].numpy(), (dense * dense).T @ w)


def test_matvec_counters(monkeypatch):
    X = _design_data()
    _, td = _pair(monkeypatch, X, centered=False, intercept=True)
    v = np.ones(td.shape[1], np.float32)
    w = np.ones(td.shape[0], np.float32)
    td.quad_matvec(v, w)
    td.presolve_reductions(w, w, w)
    td.dot(v)
    assert td.get_dot_count() == (2, 3) and td.n_matvec == 5


def test_unported_options_raise():
    """'auto' and '0' (the composed path) and a design without an exact
    column build and run composed; the unported options raise."""
    X = _design_data()
    rng = np.random.default_rng(0)
    no_exact = sps.csr_matrix(rng.standard_normal((20, 3)))
    for fused, Xd in (('auto', X), ('0', X), (None, no_exact)):
        d = SparseDesignMatrix(Xd, fused=fused, device='cpu')
        assert d.fused_ne_mode() is None and d.cg_blockorder_ctx() is not None
        assert d.has_presolve_reductions() == (Xd is X)
        v = np.ones(d.shape[1], np.float32)
        w = np.ones(d.shape[0], np.float32)
        ref = d.toarray().astype(np.float64)
        _close(d.quad_matvec(v, w).numpy(), ref.T @ (ref @ v))
    with pytest.raises(NotImplementedError, match='ell'):
        SparseDesignMatrix(X, backend='ell', device='cpu')
    with pytest.raises(NotImplementedError, match='float32'):
        SparseDesignMatrix(X, dtype=np.float64, device='cpu')
    with pytest.raises(NotImplementedError, match='dense'):
        SparseDesignMatrix(X.toarray(), device='cpu')
    for fused in ('full', '1'):
        assert SparseDesignMatrix(X, fused=fused, device='cpu') \
            .fused_ne_mode() is True


@pytest.mark.parametrize('kw', [dict(binary_frac=.9),
                                dict(binary_frac=.5, categorical_frac=.3,
                                     corr_dense_design=True)])
def test_simulate_data_matches_jax_package(kw):
    """The port's NumPy data generator gives the JAX package's arrays."""
    from bayesbridge_tpu.utils import simulate_data as jax_sim
    from bayesbridge_tpu_torch.utils import simulate_data as port_sim
    Xj = jax_sim.simulate_design(120, 40, seed=4, **kw)
    Xp = port_sim.simulate_design(120, 40, seed=4, **kw)
    assert (Xj != Xp).nnz == 0
    beta = np.linspace(-1, 1, 40)
    yj = jax_sim.simulate_outcome(Xj, beta, 'logit', seed=5)
    yp = port_sim.simulate_outcome(Xp, beta, 'logit', seed=5)
    np.testing.assert_array_equal(yj[0], yp[0])
    np.testing.assert_array_equal(yj[1], yp[1])
