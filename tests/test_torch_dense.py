"""The port's dense design and the dense Fisher information against the
JAX package's.

Both packages build their design from the same numpy (or scipy CSR)
data. The JAX dense design under ``fused='1'`` runs its Pallas sweeps in
interpret mode off-TPU, the port's the plain versions of its sweeps on
the CPU; float64 designs compose in both. Checked: dot, Tdot, the CG
operator, the GLM score in both link modes, the pre-solve reductions
with and without the warm-start column, the Fisher information (diagonal
and full) and the transposed one, with centering and intercept on and
off and at widths whose rows are not whole 16-byte vectors; the JAX
design carried across by ``convert``; the hybrid design's full Fisher
information with a Gram budget small enough for several row chunks and
a clamped last one, in float32 and float64.

Tolerances: float64 rtol 1e-10; float32 1e-5 relative to max|ref|;
a fused sweep against the interpret-mode kernel 1e-4 relative to
max|ref| (they sum in different orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import DenseDesignMatrix as JaxDense
from bayesbridge_tpu.design import SparseDesignMatrix as JaxSparse
from bayesbridge_tpu_torch import convert
from bayesbridge_tpu_torch.design import DenseDesignMatrix, SparseDesignMatrix

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

TOL = {(np.float64, '0'): 1e-10, (np.float32, '0'): 1e-5,
       (np.float32, '1'): 1e-4}


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _data(n, p, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    X[:, 1] = (X[:, 1] > 0.3)  # a 0/1 column beside the normal ones
    return rng, X


def _vectors(rng, n, p, dtype):
    return dict(v=(rng.standard_normal(p) * .3).astype(dtype),
                w=(rng.exponential(size=n) + .1).astype(dtype),
                a=(rng.uniform(size=n) < .4).astype(dtype),
                y=rng.standard_normal(n).astype(dtype),
                us=[rng.standard_normal(n).astype(dtype) for _ in range(4)])


@pytest.mark.parametrize('p_main', [6, 13])
@pytest.mark.parametrize('centered,intercept', [(True, True),
                                                (False, False)])
@pytest.mark.parametrize('dtype,fused', list(TOL))
def test_dense_products_match_jax(dtype, fused, centered, intercept,
                                  p_main):
    tol = TOL[(dtype, fused)]
    n = 37
    rng, X = _data(n, p_main, seed=p_main + 2 * centered)
    jd = JaxDense(X, center_predictor=centered, add_intercept=intercept,
                  dtype=dtype, fused=fused)
    td = DenseDesignMatrix(X, center_predictor=centered,
                           add_intercept=intercept, dtype=dtype,
                           fused=fused, device='cpu')
    p = p_main + int(intercept)
    assert td.shape == jd.shape == (n, p)
    assert td.X.shape[1] % (16 // td.X.element_size()) == 0
    assert (td.fused_ne_mode() is None) == (jd.fused_ne_mode() is None) \
        == (fused == '0' or dtype == np.float64)
    _close(td.X_main, jd.X, tol)
    s = _vectors(rng, n, p, dtype)
    t = {k: torch.from_numpy(v) if k != 'us' else
         [torch.from_numpy(u) for u in v] for k, v in s.items()}
    _close(td.dot(t['v']), jd.dot(jnp.asarray(s['v'])), tol)
    _close(td.Tdot(t['y']), jd.Tdot(jnp.asarray(s['y'])), tol)
    _close(td.quad_matvec(t['v'], t['w']),
           jd.quad_matvec(jnp.asarray(s['v']), jnp.asarray(s['w'])), tol)
    for mid, a in (('logit', 'a'), ('linear', 'y')):
        got = td.fused_link_grad(t['v'], t[a], t['w'], mid)
        ref = jd.fused_link_grad(jnp.asarray(s['v']), jnp.asarray(s[a]),
                                 jnp.asarray(s['w']), mid)
        assert (got is None) == (ref is None)
        if got is not None:
            _close(got[0], ref[0], tol)
            _close(got[1], ref[1], tol)
    for k in (3, 4):
        got = td.presolve_reductions(*t['us'][:k])
        ref = jd.presolve_reductions(*map(jnp.asarray, s['us'][:k]))
        assert len(got) == len(ref) == k
        for g, r in zip(got, ref):
            _close(g, r, tol)
    _close(td.compute_fisher_info(t['w'], diag_only=True),
           jd.compute_fisher_info(jnp.asarray(s['w']), diag_only=True), tol)
    _close(td.compute_fisher_info(t['w']),
           jd.compute_fisher_info(jnp.asarray(s['w'])), tol)
    wp = (rng.exponential(size=p) + .1).astype(dtype)
    for incl in (False, True) if intercept else (False,):
        wq = wp if incl else wp[int(intercept):]
        _close(td.compute_transposed_fisher_info(torch.from_numpy(wq), incl),
               jd.compute_transposed_fisher_info(jnp.asarray(wq), incl), tol)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_dense_design_carried_across(dtype):
    """The JAX dense design's stored X through ``convert`` gives the same
    products as the JAX design and as the port's own build."""
    rng, X = _data(29, 9, seed=5)
    jd = JaxDense(X, center_predictor=True, dtype=dtype, fused='0')
    cd = convert.dense_design_from_numpy(np.asarray(jd.X), device='cpu')
    td = DenseDesignMatrix(X, center_predictor=True, dtype=dtype,
                           device='cpu')
    assert cd.dtype == td.dtype == (torch.float32 if dtype == np.float32
                                    else torch.float64)
    assert cd.X.shape == td.X.shape
    tol = TOL[(dtype, '0')]
    _close(cd.X, td.X, tol)
    v = rng.standard_normal(10).astype(dtype)
    w = (rng.exponential(size=29) + .1).astype(dtype)
    _close(cd.dot(torch.from_numpy(v)), jd.dot(jnp.asarray(v)), tol)
    _close(cd.compute_fisher_info(torch.from_numpy(w)),
           jd.compute_fisher_info(jnp.asarray(w)), tol)


def test_dense_design_preprocessing():
    """A constant column is dropped with a warning; torch input, numpy
    input and the intercept column give the same stored X; the padding
    columns are zero; ``to_dtype`` copies the stored X into float64."""
    rng, X = _data(21, 5, seed=7)
    X_const = np.hstack((X[:, :2], np.full((21, 1), 3.0), X[:, 2:]))
    with pytest.warns(UserWarning, match='Intercept column'):
        d = DenseDesignMatrix(X_const, center_predictor=True, device='cpu')
    ref = DenseDesignMatrix(torch.from_numpy(X), center_predictor=True,
                            device='cpu')
    assert d.shape == ref.shape == (21, 6)
    torch.testing.assert_close(d.X, ref.X, rtol=0, atol=0)
    assert d.X.shape == (21, 8) and not d.X[:, 6:].any()
    assert torch.all(d.X[:, 0] == 1.0)
    np.testing.assert_allclose(d.toarray()[:, 1:].mean(0), 0, atol=1e-6)
    d64 = d.to_dtype(torch.float64)
    assert d64.dtype == torch.float64 and d64.shape == d.shape
    assert d64.X.shape == (21, 6) and d64.centered and d64.intercept_added
    torch.testing.assert_close(d64.X_main, d.X_main.double(), rtol=0, atol=0)


def _sparse_data(n, seed):
    rng = np.random.default_rng(seed)
    binary = (rng.uniform(size=(n, 9)) < .3).astype(np.float64)
    return rng, sps.csr_matrix(np.hstack(
        [binary, rng.standard_normal((n, 4)) * 1.3]))


@pytest.mark.parametrize('backend,dtype', [('hybrid', np.float32),
                                           ('hybrid', np.float64),
                                           ('bitpack', np.float32)])
@pytest.mark.parametrize('centered,intercept', [(True, True),
                                                (False, False)])
def test_sparse_fisher_matches_jax(monkeypatch, backend, dtype, centered,
                                   intercept):
    """The full and the transposed Fisher information of the sparse
    design; the Gram budget holds 256 rows, so 600 rows take three chunks
    with the last one clamped over its predecessor's rows."""
    monkeypatch.setenv('BB_GRAM_CHUNK_BYTES', '4096')
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    rng, X = _sparse_data(600, seed=11 + centered)
    kw = dict(center_predictor=centered, add_intercept=intercept,
              backend=backend, dtype=dtype)
    jd = JaxSparse(X, **kw)
    td = SparseDesignMatrix(X, device='cpu', **kw)
    tol = TOL[(dtype, '0')]
    n, p = td.shape
    w = (rng.exponential(size=n) + .1).astype(dtype)
    _close(td.compute_fisher_info(torch.from_numpy(w)),
           jd.compute_fisher_info(jnp.asarray(w)), tol)
    _close(td.compute_fisher_info(torch.from_numpy(w), diag_only=True),
           jd.compute_fisher_info(jnp.asarray(w), diag_only=True), tol)
    wp = (rng.exponential(size=p) + .1).astype(dtype)
    _close(td.compute_transposed_fisher_info(torch.from_numpy(wp), intercept),
           jd.compute_transposed_fisher_info(jnp.asarray(wp), intercept), tol)


@pytest.mark.parametrize('fused', ['0', '1'])
def test_sparse_float64_matches_jax(fused):
    """The float64 hybrid stores one float64 block and composes every
    product whatever the policy; the JAX float64 design's two blocks
    carried across by ``convert`` make the same block."""
    rng, X = _sparse_data(53, seed=2)
    jd = JaxSparse(X, center_predictor=True, backend='hybrid',
                   dtype=np.float64, fused=fused)
    td = SparseDesignMatrix(X, center_predictor=True, dtype=np.float64,
                            fused=fused, device='cpu')
    cd = convert.design_from_numpy(
        np.asarray(jd.X_exact), np.asarray(jd.X_float),
        np.asarray(jd.exact_cols), np.asarray(jd.float_cols),
        np.asarray(jd.column_offset), jd._shape_main,
        center_predictor=True, device='cpu')
    n, p = td.shape
    v = rng.standard_normal(p)
    w = rng.exponential(size=n) + .1
    for d in (td, cd):
        assert d.dtype == torch.float64 and d.n_exact == 0
        assert d.fused_ne_mode('quad') is None
        assert d.cg_blockorder_ctx() is None
        assert not d.has_presolve_reductions()
        _close(d.dot(torch.from_numpy(v)), jd.dot(jnp.asarray(v)), 1e-10)
        _close(d.Tdot(torch.from_numpy(w)), jd.Tdot(jnp.asarray(w)), 1e-10)
        _close(d.quad_matvec(torch.from_numpy(v), torch.from_numpy(w)),
               jd.quad_matvec(jnp.asarray(v), jnp.asarray(w)), 1e-10)
        _close(d.compute_fisher_info(torch.from_numpy(w), diag_only=True),
               jd.compute_fisher_info(jnp.asarray(w), diag_only=True),
               1e-10)


def test_packed_backends_refuse_float64():
    """bitpack and winell stay float32 on both build paths: from the CSR
    and from carried-across arrays."""
    _, X = _sparse_data(40, seed=4)
    for backend in ('bitpack', 'winell'):
        with pytest.raises(NotImplementedError, match='float32'):
            SparseDesignMatrix(X, backend=backend, dtype=np.float64,
                               device='cpu')
        with pytest.raises(NotImplementedError, match='float32'):
            SparseDesignMatrix(None, dtype=torch.float64, device='cpu',
                               _parts={'backend': backend})
    with pytest.raises(NotImplementedError, match='float64'):
        SparseDesignMatrix(X, dtype=np.float16, device='cpu')
