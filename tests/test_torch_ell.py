"""The port's ell backend (the dual row-ELL of X and X', multiplied by
``kernels.ell.ell_matvec_k``, its plain version on the CPU) against the
JAX package's ell backend on the same X.

* the dual ELL arrays equal the JAX design's element for element;
* `dot`, `Tdot`, the Fisher diagonal, the Fisher information and
  `toarray`, centred or not, with and without the intercept, in float32
  (rtol 1e-5 of max|JAX|: float32 sums in another order) and float64
  (1e-12);
* k chains' products (k up to 10, so ceil(k / 8) launches on the card)
  equal to the chains' single products, bit for bit;
* ``backend='auto'`` picks ell where the JAX package does, in float32
  with patched budgets and in float64, with the JAX package's warning;
* ``convert.packed_design_from_numpy('ell', ...)`` from the JAX design's
  arrays gives the same design;
* the Cox loglik and gradient on ell (float64, 1e-10);
* a logit CG chain's posterior means against the JAX chain's on ell
  (ESS-aware z-score, |z| < 4.5, as tests/test_torch_composed.py).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import bayesbridge_tpu.design.sparse as jax_sparse
from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
import bayesbridge_tpu_torch.design.sparse as port_sparse
from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel, convert,
)
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.design.ell import dual_ell_from_scipy
from bayesbridge_tpu_torch.design.sparse import PACKED_ARRAYS
from bayesbridge_tpu_torch.kernels import launch_counts
from bayesbridge_tpu_torch.kernels.ell import (
    ell_matvec_k, ell_matvec_k_plain,
)
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
Z_MAX = 4.5


def _design_data(seed=0, n=230, p=61):
    """Normal values at 8% density, an empty row block, empty columns, a
    denser column and an explicit zero entry."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)) * (rng.random((n, p)) < .08)
    X[40:55] = 0.0
    X[:, 7] = 0.0
    X[:, 12] = rng.standard_normal(n) * (rng.random(n) < .6)
    X = sps.csr_matrix(X)
    X.data[3] = 0.0  # an explicit zero stays an entry
    return X


def _close(got, ref, dtype):
    got, ref = (np.asarray(x, np.float64) for x in (got, ref))
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= RTOL[dtype] * scale, \
        np.abs(got - ref).max() / scale


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_dual_ell_matches_jax(dtype):
    from bayesbridge_tpu.design.ell import (
        dual_ell_from_scipy as jax_dual_ell,
    )
    X = _design_data()
    for ours, theirs in zip(dual_ell_from_scipy(X, dtype),
                            jax_dual_ell(X, dtype)):
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # The designs drop the empty column first, as the JAX design does.
    with pytest.warns(UserWarning, match='Intercept'):
        jd = JaxDesign(X, add_intercept=False, backend='ell', dtype=dtype)
    with pytest.warns(UserWarning, match='Intercept'):
        td = SparseDesignMatrix(X, add_intercept=False, backend='ell',
                                dtype=dtype, device='cpu')
    for name in PACKED_ARRAYS['ell']:
        theirs = np.asarray(getattr(jd, name))
        assert getattr(td, name).numpy().dtype == theirs.dtype
        np.testing.assert_array_equal(getattr(td, name).numpy(), theirs)
    assert td.nnz == jd.nnz and td.storage_bytes() == sum(
        np.asarray(getattr(jd, name)).nbytes
        for name in PACKED_ARRAYS['ell'])


@pytest.mark.parametrize('intercept', [False, True])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_products_match_jax(dtype, centered, intercept):
    X = _design_data(seed=1 + 2 * centered + intercept)
    kw = dict(center_predictor=centered, add_intercept=intercept,
              backend='ell', dtype=dtype)
    jd = JaxDesign(X, **kw)
    td = SparseDesignMatrix(X, device='cpu', **kw)
    assert td.backend == 'ell' and td.dtype == torch.from_numpy(
        np.zeros(0, dtype)).dtype
    assert td.fused_ne_mode() is None and td.cg_blockorder_ctx() is None
    assert not td.has_presolve_reductions()
    n, p = td.shape
    assert (n, p) == jd.shape
    rng = np.random.default_rng(5)
    v = rng.standard_normal(p).astype(dtype)
    u = rng.standard_normal(n).astype(dtype)
    w = rng.uniform(.1, 2., n).astype(dtype)
    _close(td.dot(v).numpy(), jd.dot(jnp.asarray(v)), dtype)
    _close(td.Tdot(u).numpy(), jd.Tdot(jnp.asarray(u)), dtype)
    _close(td.compute_fisher_info(w, diag_only=True).numpy(),
           jd.compute_fisher_info(jnp.asarray(w), diag_only=True), dtype)
    _close(td.compute_fisher_info(w).numpy(),
           jd.compute_fisher_info(jnp.asarray(w)), dtype)
    _close(td.toarray(), jd.toarray(), dtype)
    _close(td.extract_matrix().numpy(), jd.toarray(), dtype)
    _close(td.compute_transposed_fisher_info(w[:p], intercept).numpy(),
           jd.compute_transposed_fisher_info(jnp.asarray(w[:p]), intercept),
           dtype)


def test_fisher_info_over_several_row_chunks(monkeypatch):
    """The Gram's row chunks (a budget forcing several, the last one
    clamped) give the one-chunk result."""
    X = _design_data(seed=9)
    td = SparseDesignMatrix(X, center_predictor=True, backend='ell',
                            dtype=np.float64, device='cpu')
    w = np.random.default_rng(2).uniform(.1, 2., X.shape[0])
    whole = td.compute_fisher_info(w).numpy()
    monkeypatch.setenv('BB_GRAM_CHUNK_BYTES', str(256 * 61 * 8))
    _close(td.compute_fisher_info(w).numpy(), whole, np.float64)
    dense = td.toarray()
    _close(whole, dense.T @ (w[:, None] * dense), np.float64)


@pytest.mark.parametrize('k', [2, 8, 10])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_chain_products_equal_single_products(dtype, k):
    """k chains' products in one call: each chain's row is its single
    product, bit for bit (dot, Tdot and both moments)."""
    X = _design_data(seed=3)
    td = SparseDesignMatrix(X, center_predictor=True, backend='ell',
                            dtype=dtype, device='cpu')
    n, p = td.shape
    rng = np.random.default_rng(k)
    V = torch.from_numpy(rng.standard_normal((k, p)).astype(dtype))
    U = torch.from_numpy(rng.standard_normal((k, n)).astype(dtype))
    W = torch.from_numpy(rng.uniform(.1, 2., (k, n)).astype(dtype))
    for batched, single, args in (
            (td.dot(V), td.dot, V), (td.Tdot(U), td.Tdot, U),
            (td.compute_fisher_diag(W), td.compute_fisher_diag, W)):
        assert batched.shape[0] == k
        for c in range(k):
            assert torch.equal(batched[c], single(args[c]))
    for power in (1, 2):
        out = ell_matvec_k(td.col_idx, td.col_val, U, power, tag='tdot')
        for c in range(k):
            assert torch.equal(out[c], ell_matvec_k_plain(
                td.col_idx, td.col_val, U[c], power))


def test_kernel_wrapper_checks_its_arguments():
    X = _design_data(seed=4)
    td = SparseDesignMatrix(X, backend='ell', dtype=np.float64,
                            device='cpu')
    v = torch.zeros(X.shape[1], dtype=torch.float64)
    before = launch_counts()
    ref = ell_matvec_k_plain(td.row_idx, td.row_val, v)
    assert torch.equal(ell_matvec_k(td.row_idx, td.row_val, v), ref)
    assert launch_counts() == before  # CPU tensors: the plain version
    with pytest.raises(ValueError, match='float64'):
        ell_matvec_k(td.row_idx, td.row_val, v.float())
    with pytest.raises(ValueError, match='power'):
        ell_matvec_k(td.row_idx, td.row_val, v, power=3)
    with pytest.raises(ValueError, match='tag'):
        ell_matvec_k(td.row_idx, td.row_val, v, tag='rows')
    with pytest.raises(ValueError, match='int32'):
        ell_matvec_k(td.row_idx.long(), td.row_val, v)


@pytest.mark.parametrize('k', [1, 4, 11])
def test_cpu_tensors_never_reach_a_kernel(monkeypatch, k):
    """With both shared-memory traversals forced on, CPU tensors still run
    the plain version: no library is loaded, no stage is launched, no
    launch counter moves (dot, Tdot through the col-ELL's layout, and the
    moments)."""
    from bayesbridge_tpu_torch.kernels import ell as ell_mod

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernels")
    monkeypatch.setattr(ell_mod, 'takes_stage', lambda *args: True)
    monkeypatch.setattr(ell_mod, 'takes_window', lambda *args: True)
    monkeypatch.setattr(ell_mod, 'load_library', refuse)
    monkeypatch.setattr(ell_mod, 'stage_launch', refuse)
    X = _design_data(seed=6)
    td = SparseDesignMatrix(X, backend='ell', dtype=np.float64,
                            device='cpu')
    rng = np.random.default_rng(k)
    V = torch.from_numpy(rng.standard_normal((k, X.shape[1])))
    U = torch.from_numpy(rng.standard_normal((k, X.shape[0])))
    lay = ell_mod.EllLayout.from_numpy(td.col_idx.numpy(),
                                       td.col_val.numpy(), X.shape[0])
    before = launch_counts()
    for power in (1, 2):
        assert torch.equal(ell_matvec_k(td.row_idx, td.row_val, V, power),
                           ell_matvec_k_plain(td.row_idx, td.row_val, V,
                                              power))
        assert torch.equal(
            ell_matvec_k(td.col_idx, td.col_val, U, power, 'tdot', lay),
            ell_matvec_k_plain(td.col_idx, td.col_val, U, power))
    assert launch_counts() == before


def _sparse_normal(n, p, density, seed=0):
    rng = np.random.default_rng(seed)
    return sps.csr_matrix(rng.standard_normal((n, p))
                          * (rng.random((n, p)) < density))


@pytest.mark.parametrize('dtype,budgets', [
    (np.float32, (1e3, 1e3)),
    (np.float64, (1e3, 1e3)),
    (np.float64, (1e3, 1e9)),
])
def test_auto_picks_ell_with_the_jax_warning(monkeypatch, dtype, budgets):
    """float32 with both budgets tiny, and float64 whatever the packed
    budget (bitpack and winell are float32 only): ell, where the JAX
    package picks it. Where a float32 design would have taken a packed
    backend, both packages warn."""
    for mod in (jax_sparse, port_sparse):
        monkeypatch.setattr(mod, '_HYBRID_MAX_BYTES', budgets[0])
        monkeypatch.setattr(mod, '_BITPACK_MAX_BYTES', budgets[1])
    X = _sparse_normal(400, 100, .02)
    warns = dtype == np.float64 and budgets[1] > 1e6
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter('always')
        jd = JaxDesign(X, add_intercept=False, dtype=dtype)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter('always')
        td = SparseDesignMatrix(X, add_intercept=False, dtype=dtype,
                                device='cpu')
    assert jd.backend == td.backend == 'ell'

    def said(ws):
        return [str(w.message) for w in ws if '32-bit' in str(w.message)]

    assert said(port_w) == said(jax_w)
    assert bool(said(port_w)) == warns
    v = np.random.default_rng(1).standard_normal(100).astype(dtype)
    _close(td.dot(v).numpy(), jd.dot(jnp.asarray(v)), dtype)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_convert_from_jax_arrays(dtype):
    X = _design_data(seed=6)
    jd = JaxDesign(X, center_predictor=True, backend='ell', dtype=dtype)
    arrays = {name: np.asarray(getattr(jd, name))
              for name in PACKED_ARRAYS['ell']}
    design = convert.packed_design_from_numpy(
        'ell', arrays, None, np.asarray(jd.column_offset), jd._shape_main,
        nnz=jd.nnz, center_predictor=True, device='cpu')
    ours = SparseDesignMatrix(X, center_predictor=True, backend='ell',
                              dtype=dtype, device='cpu')
    assert design.backend == 'ell' and design.dtype == ours.dtype
    u = np.random.default_rng(7).standard_normal(X.shape[0]).astype(dtype)
    assert torch.equal(design.Tdot(u), ours.Tdot(u))
    _close(design.Tdot(u).numpy(), jd.Tdot(jnp.asarray(u)), dtype)
    np.testing.assert_array_equal(design.toarray(), ours.toarray())


def test_cox_on_ell_matches_jax_float64():
    from bayesbridge_tpu import RegressionModel as JaxModel
    from bayesbridge_tpu_torch.models import CoxModel
    X = simulate_design(150, 24, binary_frac=.3, seed=3)
    beta = np.zeros(24)
    beta[:4] = 0.8
    event, censor = CoxModel.simulate_outcome(X, beta, censoring_frac=.6,
                                              seed=4)
    kw = dict(family='cox', dtype=np.float64, center_predictor=False,
              backend='ell')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ours = RegressionModel((event, censor), X, device='cpu', **kw)
        theirs = JaxModel((event, censor), X, **kw)
    assert ours.design.backend == theirs.design.backend == 'ell'
    rng = np.random.default_rng(5)
    for scale in (0.0, 0.3, 1.0):
        b = rng.standard_normal(24) * scale
        lp, grad = ours.compute_loglik_and_gradient(torch.from_numpy(b))
        jlp, jgrad = theirs.compute_loglik_and_gradient(jnp.asarray(b))
        np.testing.assert_allclose(float(lp), float(jlp), rtol=1e-10)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-10, atol=1e-10)


def _parity_problem():
    X = simulate_design(400, 20, binary_frac=.7, seed=11)
    beta = np.zeros(20)
    beta[:3] = 1.0
    return X, simulate_outcome(X, beta, 'logit', seed=12)


N_ITER, N_BURNIN = 400, 100
PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


def _moments(draws):
    from bayesbridge_tpu.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.maximum(np.asarray(compute_effective_sample_size(draws)), 8.0)
    return draws.mean(axis=-1), draws.std(axis=-1) / np.sqrt(ess)


def test_chain_matches_jax_posterior():
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    X, outcome = _parity_problem()
    jmodel = JaxModel(outcome, X, family='logit', dtype=np.float32,
                      backend='ell')
    theirs, _ = JaxBridge(jmodel, JaxPrior(**PRIOR_KW),
                          dtype=np.float32).gibbs(
        N_ITER, N_BURNIN, seed=1, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    model = RegressionModel(outcome, X, family='logit', backend='ell',
                            device='cpu')
    assert model.design.backend == jmodel.design.backend == 'ell'
    ours, _ = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW)).gibbs(
        N_ITER, N_BURNIN, seed=0, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    m1, se1 = _moments(np.asarray(ours['coef'], np.float64))
    m2, se2 = _moments(np.asarray(theirs['coef'], np.float64))
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))
    assert np.all(m1[1:4] > 0.4) and np.all(m2[1:4] > 0.4)


def test_resume_equals_uninterrupted_float64():
    X, outcome = _parity_problem()
    model = RegressionModel(outcome, X, family='logit', backend='ell',
                            dtype=np.float64, device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    full, _ = bridge.gibbs(10, seed=3, coef_sampler_type='cg',
                           params_to_save='all')
    part, info = bridge.gibbs(6, seed=3, coef_sampler_type='cg',
                              params_to_save='all')
    merged, _ = bridge.gibbs_resume(info, 4, merge=True, prev_samples=part)
    assert full['coef'].dtype == np.float64
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
