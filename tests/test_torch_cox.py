"""The port's Cox model (``bayesbridge_tpu_torch.models.cox``) against the
JAX package's on the CPU.

* the host preprocessing (the sort, ties in mid-sequence, the drop of
  uninformative rows), the risk-set indices and the appearance counts
  equal the JAX package's exactly;
* the risk-set operator's products and column sums against its dense
  matrix;
* the log-likelihood, gradient and Hessian matvec against the JAX
  CoxModel on the same data, over a dense and a hybrid sparse design:
  float64 within rtol 1e-10; float32 within 2e-5 of max|JAX float32|
  (the risk-set sums are differences of one float32 prefix sum, which
  cancel; the port keeps the JAX formula, and the JAX float32 result
  is the reference) and within 2e-4 of the float64 result;
* k chains' rows equal each chain computed alone, bit for bit;
* the zero-hazard guard (loglik -inf, gradient NaN) as in the JAX
  package;
* the factory's sort and intercept warnings, and the design it builds;
* a JAX CoxModel carried across (``convert.cox_model_from_numpy``)
  gives the same numbers;
* the packed backends (bitpack, winell) against the hybrid at a small
  size.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu_torch import RegressionModel, convert
from bayesbridge_tpu_torch.design import DenseDesignMatrix
from bayesbridge_tpu_torch.models import CoxModel
from bayesbridge_tpu_torch.models.cox import (
    _HazardMultinomialProbMatrix, _sum_over_start_end,
)
from bayesbridge_tpu_torch.utils.simulate_data import simulate_design

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _tied_times():
    """The JAX suite's small case (tests/test_likelihood_models.py): tied
    events at 2.5, censoring between events, unsorted."""
    event_time = np.array([1, 5, np.inf, 2.5, 2.5, np.inf, 2])
    censoring_time = np.array([np.inf, np.inf, 3, np.inf, np.inf, 2,
                               np.inf])
    return event_time, censoring_time


def _survival_data(n=120, p=15, seed=0, ties=True, early_censor=True):
    """Cox outcomes with tied event times (rounded) and observations
    censored before the first event (dropped by the preprocessing)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[:3] = 1.0
    event, censor = CoxModel.simulate_outcome(X, beta, censoring_frac=.5,
                                              seed=seed + 1)
    if ties:  # to tenths, rounded up (no time becomes 0)
        event = np.ceil(event * 10) / 10
        censor = np.ceil(censor * 10) / 10
    if early_censor:
        first = np.min(event)
        censored = np.flatnonzero(np.isfinite(censor))[:2]
        censor[censored] = first / 4
    return X, event, censor


def test_preprocessing_and_risk_sets_match_jax():
    from bayesbridge_tpu.models import CoxModel as JaxCox
    event, censor = _tied_times()
    X = np.arange(len(event))[:, None]
    ours = CoxModel._permute_observations_by_event_and_censoring_time(
        event, censor, X)
    theirs = JaxCox._permute_observations_by_event_and_censoring_time(
        event, censor, X)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[2][:, 0], [0, 6, 3, 4, 1, 2, 5])

    for seed in (0, 1):
        X, event, censor = _survival_data(seed=seed)
        with pytest.warns(UserWarning, match='removed'):
            ours = CoxModel.preprocess_data(event, censor, X)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            theirs = JaxCox.preprocess_data(event, censor, X)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert len(ours[0]) == len(event) - 2
        assert len(np.unique(ours[0][np.isfinite(ours[0])])) \
            < np.isfinite(ours[0]).sum()  # ties present
        design = DenseDesignMatrix(ours[2], add_intercept=False,
                                   dtype=np.float64, device='cpu')
        model = CoxModel(ours[0], ours[1], design)
        jmodel = JaxCox(theirs[0], theirs[1], theirs[2])
        for name in ('risk_set_start_index', 'risk_set_end_index',
                     'n_appearance_in_risk_set'):
            np.testing.assert_array_equal(
                getattr(model, name).numpy(),
                np.asarray(getattr(jmodel, name)))
        assert model.n_event == jmodel.n_event


def test_risk_sets_of_ties_and_drop():
    """The JAX suite's exact small cases on the port."""
    event, censor = _tied_times()
    event, censor, X = \
        CoxModel._permute_observations_by_event_and_censoring_time(
            event, censor, np.arange(7.)[:, None])
    model = CoxModel(event, censor, DenseDesignMatrix(
        X, add_intercept=False, dtype=np.float64, device='cpu'))
    np.testing.assert_array_equal(model.risk_set_start_index.numpy(),
                                  [0, 1, 2, 2, 4])
    np.testing.assert_array_equal(model.risk_set_end_index.numpy(),
                                  6 - np.array([0, 0, 1, 1, 2]))
    np.testing.assert_array_equal(model.n_appearance_in_risk_set.numpy(),
                                  [1, 2, 4, 4, 5, 4, 2])
    with pytest.warns(UserWarning, match='removed'):
        event, censor, X = CoxModel._drop_uninformative_observations(
            np.array([2, 4, np.inf, np.inf]),
            np.array([np.inf, np.inf, 3, 1]), np.arange(4)[:, None])
    np.testing.assert_array_equal(event, [2, 4, np.inf])
    np.testing.assert_array_equal(X[:, 0], [0, 1, 2])
    arr = torch.tensor([1., 2., 4., 8., 16.], dtype=torch.float64)
    out = _sum_over_start_end(arr, torch.tensor([0, 1, 1, 3]),
                              torch.tensor([4, 4, 4, 4]))
    np.testing.assert_array_equal(out.numpy(), [31., 30., 30., 24.])


def _models(kind, dtype, X, event, censor):
    """(port model, JAX model) over the same design kind: 'dense' (an
    array) or 'hybrid' (scipy CSR on the hybrid backend)."""
    from bayesbridge_tpu import RegressionModel as JaxModel
    X_in = sps.csr_matrix(X) if kind == 'hybrid' else X
    kw = dict(family='cox', dtype=dtype, center_predictor=False)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ours = RegressionModel((event, censor), X_in, device='cpu',
                               backend=None if kind == 'dense'
                               else 'hybrid', **kw)
        theirs = JaxModel((event, censor), X_in, **kw)
    return ours, theirs


def _cox_data():
    X = simulate_design(150, 24, binary_frac=.5, seed=3,
                        format_='dense')
    beta = np.zeros(24)
    beta[:4] = 0.8
    event, censor = CoxModel.simulate_outcome(X, beta, censoring_frac=.6,
                                              seed=4)
    return np.asarray(X), event, censor


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize('kind', ['dense', 'hybrid'])
def test_loglik_gradient_hessian_match_jax_float64(kind):
    import jax.numpy as jnp
    X, event, censor = _cox_data()
    ours, theirs = _models(kind, np.float64, X, event, censor)
    rng = np.random.default_rng(5)
    for scale in (0.0, 0.3, 1.0):
        beta = rng.standard_normal(24) * scale
        v = rng.standard_normal(24)
        lp, grad = ours.compute_loglik_and_gradient(
            torch.from_numpy(beta))
        jlp, jgrad = theirs.compute_loglik_and_gradient(jnp.asarray(beta))
        np.testing.assert_allclose(float(lp), float(jlp), rtol=1e-10)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-10, atol=1e-10)
        lp_only, none = ours.compute_loglik_and_gradient(
            torch.from_numpy(beta), loglik_only=True)
        assert none is None and float(lp_only) == float(lp)
        hv = ours.get_hessian_matvec_operator(torch.from_numpy(beta))(
            torch.from_numpy(v))
        jhv = theirs.get_hessian_matvec_operator(jnp.asarray(beta))(
            jnp.asarray(v))
        np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize('kind', ['dense', 'hybrid'])
def test_loglik_gradient_hessian_match_jax_float32(kind):
    import jax.numpy as jnp
    X, event, censor = _cox_data()
    ours, theirs = _models(kind, np.float32, X, event, censor)
    ref64, _ = _models(kind, np.float64, X, event, censor)
    rng = np.random.default_rng(6)
    beta = (rng.standard_normal(24) * 0.5).astype(np.float32)
    v = rng.standard_normal(24).astype(np.float32)
    lp, grad = ours.compute_loglik_and_gradient(torch.from_numpy(beta))
    jlp, jgrad = theirs.compute_loglik_and_gradient(jnp.asarray(beta))
    hv = ours.get_hessian_matvec_operator(torch.from_numpy(beta))(
        torch.from_numpy(v))
    jhv = theirs.get_hessian_matvec_operator(jnp.asarray(beta))(
        jnp.asarray(v))
    lp64, grad64 = ref64.compute_loglik_and_gradient(
        torch.from_numpy(beta.astype(np.float64)))
    hv64 = ref64.get_hessian_matvec_operator(torch.from_numpy(
        beta.astype(np.float64)))(torch.from_numpy(v.astype(np.float64)))
    assert lp.dtype == grad.dtype == hv.dtype == torch.float32
    for got, jax_ref, ref in ((lp, jlp, lp64), (grad, jgrad, grad64),
                              (hv, jhv, hv64)):
        assert _rel_err(got.numpy(), jax_ref) < 2e-5
        assert _rel_err(got.numpy(), ref.numpy()) < 2e-4


def test_risk_set_operator_matches_dense_matrix():
    X, event, censor = _cox_data()
    model, _ = _models('dense', np.float64, X, event, censor)
    beta = torch.from_numpy(np.random.default_rng(7).standard_normal(24)
                            * 0.4)
    _, rel_hazard, hazard_sum = model._compute_relative_hazard(beta)
    W = _HazardMultinomialProbMatrix(
        rel_hazard, hazard_sum, model.risk_set_start_index,
        model.risk_set_end_index, model.n_appearance_in_risk_set)
    dense = W.compute_matrix().numpy()
    assert dense.shape == (model.n_event, model.n_obs)
    np.testing.assert_allclose(W.sum_over_events().numpy(), dense.sum(0),
                               rtol=1e-10)
    rng = np.random.default_rng(8)
    v_col = rng.standard_normal(model.n_obs)
    v_row = rng.standard_normal(model.n_event)
    np.testing.assert_allclose(W.dot(torch.from_numpy(v_col)).numpy(),
                               dense @ v_col, rtol=1e-10)
    np.testing.assert_allclose(W.Tdot(torch.from_numpy(v_row)).numpy(),
                               v_row @ dense, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize('kind,dtype', [('hybrid', np.float32),
                                        ('dense', np.float32)])
def test_chain_rows_equal_single_chain(kind, dtype):
    """beta (k, p): each chain's loglik, gradient and Hessian matvec
    (the operator over a subset of the chains too) equal the chain's
    computed alone, bit for bit (float32 designs; a float64 dense
    design's k-column products round differently from one column's)."""
    X, event, censor = _cox_data()
    model, _ = _models(kind, dtype, X, event, censor)
    rng = np.random.default_rng(9)
    B = torch.from_numpy(rng.standard_normal((3, 24)) * 0.4).to(
        model.design.dtype)
    V = torch.from_numpy(rng.standard_normal((3, 24))).to(B.dtype)
    lp, grad = model.compute_loglik_and_gradient(B)
    op = model.get_hessian_matvec_operator(B)
    rows = torch.tensor([0, 2])
    hv_sub = op(V[rows], rows)
    for c in range(3):
        lp_c, grad_c = model.compute_loglik_and_gradient(B[c].clone())
        assert torch.equal(lp[c], lp_c) and torch.equal(grad[c], grad_c)
        hv_c = model.get_hessian_matvec_operator(B[c].clone())(
            V[c].clone())
        assert torch.equal(op(V)[c], hv_c)
        if c != 1:
            assert torch.equal(hv_sub[c // 2], hv_c)


def test_zero_hazard_guard_matches_jax():
    """Coefficients so large that a risk set's hazards underflow to zero:
    loglik -inf and a NaN gradient, in both packages; the Hessian matvec
    stays finite (its division is guarded the same way)."""
    import jax.numpy as jnp
    X, event, censor = _cox_data()
    ours, theirs = _models('dense', np.float64, X, event, censor)
    beta = np.zeros(24)
    beta[0] = 2e3
    lp, grad = ours.compute_loglik_and_gradient(torch.from_numpy(beta))
    jlp, jgrad = theirs.compute_loglik_and_gradient(jnp.asarray(beta))
    assert float(lp) == float(jlp) == -np.inf
    assert torch.isnan(grad).all() and np.isnan(np.asarray(jgrad)).all()
    hv = ours.get_hessian_matvec_operator(torch.from_numpy(beta))(
        torch.ones(24, dtype=torch.float64))
    jhv = theirs.get_hessian_matvec_operator(jnp.asarray(beta))(
        jnp.ones(24))
    assert torch.isfinite(hv).all()
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=1e-10,
                               atol=1e-10)


def test_factory_sorts_and_refuses_intercept():
    X, event, censor = _survival_data(n=60, p=8, seed=2, ties=False,
                                      early_censor=False)
    with pytest.warns(UserWarning) as record:
        model = RegressionModel((event, censor), sps.csr_matrix(X),
                                family='cox', add_intercept=True,
                                center_predictor=False, device='cpu')
    messages = ' | '.join(str(w.message) for w in record)
    assert 'Intercept is not identifiable' in messages
    assert 'sorted' in messages
    assert model.name == 'cox' and not model.intercept_added
    assert model.design.backend == 'hybrid'
    assert model.design.shape == (60, 8)
    assert np.all(np.diff(model.event_time[np.isfinite(
        model.event_time)]) >= 0)
    # The sorted design's rows follow the sorted outcomes.
    by_event = np.argsort(event, kind='stable')
    by_censor = np.argsort(-censor, kind='stable')
    order = np.concatenate((by_event[np.isfinite(event[by_event])],
                            by_censor[np.isfinite(censor[by_censor])]))
    np.testing.assert_allclose(model.design.toarray(), X[order],
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match='sorted'):
        CoxModel(event, censor, model.design)
    with pytest.raises(NotImplementedError, match='identifiable'):
        model.calc_intercept_mle()


def test_converted_jax_model_gives_same_numbers():
    """The JAX hybrid design and CoxModel carried across by
    ``convert.design_from_numpy`` and ``convert.cox_model_from_numpy``."""
    import jax.numpy as jnp
    X, event, censor = _cox_data()
    _, theirs = _models('hybrid', np.float64, X, event, censor)
    jd = theirs.design
    design = convert.design_from_numpy(
        np.asarray(jd.X_exact), np.asarray(jd.X_float),
        np.asarray(jd.exact_cols), np.asarray(jd.float_cols),
        np.asarray(jd.column_offset), jd.shape, add_intercept=False,
        device='cpu')
    model = convert.cox_model_from_numpy(
        theirs.event_time, theirs.censoring_time, design,
        np.asarray(theirs.risk_set_start_index),
        np.asarray(theirs.risk_set_end_index),
        np.asarray(theirs.n_appearance_in_risk_set))
    beta = np.random.default_rng(10).standard_normal(24) * 0.3
    lp, grad = model.compute_loglik_and_gradient(torch.from_numpy(beta))
    jlp, jgrad = theirs.compute_loglik_and_gradient(jnp.asarray(beta))
    np.testing.assert_allclose(float(lp), float(jlp), rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-10,
                               atol=1e-10)
    with pytest.raises(ValueError, match='risk_set_end_index'):
        convert.cox_model_from_numpy(
            theirs.event_time, theirs.censoring_time, design,
            risk_set_end_index=np.zeros(model.n_event, np.int64))


@pytest.mark.parametrize('backend', ['bitpack', 'winell'])
def test_packed_backends_match_hybrid(backend):
    """Cox over the beyond-HBM backends (their plain kernels here)
    against the hybrid, float32: within 1e-5 of max|hybrid|."""
    X = simulate_design(200, 40, binary_frac=.8, seed=12)
    beta = np.zeros(40)
    beta[:3] = 1.0
    event, censor = CoxModel.simulate_outcome(X, beta, censoring_frac=.5,
                                              seed=13)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        models = {b: RegressionModel((event, censor), X, family='cox',
                                     backend=b, device='cpu')
                  for b in ('hybrid', backend)}
    assert models[backend].design.backend == backend
    rng = np.random.default_rng(14)
    B = torch.from_numpy(rng.standard_normal((2, 40)) * 0.3).float()
    v = torch.from_numpy(rng.standard_normal(40)).float()
    out = {}
    for b, model in models.items():
        lp, grad = model.compute_loglik_and_gradient(B)
        hv = model.get_hessian_matvec_operator(B[0])(v)
        out[b] = (lp, grad, hv)
    for got, ref in zip(out[backend], out['hybrid']):
        assert _rel_err(got.numpy(), ref.numpy()) < 1e-5
