"""The port's linear model, and the dense and linear slice end to end,
against the JAX package.

* The linear model's loglik, gradient, ``loglik_from_lin_pred`` and
  intercept MLE equal the JAX model's on the same data: dense and sparse
  designs, fused (the JAX sweep in interpret mode, the port's plain
  version) and composed, float32 and float64. Tolerances: float64 rtol
  1e-10; float32 1e-5 relative to max|ref|, a fused sweep 1e-4.
* The linear model's observation-precision draw, Gamma(n/2) over the
  residual rate from the chain's generator, has the Gamma moments.
* A JAX dense design and linear model carried across by ``convert``
  give the JAX model's outputs.
* The regression tests' data (tests/regression_tests/test_gibbs.py:45-68,
  n = 100, p = 50) on four combos, float64: linear/cholesky/dense,
  linear/cg/dense, logit/cholesky/dense and linear/cg/sparse with the
  prior preconditioner. Port and JAX chains use different generators, so
  posterior means are compared with ESS-aware Monte-Carlo errors,
  |z| < 4.5 (tests/test_torch_gibbs.py); resume is exact in the port, in
  float32 and float64.
* BASELINE.json configs 0-2 run through the public API, float32 and
  float64, and a float32 chain over a float64 model stays float32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel, convert,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.gibbs_util import SamplerOptions
from bayesbridge_tpu_torch.models import LinearModel
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

Z_MAX = 4.5


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize('sparse', [False, True])
@pytest.mark.parametrize('dtype,fused,tol', [(np.float64, '0', 1e-10),
                                             (np.float32, '0', 1e-5),
                                             (np.float32, '1', 1e-4)])
def test_linear_model_matches_jax(monkeypatch, sparse, dtype, fused, tol):
    from bayesbridge_tpu import RegressionModel as JaxModel
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    rng = np.random.default_rng(7 + sparse)
    X = rng.standard_normal((61, 11))
    X[:, :6] = rng.uniform(size=(61, 6)) < .3
    y = X @ rng.standard_normal(11) + rng.standard_normal(61)
    if sparse:
        X = sps.csr_matrix(X)
    kw = dict(family='linear', dtype=dtype, fused=fused)
    jm = JaxModel(y, X, **kw)
    tm = RegressionModel(y, X, device='cpu', **kw)
    assert tm.name == jm.name == 'linear'
    assert (tm.design.fused_ne_mode('link') is None) \
        == (jm.design.fused_ne_mode('link') is None)
    beta = (rng.standard_normal(12) * .3).astype(dtype)
    for obs_prec in (0.7, 2.5):
        got = tm.compute_loglik_and_gradient(torch.from_numpy(beta), obs_prec)
        ref = jm.compute_loglik_and_gradient(jnp.asarray(beta), obs_prec)
        _close(got[0], ref[0], tol)
        _close(got[1], ref[1], tol)
        lp, none = tm.compute_loglik_and_gradient(
            torch.from_numpy(beta), obs_prec, loglik_only=True)
        assert none is None
        _close(lp, ref[0], tol)
        lin = tm.design.dot(torch.from_numpy(beta))
        _close(tm.loglik_from_lin_pred(lin, obs_prec),
               jm.loglik_from_lin_pred(jm.design.dot(jnp.asarray(beta)),
                                       obs_prec), tol)
    assert tm.calc_intercept_mle() == pytest.approx(jm.calc_intercept_mle(),
                                                    rel=1e-6)


def test_obs_precision_gamma_moments():
    """obs_prec | coef = Gamma(n/2, rate = |y - X coef|^2 / 2): the mean
    and variance of 4,000 draws within 4.5 Monte-Carlo standard errors."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, 3))
    model = RegressionModel(X @ np.ones(3) + rng.standard_normal(40), X,
                            family='linear', dtype=np.float64, device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior())
    cfg = step_mod.GibbsStepConfig(
        model, bridge.prior, SamplerOptions('cholesky'), bridge.n_unshrunk,
        bridge.prior_sd_for_unshrunk)
    lin_pred = model.design.dot(torch.zeros(4, dtype=torch.float64))
    gen = torch.Generator().manual_seed(3)
    draws = np.array([float(step_mod.update_obs_precision(
        cfg, model, gen, lin_pred)) for _ in range(4000)])
    rate = float(torch.sum((model.y - lin_pred) ** 2)) / 2
    shape = 40 / 2
    mean, var = shape / rate, shape / rate ** 2
    assert abs(draws.mean() - mean) < Z_MAX * np.sqrt(var / 4000)
    # Var of the sample variance of a Gamma: (m4 - var^2) / k, with the
    # fourth central moment 3 var^2 (1 + 2 / shape).
    m4 = 3 * var ** 2 * (1 + 2 / shape)
    assert abs(draws.var() - var) < Z_MAX * np.sqrt((m4 - var ** 2) / 4000)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_linear_model_carried_across(dtype):
    from bayesbridge_tpu import RegressionModel as JaxModel
    rng = np.random.default_rng(2)
    X = rng.standard_normal((33, 7))
    y = X @ rng.standard_normal(7) + rng.standard_normal(33)
    jm = JaxModel(y, X, family='linear', dtype=dtype)
    design = convert.dense_design_from_numpy(
        np.asarray(jm.design.X), n_rows=jm.design.shape[0], device='cpu')
    tm = LinearModel(np.asarray(jm.y), design)
    beta = (rng.standard_normal(8) * .3).astype(dtype)
    got = tm.compute_loglik_and_gradient(torch.from_numpy(beta), 1.3)
    ref = jm.compute_loglik_and_gradient(jnp.asarray(beta), 1.3)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    _close(got[0], ref[0], tol)
    _close(got[1], ref[1], tol)


# The regression tests' four combos that the port runs beside logit/cg.
COMBOS = [('linear', 'cholesky', 'dense', None),
          ('linear', 'cg', 'dense', None),
          ('logit', 'cholesky', 'dense', None),
          ('linear', 'cg', 'sparse', {'cg_preconditioner': 'prior'})]
PRIOR_KW = dict(sd_for_intercept=2., regularizing_slab_size=1.,
                bridge_exponent=0.25)
N_ITER, N_BURNIN = 600, 100


def _regression_data(family, fmt):
    from tests.regression_tests.test_gibbs import simulate_data
    return simulate_data(family, fmt)


def _moments(draws):
    from bayesbridge_tpu.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.maximum(np.asarray(compute_effective_sample_size(draws)), 8.0)
    return draws.mean(axis=-1), draws.std(axis=-1) / np.sqrt(ess)


@pytest.mark.parametrize('family,sampler,fmt,options', COMBOS)
def test_combo_posterior_matches_jax(family, sampler, fmt, options):
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    outcome, X = _regression_data(family, fmt)
    theirs, _ = JaxBridge(JaxModel(outcome, X, family),
                          JaxPrior(**PRIOR_KW)).gibbs(
        N_ITER, N_BURNIN, seed=1, coef_sampler_type=sampler,
        options=options, params_to_save=('coef',))
    model = RegressionModel(outcome, X, family, dtype=np.float64,
                            device='cpu')
    ours, info = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW)).gibbs(
        N_ITER, N_BURNIN, seed=0, coef_sampler_type=sampler,
        options=options, params_to_save=('coef',))
    assert info['coef_sampler_type'] == sampler
    assert ours['coef'].dtype == np.float64
    m1, se1 = _moments(np.asarray(ours['coef'], np.float64))
    m2, se2 = _moments(np.asarray(theirs['coef'], np.float64))
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('family,sampler,fmt,options', COMBOS)
def test_combo_resume_is_exact(family, sampler, fmt, options, dtype):
    outcome, X = _regression_data(family, fmt)
    model = RegressionModel(outcome, X, family, dtype=dtype, device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    kw = dict(seed=5, coef_sampler_type=sampler, options=options,
              params_to_save='all')
    s_full, i_full = bridge.gibbs(12, **kw)
    s_a, i_a = bridge.gibbs(8, **kw)
    s_b, i_b = bridge.gibbs_resume(i_a, 4, merge=True, prev_samples=s_a)
    assert set(s_b) == set(s_full)
    for key in s_full:
        assert s_full[key].dtype == dtype
        np.testing.assert_array_equal(s_b[key], s_full[key])
    assert np.all(np.isfinite(s_full['logp']))
    want = family == 'linear'
    assert (s_full['obs_prec'].shape == (12,)) == want
    np.testing.assert_array_equal(
        i_b['_reg_coef_sampling_info'].get('n_cg_iter', []),
        i_full['_reg_coef_sampling_info'].get('n_cg_iter', []))
    assert ('n_cg_iter' in i_full['_reg_coef_sampling_info']) \
        == (sampler == 'cg')


def _baseline_config(index):
    """BASELINE.json configs 0-2 as baselines/measure.py:155-173 builds
    them."""
    np.random.seed(0)
    if index < 2:
        X = simulate_design(500, 100, binary_frac=0., format_='dense',
                            seed=0)
        beta = np.zeros(100)
        beta[:5] = 1.
        if index == 0:
            return X, simulate_outcome(X, beta, 'linear', seed=1), \
                'linear', 'cholesky', None
        n_trial = 1 + np.random.binomial(10, .5, size=500).astype(np.int64)
        return X, simulate_outcome(X, beta, 'logit', n_trial=n_trial,
                                   seed=2), 'logit', 'cholesky', None
    X = simulate_design(5000, 2000, binary_frac=.9, seed=3)
    beta = np.zeros(2000)
    beta[:10] = 1.
    return X, simulate_outcome(X, beta, 'linear', seed=4), 'linear', 'cg', \
        {'cg_preconditioner': 'prior'}


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('index', [0, 1, 2])
def test_baseline_configs_run(index, dtype):
    X, outcome, family, sampler, options = _baseline_config(index)
    model = RegressionModel(outcome, X, family, dtype=dtype, device='cpu')
    assert model.design.is_sparse == (index == 2)
    bridge = BayesBridge(model, RegressionCoefPrior(
        bridge_exponent=.5, regularizing_slab_size=2.))
    samples, info = bridge.gibbs(2, seed=0, options=options,
                                 params_to_save=('coef', 'logp'))
    assert info['coef_sampler_type'] == sampler
    assert samples['coef'].shape == (X.shape[1] + 1, 2)
    assert samples['coef'].dtype == dtype
    assert np.all(np.isfinite(samples['logp']))
    # The signal coefficients stand out of the noise ones.
    signal = np.abs(samples['coef'][1:6]).mean()
    assert signal > 4 * np.abs(samples['coef'][20:]).mean()


@pytest.mark.parametrize('family', ['linear', 'logit'])
def test_f32_chain_over_f64_model(family):
    """A float32 chain over a float64 model stays float32 (the JAX
    package's tests/regression_tests/test_gibbs.py:152)."""
    X = simulate_design(60, 8, binary_frac=.6, seed=21)
    beta = np.zeros(8)
    beta[:2] = 1.0
    outcome = simulate_outcome(X, beta, family, seed=22)
    model = RegressionModel(outcome, X, family=family, dtype=np.float64,
                            device='cpu')
    assert model.design.X_float.dtype == torch.float64
    bridge = BayesBridge(model, RegressionCoefPrior(
        bridge_exponent=.5, regularizing_slab_size=2.), dtype=np.float32)
    samples, _ = bridge.gibbs(
        n_iter=8, n_burnin=2, seed=0, coef_sampler_type='cg',
        init={'coef': np.zeros(model.n_pred), 'global_scale': .1,
              'local_scale': np.ones(model.n_pred - 1)},
        params_to_save=('coef', 'logp', 'obs_prec'))
    assert samples['coef'].dtype == np.float32
    assert samples['obs_prec'].dtype == np.float32
    assert np.all(np.isfinite(samples['logp']))


def test_linear_chain_state_carried_across():
    """A JAX float64 linear chain's final state and summarizer carried
    into the port in float64: the warm start is the same function of the
    same state, and a port step (Cholesky) runs from it, its scalar
    observation precision included."""
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    from bayesbridge_tpu.ops.summarizer import (
        extrapolate_coef_condmean as jax_extrapolate,
    )
    from bayesbridge_tpu_torch.ops.summarizer import (
        extrapolate_coef_condmean,
    )
    outcome, X = _regression_data('linear', 'dense')
    _, info = JaxBridge(JaxModel(outcome, X, 'linear'),
                        JaxPrior(**PRIOR_KW)).gibbs(
        6, seed=2, coef_sampler_type='cg', params_to_save=('coef',))
    state = info['_markov_chain_state_raw']
    summ = {k: np.asarray(v)
            for k, v in info['_reg_coef_sampler_state']['summ'].items()}
    carry = convert.carry_from_numpy(
        state['coef'], state['obs_prec'], state['global_scale'],
        state['local_scale'], summ, device='cpu', dtype=torch.float64)
    assert carry['obs_prec'].dim() == 0
    assert carry['summ']['mean'].dtype == torch.float64
    slab = PRIOR_KW['regularizing_slab_size']
    warm_j = np.asarray(jax_extrapolate(
        {k: jnp.asarray(v) for k, v in summ.items()},
        state['global_scale'], jnp.asarray(state['local_scale']), 1, slab))
    warm_t = extrapolate_coef_condmean(carry['summ'], carry['gscale'],
                                       carry['lscale'], 1, slab)
    np.testing.assert_allclose(warm_t.numpy(), warm_j, rtol=1e-12)
    model = RegressionModel(outcome, X, 'linear', dtype=np.float64,
                            device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    cfg = step_mod.GibbsStepConfig(
        model, bridge.prior, SamplerOptions('cholesky'), bridge.n_unshrunk,
        bridge.prior_sd_for_unshrunk)
    carry, out = step_mod.gibbs_step(cfg, model,
                                     torch.Generator().manual_seed(0), carry)
    assert torch.isfinite(out['logp']) and out['obs_prec'].dim() == 0
    assert int(carry['summ']['n_averaged']) == int(summ['n_averaged'])
