"""The port's HMC and NUTS Gibbs chains end to end on the CPU: the Cox
model, and the linear and logit models under HMC or NUTS.

* posterior means against the JAX package's chain of the same length on
  the data of tests/regression_tests/test_gibbs.py (n = 100, p = 50):
  the cox-hmc, cox-nuts and linear-nuts golden combos and a logit-hmc
  run. Different generators, so statistically, with the harness of
  tests/test_torch_gibbs.py: z = |m1 - m2| / sqrt(se1^2 + se2^2) with
  ESS-aware standard errors, every |z| below 4.5;
* exact resume (``gibbs(4)`` + ``gibbs_resume(2, merge=True)`` equals
  ``gibbs(6)``), for HMC with the stabilized curvature estimate and for
  NUTS: the stepsize adapter and the stabilizer's ring travel in
  ``mcmc_info``, whose keys equal the JAX package's;
* the non-positive-curvature warning;
* ``gibbs_chains`` with Cox on 2 chains: chain c equals the chain run
  alone bit for bit, and ``gibbs_chains_resume`` is exact;
* (slow) the Cox posterior against the independent NumPy sampler
  ``baselines.reference_impl.NumpyCoxGibbs``, as
  tests/test_statistical_parity.py holds the JAX package.
"""

import math
import os
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel, gibbs_chains,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.models import CoxModel, LinearModel
from bayesbridge_tpu_torch.multichain import (
    _stack_chain_inits, gibbs_chains_resume,
)
from bayesbridge_tpu_torch.ops import hmc_update

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

Z_MAX = 4.5
N_ITER, N_BURNIN = 240, 40
PRIOR_KW = dict(sd_for_intercept=2., regularizing_slab_size=1.,
                bridge_exponent=0.25)


def _golden_data(family):
    """tests/regression_tests/test_gibbs.py's simulate_data (the NumPy
    global seed 1; the port's own outcome simulators, the same draws)."""
    np.random.seed(1)
    n, p = 100, 50
    beta = np.zeros(p)
    beta[:4] = 1.0
    beta[4:15] = 2.0 ** -np.linspace(0.0, 5, 11)
    X = np.random.randn(n, p)
    if family == 'linear':
        outcome = LinearModel.simulate_outcome(X, beta, 2.0)
    elif family == 'logit':
        n_trial = np.ones(n, dtype=np.int32)
        prob = 1.0 / (1.0 + np.exp(-X @ beta))
        outcome = (np.random.binomial(n_trial.astype(np.int64), prob),
                   n_trial)
    else:
        outcome = CoxModel.simulate_outcome(X, beta)
    return outcome, (sps.csr_matrix(X) if family == 'cox' else X)


def _init(p):
    return {'global_scale': 0.1, 'local_scale': np.ones(p)}


def _bridge(family, **model_kw):
    outcome, X = _golden_data(family)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        model = RegressionModel(outcome, X, family, device='cpu',
                                **model_kw)
    return BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))


def _moments(draws):
    from bayesbridge_tpu.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.maximum(np.asarray(compute_effective_sample_size(draws)), 8.0)
    return draws.mean(axis=-1), draws.std(axis=-1) / np.sqrt(ess)


COMBOS = [('cox', 'hmc'), ('cox', 'nuts'), ('linear', 'nuts'),
          ('logit', 'hmc')]


@pytest.fixture(scope='module')
def jax_chains():
    """The JAX package's chain of each combo (float32, its default
    policy): {combo: (samples, mcmc_info)}."""
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    out = {}
    for family, sampler in COMBOS:
        outcome, X = _golden_data(family)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            model = JaxModel(outcome, X, family, dtype=np.float32)
            bridge = JaxBridge(model, JaxPrior(**PRIOR_KW),
                               dtype=np.float32)
            out[family, sampler] = bridge.gibbs(
                N_ITER, N_BURNIN, seed=0, coef_sampler_type=sampler,
                init=_init(X.shape[1]), params_to_save='all')
    return out


@pytest.mark.parametrize('family,sampler', COMBOS)
def test_posterior_matches_jax(jax_chains, family, sampler):
    bridge = _bridge(family)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ours, info = bridge.gibbs(N_ITER, N_BURNIN, seed=0,
                                  coef_sampler_type=sampler,
                                  init=_init(bridge.n_pred
                                             - bridge.n_unshrunk),
                                  params_to_save='all')
    theirs, jinfo = jax_chains[family, sampler]
    assert set(ours) == set(theirs)
    assert ('obs_prec' in ours) == (family != 'cox')
    m1, se1 = _moments(np.asarray(ours['coef'], np.float64))
    m2, se2 = _moments(np.asarray(theirs['coef'], np.float64))
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))
    # Both put the four unit coefficients above zero.
    signal = slice(0, 4) if family == 'cox' else slice(1, 5)
    assert np.all(m1[signal] > 0) and np.all(m2[signal] > 0)
    ours_info = info['_reg_coef_sampling_info']
    assert set(ours_info) == set(jinfo['_reg_coef_sampling_info'])
    assert np.all(ours_info['n_grad_evals'] >= 1)
    assert np.all(ours_info['n_hessian_matvec'] >= 2)
    assert np.all(ours_info['stepsize'] > 0)


def test_mcmc_info_keys_match_jax(jax_chains):
    """The same mcmc_info layout, sampler state included (the generator
    state's own key differs: a torch generator's, a JAX key's)."""
    bridge = _bridge('cox')
    _, info = bridge.gibbs(3, seed=0, coef_sampler_type='hmc',
                           init=_init(bridge.n_pred), params_to_save='all')
    _, jinfo = jax_chains['cox', 'hmc']
    assert set(info) == set(jinfo)
    for key in ('_reg_coef_sampler_state', '_reg_coef_sampling_info',
                '_markov_chain_state', '_markov_chain_state_raw', 'init',
                'options'):
        assert set(info[key]) == set(jinfo[key]), key
    assert set(info['_reg_coef_sampler_state']['hmc_adapter']) \
        == set(jinfo['_reg_coef_sampler_state']['hmc_adapter'])
    assert 'obs_prec' not in info['_markov_chain_state']
    assert info['init']['obs_prec'] is None


@pytest.mark.parametrize('family,sampler,stabilized', [
    ('cox', 'hmc', True), ('cox', 'nuts', False), ('linear', 'hmc', False),
    ('logit', 'nuts', True)])
def test_resume_equals_uninterrupted(family, sampler, stabilized):
    bridge = _bridge(family)
    kw = dict(seed=4, coef_sampler_type=sampler, params_to_save='all',
              init=_init(bridge.n_pred - bridge.n_unshrunk),
              options={'hmc_curvature_est_stabilized': stabilized})
    full, f_info = bridge.gibbs(6, **kw)
    part, p_info = bridge.gibbs(4, **kw)
    state = p_info['_reg_coef_sampler_state']
    assert ('stab_buffer' in state) == stabilized
    assert int(state['hmc_adapter']['n_averaged']) == 4
    merged, m_info = bridge.gibbs_resume(p_info, 2, merge=True,
                                         prev_samples=part)
    assert set(merged) == set(full)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
    for key, val in f_info['_reg_coef_sampling_info'].items():
        np.testing.assert_array_equal(
            m_info['_reg_coef_sampling_info'][key], val)


def test_curvature_warning(monkeypatch):
    """A non-positive curvature estimate is clamped and counted, and the
    run warns at its end (the reference raises)."""
    real = hmc_update.power_iteration_top_eigenvalue

    def negative(matvec, v0, *args):
        eig, vec, n = real(matvec, v0, *args)
        return -eig, vec, n

    monkeypatch.setattr(hmc_update, 'power_iteration_top_eigenvalue',
                        negative)
    bridge = _bridge('cox')
    with pytest.warns(UserWarning, match='non-positive in 3 iteration'):
        samples, _ = bridge.gibbs(3, seed=0, coef_sampler_type='hmc',
                                  init=_init(bridge.n_pred))
    assert np.all(np.isfinite(samples['coef']))


@pytest.mark.parametrize('sampler', ['hmc', 'nuts'])
def test_cox_chains_equal_chains_alone(sampler):
    bridge = _bridge('cox')
    k, n_iter, seed = 2, 4, 11
    inits = [{'coef': np.full(bridge.n_pred, 0.1 * c),
              'global_scale': 0.1 * (c + 1),
              'local_scale': np.ones(bridge.n_pred)} for c in range(k)]
    kw = dict(seed=seed, init=inits, coef_sampler_type=sampler,
              params_to_save='all')
    samples, info = gibbs_chains(bridge, n_iter, k, **kw)
    assert samples['coef'].shape == (k, bridge.n_pred, n_iter)
    assert 'obs_prec' not in samples
    cfg = bridge._step_config(bridge._resolve_options(sampler, None))
    bridge.rg.set_seed(seed)
    starts = _stack_chain_inits(bridge, inits, k)
    gens = bridge.rg.spawn(k)
    for c in range(k):
        coef, obs_prec, lscale, gscale = (s[c] for s in starts)
        carry = step_mod.init_carry('cpu', coef, obs_prec, gscale, lscale,
                                    cfg=cfg)
        _, out = step_mod.run_chain(cfg, bridge.model, gens[c], carry, 0,
                                    n_iter, 1, 0, save_keys=('coef',))
        alone = np.stack([v.numpy() for v in out['coef']], -1)
        np.testing.assert_array_equal(samples['coef'][c], alone)
        np.testing.assert_array_equal(
            info['_reg_coef_sampling_info']['n_grad_evals'][c],
            out['n_grad_evals'])
    assert not np.allclose(samples['coef'][0], samples['coef'][1])
    part, p_info = gibbs_chains(bridge, 3, k, **kw)
    assert set(p_info['_chain_carry']['hmc_adapter']) \
        == {'log_stepsize', 'log_stepsize_averaged', 'n_averaged'}
    merged, m_info = gibbs_chains_resume(bridge, p_info, 1, merge=True,
                                         prev_samples=part)
    for key in samples:
        np.testing.assert_array_equal(merged[key], samples[key])
    np.testing.assert_array_equal(
        m_info['_reg_coef_sampling_info']['stepsize'],
        info['_reg_coef_sampling_info']['stepsize'])


@pytest.mark.slow
@pytest.mark.parametrize('method', ['hmc', 'nuts'])
def test_cox_posterior_matches_numpy_oracle(method):
    """The port's Cox chain against an independent partial-likelihood
    HMC sampler, with tests/test_statistical_parity.py's data and
    tolerances."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
    from baselines.reference_impl import NumpyCoxGibbs
    np.random.seed(7)
    n, p = 150, 15
    X = np.random.randn(n, p)
    beta = np.zeros(p)
    beta[:3] = 1.0
    event, censor = CoxModel.simulate_outcome(X, beta, censoring_frac=.5,
                                              seed=8)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        event, censor, X_sorted = CoxModel.preprocess_data(event, censor, X)
    model = RegressionModel((event, censor), X_sorted, family='cox',
                            center_predictor=False, dtype=np.float64,
                            device='cpu')
    prior = RegressionCoefPrior(bridge_exponent=.5,
                                regularizing_slab_size=2.,
                                _global_scale_parametrization='raw')
    n_iter, n_burnin = 2500, 500
    samples, _ = BayesBridge(model, prior).gibbs(
        n_iter, n_burnin, seed=0, coef_sampler_type=method,
        init={'global_scale': .1})
    coef = samples['coef']
    oracle = NumpyCoxGibbs(event, censor, X_sorted, bridge_exp=.5,
                           slab_size=2., seed=11)
    coef_np = oracle.run(n_iter, n_burnin)['coef']
    mean, mean_np = coef.mean(1), coef_np.mean(1)
    sd, sd_np = coef.std(1), coef_np.std(1)
    tol = 6.0 * (sd + sd_np + 1e-3) / math.sqrt(100.0)
    assert np.all(np.abs(mean - mean_np) < tol), \
        np.abs(mean - mean_np) / tol
    assert np.all(np.abs(sd - sd_np) < 0.5 * (sd + sd_np) + 1e-3)
