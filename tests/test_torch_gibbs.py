"""The port's Gibbs sampler end to end on the CPU.

* the canonical drive of the JAX package's verify notes, on the port;
* resume equals an uninterrupted run, exactly, within the port;
* a port chain against a JAX chain on the same small sparse logit
  problem: different generators, so the comparison is statistical —
  coordinate-wise posterior means with ESS-aware Monte-Carlo standard
  errors, z = |m1 - m2| / sqrt(se1^2 + se2^2), as in
  baselines/parity_onchip.py; every |z| must stay below 4.5 (for 21
  coordinates a false alarm has probability about 1.4e-4);
* the JAX chain's state carried across by ``convert.carry_from_numpy``.
"""

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel, convert,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.gibbs_util import SamplerOptions
from bayesbridge_tpu_torch.ops.summarizer import extrapolate_coef_condmean
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

Z_MAX = 4.5


def _canonical():
    X = simulate_design(200, 30, binary_frac=.9, seed=1)
    beta = np.random.default_rng(0).standard_normal(30)
    outcome = simulate_outcome(X, beta, 'logit', seed=2)
    model = RegressionModel(outcome, X, family='logit', device='cpu')
    prior = RegressionCoefPrior(bridge_exponent=.25,
                                regularizing_slab_size=1.)
    return BayesBridge(model, prior)


def test_canonical_drive():
    bridge = _canonical()
    samples, info = bridge.gibbs(n_iter=50, n_burnin=10, seed=0,
                                 coef_sampler_type='cg',
                                 params_to_save='all')
    assert samples['coef'].shape == (31, 40)
    assert samples['local_scale'].shape == (30, 40)
    assert samples['obs_prec'].shape == (200, 40)
    assert samples['global_scale'].shape == (40,)
    logp = samples['logp']
    assert np.all(np.isfinite(logp))
    # logp rises from the MAP start region and plateaus.
    assert logp[-20:].mean() > logp[:3].mean() - 50
    n_cg = info['_reg_coef_sampling_info']['n_cg_iter']
    assert n_cg.shape == (40,) and 0 < n_cg.max() < 100
    assert info['_init_optim_info']['is_success']


@pytest.mark.parametrize('thin', [1, 2])
def test_resume_equals_uninterrupted(thin):
    bridge = _canonical()
    s_full, i_full = bridge.gibbs(30, seed=4, thin=thin,
                                  coef_sampler_type='cg',
                                  params_to_save='all')
    s_a, i_a = bridge.gibbs(20, seed=4, thin=thin, coef_sampler_type='cg',
                            params_to_save='all')
    s_b, i_b = bridge.gibbs_resume(i_a, 10, merge=True, prev_samples=s_a)
    assert set(s_b) == set(s_full)
    for key in s_full:
        np.testing.assert_array_equal(s_b[key], s_full[key])
    np.testing.assert_array_equal(
        i_b['_reg_coef_sampling_info']['n_cg_iter'],
        i_full['_reg_coef_sampling_info']['n_cg_iter'])
    assert i_b['n_iter'] == 30


def test_resume_drops_unknown_option_keys():
    bridge = _canonical()
    samples, info = bridge.gibbs(5, seed=1, coef_sampler_type='cg')
    info['options'] = {**info['options'], 'cg_recycled_basis': 8}
    with pytest.warns(UserWarning, match='cg_recycled_basis'):
        more, _ = bridge.gibbs_resume(info, 3)
    assert more['coef'].shape == (31, 3)
    opts = SamplerOptions.from_info({'coef_sampler_type': 'cg'})
    assert opts.cg_preconditioner == 'diag'


def test_unported_paths_raise():
    """Paths the port once refused run: the HMC and NUTS samplers, the
    Cox family (tests/test_torch_cox_gibbs.py holds them against the JAX
    package) and the ell backend (tests/test_torch_ell.py)."""
    bridge = _canonical()
    for sampler in ('hmc', 'nuts'):
        samples, info = bridge.gibbs(2, seed=0, coef_sampler_type=sampler)
        assert info['coef_sampler_type'] == sampler
        assert np.all(np.isfinite(samples['coef']))
    X = simulate_design(20, 5, binary_frac=.6, seed=1)
    event = np.where(np.arange(20) % 2 == 0, np.arange(20.) + 1, np.inf)
    censor = np.where(np.isinf(event), np.arange(20.) + 1, np.inf)
    with pytest.warns(UserWarning, match='sorted'):
        model = RegressionModel((event, censor), X, family='cox',
                                device='cpu')
    assert model.name == 'cox' and not model.intercept_added
    model = RegressionModel((np.arange(20) % 2).astype(float), X,
                            family='logit', backend='ell', device='cpu')
    assert model.design.backend == 'ell'
    np.testing.assert_allclose(model.design.toarray(), RegressionModel(
        np.zeros(20), X, family='logit', device='cpu').design.toarray())
    samples, _ = BayesBridge(model, RegressionCoefPrior(
        bridge_exponent=.5)).gibbs(3, seed=0, coef_sampler_type='cg')
    assert np.all(np.isfinite(samples['coef']))


def _parity_problem():
    X = simulate_design(400, 20, binary_frac=.7, seed=11)
    beta = np.zeros(20)
    beta[:3] = 1.0
    return X, simulate_outcome(X, beta, 'logit', seed=12)


def _moments(draws):
    from bayesbridge_tpu.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.maximum(np.asarray(compute_effective_sample_size(draws)), 8.0)
    return draws.mean(axis=-1), draws.std(axis=-1) / np.sqrt(ess)


N_ITER, N_BURNIN = 500, 100
PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


@pytest.fixture(scope='module')
def jax_chain():
    """A JAX chain (fused='0', its composed default) on the parity
    problem: (samples, mcmc_info)."""
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    X, outcome = _parity_problem()
    jmodel = JaxModel(outcome, X, family='logit', dtype=np.float32,
                      fused='0')
    return JaxBridge(jmodel, JaxPrior(**PRIOR_KW), dtype=np.float32).gibbs(
        N_ITER, N_BURNIN, seed=1, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))


def test_chain_matches_jax_posterior(jax_chain):
    """Port (composed hybrid path, the default policy; CPU plain versions)
    vs the JAX package on the same data and prior."""
    X, outcome = _parity_problem()
    model = RegressionModel(outcome, X, family='logit', device='cpu')
    ours, _ = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW)).gibbs(
        N_ITER, N_BURNIN, seed=0, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    theirs = jax_chain[0]
    m1, se1 = _moments(np.asarray(ours['coef'], np.float64))
    m2, se2 = _moments(np.asarray(theirs['coef'], np.float64))
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))
    # The signal coefficients are found by both.
    assert np.all(m1[1:4] > 0.4) and np.all(m2[1:4] > 0.4)


def test_carry_from_jax_state(jax_chain):
    """A JAX chain's final state and summarizer carried into the port:
    the warm start (extrapolated conditional mean) is the same function
    of the same state, and a port step runs from it."""
    import jax
    from bayesbridge_tpu.ops.summarizer import (
        extrapolate_coef_condmean as jax_extrapolate,
    )
    X, outcome = _parity_problem()
    info = jax_chain[1]
    state = info['_markov_chain_state_raw']
    summ = info['_reg_coef_sampler_state']['summ']
    carry = convert.carry_from_numpy(
        state['coef'], state['obs_prec'], state['global_scale'],
        state['local_scale'], summ, device='cpu')
    warm_j = np.asarray(jax_extrapolate(
        jax.tree_util.tree_map(np.asarray, summ),
        np.float32(state['global_scale']),
        np.asarray(state['local_scale'], np.float32), 1,
        PRIOR_KW['regularizing_slab_size']))
    warm_t = extrapolate_coef_condmean(
        carry['summ'], carry['gscale'], carry['lscale'], 1,
        PRIOR_KW['regularizing_slab_size'])
    np.testing.assert_allclose(warm_t.numpy(), warm_j, rtol=1e-6,
                               atol=1e-7)

    model = RegressionModel(outcome, X, family='logit', device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    cfg = step_mod.GibbsStepConfig(
        model, bridge.prior, SamplerOptions('cg'), bridge.n_unshrunk,
        bridge.prior_sd_for_unshrunk)
    carry, out = step_mod.gibbs_step(cfg, model,
                                     torch.Generator().manual_seed(0),
                                     carry)
    assert torch.isfinite(out['logp'])
    assert int(carry['summ']['n_averaged']) == int(summ['n_averaged']) + 1
