"""The port's public per-component updates (bayesbridge_tpu/bridge.py
:400-524; reference bayesbridge.py:355-511), the building blocks of custom
samplers.

The tests of tests/test_component_updates.py, run on the port (CPU), and
the deterministic parts against the JAX package on the same float64
problem: ``initialize_obs_precision``, ``monte_carlo_em_global_scale``
and ``compute_posterior_logprob`` within rtol 1e-10 (both evaluate the
same formulas in float64; the sums run in another order). The draws
come from another generator than the JAX package's, so they are held to
their shapes, signs and guards, and the public ``BasicRandom`` draws to
their moments.
"""

import math

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel,
)
from bayesbridge_tpu_torch.models import LogisticModel
from bayesbridge_tpu_torch.random.basic import BasicRandom
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


def _data(family, n=80, p=12, seed=0):
    X = simulate_design(n, p, binary_frac=.7, seed=seed)
    beta = np.zeros(p)
    beta[:3] = 1.0
    return X, simulate_outcome(X, beta, family, seed=seed + 1)


def _bridge(family='logit', n=80, p=12, seed=0, dtype=None):
    X, outcome = _data(family, n, p, seed)
    with pytest.warns(UserWarning) if family == 'cox' \
            else _no_warning():
        model = RegressionModel(outcome, X, family=family, dtype=dtype,
                                device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    bridge.rg.set_seed(11)
    return bridge


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _jax_bridge(family, n=80, p=12, seed=0):
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionCoefPrior as JaxPrior,
        RegressionModel as JaxModel,
    )
    X, outcome = _data(family, n, p, seed)
    with pytest.warns(UserWarning) if family == 'cox' \
            else _no_warning():
        model = JaxModel(outcome, X, family=family, dtype=np.float64)
    return JaxBridge(model, JaxPrior(**PRIOR_KW), dtype=np.float64)


@pytest.mark.parametrize('family', ['linear', 'logit', 'cox'])
def test_update_obs_precision_by_family(family):
    bridge = _bridge(family)
    coef = np.full(bridge.n_pred, .1)
    obs_prec = bridge.update_obs_precision(coef)
    if family == 'linear':
        assert np.isscalar(obs_prec) and obs_prec > 0
    elif family == 'logit':
        obs_prec = np.asarray(obs_prec)
        assert obs_prec.shape == (bridge.model.n_obs,)
        assert np.all(obs_prec > 0)
    else:
        assert obs_prec is None


def test_initialize_obs_precision_matches_moment_default():
    bridge = _bridge('linear')
    coef = np.zeros(bridge.n_pred)
    got = bridge.initialize_obs_precision({}, coef)
    y = bridge.model.y.double().numpy()
    resid = y - bridge.model.design.dot(coef).double().numpy()
    np.testing.assert_allclose(got, np.mean(resid ** 2) ** -1, rtol=1e-6)
    # Explicit init takes precedence.
    assert bridge.initialize_obs_precision({'obs_prec': 3.5}, coef) == 3.5


@pytest.mark.parametrize('method', ['cg', 'cholesky'])
def test_update_regress_coef_gaussian_paths(method):
    bridge = _bridge('logit')
    coef = np.zeros(bridge.n_pred)
    obs_prec = np.full(bridge.model.n_obs, .25)
    lscale = np.ones(bridge.n_pred - 1)
    new_coef, info = bridge.update_regress_coef(
        coef, obs_prec, .1, lscale, method)
    assert new_coef.shape == (bridge.n_pred,)
    assert np.all(np.isfinite(new_coef))
    assert np.any(new_coef != coef)
    if method == 'cg':
        assert info['n_cg_iter'] > 0


def test_update_regress_coef_hmc_path():
    bridge = _bridge('cox', n=60, p=8)
    coef = np.zeros(bridge.n_pred)
    lscale = np.ones(bridge.n_pred)
    new_coef, info = bridge.update_regress_coef(
        coef, None, .1, lscale, 'hmc')
    assert new_coef.shape == (bridge.n_pred,)
    assert np.all(np.isfinite(new_coef))
    assert info['n_grad_evals'] > 0 and np.isfinite(info['stepsize'])


def test_update_global_scale_methods():
    bridge = _bridge('logit')
    rng = np.random.default_rng(5)
    coef = rng.standard_normal(11) * .5
    alpha = .5
    # 'sample' draws a positive value.
    g1 = bridge.update_global_scale(.1, coef, alpha)
    assert g1 > 0
    # 'optimize' equals the MC-EM maximizer when above the lower bound.
    g2 = bridge.update_global_scale(.1, coef, alpha, method='optimize')
    np.testing.assert_allclose(
        g2, bridge.monte_carlo_em_global_scale(coef, alpha))
    # None passes through.
    assert bridge.update_global_scale(.37, coef, alpha, method=None) == .37
    # Empty shrinkage set returns the reference's placeholder.
    assert bridge.update_global_scale(.1, np.zeros(0), alpha) == 1.0
    # All-zero coefficients clamp to the lower bound with a warning.
    with pytest.warns(UserWarning, match='unreasonably small'):
        g3 = bridge.update_global_scale(.1, np.zeros(11), alpha)
    assert g3 > 0
    with pytest.raises(ValueError):
        bridge.update_global_scale(.1, coef, alpha, method='median')


def test_monte_carlo_em_matches_closed_form():
    bridge = _bridge('logit')
    coef = np.array([.5, -.25, 1.0])
    alpha = .5
    phi = len(coef) / alpha / np.sum(np.abs(coef) ** alpha)
    np.testing.assert_allclose(
        bridge.monte_carlo_em_global_scale(coef, alpha),
        phi ** -(1 / alpha))


def test_update_local_scale_shapes_and_ridge_case():
    bridge = _bridge('logit')
    rng = np.random.default_rng(7)
    coef = rng.standard_normal(11) * .3
    lscale = bridge.update_local_scale(.5, coef, .5)
    assert lscale.shape == (11,)
    assert np.all(lscale > 0) and np.all(np.isfinite(lscale))
    # bridge_exp == 2 is the deterministic ridge case.
    np.testing.assert_array_equal(
        bridge.update_local_scale(.5, coef, 2), .5 * np.ones(11))


def test_update_local_scale_replaces_underflow(monkeypatch):
    """An infinite tilted-stable draw gives a zero local scale: replaced
    by 1e-15 with the reference's warning."""
    bridge = _bridge('logit')
    monkeypatch.setattr(bridge.rg, 'tilted_stable',
                        lambda a, t: np.array([1.0, np.inf, 2.0]))
    with pytest.warns(UserWarning, match='under-flowed'):
        lscale = bridge.update_local_scale(.5, np.ones(3), .5)
    np.testing.assert_array_equal(lscale, [.5 ** .5, 1e-15, .25 ** .5])
    monkeypatch.setattr(bridge.rg, 'tilted_stable',
                        lambda a, t: np.array([0.0, 2.0]))
    with pytest.warns(UserWarning, match='over-flowed'):
        lscale = bridge.update_local_scale(.5, np.ones(2), .5)
    np.testing.assert_array_equal(lscale, [4.0, .25 ** .5])


def test_compute_posterior_logprob_matches_reference_formula():
    bridge = _bridge('linear', dtype=np.float64)
    rng = np.random.default_rng(9)
    coef = rng.standard_normal(bridge.n_pred) * .2
    gscale, obs_prec, alpha = .3, 1.7, .5
    got = bridge.compute_posterior_logprob(coef, gscale, obs_prec, alpha)
    # Independent NumPy evaluation of the reference's bookkeeping
    # (bayesbridge.py:480-511).
    loglik = float(bridge.model.compute_loglik_and_gradient(
        torch.from_numpy(coef), torch.tensor(obs_prec, dtype=torch.float64),
        loglik_only=True)[0])
    loglik += -.5 * np.sum((coef / bridge.prior.slab_size) ** 2)
    n_shrunk = len(coef) - bridge.n_unshrunk
    prior_logp = -n_shrunk * math.log(gscale) \
        - np.sum(np.abs(coef[bridge.n_unshrunk:] / gscale) ** alpha)
    sd = np.asarray(bridge.prior_sd_for_unshrunk, dtype=np.float64)
    finite = np.isfinite(sd)
    prior_logp += -.5 * np.sum(
        (coef[:bridge.n_unshrunk][finite] / sd[finite]) ** 2)
    prior_logp += -np.sum(np.log(sd[finite]))
    prm = bridge.prior.param['gscale_neg_power']
    prior_logp += (prm['shape'] - 1.) * math.log(gscale) \
        - prm['rate'] * gscale
    np.testing.assert_allclose(got, loglik + prior_logp, rtol=1e-8)


def test_change_log_base():
    np.testing.assert_allclose(
        RegressionCoefPrior.change_log_base(math.log(100.)), 2.0)
    np.testing.assert_allclose(
        RegressionCoefPrior.change_log_base(3., from_=10., to=100.), 1.5)


def test_manual_gibbs_loop_via_public_components():
    """A custom sampler loop written the reference way, alternating the
    public component updates, runs and moves the chain."""
    bridge = _bridge('logit')
    alpha = bridge.prior.bridge_exp
    coef = np.zeros(bridge.n_pred)
    gscale = .1
    lscale = np.ones(bridge.n_pred - 1)
    obs_prec = bridge.initialize_obs_precision({}, coef)
    logps = []
    for _ in range(5):
        coef, _ = bridge.update_regress_coef(
            coef, obs_prec, gscale, lscale, 'cg')
        obs_prec = bridge.update_obs_precision(coef)
        shrunk = coef[bridge.n_unshrunk:]
        gscale = bridge.update_global_scale(gscale, shrunk, alpha)
        lscale = bridge.update_local_scale(gscale, shrunk, alpha)
        logps.append(bridge.compute_posterior_logprob(
            coef, gscale, obs_prec, alpha))
    assert np.all(np.isfinite(logps))
    assert len(set(np.round(logps, 6))) > 1  # the chain actually moved


def test_components_draw_from_the_bridge_generator():
    """The updates draw from the bridge's generator: the same seed gives
    the same draws, a resumed generator state the same next draws."""
    def draws(bridge):
        coef = np.full(bridge.n_pred, .2)
        return (bridge.update_obs_precision(coef),
                bridge.update_global_scale(.1, coef[1:], .5),
                bridge.update_local_scale(.3, coef[1:], .5))

    one, two = _bridge('logit'), _bridge('logit')
    for a, b in zip(draws(one), draws(two)):
        np.testing.assert_array_equal(a, b)
    state = one.rg.get_state()
    first = draws(one)
    one.rg.set_state(state)
    for a, b in zip(first, draws(one)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('family', ['linear', 'logit'])
def test_initialize_obs_precision_matches_jax(family):
    ours = _bridge(family, dtype=np.float64)
    theirs = _jax_bridge(family)
    coef = np.random.default_rng(3).standard_normal(ours.n_pred) * .3
    np.testing.assert_allclose(
        np.asarray(ours.initialize_obs_precision({}, coef), np.float64),
        np.asarray(theirs.initialize_obs_precision({}, coef), np.float64),
        rtol=1e-10)


def test_monte_carlo_em_matches_jax():
    ours, theirs = _bridge('logit', dtype=np.float64), _jax_bridge('logit')
    coef = np.random.default_rng(4).standard_normal(11) * .4
    for alpha in (.25, .5, 1.0):
        np.testing.assert_allclose(
            ours.monte_carlo_em_global_scale(coef, alpha),
            theirs.monte_carlo_em_global_scale(coef, alpha), rtol=1e-10)
        np.testing.assert_allclose(
            ours.update_global_scale(.1, coef, alpha, method='optimize'),
            theirs.update_global_scale(.1, coef, alpha, method='optimize'),
            rtol=1e-10)


@pytest.mark.parametrize('family', ['linear', 'logit', 'cox'])
def test_compute_posterior_logprob_matches_jax(family):
    ours = _bridge(family, dtype=np.float64)
    theirs = _jax_bridge(family)
    assert ours.dtype == torch.float64
    rng = np.random.default_rng(8)
    coef = rng.standard_normal(ours.n_pred) * .3
    obs_prec = {'linear': 1.7, 'logit': rng.uniform(.1, .3, 80),
                'cox': None}[family]
    for gscale, alpha in ((.3, .5), (.05, .25), (1.2, 1.0)):
        np.testing.assert_allclose(
            ours.compute_posterior_logprob(coef, gscale, obs_prec, alpha),
            theirs.compute_posterior_logprob(coef, gscale, obs_prec, alpha),
            rtol=1e-10)


def test_basic_random_draws():
    rg = BasicRandom('cpu', seed=0, dtype=torch.float64)
    z = rg.normal(20000)
    u = rg.uniform((50, 400))
    g = rg.gamma(3.0, size=20000)
    assert z.shape == (20000,) and u.shape == (50, 400)
    assert g.shape == (20000,) and np.ndim(rg.gamma(2.0)) == 0
    assert np.ndim(rg.uniform()) == 0
    assert abs(z.mean()) < .03 and abs(z.std() - 1) < .03
    assert u.min() >= 0 and u.max() < 1 and abs(u.mean() - .5) < .01
    assert abs(g.mean() - 3) < .06 and abs(g.var() - 3) < .2


def test_logistic_helpers_match_jax():
    from bayesbridge_tpu.models.logistic import LogisticModel as JaxLogit
    X = simulate_design(60, 8, binary_frac=.5, seed=2)
    model = RegressionModel(np.ones(60), X, family='logit',
                            dtype=np.float64, device='cpu')
    beta = np.random.default_rng(1).standard_normal(9)
    x = np.array([-800., -30., 0., 2., 40.])
    for truncate in (False, True):
        got = LogisticModel.convert_to_probability_scale(x, truncate)
        ref = 1 / (1 + np.exp(-np.clip(x, -709., 36.7) if truncate else -x))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
        # XLA on the CPU flushes the subnormal 1.2e-308 at -709 to 0.
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(JaxLogit.convert_to_probability_scale(x, truncate)),
            rtol=1e-12, atol=1e-300)
    assert 0 < float(LogisticModel.convert_to_probability_scale(
        torch.tensor(-800., dtype=torch.float64), True))
    prob = LogisticModel.compute_predicted_prob(model.design, beta)
    np.testing.assert_allclose(prob.numpy(), 1 / (1 + np.exp(
        -model.design.toarray() @ beta)), rtol=1e-12)
    n_trial = np.full(60, 5)
    ours = LogisticModel.simulate_outcome(n_trial, model.design, beta,
                                          seed=3)
    dense = model.design.toarray()
    theirs = JaxLogit.simulate_outcome(n_trial, dense, beta, seed=3)
    np.testing.assert_array_equal(ours, theirs)


def test_design_memo_and_counters():
    X = simulate_design(30, 10, binary_frac=.5, seed=11)
    model = RegressionModel(np.ones(30), X, family='logit',
                            add_intercept=False, device='cpu')
    design = model.design
    v = np.random.default_rng(12).standard_normal(10)
    design.dot(v)
    design.Tdot(np.ones(30))
    assert design.get_dot_count() == (1, 1) and design.n_matvec == 2
    design.reset_matvec_count()
    assert design.n_matvec == 0
    design.reset_matvec_count((3, 4))
    assert design.get_dot_count() == (3, 4)
    design.reset_matvec_count()
    design.memoize_dot(True)
    r1 = design.dot(v)
    r2 = design.dot(v)  # memoized: no new evaluation
    assert design.dot_count == 1 and r2 is r1
    design.dot(v + 1)
    assert design.dot_count == 2
    design.memoize_dot(False)
    design.dot(v + 1)
    assert design.dot_count == 3
    np.testing.assert_array_equal(design.extract_matrix().numpy(),
                                  design.toarray())
