"""The composed CG path of the port (bitpack and winell designs) against
the JAX package's, and ``backend='auto'`` parity.

* ``backend='auto'`` picks what the JAX package picks for hybrid-,
  bitpack-, winell- and ell-shaped designs, with the budgets patched in
  both packages' modules (the port's seam is its own
  ``design.sparse`` module), and the picked design's X v matches the
  JAX design's (rtol 1e-5 of max; tests/test_torch_ell.py holds the
  ell backend in full);
* ``sample_gaussian_cg`` with ``return_lin_pred`` on identical numpy
  inputs: the same ``n_cg_iter``, the draw within rtol 1e-4 / atol 1e-4
  * max|coef| (the two operators round differently in each of a few
  dozen iterations), and the accumulated linear predictor equal to X
  coef within rtol 1e-4 of max|X coef|;
* the composed loglik + gradient of the MAP search on each backend
  against the JAX model's, with centering and intercept on and off, and
  on a hybrid design the composed objective against the fused sweep's:
  loglik rtol 1e-5, gradient rtol 2e-5 / atol 2e-5 * max|ref| (float32
  sums in another order);
* one Gibbs step spends exactly one `dot` per operator application (the
  linear predictor comes from the CG loop);
* a chain on each backend against the JAX package's posterior means
  (ESS-aware z-score test of tests/test_torch_gibbs.py, |z| < 4.5), and
  resume equals an uninterrupted run exactly on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import bayesbridge_tpu.design.sparse as jax_sparse
from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.ops.cg import sample_gaussian_cg as jax_cg
import bayesbridge_tpu_torch.design.sparse as port_sparse
from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.gibbs_util import SamplerOptions
from bayesbridge_tpu_torch.ops.cg import sample_gaussian_cg
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

BACKENDS = ('bitpack', 'winell')
Z_MAX = 4.5


def _sparse_normal(rng, n, p, density):
    return sps.csr_matrix(rng.standard_normal((n, p))
                          * (rng.random((n, p)) < density))


@pytest.mark.parametrize('shape,budgets,want', [
    ('binary', None, 'hybrid'),
    ('binary', (1e3, 1e9), 'bitpack'),
    ('normal', (1e3, 1e9), 'winell'),
    ('normal', (1e3, 1e3), 'ell'),
    ('dense', (1e3, 1e3), 'hybrid'),
])
def test_auto_backend_matches_jax(monkeypatch, shape, budgets, want):
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    if budgets is not None:
        for mod in (jax_sparse, port_sparse):
            monkeypatch.setattr(mod, '_HYBRID_MAX_BYTES', budgets[0])
            monkeypatch.setattr(mod, '_BITPACK_MAX_BYTES', budgets[1])
    rng = np.random.default_rng(0)
    if shape == 'binary':
        X = sps.csr_matrix((rng.random((200, 64)) < .1).astype(float))
    elif shape == 'normal':
        X = _sparse_normal(rng, 400, 100, .02)
    else:  # dense-ish, half of the columns 0/1
        X = _sparse_normal(rng, 400, 100, .9).tolil()
        X[:, :50] = (rng.random((400, 50)) < .9).astype(float)
        X = X.tocsr()
    jd = JaxDesign(X, add_intercept=False, backend='auto', dtype=np.float32)
    assert jd.backend == want
    td = SparseDesignMatrix(X, add_intercept=False, device='cpu')
    assert td.backend == want
    v = rng.standard_normal(X.shape[1]).astype(np.float32)
    ref = np.asarray(jd.dot(jnp.asarray(v)), np.float64)
    np.testing.assert_allclose(td.dot(v).numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _designs(backend, seed, centered):
    rng = np.random.default_rng(seed)
    n, p = 150, 37
    X = (rng.random((n, p)) < .15).astype(np.float64)
    X[:, ::5] *= rng.standard_normal((n, len(range(0, p, 5))))
    X = sps.csr_matrix(X)
    jd = JaxDesign(X, center_predictor=centered, backend=backend,
                   dtype=np.float32)
    td = SparseDesignMatrix(X, center_predictor=centered, backend=backend,
                            device='cpu')
    return rng, jd, td


def _cg_inputs(rng, td):
    n, p = td.shape
    f32 = np.float32
    obs_prec = (rng.exponential(size=n) * .25 + .05).astype(f32)
    prior_prec_sqrt = np.concatenate(
        ([1e-3], 1.0 / rng.uniform(.05, 3.0, size=p - 1))).astype(f32)
    dense = td.toarray().astype(np.float64)
    z = (dense.T @ (rng.standard_normal(n) * obs_prec)).astype(f32)
    fisher = (dense * dense).T @ obs_prec
    precond = (1.0 / np.sqrt(prior_prec_sqrt.astype(np.float64) ** 2
                             + fisher)).astype(f32)
    return dense, dict(
        obs_prec=obs_prec, prior_prec_sqrt=prior_prec_sqrt, z=z,
        coef_cg_init=(rng.standard_normal(p) * .1).astype(f32),
        precond_scale=precond,
        perturbation=(rng.standard_normal(p) * 2.0).astype(f32))


@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('backend', BACKENDS)
def test_composed_cg_matches_jax(backend, centered):
    rng, jd, td = _designs(backend, 1 + centered, centered)
    dense, a = _cg_inputs(rng, td)
    atol = 1e-5 * np.sqrt(td.shape[1])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    coef_j, lin_j, info_j = jax_cg(
        jax.random.key(0), jd, j['obs_prec'], j['prior_prec_sqrt'], j['z'],
        coef_cg_init=j['coef_cg_init'], precond_scale=j['precond_scale'],
        maxiter=500, atol=atol, perturbation=j['perturbation'],
        return_lin_pred=True)
    coef_t, lin_t, info_t = sample_gaussian_cg(
        None, td, t['obs_prec'], t['prior_prec_sqrt'], t['z'],
        coef_cg_init=t['coef_cg_init'], precond_scale=t['precond_scale'],
        maxiter=500, atol=atol, perturbation=t['perturbation'],
        return_lin_pred=True)
    assert info_t['n_cg_iter'] == int(info_j['n_cg_iter']) > 2
    assert info_t['cg_converged'] and bool(info_j['cg_converged'])
    ref = np.asarray(coef_j, np.float64)
    np.testing.assert_allclose(coef_t.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    x_coef = dense @ coef_t.numpy().astype(np.float64)
    scale = np.abs(x_coef).max()
    np.testing.assert_allclose(lin_t.numpy(), x_coef, rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(lin_t.numpy(), np.asarray(lin_j), rtol=1e-4,
                               atol=1e-4 * scale)


def _objective_problem(seed):
    rng = np.random.default_rng(seed)
    n, p = 300, 70
    X = (rng.random((n, p)) < .12).astype(np.float64)
    X[:, ::9] *= rng.standard_normal((n, len(range(0, p, 9))))
    y = (rng.random(n) < .4).astype(np.float64)
    return rng, sps.csr_matrix(X), y


def _assert_objective_close(got, ref):
    lp, grad = (np.asarray(x, np.float64) for x in got)
    lp_ref, grad_ref = (np.asarray(x, np.float64) for x in ref)
    np.testing.assert_allclose(lp, lp_ref, rtol=1e-5)
    np.testing.assert_allclose(grad, grad_ref, rtol=2e-5,
                               atol=2e-5 * np.abs(grad_ref).max())


@pytest.mark.parametrize('intercept', [False, True])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('backend', BACKENDS)
def test_loglik_and_gradient_matches_jax(backend, centered, intercept):
    """The MAP search's objective on the packed backends (dot, loglik
    rows, Tdot of the score) against the JAX model's composed one."""
    from bayesbridge_tpu import RegressionModel as JaxModel
    rng, X, y = _objective_problem(20 + 2 * centered + intercept)
    kw = dict(family='logit', add_intercept=intercept,
              center_predictor=centered, backend=backend)
    jm = JaxModel(y, X, dtype=np.float32, **kw)
    tm = RegressionModel(y, X, device='cpu', **kw)
    assert tm.design.fused_link_grad(np.zeros(1), y, y, 'logit') is None
    beta = (rng.standard_normal(tm.design.shape[1]) * .3).astype(np.float32)
    got = tm.compute_loglik_and_gradient(torch.from_numpy(beta))
    _assert_objective_close(got, jm.compute_loglik_and_gradient(
        jnp.asarray(beta)))


@pytest.mark.parametrize('centered', [False, True])
def test_composed_objective_matches_fused_on_hybrid(centered):
    """On one hybrid design the composed objective (dot, loglik rows,
    Tdot) and the fused sweep's agree: the packed backends' MAP search
    differs from the hybrid's only by the order of float32 sums."""
    rng, X, y = _objective_problem(30 + centered)
    model = RegressionModel(y, X, family='logit', center_predictor=centered,
                            backend='hybrid', device='cpu')
    design = model.design
    beta = torch.from_numpy(
        (rng.standard_normal(design.shape[1]) * .3).astype(np.float32))
    fused = model.compute_loglik_and_gradient(beta)
    lin_pred = design.dot(beta)
    composed = (model.loglik_from_lin_pred(lin_pred), design.Tdot(
        model.n_success - model.n_trial * torch.sigmoid(lin_pred)))
    _assert_objective_close(composed, fused)


def _parity_problem():
    X = simulate_design(400, 20, binary_frac=.7, seed=11)
    beta = np.zeros(20)
    beta[:3] = 1.0
    return X, simulate_outcome(X, beta, 'logit', seed=12)


@pytest.mark.parametrize('backend', BACKENDS)
def test_step_takes_lin_pred_from_cg(backend):
    """Per Gibbs step the design runs dot once per CG operator
    application (n_cg_iter + 1) and Tdot once more for each, plus the two
    pre-solve Tdots: no separate linear-predictor pass."""
    X, outcome = _parity_problem()
    model = RegressionModel(outcome, X, family='logit', backend=backend,
                            device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    _, info = bridge.gibbs(3, seed=0, coef_sampler_type='cg')
    cfg = step_mod.GibbsStepConfig(
        model, bridge.prior, SamplerOptions('cg'), bridge.n_unshrunk,
        bridge.prior_sd_for_unshrunk)
    state = info['_markov_chain_state_raw']
    carry = step_mod.init_carry('cpu', state['coef'], state['obs_prec'],
                                state['global_scale'], state['local_scale'])
    design = model.design
    design.dot_count = design.Tdot_count = 0
    _, out = step_mod.gibbs_step(cfg, model, torch.Generator().manual_seed(0),
                                 carry)
    k = out['n_cg_iter'] + 1
    assert 'lin_pred' not in out
    assert design.get_dot_count() == (k, k + 2)


N_ITER, N_BURNIN = 400, 100
PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


@pytest.fixture(scope='module', params=BACKENDS)
def jax_chain(request):
    """(backend, JAX samples) on the parity problem."""
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    X, outcome = _parity_problem()
    jmodel = JaxModel(outcome, X, family='logit', dtype=np.float32,
                      backend=request.param)
    assert jmodel.design.backend == request.param
    samples, _ = JaxBridge(jmodel, JaxPrior(**PRIOR_KW),
                           dtype=np.float32).gibbs(
        N_ITER, N_BURNIN, seed=1, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    return request.param, samples


def _moments(draws):
    from bayesbridge_tpu.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.maximum(np.asarray(compute_effective_sample_size(draws)), 8.0)
    return draws.mean(axis=-1), draws.std(axis=-1) / np.sqrt(ess)


def test_chain_matches_jax_posterior(jax_chain):
    backend, theirs = jax_chain
    X, outcome = _parity_problem()
    model = RegressionModel(outcome, X, family='logit', backend=backend,
                            device='cpu')
    assert model.design.backend == backend
    ours, _ = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW)).gibbs(
        N_ITER, N_BURNIN, seed=0, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    m1, se1 = _moments(np.asarray(ours['coef'], np.float64))
    m2, se2 = _moments(np.asarray(theirs['coef'], np.float64))
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))
    assert np.all(m1[1:4] > 0.4) and np.all(m2[1:4] > 0.4)


@pytest.mark.parametrize('backend', BACKENDS)
def test_resume_equals_uninterrupted(backend):
    X, outcome = _parity_problem()
    model = RegressionModel(outcome, X, family='logit', backend=backend,
                            device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    full, i_full = bridge.gibbs(12, seed=3, coef_sampler_type='cg',
                                params_to_save='all')
    part, info = bridge.gibbs(7, seed=3, coef_sampler_type='cg',
                              params_to_save='all')
    merged, i_m = bridge.gibbs_resume(info, 5, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
    np.testing.assert_array_equal(
        i_m['_reg_coef_sampling_info']['n_cg_iter'],
        i_full['_reg_coef_sampling_info']['n_cg_iter'])
