"""The hybrid backend's composed path (the default policy) against the JAX
package's ``fused='0'``.

Both packages build the same hybrid design from one scipy CSR matrix:
0/1, small-count or bf16-exact columns in the exact block beside a
float32 block, or an all-0/1 design (one int8 block, whose squared
moment the JAX package reuses from X'u3), centred or not, with or
without the intercept.

* ``main_dot``, ``main_Tdot``, ``cg_blockorder_ctx`` (the permutation
  equal), ``quad_matvec`` and ``quad_matvec_blockorder`` with and without
  ``return_t``, and ``presolve_reductions(u1, u2, u3, u4)`` (the
  multi-RHS pre-solve with the warm-start column): within 1e-5 of
  max|ref| (float32 sums in another order);
* ``sample_gaussian_cg`` with the caller's warm start (``warm_tdot``,
  ``lin_pred0``) and a given perturbation on identical numpy inputs: the
  same ``n_cg_iter``, the draw within 1e-4 of max|ref|; its ValueError;
* the fused policy (``design.fusedne``): the env default, per-kind
  ``fused_ne_mode``, one Gibbs step under every mix of fused and composed
  kinds against the all-composed step;
* per Gibbs step the composed path runs one ``dot`` per CG iteration plus
  one for the warm start, and no separate linear-predictor pass;
* a chain against the JAX package's posterior means (ESS-aware z-score
  test of tests/test_torch_gibbs.py, |z| < 4.5) on a design with a
  small-count exact block; resume equals an uninterrupted run exactly;
  a design without an exact column runs.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.ops.cg import sample_gaussian_cg as jax_cg
from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.design import SparseDesignMatrix, fusedne
from bayesbridge_tpu_torch.gibbs_util import SamplerOptions
from bayesbridge_tpu_torch.ops.cg import sample_gaussian_cg

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

KINDS = ('binary', 'counts', 'bf16', 'binary_only')
Z_MAX = 4.5


def _design_data(kind, seed, n=83, p_exact=23, p_float=6):
    rng = np.random.default_rng(seed)
    exact = (rng.random((n, p_exact)) < .3).astype(np.float64)
    if kind == 'counts':
        exact *= rng.integers(1, 4, size=exact.shape)
    elif kind == 'bf16':
        exact *= rng.choice([0.5, 1.25, -2.0], size=exact.shape)
    if kind == 'binary_only':
        p_float = 0
    dense = np.hstack((exact, rng.standard_normal((n, p_float))
                       * (rng.random((n, p_float)) < .7)))
    return rng, sps.csr_matrix(dense[:, rng.permutation(dense.shape[1])])


def _pair(monkeypatch, X, centered, intercept):
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    kw = dict(center_predictor=centered, add_intercept=intercept,
              backend='hybrid', fused='0')
    jd = JaxDesign(X, dtype=np.float32, **kw)
    td = SparseDesignMatrix(X, device='cpu', **kw)
    return jd, td


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize('intercept', [False, True])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('kind', KINDS)
def test_composed_products_match_jax(monkeypatch, kind, centered, intercept):
    rng, X = _design_data(kind, 3 + 4 * centered + 2 * intercept)
    jd, td = _pair(monkeypatch, X, centered, intercept)
    assert td.exact_is_binary == jd.exact_is_binary \
        == (kind == 'binary_only')
    assert td.n_float == (0 if kind == 'binary_only'
                          else int(jd.float_cols.shape[0]))
    want = torch.bfloat16 if kind == 'bf16' else torch.int8
    assert td.X_exact.dtype == want
    assert td.fused_ne_mode('quad') is None
    assert jd.fused_ne_mode('quad') is None
    assert td.has_presolve_reductions() and jd.has_presolve_reductions()
    n, p = td.shape
    p_main = p - intercept
    f32 = np.float32
    v = rng.standard_normal(p).astype(f32)
    w = rng.exponential(size=n).astype(f32)
    us = [rng.standard_normal(n).astype(f32) for _ in range(4)]

    _close(td.main_dot(torch.from_numpy(v[:p_main])).numpy(),
           jd.main_dot(jnp.asarray(v[:p_main])))
    _close(td.main_Tdot(torch.from_numpy(us[0])).numpy(),
           jd.main_Tdot(jnp.asarray(us[0])))
    for return_t in (False, True):
        got = td.quad_matvec(v, w, return_t=return_t)
        ref = jd.quad_matvec(v, w, return_t=return_t)
        for g, r in zip(*((got, ref) if return_t else ((got,), (ref,)))):
            _close(g.numpy(), r)

    perm, unperm, off_bo = td.cg_blockorder_ctx()
    perm_j, unperm_j, off_j = jd.cg_blockorder_ctx()
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(unperm.numpy(), np.asarray(unperm_j))
    _close(off_bo.numpy(), off_j, rtol=1e-6)
    v_bo = v[perm.numpy()]
    for return_t in (False, True):
        got = td.quad_matvec_blockorder(v_bo, w, off_bo, return_t=return_t)
        ref = jd.quad_matvec_blockorder(jnp.asarray(v_bo), jnp.asarray(w),
                                        off_j, return_t=return_t)
        if not return_t:
            got, ref = (got,), (ref,)
        for g, r in zip(got, ref):
            _close(g.numpy(), r)
        # Block order is a conjugation of the plain operator.
        _close(got[0].numpy()[unperm.numpy()], td.quad_matvec(v, w).numpy())

    got = td.presolve_reductions(*us[:2], w, us[3])
    ref = jd.presolve_reductions(*(jnp.asarray(u) for u in us[:2]),
                                 jnp.asarray(w), jnp.asarray(us[3]))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    # The Jacobi diagonal and the warm-start column against the dense form.
    dense = td.toarray().astype(np.float64)
    _close(got[2].numpy(), (dense * dense).T @ w)
    _close(got[3].numpy(), dense.T @ us[3])


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
    coef_init = (rng.standard_normal(p) * .1).astype(f32)
    lin_pred0 = dense @ coef_init
    return dense, dict(
        obs_prec=obs_prec, prior_prec_sqrt=prior_prec_sqrt, z=z,
        coef_cg_init=coef_init, precond_scale=precond,
        perturbation=(rng.standard_normal(p) * 2.0).astype(f32),
        warm_tdot=(dense.T @ (obs_prec * lin_pred0)).astype(f32),
        lin_pred0=lin_pred0.astype(f32))


@pytest.mark.parametrize('warm', [False, True])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('kind', KINDS)
def test_cg_matches_jax(monkeypatch, kind, centered, warm):
    """The block-ordered solve from the caller's warm start (or from the
    initial residual's operator application) on identical inputs."""
    rng, X = _design_data(kind, 40 + 2 * centered + warm, n=150,
                          p_exact=30, p_float=7)
    jd, td = _pair(monkeypatch, X, centered, True)
    dense, a = _cg_inputs(rng, td)
    if not warm:
        del a['warm_tdot'], a['lin_pred0']
    # The stopping rule at cg_atol_multiplier 10. Where the last residual
    # lands within float32 rounding of the threshold, the two packages
    # may stop one iteration apart: over 120 random problems of this
    # size, 10 did at 1e-5 sqrt(p), 5 at 1e-4 sqrt(p); these seeds are
    # clear of it.
    atol = 1e-4 * np.sqrt(td.shape[1])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    coef_j, lin_j, info_j = jax_cg(
        jax.random.key(0), jd, j.pop('obs_prec'), j.pop('prior_prec_sqrt'),
        j.pop('z'), maxiter=500, atol=atol, return_lin_pred=True, **j)
    coef_t, lin_t, info_t = sample_gaussian_cg(
        None, td, t.pop('obs_prec'), t.pop('prior_prec_sqrt'), t.pop('z'),
        maxiter=500, atol=atol, return_lin_pred=True, **t)
    assert info_t['n_cg_iter'] == int(info_j['n_cg_iter']) > 2
    assert info_t['cg_converged'] and bool(info_j['cg_converged'])
    ref = np.asarray(coef_j, np.float64)
    _close(coef_t.numpy(), ref, rtol=1e-4)
    _close(lin_t.numpy(), lin_j, rtol=1e-4)
    _close(lin_t.numpy(), dense @ coef_t.numpy().astype(np.float64),
           rtol=1e-4)


def test_warm_start_needs_lin_pred0(monkeypatch):
    rng, X = _design_data('binary', 7)
    _, td = _pair(monkeypatch, X, True, True)
    _, a = _cg_inputs(rng, td)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    del t['lin_pred0']
    with pytest.raises(ValueError, match='lin_pred0'):
        sample_gaussian_cg(None, td, t.pop('obs_prec'),
                           t.pop('prior_prec_sqrt'), t.pop('z'),
                           return_lin_pred=True, **t)


def test_policy_default_and_kinds(monkeypatch):
    monkeypatch.delenv('BB_FUSED_NE', raising=False)
    for kind in fusedne.KINDS:
        assert fusedne.dispatch_mode(kind) == (
            True if fusedne.AUTO[kind] else None)
        assert fusedne.dispatch_mode(kind, '0') is None
        assert fusedne.dispatch_mode(kind, '1') is True
        assert fusedne.dispatch_mode(kind, 'full') is True
    monkeypatch.setenv('BB_FUSED_NE', '1')
    assert fusedne.dispatch_mode('quad') is True
    _, X = _design_data('binary', 1)
    assert SparseDesignMatrix(X, device='cpu').fused_ne_mode() is True
    with pytest.raises(ValueError, match='kind'):
        fusedne.dispatch_mode('gram')
    monkeypatch.setenv('BB_FUSED_NE', 'sometimes')
    with pytest.raises(ValueError, match='policy'):
        fusedne.dispatch_mode('quad')
    monkeypatch.setattr(fusedne, 'AUTO', dict(quad=False, presolve=True,
                                              link=False))
    d = SparseDesignMatrix(X, fused='auto', device='cpu')
    assert d.fused_ne_mode('presolve') is True
    assert d.fused_ne_mode('quad') is None and d.fused_ne_mode('link') is None
    assert d.cg_blockorder_ctx() is not None


def test_with_policy_shares_the_stored_blocks():
    _, X = _design_data('binary', 2)
    d = SparseDesignMatrix(X, fused='1', device='cpu')
    d.dot(np.ones(d.shape[1], np.float32))
    other = d.with_policy('0')
    assert other.X_exact is d.X_exact and other.X_float is d.X_float
    assert other.get_dot_count() == (0, 0) and d.get_dot_count() == (1, 0)
    assert d.fused_ne_mode() is True and other.fused_ne_mode() is None
    with pytest.raises(ValueError, match='policy'):
        d.with_policy('2')


def _parity_problem():
    rng, X = _design_data('counts', 11, n=400, p_exact=16, p_float=4)
    beta = np.zeros(X.shape[1])
    beta[:3] = 1.0
    lin = X @ beta - .5
    y = (rng.random(X.shape[0]) < 1 / (1 + np.exp(-lin))).astype(np.float64)
    return X, y


def _one_step(policy, monkeypatch, mix=None):
    X, y = _parity_problem()
    if mix is not None:
        monkeypatch.setattr(fusedne, 'AUTO', dict(zip(fusedne.KINDS, mix)))
    model = RegressionModel(y, X, family='logit', fused=policy,
                            device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=.5))
    cfg = step_mod.GibbsStepConfig(
        model, bridge.prior, SamplerOptions('cg'), bridge.n_unshrunk,
        bridge.prior_sd_for_unshrunk)
    p = model.design.shape[1]
    carry = step_mod.init_carry(
        'cpu', np.linspace(-.5, .5, p), np.full(X.shape[0], .2), .3,
        np.ones(p - 1))
    model.design.dot_count = model.design.Tdot_count = 0
    carry, out = step_mod.gibbs_step(cfg, model,
                                     torch.Generator().manual_seed(5), carry)
    return model.design, carry, out


@pytest.mark.parametrize('mix', list(itertools.product((False, True),
                                                       repeat=3)))
def test_step_under_every_policy_mix(monkeypatch, mix):
    """One Gibbs step with each kind fused or composed against the
    all-composed step from the same state and generator: the same
    n_cg_iter and coef within 1e-4 of max|coef| (float32 rounding)."""
    _, ref_carry, ref_out = _one_step('0', monkeypatch)
    _, carry, out = _one_step('auto', monkeypatch, mix)
    assert out['n_cg_iter'] == ref_out['n_cg_iter']
    _close(carry['coef'].numpy(), ref_carry['coef'].numpy(), rtol=1e-4)


def test_step_reads_per_iteration(monkeypatch):
    """Composed: a dot for X coef_init, one dot + Tdot per CG iteration
    (the initial residual rides the pre-solve), three pre-solve Tdots (the
    warm-start column among them), no linear-predictor pass. Fused: one
    sweep per operator application, the initial residual's included, two
    pre-solve Tdots and the linear predictor's dot."""
    design, _, out = _one_step('0', monkeypatch)
    k = out['n_cg_iter']
    assert design.get_dot_count() == (k + 1, k + 3)
    design, _, out = _one_step('1', monkeypatch)
    k = out['n_cg_iter']
    assert design.get_dot_count() == (k + 2, k + 3)


N_ITER, N_BURNIN = 400, 100
PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


@pytest.fixture(scope='module')
def jax_chain():
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    X, y = _parity_problem()
    jmodel = JaxModel(y, X, family='logit', dtype=np.float32, fused='0')
    samples, _ = JaxBridge(jmodel, JaxPrior(**PRIOR_KW),
                           dtype=np.float32).gibbs(
        N_ITER, N_BURNIN, seed=1, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    return samples


def _moments(draws):
    from bayesbridge_tpu.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.maximum(np.asarray(compute_effective_sample_size(draws)), 8.0)
    return draws.mean(axis=-1), draws.std(axis=-1) / np.sqrt(ess)


def test_chain_matches_jax_posterior(jax_chain):
    X, y = _parity_problem()
    model = RegressionModel(y, X, family='logit', fused='0', device='cpu')
    assert model.design.X_exact.dtype == torch.int8
    assert not model.design.exact_is_binary
    ours, _ = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW)).gibbs(
        N_ITER, N_BURNIN, seed=0, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    m1, se1 = _moments(np.asarray(ours['coef'], np.float64))
    m2, se2 = _moments(np.asarray(jax_chain['coef'], np.float64))
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))


@pytest.mark.parametrize('exact', [True, False])
def test_resume_equals_uninterrupted(exact):
    """Composed hybrid designs with and without an exact column (the
    latter pre-solves by separate Tdots and the Fisher diagonal)."""
    if exact:
        X, y = _parity_problem()
    else:
        rng = np.random.default_rng(9)
        X = sps.csr_matrix(rng.standard_normal((120, 8))
                           * (rng.random((120, 8)) < .6))
        y = (rng.random(120) < .4).astype(np.float64)
    model = RegressionModel(y, X, family='logit', fused='0', device='cpu')
    assert model.design.backend == 'hybrid'
    assert model.design.has_presolve_reductions() == exact
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    full, i_full = bridge.gibbs(12, seed=3, coef_sampler_type='cg',
                                params_to_save='all')
    assert np.all(np.isfinite(full['logp']))
    part, info = bridge.gibbs(7, seed=3, coef_sampler_type='cg',
                              params_to_save='all')
    merged, i_m = bridge.gibbs_resume(info, 5, merge=True, prev_samples=part)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
    np.testing.assert_array_equal(
        i_m['_reg_coef_sampling_info']['n_cg_iter'],
        i_full['_reg_coef_sampling_info']['n_cg_iter'])
