"""The models' Hessian operators and the Newton branches of the MAP
search (``ops/reg_coef.py``) against the JAX package's on the CPU.

* the linear and logit Hessian matvecs and ``compute_hessian`` on dense
  and hybrid sparse designs: float64 within rtol 1e-10 of the JAX
  package's; float32 under ``fused='0'`` (the row and column passes) and
  ``fused='1'`` (the one-read sweep's plain version) within 1e-5 of
  max|JAX float64| (the matvec is one float32 product pair);
* ``make_precond_hessian_matvec`` (the HMC curvature operator) within
  rtol 1e-10, cast back to the operand's dtype;
* ``search_mode`` with Newton-CG and with trust-ncg: the JAX package's
  method name and a MAP within 1e-6 of its MAP, in float64, for the
  logit, linear and Cox models.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu_torch import RegressionModel
from bayesbridge_tpu_torch.models import CoxModel
from bayesbridge_tpu_torch.ops import reg_coef
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _data(family, seed=1):
    X = np.asarray(simulate_design(160, 20, binary_frac=.6, seed=seed,
                                   format_='dense'))
    beta = np.zeros(20)
    beta[:3] = 0.8
    if family == 'linear':
        y = X @ beta + np.random.default_rng(seed).standard_normal(160)
    elif family == 'logit':
        y = simulate_outcome(X, beta, 'logit', seed=seed + 1)
    else:
        y = CoxModel.simulate_outcome(X, beta, censoring_frac=.5,
                                      seed=seed + 1)
    return X, y


def _pair(family, kind, dtype=np.float64, fused=None):
    """(port model, JAX model) on the same data: `kind` 'dense' (an
    array) or 'hybrid' (scipy CSR)."""
    from bayesbridge_tpu import RegressionModel as JaxModel
    X, y = _data(family)
    X_in = sps.csr_matrix(X) if kind == 'hybrid' else X
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ours = RegressionModel(y, X_in, family=family, dtype=dtype,
                               fused=fused, device='cpu')
        theirs = JaxModel(y, X_in, family=family, dtype=np.float64)
    return ours, theirs


def _args(family, beta, obs_prec=1.7):
    return (beta, obs_prec) if family == 'linear' else (beta,)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize('kind', ['dense', 'hybrid'])
@pytest.mark.parametrize('family', ['linear', 'logit'])
def test_hessian_matvec_and_matrix_match_jax_float64(family, kind):
    import jax.numpy as jnp
    ours, theirs = _pair(family, kind)
    rng = np.random.default_rng(2)
    beta = rng.standard_normal(ours.n_pred) * 0.3
    v = rng.standard_normal(ours.n_pred)
    op = ours.get_hessian_matvec_operator(*_args(family,
                                                 torch.from_numpy(beta)))
    jop = theirs.get_hessian_matvec_operator(*_args(family,
                                                    jnp.asarray(beta)))
    np.testing.assert_allclose(op(torch.from_numpy(v)).numpy(),
                               np.asarray(jop(jnp.asarray(v))),
                               rtol=1e-10, atol=1e-10)
    H = ours.compute_hessian(*_args(family, torch.from_numpy(beta)))
    jH = theirs.compute_hessian(*_args(family, jnp.asarray(beta)))
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(H.numpy() @ v, op(torch.from_numpy(v)),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize('fused', ['0', '1'])
@pytest.mark.parametrize('kind', ['dense', 'hybrid'])
@pytest.mark.parametrize('family', ['linear', 'logit'])
def test_hessian_matvec_float32_policies(family, kind, fused):
    """float32 under both policies: '1' puts the matvec on the one-read
    sweep (``quad_matvec``'s fused call site), '0' on the composed
    pair; both within 1e-5 of the JAX float64 matvec, and k chains'
    rows equal to each chain's alone."""
    import jax.numpy as jnp
    ours, theirs = _pair(family, kind, dtype=np.float32, fused=fused)
    assert bool(ours.design.fused_ne_mode('quad')) == (fused == '1')
    rng = np.random.default_rng(3)
    B = rng.standard_normal((2, ours.n_pred)) * 0.3
    V = rng.standard_normal((2, ours.n_pred))
    prec = np.array([1.7, 0.4])
    op = ours.get_hessian_matvec_operator(*(
        (torch.from_numpy(B).float(), torch.from_numpy(prec).float())
        if family == 'linear' else (torch.from_numpy(B).float(),)))
    got = op(torch.from_numpy(V).float())
    assert got.dtype == torch.float32
    for c in range(2):
        jop = theirs.get_hessian_matvec_operator(*(
            (jnp.asarray(B[c]), prec[c]) if family == 'linear'
            else (jnp.asarray(B[c]),)))
        assert _rel_err(got[c], jop(jnp.asarray(V[c]))) < 1e-5
        alone = ours.get_hessian_matvec_operator(*(
            (torch.from_numpy(B[c]).float(), float(prec[c]))
            if family == 'linear'
            else (torch.from_numpy(B[c]).float(),)))(
            torch.from_numpy(V[c]).float())
        assert torch.equal(got[c], alone)


@pytest.mark.parametrize('family', ['linear', 'logit', 'cox'])
def test_precond_hessian_matvec_matches_jax(family):
    """The HMC curvature operator, float64, and its cast back to a
    float32 operand's dtype (reg_coef.py:202-208)."""
    import jax.numpy as jnp
    from bayesbridge_tpu.ops import reg_coef as jax_reg_coef
    ours, theirs = _pair(family, 'hybrid')
    p = ours.n_pred
    rng = np.random.default_rng(4)
    coef = rng.standard_normal(p) * 0.3
    scale = rng.uniform(0.2, 2.0, p)
    prior_prec = rng.uniform(0.5, 1.5, p)
    v = rng.standard_normal(p)
    obs_prec = 1.3 if family == 'linear' else None
    mv = reg_coef.make_precond_hessian_matvec(
        ours, torch.from_numpy(coef), torch.from_numpy(scale),
        torch.from_numpy(prior_prec), obs_prec)
    jmv = jax_reg_coef.make_precond_hessian_matvec(
        theirs, jnp.asarray(coef), jnp.asarray(scale),
        jnp.asarray(prior_prec), obs_prec)
    np.testing.assert_allclose(mv(torch.from_numpy(v)).numpy(),
                               np.asarray(jmv(jnp.asarray(v))),
                               rtol=1e-10, atol=1e-10)
    out32 = mv(torch.from_numpy(v).float())
    assert out32.dtype == torch.float32
    # The preconditioned log density and gradient of the same model.
    f = reg_coef.make_precond_logp_and_grad(
        ours, torch.from_numpy(scale), torch.from_numpy(prior_prec),
        obs_prec)
    jf = jax_reg_coef.make_precond_logp_and_grad(
        theirs, jnp.asarray(scale), jnp.asarray(prior_prec), obs_prec)
    q = coef / scale
    lp, grad = f(torch.from_numpy(q))
    jlp, jgrad = jf(jnp.asarray(q))
    np.testing.assert_allclose(float(lp), float(jlp), rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize('trust', [False, True])
@pytest.mark.parametrize('family', ['linear', 'logit', 'cox'])
def test_newton_search_mode_matches_jax(family, trust):
    from bayesbridge_tpu.ops import reg_coef as jax_reg_coef
    ours, theirs = _pair(family, 'hybrid')
    p = ours.n_pred
    n_unshrunk = 0 if family == 'cox' else 1
    prior_sd = np.full(n_unshrunk, 2.0)
    lscale = np.random.default_rng(5).uniform(0.5, 2.0, p - n_unshrunk)
    obs_prec = 1.1 if family == 'linear' else None
    kw = dict(use_newton_method=True, require_trust_region=trust)
    coef, info = reg_coef.search_mode(
        np.zeros(p), lscale, 0.3, obs_prec, ours, prior_sd, 2.0, **kw)
    jcoef, jinfo = jax_reg_coef.search_mode(
        np.zeros(p), lscale, 0.3, obs_prec, theirs, prior_sd, 2.0, **kw)
    assert info['method'] == jinfo['method'] \
        == ('trust-ncg' if trust else 'Newton-CG')
    assert info['n_hess_eval'] > 0
    np.testing.assert_allclose(coef, jcoef, rtol=1e-6,
                               atol=1e-6 * np.abs(jcoef).max())
    # L-BFGS-B (the chain's default search) lands on the same mode, to
    # the two methods' stopping rules (15 Newton steps at most).
    lbfgs, l_info = reg_coef.search_mode(
        np.zeros(p), lscale, 0.3, obs_prec, ours, prior_sd, 2.0)
    assert l_info['method'] == 'L-BFGS-B' and l_info['n_hess_eval'] == 0
    np.testing.assert_allclose(lbfgs, coef, atol=1e-3 * np.abs(coef).max())
