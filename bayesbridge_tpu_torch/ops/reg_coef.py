"""Regression-coefficient sampler facade.

Port of ``bayesbridge_tpu/ops/reg_coef.py`` (reference:
bayesbridge/reg_coef_sampler/reg_coef_sampler.py:20-429): the collapsed
Gaussian update (Cholesky or CG, with the Jacobi or the prior
preconditioner) inside the Gibbs step; the preconditioned log density,
gradient and Hessian matvec that the HMC and NUTS update
(:mod:`.hmc_update`) and the MAP search share; and the MAP search (scipy
L-BFGS-B, Newton-CG or trust-ncg over a torch objective) for chain
initialization.
"""

import numpy as np
import scipy.optimize
import torch

from .cg import (
    choose_diag_preconditioner, choose_preconditioner,
    sample_gaussian_cg_chains,
)
from .cholesky import sample_gaussian_cholesky
from .summarizer import (
    compute_prior_shrunk_scale, estimate_coef_precond_scale_sd,
    extrapolate_coef_condmean, summarizer_update,
)
from ..utils.chains import rsum, take
from ..utils.profiling import annotate


def sample_gaussian_posterior(
        gens, design, y_gauss, obs_prec, gscale, lscale,
        prior_sd_for_unshrunk, slab_size, summ_state, method='cg',
        cg_maxiter=500, cg_precond_by='diag', cg_atol_multiplier=1.0,
        cg_atol=None):
    """One draw of coef | obs_prec, gscale, lscale (reg_coef.py:25-133)
    for each of k chains: `gens` one generator per chain, y_gauss and
    obs_prec (k, n), gscale (k,), lscale (k, p_shrunk), `summ_state` the
    chains' summarizer states (leading chain axis). Returns (coef (k, p),
    summ_state, info), coef in y_gauss's dtype (the chain's; the
    products compute in the design's), info's 'n_cg_iter' and
    'cg_converged' (k,) numpy arrays on the CG path (device tensors
    where a step graph's capture solves). `prior_sd_for_unshrunk` a host
    array or a tensor on the chain's device; `cg_atol` the CG tolerance,
    by default cg_atol_multiplier * 1e-5 * sqrt(p) (the step computes it
    once a run, ``GibbsStepConfig.cg_atol``).

    'cholesky': the direct draw from the design's Fisher information,
    chain by chain (each chain has its own weights).

    'cg', Jacobi ('diag') preconditioner, hybrid or dense designs with a
    one-read pre-solve: the pre-solve is one `presolve_reductions` call.
    Where the CG operator composes (the default policy), the CG loop
    accumulates the draw's linear predictor, returned as
    ``info['lin_pred']`` (reg_coef.py:79-80, 125-127); where the
    pre-solve composes too, the warm start's residual reduction
    X'(obs_prec * X coef_init) rides the pre-solve read as a fifth
    reduction, after one `dot` for X coef_init (reg_coef.py:90-96).
    Other designs, and the prior preconditioner: the pre-solve
    reductions are separate `Tdot`s, and the Fisher diagonal or the
    summarizer's sd estimate gives the preconditioner
    (reg_coef.py:103-115). The design reads X once for all chains per
    product where its kernels serve chains together (the hybrid
    backend's composed path), else once per chain.
    """
    n_unshrunk = len(prior_sd_for_unshrunk)
    dtype, dev = y_gauss.dtype, y_gauss.device
    k = y_gauss.shape[0]
    prior_shrunk_scale = compute_prior_shrunk_scale(gscale, lscale,
                                                    slab_size)
    prior_sd = torch.cat((torch.as_tensor(
        prior_sd_for_unshrunk, dtype=dtype, device=dev).expand(
            k, n_unshrunk), prior_shrunk_scale), -1)
    prior_prec_sqrt = 1.0 / prior_sd
    if method == 'cholesky':
        v = design.Tdot(obs_prec * y_gauss)
        coef = torch.stack([
            sample_gaussian_cholesky(g, design, w, pps, z) for g, w, pps, z
            in zip(gens, obs_prec, prior_prec_sqrt, v)])
        return coef.to(dtype), summ_state, {}
    if method != 'cg':
        raise NotImplementedError(method)
    coef_init = extrapolate_coef_condmean(summ_state, gscale, lscale,
                                          n_unshrunk, slab_size)
    n_obs, n_pred = design.shape
    if cg_atol is None:
        cg_atol = cg_atol_multiplier * 1e-5 * np.sqrt(n_pred)
    want_lin_pred = design.fused_ne_mode('quad') is None

    # The b-vector noise is drawn here, each chain's eps_obs then its
    # eps_prior, in the design's dtype on both branches, so that the
    # pre-solve reductions can share one call.
    def draw_eps():
        eps = [(torch.randn(n_obs, generator=g, dtype=design.dtype,
                            device=dev),
                torch.randn(n_pred, generator=g, dtype=design.dtype,
                            device=dev)) for g in gens]
        return (torch.stack([e for e, _ in eps]),
                torch.stack([e for _, e in eps]))

    with annotate('gibbs:cg_presolve'):
        lin_pred0 = warm_tdot = None
        if cg_precond_by == 'diag' and design.has_presolve_reductions():
            eps_obs, eps_prior = draw_eps()
            if design.fused_ne_mode('presolve') is None:
                # Fold the warm start into the pre-solve.
                lin_pred0 = design.dot(coef_init)
                v, pert, fisher_diag, warm_tdot = \
                    design.presolve_reductions(
                        obs_prec * y_gauss, torch.sqrt(obs_prec) * eps_obs,
                        obs_prec, obs_prec * lin_pred0)
            else:
                v, pert, fisher_diag = design.presolve_reductions(
                    obs_prec * y_gauss, torch.sqrt(obs_prec) * eps_obs,
                    obs_prec)
            precond_scale = 1.0 / torch.sqrt(prior_prec_sqrt ** 2
                                             + fisher_diag)
        else:
            v = design.Tdot(obs_prec * y_gauss)
            eps_obs, eps_prior = draw_eps()
            pert = design.Tdot(torch.sqrt(obs_prec) * eps_obs)
            if cg_precond_by == 'diag':
                precond_scale = choose_diag_preconditioner(design, obs_prec,
                                                           prior_prec_sqrt)
            else:
                precond_scale = choose_preconditioner(
                    prior_prec_sqrt, n_unshrunk,
                    estimate_coef_precond_scale_sd(summ_state))
    with annotate('gibbs:cg_solve'):
        res = sample_gaussian_cg_chains(
            gens, design, obs_prec, prior_prec_sqrt, v,
            coef_cg_init=coef_init, precond_scale=precond_scale,
            maxiter=cg_maxiter, atol=cg_atol,
            perturbation=pert + prior_prec_sqrt * eps_prior,
            warm_tdot=warm_tdot, lin_pred0=lin_pred0,
            return_lin_pred=want_lin_pred)
    if want_lin_pred:
        coef, lin_pred, info = res
        info = {**info, 'lin_pred': lin_pred}
    else:
        coef, info = res
    coef = coef.to(dtype)  # the design's dtype -> the chain's
    summ_state = summarizer_update(summ_state, coef, gscale, lscale,
                                   n_unshrunk, slab_size)
    return coef, summ_state, info


def compute_preconditioning_scale(gscale, lscale, coef_precond_post_sd,
                                  prior_sd_for_unshrunk, slab_size,
                                  unshrunk_target_sd_scale=1.0):
    """Per-coordinate change of variables: shrunk coordinates by their
    conditional prior scale, unshrunk ones by a posterior-sd estimate
    (reg_coef_sampler.py:174-192), for one chain or k chains' rows
    (gscale (k,), lscale and the sd (k, ...)). Returns (precond_scale,
    precond_prior_prec)."""
    n_unshrunk = len(prior_sd_for_unshrunk)
    shrunk_scale = compute_prior_shrunk_scale(gscale, lscale, slab_size)
    ones = torch.ones_like(lscale)
    if n_unshrunk == 0:
        return shrunk_scale, ones
    unshrunk_scale = unshrunk_target_sd_scale \
        * coef_precond_post_sd[..., :n_unshrunk]
    prior_sd = torch.as_tensor(prior_sd_for_unshrunk, dtype=lscale.dtype,
                               device=lscale.device)
    ratio = prior_sd / unshrunk_scale
    return (torch.cat((unshrunk_scale, shrunk_scale), -1),
            torch.cat((1.0 / (ratio * ratio), ones), -1))


def make_precond_logp_and_grad(model, precond_scale, precond_prior_prec,
                               obs_prec=None):
    """The log conditional posterior (up to a constant) and its gradient
    in the preconditioned parametrization (reg_coef_sampler.py:259-279;
    reg_coef.py:167-189): f(coef_precond, loglik_only=False, rows=None)
    for one vector, or for the (m, p) rows of the chains `rows` (a
    LongTensor into the chains of precond_scale (k, p); None: all). The
    model computes in the design's dtype; logp and the gradient come back
    in coef_precond's (the chain's)."""
    def f(q, loglik_only=False, rows=None):
        scale = take(precond_scale, rows)
        prior_prec = take(precond_prior_prec, rows)
        coef = q * scale
        if model.name == 'linear':
            logp, grad_coef = model.compute_loglik_and_gradient(
                coef, take(obs_prec, rows), loglik_only=loglik_only)
        else:
            logp, grad_coef = model.compute_loglik_and_gradient(
                coef, loglik_only=loglik_only)
        logp = (logp - 0.5 * rsum(prior_prec * (q * q))).to(q.dtype)
        if loglik_only:
            return logp, None
        grad = scale * grad_coef - prior_prec * q
        return logp, grad.to(q.dtype)
    return f


def make_precond_hessian_matvec(model, coef_location, precond_scale,
                                precond_prior_prec, obs_prec=None):
    """The negative Hessian's matvec of the preconditioned log posterior
    (reg_coef_sampler.py:242-257; reg_coef.py:192-208): matvec(v,
    rows=None) as for :func:`make_precond_logp_and_grad`, cast back to
    v's dtype (the model's Hessian computes in the design's)."""
    if model.name == 'linear':
        loglik_hess = model.get_hessian_matvec_operator(coef_location,
                                                        obs_prec)
    else:
        loglik_hess = model.get_hessian_matvec_operator(coef_location)

    def matvec(v, rows=None):
        scale = take(precond_scale, rows)
        return (take(precond_prior_prec, rows) * v
                - scale * loglik_hess(scale * v, rows)).to(v.dtype)
    return matvec


def search_mode(coef, lscale, gscale, obs_prec, model,
                prior_sd_for_unshrunk, slab_size, optim_maxiter=None,
                use_newton_method=False, require_trust_region=False):
    """Conditional MAP of coef | scales by scipy L-BFGS-B, or Newton-CG /
    trust-ncg with the Hessian's matvec (reg_coef.py:216-273;
    reg_coef_sampler.py:281-391), over a torch objective in the design's
    dtype; the linear model's at the given observation precision. Each
    objective evaluation is one fused GLM sweep (loglik and gradient
    together) where the design's policy fuses it, `dot` then `Tdot`
    elsewhere, counted as two design matvecs as in the reference."""
    dev, dtype = model.design.device, model.design.dtype
    lscale = torch.as_tensor(np.asarray(lscale, np.float64), dtype=dtype,
                             device=dev)
    precond_scale, precond_prior_prec = compute_preconditioning_scale(
        float(gscale), lscale,
        torch.ones(len(coef), dtype=dtype, device=dev),
        prior_sd_for_unshrunk, slab_size)
    if model.name != 'linear':
        obs_prec = None
    f = make_precond_logp_and_grad(model, precond_scale, precond_prior_prec,
                                   obs_prec)
    n_eval = [0]

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def objective(x):
        n_eval[0] += 1
        logp, grad = f(tensor(x))
        return -float(logp), -grad.double().cpu().numpy()

    hessp = None
    if use_newton_method:
        def hessp(x, v):
            matvec = make_precond_hessian_matvec(
                model, precond_scale * tensor(x), precond_scale,
                precond_prior_prec, obs_prec)
            return matvec(tensor(v)).double().cpu().numpy()

    method, options = _choose_optim_method_and_options(
        optim_maxiter, use_newton_method, require_trust_region, len(coef))
    x0 = np.asarray(coef, np.float64) \
        / precond_scale.double().cpu().numpy()
    result = scipy.optimize.minimize(objective, x0, method=method,
                                     jac=True, hessp=hessp, options=options)
    coef = precond_scale.double().cpu().numpy() * result.x
    info = {
        'is_success': bool(result.success),
        'method': method,
        'n_iter': int(result.nit),
        'n_logp_eval': int(result.nfev),
        'n_grad_eval': int(result.nfev),
        'n_hess_eval': int(result.get('nhev', 0)),
        'n_design_matvec': 2 * n_eval[0],
    }
    return coef, info


def _choose_optim_method_and_options(optim_maxiter, use_newton_method,
                                     require_trust_region, n_param):
    """The reference's heuristics (reg_coef_sampler.py:360-391)."""
    if optim_maxiter is None:
        optim_maxiter = 15 if use_newton_method else 250
    options = {'maxiter': optim_maxiter}
    tol = 1e-6 / np.sqrt(n_param)  # in analogy with the CG tolerance
    if not use_newton_method:
        method = 'L-BFGS-B'
        options.update({'gtol': tol, 'maxcor': 200})
    elif require_trust_region:
        method = 'trust-ncg'
        init_radius = 1.96 * np.sqrt(n_param)
        options.update({
            'gtol': tol,
            'initial_trust_radius': init_radius,
            'max_trust_radius': 4.0 * init_radius,
        })
    else:
        method = 'Newton-CG'
        options['xtol'] = tol
    return method, options
