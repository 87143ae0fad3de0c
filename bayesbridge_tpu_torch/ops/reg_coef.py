"""Regression-coefficient sampler facade.

Port of ``bayesbridge_tpu/ops/reg_coef.py`` (reference:
bayesbridge/reg_coef_sampler/reg_coef_sampler.py:20-429): the collapsed
Gaussian update (Cholesky or CG, with the Jacobi or the prior
preconditioner) inside the Gibbs step, and the MAP search (scipy
L-BFGS-B over a torch objective) for chain initialization. The HMC and
NUTS samplers and the Newton-CG search are not ported.
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


def sample_gaussian_posterior(
        gens, design, y_gauss, obs_prec, gscale, lscale,
        prior_sd_for_unshrunk, slab_size, summ_state, method='cg',
        cg_maxiter=500, cg_precond_by='diag', cg_atol_multiplier=1.0):
    """One draw of coef | obs_prec, gscale, lscale (reg_coef.py:25-133)
    for each of k chains: `gens` one generator per chain, y_gauss and
    obs_prec (k, n), gscale (k,), lscale (k, p_shrunk), `summ_state` the
    chains' summarizer states (leading chain axis). Returns (coef (k, p),
    summ_state, info), coef in y_gauss's dtype (the chain's; the
    products compute in the design's), info's 'n_cg_iter' and
    'cg_converged' (k,) numpy arrays on the CG path.

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

    lin_pred0 = warm_tdot = None
    if cg_precond_by == 'diag' and design.has_presolve_reductions():
        eps_obs, eps_prior = draw_eps()
        if design.fused_ne_mode('presolve') is None:  # fold the warm start
            lin_pred0 = design.dot(coef_init)
            v, pert, fisher_diag, warm_tdot = design.presolve_reductions(
                obs_prec * y_gauss, torch.sqrt(obs_prec) * eps_obs,
                obs_prec, obs_prec * lin_pred0)
        else:
            v, pert, fisher_diag = design.presolve_reductions(
                obs_prec * y_gauss, torch.sqrt(obs_prec) * eps_obs,
                obs_prec)
        precond_scale = 1.0 / torch.sqrt(prior_prec_sqrt ** 2 + fisher_diag)
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
    res = sample_gaussian_cg_chains(
        gens, design, obs_prec, prior_prec_sqrt, v,
        coef_cg_init=coef_init, precond_scale=precond_scale,
        maxiter=cg_maxiter,
        atol=cg_atol_multiplier * 1e-5 * np.sqrt(n_pred),
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
                                  prior_sd_for_unshrunk, slab_size):
    """Per-coordinate change of variables for the MAP search: shrunk
    coordinates by their conditional prior scale, unshrunk ones by a
    posterior-sd estimate (reg_coef_sampler.py:174-192). Returns
    (precond_scale, precond_prior_prec)."""
    n_unshrunk = len(prior_sd_for_unshrunk)
    dtype, dev = lscale.dtype, lscale.device
    shrunk_scale = compute_prior_shrunk_scale(gscale, lscale, slab_size)
    ones = torch.ones(len(lscale), dtype=dtype, device=dev)
    if n_unshrunk == 0:
        return shrunk_scale, ones
    unshrunk_scale = coef_precond_post_sd[:n_unshrunk]
    prior_sd = torch.as_tensor(prior_sd_for_unshrunk, dtype=dtype,
                               device=dev)
    return (torch.cat((unshrunk_scale, shrunk_scale)),
            torch.cat(((prior_sd / unshrunk_scale) ** -2, ones)))


def search_mode(coef, lscale, gscale, obs_prec, model,
                prior_sd_for_unshrunk, slab_size, optim_maxiter=250):
    """Conditional MAP of coef | scales by scipy L-BFGS-B over a torch
    objective in the design's dtype (reg_coef.py:216-273;
    reg_coef_sampler.py:281-391); the linear model's objective at the
    given observation precision (reg_coef.py:167-190). Each objective
    evaluation is one fused GLM sweep (loglik and gradient together)
    where the design's policy fuses it, `dot` then `Tdot` elsewhere,
    counted as two design matvecs as in the reference."""
    dev, dtype = model.design.device, model.design.dtype
    lscale = torch.as_tensor(np.asarray(lscale, np.float64), dtype=dtype,
                             device=dev)
    precond_scale, precond_prior_prec = compute_preconditioning_scale(
        float(gscale), lscale,
        torch.ones(len(coef), dtype=dtype, device=dev),
        prior_sd_for_unshrunk, slab_size)
    n_eval = [0]
    extra = (float(obs_prec),) if model.name == 'linear' else ()

    def objective(x):
        n_eval[0] += 1
        x_t = torch.as_tensor(x, dtype=dtype, device=dev)
        logp, grad_coef = model.compute_loglik_and_gradient(
            x_t * precond_scale, *extra)
        logp = logp - 0.5 * torch.sum(precond_prior_prec * x_t ** 2)
        grad = precond_scale * grad_coef - precond_prior_prec * x_t
        return -float(logp), -grad.double().cpu().numpy()

    tol = 1e-6 / np.sqrt(len(coef))  # in analogy with the CG tolerance
    x0 = np.asarray(coef, np.float64) \
        / precond_scale.double().cpu().numpy()
    result = scipy.optimize.minimize(
        objective, x0, method='L-BFGS-B', jac=True,
        options={'maxiter': optim_maxiter, 'gtol': tol, 'maxcor': 200})
    coef = precond_scale.double().cpu().numpy() * result.x
    info = {
        'is_success': bool(result.success),
        'method': 'L-BFGS-B',
        'n_iter': int(result.nit),
        'n_logp_eval': int(result.nfev),
        'n_grad_eval': int(result.nfev),
        'n_hess_eval': 0,
        'n_design_matvec': 2 * n_eval[0],
    }
    return coef, info
