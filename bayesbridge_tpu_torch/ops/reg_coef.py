"""Regression-coefficient sampler facade.

Port of ``bayesbridge_tpu/ops/reg_coef.py`` (reference:
bayesbridge/reg_coef_sampler/reg_coef_sampler.py:20-429): the collapsed
Gaussian update by CG inside the Gibbs step, and the MAP search (scipy
L-BFGS-B over a torch objective) for chain initialization.
The Cholesky, HMC and NUTS samplers are not ported.
"""

import numpy as np
import scipy.optimize
import torch

from .cg import choose_diag_preconditioner, sample_gaussian_cg
from .summarizer import (
    compute_prior_shrunk_scale, extrapolate_coef_condmean,
    summarizer_update,
)


def sample_gaussian_posterior(
        gen, design, y_gauss, obs_prec, gscale, lscale,
        prior_sd_for_unshrunk, slab_size, summ_state, cg_maxiter=500,
        cg_atol_multiplier=1.0):
    """One draw of coef | obs_prec, gscale, lscale by CG with the Jacobi
    ('diag') preconditioner (reg_coef.py:25-133, the 'cg' branch).
    Returns (coef, summ_state, info).

    Hybrid designs (fused sweeps): the pre-solve is one `tdots` sweep
    and every operator application, the initial residual's included, one
    `ne` sweep. Designs on the composed path (bitpack, winell): the
    pre-solve reductions are separate `Tdot`s and the Fisher diagonal
    (reg_coef.py:103-115), and the CG loop accumulates the draw's linear
    predictor, returned as ``info['lin_pred']`` (reg_coef.py:79-80,
    125-127). The warm start's fold into a batched pre-solve
    (reg_coef.py:90-96) needs the hybrid composed path, not ported.
    """
    n_unshrunk = len(prior_sd_for_unshrunk)
    dev = y_gauss.device
    prior_shrunk_scale = compute_prior_shrunk_scale(gscale, lscale,
                                                    slab_size)
    prior_sd = torch.cat((torch.as_tensor(prior_sd_for_unshrunk,
                                          dtype=torch.float32, device=dev),
                          prior_shrunk_scale))
    prior_prec_sqrt = 1.0 / prior_sd
    coef_init = extrapolate_coef_condmean(summ_state, gscale, lscale,
                                          n_unshrunk, slab_size)
    n_obs, n_pred = design.shape
    want_lin_pred = design.fused_ne_mode('quad') is None

    # The b-vector noise is drawn here, eps_obs then eps_prior, on both
    # branches, so that the pre-solve reductions can share one call.
    def draw_eps():
        return (torch.randn(n_obs, generator=gen, dtype=torch.float32,
                            device=dev),
                torch.randn(n_pred, generator=gen, dtype=torch.float32,
                            device=dev))

    if design.has_presolve_reductions():
        eps_obs, eps_prior = draw_eps()
        v, pert, fisher_diag = design.presolve_reductions(
            obs_prec * y_gauss, torch.sqrt(obs_prec) * eps_obs, obs_prec)
        precond_scale = 1.0 / torch.sqrt(prior_prec_sqrt ** 2 + fisher_diag)
    else:
        v = design.Tdot(obs_prec * y_gauss)
        eps_obs, eps_prior = draw_eps()
        pert = design.Tdot(torch.sqrt(obs_prec) * eps_obs)
        precond_scale = choose_diag_preconditioner(design, obs_prec,
                                                   prior_prec_sqrt)
    res = sample_gaussian_cg(
        gen, design, obs_prec, prior_prec_sqrt, v,
        coef_cg_init=coef_init, precond_scale=precond_scale,
        maxiter=cg_maxiter,
        atol=cg_atol_multiplier * 1e-5 * np.sqrt(n_pred),
        perturbation=pert + prior_prec_sqrt * eps_prior,
        return_lin_pred=want_lin_pred)
    if want_lin_pred:
        coef, lin_pred, info = res
        info = {**info, 'lin_pred': lin_pred}
    else:
        coef, info = res
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
    dev = lscale.device
    shrunk_scale = compute_prior_shrunk_scale(gscale, lscale, slab_size)
    ones = torch.ones(len(lscale), dtype=torch.float32, device=dev)
    if n_unshrunk == 0:
        return shrunk_scale, ones
    unshrunk_scale = coef_precond_post_sd[:n_unshrunk]
    prior_sd = torch.as_tensor(prior_sd_for_unshrunk, dtype=torch.float32,
                               device=dev)
    return (torch.cat((unshrunk_scale, shrunk_scale)),
            torch.cat(((prior_sd / unshrunk_scale) ** -2, ones)))


def search_mode(coef, lscale, gscale, obs_prec, model,
                prior_sd_for_unshrunk, slab_size, optim_maxiter=250):
    """Conditional MAP of coef | scales by scipy L-BFGS-B over a torch
    objective (reg_coef.py:216-273; reg_coef_sampler.py:281-391). Each
    objective evaluation is one fused GLM sweep (loglik and gradient
    together) on the hybrid backend, `dot` then `Tdot` elsewhere, counted
    as two design matvecs as in the reference."""
    dev = model.design.device
    lscale = torch.as_tensor(np.asarray(lscale, np.float64),
                             dtype=torch.float32, device=dev)
    precond_scale, precond_prior_prec = compute_preconditioning_scale(
        float(gscale), lscale,
        torch.ones(len(coef), dtype=torch.float32, device=dev),
        prior_sd_for_unshrunk, slab_size)
    n_eval = [0]

    def objective(x):
        n_eval[0] += 1
        x_t = torch.as_tensor(x, dtype=torch.float32, device=dev)
        logp, grad_coef = model.compute_loglik_and_gradient(
            x_t * precond_scale)
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
