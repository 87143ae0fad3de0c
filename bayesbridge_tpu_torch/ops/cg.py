"""Prior-preconditioned conjugate-gradient Gaussian sampler.

Port of ``bayesbridge_tpu/ops/cg.py`` (Nishimura & Suchard 2022;
reference: bayesbridge/reg_coef_sampler/cg_sampler.py:20-150): one draw
from N(Sigma z, Sigma), Sigma^{-1} = Phi = X' diag(obs_prec) X +
diag(prior_prec_sqrt)^2, by CG-solving Phi beta = b with

    b = z + X'(sqrt(obs_prec) eps_1) + prior_prec_sqrt * eps_2,

preconditioned by `precond_scale`. Each iteration applies the operator
through ``design.quad_matvec``: one fused sweep of the stored blocks on
the hybrid backend, `dot` then `Tdot` on the composed path, where the
loop can also accumulate the draw's linear predictor from the forward
intermediates (`return_lin_pred`).

The JAX loop is a ``lax.while_loop`` with no host round-trips. Here the
loop runs eagerly and reads the stopping test ``rs > atol^2`` on the
host once per iteration; the rule, including the float32 floor on the
tolerance, is the reference's, so ``n_cg_iter`` matches it on the same
inputs. The block-ordered solve and the caller-supplied warm start
(`warm_tdot` / `lin_pred0`) of the JAX package serve its hybrid composed
path and come with it (ROADMAP Queue 1 item 11).
"""

import torch


def choose_diag_preconditioner(design, obs_prec, prior_prec_sqrt):
    """Jacobi preconditioner from the full conditional-precision
    diagonal (cg_sampler.py:140-143): 1/sqrt(prior_prec^2 + diag(X'WX))."""
    diag = prior_prec_sqrt ** 2 \
        + design.compute_fisher_info(obs_prec, diag_only=True)
    return 1.0 / torch.sqrt(diag)


def sample_gaussian_cg(gen, design, obs_prec, prior_prec_sqrt, z,
                       coef_cg_init, precond_scale, maxiter=500, atol=1e-6,
                       perturbation=None, return_lin_pred=False):
    """One CG-sampled draw. Returns (coef, info), or (coef, lin_pred,
    info) with `return_lin_pred`; info = {'n_cg_iter': int,
    'cg_converged': bool}.

    `perturbation` (optional): the precomputed b-vector noise
    X'(sqrt(obs_prec) eps_1) + prior_prec_sqrt * eps_2; when omitted it
    is drawn here from `gen` (eps_1 first, then eps_2).

    `return_lin_pred`: also return the draw's linear predictor X coef,
    accumulated from the operator's forward intermediates
    (lin_pred = X x0 + sum_k alpha_k X(s p_k)), exact in exact
    arithmetic, so the Gibbs step needs no separate design pass.
    """
    dtype = z.dtype
    n_obs, n_pred = design.shape
    if perturbation is None:
        eps_obs = torch.randn(n_obs, generator=gen, dtype=dtype,
                              device=z.device)
        eps_prior = torch.randn(n_pred, generator=gen, dtype=dtype,
                                device=z.device)
        perturbation = design.Tdot(torch.sqrt(obs_prec) * eps_obs) \
            + prior_prec_sqrt * eps_prior
    b = precond_scale * (z + perturbation)
    precond_prior_prec = (precond_scale * prior_prec_sqrt) ** 2

    def matvec(x):
        # Phi-tilde x = D P D x + s X' (omega X (s x)), s the
        # preconditioner scale (cg_sampler.py:104-113).
        return precond_prior_prec * x + precond_scale * \
            design.quad_matvec(precond_scale * x, obs_prec)

    def matvec_t(x):
        out, t = design.quad_matvec(precond_scale * x, obs_prec,
                                    return_t=True)
        return precond_prior_prec * x + precond_scale * out, t

    x = coef_cg_init / precond_scale
    if return_lin_pred:
        Ax, yhat = matvec_t(x)
        r = b - Ax
    else:
        r = b - matvec(x)
    # Stop when ||r|| <= atol (scipy's cg with tol = atol/||b||,
    # cg_sampler.py:74-80); in float32 the achievable residual is
    # floored at ~50 eps ||b||, so the threshold rises to meet it.
    atol = torch.maximum(
        torch.tensor(atol, dtype=dtype, device=z.device),
        50.0 * torch.finfo(dtype).eps * torch.linalg.vector_norm(b))
    thresh = atol ** 2
    p = r
    rs = torch.dot(r, r)
    n_iter = 0
    while n_iter < maxiter and bool(rs > thresh):
        if return_lin_pred:
            Ap, t_p = matvec_t(p)
        else:
            Ap = matvec(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        if return_lin_pred:
            yhat = yhat + alpha * t_p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        n_iter += 1
    coef = precond_scale * x
    info = {'n_cg_iter': n_iter, 'cg_converged': bool(rs <= thresh)}
    if return_lin_pred:
        return coef, yhat, info
    return coef, info
