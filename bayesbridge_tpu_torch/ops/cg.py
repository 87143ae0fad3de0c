"""Prior-preconditioned conjugate-gradient Gaussian sampler.

Port of ``bayesbridge_tpu/ops/cg.py`` (Nishimura & Suchard 2022;
reference: bayesbridge/reg_coef_sampler/cg_sampler.py:20-150): one draw
from N(Sigma z, Sigma), Sigma^{-1} = Phi = X' diag(obs_prec) X +
diag(prior_prec_sqrt)^2, by CG-solving Phi beta = b with

    b = z + X'(sqrt(obs_prec) eps_1) + prior_prec_sqrt * eps_2,

preconditioned by `precond_scale`. Each iteration applies the operator
through ``design.quad_matvec``: one fused sweep of the stored blocks
where the hybrid design's policy fuses the CG operator, `dot` then
`Tdot` on the composed path, where the loop can also accumulate the
draw's linear predictor from the forward intermediates
(`return_lin_pred`). On the hybrid composed path the whole solve is
block-ordered (``design.cg_blockorder_ctx``), and a caller-supplied warm
start (`warm_tdot` / `lin_pred0`) saves the initial residual's operator
application.

The JAX loop is a ``lax.while_loop`` with no host round-trips. Here the
loop runs eagerly and reads the stopping test ``rs > atol^2`` on the
host once per iteration; the rule, including the float32 floor on the
tolerance, is the reference's, so ``n_cg_iter`` matches it on the same
inputs.
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
                       perturbation=None, warm_tdot=None, lin_pred0=None,
                       return_lin_pred=False):
    """One CG-sampled draw. Returns (coef, info), or (coef, lin_pred,
    info) with `return_lin_pred`; info = {'n_cg_iter': int,
    'cg_converged': bool}.

    `perturbation` (optional): the precomputed b-vector noise
    X'(sqrt(obs_prec) eps_1) + prior_prec_sqrt * eps_2; when omitted it
    is drawn here from `gen` (eps_1 first, then eps_2).

    `warm_tdot` (optional): ``X'(obs_prec * (X coef_cg_init))`` in the
    original column order. The design part of the operator at the warm
    start x0 = coef_cg_init / precond_scale depends on coef_cg_init alone,
    so the caller can ride it on the pre-solve read
    (``presolve_reductions`` u4); the initial residual then needs no
    operator application. With `return_lin_pred` supply `lin_pred0` =
    X coef_cg_init beside it (ops/cg.py:63-71, 149-163).

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

    # Block-ordered solve on the hybrid composed path: conjugating the
    # whole solve by the block permutation turns the operator's
    # per-iteration gather and scatter into slices (ops/cg.py:110-147).
    bo_ctx = design.cg_blockorder_ctx()
    if bo_ctx is not None:
        perm, unperm, offset_bo = bo_ctx
        b = b[perm]
        precond_scale = precond_scale[perm]
        precond_prior_prec = precond_prior_prec[perm]
        coef_cg_init = coef_cg_init[perm]
        if warm_tdot is not None:
            warm_tdot = warm_tdot[perm]

        def quad(x, return_t=False):
            return design.quad_matvec_blockorder(x, obs_prec, offset_bo,
                                                 return_t=return_t)
    else:
        def quad(x, return_t=False):
            return design.quad_matvec(x, obs_prec, return_t=return_t)

    def matvec(x):
        # Phi-tilde x = D P D x + s X' (omega X (s x)), s the
        # preconditioner scale (cg_sampler.py:104-113).
        return precond_prior_prec * x + precond_scale * \
            quad(precond_scale * x)

    def matvec_t(x):
        out, t = quad(precond_scale * x, return_t=True)
        return precond_prior_prec * x + precond_scale * out, t

    x = coef_cg_init / precond_scale
    yhat = None
    if warm_tdot is not None:
        if return_lin_pred and lin_pred0 is None:
            raise ValueError("return_lin_pred with warm_tdot requires "
                             "lin_pred0 (= X coef_cg_init)")
        # s * x0 = coef_cg_init up to one rounding, so the design part of
        # matvec(x0) is the caller-supplied reduction.
        r = b - (precond_prior_prec * x + precond_scale * warm_tdot)
        yhat = lin_pred0
    elif return_lin_pred:
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
    if bo_ctx is not None:
        coef = coef[unperm]
    info = {'n_cg_iter': n_iter, 'cg_converged': bool(rs <= thresh)}
    if return_lin_pred:
        return coef, yhat, info
    return coef, info
