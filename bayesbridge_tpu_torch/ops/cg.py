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

:func:`sample_gaussian_cg_chains` solves for k Markov chains at once (the
JAX loop under ``vmap``): each chain has its own step sizes, residual,
threshold and iteration count, one host read per iteration says which
chains still run, and a chain that has converged is compacted out of
the batch (its state frozen, as ``vmap`` of a while loop masks it) so
that the operator reads X only for the running chains. The sums over a
chain's vector run per chain (:mod:`..utils.chains`), so chain c takes
the iterations and the values it takes alone.
"""

import numpy as np
import torch

from ..utils.chains import rdot, rnorm


def choose_preconditioner(prior_prec_sqrt, n_unshrunk, coef_scaled_sd,
                          target_sd_scale=2.0):
    """The prior preconditioner (cg_sampler.py:123-138): shrunk
    coordinates scaled by their prior sd, unshrunk ones by an inflated
    estimate of their posterior sd (erring toward larger precision)."""
    shrunk_scale = 1.0 / prior_prec_sqrt
    if n_unshrunk == 0:
        return shrunk_scale
    return torch.cat((target_sd_scale * coef_scaled_sd[..., :n_unshrunk],
                      shrunk_scale[..., n_unshrunk:]), -1)


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
    def row(x):
        return None if x is None else x[None]

    res = sample_gaussian_cg_chains(
        [gen], design, obs_prec[None], prior_prec_sqrt[None], z[None],
        coef_cg_init[None], precond_scale[None], maxiter, atol,
        row(perturbation), row(warm_tdot), row(lin_pred0), return_lin_pred)
    info = {'n_cg_iter': int(res[-1]['n_cg_iter'][0]),
            'cg_converged': bool(res[-1]['cg_converged'][0])}
    return tuple(r[0] for r in res[:-1]) + (info,)


def sample_gaussian_cg_chains(gens, design, obs_prec, prior_prec_sqrt, z,
                              coef_cg_init, precond_scale, maxiter=500,
                              atol=1e-6, perturbation=None, warm_tdot=None,
                              lin_pred0=None, return_lin_pred=False):
    """:func:`sample_gaussian_cg` for k chains: every vector argument
    carries a leading chain axis ((k, n) or (k, p)), `gens` is one
    generator per chain (read only without `perturbation`). Returns
    (coef (k, p)[, lin_pred (k, n)], info) with info['n_cg_iter'] (k,)
    ints and info['cg_converged'] (k,) bools, numpy arrays."""
    dtype = z.dtype
    k = z.shape[0]
    n_obs, n_pred = design.shape
    if perturbation is None:
        eps_obs, eps_prior = [], []
        for g in gens:
            eps_obs.append(torch.randn(n_obs, generator=g, dtype=dtype,
                                       device=z.device))
            eps_prior.append(torch.randn(n_pred, generator=g, dtype=dtype,
                                         device=z.device))
        perturbation = design.Tdot(torch.sqrt(obs_prec)
                                   * torch.stack(eps_obs)) \
            + prior_prec_sqrt * torch.stack(eps_prior)
    b = precond_scale * (z + perturbation)
    precond_prior_prec = (precond_scale * prior_prec_sqrt) ** 2

    # Block-ordered solve on the hybrid composed path: conjugating the
    # whole solve by the block permutation turns the operator's
    # per-iteration gather and scatter into slices (ops/cg.py:110-147).
    bo_ctx = design.cg_blockorder_ctx()
    if bo_ctx is not None:
        perm, unperm, offset_bo = bo_ctx
        b = b[:, perm]
        precond_scale = precond_scale[:, perm]
        precond_prior_prec = precond_prior_prec[:, perm]
        coef_cg_init = coef_cg_init[:, perm]
        if warm_tdot is not None:
            warm_tdot = warm_tdot[:, perm]

        def quad(x, w, return_t=False):
            return design.quad_matvec_blockorder(x, w, offset_bo,
                                                 return_t=return_t)
    else:
        def quad(x, w, return_t=False):
            return design.quad_matvec(x, w, return_t=return_t)

    def matvec_t(x, rows):
        # Phi-tilde x = D P D x + s X' (omega X (s x)), s the
        # preconditioner scale (cg_sampler.py:104-113), for the chains
        # `rows` (None: all), with X (s x) when the loop keeps the linear
        # predictor.
        s, w, d = precond_scale, obs_prec, precond_prior_prec
        if rows is not None:
            s, w, d = s[rows], w[rows], d[rows]
        if return_lin_pred:
            out, t = quad(s * x, w, return_t=True)
        else:
            out, t = quad(s * x, w), None
        return d * x + s * out, t

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
    else:
        Ax, yhat = matvec_t(x, None)
        r = b - Ax
    # Stop when ||r|| <= atol (scipy's cg with tol = atol/||b||,
    # cg_sampler.py:74-80); in float32 the achievable residual is
    # floored at ~50 eps ||b||, so the threshold rises to meet it.
    atol = torch.maximum(
        torch.tensor(atol, dtype=dtype, device=z.device),
        50.0 * torch.finfo(dtype).eps * rnorm(b))
    thresh = atol ** 2
    p = r
    rs = rdot(r, r)
    n_iter = np.zeros(k, dtype=np.int64)
    running = (rs > thresh).cpu().numpy()
    while True:
        act = np.flatnonzero(running & (n_iter < maxiter))
        if act.size == 0:
            break
        # The running chains, compacted; all of them index nothing.
        rows = None if act.size == k else torch.as_tensor(act,
                                                          device=z.device)

        def sub(t):
            return t if rows is None else t[rows]

        p_a, rs_a = sub(p), sub(rs)
        Ap, t_p = matvec_t(p_a, rows)
        alpha = rs_a / rdot(p_a, Ap)
        x_a = sub(x) + alpha[:, None] * p_a
        r_a = sub(r) - alpha[:, None] * Ap
        rs_new = rdot(r_a, r_a)
        p_new = r_a + (rs_new / rs_a)[:, None] * p_a
        if return_lin_pred:
            y_a = sub(yhat) + alpha[:, None] * t_p
        if rows is None:
            x, r, p, rs = x_a, r_a, p_new, rs_new
            if return_lin_pred:
                yhat = y_a
        else:
            x, r, p, rs = (t.index_copy(0, rows, a) for t, a in
                           ((x, x_a), (r, r_a), (p, p_new), (rs, rs_new)))
            if return_lin_pred:
                yhat = yhat.index_copy(0, rows, y_a)
        n_iter[act] += 1
        running[act] = (rs_new > sub(thresh)).cpu().numpy()
    coef = precond_scale * x
    if bo_ctx is not None:
        coef = coef[:, unperm]
    info = {'n_cg_iter': n_iter, 'cg_converged': ~running}
    if return_lin_pred:
        return coef, yhat, info
    return coef, info
