"""HMC / NUTS coefficient update inside the Gibbs step.

Port of ``bayesbridge_tpu/ops/hmc_update.py`` (reference:
bayesbridge/reg_coef_sampler/reg_coef_sampler.py:105-240), for k chains
at once:

1. precondition the coordinates by the prior scale (shrunk) and a
   posterior-sd estimate (unshrunk);
2. estimate the top curvature of the preconditioned negative Hessian to
   set the stepsize at the stability limit 2 / sqrt(lambda_max): a power
   iteration warm-started at the summarizer's principal component, with
   the reference's loose 10% tolerance (its Lanczos ``eigsh(k=1, ncv=2,
   tol=.1)``), at most 50 matvecs;
3. a jittered stepsize and (HMC) trajectory length, the HMC or NUTS
   transition, and the Robbins-Monro adaptation of the stability-limit
   multiplier.

Each chain runs its own power iteration and its own trajectory or tree;
they run side by side (``utils.chains.run_lockstep``), each answer of the
target (the Hessian's matvec, the log density and gradient) one call of
the design's chain-batched products for the chains still running, which
leave the batch as they finish. The host syncs once per matvec or
leapfrog step for all chains ("still running?"), once for the HMC step
counts, and once per NUTS doubling and transition. Every draw of chain c
comes from chain c's generator, in the amounts the chain alone draws:
the principal component's fallback direction, the stepsize jitter, (HMC)
the integration-time jitter, then the transition's own draws.

The optional clamp of outlying stability estimates mirrors the
reference's StabilityEstimateStabilizer (reg_coef_sampler.py:394-429)
over a ring buffer of the last ``_STAB_BUFFER`` estimates.
"""

import math

import numpy as np
import torch

from . import hmc as hmc_kernel
from . import nuts as nuts_kernel
from .reg_coef import (
    compute_preconditioning_scale, make_precond_hessian_matvec,
    make_precond_logp_and_grad,
)
from .stepsize import hamiltonian_adapter_init, hamiltonian_adapter_update
from .summarizer import (
    estimate_coef_precond_scale_sd, estimate_precond_hessian_pc,
    extrapolate_coef_condmean, summarizer_update,
    update_precond_hessian_pc,
)
from ..utils.chains import drive, per_chain, run_lockstep

_STAB_BUFFER = 100  # the reference's n_warmup (reg_coef_sampler.py:397)
_MAX_HMC_STEP = 512  # reg_coef_sampler.py:106
# The 0.8414 quantile of the recent estimates sits one standard deviation
# above their median (for a Gaussian).
_GAUSSIAN_CDF_AT_ONESTD = 0.8414


def init_hmc_carry(cfg, device, n_chains=None):
    """The HMC entries of a chain's carry (k chains' with `n_chains`): the
    stepsize adapter, the count of non-positive curvature estimates, and
    with ``cfg.curvature_est_stabilized`` the stabilizer's ring buffer."""
    shape = () if n_chains is None else (n_chains,)
    adapter, _ = hamiltonian_adapter_init(cfg.dtype, device,
                                          n_chains=n_chains)
    carry = {'hmc_adapter': adapter,
             'n_curvature_invalid': torch.zeros(shape, dtype=torch.int32,
                                                device=device)}
    if cfg.curvature_est_stabilized:
        carry['stab_buffer'] = torch.zeros(shape + (_STAB_BUFFER,),
                                           dtype=cfg.dtype, device=device)
        carry['stab_n'] = torch.zeros(shape, dtype=torch.int32,
                                      device=device)
    return carry


def power_iteration(v0, tol=0.1, max_iter=50):
    """The power iteration of one chain as its generator: 'eval' requests
    for the operator's product, one 'host' check per product from the
    third on. Returns (eigval, eigvec, n_matvec)."""
    v = v0 / torch.linalg.vector_norm(v0)
    eig = torch.zeros((), dtype=v0.dtype, device=v0.device)
    eig_prev = torch.full((), math.inf, dtype=v0.dtype, device=v0.device)
    n = 0
    while n < max_iter:
        if n >= 2:
            rel_change = (eig - eig_prev).abs() / torch.clamp_min(eig,
                                                                  1e-30)
            if not (yield 'host', rel_change > tol):
                break
        w = yield 'eval', v
        eig_prev, eig = eig, torch.dot(v, w)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
        n += 1
    return eig, v, n


def power_iteration_top_eigenvalue(matvec, v0, tol=0.1, max_iter=50):
    """Largest eigenvalue of a PSD operator, warm-started at v0, with the
    reference's coarse relative tolerance (reg_coef_sampler.py:228-230).
    One vector v0 (p,) and matvec(v); or k chains' rows v0 (k, p) and
    matvec(V, rows) for the (m, p) rows of the chains `rows` still
    iterating. Returns (eigval, eigvec, n_matvec), per chain for k chains
    (n_matvec a numpy array)."""
    if v0.dim() == 1:
        return drive(power_iteration(v0, tol, max_iter), matvec)
    out = run_lockstep([power_iteration(v, tol, max_iter) for v in v0],
                       matvec)
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]),
            np.array([o[2] for o in out]))


def _nanquantile(x, q, method):
    """The q-quantile of the non-NaN entries of the vector x, as
    ``jnp.nanquantile`` computes it: 'linear' low (1 - w) + high w,
    'midpoint' (low + high) / 2 (``jnp.nanmedian``)."""
    x = torch.sort(torch.where(torch.isnan(x), math.nan, x)).values
    count = (~torch.isnan(x)).sum().to(x.dtype)
    pos = q * (count - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    last = count - 1
    low_value = x[torch.maximum(torch.zeros_like(low), torch.minimum(
        low, last)).long()]
    high_value = x[torch.maximum(torch.zeros_like(high), torch.minimum(
        high, last)).long()]
    if method == 'midpoint':
        return (low_value + high_value) * 0.5
    return low_value * (1 - w_high) + high_value * w_high


def _stabilize_one(buffer, n, estimate):
    """One chain's clamp (reg_coef_sampler.py:406-429): the empirical CDF
    of the estimate over the window (its occupancy as the denominator),
    and, past a full window, estimates beyond the one-std quantile pulled
    toward it. Returns (buffer, n, result); the raw estimate enters the
    ring buffer."""
    active = torch.arange(_STAB_BUFFER, device=buffer.device) < n
    n_f = torch.clamp_min(torch.clamp_max(n, _STAB_BUFFER), 1) \
        .to(estimate.dtype)
    cdf_at_estimate = (active & (buffer < estimate)).sum() / n_f
    filled = torch.where(active, buffer, math.nan)
    median = _nanquantile(filled, 0.5, 'midpoint')
    at_onestd = _nanquantile(filled, _GAUSSIAN_CDF_AT_ONESTD, 'linear')
    dist_above = torch.clamp_max(torch.special.ndtri(torch.clamp(
        cdf_at_estimate, 1e-6, 1 - 1e-6)) - 1.0, 2.0)
    stabilized = at_onestd + (at_onestd - median) * dist_above
    use_raw = (n < _STAB_BUFFER) | (cdf_at_estimate
                                    <= _GAUSSIAN_CDF_AT_ONESTD)
    result = torch.where(use_raw, estimate, stabilized.to(estimate.dtype))
    buffer = buffer.clone()
    buffer[n % _STAB_BUFFER] = estimate
    return buffer, n + 1, result


def _stabilize_estimate(carry, estimate):
    """Clamp outlying stability estimates by the empirical quantiles of
    the recent ones (reg_coef_sampler.py:406-429), per chain for k
    chains' carry entries."""
    one = estimate.dim() == 0
    buffer, n, result = per_chain(
        _stabilize_one, *((carry['stab_buffer'], carry['stab_n'], estimate)
                          if not one else (carry['stab_buffer'][None],
                                           carry['stab_n'][None],
                                           estimate[None])))
    if one:
        buffer, n, result = buffer[0], n[0], result[0]
    return {**carry, 'stab_buffer': buffer, 'stab_n': n}, result


def _adapt(state, target, hamiltonian_error):
    """The adapter's update, chain by chain."""
    params = {'target_log10_error': target}
    parts = [hamiltonian_adapter_update(
        {key: val[c] for key, val in state.items()}, params,
        hamiltonian_error[c]) for c in range(hamiltonian_error.shape[0])]
    return {key: torch.stack([p[key] for p in parts]) for key in parts[0]}


def _uniform(gens, low, high, dtype, device):
    """One Uniform(low, high) draw per chain, each from its generator."""
    u = torch.stack([torch.rand((), generator=g, dtype=dtype,
                                device=device) for g in gens])
    return low + (high - low) * u


def sample_coef_by_hmc(cfg, model, gens, carry):
    """One HMC or NUTS coefficient transition of k chains (carry entries
    with a leading chain axis, one generator per chain); returns (coef
    (k, p), carry, info)."""
    dtype = cfg.dtype
    coef, gscale, lscale = carry['coef'], carry['gscale'], carry['lscale']
    summ = carry['summ']
    dev = coef.device
    # The linear model's coefficient conditional depends on the
    # observation precision; the logit and Cox likelihoods do not.
    obs_prec = carry['obs_prec'] if model.name == 'linear' else None

    precond_scale, precond_prior_prec = compute_preconditioning_scale(
        gscale, lscale, estimate_coef_precond_scale_sd(summ),
        cfg.prior_sd_for_unshrunk, cfg.slab_size)

    # The stability limit from the top preconditioned curvature.
    coef_guess = extrapolate_coef_condmean(summ, gscale, lscale,
                                           cfg.n_unshrunk, cfg.slab_size)
    hess_matvec = make_precond_hessian_matvec(
        model, coef_guess, precond_scale, precond_prior_prec, obs_prec)
    fallback = torch.stack([torch.randn(cfg.n_pred, generator=g,
                                        dtype=dtype, device=dev)
                            for g in gens])
    max_curvature, pc, n_hessian_matvec = power_iteration_top_eigenvalue(
        hess_matvec, estimate_precond_hessian_pc(summ, fallback))
    # The reference raises on a non-positive curvature
    # (reg_coef_sampler.py:233-239); the step clamps and counts it.
    curvature_invalid = max_curvature <= 0
    max_curvature = torch.clamp_min(max_curvature, 1e-30)
    summ = update_precond_hessian_pc(summ, pc)
    stability_limit = 2.0 / torch.sqrt(max_curvature)
    if cfg.curvature_est_stabilized:
        carry, stability_limit = _stabilize_estimate(carry,
                                                     stability_limit)
    adjustment = torch.exp(carry['hmc_adapter']['log_stepsize'])
    dt = _uniform(gens, 0.5, 1.0, dtype, dev) * adjustment * stability_limit

    q0 = coef / precond_scale
    f = make_precond_logp_and_grad(model, precond_scale, precond_prior_prec,
                                   obs_prec)
    info = {
        'stepsize': dt,
        'stability_limit_est': stability_limit,
        'stability_adjustment_factor': adjustment,
        'n_hessian_matvec': n_hessian_matvec,
        'curvature_estimate_invalid': curvature_invalid,
    }
    if cfg.coef_sampler_type == 'hmc':
        integration_time = math.pi / 2.0 * _uniform(gens, 0.8, 1.0, dtype,
                                                    dev)
        n_step = np.minimum(np.ceil(
            (integration_time / dt).cpu().numpy()).astype(np.int64),
            _MAX_HMC_STEP)
        coros = [hmc_kernel.transition(g, dt[c], int(n_step[c]), q0[c])
                 for c, g in enumerate(gens)]
    else:
        max_height = int(np.log2(_MAX_HMC_STEP))
        coros = [nuts_kernel.transition(g, dt[c], q0[c],
                                        max_height=max_height)
                 for c, g in enumerate(gens)]
    out = run_lockstep(coros, lambda Q, rows: f(Q, rows=rows))
    q = torch.stack([o[0] for o in out])

    def stacked(key):
        vals = [o[1][key] for o in out]
        if torch.is_tensor(vals[0]):
            return torch.stack(vals)
        return np.array(vals)

    if cfg.coef_sampler_type == 'hmc':
        hamiltonian_error = stacked('hamiltonian_error')
        info.update({
            'accepted': stacked('accepted'),
            'accept_prob': stacked('accept_prob'),
            'n_grad_evals': stacked('n_grad_evals'),
            'instability_detected': stacked('instability_detected'),
            'n_integrator_step': n_step,
        })
    else:
        hamiltonian_error = stacked('ave_hamiltonian_error')
        info.update({
            'ave_accept_prob': stacked('ave_accept_prob'),
            'n_grad_evals': stacked('n_grad_evals'),
            'instability_detected': stacked('instability_detected'),
            'tree_height': stacked('tree_height'),
        })

    coef_new = q * precond_scale
    summ = summarizer_update(summ, coef_new, gscale, lscale, cfg.n_unshrunk,
                             cfg.slab_size)
    adapter = _adapt(carry['hmc_adapter'], cfg.hmc_target_log10_error,
                     hamiltonian_error)
    return coef_new, {**carry, 'summ': summ, 'hmc_adapter': adapter}, info
