"""The Gibbs step and chain runner.

Port of ``bayesbridge_tpu/step.py`` (reference:
bayesbridge/bayesbridge.py:210-240). One step draws, in the reference's
order, the coefficients (the collapsed Gaussian draw by Cholesky or CG
for the linear and logit models, or an HMC / NUTS transition for any
model, the Cox model's only sampler), then the observation precision
(none for Cox), then the global scale, then the local scale. The JAX package traces the step once and
scans it on the device; here the step runs eagerly, a Python loop drives
it, and the carry is a dict of device tensors. The chain's state is in
the chain's dtype (``cfg.dtype``); the design's products compute in the
design's, and their results are cast back where they enter the carry (a
float32 chain over a float64 model stays float32).

The step runs k independent chains at once (the JAX step under
``jax.vmap``, ``multichain.py``): every carry entry has a leading chain
axis, and each chain draws from its own ``torch.Generator``, in the
order one chain alone draws, so the carry plus the generators' states is
the checkpoint and chain c of a batch is the chain run alone
(:func:`gibbs_step_chains`, :func:`run_chains`). One chain is the batch
of one: :func:`gibbs_step` and :func:`run_chain` take and return a
single chain's carry.
"""

import math

import numpy as np
import torch

from .ops import hmc_update
from .ops.reg_coef import sample_gaussian_posterior
from .ops.stepsize import target_log10_hamiltonian_error
from .ops.summarizer import summarizer_init
from .random.polya_gamma import sample_polya_gamma_chains
from .random.tilted_stable import sample_tilted_stable_chains
from .utils.chains import pow_pos, rsum
from .utils.dtypes import full_float32
from .utils.profiling import annotate

SAMPLE_KEYS = ('coef', 'local_scale', 'global_scale', 'obs_prec', 'logp')


class GibbsStepConfig:
    """Static configuration of the step."""

    def __init__(self, model, prior, options, n_unshrunk,
                 prior_sd_for_unshrunk, dtype=None):
        self.n_obs = model.n_obs
        self.dtype = model.design.dtype if dtype is None else dtype
        self.coef_sampler_type = options.coef_sampler_type
        self.curvature_est_stabilized = options.curvature_est_stabilized
        self.cg_preconditioner = options.cg_preconditioner
        self.bridge_exp = float(prior.bridge_exp)
        self.slab_size = float(prior.slab_size)
        self.gscale_prior_shape = float(
            prior.param['gscale_neg_power']['shape'])
        self.gscale_prior_rate = float(
            prior.param['gscale_neg_power']['rate'])
        self.gscale_update_method = options.gscale_update
        self.cg_atol_multiplier = float(options.cg_atol_multiplier)
        self.n_unshrunk = n_unshrunk
        self.prior_sd_for_unshrunk = np.asarray(prior_sd_for_unshrunk,
                                                dtype=np.float64)
        self.n_pred = model.n_pred
        self.n_shrunk = model.n_pred - n_unshrunk
        # Lower bound on the global scale: the value at which the prior
        # expected coefficient magnitude is 0.001 (bayesbridge.py:418-423).
        ave_magnitude = math.gamma(2 / self.bridge_exp) \
            / math.gamma(1 / self.bridge_exp)
        self.gscale_lower_bd = 0.001 / ave_magnitude
        finite_sd = self.prior_sd_for_unshrunk[
            np.isfinite(self.prior_sd_for_unshrunk)]
        self.neg_log_prior_sd_sum = -float(np.sum(np.log(finite_sd))) \
            if len(finite_sd) else 0.0
        # The HMC stepsize adapter's target (reg_coef_sampler.py:38-39).
        self.hmc_target_log10_error = target_log10_hamiltonian_error(0.95)

    @property
    def hmc(self):
        return self.coef_sampler_type in ('hmc', 'nuts')


def _gamma(gens, shape, dtype, device):
    """One Gamma(shape, 1) draw per chain, each from its generator."""
    one = torch.full((1,), float(shape), dtype=dtype, device=device)
    return torch.cat([torch._standard_gamma(one, generator=g) for g in gens])


def update_obs_precision_chains(cfg, model, gens, lin_pred):
    """obs_prec | coef (bayesbridge.py:397-410) for each chain's row of
    lin_pred (k, n): for the linear model one Gamma(n/2) draw over the
    residual rate per chain (step.py:94-103); for logit, Polya-Gamma
    draws tilted by the linear predictor; for Cox, none (k, 0)."""
    if model.name == 'cox':
        return torch.zeros((len(gens), 0), dtype=cfg.dtype,
                           device=model.design.device)
    if model.name == 'linear':
        resid = model.y - lin_pred
        rate = rsum(resid * resid) / 2.0
        draw = _gamma(gens, cfg.n_obs / 2.0, cfg.dtype, lin_pred.device)
        return (draw / rate).to(cfg.dtype)
    return sample_polya_gamma_chains(gens, model.pg_shape,
                                     lin_pred).to(cfg.dtype)


def update_obs_precision(cfg, model, gen, lin_pred):
    """:func:`update_obs_precision_chains` for one chain."""
    return update_obs_precision_chains(cfg, model, [gen], lin_pred[None])[0]


def update_global_scale(cfg, gens, gscale, coef_shrunk):
    """gscale | coef via the conjugate Gamma update on
    phi = gscale^(-bridge_exp), the MC-EM 'optimize' variant and the
    lower-bound guard (bayesbridge.py:412-456), per chain (gscale (k,),
    coef_shrunk (k, p_shrunk)). Returns (gscale, clamped)."""
    dev = coef_shrunk.device
    k = coef_shrunk.shape[0]
    no = torch.zeros(k, dtype=torch.bool, device=dev)
    if cfg.n_shrunk == 0:
        return torch.ones(k, dtype=cfg.dtype, device=dev), no
    alpha = cfg.bridge_exp
    method = cfg.gscale_update_method
    abs_power_sum = rsum(pow_pos(coef_shrunk.abs(), alpha))
    if method == 'optimize':
        phi = cfg.n_shrunk / alpha / abs_power_sum
        new_gscale = pow_pos(phi, -1.0 / alpha)
    elif method == 'sample':
        shape = cfg.gscale_prior_shape + cfg.n_shrunk / alpha
        rate = cfg.gscale_prior_rate + abs_power_sum
        draw = _gamma(gens, shape, cfg.dtype, dev)
        new_gscale = pow_pos(draw / rate, -1.0 / alpha)
        all_zero = (coef_shrunk != 0).sum(-1) == 0
        new_gscale = torch.where(all_zero, torch.zeros_like(new_gscale),
                                 new_gscale)
    elif method is None:
        return gscale, no
    else:
        raise ValueError(method)
    clamped = new_gscale < cfg.gscale_lower_bd
    return torch.clamp_min(new_gscale, cfg.gscale_lower_bd), clamped


def update_local_scale(cfg, gens, gscale, coef_shrunk):
    """lscale | gscale, coef via exponentially tilted stable draws, with
    the reference's under/overflow guards (bayesbridge.py:458-478), per
    chain. Returns (lscale, n_underflow, n_overflow), the counts (k,)."""
    dev = coef_shrunk.device
    k = coef_shrunk.shape[0]
    if cfg.bridge_exp == 2:
        zero = torch.zeros(k, dtype=torch.int32, device=dev)
        return 0.5 * torch.ones((k, cfg.n_shrunk), dtype=cfg.dtype,
                                device=dev), zero, zero
    ratio = coef_shrunk / gscale[:, None]
    ts = sample_tilted_stable_chains(gens, cfg.bridge_exp / 2.0,
                                     ratio * ratio)
    lscale = torch.sqrt(0.5 / ts)
    underflow = lscale == 0.0
    overflow = torch.isinf(lscale)
    lscale = torch.where(underflow, torch.full_like(lscale, 1e-15), lscale)
    lscale = torch.where(overflow, 2.0 / gscale[:, None], lscale)
    return lscale, underflow.sum(-1).to(torch.int32), \
        overflow.sum(-1).to(torch.int32)


def compute_posterior_logprob(cfg, model, coef, gscale, obs_prec, lin_pred):
    """Joint log density of (coef, gscale | rest) per chain, matching the
    reference's bookkeeping (bayesbridge.py:480-511); the Cox model's
    log-likelihood from its own pass (lin_pred None)."""
    if model.name == 'linear':
        loglik = model.loglik_from_lin_pred(lin_pred, obs_prec)
    elif model.name == 'logit':
        loglik = model.loglik_from_lin_pred(lin_pred)
    else:
        loglik = model.compute_loglik_and_gradient(
            coef, loglik_only=True)[0].to(cfg.dtype)
    if np.isfinite(cfg.slab_size):
        scaled = coef / cfg.slab_size
        loglik = loglik - 0.5 * rsum(scaled * scaled)
    coef_shrunk = coef[:, cfg.n_unshrunk:]
    coef_unshrunk = coef[:, :cfg.n_unshrunk]
    prior_sd = torch.as_tensor(cfg.prior_sd_for_unshrunk,
                               dtype=cfg.dtype, device=coef.device)
    prior_logp = -cfg.n_shrunk * torch.log(gscale) - rsum(pow_pos(
        (coef_shrunk / gscale[:, None]).abs(), cfg.bridge_exp))
    finite_sd = torch.isfinite(prior_sd)
    ratio = coef_unshrunk / torch.where(finite_sd, prior_sd,
                                        torch.ones_like(prior_sd))
    prior_logp = prior_logp - 0.5 * rsum(
        torch.where(finite_sd, ratio * ratio, torch.zeros_like(ratio)))
    prior_logp = prior_logp + cfg.neg_log_prior_sd_sum \
        + (cfg.gscale_prior_shape - 1.0) * torch.log(gscale) \
        - cfg.gscale_prior_rate * gscale
    return loglik + prior_logp


def _collapsed_draw(cfg, model, gens, carry):
    """coef | obs_prec, gscale, lscale by the Gaussian collapse (Cholesky
    or CG) of the linear and logit models (step.py:200-224)."""
    k = carry['coef'].shape[0]
    if model.name == 'linear':
        y_gauss = model.y.to(cfg.dtype).expand(k, -1)
        obs_prec = carry['obs_prec'][:, None] * torch.ones(
            cfg.n_obs, dtype=cfg.dtype, device=y_gauss.device)
    else:  # logit: Polya-Gamma collapse to a Gaussian observation
        obs_prec = carry['obs_prec']
        y_gauss = (model.n_success - model.n_trial / 2.0).to(
            cfg.dtype) / obs_prec
    coef, summ, info = sample_gaussian_posterior(
        gens, model.design, y_gauss, obs_prec, carry['gscale'],
        carry['lscale'], cfg.prior_sd_for_unshrunk, cfg.slab_size,
        carry['summ'], method=cfg.coef_sampler_type,
        cg_precond_by=cfg.cg_preconditioner,
        cg_atol_multiplier=cfg.cg_atol_multiplier)
    n_unconverged = carry['n_cg_unconverged'] + (
        ~info.pop('cg_converged', np.ones(k, dtype=bool))).astype(np.int64)
    return coef, {**carry, 'summ': summ,
                  'n_cg_unconverged': n_unconverged}, info


def update_regress_coef_chains(cfg, model, gens, carry):
    """coef | obs_prec, gscale, lscale (step.py:203-231) for k chains: the
    Gaussian collapse (Cholesky, CG) or an HMC / NUTS transition. Returns
    (coef, carry, info)."""
    if cfg.hmc:
        return hmc_update.sample_coef_by_hmc(cfg, model, gens, carry)
    return _collapsed_draw(cfg, model, gens, carry)


def gibbs_step_chains(cfg, model, gens, carry):
    """One Gibbs iteration of k chains (carry entries with a leading
    chain axis, gens one generator per chain): returns (carry, outputs),
    outputs with the same leading axis (the sampler's host counts, such
    as 'n_cg_iter', (k,) numpy arrays)."""
    with annotate('gibbs:step'):
        return _gibbs_step_chains(cfg, model, gens, carry)


def _gibbs_step_chains(cfg, model, gens, carry):
    # Each phase in a profiler span of its own (utils.profiling.span_stats
    # reads their host and device time).
    with annotate('gibbs:coef'):
        coef, carry, info = update_regress_coef_chains(cfg, model, gens,
                                                       carry)
    if cfg.hmc:
        # The reference raises on a non-positive curvature estimate
        # (reg_coef_sampler.py:233-239); the step counts it, and the run
        # warns at its end (step.py:252-260).
        carry['n_curvature_invalid'] = carry['n_curvature_invalid'] \
            + info.pop('curvature_estimate_invalid').to(torch.int32)
    coef = coef.to(cfg.dtype)
    # ONE linear predictor per iteration, shared by the observation
    # precision draw and the log density (step.py:261-270): on the
    # composed CG path the CG loop accumulated it, otherwise one dot;
    # none for Cox, whose log density takes its own pass.
    lin_pred = info.pop('lin_pred', None)
    if lin_pred is None and model.name != 'cox':
        with annotate('gibbs:lin_pred'):
            lin_pred = model.design.dot(coef)
    with annotate('gibbs:obs_prec'):
        obs_prec = update_obs_precision_chains(cfg, model, gens, lin_pred)
    with annotate('gibbs:scales'):
        gscale, clamped = update_global_scale(cfg, gens, carry['gscale'],
                                              coef[:, cfg.n_unshrunk:])
        lscale, n_under, n_over = update_local_scale(
            cfg, gens, gscale, coef[:, cfg.n_unshrunk:])
    with annotate('gibbs:logp'):
        logp = compute_posterior_logprob(cfg, model, coef, gscale, obs_prec,
                                         lin_pred)
    carry = {
        **carry,
        'coef': coef, 'obs_prec': obs_prec,
        'gscale': gscale, 'lscale': lscale,
        'n_gscale_clamped': carry['n_gscale_clamped'] + clamped.to(
            torch.int32),
        'n_lscale_underflow': carry['n_lscale_underflow'] + n_under,
        'n_lscale_overflow': carry['n_lscale_overflow'] + n_over,
    }
    outputs = {'coef': coef, 'local_scale': lscale, 'global_scale': gscale,
               'obs_prec': obs_prec, 'logp': logp, **info}
    return carry, outputs


def init_carry(device, coef, obs_prec, gscale, lscale, summ=None,
               dtype=torch.float32, cfg=None):
    """One chain's state in `dtype` on `device` from host values; `summ`
    None starts a fresh summarizer, obs_prec None is the Cox model's
    (none), and an HMC or NUTS `cfg` adds the sampler's entries
    (``hmc_update.init_hmc_carry``)."""
    def fl(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    coef = fl(coef)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    carry = {
        'coef': coef,
        'obs_prec': fl(np.zeros(0) if obs_prec is None else obs_prec),
        'gscale': fl(gscale), 'lscale': fl(lscale),
        'summ': summ if summ is not None
        else summarizer_init(coef.shape[0], device, dtype=dtype),
        'n_gscale_clamped': zero, 'n_lscale_underflow': zero,
        'n_lscale_overflow': zero, 'n_cg_unconverged': 0,
    }
    if cfg is not None and cfg.hmc:
        carry.update(hmc_update.init_hmc_carry(cfg, device))
    return carry


def stack_carries(carries):
    """k single-chain carries as one chain-batched carry."""
    def stack(vals):
        if isinstance(vals[0], dict):
            return {key: stack([v[key] for v in vals]) for key in vals[0]}
        if torch.is_tensor(vals[0]):
            return torch.stack(vals)
        return np.asarray(vals, dtype=np.int64)
    return stack(list(carries))


def chain_of(batched, c):
    """Chain c's entries of a chain-batched carry or output dict (numpy
    counters as Python ints)."""
    out = {}
    for key, val in batched.items():
        if isinstance(val, dict):
            out[key] = chain_of(val, c)
        elif isinstance(val, np.ndarray):
            out[key] = int(val[c])
        else:
            out[key] = val[c]
    return out


def gibbs_step(cfg, model, gen, carry):
    """One Gibbs iteration of one chain: returns (carry, outputs)."""
    carry, out = gibbs_step_chains(cfg, model, [gen], stack_carries([carry]))
    return chain_of(carry, 0), chain_of(out, 0)


def run_chains(cfg, model, gens, carry, n_burnin, n_sample, thin,
               n_remainder, save_keys, status=None):
    """Run n_burnin + n_sample*thin + n_remainder iterations of k chains
    (a chain-batched carry, one generator per chain), keeping every
    `thin`-th post-burn-in draw (gibbs_util.py:164-199 semantics, as in
    step.run_chain). Returns (carry, outputs) with outputs[key] a list of
    per-sample (k, ...) tensors, or (k,) numpy arrays for the sampler
    diagnostics.

    `status` (optional): (callback(iteration, n_iter), interval) for
    progress printing."""
    n_iter = n_burnin + n_sample * thin + n_remainder
    outputs = {}
    n_saved = 0
    # float32 products in full float32 whatever the process's TF32
    # setting (the JAX package forces 'float32' precision under its
    # chains' vmap, multichain.py:41-50).
    with full_float32():
        for it in range(n_iter):
            carry, out = gibbs_step_chains(cfg, model, gens, carry)
            if it >= n_burnin and (it - n_burnin) % thin == thin - 1 \
                    and n_saved < n_sample:
                for key, val in out.items():
                    if key in save_keys or key not in SAMPLE_KEYS:
                        outputs.setdefault(key, []).append(val)
                n_saved += 1
            if status is not None and (it + 1) % status[1] == 0:
                status[0](it + 1, n_iter)
    return carry, outputs


def run_chain(cfg, model, gen, carry, n_burnin, n_sample, thin,
              n_remainder, save_keys, status=None):
    """:func:`run_chains` for one chain (a single-chain carry and
    generator): outputs[key] a list of per-sample tensors, or ints for
    the sampler diagnostics."""
    carry, outputs = run_chains(cfg, model, [gen], stack_carries([carry]),
                                n_burnin, n_sample, thin, n_remainder,
                                save_keys, status)
    return chain_of(carry, 0), {
        key: [int(v[0]) if isinstance(v, np.ndarray) else v[0]
              for v in vals] for key, vals in outputs.items()}
