"""On-the-fly posterior summarizer state.

Port of ``bayesbridge_tpu/ops/summarizer.py`` (reference:
bayesbridge/reg_coef_sampler/reg_coef_posterior_summarizer.py:3-123): a
dict of tensors holding the running mean / second moment of the
prior-scaled coefficients, which feed the CG warm start, the prior
preconditioner's estimate of the unshrunk coefficients' sd and the HMC
preconditioner, and the sign-aligned running mean of the preconditioned
Hessian's principal component, which warm-starts the HMC curvature
estimate. The keys match
the JAX package's, so a chain state can be carried across
(``convert.carry_from_numpy``).

Every function takes one chain's state, or k chains' with a leading
chain axis (vectors (k, p), counters and scalars (k,)), as the JAX
functions do under ``vmap``; a per-chain scalar meets a vector through
``[..., None]``.
"""

import torch

from ..utils.chains import rdot


def _col(x, like):
    """A per-chain scalar (0-d, (k,) or a float) as a column against the
    vectors of `like`."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x[..., None]


def compute_prior_shrunk_scale(gscale, lscale, slab_size):
    """Slab-regularized prior scale, numerically stable
    (reg_coef_sampler.py:194-201)."""
    scale = _col(gscale, lscale) * lscale
    return scale / torch.sqrt(1.0 + (scale / slab_size) ** 2)


def summarizer_init(n_coef, device, sd_prior_samplesize=5,
                    dtype=torch.float32):
    fl = dict(dtype=dtype, device=device)
    return {
        'mean': torch.zeros(n_coef, **fl),
        'square': torch.ones(n_coef, **fl),
        'n_averaged': torch.zeros((), dtype=torch.int32, device=device),
        'sd_prior_guess': torch.ones(n_coef, **fl),
        'sd_prior_samplesize': torch.tensor(float(sd_prior_samplesize),
                                            **fl),
        'pc': torch.zeros(n_coef, **fl),
        'pc_n_averaged': torch.zeros((), dtype=torch.int32, device=device),
    }


def _scaling(state_dtype, device, gscale, lscale, n_unshrunk, slab_size):
    prior_scale = compute_prior_shrunk_scale(gscale, lscale, slab_size)
    return torch.cat((torch.ones(prior_scale.shape[:-1] + (n_unshrunk,),
                                 dtype=state_dtype, device=device),
                      prior_scale), -1)


def summarizer_update(state, coef, gscale, lscale, n_unshrunk, slab_size):
    """Online mean / second-moment update of the scaled coefficients
    (reg_coef_posterior_summarizer.py:18-21, 93-103)."""
    coef_scaled = coef / _scaling(coef.dtype, coef.device, gscale, lscale,
                                  n_unshrunk, slab_size)
    n = state['n_averaged']
    weight = _col(1.0 / (1.0 + n.to(coef.dtype)), coef)
    return {
        **state,
        'mean': weight * coef_scaled + (1 - weight) * state['mean'],
        'square': weight * coef_scaled ** 2 + (1 - weight) * state['square'],
        'n_averaged': n + 1,
    }


def extrapolate_coef_condmean(state, gscale, lscale, n_unshrunk, slab_size):
    """Warm-start guess of the conditional posterior mean: the scaled
    running mean mapped back through the current prior scale
    (reg_coef_posterior_summarizer.py:25-29)."""
    mean = state['mean']
    return mean * _scaling(mean.dtype, mean.device, gscale, lscale,
                           n_unshrunk, slab_size)


def estimate_coef_precond_scale_sd(state):
    """Shrunk estimator of the posterior sd of the scaled coefficients
    (reg_coef_posterior_summarizer.py:105-123): the sample variance
    blended with the prior guess, weighted as if the guess were an
    average of `sd_prior_samplesize` earlier draws."""
    mean, sec_moment = state['mean'], state['square']
    n = _col(state['n_averaged'].to(mean.dtype), mean)
    prior_m = _col(state['sd_prior_samplesize'], mean)
    zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
    var_est = torch.where(n > 1, n / torch.clamp_min(n - 1, 1)
                          * (sec_moment - mean ** 2), zero)
    est_weight = torch.where(n > 1, (n - 1) / (n - 1 + prior_m), zero)
    return torch.sqrt(est_weight * torch.clamp_min(var_est, 0.0)
                      + (1 - est_weight) * state['sd_prior_guess'] ** 2)


def update_precond_hessian_pc(state, pc):
    """Sign-aligned running average of the principal component
    (reg_coef_posterior_summarizer.py:43-62, 'average' method)."""
    n = state['pc_n_averaged']
    flip = rdot(state['pc'], pc) < 0
    aligned = pc * _col(torch.where(flip, -1.0, 1.0), pc)
    weight = _col(1.0 / (1.0 + n.to(pc.dtype)), pc)
    new_pc = torch.where((n == 0)[..., None], pc,
                         weight * aligned + (1 - weight) * state['pc'])
    return {**state, 'pc': new_pc, 'pc_n_averaged': n + 1}


def estimate_precond_hessian_pc(state, fallback):
    """The principal-component estimate, or `fallback` (a random
    direction) while no update has been recorded
    (reg_coef_posterior_summarizer.py:64-70)."""
    return torch.where((state['pc_n_averaged'] > 0)[..., None],
                       state['pc'], fallback)
