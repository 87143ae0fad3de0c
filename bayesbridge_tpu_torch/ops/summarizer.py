"""On-the-fly posterior summarizer state.

Port of ``bayesbridge_tpu/ops/summarizer.py`` (reference:
bayesbridge/reg_coef_sampler/reg_coef_posterior_summarizer.py:3-123): a
dict of tensors holding the running mean / second moment of the
prior-scaled coefficients, which feed the CG warm start. The keys match
the JAX package's, so a chain state can be carried across
(``convert.carry_from_numpy``).
"""

import torch


def compute_prior_shrunk_scale(gscale, lscale, slab_size):
    """Slab-regularized prior scale, numerically stable
    (reg_coef_sampler.py:194-201)."""
    scale = gscale * lscale
    return scale / torch.sqrt(1.0 + (scale / slab_size) ** 2)


def summarizer_init(n_coef, device, sd_prior_samplesize=5):
    f32 = dict(dtype=torch.float32, device=device)
    return {
        'mean': torch.zeros(n_coef, **f32),
        'square': torch.ones(n_coef, **f32),
        'n_averaged': torch.zeros((), dtype=torch.int32, device=device),
        'sd_prior_guess': torch.ones(n_coef, **f32),
        'sd_prior_samplesize': torch.tensor(float(sd_prior_samplesize),
                                            **f32),
        'pc': torch.zeros(n_coef, **f32),
        'pc_n_averaged': torch.zeros((), dtype=torch.int32, device=device),
    }


def _scaling(state_dtype, device, gscale, lscale, n_unshrunk, slab_size):
    prior_scale = compute_prior_shrunk_scale(gscale, lscale, slab_size)
    return torch.cat((torch.ones(n_unshrunk, dtype=state_dtype,
                                 device=device), prior_scale))


def summarizer_update(state, coef, gscale, lscale, n_unshrunk, slab_size):
    """Online mean / second-moment update of the scaled coefficients
    (reg_coef_posterior_summarizer.py:18-21, 93-103)."""
    coef_scaled = coef / _scaling(coef.dtype, coef.device, gscale, lscale,
                                  n_unshrunk, slab_size)
    n = state['n_averaged']
    weight = 1.0 / (1.0 + n.to(coef.dtype))
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
