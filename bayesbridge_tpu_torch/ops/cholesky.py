"""Direct (Cholesky) Gaussian coefficient sampler.

Port of ``bayesbridge_tpu/ops/cholesky.py`` (reference:
bayesbridge/reg_coef_sampler/direct_gaussian_sampler.py:4-44): one draw
from N(Sigma z, Sigma), Sigma^{-1} = X' diag(obs_prec) X +
diag(prior_prec_sqrt)^2. The weighted Gram comes from the design's
``compute_fisher_info`` (cuBLAS on the card), the Jacobi-rescaled
precision is factored by ``torch.linalg.cholesky_ex`` (cuSOLVER), and the
draw is two triangular solves, with the intended lower/upper semantics
(the reference passed its scale vector as scipy's ``lower`` flag).

A precision that is not positive definite gives a factor of NaNs and so
a NaN draw, as ``jnp.linalg.cholesky`` does inside the JAX package's
scan, rather than raising: the chain's NaNs show the failure, and the
factorization needs no host sync to check it.
"""

import torch

from ..utils.dtypes import full_float32


def cholesky_draw(fisher, fisher_diag, prior_prec_sqrt, z, noise):
    """The draw from the Fisher information, its diagonal, the prior
    precision's square root, z and the standard-normal vector `noise`
    (all of one dtype): with s the Jacobi scale and L L' the rescaled
    precision, s * (L'^-1 L^-1 s z + L'^-1 noise)."""
    jacobi_scale = 1.0 / torch.sqrt(prior_prec_sqrt ** 2 + fisher_diag)
    prec = jacobi_scale[:, None] * fisher * jacobi_scale[None, :]
    prec = prec + torch.diag((jacobi_scale * prior_prec_sqrt) ** 2)
    with full_float32():
        chol, info = torch.linalg.cholesky_ex(prec)
        chol = torch.where(info == 0, chol,
                           torch.full_like(chol, float('nan')))
        mean = torch.cholesky_solve((jacobi_scale * z)[:, None], chol)[:, 0]
        dev = torch.linalg.solve_triangular(chol.T, noise[:, None],
                                            upper=True)[:, 0]
    return jacobi_scale * (mean + dev)


def sample_gaussian_cholesky(gen, design, obs_prec, prior_prec_sqrt, z):
    """One draw from the conditional Gaussian posterior of the
    coefficients, its standard-normal noise from `gen` in z's dtype."""
    fisher_diag = design.compute_fisher_info(obs_prec, diag_only=True)
    fisher = design.compute_fisher_info(obs_prec)
    noise = torch.randn(z.shape, generator=gen, dtype=z.dtype,
                        device=z.device)
    return cholesky_draw(fisher, fisher_diag, prior_prec_sqrt, z, noise)
