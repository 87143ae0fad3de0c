"""BayesBridge on PyTorch and CUDA: Bayesian sparse regression with the
bridge prior, ported from the JAX package ``bayesbridge_tpu``.

The public API mirrors the reference library and the JAX package:

    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionModel, RegressionCoefPrior, SamplerOptions
    )

This package serves the flagship path: a logistic model on a sparse
design stored as int8/bf16 + f32 blocks, coefficients drawn by the
prior-preconditioned CG sampler, with the design sweeps in hand-written
CUDA kernels for Hopper (``csrc/``). Devices are explicit: models live on
``device='cuda'`` by default, and ``device='cpu'`` runs every kernel's
plain PyTorch version. It imports torch and never jax.
"""

from .prior import RegressionCoefPrior
from .models import RegressionModel
from .gibbs_util import SamplerOptions
from .bridge import BayesBridge

__all__ = ["RegressionCoefPrior", "RegressionModel", "SamplerOptions",
           "BayesBridge"]

__version__ = "0.1.0"
