"""BayesBridge on PyTorch and CUDA: Bayesian sparse regression with the
bridge prior, ported from the JAX package ``bayesbridge_tpu``.

The public API mirrors the reference library and the JAX package:

    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionModel, RegressionCoefPrior, SamplerOptions,
        gibbs_chains,
    )

This package serves the linear and logistic models on dense designs
(one block) and sparse ones (int8/bf16 + f32 blocks, bitmaps or a
windowed CSR), float32 or float64, the coefficients drawn by the
Cholesky sampler or the CG sampler (Jacobi or prior preconditioner),
with the float32 design sweeps in hand-written CUDA kernels for Hopper
(``csrc/``). ``gibbs_chains`` runs several independent chains as one
chain-batched step (:mod:`.multichain`; split R-hat and pooled ESS in
:mod:`.utils.mcmc_summarizer`). Devices are explicit: models live on
``device='cuda'`` by default, and ``device='cpu'`` runs every kernel's
plain PyTorch version.
It imports torch and never jax.
"""

from .prior import RegressionCoefPrior
from .models import RegressionModel
from .gibbs_util import SamplerOptions
from .bridge import BayesBridge
from .multichain import gibbs_chains

__all__ = ["RegressionCoefPrior", "RegressionModel", "SamplerOptions",
           "BayesBridge", "gibbs_chains"]

__version__ = "0.1.0"
