"""BayesBridge on PyTorch and CUDA: Bayesian sparse regression with the
bridge prior, ported from the JAX package ``bayesbridge_tpu``.

The public API mirrors the reference library and the JAX package:

    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionModel, RegressionCoefPrior, SamplerOptions,
        gibbs_chains,
    )

This package serves the linear, logistic and Cox models on dense
designs (one block) and sparse ones (int8/bf16 + f32 blocks, bitmaps, a
windowed CSR, or the dual row-ELL of X and X' on the ``ell`` backend),
float32 or float64. The coefficients are drawn by the Cholesky sampler,
the CG sampler (Jacobi or prior preconditioner) or the HMC and NUTS
samplers (the Cox model's default), with the design sweeps and products
in hand-written CUDA kernels for Hopper (``csrc/``; the ``ell`` backend's
col-ELL product on a traversal that stages windows of the vectors in
shared memory). ``gibbs_chains`` runs several independent chains as one
chain-batched step (:mod:`.multichain`; split R-hat and pooled ESS in
:mod:`.utils.mcmc_summarizer`); ``BayesBridge`` also exposes the Gibbs
step's component updates, for custom samplers. :mod:`.parallel` splits
a design by rows over a mesh of devices, in one process or several, and
``gibbs_chains(mesh=)`` runs groups of chains on them.
:mod:`.utils.profiling` traces any block with ``torch.profiler`` and
sums its device time by operation. Devices are explicit: models live on ``device='cuda'`` by
default, and ``device='cpu'`` runs every kernel's plain PyTorch version.
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
