"""Floating point and device configuration.

The JAX package follows the process's default float (float64 under
``jax_enable_x64``). This port has no such switch: the working dtype is
float32 unless a design asks for float64 (``dtype=np.float64`` or
``torch.float64``), and a chain follows its model's design unless
``BayesBridge(..., dtype=...)`` says otherwise. The hand-written kernels
are float32 only, but for the ell backend's gather kernel, which runs
both types; a float64 hybrid or dense design runs its products as
``torch.matmul`` (and cuSOLVER for the Cholesky factor), as the JAX
package runs them as XLA products outside Pallas.

The device is always explicit. ``'cuda'`` is the default everywhere;
with no GPU it raises instead of falling back to the CPU. The CPU tests
pass ``device='cpu'``, which runs the kernels' plain PyTorch versions.
"""

import contextlib

import numpy as np
import torch

WORKING_DTYPES = (torch.float32, torch.float64)


def working_dtype(dtype):
    """torch.float32 or torch.float64 for `dtype` (None = float32; numpy
    or torch spelling); raise for any other."""
    if dtype is None:
        return torch.float32
    if not isinstance(dtype, torch.dtype):
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if dtype not in WORKING_DTYPES:
        raise NotImplementedError(
            "dtype={}: the working dtype is float32 or float64".format(
                dtype))
    return dtype


@contextlib.contextmanager
def full_float32():
    """float32 matrix products in full float32 inside the block, whatever
    the process's TF32 setting (restored on exit): the Gram feeds the
    Cholesky factor, as the JAX package forces Precision.HIGHEST there."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def resolve_device(device='cuda'):
    """torch.device for `device`; a CUDA request with no usable GPU
    raises instead of moving to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "device='{}' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch "
            "versions.".format(device))
    if device.type not in ('cuda', 'cpu'):
        raise ValueError("unsupported device {}".format(device))
    return device
