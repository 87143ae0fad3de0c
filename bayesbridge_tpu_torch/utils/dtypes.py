"""Floating point and device configuration.

The JAX package follows the process's default float (float64 under
``jax_enable_x64``). This port serves the flagship's float32 working
precision only: every design, model and chain tensor is float32, and
a float64 request raises rather than silently narrowing.

The device is always explicit. ``'cuda'`` is the default everywhere;
with no GPU it raises instead of falling back to the CPU. The CPU tests
pass ``device='cpu'``, which runs the kernels' plain PyTorch versions.
"""

import numpy as np
import torch


def check_float32(dtype):
    """Accept None / float32 (numpy or torch spelling); raise otherwise."""
    if dtype is None or dtype is torch.float32 or (
            not isinstance(dtype, torch.dtype)
            and np.dtype(dtype) == np.float32):
        return torch.float32
    raise NotImplementedError(
        "dtype={}: the torch port runs float32 only (the float64 path "
        "is not ported).".format(dtype))


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
