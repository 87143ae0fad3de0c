"""Carrying the JAX package's state across to this package.

The JAX package's arrays, taken as numpy (``np.asarray`` of a jax
array), become this package's tensors on an explicit device. This module
imports neither jax nor ``bayesbridge_tpu``: the caller hands over plain
numpy arrays and flags.
"""

import numpy as np
import torch

from .design.sparse import SparseDesignMatrix
from .kernels import layout
from .step import init_carry


def _pad_cols(block, width):
    out = np.zeros((block.shape[0], width), dtype=block.dtype)
    out[:, :block.shape[1]] = block
    return out


def _block_tensor(block, p):
    """A hybrid block as a tensor padded to the kernels' column layout.
    bf16 arrives as ``ml_dtypes.bfloat16`` (numpy has no bf16): its raw
    16-bit pattern is reinterpreted as torch.bfloat16."""
    block = np.asarray(block)[:, :p]
    padded = _pad_cols(block, layout.padded_width(p))
    if block.dtype.name == 'bfloat16':
        return torch.from_numpy(padded.view(np.uint16).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(padded))


def design_from_numpy(X_exact, X_float, exact_cols, float_cols,
                      column_offset, shape, add_intercept=True,
                      center_predictor=False, exact_is_binary=False,
                      device='cuda', fused=None):
    """A hybrid SparseDesignMatrix from the JAX design's arrays.

    Parameters
    ----------
    X_exact, X_float : the stored blocks (int8 / bfloat16 / float32 and
        float32), possibly wider than their column sets (mesh padding)
    exact_cols, float_cols : original column index of each block column
    column_offset : (p,) centering offsets (zeros when not centered)
    shape : (n, p) of the main design, intercept excluded
    """
    n, p = shape
    exact_cols = np.asarray(exact_cols)
    float_cols = np.asarray(float_cols)
    parts = dict(
        X_exact=_block_tensor(np.asarray(X_exact)[:n], len(exact_cols)),
        X_float=torch.from_numpy(_pad_cols(
            np.asarray(X_float, np.float32)[:n, :len(float_cols)],
            layout.padded_width(len(float_cols)))),
        exact_cols=exact_cols, float_cols=float_cols,
        column_offset=np.asarray(column_offset, np.float64),
        shape_main=(n, p), nnz=None, exact_is_binary=exact_is_binary)
    return SparseDesignMatrix(None, center_predictor=center_predictor,
                              add_intercept=add_intercept, fused=fused,
                              device=device, _parts=parts)


def carry_from_numpy(coef, obs_prec, gscale, lscale, summ=None,
                     device='cuda'):
    """The port's chain state from the JAX chain's: coef, obs_prec,
    gscale (raw parametrization), lscale and the summarizer state (the
    JAX dict of the same keys; None starts a fresh one)."""
    device = torch.device(device)
    summ_t = None
    if summ is not None:
        summ_t = {}
        for key, val in summ.items():
            val = np.asarray(val)
            summ_t[key] = torch.as_tensor(
                val.astype(np.int32) if np.issubdtype(val.dtype, np.integer)
                else val.astype(np.float32), device=device)
    return init_carry(device, coef, obs_prec, gscale, lscale, summ_t)
