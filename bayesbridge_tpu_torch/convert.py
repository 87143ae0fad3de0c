"""Carrying the JAX package's state across to this package.

The JAX package's arrays, taken as numpy (``np.asarray`` of a jax
array), become this package's tensors on an explicit device. This module
imports neither jax nor ``bayesbridge_tpu``: the caller hands over plain
numpy arrays and flags. A model's outcome arrays go straight to the
port's model classes (``LinearModel(np.asarray(jax_model.y), design)``,
``LogisticModel(n_success, n_trial, design)``).
"""

import numpy as np
import torch

from .design.dense import DenseDesignMatrix, stored_width
from .design.sparse import PACKED_ARRAYS, SparseDesignMatrix
from .kernels import layout
from .step import init_carry, stack_carries


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
        float32; or both float64, which make one float64 block of every
        column in the port), possibly wider than their column sets (mesh
        padding)
    exact_cols, float_cols : original column index of each block column
    column_offset : (p,) centering offsets (zeros when not centered)
    shape : (n, p) of the main design, intercept excluded
    """
    n, p = shape
    exact_cols = np.asarray(exact_cols)
    float_cols = np.asarray(float_cols)
    if np.asarray(X_float).dtype == np.float64:
        X = np.zeros((n, layout.padded_width(p)))
        for block, cols in ((X_exact, exact_cols), (X_float, float_cols)):
            X[:, cols] = np.asarray(block)[:n, :len(cols)]
        parts = dict(
            backend='hybrid', X_exact=torch.zeros((n, 0), dtype=torch.float64),
            X_float=torch.from_numpy(X), exact_cols=exact_cols[:0],
            float_cols=np.arange(p),
            column_offset=np.asarray(column_offset, np.float64),
            shape_main=(n, p), nnz=None, exact_is_binary=exact_is_binary)
        return SparseDesignMatrix(None, center_predictor=center_predictor,
                                  add_intercept=add_intercept,
                                  dtype=torch.float64, fused=fused,
                                  device=device, _parts=parts)
    parts = dict(
        backend='hybrid',
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


def dense_design_from_numpy(X, n_rows=None, add_intercept=True,
                            center_predictor=False, device='cuda',
                            fused=None):
    """A DenseDesignMatrix from the JAX dense design's stored X (numpy:
    the intercept column and the centering already in it, float32 or
    float64), its first `n_rows` rows (the JAX design's ``_n_rows``; the
    rest are zero padding)."""
    X = np.asarray(X)
    n, p = X.shape
    n = n if n_rows is None else n_rows
    stored = np.zeros((n, stored_width(p, X.itemsize)), X.dtype)
    stored[:, :p] = X[:n]
    return DenseDesignMatrix(
        None, center_predictor=center_predictor, add_intercept=add_intercept,
        fused=fused, device=device, _stored=(torch.from_numpy(stored), p))


def packed_design_from_numpy(backend, arrays, meta, column_offset, shape,
                             nnz=None, add_intercept=True,
                             center_predictor=False, device='cuda',
                             fused=None):
    """A bitpack or winell SparseDesignMatrix from the JAX design's arrays.

    Parameters
    ----------
    backend : 'bitpack' | 'winell'
    arrays : {name: numpy array} holding the JAX design's attributes of
        those names: bits_col, bits_row, X_float, bin_cols, float_cols
        (bitpack); widx_dot, wval_dot, widx_tdot, wval_tdot, sd_idx,
        sd_val, st_idx, st_val (winell)
    meta : the JAX design's ``_bitpack_meta`` / ``_winell_meta``
    column_offset : (p,) centering offsets (zeros when not centered)
    shape : (n, p) of the main design, intercept excluded
    """
    if backend not in PACKED_ARRAYS:
        raise ValueError(f"backend must be one of {sorted(PACKED_ARRAYS)}")
    parts = {name: np.asarray(arrays[name])
             for name in PACKED_ARRAYS[backend]}
    parts.update(backend=backend, column_offset=np.asarray(
        column_offset, np.float64), shape_main=tuple(shape), nnz=nnz,
        meta=tuple(meta))
    return SparseDesignMatrix(None, center_predictor=center_predictor,
                              add_intercept=add_intercept, fused=fused,
                              device=device, _parts=parts)


def carry_from_numpy(coef, obs_prec, gscale, lscale, summ=None,
                     device='cuda', dtype=torch.float32):
    """The port's chain state in `dtype` from the JAX chain's: coef,
    obs_prec, gscale (raw parametrization), lscale and the summarizer
    state (the JAX dict of the same keys; None starts a fresh one)."""
    device = torch.device(device)
    summ_t = None
    if summ is not None:
        summ_t = {}
        for key, val in summ.items():
            val = np.asarray(val)
            if np.issubdtype(val.dtype, np.integer):
                summ_t[key] = torch.as_tensor(val.astype(np.int32),
                                              device=device)
            else:
                summ_t[key] = torch.tensor(val, dtype=dtype, device=device)
    return init_carry(device, coef, obs_prec, gscale, lscale, summ_t,
                      dtype=dtype)


def chain_carry_from_numpy(chain_carry, device='cuda', dtype=torch.float32):
    """The port's chain-batched carry in `dtype` from the ``_chain_carry``
    of a JAX ``gibbs_chains`` info (numpy arrays with a leading chain
    axis): each chain's coef, obs_prec, gscale (raw parametrization),
    lscale and summarizer state. The guard-rail counters start at zero.
    The JAX chains' keys do not carry over: a continuation draws from
    fresh generators (``BasicRandom.spawn``)."""
    summ = chain_carry.get('summ')
    return stack_carries([carry_from_numpy(
        chain_carry['coef'][c], chain_carry['obs_prec'][c],
        chain_carry['gscale'][c], chain_carry['lscale'][c],
        None if summ is None else {key: np.asarray(val)[c]
                                   for key, val in summ.items()},
        device=device, dtype=dtype)
        for c in range(len(chain_carry['coef']))])
