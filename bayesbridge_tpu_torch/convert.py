"""Carrying the JAX package's state across to this package.

The JAX package's arrays, taken as numpy (``np.asarray`` of a jax
array), become this package's tensors on an explicit device. This module
imports neither jax nor ``bayesbridge_tpu``: the caller hands over plain
numpy arrays and flags. A model's outcome arrays go straight to the
port's model classes (``LinearModel(np.asarray(jax_model.y), design)``,
``LogisticModel(n_success, n_trial, design)``); a Cox model's sorted
times and risk sets go through :func:`cox_model_from_numpy`.
"""

import numpy as np
import scipy.sparse as sps
import torch

from .design import bitlut as bitlut_mod
from .design.dense import DenseDesignMatrix, stored_width
from .design.sparse import PACKED_ARRAYS, SparseDesignMatrix
from .design.wincsr import csr_from_winell
from .kernels import layout
from .models.cox import CoxModel
from .step import init_carry, stack_carries

# The HMC and NUTS entries of a chain's carry (step.py:310-311).
HMC_CARRY_KEYS = ('hmc_adapter', 'stab_buffer', 'stab_n',
                  'n_curvature_invalid')


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
                      device='cuda', fused=None, exact_tier=None):
    """A hybrid SparseDesignMatrix from the JAX design's arrays.

    Parameters
    ----------
    X_exact, X_float : the stored blocks (int8 / bfloat16 / float32 and
        float32; or both float64, which make one float64 block of every
        column in the port), possibly wider than their column sets (mesh
        padding). The JAX design's packed-s4 (int4) block arrives widened
        to int8 (``np.asarray(X_exact).astype(np.int8)``) with
        ``exact_tier='int4'``, and is packed here.
    exact_cols, float_cols : original column index of each block column
    column_offset : (p,) centering offsets (zeros when not centered)
    shape : (n, p) of the main design, intercept excluded
    exact_tier : 'int4' to store X_exact as a packed int4 block, else
        None (its own dtype)
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
    if exact_tier == 'int4':
        X_exact = layout.pack_int4(torch.from_numpy(np.ascontiguousarray(
            np.asarray(X_exact, np.int8)[:n])), len(exact_cols))
    elif exact_tier is not None:
        raise ValueError(f"exact_tier must be 'int4' or None, got "
                         f"{exact_tier!r}")
    else:
        X_exact = _block_tensor(np.asarray(X_exact)[:n], len(exact_cols))
    parts = dict(
        backend='hybrid', X_exact=X_exact,
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
    """A bitpack, winell or ell SparseDesignMatrix from the JAX design's
    arrays.

    Parameters
    ----------
    backend : 'bitpack' | 'winell' | 'ell'
    arrays : {name: numpy array} holding the JAX design's attributes of
        those names: bits_col, bits_row, X_float, bin_cols, float_cols
        (bitpack); widx_dot, wval_dot, widx_tdot, wval_tdot, sd_idx,
        sd_val, st_idx, st_val (winell); row_idx, row_val, col_idx,
        col_val (ell, whose values' dtype, float32 or float64, is the
        design's)
    meta : the JAX design's ``_bitpack_meta`` / ``_winell_meta``; None
        for ell
    column_offset : (p,) centering offsets (zeros when not centered)
    shape : (n, p) of the main design, intercept excluded
    """
    if backend not in PACKED_ARRAYS:
        raise ValueError(f"backend must be one of {sorted(PACKED_ARRAYS)}")
    parts = {name: np.asarray(arrays[name])
             for name in PACKED_ARRAYS[backend]}
    parts.update(backend=backend, column_offset=np.asarray(
        column_offset, np.float64), shape_main=tuple(shape), nnz=nnz)
    if meta is not None:
        parts['meta'] = tuple(meta)
    dtype = parts['row_val'].dtype if backend == 'ell' else np.float32
    return SparseDesignMatrix(None, center_predictor=center_predictor,
                              add_intercept=add_intercept, dtype=dtype,
                              fused=fused, device=device, _parts=parts)


def design_from_sharded_numpy(backend, arrays, meta, column_offset, shape,
                              nnz=None, add_intercept=True,
                              center_predictor=False, device='cuda',
                              fused=None):
    """The port's unsharded design from a JAX design sharded on a 1-d
    mesh (``bayesbridge_tpu.parallel.shard_design``): `arrays` are
    ``np.asarray`` of its attributes (which gathers a sharded array),
    with the mesh's zero padding (``_put_pad``) still on; it is cut off
    here. Shard the result with ``parallel.shard_model`` / ``shard_design``
    over as many shards.

    backend : 'hybrid' (`arrays` as :func:`design_from_numpy` names them,
        ``exact_is_binary`` and ``exact_tier``), 'dense' ({'X': the
        stored X}), 'bitpack', 'winell' or 'ell'
        (:func:`packed_design_from_numpy`'s names)
    meta : the JAX design's ``_bitpack_meta`` (bitpack; re-planned for
        the unsharded shape here), ``_winell_shard[2:7]`` = (w_dot, k_dot,
        w_tdot, k_tdot, rows a device) (winell; its packings are one per
        device, stacked), else None
    shape : (n, p) of the main design, intercept excluded
    """
    n, p = shape
    kw = dict(add_intercept=add_intercept, center_predictor=center_predictor,
              device=device, fused=fused)
    if backend == 'hybrid':
        return design_from_numpy(
            arrays['X_exact'], arrays['X_float'], arrays['exact_cols'],
            arrays['float_cols'], column_offset, shape,
            exact_is_binary=bool(arrays.get('exact_is_binary', False)),
            exact_tier=arrays.get('exact_tier'), **kw)
    if backend == 'dense':
        return dense_design_from_numpy(arrays['X'], n, **kw)
    if backend == 'ell':
        return packed_design_from_numpy('ell', arrays, None, column_offset,
                                        shape, nnz, **kw)
    if backend == 'bitpack':
        p_bin = int(meta[0])
        gcol_pad, n_pad, k_dot = bitlut_mod.plan_blocks(p_bin, n)
        grow_pad, pbin_pad, k_tdot = bitlut_mod.plan_blocks(n, p_bin)
        cut = dict(arrays)
        cut['bits_col'] = np.asarray(arrays['bits_col'])[:gcol_pad, :n_pad]
        cut['bits_row'] = np.asarray(arrays['bits_row'])[:grow_pad,
                                                         :pbin_pad]
        cut['X_float'] = np.asarray(arrays['X_float'])[:n]
        return packed_design_from_numpy(
            'bitpack', cut, (p_bin, gcol_pad, n_pad, k_dot, grow_pad,
                             pbin_pad, k_tdot), column_offset, shape, nnz,
            **kw)
    if backend != 'winell':
        raise ValueError(f"unknown backend {backend!r}")
    w_dot, k_dot, _, _, n_loc = (int(m) for m in meta)
    blocks = [csr_from_winell(
        arrays['widx_dot'][d], arrays['wval_dot'][d], arrays['sd_idx'][d],
        arrays['sd_val'][d], (n_loc, p), w_dot, k_dot)
        for d in range(len(arrays['widx_dot']))]
    X = sps.vstack(blocks).tocsr()[:n]
    design = SparseDesignMatrix(X, backend='winell', **kw)
    design.column_offset = torch.as_tensor(
        np.asarray(column_offset, np.float64), dtype=design.dtype,
        device=design.device)
    return design


def cox_model_from_numpy(event_time, censoring_time, design,
                         risk_set_start_index=None, risk_set_end_index=None,
                         n_appearance_in_risk_set=None):
    """The port's CoxModel over `design` from the JAX CoxModel's sorted
    event and censoring times. Its risk sets are computed again; the JAX
    model's (``risk_set_start_index``, ``risk_set_end_index``,
    ``n_appearance_in_risk_set``), where given, must equal them."""
    model = CoxModel(event_time, censoring_time, design)
    for name, theirs in (
            ('risk_set_start_index', risk_set_start_index),
            ('risk_set_end_index', risk_set_end_index),
            ('n_appearance_in_risk_set', n_appearance_in_risk_set)):
        ours = getattr(model, name).cpu().numpy()
        if theirs is not None and not np.array_equal(ours,
                                                     np.asarray(theirs)):
            raise ValueError(f"{name} differs from the port's")
    return model


def _tensors(tree, device, dtype):
    """Numpy arrays (nested dicts of them) as tensors: floats in `dtype`,
    integers as int32."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _tensors(val, device, dtype)
            continue
        val = np.asarray(val)
        if np.issubdtype(val.dtype, np.integer):
            out[key] = torch.as_tensor(val.astype(np.int32), device=device)
        else:
            out[key] = torch.tensor(val, dtype=dtype, device=device)
    return out


def carry_from_numpy(coef, obs_prec, gscale, lscale, summ=None,
                     device='cuda', dtype=torch.float32, hmc=None):
    """The port's chain state in `dtype` from the JAX chain's: coef,
    obs_prec (None or empty for Cox), gscale (raw parametrization),
    lscale, the summarizer state (the JAX dict of the same keys; None
    starts a fresh one) and, for HMC and NUTS, `hmc`: the JAX carry's
    entries of ``HMC_CARRY_KEYS`` (the stepsize adapter, the stabilizer
    ring where the run has one, the curvature counter)."""
    device = torch.device(device)
    summ_t = None if summ is None else _tensors(summ, device, dtype)
    carry = init_carry(device, coef, obs_prec, gscale, lscale, summ_t,
                       dtype=dtype)
    if hmc is not None:
        carry.update(_tensors({key: hmc[key] for key in HMC_CARRY_KEYS
                               if key in hmc}, device, dtype))
    return carry


def chain_carry_from_numpy(chain_carry, device='cuda', dtype=torch.float32):
    """The port's chain-batched carry in `dtype` from the ``_chain_carry``
    of a JAX ``gibbs_chains`` info (numpy arrays with a leading chain
    axis): each chain's coef, obs_prec, gscale (raw parametrization),
    lscale, summarizer state and, under HMC and NUTS, the sampler's
    entries (``HMC_CARRY_KEYS``). The other guard-rail counters start at
    zero. The JAX chains' keys do not carry over: a continuation draws
    from fresh generators (``BasicRandom.spawn``)."""
    def chain(tree, c):
        return {key: chain(val, c) if isinstance(val, dict)
                else np.asarray(val)[c] for key, val in tree.items()}

    summ = chain_carry.get('summ')
    hmc = {key: chain_carry[key] for key in HMC_CARRY_KEYS
           if key in chain_carry} or None
    return stack_carries([carry_from_numpy(
        chain_carry['coef'][c], chain_carry['obs_prec'][c],
        chain_carry['gscale'][c], chain_carry['lscale'][c],
        None if summ is None else chain(summ, c), device=device,
        dtype=dtype, hmc=None if hmc is None else chain(hmc, c))
        for c in range(len(chain_carry['coef']))])
