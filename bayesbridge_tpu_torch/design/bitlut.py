"""Bitpacked binary columns: host-side layout of the bitpack backend.

Port of the host part of ``bayesbridge_tpu/design/bitlut.py``: the byte
layout, its padding plan and the packers. The matvec on this layout
(``out[m] = sum_g lut[g, bits[g, m]]``) is the ``bitlut`` kernel of
:mod:`bayesbridge_tpu_torch.kernels.bitlut`.

Storage is one BIT per element, bytes grouping 8 INPUT-dimension
positions, byte-group axis first and the OUTPUT dimension contiguous:

    bits[g, m] = sum_b X[m, 8g + b] << b        (for the X @ v direction)

The design keeps two orientations: ``bits_col`` (groups of columns,
one byte per row) for ``X v`` and ``bits_row`` (groups of rows, one byte
per binary column) for ``X' u``. All padding is zero bits, which add
``lut[g, 0] = 0``. The arrays are byte for byte the JAX package's.
"""

import numpy as np
import torch

# Block plan constants of the JAX package (bitlut.py:47-50); the padded
# shapes they imply are part of the stored layout.
_JB = 32
_K = 64
_LANE = 128
# Rows of the CSR packed per vectorized step (a multiple of 8, so each
# step owns whole bytes of bits_row).
_PACK_ROWS = 4096


def _ceil_to(x, m):
    return -(-x // m) * m


def pack_bits(dense_01, axis):
    """Pack a 0/1 array along `axis` into bytes, byte-group axis FIRST.

    pack_bits(X, axis=1) -> (ceil(p/8), n): bits[g, i] packs X[i, 8g:8g+8]
    pack_bits(X, axis=0) -> (ceil(n/8), p): bits[g, j] packs X[8g:8g+8, j]
    """
    packed = np.packbits(np.asarray(dense_01, dtype=np.uint8),
                         axis=axis, bitorder='little')
    return np.ascontiguousarray(packed.T if axis == 1 else packed)


def plan_blocks(n_in, n_out):
    """Static padding plan for a (n_in -> n_out) bitpacked product.

    Returns (g_pad, m_pad, n_chunk): the padded byte-group count, padded
    output length, and the JAX kernel's lane-chunks per block.
    """
    n_groups = _ceil_to(n_in, 8) // 8
    g_pad = _ceil_to(n_groups, _JB) if n_groups >= _JB \
        else _ceil_to(n_groups, 8)
    n_chunk = max(1, min(_K, _ceil_to(n_out, _LANE) // _LANE))
    m_pad = _ceil_to(n_out, n_chunk * _LANE)
    return g_pad, m_pad, n_chunk


def pad_packed(bits, g_pad, m_pad):
    """Zero-pad a packed (G, M) bitmap to the planned (g_pad, m_pad)."""
    g, m = bits.shape
    if (g, m) == (g_pad, m_pad):
        return bits
    out = np.zeros((g_pad, m_pad), dtype=np.uint8)
    out[:g, :m] = bits
    return out


def pack_csr_bitmaps(X_csr, bin_cols, plan_col, plan_row):
    """Both bitmaps of the 0/1 columns `bin_cols` of a CSR matrix.

    ``plan_col = (gcol_pad, n_pad)`` and ``plan_row = (grow_pad,
    pbin_pad)`` are the padded shapes of ``bits_col`` and ``bits_row``.
    Vectorized over row chunks of the CSR (no dense n x p transient and
    no per-row or per-column Python loop). Within one byte every entry
    sets a distinct bit (a row holds each column once), so a per-chunk
    sum of ``1 << bit`` over the byte's entries equals their OR. Every
    stored entry of a binary column is 1, so each sets its bit.
    """
    n, p = X_csr.shape
    p_bin = len(bin_cols)
    bits_col = np.zeros(plan_col, dtype=np.uint8)
    bits_row = np.zeros(plan_row, dtype=np.uint8)
    if p_bin == 0:
        return bits_col, bits_row
    pbin_pad = plan_row[1]
    n_groups = -(-p_bin // 8)
    col_of = np.full(p, -1, dtype=np.int64)
    col_of[bin_cols] = np.arange(p_bin)
    indptr, indices = X_csr.indptr, X_csr.indices
    for r0 in range(0, n, _PACK_ROWS):
        r1 = min(n, r0 + _PACK_ROWS)
        m = r1 - r0
        s, e = indptr[r0], indptr[r1]
        rows = np.repeat(np.arange(m, dtype=np.int64),
                         np.diff(indptr[r0:r1 + 1]))
        jb = col_of[indices[s:e]]
        keep = jb >= 0
        rows, jb = rows[keep], jb[keep]
        slab = np.bincount((jb >> 3) * m + rows,
                           weights=np.left_shift(1, jb & 7),
                           minlength=n_groups * m)
        bits_col[:n_groups, r0:r1] = slab.reshape(n_groups, m)
        g_rows = -(-m // 8)
        slab = np.bincount((rows >> 3) * pbin_pad + jb,
                           weights=np.left_shift(1, rows & 7),
                           minlength=g_rows * pbin_pad)
        bits_row[r0 // 8:r0 // 8 + g_rows] = slab.reshape(g_rows, pbin_pad)
    return bits_col, bits_row


def row_block_bits(bits_col, bits_row, r0, r1, plan_col, plan_row):
    """Both bitmaps (uint8 tensors) of rows r0:r1 of a design's binary
    columns, from the design's bitmaps, padded to the block's plans
    ``plan_col = (gcol_pad, n_pad)`` and ``plan_row = (grow_pad,
    pbin_pad)``, on the bitmaps' device. bits_col keeps its byte-groups
    (one byte per row); bits_row's bytes group rows by 8, so its groups
    are shifted by r0 % 8 bits, and the last group's bits past r1 are
    cleared."""
    m = r1 - r0
    dev = bits_col.device
    col = torch.zeros(plan_col, dtype=torch.uint8, device=dev)
    g = min(plan_col[0], bits_col.shape[0])
    col[:g, :m] = bits_col[:g, r0:r1]
    g0, shift = divmod(r0, 8)
    g_out = -(-m // 8)
    pbin = min(plan_row[1], bits_row.shape[1])
    # Only the row groups the block reads are widened.
    src = bits_row[g0:g0 + g_out + 1, :pbin].to(torch.int32)
    lo = src[:g_out]
    hi = torch.zeros_like(lo)
    nxt = src[1:1 + g_out]
    hi[:nxt.shape[0]] = nxt
    rows = ((lo >> shift) | (hi << (8 - shift))) & 0xFF
    if m % 8:
        rows[-1] &= (1 << (m % 8)) - 1
    row = torch.zeros(plan_row, dtype=torch.uint8, device=dev)
    row[:g_out, :pbin] = rows.to(torch.uint8)
    return col, row
