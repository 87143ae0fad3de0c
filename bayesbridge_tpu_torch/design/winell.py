"""Windowed-ELL: host-side layout of the winell backend.

Port of the host part of ``bayesbridge_tpu/design/winell.py``: the
window/slot plan, the storage estimate used by ``backend='auto'`` and
the packer. The matvec on this layout is the ``winell`` kernel of
:mod:`bayesbridge_tpu_torch.kernels.winell`:

    out[tile, lane] += sum_slot val[slot, lane] * v[window, idx[slot, lane]]

The INPUT dimension is cut into windows of ``W`` positions and the
OUTPUT dimension into tiles of 128 lanes; each (window, tile) cell holds
``K`` slot rows of 128 lanes with the entry's window-local input
position (int16) and its value (float32). Entries beyond the K-th slot
of their (output, window) cell spill to a small CSR side matrix. Empty
slots hold index 0 and value 0. The arrays are the JAX package's,
element for element.
"""

import numpy as np
import scipy.sparse as sps

_LANE = 128


def _ceil_to(x, m):
    return -(-x // m) * m


def plan_windows(n_in, n_out, nnz):
    """Choose (W, K): window width and ELL slot depth.

    W targets a per-(output, window) Poisson mean of ~4-13 entries so
    the K slots fill well; K is ~3x the mean so spill stays in the
    fraction-of-a-percent range.
    """
    density = nnz / max(1, n_in * n_out)
    W = _LANE
    while W < 8 * _LANE and W * density < 4.0:
        W *= 2
    mean = W * density
    K = 32 if mean > 8.0 else 16
    return W, K


def tile_block(n_out):
    """(T, TB): padded output-tile count and the JAX kernel's tiles per
    block (T is a multiple of TB, part of the stored layout)."""
    T = max(1, _ceil_to(n_out, _LANE) // _LANE)
    TB = min(8, T)
    return _ceil_to(T, TB), TB


def estimate_bytes(shape, nnz):
    """Predicted dual-orientation storage (6 B per slot: int16 idx +
    f32 value), from shape and nnz alone."""
    n, p = shape
    total = 0
    for n_in, n_out in ((p, n), (n, p)):
        W, K = plan_windows(n_in, n_out, nnz)
        T, _ = tile_block(n_out)
        Wn = max(1, _ceil_to(n_in, W) // W)
        total += Wn * T * K * _LANE * 6
    return total


def pack_winell(X_csr, W, K):
    """Pack a CSR matrix (rows = outputs, indices sorted) into windowed-ELL.

    Returns (idx, val, spill_csr): idx/val of shape (Wn * T * K, 128),
    Wn input windows (major), T output tiles, K slots; spill_csr a scipy
    CSR of the entries beyond the K-th slot of their cell, or None.
    """
    n_out, n_in = X_csr.shape
    T, _ = tile_block(n_out)
    Wn = max(1, _ceil_to(n_in, W) // W)
    nnz = X_csr.nnz

    idx = np.zeros((Wn * T * K, _LANE), dtype=np.int16)
    val = np.zeros((Wn * T * K, _LANE), dtype=np.float32)
    if nnz == 0:
        return idx, val, None

    indptr, indices = X_csr.indptr, X_csr.indices
    data = np.asarray(X_csr.data, dtype=np.float32)
    rows = np.repeat(np.arange(n_out, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    w = cols // W
    local = (cols - w * W).astype(np.int16)
    lane = (rows & (_LANE - 1)).astype(np.int32)
    tile = rows >> 7

    # Slot = running count within each (row, window) cell: CSR order is
    # (row asc, col asc), so the cell key is non-decreasing and the count
    # is a change-point cumcount.
    key = rows * Wn + w
    pos = np.arange(nnz, dtype=np.int64)
    change = np.empty(nnz, dtype=bool)
    change[0] = True
    np.not_equal(key[1:], key[:-1], out=change[1:])
    start = np.maximum.accumulate(np.where(change, pos, 0))
    slot = pos - start

    main = slot < K
    cell = (w * T + tile) * K + slot
    idx[cell[main], lane[main]] = local[main]
    val[cell[main], lane[main]] = data[main]

    if main.all():
        return idx, val, None
    rest = ~main
    spill = sps.csr_matrix(
        (data[rest], (rows[rest], cols[rest])), shape=(n_out, n_in))
    return idx, val, spill
