"""Windowed CSR: the winell backend's layout on the card.

The JAX package's windowed-ELL packing (:mod:`.winell`) cuts the input
dimension into windows of at most 1,024 positions for the TPU's
in-register gather, and pads every (window, 128-output tile) cell to K
slots: at the 131,072 x 16,384 design about a third of its slots hold a
nonzero. On the H100 the inputs need no such cut (v stays in the 50 MB
L2 cache), so the card stores this layout instead, per orientation
(rows = outputs):

* the input dimension is cut into ``Wn`` windows of ``window`` positions
  (at most ``MAX_WINDOW``; a 16-bit local index allows up to 65,536);
* segment ``s = w * n_out + row`` holds the row's nonzeros in window
  ``w``, in column order, at entries ``ptr[s] .. ptr[s + 1]`` of the
  flat ``idx`` (window-local position, uint16 stored as int16) and
  ``val`` (float32) arrays;
* every segment is padded with (index 0, value 0) to a multiple of
  ``ALIGN`` entries, so that a thread loads eight indices and eight
  values as aligned 16-byte vectors; a padded entry adds 0 * v[window
  start], exactly 0 for finite v.

Every nonzero has its place: no slots, no spill. About 6 bytes per
nonzero plus the pointers.
"""

import numpy as np
import scipy.sparse as sps
import torch

from .winell import tile_block

# Input positions per window: 16,384 (64 KB of float32). At the winell
# design X' u ran 0.0702 ms over windows of 16,384 against 0.0839 over
# windows of 32,768, both gathering u through L2 (H100, PERF.md).
MAX_WINDOW = 16_384
ALIGN = 8            # entries per 16-byte vector of uint16 indices
LANE_CHOICES = (4, 8, 16, 32)


def _ceil_to(x, m):
    return -(-x // m) * m


def plan_window(n_in):
    """Window width for `n_in` inputs: one window where they fit, else
    MAX_WINDOW."""
    return max(ALIGN, min(MAX_WINDOW, _ceil_to(n_in, ALIGN)))


def lanes_per_row(n_entries, n_segments):
    """Lanes of the kernel that share one row segment: the power of two
    (4 to 32) nearest half the mean segment's 8-entry chunks, so that a
    lane takes about two chunks of an average segment."""
    chunks = n_entries / ALIGN / max(1, n_segments)
    for lanes in LANE_CHOICES:
        if 2 * lanes >= chunks:
            return lanes
    return LANE_CHOICES[-1]


class WinCSR:
    """One orientation of the layout: tensors ``ptr`` (int64, Wn * n_out
    + 1), ``idx`` (int16 holding uint16), ``val`` (float32), and the
    ints ``n_out``, ``n_in``, ``window``, ``n_win``, ``lanes``."""

    def __init__(self, ptr, idx, val, n_out, n_in, window):
        self.ptr, self.idx, self.val = ptr, idx, val
        self.n_out, self.n_in, self.window = int(n_out), int(n_in), \
            int(window)
        self.n_win = (ptr.shape[0] - 1) // max(1, self.n_out)
        self.lanes = lanes_per_row(idx.shape[0], self.n_win * self.n_out)

    def to(self, device):
        return WinCSR(self.ptr.to(device), self.idx.to(device),
                      self.val.to(device), self.n_out, self.n_in,
                      self.window)

    def tensors(self):
        return (self.ptr, self.idx, self.val)

    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def to_scipy(self):
        """The matrix as a scipy CSR (padding dropped), for tests."""
        ptr = self.ptr.cpu().numpy()
        idx = self.idx.cpu().numpy().view(np.uint16).astype(np.int64)
        val = self.val.cpu().numpy()
        seg = np.repeat(np.arange(ptr.shape[0] - 1), np.diff(ptr))
        rows = seg % max(1, self.n_out)
        cols = (seg // max(1, self.n_out)) * self.window + idx
        keep = val != 0
        return sps.csr_matrix((val[keep], (rows[keep], cols[keep])),
                              shape=(self.n_out, self.n_in))


def build_wincsr(X_csr, window=None):
    """The layout of a CSR matrix (rows = outputs, explicit zeros kept as
    entries) with windows of `window` inputs (default
    :func:`plan_window`). Vectorized NumPy; returns a :class:`WinCSR` of
    CPU tensors."""
    X = sps.csr_matrix(X_csr)
    X.sort_indices()
    n_out, n_in = X.shape
    W = plan_window(n_in) if window is None else int(window)
    if not 0 < W <= 65_536 or W % ALIGN:
        raise ValueError(f"window must be a multiple of {ALIGN} in "
                         f"(0, 65536], got {W}")
    n_win = max(1, -(-n_in // W))
    cols = X.indices.astype(np.int64)
    rows = np.repeat(np.arange(n_out, dtype=np.int64), np.diff(X.indptr))
    key = (cols // W) * n_out + rows
    cnt = np.bincount(key, minlength=n_win * n_out)
    ptr = np.zeros(n_win * n_out + 1, dtype=np.int64)
    np.cumsum(_ceil_to(cnt, ALIGN), out=ptr[1:])
    # CSR order is (row, column); a stable sort by segment keeps the
    # columns ascending within each segment.
    order = None if n_win == 1 else np.argsort(key, kind='stable')
    ks = key if order is None else key[order]
    first = np.cumsum(cnt) - cnt  # unpadded start of each segment
    dest = ptr[ks] + (np.arange(ks.shape[0], dtype=np.int64) - first[ks])
    idx = np.zeros(ptr[-1], dtype=np.uint16)
    val = np.zeros(ptr[-1], dtype=np.float32)
    c_sorted = cols if order is None else cols[order]
    d_sorted = X.data if order is None else X.data[order]
    idx[dest] = (c_sorted % W).astype(np.uint16)
    val[dest] = d_sorted.astype(np.float32)
    return WinCSR(torch.from_numpy(ptr), torch.from_numpy(idx.view(np.int16)),
                  torch.from_numpy(val), n_out, n_in, W)


def csr_from_winell(widx, wval, ell_idx, ell_val, shape, W, K):
    """The scipy CSR (rows = outputs) that a windowed-ELL packing and its
    spill ELL arrays encode: occupied slots are the nonzero values (the
    packer drops explicit zeros), padded ELL lanes hold value 0."""
    n_out, n_in = shape
    widx = np.asarray(widx)
    wval = np.asarray(wval, np.float32)
    T, _ = tile_block(n_out)
    slot, lane = np.nonzero(wval)
    cell = slot // K
    rows = (cell % T) * 128 + lane
    cols = (cell // T) * W + widx[slot, lane].astype(np.int64)
    data = wval[slot, lane]
    ell_val = np.asarray(ell_val, np.float32)
    if ell_val.size:
        r, k = np.nonzero(ell_val)
        rows = np.concatenate((rows, r))
        cols = np.concatenate((cols, np.asarray(ell_idx)[r, k]))
        data = np.concatenate((data, ell_val[r, k]))
    return sps.csr_matrix((data, (rows, cols)), shape=(n_out, n_in))
