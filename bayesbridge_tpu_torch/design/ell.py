"""CSR -> padded ELL conversion (host side, one-time data preparation).

Port of ``bayesbridge_tpu/design/ell.py`` ``csr_to_ell`` (its NumPy
path). The winell backend stores its spill matrices this way: every row
padded to the longest row, padding index `pad_value` with value 0, so a
padded gather lane adds exactly zero.
"""

import numpy as np


def csr_to_ell(indptr, indices, data, n_cols, pad_value=0):
    """(ell_idx, ell_val) of shape (n_rows, max(1, k_max)), k_max the
    longest row; `n_cols` is kept for the JAX signature."""
    n_rows = len(indptr) - 1
    row_len = np.diff(indptr)
    k_max = int(row_len.max()) if n_rows > 0 and row_len.size else 0
    k_max = max(k_max, 1)
    ell_idx = np.full((n_rows, k_max), pad_value, dtype=np.int32)
    ell_val = np.zeros((n_rows, k_max), dtype=data.dtype)
    slot = np.arange(k_max)[None, :]
    valid = slot < row_len[:, None]
    flat_pos = (indptr[:-1, None] + slot)[valid]
    ell_idx[valid] = indices[flat_pos]
    ell_val[valid] = data[flat_pos]
    return ell_idx, ell_val
