"""CSR -> padded ELL conversion (host side, one-time data preparation).

Port of ``bayesbridge_tpu/design/ell.py`` (its NumPy path): every row
padded to the longest row, padding index `pad_value` with value 0, so a
padded gather lane adds exactly zero. The ell backend stores X and X'
this way (:func:`dual_ell_from_scipy`), the winell backend its spill
matrices.
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


def dual_ell_from_scipy(X_csr, dtype):
    """((row_idx, row_val), (col_idx, col_val)): the row-ELL of X and the
    row-ELL of X' (ell.py:47-59), values in `dtype`, explicit zeros kept
    as entries."""
    X_csr = X_csr.tocsr()
    X_csc = X_csr.tocsc()
    rows = csr_to_ell(X_csr.indptr, X_csr.indices,
                      X_csr.data.astype(dtype), X_csr.shape[1])
    cols = csr_to_ell(X_csc.indptr, X_csc.indices,
                      X_csc.data.astype(dtype), X_csc.shape[0])
    return rows, cols
