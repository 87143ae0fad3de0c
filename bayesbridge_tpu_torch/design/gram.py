"""Row-chunked weighted Gram products of the Cholesky path.

Port of ``bayesbridge_tpu/design/sparse.py`` ``_chunked_gram``
(:143-180), shared by the hybrid and the dense designs. The products run
on ``torch.matmul`` (cuBLAS on the card: the JAX package's XLA dots, not
Pallas) in full float32 or in float64, whatever the process's TF32
setting: the Gram feeds the Cholesky factor.
"""

import os

import torch

from ..kernels.layout import CHUNK_BYTES
from ..utils.dtypes import full_float32


def chunked_gram(chunk_fn, m, p, w, dtype):
    """(Z' W Z, Z' w) of an m x p design whose rows ``chunk_fn(start,
    size)`` gives as a (size, p) panel in `dtype`, over row chunks that
    bound the w-scaled transient to ``BB_GRAM_CHUNK_BYTES`` (default
    2**28): n any, p Cholesky-sized. Chunk starts are clamped (the last
    chunk re-reads rows the one before covered) and the overlap is
    masked out of the weights, so every row counts once."""
    budget = int(os.environ.get('BB_GRAM_CHUNK_BYTES', 2 ** 28))
    itemsize = torch.empty((), dtype=dtype).element_size()
    c = max(256, budget // max(1, 2 * p * itemsize))
    c = min(m, -(-c // 8) * 8)
    k = -(-m // c)
    with full_float32():
        if k <= 1:
            Z = chunk_fn(0, m)
            return Z.T @ (w[:, None] * Z), Z.T @ w
        G = torch.zeros((p, p), dtype=dtype, device=w.device)
        s = torch.zeros(p, dtype=dtype, device=w.device)
        rows = torch.arange(c, device=w.device)
        for i in range(k):
            start = min(i * c, m - c)
            wb = w[start:start + c] * (start + rows >= i * c).to(dtype)
            Z = chunk_fn(start, c)
            G += Z.T @ (wb[:, None] * Z)
            s += Z.T @ wb
        return G, s


def squared_col_moment(X, w):
    """(X . X)' w in X's dtype, squaring row chunks of at most
    ``CHUNK_BYTES``."""
    step = max(1, CHUNK_BYTES // max(1, X.shape[1] * X.element_size()))
    out = None
    for i in range(0, X.shape[0], step):
        Xc = X[i:i + step]
        part = (Xc * Xc).T @ w[i:i + step]
        out = part if out is None else out + part
    return out
