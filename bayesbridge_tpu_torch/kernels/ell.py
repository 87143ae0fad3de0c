"""Row-ELL matvec for up to 8 vectors: wrapper and plain version.

The ell design backend's product (:mod:`..design.ell`). For row-ELL
arrays ``idx`` (m, width) int32 and ``val`` (m, width) of an (m, n_in)
matrix A (every row padded with index 0, value 0) and k vectors X (k,
n_in) it computes

    out[c, r] = sum_s val[r, s] ** power * X[c, idx[r, s]]

with power 1 (A x) or 2 (the Fisher diagonal's second moment). It
replaces the XLA gathers of the JAX package's ell backend
(``bayesbridge_tpu/design/sparse.py:1006-1008, :1033-1036, :1535-1537``;
no Pallas kernel).

On a CUDA tensor :func:`ell_matvec_k` launches the hand-written kernel
of ``csrc/ell.cu`` (or raises), on a CPU tensor it runs
:func:`ell_matvec_k_plain`. One launch serves up to 8 vectors, handed to
the kernel interleaved (X' contiguous, one index's values side by side);
more take ceil(k / 8) launches. Each vector's result is the bits of its
single-vector launch. ``launches[tag]`` counts the kernel launches per
orientation ('dot' on the row-ELL, 'tdot' on the col-ELL).
"""

import torch

from .build import load_library

launches = {'dot': 0, 'tdot': 0}
MAX_VECTORS = 8  # vectors per launch (csrc/ell.cu kMaxVectors)


def ell_matvec_k_plain(idx, val, X, power=1):
    """The product in plain PyTorch: gather, multiply, sum over the
    slots. Same arguments as :func:`ell_matvec_k`."""
    a = val * val if power == 2 else val
    return (a * X[..., idx.long()]).sum(-1)


def ell_matvec_k(idx, val, X, power=1, tag='dot'):
    """out (m,) for X (n_in,), or (k, m) for X (k, n_in); see the module
    docstring.

    Parameters
    ----------
    idx : (m, width) int32, contiguous
    val : (m, width) float32 or float64, contiguous
    X : (n_in,) or (k, n_in) of val's dtype, contiguous, on val's device
    power : 1 or 2
    tag : 'dot' | 'tdot', the launch counter to advance
    """
    if tag not in launches:
        raise ValueError(f"tag must be one of {sorted(launches)}")
    if power not in (1, 2):
        raise ValueError(f"power must be 1 or 2, got {power}")
    if idx.dtype != torch.int32 or val.dtype not in (torch.float32,
                                                     torch.float64) \
            or idx.dim() != 2 or idx.shape != val.shape \
            or not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("the ELL arrays need contiguous int32 idx and "
                         "float32 or float64 val of one (m, width) shape")
    if X.dtype != val.dtype or X.dim() not in (1, 2) \
            or not X.is_contiguous() \
            or len({idx.device, val.device, X.device}) != 1:
        raise ValueError(f"X must be a contiguous {val.dtype} vector or "
                         f"(k, n_in) matrix on {val.device}")
    if X.device.type == 'cpu':
        return ell_matvec_k_plain(idx, val, X, power)
    if X.device.type != 'cuda':
        raise ValueError(f"no ell_matvec_k for device {X.device}")
    if X.dim() == 1:
        return _ell_cuda(idx, val, X[None], power, tag)[0]
    return torch.cat([_ell_cuda(idx, val, X[c:c + MAX_VECTORS], power, tag)
                      for c in range(0, X.shape[0], MAX_VECTORS)])


def _ell_cuda(idx, val, X, power, tag):
    m, width = idx.shape
    k, n_in = X.shape
    out = torch.empty((k, m), dtype=val.dtype, device=X.device)
    if m == 0 or k == 0:
        return out
    if n_in == 0 or width == 0:  # no entry to gather
        return out.zero_()
    kl = load_library()
    Xt = X.t().contiguous()  # (n_in, k): one index's values side by side
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = kl.lib.bb_ell(idx.data_ptr(), val.data_ptr(), m, width,
                           Xt.data_ptr(), k, power,
                           int(val.dtype == torch.float64), out.data_ptr(),
                           stream)
    kl.check(rc, 'ell_matvec_k')
    launches[tag] += 1
    return out
