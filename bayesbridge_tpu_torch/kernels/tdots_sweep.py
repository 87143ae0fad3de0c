"""Pre-solve reduction sweep: wrapper and plain version.

Counterpart of ``bayesbridge_tpu/design/fusedne.py`` ``fused_tdots``
(Pallas kernel ``_tdots_kernel``). For one or two row-aligned stored
blocks with logical widths ``ps`` it returns, per block, the four
``(p_b,)`` float32 vectors

    X_b' u1,  X_b' u2,  X_b' u3,  (X_b . X_b)' u3  [,  X_b' u4]

from one read of the blocks. The optional fifth reduction is the
composed path's pre-solve (``sparse.py:1325-1388``, the JAX package's
multi-RHS dot with the warm start's column). On a CUDA tensor
:func:`tdots_sweep` launches the hand-written kernel of
``csrc/tdots_sweep.cu`` (or raises); on a CPU tensor it runs
:func:`tdots_sweep_plain`. ``launches['tdots']`` and ``launches['u4']``
count the kernel's launches with four and with five reductions.
"""

import torch

from . import layout
from .build import load_library

launches = {'tdots': 0, 'u4': 0}


def tdots_sweep_plain(Xs, ps, u1, u2, u3, u4=None):
    """The reductions in plain PyTorch (float32, row-chunked)."""
    U = torch.stack((u1, u2, u3) + ((u4,) if u4 is not None else ()),
                    dim=1)
    outs = []
    for X, p in zip(Xs, ps):
        R = layout.rmatvec(X, p, U)
        sq = layout.rmatvec(X, p, u3, square=True)
        outs.append((R[:, 0], R[:, 1], R[:, 2], sq)
                    + ((R[:, 3],) if u4 is not None else ()))
    return outs


def tdots_sweep(Xs, ps, u1, u2, u3, u4=None):
    """Per block (X'u1, X'u2, X'u3, (X.X)'u3[, X'u4]); see the module
    docstring.

    Parameters
    ----------
    Xs : one or two (n, ld_b) int8/bf16/f32 stored blocks
    ps : their logical widths p_b <= ld_b
    u1, u2, u3 : (n,) float32
    u4 : (n,) float32 or None
    """
    if not 1 <= len(Xs) == len(ps) <= 2:
        raise ValueError("one or two blocks, each with its width")
    device = Xs[0].device
    n = Xs[0].shape[0]
    for i, (X, p) in enumerate(zip(Xs, ps)):
        if X.device != device or X.shape[0] != n:
            raise ValueError("blocks must share the device and row count")
        layout.check_block(X, p, f"X{i}")
    us = (u1, u2, u3) + ((u4,) if u4 is not None else ())
    for i, u in enumerate(us):
        layout.check_vector(u, n, f'u{i + 1}', device)
    if device.type == 'cpu':
        return tdots_sweep_plain(Xs, ps, u1, u2, u3, u4)
    if device.type != 'cuda':
        raise ValueError(f"no tdots_sweep for device {device}")
    return _tdots_sweep_cuda(Xs, ps, u1, u2, u3, u4)


def _tdots_sweep_cuda(Xs, ps, u1, u2, u3, u4):
    kl = load_library()
    device, n = Xs[0].device, Xs[0].shape[0]
    args, tiles = [], 0
    for i, (X, p) in enumerate(zip(Xs, ps)):
        layout.check_cuda_layout(X, f"X{i}")
        args += [layout.DTYPE_CODE[X.dtype], X.data_ptr(), X.shape[1], p]
        tiles += layout.col_tiles(p, X)
    if len(Xs) == 1:
        args += [0, None, 0, 0]
    n_seg, rows_per_seg = layout.segments(n, tiles, device)
    p_total = sum(ps)
    k_red = 4 if u4 is None else 5
    out = torch.empty((k_red, p_total), dtype=torch.float32, device=device)
    partial = torch.empty(n_seg * k_red * p_total, dtype=torch.float32,
                          device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_tdots_sweep(
            *args, n, u1.data_ptr(), u2.data_ptr(), u3.data_ptr(),
            None if u4 is None else u4.data_ptr(), n_seg, rows_per_seg,
            partial.data_ptr(), out.data_ptr(), stream)
    kl.check(rc, 'tdots_sweep')
    launches['tdots' if u4 is None else 'u4'] += 1
    outs, off = [], 0
    for p in ps:
        blk = out[:, off:off + p]
        outs.append(tuple(blk[k] for k in range(k_red)))
        off += p
    return outs
