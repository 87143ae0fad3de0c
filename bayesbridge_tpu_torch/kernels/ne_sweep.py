"""Fused normal-equations / GLM-link sweep: wrapper and plain version.

Counterpart of ``bayesbridge_tpu/design/fusedne.py`` ``_run`` /
``fused_ne_matvec`` / ``fused_ne_matvec2`` / ``fused_link_matvec``
(Pallas kernel ``_ne_kernel``). For one or two row-aligned blocks
``[(X_b, v_b)]`` it computes

    t = sum_b X_b[:, :p_b] v_b + c        (p_b = len(v_b))
    u = mid(t; a, b)     'ne': b t   'logit': a - b sigmoid(t)
                         'linear': b (a - t)
    out_b = X_b[:, :p_b]' u
    logp  = sum of the log-likelihood rows ('logit' / 'linear',
            with_logp=True)

and returns ``(outs, u, logp)``. On a CUDA tensor :func:`ne_sweep`
launches a hand-written kernel (or raises); on a CPU tensor it runs
:func:`ne_sweep_plain`. Every mode takes the one-read kernel of
:mod:`.ne_oneread` (``csrc/ne_oneread.cu``, counted there per mode)
wherever its plan fits the blocks, else the two-pass kernel of
``csrc/ne_sweep.cu``; ``launches[mid]`` counts the two-pass kernel's
launches. ``route`` forces either.

Its two passes are entries of their own, the hybrid design's composed
products (the JAX package's XLA dots ``Xe @ v`` and ``Xe.T @ u``,
``sparse.py:984-1037``): :func:`ne_rows` returns ``t = sum_b X_b v_b + c``
(the row pass, ``launches['rows']``) and :func:`colpass` returns
``[X_b' u]`` (the column pass, ``launches['cols']``).
"""

import torch

from . import layout
from . import ne_oneread as _oneread
from .build import load_library

MIDS = {'ne': 0, 'logit': 1, 'linear': 2}
launches = {key: 0 for key in (*MIDS, 'rows', 'cols')}


def _row_map(t, a, b, mid, with_logp):
    if mid == 'ne':
        return b * t, None
    if mid == 'logit':
        u = a - b * torch.sigmoid(t)
        lp = a * t - b * (torch.clamp_min(t, 0.0)
                          + torch.log1p(torch.exp(-t.abs()))) \
            if with_logp else None
        return u, lp
    resid = a - t
    return b * resid, (-0.5 * b * resid * resid if with_logp else None)


def ne_sweep_plain(blocks, c, a, b, mid='ne', with_logp=False):
    """The sweep in plain PyTorch (float32, blocks up-converted in row
    chunks). Same arguments and results as :func:`ne_sweep`."""
    t = None
    for X, v in blocks:
        part = layout.matvec(X, v.shape[0], v)
        t = part if t is None else t + part
    u, lp_rows = _row_map(t + c, a, b, mid, with_logp)
    outs = [layout.rmatvec(X, v.shape[0], u) for X, v in blocks]
    return outs, u, (lp_rows.sum() if with_logp else None)


ROUTES = (None, 'oneread', 'twopass')


def ne_sweep(blocks, c, a, b, mid='ne', with_logp=False, route=None):
    """(outs, u, logp) of the sweep; see the module docstring.

    Parameters
    ----------
    blocks : one or two (X_b, v_b): X_b (n, ld_b) int8/bf16/f32 stored
        block, v_b (p_b,) float32 with p_b <= ld_b
    c : (n,) float32, or a 0-d float32 tensor added to every row
    a : (n,) float32 ('logit' / 'linear'), or None for 'ne'
    b : (n,) float32 row weights
    route : None (the one-read kernel where its plan fits, else
        two-pass), 'oneread' (raises where no plan fits) or 'twopass';
        read on CUDA tensors only
    """
    if mid not in MIDS:
        raise ValueError(f"mid must be one of {sorted(MIDS)}, got {mid!r}")
    if with_logp and mid == 'ne':
        raise ValueError("with_logp needs a 'logit' or 'linear' mid")
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    device, n = check_sweep_args(blocks, c, b)
    if mid != 'ne':
        layout.check_vector(a, n, 'a', device)
    if not _on_cuda(device, 'ne_sweep'):
        return ne_sweep_plain(blocks, c, a, b, mid, with_logp)
    if route != 'twopass' and (
            route == 'oneread' or _oneread.block_plan(blocks) is not None):
        if mid == 'ne':
            outs, u = _oneread.ne_oneread(blocks, c, b)
            return outs, u, None
        return _oneread.ne_oneread_link(blocks, c, a, b, mid, with_logp)
    return _ne_sweep_cuda(blocks, c, a, b, mid, with_logp)


def check_sweep_args(blocks, c, w):
    """(device, n) of the blocks after checking them, their vectors, the
    row offset `c` and the row weights `w`."""
    device, n = _check_blocks([X for X, _ in blocks],
                              [v.shape[0] for _, v in blocks])
    for i, (_, v) in enumerate(blocks):
        layout.check_vector(v, v.shape[0], f"v{i}", device)
    layout.check_vector(w, n, 'b', device)
    _check_c(c, n, device)
    return device, n


def _check_blocks(Xs, ps):
    """(device, n) of one or two row-aligned stored blocks."""
    if not 1 <= len(Xs) == len(ps) <= 2:
        raise ValueError("one or two blocks, each with its width")
    device, n = Xs[0].device, Xs[0].shape[0]
    for i, (X, p) in enumerate(zip(Xs, ps)):
        if X.device != device or X.shape[0] != n:
            raise ValueError("blocks must share the device and row count")
        layout.check_block(X, p, f"X{i}")
    return device, n


def _check_c(c, n, device):
    if c.dim() == 0:
        if c.dtype != torch.float32 or c.device != device:
            raise ValueError("scalar c must be float32 on the blocks' "
                             "device")
    else:
        layout.check_vector(c, n, 'c', device)


def _on_cuda(device, name):
    if device.type == 'cpu':
        return False
    if device.type != 'cuda':
        raise ValueError(f"no {name} for device {device}")
    return True


def _block_args(blocks, device, keep):
    """C arguments (dt, X, ld, p, v_pad) of two block slots (the second
    empty for one block); `keep` holds the padded vectors alive."""
    args = []
    for i, (X, v) in enumerate(list(blocks) + [(None, None)] * (
            2 - len(blocks))):
        if X is None:
            args += [0, None, 0, 0, None]
            continue
        layout.check_cuda_layout(X, f"X{i}")
        v_pad = torch.zeros(X.shape[1], dtype=torch.float32, device=device)
        v_pad[:v.shape[0]] = v
        keep.append(v_pad)
        args += [layout.DTYPE_CODE[X.dtype], X.data_ptr(), X.shape[1],
                 v.shape[0], v_pad.data_ptr()]
    return args


def ne_rows_plain(blocks, c):
    """t = sum_b X_b[:, :p_b] v_b + c in plain PyTorch."""
    t = None
    for X, v in blocks:
        part = layout.matvec(X, v.shape[0], v)
        t = part if t is None else t + part
    return t + c


def ne_rows(blocks, c):
    """The row pass alone: t = sum_b X_b v_b + c, (n,) float32. `blocks`
    and `c` as for :func:`ne_sweep`."""
    device, n = _check_blocks([X for X, _ in blocks],
                              [v.shape[0] for _, v in blocks])
    for i, (_, v) in enumerate(blocks):
        layout.check_vector(v, v.shape[0], f"v{i}", device)
    _check_c(c, n, device)
    if not _on_cuda(device, 'ne_rows'):
        return ne_rows_plain(blocks, c)
    kl = load_library()
    keep = []
    args = _block_args(blocks, device, keep)
    t = torch.empty(n, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_ne_rows(*args, n, c.data_ptr(),
                               0 if c.dim() == 0 else 1, t.data_ptr(),
                               stream)
    kl.check(rc, 'ne_rows')
    launches['rows'] += 1
    return t


def colpass_plain(Xs, ps, u):
    """[X_b[:, :p_b]' u] in plain PyTorch."""
    return [layout.rmatvec(X, p, u) for X, p in zip(Xs, ps)]


def colpass(Xs, ps, u):
    """The column pass alone: [X_b[:, :p_b]' u] for one or two stored
    blocks with logical widths `ps`, u (n,) float32."""
    device, n = _check_blocks(Xs, ps)
    layout.check_vector(u, n, 'u', device)
    if not _on_cuda(device, 'colpass'):
        return colpass_plain(Xs, ps, u)
    kl = load_library()
    args, tiles = [], 0
    for i, (X, p) in enumerate(zip(Xs, ps)):
        layout.check_cuda_layout(X, f"X{i}")
        args += [layout.DTYPE_CODE[X.dtype], X.data_ptr(), X.shape[1], p]
        tiles += layout.col_tiles(p, X)
    if len(Xs) == 1:
        args += [0, None, 0, 0]
    n_seg, rows_per_seg = layout.segments(n, tiles, device)
    out = torch.empty(sum(ps), dtype=torch.float32, device=device)
    partial = torch.empty(n_seg * sum(ps), dtype=torch.float32,
                          device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_colpass(*args, n, u.data_ptr(), n_seg, rows_per_seg,
                               partial.data_ptr(), out.data_ptr(), stream)
    kl.check(rc, 'colpass')
    launches['cols'] += 1
    return list(torch.split(out, list(ps)))


def _ne_sweep_cuda(blocks, c, a, b, mid, with_logp):
    kl = load_library()
    X0 = blocks[0][0]
    device, n = X0.device, X0.shape[0]
    # The padded operands must live until the launch below; after it the
    # caching allocator reuses freed blocks only in this stream's order,
    # so scratch may be released on return.
    keep = []
    args = _block_args(blocks, device, keep)
    widths = [v.shape[0] for _, v in blocks]
    tiles = sum(layout.col_tiles(v.shape[0], X) for X, v in blocks)
    n_seg, rows_per_seg = layout.segments(n, tiles, device)
    p_total = sum(widths)
    u = torch.empty(n, dtype=torch.float32, device=device)
    out = torch.empty(p_total, dtype=torch.float32, device=device)
    partial = torch.empty(n_seg * p_total, dtype=torch.float32,
                          device=device)
    lp_partial = lp = None
    if with_logp:
        grid_a = -(-n // kl.rows_per_block)
        lp_partial = torch.empty(grid_a, dtype=torch.float32, device=device)
        lp = torch.empty(1, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_ne_sweep(
            *args, n, c.data_ptr(), 0 if c.dim() == 0 else 1,
            None if a is None else a.data_ptr(), b.data_ptr(), MIDS[mid],
            int(with_logp), u.data_ptr(), n_seg, rows_per_seg,
            partial.data_ptr(), out.data_ptr(),
            None if lp_partial is None else lp_partial.data_ptr(),
            None if lp is None else lp.data_ptr(), stream)
    kl.check(rc, 'ne_sweep')
    launches[mid] += 1
    outs = list(torch.split(out, widths))
    return outs, u, (lp[0] if with_logp else None)
