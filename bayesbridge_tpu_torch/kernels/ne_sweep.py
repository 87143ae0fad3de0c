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
launches the hand-written kernel of ``csrc/ne_sweep.cu`` (or raises); on a
CPU tensor it runs :func:`ne_sweep_plain`. ``launches[mid]`` counts the
kernel launches.
"""

import torch

from . import layout
from .build import load_library

MIDS = {'ne': 0, 'logit': 1, 'linear': 2}
launches = {mid: 0 for mid in MIDS}


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


def ne_sweep(blocks, c, a, b, mid='ne', with_logp=False):
    """(outs, u, logp) of the sweep; see the module docstring.

    Parameters
    ----------
    blocks : one or two (X_b, v_b): X_b (n, ld_b) int8/bf16/f32 stored
        block, v_b (p_b,) float32 with p_b <= ld_b
    c : (n,) float32, or a 0-d float32 tensor added to every row
    a : (n,) float32 ('logit' / 'linear'), or None for 'ne'
    b : (n,) float32 row weights
    """
    if mid not in MIDS:
        raise ValueError(f"mid must be one of {sorted(MIDS)}, got {mid!r}")
    if with_logp and mid == 'ne':
        raise ValueError("with_logp needs a 'logit' or 'linear' mid")
    if not 1 <= len(blocks) <= 2:
        raise ValueError("one or two blocks")
    X0 = blocks[0][0]
    device = X0.device
    n = X0.shape[0]
    for i, (X, v) in enumerate(blocks):
        if X.device != device or X.shape[0] != n:
            raise ValueError("blocks must share the device and row count")
        layout.check_block(X, v.shape[0], f"X{i}")
        layout.check_vector(v, v.shape[0], f"v{i}", device)
    layout.check_vector(b, n, 'b', device)
    if mid != 'ne':
        layout.check_vector(a, n, 'a', device)
    if c.dim() == 0:
        if c.dtype != torch.float32 or c.device != device:
            raise ValueError("scalar c must be float32 on the blocks' "
                             "device")
    else:
        layout.check_vector(c, n, 'c', device)
    if device.type == 'cpu':
        return ne_sweep_plain(blocks, c, a, b, mid, with_logp)
    if device.type != 'cuda':
        raise ValueError(f"no ne_sweep for device {device}")
    return _ne_sweep_cuda(blocks, c, a, b, mid, with_logp)


def _ne_sweep_cuda(blocks, c, a, b, mid, with_logp):
    kl = load_library()
    X0 = blocks[0][0]
    device, n = X0.device, X0.shape[0]
    args, widths, tiles = [], [], 0
    # The padded operands must live until the launch below; after it the
    # caching allocator reuses freed blocks only in this stream's order,
    # so scratch may be released on return.
    keep = []
    for i, (X, v) in enumerate(list(blocks) + [(None, None)] * (
            2 - len(blocks))):
        if X is None:
            args += [0, None, 0, 0, None]
            continue
        layout.check_cuda_layout(X, f"X{i}")
        p = v.shape[0]
        v_pad = torch.zeros(X.shape[1], dtype=torch.float32, device=device)
        v_pad[:p] = v
        keep.append(v_pad)
        args += [layout.DTYPE_CODE[X.dtype], X.data_ptr(), X.shape[1], p,
                 v_pad.data_ptr()]
        widths.append(p)
        tiles += layout.col_tiles(p, X)
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
