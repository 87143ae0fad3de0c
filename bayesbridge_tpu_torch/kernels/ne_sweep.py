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

Their chain-batched forms serve k Markov chains from one read of the
blocks per launch (the JAX package's ``vmap`` over chains turns its dots
into k-column ones, ``multichain.py:34-53``): :func:`ne_rows_k` returns
``T = sum_b X_b V_b' + c`` as (k, n), :func:`colpass_k` ``[U X_b]`` as
(k, p_b). A launch serves up to 8 chains (``layout.batched_plan``, its
geometry; ``launches['rows_k']`` / ``['cols_k']`` count launches, each
one read of X); chain c's row equals its single-vector launch bit for
bit, and k = 1 is the single-vector launch itself. Their plain versions
run the single plain versions chain by chain.

The row and column passes take a packed int4 first block
(``layout.pack_int4``; the hybrid design's int4 tier): their nibble
modes, counted apart (``launches['rows_i4']`` / ``['cols_i4']``), which
replace the JAX package's XLA dots over its packed-s4 block. The
chain-batched forms have no nibble mode yet: over an int4 block they run
one single-vector launch per chain (``launches['rows_i4_k']`` /
``['cols_i4_k']``), each chain's result its single launch's bits. The
fused sweep (:func:`ne_sweep`, and the one-read kernel behind it) takes
no int4 block, as the JAX package's fused kernels do not
(``sparse.py:1052``).
"""

import torch

from . import layout
from . import ne_oneread as _oneread
from .build import count_launch, load_library

MIDS = {'ne': 0, 'logit': 1, 'linear': 2}
launches = {key: 0 for key in (*MIDS, 'rows', 'cols', 'rows_k', 'cols_k',
                                'rows_i4', 'cols_i4', 'rows_i4_k',
                                'cols_i4_k')}


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
    if any(layout.is_int4(X) for X, _ in blocks):
        raise TypeError("the fused sweeps take no packed int4 block "
                        "(sparse.py:1052): its design composes")
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
    if len(Xs) == 2 and layout.is_int4(Xs[1]):
        raise TypeError("a packed int4 block must be the first")
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
        v_pad = torch.zeros(layout.stored_columns(X), dtype=torch.float32,
                            device=device)
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
    t = _rows_launch(blocks, c)
    count_launch(launches, _key('rows', blocks[0][0]))
    return t


def _key(name, X0):
    """The launch counter of a pass over first block X0: its nibble
    mode's over a packed int4 block."""
    return name + '_i4' if layout.is_int4(X0) else name


def _rows_launch(blocks, c):
    """One launch of the row pass on checked CUDA blocks (uncounted)."""
    kl = load_library()
    device, n = blocks[0][0].device, blocks[0][0].shape[0]
    keep = []
    args = _block_args(blocks, device, keep)
    t = torch.empty(n, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_ne_rows(*args, n, c.data_ptr(),
                               0 if c.dim() == 0 else 1, t.data_ptr(),
                               stream)
    kl.check(rc, 'ne_rows')
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
    outs = _colpass_launch(Xs, ps, u)
    count_launch(launches, _key('cols', Xs[0]))
    return outs


def _colpass_launch(Xs, ps, u):
    """One launch of the column pass on checked CUDA blocks
    (uncounted)."""
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
    out = torch.empty(sum(ps), dtype=torch.float32, device=device)
    partial = torch.empty(n_seg * sum(ps), dtype=torch.float32,
                          device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_colpass(*args, n, u.data_ptr(), n_seg, rows_per_seg,
                               partial.data_ptr(), out.data_ptr(), stream)
    kl.check(rc, 'colpass')
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
    count_launch(launches, mid)
    outs = list(torch.split(out, widths))
    return outs, u, (lp[0] if with_logp else None)


# -- chain-batched forms ------------------------------------------------- #

def ne_rows_k_plain(blocks, c):
    """ne_rows_k chain by chain with the single plain version."""
    return torch.stack([ne_rows_plain([(X, V[i]) for X, V in blocks], c[i])
                        for i in range(c.shape[0])])


def ne_rows_k(blocks, c):
    """The row pass for k chains: ``T[i] = sum_b X_b V_b[i] + c[i]``, (k,
    n) float32.

    Parameters
    ----------
    blocks : one or two (X_b, V_b): X_b as for :func:`ne_sweep` (a second
        block float32), V_b (k, p_b) float32
    c : (k,) per-chain row offset, or (k, n)
    """
    device, n = _check_blocks([X for X, _ in blocks],
                              [V.shape[1] for _, V in blocks])
    layout.check_second_block([X for X, _ in blocks])
    k = c.shape[0]
    layout.check_chains('ne_rows_k', device, k, *(V for _, V in blocks))
    if c.dim() != 1:
        layout.check_chains('ne_rows_k', device, k, c)
        if c.shape[1] != n:
            raise ValueError(f"c must be (k,) or (k, {n})")
    elif c.dtype != torch.float32 or c.device != device:
        raise ValueError("c must be float32 on the blocks' device")
    if not _on_cuda(device, 'ne_rows_k'):
        return ne_rows_k_plain(blocks, c)
    if k == 1:
        return ne_rows([(X, V[0]) for X, V in blocks], c[0])[None]
    if layout.is_int4(blocks[0][0]):  # no chain-batched nibble mode
        T = torch.stack([_rows_launch([(X, V[i]) for X, V in blocks], c[i])
                         for i in range(k)])
        count_launch(launches, 'rows_i4_k', k)
        return T
    plan = layout.batched_plan('rows', [X.dtype for X, _ in blocks], k)
    T, n_launch = rows_k_launches(load_library(), plan.chains, blocks, c)
    count_launch(launches, 'rows_k', n_launch)
    return T


def rows_k_launches(kl, cmax, blocks, c):
    """((k, n) T, launches) of the batched row pass from library `kl`, in
    launches of at most `cmax` chains."""
    X0 = blocks[0][0]
    device, n = X0.device, X0.shape[0]
    k = c.shape[0]
    args = []
    for i, (X, V) in enumerate(blocks):
        layout.check_cuda_layout(X, f"X{i}")
        V_pad = torch.zeros((k, X.shape[1]), dtype=torch.float32,
                            device=device)
        V_pad[:, :V.shape[1]] = V
        args.append((X, V_pad, V.shape[1]))
    if len(args) == 1:
        args.append((None, None, 0))
    c = c.contiguous()
    c_chain, c_stride = (1, 0) if c.dim() == 1 else (n, 1)
    T = torch.empty((k, n), dtype=torch.float32, device=device)
    (X0, V0, p0), (X1, V1, p1) = args
    stream = torch.cuda.current_stream(device).cuda_stream
    groups = layout.chain_groups(k, cmax)
    for c0, nc in groups:
        with torch.cuda.device(device):
            rc = kl.lib.bb_ne_rows_k(
                layout.DTYPE_CODE[X0.dtype], X0.data_ptr(), X0.shape[1], p0,
                layout.elem_ptr(V0, c0 * X0.shape[1]),
                None if X1 is None else X1.data_ptr(),
                0 if X1 is None else X1.shape[1], p1,
                None if V1 is None
                else layout.elem_ptr(V1, c0 * X1.shape[1]), n, nc,
                layout.elem_ptr(c, c0 * c_chain), c_chain, c_stride,
                layout.elem_ptr(T, c0 * n), stream)
        kl.check(rc, 'ne_rows_k')
    return T, len(groups)


def colpass_k_plain(Xs, ps, U):
    """colpass_k chain by chain with the single plain version."""
    per = [colpass_plain(Xs, ps, u) for u in U]
    return [torch.stack([outs[b] for outs in per]) for b in range(len(Xs))]


def colpass_k(Xs, ps, U):
    """The column pass for k chains: ``[U X_b[:, :p_b]]``, each (k, p_b)
    float32, for one or two stored blocks (a second block float32) and U
    (k, n) float32."""
    device, n = _check_blocks(Xs, ps)
    layout.check_second_block(Xs)
    k = U.shape[0]
    layout.check_chains('colpass_k', device, k, U)
    if U.shape[1] != n:
        raise ValueError(f"U must be (k, {n})")
    if not _on_cuda(device, 'colpass_k'):
        return colpass_k_plain(Xs, ps, U)
    if k == 1:
        return [o[None] for o in colpass(Xs, ps, U[0])]
    if layout.is_int4(Xs[0]):  # no chain-batched nibble mode
        per = [_colpass_launch(Xs, ps, u) for u in U]
        count_launch(launches, 'cols_i4_k', k)
        return [torch.stack([outs[b] for outs in per])
                for b in range(len(Xs))]
    plan = layout.batched_plan('cols', [X.dtype for X in Xs], k)
    out, n_launch = batched_colpass('colpass_k', Xs, ps, n, [U], 1,
                                    load_library(), plan.chains)
    count_launch(launches, 'cols_k', n_launch)
    return list(torch.split(out[:, 0], list(ps), dim=1))


def batched_colpass(name, Xs, ps, n, Us, R, kl, cmax):
    """((k, R, sum(ps)), launches) of the chain-batched column pass with R
    reductions (1: X'u of one (k, n) vector in `Us`; 4 or 5: the
    pre-solve's of three or four) from library `kl`, in launches of at
    most `cmax` chains, each over the single-vector launch's row
    segments."""
    device = Xs[0].device
    k = Us[0].shape[0]
    for i, X in enumerate(Xs):
        layout.check_cuda_layout(X, f"X{i}")
    tiles = sum(layout.col_tiles(p, X) for X, p in zip(Xs, ps))
    n_seg, rows_per_seg = layout.segments(n, tiles, device)
    dt0 = layout.DTYPE_CODE[Xs[0].dtype]
    p_total = sum(ps)
    out = torch.empty((k, R, p_total), dtype=torch.float32, device=device)
    partial = torch.empty(n_seg * min(cmax, k) * R * p_total,
                          dtype=torch.float32, device=device)
    X1 = Xs[1] if len(Xs) == 2 else None
    fn = kl.lib.bb_colpass_k if R == 1 else kl.lib.bb_tdots_sweep_k
    stream = torch.cuda.current_stream(device).cuda_stream
    groups = layout.chain_groups(k, cmax)
    for c0, nc in groups:
        us = [layout.elem_ptr(U, c0 * n) for U in Us]
        if R != 1:
            us += [None] * (4 - len(us))
        with torch.cuda.device(device):
            rc = fn(dt0, Xs[0].data_ptr(), Xs[0].shape[1], ps[0],
                    None if X1 is None else X1.data_ptr(),
                    0 if X1 is None else X1.shape[1],
                    0 if X1 is None else ps[1], n, nc, *us, n_seg,
                    rows_per_seg, partial.data_ptr(),
                    layout.elem_ptr(out, c0 * R * p_total), stream)
        kl.check(rc, name)
    return out, len(groups)
