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

:func:`tdots_sweep_k` runs the reductions for k Markov chains, up to 8
of them per read of the blocks (``layout.batched_plan``;
``launches['tdots_k']`` / ``['u4_k']`` count the launches), each chain's
columns equal to its single-vector launch bit for bit; k = 1 is the
single-vector launch. The JAX package gets this form from ``vmap`` of
``fused_tdots`` over its chains.

A packed int4 first block (``layout.pack_int4``) beside an f32 block
takes the nibble pre-solve (``launches['i4']`` / ``['u4_i4']``), which
replaces the JAX package's multi-RHS dot over its packed-s4 block
(``sparse.py:1325-1368``); its squares (at most 64) are exact in
float32. With ``binary=True`` (a block of 0/1 values only) it takes the
binary mode (``launches['i4_bin']`` / ``['u4_i4_bin']``): the square
row is X'u3, as the JAX package reuses its column 3 for a binary block;
the plain version ignores the flag (its square equals X'u3 on 0/1
values). Both give the int8 mode's bits on the same values
(``layout.presolve_i4_plan``). :func:`tdots_sweep_k` has no
chain-batched nibble mode: over an int4 block it runs one single-vector
launch per chain (the keys with ``_k``).
"""

import torch

from . import layout
from .build import count_launch, load_library
from .ne_sweep import batched_colpass

launches = {'tdots': 0, 'u4': 0, 'tdots_k': 0, 'u4_k': 0, 'i4': 0,
            'u4_i4': 0, 'i4_k': 0, 'u4_i4_k': 0, 'i4_bin': 0,
            'u4_i4_bin': 0, 'i4_bin_k': 0, 'u4_i4_bin_k': 0}


def _key(u4, int4, chains=False, binary=False):
    """The launch counter: four or five reductions (`u4`), over a packed
    int4 first block or not (in binary mode or not), per chain of a batch
    (`chains`)."""
    if not int4:
        key = 'tdots' if u4 is None else 'u4'
    else:
        key = ('i4' if u4 is None else 'u4_i4') + ('_bin' if binary else '')
    return key + '_k' if chains else key


def _check_binary(Xs, binary):
    if binary and not layout.is_int4(Xs[0]):
        raise ValueError("binary: the mode of a packed int4 first block")


def tdots_sweep_plain(Xs, ps, u1, u2, u3, u4=None, binary=False):
    """The reductions in plain PyTorch (float32, row-chunked); `binary`
    is ignored (the square equals X'u3 on 0/1 values)."""
    U = torch.stack((u1, u2, u3) + ((u4,) if u4 is not None else ()),
                    dim=1)
    outs = []
    for X, p in zip(Xs, ps):
        R = layout.rmatvec(X, p, U)
        sq = layout.rmatvec(X, p, u3, square=True)
        outs.append((R[:, 0], R[:, 1], R[:, 2], sq)
                    + ((R[:, 3],) if u4 is not None else ()))
    return outs


def tdots_sweep(Xs, ps, u1, u2, u3, u4=None, binary=False):
    """Per block (X'u1, X'u2, X'u3, (X.X)'u3[, X'u4]); see the module
    docstring.

    Parameters
    ----------
    Xs : one or two (n, ld_b) int8/bf16/f32 stored blocks (the first may
        be a packed int4 one)
    ps : their logical widths p_b <= ld_b
    u1, u2, u3 : (n,) float32
    u4 : (n,) float32 or None
    binary : the first block is packed int4 and holds only 0/1
    """
    if not 1 <= len(Xs) == len(ps) <= 2:
        raise ValueError("one or two blocks, each with its width")
    device = Xs[0].device
    n = Xs[0].shape[0]
    for i, (X, p) in enumerate(zip(Xs, ps)):
        if X.device != device or X.shape[0] != n:
            raise ValueError("blocks must share the device and row count")
        layout.check_block(X, p, f"X{i}")
    if len(Xs) == 2 and layout.is_int4(Xs[1]):
        raise TypeError("a packed int4 block must be the first")
    _check_binary(Xs, binary)
    us = (u1, u2, u3) + ((u4,) if u4 is not None else ())
    for i, u in enumerate(us):
        layout.check_vector(u, n, f'u{i + 1}', device)
    if device.type == 'cpu':
        return tdots_sweep_plain(Xs, ps, u1, u2, u3, u4)
    if device.type != 'cuda':
        raise ValueError(f"no tdots_sweep for device {device}")
    outs = _tdots_sweep_cuda(Xs, ps, u1, u2, u3, u4, binary)
    count_launch(launches, _key(u4, layout.is_int4(Xs[0]), binary=binary))
    return outs


def _tdots_sweep_cuda(Xs, ps, u1, u2, u3, u4, binary=False):
    """One launch; `binary` the binary mode of a packed int4 block."""
    kl = load_library()
    device, n = Xs[0].device, Xs[0].shape[0]
    args, tiles = [], 0
    for i, (X, p) in enumerate(zip(Xs, ps)):
        layout.check_cuda_layout(X, f"X{i}")
        args += [layout.DTYPE_CODE[X.dtype], X.data_ptr(), X.shape[1], p]
        tiles += layout.col_tiles(p, X)
    if len(Xs) == 1:
        args += [0, None, 0, 0]
    if layout.is_int4(Xs[0]):
        if len(Xs) == 2 and Xs[1].dtype != torch.float32:
            raise TypeError("the nibble pre-solve takes a float32 second "
                            "block (the hybrid design's float block)")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = layout.presolve_i4_plan(n, ps[0], sum(ps[1:]), sms)
        n_seg, rows_per_seg = plan.n_seg, plan.rows_per_seg
    else:
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
            None if u4 is None else u4.data_ptr(), int(binary), n_seg,
            rows_per_seg, partial.data_ptr(), out.data_ptr(), stream)
    kl.check(rc, 'tdots_sweep')
    outs, off = [], 0
    for p in ps:
        blk = out[:, off:off + p]
        outs.append(tuple(blk[k] for k in range(k_red)))
        off += p
    return outs


def tdots_sweep_k_plain(Xs, ps, U1, U2, U3, U4=None, binary=False):
    """tdots_sweep_k chain by chain with the single plain version
    (`binary` ignored)."""
    per = [tdots_sweep_plain(Xs, ps, U1[i], U2[i], U3[i],
                             None if U4 is None else U4[i])
           for i in range(U1.shape[0])]
    return [tuple(torch.stack([outs[b][r] for outs in per])
                  for r in range(len(per[0][b])))
            for b in range(len(Xs))]


def tdots_sweep_k(Xs, ps, U1, U2, U3, U4=None, binary=False):
    """Per block the reductions of :func:`tdots_sweep` for k chains, each
    (k, p_b): U1..U3 (and U4) (k, n) float32; a second block float32;
    `binary` as for :func:`tdots_sweep`."""
    if not 1 <= len(Xs) == len(ps) <= 2:
        raise ValueError("one or two blocks, each with its width")
    device, n = Xs[0].device, Xs[0].shape[0]
    for i, (X, p) in enumerate(zip(Xs, ps)):
        if X.device != device or X.shape[0] != n:
            raise ValueError("blocks must share the device and row count")
        layout.check_block(X, p, f"X{i}")
    layout.check_second_block(Xs)
    _check_binary(Xs, binary)
    Us = [U1, U2, U3] + ([U4] if U4 is not None else [])
    k = U1.shape[0]
    layout.check_chains('tdots_sweep_k', device, k, *Us)
    if any(U.shape[1] != n for U in Us):
        raise ValueError(f"the U's must be (k, {n})")
    if device.type == 'cpu':
        return tdots_sweep_k_plain(Xs, ps, U1, U2, U3, U4)
    if device.type != 'cuda':
        raise ValueError(f"no tdots_sweep_k for device {device}")
    if k == 1:
        outs = tdots_sweep(Xs, ps, *(U[0] for U in Us[:3]),
                           U4[0] if U4 is not None else None, binary)
        return [tuple(o[None] for o in blk) for blk in outs]
    if layout.is_int4(Xs[0]):  # no chain-batched nibble mode
        per = [_tdots_sweep_cuda(Xs, ps, U1[i], U2[i], U3[i],
                                 None if U4 is None else U4[i], binary)
               for i in range(k)]
        count_launch(launches, _key(U4, True, chains=True, binary=binary),
                     k)
        return [tuple(torch.stack([outs[b][r] for outs in per])
                      for r in range(len(per[0][b])))
                for b in range(len(Xs))]
    R = len(Us) + 1
    plan = layout.batched_plan(f'tdots{R}', [X.dtype for X in Xs], k)
    out, n_launch = batched_colpass('tdots_sweep_k', Xs, ps, n, Us, R,
                                    load_library(), plan.chains)
    count_launch(launches, 'tdots_k' if U4 is None else 'u4_k', n_launch)
    outs, off = [], 0
    for p in ps:
        outs.append(tuple(out[:, r, off:off + p] for r in range(R)))
        off += p
    return outs
