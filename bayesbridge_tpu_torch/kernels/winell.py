"""Windowed-ELL matvec: wrapper and plain version.

Counterpart of ``bayesbridge_tpu/design/winell.py`` ``winell_matvec``
(Pallas kernel ``_winell_kernel``). For a packing ``idx`` (int16) /
``val`` (float32) of shape (Wn * T * K, 128) from
:func:`bayesbridge_tpu_torch.design.winell.pack_winell`, with T output
tiles of 128 lanes (``tile_block(n_out)``), Wn input windows of W
positions and K slots per (window, tile) cell, it computes

    out[tile*128 + lane] = sum_w sum_slot x[r, lane] v[w*W + idx[r, lane]]

with r = (w T + tile) K + slot and x = val, or val**2 with ``square``
(the Fisher diagonal's second moment); v is zero beyond its length.

On a CUDA tensor :func:`winell` launches the hand-written kernel of
``csrc/winell.cu`` (or raises); on a CPU tensor it runs
:func:`winell_plain`. ``launches[tag]`` counts the kernel launches per
orientation ('dot' on the row packing, 'tdot' on the column packing).
"""

import math

import torch

from ..design.winell import tile_block
from . import layout
from .build import count_launch, load_library

launches = {'dot': 0, 'tdot': 0}
_LANE = 128
# Output tiles per block of the kernel (csrc/winell.cu kTiles).
_KERNEL_TILES = 2


def winell_plain(idx, val, v, n_out, W, K, square=False):
    """The product in plain PyTorch: gather, multiply, sum each window's
    slots, then the windows. Same arguments as :func:`winell`."""
    T, _ = tile_block(n_out)
    Wn = idx.shape[0] // (T * K)
    vp = torch.zeros(Wn * W, dtype=v.dtype, device=v.device)
    vp[:v.shape[0]] = v
    base = torch.arange(Wn, device=v.device).view(Wn, 1, 1, 1) * W
    g = vp[idx.view(Wn, T, K, _LANE).long() + base]
    x = val.view(Wn, T, K, _LANE)
    if square:
        x = x * x
    return (x * g).sum(2).sum(0).reshape(T * _LANE)[:n_out]


def winell(idx, val, v, n_out, W, K, square=False, tag='dot'):
    """out (n_out,) float32 of the windowed-ELL product; see the module
    docstring.

    Parameters
    ----------
    idx, val : (Wn * T * K, 128) int16 / float32, contiguous
    v : (n_in,) float32 input vector, n_in <= Wn * W
    n_out : logical output length (fixes T = tile_block(n_out)[0])
    W, K : the packing plan (W <= 1024 a multiple of 128; K 16 or 32)
    square : multiply by val**2 instead of val
    tag : 'dot' | 'tdot', the launch counter to advance
    """
    if tag not in launches:
        raise ValueError(f"tag must be one of {sorted(launches)}")
    T, _ = tile_block(n_out)
    rows = idx.shape[0] if idx.dim() == 2 else -1
    if idx.dtype != torch.int16 or val.dtype != torch.float32 \
            or idx.shape != val.shape or idx.dim() != 2 \
            or idx.shape[1] != _LANE or rows % (T * K) \
            or not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError(f"idx/val must be contiguous int16/float32 of "
                         f"shape (Wn * {T} * {K}, {_LANE})")
    Wn = rows // (T * K)
    if W % _LANE or not 0 < W <= 1024 or K % 16:
        raise ValueError(f"unsupported plan W={W}, K={K}")
    if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] > Wn * W \
            or not v.is_contiguous() or len({idx.device, val.device,
                                              v.device}) != 1:
        raise ValueError(f"v must be a contiguous float32 vector of length "
                         f"<= {Wn * W} on {idx.device}")
    if idx.device.type == 'cpu':
        return winell_plain(idx, val, v, n_out, W, K, square)
    if idx.device.type != 'cuda':
        raise ValueError(f"no winell for device {idx.device}")
    return _winell_cuda(idx, val, v, n_out, W, K, square, tag, T, Wn)


def _winell_cuda(idx, val, v, n_out, W, K, square, tag, T, Wn):
    kl = load_library()
    device = idx.device
    n_split, per = layout.splits(Wn, math.ceil(T / _KERNEL_TILES), device)
    out = torch.empty(n_out, dtype=torch.float32, device=device)
    partial = torch.empty(n_split * n_out if n_split > 1 else 0,
                          dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_winell(idx.data_ptr(), val.data_ptr(), v.data_ptr(),
                              v.shape[0], W, K, T, Wn, int(square), n_out,
                              n_split, per, partial.data_ptr(),
                              out.data_ptr(), stream)
    kl.check(rc, 'winell')
    count_launch(launches, tag)
    return out
