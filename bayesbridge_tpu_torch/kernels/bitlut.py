"""Byte-LUT matvec over a bitpacked 0/1 matrix: wrapper and plain version.

Counterpart of ``bayesbridge_tpu/design/bitlut.py`` ``bitpacked_matvec``
(Pallas kernel ``_lut_kernel``). For a (G_pad, M_pad) uint8 bitmap whose
byte ``bits[g, m]`` packs input positions 8g..8g+7 of output m (bit b
for position 8g + b) and an input vector v of length 8 G_pad it computes

    lut[g, B] = sum_b bit_b(B) v[8g + b]        (b ascending)
    out[m]    = sum_g lut[g, bits[g, m]]         for m < n_out

On a CUDA tensor :func:`bitlut` launches the hand-written kernel of
``csrc/bitlut.cu`` (or raises); on a CPU tensor it runs
:func:`bitlut_plain`. ``launches[tag]`` counts the kernel launches per
orientation ('dot' on ``bits_col``, 'tdot' on ``bits_row``).
"""

import math

import torch

from . import layout
from .build import load_library

launches = {'dot': 0, 'tdot': 0}
# Byte-groups gathered per step of the plain version (bounds its
# int64-index transient).
_PLAIN_ELEMS = 2 ** 25
# Groups per shared-memory table chunk and outputs per block of the
# kernel (csrc/bitlut.cu kGroups, kTileOut).
_KERNEL_GROUPS = 32
_KERNEL_TILE_OUT = 4096


def lut_plain(v):
    """(G, 256) tables of a (8 G,) vector, each entry summed over its set
    bits in ascending order from 0 (the kernel's order)."""
    vg = v.view(-1, 8)
    byte = torch.arange(256, device=v.device)
    lut = torch.zeros((vg.shape[0], 256), dtype=v.dtype, device=v.device)
    for b in range(8):
        lut = lut + ((byte >> b) & 1).to(v.dtype) * vg[:, b:b + 1]
    return lut


def bitlut_plain(bits, v, n_out):
    """The product in plain PyTorch: a flat gather of the tables by byte,
    summed over groups in chunks. Same arguments as :func:`bitlut`."""
    G = bits.shape[0]
    flat = lut_plain(v).reshape(-1)
    out = torch.zeros(n_out, dtype=v.dtype, device=v.device)
    step = max(1, _PLAIN_ELEMS // max(n_out, 1))
    for g0 in range(0, G, step):
        g1 = min(G, g0 + step)
        rows = torch.arange(g0, g1, device=v.device)[:, None] * 256
        out = out + flat[bits[g0:g1, :n_out].long() + rows].sum(0)
    return out


def bitlut(bits, v, n_out, tag='dot'):
    """out (n_out,) float32 of the byte-LUT product; see the module
    docstring.

    Parameters
    ----------
    bits : (G_pad, M_pad) uint8, contiguous; M_pad a multiple of 128
    v : (8 * G_pad,) float32, zero beyond the logical input length
    n_out : logical output length, <= M_pad
    tag : 'dot' | 'tdot', the launch counter to advance
    """
    if tag not in launches:
        raise ValueError(f"tag must be one of {sorted(launches)}")
    if bits.dtype != torch.uint8 or bits.dim() != 2 \
            or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous 2-d uint8 tensor")
    g_pad, m_pad = bits.shape
    if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != 8 * g_pad \
            or v.device != bits.device or not v.is_contiguous():
        raise ValueError(f"v must be a contiguous float32 vector of length "
                         f"{8 * g_pad} on {bits.device}")
    if not 0 < n_out <= m_pad:
        raise ValueError(f"n_out {n_out} outside (0, {m_pad}]")
    if bits.device.type == 'cpu':
        return bitlut_plain(bits, v, n_out)
    if bits.device.type != 'cuda':
        raise ValueError(f"no bitlut for device {bits.device}")
    return _bitlut_cuda(bits, v, n_out, tag)


def _bitlut_cuda(bits, v, n_out, tag):
    g_pad, m_pad = bits.shape
    if m_pad % 128 or bits.data_ptr() % 16:
        raise ValueError("the CUDA kernel reads 16-byte vectors: M_pad must "
                         "be a multiple of 128 and the base 16-byte aligned")
    kl = load_library()
    device = bits.device
    n_split, per = layout.splits(math.ceil(g_pad / _KERNEL_GROUPS),
                                 math.ceil(n_out / _KERNEL_TILE_OUT), device)
    out = torch.empty(n_out, dtype=torch.float32, device=device)
    partial = torch.empty(n_split * n_out if n_split > 1 else 0,
                          dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_bitlut(bits.data_ptr(), g_pad, m_pad, v.data_ptr(),
                              n_out, n_split, per, partial.data_ptr(),
                              out.data_ptr(), stream)
    kl.check(rc, 'bitlut')
    launches[tag] += 1
    return out
