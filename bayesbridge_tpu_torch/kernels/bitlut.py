"""LUT matvec over a bitpacked 0/1 matrix: wrapper and plain version.

Counterpart of ``bayesbridge_tpu/design/bitlut.py`` ``bitpacked_matvec``
(Pallas kernel ``_lut_kernel``). For a (G_pad, M_pad) uint8 bitmap whose
byte ``bits[g, m]`` packs input positions 8g..8g+7 of output m (bit b
for position 8g + b) and an input vector v of length 8 G_pad it computes

    out[m] = sum_g sum_b bit_b(bits[g, m]) v[8g + b]      for m < n_out

by table lookups, in the kernel's order: each group's two 16-entry
nibble tables (:func:`nibble_plain`; lo over bits 0-3, hi over bits
4-7, each entry summed over its set bits in ascending order from 0) give
a byte B the entry ``lo[B & 15] + hi[B >> 4]`` (:func:`lut_plain`), and
the entries are summed over g.

On a CUDA tensor :func:`bitlut` launches the hand-written kernel of
``csrc/bitlut.cu`` (or raises); on a CPU tensor it runs
:func:`bitlut_plain`. ``launches[tag]`` counts the kernel launches per
orientation ('dot' on ``bits_col``, 'tdot' on ``bits_row``).
:func:`bitlut_variant` launches the source's other modes (the first
design's byte-table kernel and the ablation's cuts; no counter), for
``baselines/bitlut_ablation.py`` and the chip smoke's timings.
"""

import math

import torch

from . import layout
from .build import count_launch, load_library

launches = {'dot': 0, 'tdot': 0}
# Byte-groups gathered per step of the plain version (bounds its
# int64-index transient).
_PLAIN_ELEMS = 2 ** 25
# Groups per table chunk and outputs per block of the kernel
# (csrc/bitlut.cu kGroups, kTileOut), floats of a group's nibble tables
# (kNib).
_KERNEL_GROUPS = 32
_KERNEL_TILE_OUT = 4096
NIBBLE_FLOATS = 32
# bb_bitlut's modes: the design's kernel, then the ones only timed.
MODES = {'nibble': 0, 'byte': 1, 'nibble_l2': 2, 'nolookup': 3}


def _bit_sums(values, n_bits):
    """(G, 2 ** n_bits) sums of each row of `values` (G, n_bits) over the
    set bits of every index, in ascending bit order from 0."""
    idx = torch.arange(2 ** n_bits, device=values.device)
    out = torch.zeros((values.shape[0], 2 ** n_bits), dtype=values.dtype,
                      device=values.device)
    for b in range(n_bits):
        out = out + ((idx >> b) & 1).to(values.dtype) * values[:, b:b + 1]
    return out


def nibble_plain(v):
    """(G, 32) nibble tables of a (8 G,) vector: [:, :16] over
    v[8g..8g+3] (lo), [:, 16:] over v[8g+4..8g+7] (hi), each entry summed
    over its set bits in ascending order from 0 (the kernel's
    pre-pass)."""
    halves = v.view(-1, 4)
    return _bit_sums(halves, 4).view(-1, NIBBLE_FLOATS)


def lut_plain(v):
    """(G, 256) byte tables of a (8 G,) vector as the kernel forms them:
    entry B = lo[B & 15] + hi[B >> 4] of :func:`nibble_plain`."""
    nib = nibble_plain(v)
    byte = torch.arange(256, device=v.device)
    return nib[:, byte & 15] + nib[:, 16 + (byte >> 4)]


def byte_lut_plain(v):
    """(G, 256) byte tables of a (8 G,) vector, each entry summed over its
    eight bits in ascending order from 0: the order of the byte-table
    kernel (the 'byte' mode of :func:`bitlut_variant`)."""
    return _bit_sums(v.view(-1, 8), 8)


def bitlut_plain(bits, v, n_out, tables=lut_plain):
    """The product in plain PyTorch: a flat gather of the byte tables
    (``tables(v)``, by default the kernel's :func:`lut_plain`) by byte,
    summed over groups in chunks. Same arguments as :func:`bitlut`."""
    G = bits.shape[0]
    flat = tables(v).reshape(-1)
    out = torch.zeros(n_out, dtype=v.dtype, device=v.device)
    step = max(1, _PLAIN_ELEMS // max(n_out, 1))
    for g0 in range(0, G, step):
        g1 = min(G, g0 + step)
        rows = torch.arange(g0, g1, device=v.device)[:, None] * 256
        out = out + flat[bits[g0:g1, :n_out].long() + rows].sum(0)
    return out


def bitlut(bits, v, n_out, tag='dot'):
    """out (n_out,) float32 of the LUT product; see the module
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
    _check(bits, v, n_out)
    if bits.device.type == 'cpu':
        return bitlut_plain(bits, v, n_out)
    if bits.device.type != 'cuda':
        raise ValueError(f"no bitlut for device {bits.device}")
    out = _bitlut_cuda(bits, v, n_out, MODES['nibble'])
    count_launch(launches, tag)
    return out


def bitlut_variant(bits, v, n_out, mode):
    """:func:`bitlut`'s product by another mode of ``csrc/bitlut.cu``
    (CUDA tensors only; not counted): 'byte' (the first design's
    byte-table kernel, same function, :func:`byte_lut_plain`'s order),
    or the ablation's cuts 'nibble_l2' (nibble tables read through
    L1/L2, same function) and 'nolookup' (no lookups: its results mean
    nothing)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}")
    _check(bits, v, n_out)
    if bits.device.type != 'cuda':
        raise ValueError("bitlut_variant runs on CUDA tensors only")
    return _bitlut_cuda(bits, v, n_out, MODES[mode])


def _check(bits, v, n_out):
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


def _bitlut_cuda(bits, v, n_out, mode):
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
    tables = torch.empty(g_pad * NIBBLE_FLOATS, dtype=torch.float32,
                         device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_bitlut(bits.data_ptr(), g_pad, m_pad, v.data_ptr(),
                              n_out, n_split, per, tables.data_ptr(),
                              partial.data_ptr(), out.data_ptr(), mode,
                              stream)
    kl.check(rc, 'bitlut')
    return out
