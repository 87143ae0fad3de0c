"""Streaming probe: wrapper and plain version.

Counterpart of ``baselines/dev_ne_variants.py`` ``make_probe`` (its
Pallas kernel). For X (n, p) it returns the 0-d float32 tensor

    sum over rows i of ( sum_j g(X_ij) + 128 * seed )

with g by `kind`: 'i32' (X int32; each row sums into a wrapping int32,
the seed truncated to int32 first), 'cvt' (X int8 up-converted to f32),
'mul' (X int8 up-converted and multiplied by v, zeros unless given, as
the TPU probe's v). These equal the TPU probe's results wherever those
are defined: p a multiple of 1024 and n a multiple of its panel rows
(elsewhere the TPU probe also sums its padding). The sweep A/B harness
times the three kinds to tell whether the stream, the int8 up-convert or
the multiply caps a pass over the design on this card.

On a CUDA tensor :func:`stream_probe` launches the kernel of
``csrc/stream_probe.cu`` (or raises); on a CPU tensor it runs
:func:`stream_probe_plain`. ``launches[kind]`` counts the launches.
"""

import torch

from . import layout
from .build import load_library

KINDS = {'i32': 0, 'cvt': 1, 'mul': 2}
DTYPES = {'i32': torch.int32, 'cvt': torch.int8, 'mul': torch.int8}
launches = {kind: 0 for kind in KINDS}


def _wrap_int32(x):
    """int64 values reduced to int32 with two's-complement wrapping."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def stream_probe_plain(X, seed, kind, v=None):
    """The probe in plain PyTorch (row chunks, float32 row totals summed
    in float32); `v` None = zeros, as for :func:`stream_probe`."""
    if kind == 'mul' and v is None:
        v = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    n = X.shape[0]
    step = max(1, layout.CHUNK_BYTES // (4 * max(X.shape[1], 1)))
    total = torch.zeros((), dtype=torch.float32, device=X.device)
    for i in range(0, n, step):
        Xc = X[i:i + step]
        if kind == 'i32':
            s32 = int(torch.trunc(seed).item())
            rows = _wrap_int32(Xc.long().sum(1) + 128 * s32).float()
        else:
            Xc = Xc.float()
            if kind == 'mul':
                Xc = Xc * v
            rows = Xc.sum(1) + 128.0 * seed
        total = total + rows.sum()
    return total


def stream_probe(X, seed, kind, v=None):
    """The probe's scalar; see the module docstring.

    Parameters
    ----------
    X : (n, p) int32 ('i32') or int8 ('cvt', 'mul'), contiguous
    seed : float or 0-d float32 tensor on X's device (a chain of calls
        feeds each result, scaled down, to the next)
    kind : 'i32' | 'cvt' | 'mul'
    v : (p,) float32 for 'mul'; None = zeros
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got "
                         f"{kind!r}")
    if X.dim() != 2 or X.dtype != DTYPES[kind] or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-d {DTYPES[kind]} array "
                         f"for kind {kind!r}")
    device = X.device
    seed = torch.as_tensor(seed, dtype=torch.float32, device=device)
    if seed.dim() != 0:
        raise ValueError("seed must be a scalar")
    if kind == 'mul':
        if v is None:
            v = torch.zeros(X.shape[1], dtype=torch.float32, device=device)
        layout.check_vector(v, X.shape[1], 'v', device)
    if device.type == 'cpu':
        return stream_probe_plain(X, seed, kind, v)
    if device.type != 'cuda':
        raise ValueError(f"no stream_probe for device {device}")
    return _stream_probe_cuda(X, seed, kind, v)


def _stream_probe_cuda(X, seed, kind, v):
    kl = load_library()
    device, n = X.device, X.shape[0]
    row_bytes = X.shape[1] * X.element_size()
    if row_bytes % 16 or X.data_ptr() % 16:
        raise ValueError("stream_probe: rows must be whole 16-byte vectors "
                         f"(got {row_bytes} bytes) on a 16-byte base")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = max(1, min(-(-n // 8), 8 * sms))
    rows = torch.empty(n, dtype=torch.float32, device=device)
    out = torch.empty(1, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_stream_probe(
            X.data_ptr(), row_bytes, n, KINDS[kind],
            v.data_ptr() if v is not None else None, seed.data_ptr(),
            rows.data_ptr(), out.data_ptr(), grid, stream)
    kl.check(rc, 'stream_probe')
    launches[kind] += 1
    return out[0]
