"""Windowed-CSR matvec: wrapper and plain version.

The winell backend's product on the card, over the layout of
:mod:`bayesbridge_tpu_torch.design.wincsr` (it replaces the windowed-ELL
kernel ``bayesbridge_tpu/design/winell.py`` ``_winell_kernel`` on the
design's path; :mod:`.winell` keeps the port of that kernel). For a
layout ``m`` of an (n_out, n_in) matrix X it computes

    out[row] = sum_w ( sum_{e in segment (w, row)} x_e v[w * window + idx_e] )

with x = val, or val**2 with ``square`` (the Fisher diagonal's second
moment): the windows of a row summed in window order.

On a CUDA tensor :func:`wincsr` launches the hand-written kernel of
``csrc/wincsr.cu`` (or raises); on a CPU tensor it runs
:func:`wincsr_plain`. ``launches[tag]`` counts the kernel launches per
orientation ('dot' on the row layout, 'tdot' on the column layout).

The kernel gathers v through the L2 cache. Staging each input window in
shared memory instead was slower on the H100 at the winell design
(``PERF.md``): 0.0731 ms on X v against 0.0586 gathered (64 KB of shared
memory per block leaves three blocks per SM, gathering eight), and on
X' u 0.0785 against 0.0702 (windows of 16,384) and 0.1207 (32,768).
"""

import torch

from .build import count_launch, load_library

launches = {'dot': 0, 'tdot': 0}


def wincsr_plain(m, v, square=False):
    """The product in plain PyTorch: each entry's product, summed per
    (window, row) segment, then the windows in order."""
    n_seg = m.n_win * m.n_out
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=v.device), m.ptr.diff())
    col = (seg // max(1, m.n_out)) * m.window \
        + (m.idx.to(torch.int64) & 0xFFFF)
    vp = torch.zeros(m.n_win * m.window, dtype=v.dtype, device=v.device)
    vp[:v.shape[0]] = v
    x = m.val * m.val if square else m.val
    sums = torch.zeros(n_seg, dtype=torch.float32, device=v.device)
    sums.index_add_(0, seg, x * vp[col])
    out = sums.view(m.n_win, m.n_out)
    total = out[0].clone()
    for w in range(1, m.n_win):
        total += out[w]
    return total


def wincsr(m, v, square=False, tag='dot'):
    """out (n_out,) float32 of the windowed-CSR product; see the module
    docstring.

    Parameters
    ----------
    m : :class:`..design.wincsr.WinCSR` with its tensors on v's device
    v : (n_in,) float32 input vector, contiguous
    square : multiply by val**2 instead of val
    tag : 'dot' | 'tdot', the launch counter to advance
    """
    if tag not in launches:
        raise ValueError(f"tag must be one of {sorted(launches)}")
    if m.idx.dtype != torch.int16 or m.val.dtype != torch.float32 \
            or m.ptr.dtype != torch.int64 \
            or m.idx.shape != m.val.shape or m.idx.dim() != 1 \
            or m.ptr.shape[0] != m.n_win * m.n_out + 1 \
            or not all(t.is_contiguous() for t in m.tensors()):
        raise ValueError("the layout needs contiguous int64 ptr "
                         "(n_win * n_out + 1), int16 idx and float32 val "
                         "of one length")
    if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != m.n_in \
            or not v.is_contiguous() \
            or len({m.ptr.device, m.idx.device, m.val.device,
                    v.device}) != 1:
        raise ValueError(f"v must be a contiguous float32 vector of length "
                         f"{m.n_in} on {m.idx.device}")
    if v.device.type == 'cpu':
        return wincsr_plain(m, v, square)
    if v.device.type != 'cuda':
        raise ValueError(f"no wincsr for device {v.device}")
    return _wincsr_cuda(m, v, square, tag)


def _wincsr_cuda(m, v, square, tag):
    kl = load_library()
    device = v.device
    out = torch.empty(m.n_out, dtype=torch.float32, device=device)
    if m.n_out == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_wincsr(m.ptr.data_ptr(), m.idx.data_ptr(),
                              m.val.data_ptr(), v.data_ptr(), m.window,
                              m.n_win, m.n_out, m.lanes, int(square),
                              out.data_ptr(), stream)
    kl.check(rc, 'wincsr')
    count_launch(launches, tag)
    return out
