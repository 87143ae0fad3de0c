"""One-read normal-equations sweep: wrapper and plain version.

Counterpart of ``baselines/dev_ne_variants.py`` ``make_fused`` (Pallas
kernel body ``kernel`` with the ``_phase_a`` / ``_phase_b`` variants).
For an int8 block ``Xe (n, lde)`` and an f32 block ``Xf (n, ldf)`` with
logical widths ``len(ve)``, ``len(vf)`` it computes

    t = Xe ve + Xf vf + c,   u = w * t,   out_e = Xe' u,   out_f = Xf' u

and returns ``(out_e, out_f, u)``, reading each stored byte of X once per
call (``csrc/ne_onepass.cu``). ``csrc/ne_sweep.cu`` computes the same
function from two reads of X; the sweep A/B harness
(``bayesbridge_tpu_torch.baselines.dev_ne_variants``) times the two and
the composed pair against each other.

Variants: ``a_mode`` 'fma' (CUDA cores) | 'mma2' (tensor cores, v split
into two bf16 terms) | 'mma1' (v rounded to bf16, lossy); ``b_mode``
'fma' | 'mma2' | 'mma3' (u split into two or three bf16 terms); ``cvt``
keeps the int8 slice converted to f32 for phase B. The tensor-core modes
apply to the int8 block; the f32 block always takes FMAs. The plain
version rounds v and u to the same bf16 terms, so each variant's plain
result matches the TPU variant's. ``SPEC_A`` / ``SPEC_B`` map the TPU
harness's spec names onto these modes.

On a CUDA tensor :func:`ne_onepass` launches the kernel (or raises); on
a CPU tensor it runs :func:`ne_onepass_plain`. ``launches['onepass']``
counts the kernel launches.
"""

import math

import torch

from . import layout
from .build import load_library

A_MODES = {'fma': 0, 'mma2': 1, 'mma1': 2}
B_MODES = {'fma': 0, 'mma2': 1, 'mma3': 2}
# TPU spec names (dev_ne_variants.py) -> Hopper modes; an 'a' spec ending
# in 's' (the TPU's f32 scratch panel) sets `cvt`.
SPEC_A = {'v1': 'fma', 'wide': 'fma', 'chunkwide': 'fma', 'reshape': 'fma',
          'mxu2a': 'mma2', 'mxd2a': 'mma2', 'mxu1a': 'mma1'}
SPEC_B = {'v1': 'fma', 'fold8': 'fma', 'mxu2': 'mma2', 'mxu3': 'mma3',
          'mxuf': 'mma3'}
CLUSTER = 8          # CTAs that share one row panel (csrc kCluster)
MAX_ROWS = 16        # rows per panel at most (csrc kMaxRows)
SMEM_CAP = 232_448   # dynamic shared memory a block may use on sm_90
# Bytes of one row panel each CTA stages, by default; two panel buffers
# are in flight (csrc double-buffers the copies). At the flagship: 12 rows.
PANEL_BYTES = 128 * 1024

launches = {'onepass': 0}


def map_spec(spec):
    """(a_mode, b_mode, cvt) of a TPU harness spec 'a:b'."""
    a, b = spec.split(':')
    cvt = a.endswith('s')
    base = a[:-1] if cvt else a
    if base not in SPEC_A or b not in SPEC_B:
        raise ValueError(f"unknown variant spec {spec!r}")
    return SPEC_A[base], SPEC_B[b], cvt


def bf16_terms(x, k):
    """x split into k bfloat16 terms (as float32): hi, then the rounded
    residuals, as the TPU variants and the kernel split it."""
    terms, res = [], x
    for i in range(k):
        term = res.to(torch.bfloat16).float()
        terms.append(term)
        res = res - term
    return terms


def _through_terms(x, k):
    """The value the k-term split carries (the terms summed in f32)."""
    out = None
    for term in bf16_terms(x, k):
        out = term if out is None else out + term
    return out


_A_TERMS = {'fma': None, 'mma2': 2, 'mma1': 1}
_B_TERMS = {'fma': None, 'mma2': 2, 'mma3': 3}


def _check_modes(a_mode, b_mode):
    if a_mode not in A_MODES or b_mode not in B_MODES:
        raise ValueError(f"a_mode in {sorted(A_MODES)}, b_mode in "
                         f"{sorted(B_MODES)}; got {a_mode!r}, {b_mode!r}")


def ne_onepass_plain(Xe, Xf, ve, vf, c, w, a_mode='fma', b_mode='fma',
                     cvt=False):
    """The sweep in plain PyTorch, with v and u rounded to the variant's
    bf16 terms on the int8 block. `cvt` changes no result."""
    _check_modes(a_mode, b_mode)
    k_a, k_b = _A_TERMS[a_mode], _B_TERMS[b_mode]
    ve_eff = ve if k_a is None else _through_terms(ve, k_a)
    t = layout.matvec(Xe, ve.shape[0], ve_eff)
    if Xf is not None:
        t = t + layout.matvec(Xf, vf.shape[0], vf)
    u = w * (t + c)
    u_e = u if k_b is None else _through_terms(u, k_b)
    out_e = layout.rmatvec(Xe, ve.shape[0], u_e)
    out_f = layout.rmatvec(Xf, vf.shape[0], u) if Xf is not None else None
    return out_e, out_f, u


def ne_onepass(Xe, Xf, ve, vf, c, w, a_mode='fma', b_mode='fma', cvt=False,
               panel_bytes=PANEL_BYTES):
    """(out_e, out_f, u) of the one-read sweep; see the module docstring.

    Parameters
    ----------
    Xe : (n, lde) int8 stored block, ve (pe,) float32, pe <= lde
    Xf : (n, ldf) float32 stored block and vf (pf,), or both None
    c, w : (n,) float32 row offset and weight
    panel_bytes : bytes of one row panel a CTA stages (two are in
        flight), which sets the rows per panel (at most 16); read on
        CUDA tensors only
    """
    _check_modes(a_mode, b_mode)
    if Xe.dtype != torch.int8:
        raise TypeError(f"Xe must be int8, got {Xe.dtype}")
    device, n = Xe.device, Xe.shape[0]
    layout.check_block(Xe, ve.shape[0], 'Xe')
    layout.check_vector(ve, ve.shape[0], 've', device)
    if Xf is not None:
        if Xf.dtype != torch.float32 or Xf.device != device \
                or Xf.shape[0] != n:
            raise ValueError("Xf must be float32 with Xe's rows and device")
        layout.check_block(Xf, vf.shape[0], 'Xf')
        layout.check_vector(vf, vf.shape[0], 'vf', device)
    layout.check_vector(c, n, 'c', device)
    layout.check_vector(w, n, 'w', device)
    if device.type == 'cpu':
        return ne_onepass_plain(Xe, Xf, ve, vf, c, w, a_mode, b_mode, cvt)
    if device.type != 'cuda':
        raise ValueError(f"no ne_onepass for device {device}")
    return _ne_onepass_cuda(Xe, Xf, ve, vf, c, w, a_mode, b_mode, cvt,
                            panel_bytes)


def plan(kl, lde, ldf, cvt, panel_bytes):
    """(rows per panel, int8 units per CTA, f32 units per CTA) of the
    cluster's column split (16-byte units): as many rows (at most
    MAX_ROWS) as fill `panel_bytes` of raw panel, fewer where the two
    panel buffers (and under `cvt` the converted int8 slice) overflow the
    shared memory."""
    ue = math.ceil(lde // 16 / CLUSTER)
    uf = math.ceil(ldf // 4 / CLUSTER)
    row_bytes = ue * 16 + uf * 16
    rows = max(1, min(MAX_ROWS, panel_bytes // max(row_bytes, 1)))
    while rows > 1 and kl.lib.bb_ne_onepass_smem(rows, ue, uf,
                                                 int(cvt)) > SMEM_CAP:
        rows -= 1
    if kl.lib.bb_ne_onepass_smem(rows, ue, uf, int(cvt)) > SMEM_CAP:
        raise ValueError(
            f"ne_onepass: one row of a CTA's slice ({row_bytes} bytes) "
            f"does not fit its shared memory")
    return rows, ue, uf


def _ne_onepass_cuda(Xe, Xf, ve, vf, c, w, a_mode, b_mode, cvt,
                     panel_bytes):
    kl = load_library()
    device, n = Xe.device, Xe.shape[0]
    layout.check_cuda_layout(Xe, 'Xe')
    pe = ve.shape[0]
    pf = vf.shape[0] if Xf is not None else 0
    ve_pad = torch.zeros(Xe.shape[1], dtype=torch.float32, device=device)
    ve_pad[:pe] = ve
    if Xf is not None:
        layout.check_cuda_layout(Xf, 'Xf')
        vf_pad = torch.zeros(Xf.shape[1], dtype=torch.float32, device=device)
        vf_pad[:pf] = vf
    ldf = Xf.shape[1] if Xf is not None else 0
    rows, ue, uf = plan(kl, Xe.shape[1], ldf, cvt, panel_bytes)
    # Scratch for two CTAs on each SM; the kernel launches as many
    # clusters as the card holds at once (cudaOccupancyMaxActiveClusters).
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_clusters = max(1, 2 * sms // CLUSTER)
    u = torch.empty(n, dtype=torch.float32, device=device)
    out = torch.empty(pe + pf, dtype=torch.float32, device=device)
    partial = torch.empty(max_clusters * (pe + pf), dtype=torch.float32,
                          device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_ne_onepass(
            Xe.data_ptr(), Xe.shape[1], pe,
            Xf.data_ptr() if Xf is not None else None, ldf, pf,
            ve_pad.data_ptr(), vf_pad.data_ptr() if Xf is not None else None,
            c.data_ptr(), w.data_ptr(), n, rows, ue, uf, A_MODES[a_mode],
            B_MODES[b_mode], int(cvt), max_clusters, u.data_ptr(),
            partial.data_ptr(), out.data_ptr(), stream)
    kl.check(rc, 'ne_onepass')
    launches['onepass'] += 1
    return out[:pe], (out[pe:] if Xf is not None else None), u
