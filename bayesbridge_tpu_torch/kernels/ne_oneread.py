"""The hybrid sweep from one read of X: plan, wrappers, counters.

For one or two row-aligned stored blocks ``[(X_b, v_b)]`` (int8, bf16 or
f32; the hybrid design's exact block beside its f32 block, or either
alone) :func:`ne_oneread` computes the CG operator

    t = sum_b X_b[:, :p_b] v_b + c,   u = w * t,   out_b = X_b[:, :p_b]' u

and returns ``(outs, u)``; :func:`ne_oneread_link` computes the GLM
score of the link modes, ``u = a - b sigmoid(t)`` ('logit') or
``u = b (a - t)`` ('linear'), ``out_b = X_b' u`` and, with
``with_logp``, the summed log-likelihood rows, and returns
``(outs, u, logp)``. They are the modes of :func:`.ne_sweep.ne_sweep`,
which routes there on the card. On a CUDA tensor each launches the
kernel of ``csrc/ne_oneread.cu`` (or raises); on a CPU tensor it runs
the sweep's plain version, :func:`.ne_sweep.ne_sweep_plain`.
``launches[mid]`` counts the kernel launches per mode.

The kernel spreads each panel of ``ROWS`` rows over a thread-block
cluster of ``CLUSTER`` CTAs, each owning 1/8 of every block's 16-byte
column units, one unit per consumer thread for the whole launch (its
slice of v and its column sums in registers). :func:`plan` picks the
units per CTA and the ring of staged panels for a block pair, or returns
None where they do not fit (too many units per CTA): ``ne_sweep`` then
takes the two-pass route, which counts its own launches. The cluster
size is fixed: on the H100 at the flagship blocks clusters of 16 took
5.56 ms against 2.84 for clusters of 8 (slower than the two-pass sweep),
and clusters of 4 do not fit there (``PERF.md``).
"""

import math
from dataclasses import dataclass

import torch

from . import layout
from .build import load_library

ROWS = 4                 # rows per panel (csrc kRows)
MAX_CONSUMERS = 512      # consumer threads per CTA (csrc kMaxConsumers)
MAX_STAGES = 8           # staged panels at most (csrc kMaxStages)
MIN_STAGES = 3           # fewer cannot keep the stream in flight
FIXED_SMEM = 4096        # barriers and row partials (csrc kFixedSmem)
SMEM_CAP = 232_448       # dynamic shared memory a block may use on sm_90
CLUSTER = 8              # CTAs per cluster (csrc kCluster)
UNIT_BYTES = 16

launches = {'ne': 0, 'logit': 0, 'linear': 0}
_FIT = {}  # (dtype codes, plan) -> clusters that fit on the card at once


@dataclass(frozen=True)
class Plan:
    """The kernel's split of a block pair: 16-byte units of each block
    (live units ``U``, per CTA ``ue`` / ``uf``), consumer threads, staged
    panels and the shared memory it takes."""
    units: tuple
    ue: int
    uf: int
    n_cons: int
    stages: int
    smem: int

    def slices(self, rank):
        """[(first, stop) of live units of each block] owned by CTA
        `rank` of a cluster."""
        per = (self.ue, self.uf)
        return [(min(u, rank * k), min(u, (rank + 1) * k))
                for u, k in zip(self.units, per)]


def _ceil32(x):
    return -(-x // 32) * 32


def plan(widths, itemsizes):
    """The Plan for blocks of logical widths `widths` and element sizes
    `itemsizes` (one or two each); None where it does not fit."""
    units = [math.ceil(p / (UNIT_BYTES // s))
             for p, s in zip(widths, itemsizes)]
    units = (units + [0])[:2]
    ue, uf = (math.ceil(u / CLUSTER) for u in units)
    n_cons = _ceil32(ue) + _ceil32(uf)
    if n_cons > MAX_CONSUMERS:
        return None
    row_bytes = (ue + uf) * UNIT_BYTES
    stages = min(MAX_STAGES, (SMEM_CAP - FIXED_SMEM) // (ROWS * row_bytes))
    if stages < MIN_STAGES:
        return None
    return Plan(tuple(units), ue, uf, n_cons, stages,
                FIXED_SMEM + stages * ROWS * row_bytes)


def block_plan(blocks):
    """:func:`plan` for ``[(X_b, v_b)]``."""
    return plan([v.shape[0] for _, v in blocks],
                [X.element_size() for X, _ in blocks])


def ne_oneread(blocks, c, w):
    """(outs, u) of the CG operator; see the module docstring.

    Parameters
    ----------
    blocks : one or two (X_b, v_b): X_b (n, ld_b) int8/bf16/f32 stored
        block, v_b (p_b,) float32 with p_b <= ld_b
    c : (n,) float32, or a 0-d float32 tensor added to every row
    w : (n,) float32 row weights
    """
    outs, u, _ = _sweep(blocks, c, None, w, 'ne', False)
    return outs, u


def ne_oneread_link(blocks, c, a, b, mid, with_logp=False):
    """(outs, u, logp) of the link mode `mid` ('logit' | 'linear'); logp
    is None without `with_logp`. `blocks` and `c` as for
    :func:`ne_oneread`; a, b (n,) float32 the rows' operands (b the row
    weights)."""
    if mid not in ('logit', 'linear'):
        raise ValueError(f"mid must be 'logit' or 'linear', got {mid!r}")
    return _sweep(blocks, c, a, b, mid, with_logp)


def _sweep(blocks, c, a, b, mid, with_logp):
    from .ne_sweep import check_sweep_args, ne_sweep_plain
    device, n = check_sweep_args(blocks, c, b)
    if mid != 'ne':
        layout.check_vector(a, n, 'a', device)
    if device.type == 'cpu':
        return ne_sweep_plain(blocks, c, a, b, mid, with_logp)
    if device.type != 'cuda':
        raise ValueError(f"no ne_oneread for device {device}")
    p = block_plan(blocks)
    if p is None:
        raise ValueError(
            f"ne_oneread: a cluster of {CLUSTER} CTAs does not hold these "
            f"blocks' column units in {MAX_CONSUMERS} threads each")
    return _ne_oneread_cuda(blocks, c, a, b, mid, with_logp, p)


def fit_clusters(kl, codes, p):
    """Clusters of the plan that fit on the card at once (cached; a pair
    of blocks at one CTA an SM, ``csrc/ne_oneread.cu`` kPairMinSmem)."""
    key = (codes, p)
    if key not in _FIT:
        fit = kl.lib.bb_ne_oneread_fit(codes[0], codes[1], p.ue, p.uf,
                                       p.n_cons, p.stages)
        if fit < 1:
            raise RuntimeError(f"ne_oneread: plan {p} does not fit the card")
        _FIT[key] = fit
    return _FIT[key]


def _ne_oneread_cuda(blocks, c, a, w, mid, with_logp, p, clusters=None):
    """The launch; `clusters` None launches :func:`fit_clusters`' count
    (``baselines/oneread_reruns.py`` passes others)."""
    from .ne_sweep import MIDS
    kl = load_library()
    X0 = blocks[0][0]
    device, n = X0.device, X0.shape[0]
    args, keep = [], []
    for i, (X, v) in enumerate(list(blocks) + [(None, None)] * (
            2 - len(blocks))):
        if X is None:
            args += [-1, None, 0, 0, None]
            continue
        layout.check_cuda_layout(X, f"X{i}")
        v_pad = torch.zeros(X.shape[1], dtype=torch.float32, device=device)
        v_pad[:v.shape[0]] = v
        keep.append(v_pad)
        args += [layout.DTYPE_CODE[X.dtype], X.data_ptr(), X.shape[1],
                 v.shape[0], v_pad.data_ptr()]
    codes = (args[0], args[5])
    if clusters is None:
        clusters = fit_clusters(kl, codes, p)
    widths = [v.shape[0] for _, v in blocks]
    width = sum(widths) + int(with_logp)  # logp after the columns
    u = torch.empty(n, dtype=torch.float32, device=device)
    out = torch.empty(width, dtype=torch.float32, device=device)
    partial = torch.empty(clusters * width, dtype=torch.float32,
                          device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = kl.lib.bb_ne_oneread(
            *args, n, c.data_ptr(), 0 if c.dim() == 0 else 1, w.data_ptr(),
            None if a is None else a.data_ptr(), MIDS[mid], int(with_logp),
            p.units[0], p.units[1], p.ue, p.uf, p.n_cons, p.stages,
            clusters, u.data_ptr(), partial.data_ptr(),
            out.data_ptr(), stream)
    kl.check(rc, 'ne_oneread')
    launches[mid] += 1
    outs = list(torch.split(out[:sum(widths)], widths))
    return outs, u, (out[-1] if with_logp else None)
