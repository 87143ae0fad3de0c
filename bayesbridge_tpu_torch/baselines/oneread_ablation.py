"""Where the one-read CG operator's time goes: ``ne_oneread`` with parts
cut out.

Builds copies of ``csrc/ne_oneread.cu`` with one part removed each and
times every copy at one shape (the sweep A/B harness's int8 + f32
blocks), on the card:

``base``      the kernel as it is;
``noA``       without phase A's arithmetic (the row sums);
``noB``       without phase B's arithmetic (the column sums);
``noAB``      without either: the stream of X, the stage ring and the
              cluster's reduction alone;
``noexch``    without the cluster exchange: no DSMEM pushes, and the
              finisher waits for the local partials instead of the
              peers';
``nostream``  copies only into the first ring of stages: the arithmetic
              and the reductions on data already in shared memory;
``onewarp``   the reduction on one warp, which pushes a panel's partials
              and then waits for the cluster's before the next panel's
              push (the design before the pusher / finisher split).

The copies compute wrong results; only their times mean anything. Also
prints the plan and how many clusters the card holds at once. CUDA
events, median of ``--reps``.

    python -m bayesbridge_tpu_torch.baselines.oneread_ablation \\
        [--n N] [--pe PE] [--pf PF] [--reps R]
"""

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import build, layout
from ..kernels.ne_oneread import CLUSTER, block_plan
from .dev_ne_variants import make_inputs

# The pieces each copy removes (exact source text of csrc/ne_oneread.cu).
_A = '      part[r] = s0 + s1;'
_B = 'for (int e = 0; e < N; ++e) acc[e] = fmaf(x[e], uu[r], acc[e]);'
_PUSH = 'if (lane < C) {'
_WAIT = 'bar_wait<true>(&s.cbar[j], (uint32_t)((k / kSlots) & 1));'
_EXPECT = 'bar_expect(&s.full[st], (uint32_t)(live * (my_ue + my_uf) * 16));'
_COPY = '    if (lane < live) {\n      const int64_t row = row0 + lane;'
_SPLIT = '''  } else if (warp == ncw + 1) {
    pusher(s, rank, C, K, ncw);
  } else {
    finisher(a, s, rank, C, cid, ncl, K);
  }'''
# One warp pushes panel k's partials, then finishes panel k: the pusher
# and the finisher run in turn, panel by panel.
_ONEWARP = '''  } else if (warp == ncw + 1) {
    for (int64_t k = 0; k < K; ++k) {
      push_panel(s, rank, C, k, ncw);
      finish_panel(a, s, rank, C, cid, ncl, k);
    }
  }'''


def variants():
    """{name: source} of the ablated copies."""
    src = (build.CSRC / 'ne_oneread.cu').read_text()
    missing = [p for p in (_A, _B, _PUSH, _WAIT, _EXPECT, _COPY, _SPLIT)
               if p not in src]
    if missing:
        raise RuntimeError(f"ne_oneread.cu no longer holds {missing}")
    no_a = src.replace(_A, '      part[r] = 0.f;')
    return {
        'base': src,
        'noA': no_a,
        'noB': src.replace(_B, ';'),
        'noAB': no_a.replace(_B, ';'),
        'noexch': src.replace(_PUSH, 'if (false) {').replace(
            _WAIT, 'bar_wait<false>(&s.lbar[j], '
                   '(uint32_t)((k / kSlots) & 1));'),
        'nostream': src.replace(
            _EXPECT, 'bar_expect(&s.full[st], k < a.stages ? '
                     '(uint32_t)(live * (my_ue + my_uf) * 16) : 0u);')
        .replace(_COPY, '    if (lane < live && k < a.stages) {\n'
                        '      const int64_t row = row0 + lane;'),
        'onewarp': src.replace(_SPLIT, _ONEWARP),
    }


def build_all(sources):
    """One nvcc per copy, all at once; {name: loaded library}."""
    key = hashlib.sha256(''.join(sources.values()).encode()).hexdigest()
    out = build.BUILD_ROOT / 'oneread_ablation' / key[:16]
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        cu, so = out / f'{name}.cu', out / f'{name}.so'
        if not so.exists():
            cu.write_text(sources[name])
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-shared',
                            '-I', str(build.CSRC), '-o', str(so), str(cu)],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for fn in ('bb_ne_oneread', 'bb_ne_oneread_fit'):
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        return name, lib

    with ThreadPoolExecutor(len(sources)) as ex:
        return dict(ex.map(one, sources))


def run(n, pe, pf, reps, log=print):
    """Times of every copy; returns records."""
    libs = build_all(variants())
    Xe, Xf, ve, vf, c, w = make_inputs(n, pe, pf, torch.device('cuda'))
    pads = []
    for X, v in ((Xe, ve), (Xf, vf)):
        pad = torch.zeros(X.shape[1], device='cuda')
        pad[:v.shape[0]] = v
        pads.append(pad)
    u = torch.empty(n, device='cuda')
    out = torch.empty(pe + pf, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    codes = (layout.DTYPE_CODE[Xe.dtype], layout.DTYPE_CODE[Xf.dtype])
    log(f"ne_oneread ablation: n={n} pe={pe} pf={pf} on "
        f"{torch.cuda.get_device_name(0)}")
    recs = []
    p = block_plan([(Xe, ve), (Xf, vf)])
    if p is None:
        log("  no plan fits these blocks")
        return recs
    fit = libs['base'].bb_ne_oneread_fit(*codes, p.ue, p.uf, p.n_cons,
                                         p.stages)
    log(f"  {p}: {fit} clusters of {CLUSTER} at once ({fit * CLUSTER} SMs)")
    partial = torch.empty(fit * (pe + pf), device='cuda')
    for name, lib in libs.items():
        def call(lib=lib, name=name):
            rc = lib.bb_ne_oneread(
                codes[0], Xe.data_ptr(), Xe.shape[1], pe, pads[0].data_ptr(),
                codes[1], Xf.data_ptr(), Xf.shape[1], pf, pads[1].data_ptr(),
                n, c.data_ptr(), 1, w.data_ptr(), None, 0, 0, p.units[0],
                p.units[1], p.ue, p.uf, p.n_cons, p.stages, fit, u.data_ptr(),
                partial.data_ptr(), out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        recs.append(dict(name=name, ms=ms))
        log(f"    {name:>8}: {ms:.3f} ms")
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--pe', type=int, default=45_000)
    ap.add_argument('--pf', type=int, default=5_000)
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("oneread_ablation: needs a CUDA device")
    run(args.n, args.pe, args.pf, args.reps)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
