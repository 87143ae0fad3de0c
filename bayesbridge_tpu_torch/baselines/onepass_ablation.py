"""Where the one-read sweep's time goes: ``ne_onepass`` with parts cut out.

Builds copies of ``csrc/ne_onepass.cu`` (its fma:fma variant) with one
part removed each and times every copy at one shape, on the card:

``base``     the kernel as it is;
``noA``      without phase A (the row sums of the panel);
``noB``      without phase B (the column sums);
``noAB``     without either: the stream of X and the barriers alone;
``nosync``   the cluster barrier and the remote reads of the partials
             replaced by a block barrier and local reads;
``nostage``  no copies after the first panel: the arithmetic and the
             barriers on data already in shared memory.

The copies compute wrong results; only their times mean anything. Also
prints the rows per panel, the column units per CTA and how many
clusters the card holds at once. CUDA events, median of ``--reps``.

    python -m bayesbridge_tpu_torch.baselines.onepass_ablation \\
        [--n N] [--pe PE] [--pf PF] [--budget KIB,...] [--reps R]
"""

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import build
from ..kernels.ne_onepass import CLUSTER, plan
from .dev_ne_variants import make_inputs

# The pieces each copy removes (exact source text of csrc/ne_onepass.cu).
_A = 'phase_a<AM, CVT>(a, s, P, ue0, my_ue, uf0, my_uf);'
_B = 'phase_b<BM, CVT>(a, s, P, my_ue, my_uf);'
_STAGE = ('stage(a, s.raw[cur ^ 1], &s.bar[cur ^ 1], next * a.R, ue0, '
          'my_ue,\n            uf0, my_uf);')
_WAIT = 'bar_wait(&s.bar[cur], (it >> 1) & 1);'
_SYNC = 'cluster.sync();  // every CTA'
_REMOTE = 'cluster.map_shared_rank(part, q)[r]'
# How many clusters of the fma:fma kernel the card holds at once.
_FIT = '''
extern "C" int bb_ablation_fit(int rows, int ue, int uf) {
  using namespace bbonepass;
  auto kern = onepass_kernel<A_FMA, B_FMA, false>;
  const size_t smem = smem_bytes(rows, ue, uf, false);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  int fit = -1;
  cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
  return fit;
}
'''


def variants():
    """{name: source} of the ablated copies."""
    src = (build.CSRC / 'ne_onepass.cu').read_text() + _FIT
    missing = [p for p in (_A, _B, _STAGE, _WAIT, _SYNC, _REMOTE)
               if p not in src]
    if missing:
        raise RuntimeError(f"ne_onepass.cu no longer holds {missing}")
    return {
        'base': src,
        'noA': src.replace(_A, ''),
        'noB': src.replace(_B, ''),
        'noAB': src.replace(_A, '').replace(_B, ''),
        'nosync': src.replace(_SYNC, '__syncthreads();  // every CTA')
                     .replace(_REMOTE, 'part[r]'),
        'nostage': src.replace(_STAGE, ';').replace(_WAIT, ';'),
    }


def build_all(sources):
    """One nvcc per copy, all at once; {name: loaded library}."""
    key = hashlib.sha256(''.join(sources.values()).encode()).hexdigest()
    out = build.BUILD_ROOT / 'ablation' / key[:16]
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        cu, so = out / f'{name}.cu', out / f'{name}.so'
        if not so.exists():
            cu.write_text(sources[name])
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-shared',
                            '-I', str(build.CSRC), '-o', str(so), str(cu)],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.bb_ne_onepass.argtypes = build._SIGNATURES['bb_ne_onepass']
        lib.bb_ne_onepass.restype = ctypes.c_int
        lib.bb_ne_onepass_smem.argtypes = [ctypes.c_int] * 4
        lib.bb_ne_onepass_smem.restype = ctypes.c_longlong
        return name, lib

    with ThreadPoolExecutor(len(sources)) as ex:
        return dict(ex.map(one, sources))


class _Plan:  # what kernels.ne_onepass.plan reads of a KernelLibrary
    def __init__(self, lib):
        self.lib = lib


def run(n, pe, pf, budgets_kib, reps, log=print):
    """Times of every copy at each panel budget; returns records."""
    libs = build_all(variants())
    Xe, Xf, ve, vf, c, w = make_inputs(n, pe, pf, torch.device('cuda'))
    ve_pad = torch.zeros(Xe.shape[1], device='cuda')
    ve_pad[:pe] = ve
    vf_pad = torch.zeros(Xf.shape[1], device='cuda')
    vf_pad[:pf] = vf
    max_clusters = 2 * torch.cuda.get_device_properties(
        0).multi_processor_count // CLUSTER
    u = torch.empty(n, device='cuda')
    out = torch.empty(pe + pf, device='cuda')
    partial = torch.empty(max_clusters * (pe + pf), device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    log(f"ne_onepass ablation (fma:fma): n={n} pe={pe} pf={pf} on "
        f"{torch.cuda.get_device_name(0)}")
    recs = []
    for kib in budgets_kib:
        rows, ue, uf = plan(_Plan(libs['base']), Xe.shape[1], Xf.shape[1],
                            False, kib * 1024)
        fit = libs['base'].bb_ablation_fit(rows, ue, uf)
        log(f"  panel budget {kib} KiB: {rows} rows, {ue} int8 + {uf} f32 "
            f"units per CTA, {fit} clusters of {CLUSTER} at once")
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.bb_ne_onepass(
                    Xe.data_ptr(), Xe.shape[1], pe, Xf.data_ptr(),
                    Xf.shape[1], pf, ve_pad.data_ptr(), vf_pad.data_ptr(),
                    c.data_ptr(), w.data_ptr(), n, rows, ue, uf, 0, 0, 0,
                    max_clusters, u.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), stream)
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
            recs.append(dict(budget_kib=kib, name=name, ms=ms))
            log(f"    {name:>8}: {ms:.3f} ms")
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--pe', type=int, default=45_000)
    ap.add_argument('--pf', type=int, default=5_000)
    ap.add_argument('--budget', default='64,128',
                    help='comma list of panel budgets, KiB')
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("onepass_ablation: needs a CUDA device")
    run(args.n, args.pe, args.pf,
        [int(x) for x in args.budget.split(',')], args.reps)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
