"""The chain-batched sweeps (``ne_rows_k``, ``colpass_k``,
``tdots_sweep_k``) built with other values of their tuning constants, and
optionally from an earlier design's sources, timed in turns at one shape
(the flagship's int8 + f32 blocks), on the card.

Builds copies of ``csrc/ne_sweep.cu`` and ``csrc/tdots_sweep.cu`` (with
``sweep_common.cuh``) that differ from the sources in one constant each
(``<key><value>``):

``rows``       ``kRowsPerWarpK`` (rows each warp of the batched row pass
               owns);
``warpsC-``    ``kRowWarpsKC`` (warps a row-pass CTA for C = 2, 4 or 8
               chains, which share its staged chunks of v);
``chunk``      ``kRowChunkK`` (columns of v a chunk);
``rowstages``  ``kRowStagesK`` (chunks of v staged at once);
``xstages``    ``kRowXStagesK`` (steps of a warp's rows staged at once);
``cols``       ``kColBytesInFlight`` (bytes of the next rows each
               column-pass thread keeps in flight);
``cols5-``     ``kColBytesInFlight5`` (the same for the five-reduction
               pre-solve at up to 4 chains);
``panel``      ``kTdPanelBytes`` (bytes of X a pre-solve panel, 5-8
               chains);
``tdstages``   ``kTdStages`` (pre-solve panels staged at once);
``minblocks``  ``kTdMinBlocks`` (pre-solve CTAs an SM is compiled for);
``unroll``     ``kTdUnroll`` (pre-solve rows a loop body holds).

A name joins several with ``+`` (``rows4+warps8-16``). The cuts
(``cut-...``) take a part of the work out and so change the results;
they are timed but not held to the sources' bits:

``cut-u``      the pre-solve reads each panel's first row of u for every
               row (the u loads leave the row loop);
``cut-x``      the pre-solve reads each panel's first row of X for every
               row (the X loads, conversions and squares leave it);
``cut-sync``   the pre-solve neither waits for its panels nor syncs its
               warps per panel;
``cut-v``      the row pass multiplies by constants in place of v (no
               shared-memory loads of v).

``base`` is the sources as they are; with ``--baseline DIR`` also
``baseline``, a build of the three files found in DIR (an earlier
design; its launches serve its own ``bb_max_chains`` chains each).
Every copy must give the sources' bits (no constant changes a sum's
order, and every design equals the single-vector launches); each is
timed for 2, 4 and 8 chains, the copies in turns, forth and back, each
kernel through the package's launch helpers with the copy's library.
CUDA events, median of ``--reps``; the line per copy and k holds the
mean of its two turns, and ``--out`` writes the records as JSON.

    python -m bayesbridge_tpu_torch.baselines.batched_variants \\
        [--n N] [--pe PE] [--pf PF] [--reps R] [--variants a,b,...] \\
        [--baseline DIR] [--out FILE]
"""

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import build, layout
from ..kernels.ne_sweep import batched_colpass, rows_k_launches

# key: (the line that sets the constant, the values tried)
_CONSTANTS = {
    'rows': ('constexpr int kRowsPerWarpK = {};', (4,)),
    'warps2-': ('constexpr int kRowWarpsK2 = {};', (8, 12)),
    'warps4-': ('constexpr int kRowWarpsK4 = {};', (8, 16)),
    'warps8-': ('constexpr int kRowWarpsK8 = {};', (8, 16)),
    'chunk': ('constexpr int kRowChunkK = {};', (256, 1024)),
    'rowstages': ('constexpr int kRowStagesK = {};', (2, 4)),
    'xstages': ('constexpr int kRowXStagesK = {};', (2,)),
    'cols': ('constexpr int kColBytesInFlight = {};', (32, 128)),
    'cols5-': ('constexpr int kColBytesInFlight5 = {};', (64,)),
    'panel': ('constexpr int kTdPanelBytes = {};', (8192, 32768)),
    'tdstages': ('constexpr int kTdStages = {};', (3,)),
    'minblocks': ('constexpr int kTdMinBlocks = {};', (1,)),
    'unroll': ('constexpr int kTdUnroll = {};', (2, 8)),
}
# cut: (file, text, its replacement)
_CUTS = {
    'cut-u': ('tdots_sweep.cu', 'up + (j * PR + i) * C)',
              'up + j * PR * C)'),
    'cut-x': ('tdots_sweep.cu', 'td_load<T, N>(xp + i * ROWB, x)',
              'td_load<T, N>(xp, x)'),
    'cut-sync': ('tdots_sweep.cu',
                 'cp_async_wait<kTdStages - 2>();\n    __syncthreads();', ''),
    'cut-v': ('ne_sweep.cu',
              '*reinterpret_cast<const float4*>(vb + (c * G + J) * U * 4)',
              'make_float4(c, J, 1.f, 2.f)'),
}
_FILES = ('ne_sweep.cu', 'tdots_sweep.cu', 'sweep_common.cuh')
_FUNCS = ('bb_ne_rows_k', 'bb_colpass_k', 'bb_tdots_sweep_k',
          'bb_max_chains', 'bb_rows_per_block', 'bb_ne_rows', 'bb_colpass',
          'bb_tdots_sweep')


def _edits():
    """{name: (file, text, replacement)} of every one-constant copy and
    every cut."""
    src = {f: (build.CSRC / f).read_text() for f in _FILES}
    out = {}
    for key, (pat, values) in _CONSTANTS.items():
        head = pat.split('{}')[0]
        hits = [f for f in _FILES if head in src[f]]
        if len(hits) != 1 or src[hits[0]].count(head) != 1:
            raise RuntimeError(f"the sources no longer hold {pat!r} once")
        line = next(ln for ln in src[hits[0]].splitlines()
                    if ln.startswith(head))
        for value in values:
            out[f'{key.rstrip("-")}{"-" if key.endswith("-") else ""}'
                f'{value}'] = (hits[0], line, pat.format(value))
    for name, (f, old, new) in _CUTS.items():
        if src[f].count(old) != 1:
            raise RuntimeError(f"{name}: {f} no longer holds {old!r} once")
        out[name] = (f, old, new)
    return src, out


def variants(names=None, baseline=None):
    """{name: {file: source}} of the copies (`names`: a subset, each one
    edit or several joined by '+'; 'base' always included); `baseline`:
    a directory holding an earlier design's three files."""
    src, edits = _edits()
    out = {'base': src}
    for name in (edits if names is None else names):
        if name == 'base':
            continue
        files = dict(src)
        for part in name.split('+'):
            f, old, new = edits[part]
            files[f] = files[f].replace(old, new)
        out[name] = files
    if baseline is not None:
        out['baseline'] = {f: (Path(baseline) / f).read_text()
                           for f in _FILES}
    return out


def build_all(sources):
    """One nvcc per source file of each copy, all at once, then one link
    per copy; {name: KernelLibrary} of the copies that build."""
    def one(name):
        files = sources[name]
        key = hashlib.sha256(''.join(files.values()).encode()).hexdigest()
        out = build.BUILD_ROOT / 'batched_variants' / key[:16]
        out.mkdir(parents=True, exist_ok=True)
        so = out / 'lib.so'
        if not so.exists():
            for f, text in files.items():
                (out / f).write_text(text)
            objs = [out / (f[:-3] + '.o') for f in _FILES if f.endswith('.cu')]
            for o in objs:
                done = subprocess.run(
                    [build._nvcc(), *build.NVCC_FLAGS, '-c', '-o', str(o),
                     str(out / (o.stem + '.cu'))], capture_output=True)
                if done.returncode:  # e.g. more shared memory than a CTA has
                    return name, None
            subprocess.run([build._nvcc(), '-gencode',
                            'arch=compute_90a,code=sm_90a', '-shared', '-o',
                            str(so), *map(str, objs)], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(so))
        for fn in _FUNCS:
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        lib.bb_error_string.argtypes = [ctypes.c_int]
        lib.bb_error_string.restype = ctypes.c_char_p
        return name, build.KernelLibrary(lib, so, 0.0, '')

    with ThreadPoolExecutor(len(sources)) as ex:
        return {name: kl for name, kl in ex.map(one, sources)
                if kl is not None}


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernels(kl, Xs, ps, Vs, c, Us):
    """{kernel: call} of the four batched launches from library `kl`,
    each in launches of the library's own chains."""
    n = Xs[0].shape[0]
    dt0 = layout.DTYPE_CODE[Xs[0].dtype]
    blocks = list(zip(Xs, Vs))

    def cols(R, us):
        cmax = kl.lib.bb_max_chains(R, dt0)
        return lambda: batched_colpass('batched_variants', Xs, ps, n, us, R,
                                       kl, cmax)[0]
    return {'rows': lambda: rows_k_launches(
                kl, kl.lib.bb_max_chains(0, dt0), blocks, c)[0],
            'cols': cols(1, Us[:1]), 'tdots5': cols(5, Us),
            'tdots4': cols(4, Us[:3])}


def run(n, pe, pf, reps, names=None, baseline=None, log=print):
    """Times of every copy for k = 2, 4, 8; returns records."""
    sources = variants(names, baseline)
    libs = build_all(sources)
    for name in sorted(set(sources) - set(libs)):
        log(f"  {name}: does not build (skipped)")
    gen = torch.Generator(device='cuda').manual_seed(0)
    Xe = torch.zeros((n, layout.padded_width(pe)), dtype=torch.int8,
                     device='cuda')
    for i in range(0, n, 4096):
        Xe[i:i + 4096, :pe] = torch.rand(
            (min(4096, n - i), pe), generator=gen, device='cuda') < 0.1
    Xf = torch.zeros((n, layout.padded_width(pf)), device='cuda')
    Xf[:, :pf] = torch.randn((n, pf), generator=gen, device='cuda')
    Xs, ps = [Xe, Xf], [pe, pf]
    log(f"batched sweep variants: n={n} pe={pe} pf={pf} on "
        f"{torch.cuda.get_device_name(0)}; copies {list(libs)}")
    recs = []
    for k in (2, 4, 8):
        Vs = [torch.randn((k, p), generator=gen, device='cuda') for p in ps]
        c = torch.zeros(k, device='cuda')
        Us = [torch.randn((k, n), generator=gen, device='cuda')
              for _ in range(4)]
        fns = {name: _kernels(kl, Xs, ps, Vs, c, Us)
               for name, kl in libs.items()}
        times, ref = {}, None
        for name in list(libs) + list(libs)[::-1]:
            outs = [fn() for fn in fns[name].values()]
            ref = outs if ref is None else ref
            if 'cut-' not in name and not all(
                    torch.equal(a, b) for a, b in zip(outs, ref)):
                raise AssertionError(f"{name}: other bits than base")
            del outs
            for key, fn in fns[name].items():
                times.setdefault((name, key), []).append(_time_ms(fn, reps))
        for name in libs:
            rec = dict(k=k, name=name, **{
                key: statistics.mean(times[(name, key)])
                for key in fns[name]})
            recs.append(rec)
            log(f"  k={k} {name:>12}: " + ', '.join(
                f"{key} {rec[key]:.3f}" for key in fns[name]) + " ms")
        del Vs, Us, fns
        torch.cuda.empty_cache()
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--pe', type=int, default=45_001)
    ap.add_argument('--pf', type=int, default=4_999)
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--variants', default=None,
                    help="comma-separated copies (default: all)")
    ap.add_argument('--baseline', default=None,
                    help="directory of an earlier design's three sources")
    ap.add_argument('--out', default=None, help="JSON file of the records")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("batched_variants: needs a CUDA device")
    names = None if args.variants is None else set(args.variants.split(','))
    recs = run(args.n, args.pe, args.pf, args.reps, names, args.baseline)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=torch.cuda.get_device_name(0), n=args.n, pe=args.pe,
                 pf=args.pf, reps=args.reps, records=recs), indent=1))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
