"""The chain-batched sweeps (``ne_rows_k``, ``colpass_k``,
``tdots_sweep_k``) built with other values of their tuning constants,
timed in turns at one shape (the flagship's int8 + f32 blocks), on the
card.

Builds copies of ``csrc/ne_sweep.cu`` and ``csrc/tdots_sweep.cu`` (with
``sweep_common.cuh``) that differ from the sources in one constant each:

``base``       the sources as they are;
``rows2``      ``kRowsPerWarpK`` 2 (rows per warp of the batched row pass);
``rows8``      ``kRowsPerWarpK`` 8;
``cols32``     ``kColBytesInFlight`` 32 (bytes of the next rows each
               column-pass thread keeps in flight, one or four
               reductions);
``cols128``    ``kColBytesInFlight`` 128;
``tdots64``    ``kColBytesInFlight5`` 64 (the same for the five-reduction
               pre-solve).

Every copy must give the sources' bits (the constants change no sum's
order); each is timed for 2, 4 and 8 chains, the copies in turns, forth
and back, through the package's wrappers. CUDA events, median of
``--reps``; the line per copy and k holds the mean of its two turns.

    python -m bayesbridge_tpu_torch.baselines.batched_variants \\
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
from ..kernels.ne_sweep import colpass_k, ne_rows_k
from ..kernels.tdots_sweep import tdots_sweep_k

_CONSTANTS = {'rows': 'constexpr int kRowsPerWarpK = {};',
              'cols': 'constexpr int kColBytesInFlight = {};',
              'tdots': 'constexpr int kColBytesInFlight5 = {};'}
_FILES = ('ne_sweep.cu', 'tdots_sweep.cu', 'sweep_common.cuh')
_FUNCS = ('bb_ne_rows_k', 'bb_colpass_k', 'bb_tdots_sweep_k',
          'bb_max_chains', 'bb_rows_per_block', 'bb_ne_rows', 'bb_colpass',
          'bb_tdots_sweep')


def variants():
    """{name: {file: source}} of the copies."""
    src = {f: (build.CSRC / f).read_text() for f in _FILES}
    base = {}
    for key, pat in _CONSTANTS.items():
        hits = [f for f in _FILES if pat.split('{}')[0] in src[f]]
        if len(hits) != 1:
            raise RuntimeError(f"the sources no longer hold {pat!r} once")
        line = next(ln for ln in src[hits[0]].splitlines()
                    if ln.startswith(pat.split('{}')[0]))
        base[key] = (hits[0], line)

    def copy(key, value):
        f, line = base[key]
        out = dict(src)
        out[f] = src[f].replace(line, _CONSTANTS[key].format(value))
        return out

    return {'base': src, 'rows2': copy('rows', 2), 'rows8': copy('rows', 8),
            'cols32': copy('cols', 32), 'cols128': copy('cols', 128),
            'tdots64': copy('tdots', 64)}


def build_all(sources):
    """One nvcc per source file of each copy, all at once, then one link
    per copy; {name: KernelLibrary}."""
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
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, '-c', '-o',
                                str(o), str(out / (o.stem + '.cu'))],
                               check=True, capture_output=True)
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
        return dict(ex.map(one, sources))


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


def run(n, pe, pf, reps, log=print):
    """Times of every copy for k = 2, 4, 8; returns records. The wrappers
    launch whichever library the loader holds, so each copy is swapped in
    for its turns and the package's own is restored after."""
    libs = build_all(variants())
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
        f"{torch.cuda.get_device_name(0)}")
    recs, saved = [], build._LOADED
    try:
        for k in (2, 4, 8):
            Vs = [torch.randn((k, p), generator=gen, device='cuda')
                  for p in ps]
            c = torch.zeros(k, device='cuda')
            Us = [torch.randn((k, n), generator=gen, device='cuda')
                  for _ in range(4)]
            fns = {'rows': lambda: ne_rows_k(list(zip(Xs, Vs)), c),
                   'cols': lambda: colpass_k(Xs, ps, Us[0]),
                   'tdots5': lambda: tdots_sweep_k(Xs, ps, *Us),
                   'tdots4': lambda: tdots_sweep_k(Xs, ps, *Us[:3])}
            times, ref = {}, None
            for name in list(libs) + list(libs)[::-1]:
                build._LOADED = libs[name]
                outs = [fns['rows']()] + fns['cols']() + [
                    o for blk in fns['tdots5']() for o in blk]
                ref = outs if ref is None else ref
                if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                    raise AssertionError(f"{name}: other bits than base")
                for key, fn in fns.items():
                    times.setdefault((name, key), []).append(
                        _time_ms(fn, reps))
            for name in libs:
                rec = dict(k=k, name=name, **{
                    key: statistics.mean(times[(name, key)]) for key in fns})
                recs.append(rec)
                log(f"  k={k} {name:>8}: " + ', '.join(
                    f"{key} {rec[key]:.3f}" for key in fns) + " ms")
    finally:
        build._LOADED = saved
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--pe', type=int, default=45_001)
    ap.add_argument('--pf', type=int, default=4_999)
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("batched_variants: needs a CUDA device")
    run(args.n, args.pe, args.pf, args.reps)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
