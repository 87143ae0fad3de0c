"""The nibble pre-solve (``tdots_sweep`` over a packed int4 block beside an
f32 block) against earlier designs and the int8 mode, built with other
values of its tuning constants and with parts of its work cut out, timed
in turns at the flagship's shape, on the card.

Builds copies of ``csrc/tdots_sweep.cu`` and ``csrc/ne_sweep.cu`` (with
``sweep_common.cuh``) that differ from the sources in one constant each
(``<key><value>``):

``urows``      ``kI4Urows`` (rows of u staged at a time);
``minblocks``  ``kI4MinBlocks`` (CTAs an SM is compiled for);
``funit``      ``kI4FUnit`` (bytes of an f32 row a lane owns);
``bytes``      ``kI4Bytes`` (bytes of the next rows a nibble lane loads
               at once);
``fbytes``     ``kI4FBytes`` (the same for an f32 lane).

A name joins several with ``+`` (``urows4096+minblocks3``). The cuts
(``cut-...``) take a part of the work out and so change the results;
they are timed but not held to the sources' bits:

``cut-u``       no u staging: the staged rows keep whatever the shared
                memory held;
``cut-x``       no X loads: every row reads its load group's first row;
``cut-sync``    no barriers around the staging;
``cut-square``  no square (the non-binary mode's fifth FMA and its FMUL).

``base`` is the sources as they are; with ``--baseline DIR[,DIR]`` also
``baseline:<dir name>``, a build of the three files found in each DIR (an
earlier design, for example ``git show <commit>:bayesbridge_tpu_torch/csrc/<file>``
copies of the first nibble design, the column pass's tiles, from the
commit before this kernel; a ``bb_tdots_sweep`` without the ``binary``
argument runs its one nibble mode), and ``baseline:<dir name>+1cta``,
that copy with 120 KB of dynamic shared memory a column-pass CTA, so an
SM holds one CTA at every reduction count (the first design's
five-reduction build holds one anyway; its four-reduction one two), run
on the int4 block and in its int8 mode. Each library is timed over the
same blocks: the int8 block and its packed form (0/1 at 10% density, the
flagship's exact block) and a block of values in [-8, 7] of the same
shape, beside one f32 block; at five and four reductions; each copy in
its nibble mode and, where it has one, its binary mode (on the 0/1
block), and the int8 mode. Every copy but the cuts must give the int8
mode's bits; the int8 mode within 1e-4 of max|plain|. The copies run in
turns, forth and back; CUDA events, median of ``--reps`` each, the line
holding the mean of the two turns beside the bound (bytes over 3,350
GB/s). Each copy's ptxas registers and spills for the pre-solve's
kernels are logged; ``--out`` writes the records as JSON.

    python -m bayesbridge_tpu_torch.baselines.presolve_i4_variants \\
        [--n N] [--pe PE] [--pf PF] [--reps R] [--variants a,b,...] \\
        [--baseline DIR] [--out FILE]

Check-only: nothing on the main path imports it.
"""

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import build, layout
from ..kernels.tdots_sweep import tdots_sweep_plain

HBM_BYTES_PER_S = 3.35e12
RTOL = 1e-4
_FILES = ('ne_sweep.cu', 'tdots_sweep.cu', 'sweep_common.cuh')
# key: (the line that sets the constant, the values tried)
_CONSTANTS = {
    'urows': ('constexpr int kI4Urows = {};', (256, 2048)),
    'minblocks': ('constexpr int kI4MinBlocks = {};', (1, 3)),
    'funit': ('constexpr int kI4FUnit = {};', (16,)),
    'bytes': ('constexpr int kI4Bytes = {};', (32, 128)),
    'fbytes': ('constexpr int kI4FBytes = {};', (64, 256)),
}
# cut: (file, text, its replacement)
_CUTS = {
    'cut-u': ('tdots_sweep.cu', '      su[i] = s;\n', ''),
    'cut-x': ('tdots_sweep.cu', 'load_words<L::unit>(nx + j * ldb, qn[j]);',
              'load_words<L::unit>(xb, qn[j]);'),
    'cut-sync': ('tdots_sweep.cu', '''    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      float4 s = make_float4(u0[rb + i], u1[rb + i], u2[rb + i], 0.f);
      if constexpr (K == 5) s.w = u3[rb + i];
      su[i] = s;
    }
    __syncthreads();''', '''    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      float4 s = make_float4(u0[rb + i], u1[rb + i], u2[rb + i], 0.f);
      if constexpr (K == 5) s.w = u3[rb + i];
      su[i] = s;
    }'''),
    'cut-square': ('tdots_sweep.cu',
                   '      acc[3][e] = fmaf(xs[e] * xs[e], w.z, acc[3][e]);\n',
                   ''),
}
# The edit of a baseline copy (`+1cta`): one column-pass CTA an SM.
_ONE_CTA = ('sweep_common.cuh',
            '  colpass_kernel<T0, T1, K><<<grid, kThreads, 0, stream>>>(',
            '  cudaFuncSetAttribute(colpass_kernel<T0, T1, K>, '
            'cudaFuncAttributeMaxDynamicSharedMemorySize, 122880);\n'
            '  colpass_kernel<T0, T1, K><<<grid, kThreads, 122880, '
            'stream>>>(')
_OLD_SIGNATURE = [build._I, build._P, build._L, build._I, build._I,
                  build._P, build._L, build._I, build._L, build._P,
                  build._P, build._P, build._P, build._I, build._L,
                  build._P, build._P, build._P]


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
            out[f'{key}{value}'] = (hits[0], line, pat.format(value))
    for name, (f, old, new) in _CUTS.items():
        if src[f].count(old) != 1:
            raise RuntimeError(f"{name}: {f} no longer holds {old!r} once")
        out[name] = (f, old, new)
    return src, out


def variants(names=None, baseline=None):
    """{name: {file: source}} of the copies (`names`: a subset, each one
    edit or several joined by '+'; 'base' always included); `baseline`:
    directories (comma-separated), each holding an earlier design's three
    files, built as they are and with `_ONE_CTA`."""
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
    for d in baseline.split(',') if baseline else ():
        files = {f: (Path(d) / f).read_text() for f in _FILES}
        out[f'baseline:{Path(d).name}'] = files
        f, old, new = _ONE_CTA
        if files[f].count(old) != 1:
            raise RuntimeError(f"{d}/{f} does not hold {old!r} once")
        out[f'baseline:{Path(d).name}+1cta'] = dict(
            files, **{f: files[f].replace(old, new)})
    return out


def ptxas_kernels(log):
    """[(label, registers, spill bytes)] of the pre-solve's kernels in a
    ptxas -v log: the nibble pre-solve's instantiations (K, binary) and
    the first design's column pass over a nibble block (K)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            spill = 0
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if not m:
            continue
        regs, label = int(m.group(1)), None
        k = re.search(r'tdots_i4_kernelILi(\d)ELb([01])E', name)
        if k:
            label = f"nibble K={k.group(1)}" + \
                (" binary" if k.group(2) == '1' else '')
        elif 'colpass_kernel' in name and 'Nib4' in name:
            k = re.search(r'Li([45])EEEv', name)
            label = f"first K={k.group(1)}" if k else None
        if label is not None:
            out.append((label, regs, spill))
        name = None
    return out


def build_all(sources):
    """One nvcc per source file of each copy, all at once, then one link
    per copy; {name: (KernelLibrary, ptxas log)} of the copies that
    build."""
    def one(name):
        files = sources[name]
        key = hashlib.sha256(''.join(files.values()).encode()).hexdigest()
        out = build.BUILD_ROOT / 'presolve_i4_variants' / key[:16]
        out.mkdir(parents=True, exist_ok=True)
        so, logf = out / 'lib.so', out / 'ptxas.log'
        if not so.exists():
            for f, text in files.items():
                (out / f).write_text(text)
            objs = [out / (f[:-3] + '.o') for f in _FILES if f.endswith('.cu')]
            log = ''
            for o in objs:
                done = subprocess.run(
                    [build._nvcc(), *build.NVCC_FLAGS, '-Xptxas', '-v', '-c',
                     '-o', str(o), str(out / (o.stem + '.cu'))],
                    capture_output=True, text=True)
                log += done.stdout + done.stderr
                if done.returncode:
                    return name, None, log
            subprocess.run([build._nvcc(), '-gencode',
                            'arch=compute_90a,code=sm_90a', '-shared', '-o',
                            str(so), *map(str, objs)], check=True,
                           capture_output=True)
            logf.write_text(log)
        lib = ctypes.CDLL(str(so))
        new = 'int binary,' in files['tdots_sweep.cu']
        lib.bb_tdots_sweep.argtypes = build._SIGNATURES['bb_tdots_sweep'] \
            if new else _OLD_SIGNATURE
        lib.bb_tdots_sweep.restype = ctypes.c_int
        lib.bb_error_string.argtypes = [ctypes.c_int]
        lib.bb_error_string.restype = ctypes.c_char_p
        kl = build.KernelLibrary.__new__(build.KernelLibrary)
        kl.lib, kl.path, kl.build_seconds = lib, so, 0.0
        kl.ptxas_log = logf.read_text()
        return name, (kl, new), kl.ptxas_log

    with ThreadPoolExecutor(len(sources)) as ex:
        done = list(ex.map(one, sources))
    return ({name: lib for name, lib, _ in done if lib is not None},
            {name: log for name, lib, log in done if lib is None})


def _launch(kl, new, Xs, ps, us, binary):
    """One pre-solve launch by library `kl` (in binary mode where `new`
    and `binary`); the (K, p0 + p1) output."""
    n = Xs[0].shape[0]
    X0, Xf = Xs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = layout.col_tiles(ps[0], X0) + layout.col_tiles(ps[1], Xf)
    n_seg, rows = layout.segments_for(n, tiles, sms)
    K = 4 if len(us) == 3 else 5
    p_total = sum(ps)
    out = torch.empty((K, p_total), device='cuda')
    partial = torch.empty(n_seg * K * p_total, device='cuda')
    u4 = us[3].data_ptr() if K == 5 else None
    args = [layout.DTYPE_CODE[X0.dtype], X0.data_ptr(), X0.shape[1], ps[0],
            0, Xf.data_ptr(), Xf.shape[1], ps[1], n,
            us[0].data_ptr(), us[1].data_ptr(), us[2].data_ptr(), u4]
    if new:
        args.append(int(binary))
    args += [n_seg, rows, partial.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream().cuda_stream]
    kl.check(kl.lib.bb_tdots_sweep(*args), 'bb_tdots_sweep')
    return out


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


def make_blocks(n, pe, pf, gen):
    """(int8 0/1 block, its packed form, int8 [-8, 7] block, its packed
    form, f32 block), built on the card in row chunks."""
    w = layout.padded_width(pe, int4=True)
    X8b = torch.zeros((n, w), dtype=torch.int8, device='cuda')
    X8s = torch.zeros((n, w), dtype=torch.int8, device='cuda')
    for i in range(0, n, 4096):
        m = min(4096, n - i)
        X8b[i:i + m, :pe] = torch.rand((m, pe), generator=gen,
                                       device='cuda') < 0.1
        X8s[i:i + m, :pe] = torch.randint(-8, 8, (m, pe), generator=gen,
                                          device='cuda', dtype=torch.int8)
    Xf = torch.zeros((n, layout.padded_width(pf)), device='cuda')
    Xf[:, :pf] = torch.randn((n, pf), generator=gen, device='cuda')
    return X8b, layout.pack_int4(X8b), X8s, layout.pack_int4(X8s), Xf


def run(n, pe, pf, reps, names=None, baseline=None, log=print):
    """Times of every copy and mode; returns (records, registers)."""
    sources = variants(names, baseline)
    libs, failed = build_all(sources)
    for name, text in failed.items():
        log(f"  {name}: does not build (skipped)\n" + text[-2000:])
    regs = {name: ptxas_kernels(kl.ptxas_log)
            for name, (kl, _) in libs.items()}
    for name, rows in regs.items():
        log(f"  ptxas {name}: " + '; '.join(
            f"{label} {r} registers, {s} bytes spilled"
            for label, r, s in rows))
    gen = torch.Generator(device='cuda').manual_seed(0)
    X8b, X4b, X8s, X4s, Xf = make_blocks(n, pe, pf, gen)
    ps = [pe, pf]
    us = [torch.randn(n, generator=gen, device='cuda') for _ in range(4)]
    gb = {'bin': (X4b.numel() + 4 * Xf.numel()) / 1e9,
          'small': (X4s.numel() + 4 * Xf.numel()) / 1e9}
    log(f"nibble pre-solve variants: n={n} pe={pe} pf={pf} on "
        f"{torch.cuda.get_device_name(0)}; copies {list(libs)}; "
        f"{gb['bin']:.4f} GB packed + f32")
    recs = []
    for K in (5, 4):
        u = us[:K - 1]
        extra = 4 * (pe + pf) * K + 4 * n * (K - 1)
        for data, X8, X4 in (('bin', X8b, X4b), ('small', X8s, X4s)):
            bound = (gb[data] * 1e9 + extra) / HBM_BYTES_PER_S * 1e3
            calls = {'int8': (libs['base'], [X8, Xf], False)}
            for name, (kl, new) in libs.items():
                calls[name] = ((kl, new), [X4, Xf], False)
                if new and data == 'bin':
                    calls[name + ':binary'] = ((kl, new), [X4, Xf], True)
                if name.endswith('+1cta'):
                    calls[name + ':int8'] = ((kl, new), [X8, Xf], False)
            fns = {key: (lambda lib=lib, Xs=Xs, b=b: _launch(
                       *lib, Xs, ps, u, b))
                   for key, (lib, Xs, b) in calls.items()}
            ref = fns['int8']()
            blocks = tdots_sweep_plain([X4, Xf], ps, *u)
            want = torch.cat([torch.stack(b) for b in blocks], dim=1)
            err = float((ref - want).abs().max())
            scale = float(want.abs().max())
            assert err <= RTOL * scale, ('int8 mode against plain', err)
            for key, fn in fns.items():
                if 'cut-' in key:
                    continue
                got = fn()
                if not torch.equal(got, ref):
                    raise AssertionError(f"K={K} {data} {key}: other bits "
                                         "than the int8 mode")
            times = {}
            order = list(fns) + list(fns)[::-1]
            for key in order:
                times.setdefault(key, []).append(_time_ms(fns[key], reps))
            for key in fns:
                ms = statistics.mean(times[key])
                rec = dict(K=K, data=data, name=key, ms=ms,
                           turns=times[key], bound_ms=bound,
                           pct=100 * bound / ms)
                recs.append(rec)
                log(f"  K={K} {data:>5} {key:>22}: {ms:.3f} ms "
                    f"({rec['pct']:.0f}% of {bound:.3f}; turns "
                    f"{[round(t, 3) for t in times[key]]})")
            log(f"  K={K} {data}: every copy but the cuts gives the int8 "
                f"mode's bits; int8 within {err / scale:.1e} of max|plain|")
            del fns, ref, want
            torch.cuda.empty_cache()
    return recs, regs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--pe', type=int, default=45_000)
    ap.add_argument('--pf', type=int, default=5_000)
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--variants', default=None,
                    help="comma-separated copies (default: all)")
    ap.add_argument('--baseline', default=None,
                    help="directories (comma-separated) of earlier "
                    "designs' three sources")
    ap.add_argument('--out', default=None, help="JSON file of the records")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("presolve_i4_variants: needs a CUDA device")
    names = None if args.variants is None else set(args.variants.split(','))
    recs, regs = run(args.n, args.pe, args.pf, args.reps, names,
                     args.baseline)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=torch.cuda.get_device_name(0), n=args.n, pe=args.pe,
                 pf=args.pf, reps=args.reps, registers=regs, records=recs),
            indent=1))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
