"""The ell gather kernel's two traversals, copies of ``csrc/ell.cu`` with
other tuning constants, and a cut, timed in turns at the ell slice's
col-ELL and row-ELL, on the card.

The design is the chip smoke's ell slice (``utils.simulate_data``
``normal_design``: n x 16,384, 164 standard-normal draws a row, seed 0;
``--per-row`` takes fewer for a sparser one), stored as the port's dual
row-ELL in float64 and float32, with each orientation's
:class:`..kernels.ell.EllLayout`. Routes:

``first``      ``bb_ell`` of the sources as they are: one warp per row,
               every gather through L2;
``win``        ``bb_ell_win`` of the sources: the windowed traversal;
``win-<copy>`` ``bb_ell_win`` of a copy built with one edit:
               ``warps<n>`` sets ``kWinWarps`` (consumer warps a CTA),
               ``<R|U><64|32>k<k>=<n>`` one entry of ``kRowsF64`` /
               ``kUnrollF64`` / ``kRowsF32`` / ``kUnrollF32`` (rows a warp
               owns, groups of each row loaded at once, for k vectors);
               edits join with ``+``; or the sources with another window,
               ``winb<bytes>`` (the plan's ``win_bytes``);
``cut-l1``     ``bb_ell`` of a copy that gathers from ``xt[idx & mask]``,
               the first 128 KB of the interleaved vectors: the same
               instructions with a vector that fits L1. It changes the
               results and is timed only;
``cusparse``   ``torch.mv`` of the CSR of the same matrix (k = 1; a
               yardstick, never called by the port).

Every route but the cut must give ``first``'s bits (power 1 and 2). The
routes are timed in turns, forth and back, for each orientation, dtype
and k, CUDA events, median of ``--reps`` timings of 10 calls each; the
line per route holds the mean of its two turns beside the bound (the
padded ELL arrays, the vectors and the outputs once over 3,350 GB/s;
for the windowed routes the valid slots and the window pointers they
read in place of the padded arrays), and the traversal that
``kernels.ell.takes_window`` picks for the launch beside the faster of
``first`` and ``win``. ``--out`` writes the records as JSON.

    python -m bayesbridge_tpu_torch.baselines.ell_variants \\
        [--n N] [--per-row P] [--reps R] [--ks 1,2,...] \\
        [--variants a,b,...] [--out FILE]
"""

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..kernels import build
from ..kernels import ell as ell_mod
from ..utils.simulate_data import normal_design

HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published HBM rate
# key: (the line that sets the constant, the values tried)
_CONSTANTS = {
    'warps': ('constexpr int kWinWarps = {};', (12, 24)),
}
# The table copies tried by default: <R|U><64|32>k<k>=<value> sets one
# entry of kRowsF64 / kUnrollF64 / kRowsF32 / kUnrollF32.
_TABLE_COPIES = ('U64k1=6', 'R64k2=3', 'R64k8=4', 'U32k1=3')
_TABLES = {'R64': 'kRowsF64', 'U64': 'kUnrollF64', 'R32': 'kRowsF32',
           'U32': 'kUnrollF32'}
_WIN_BYTES = (65536, 114688)  # other windows (plan win_bytes)
_CUT = ('load_k<K>(xt + (int64_t)__ldg(ir + s) * K, xj);',
        'load_k<K>(xt + (int64_t)(__ldg(ir + s) & (int)(131072 / '
        '(K * sizeof(T)) - 1)) * K, xj);')
_FUNCS = ('bb_ell', 'bb_ell_win', 'bb_ell_win_rows')


def _table_edit(src, name):
    """ell.cu with one table entry set, for a copy named like
    'R64k2=3'."""
    m = re.fullmatch(r'([RU](?:64|32))k([1-8])=(\d+)', name)
    if m is None:
        raise ValueError(f"no copy {name!r}")
    head = f'constexpr int {_TABLES[m[1]]}[kMaxVectors + 1] = {{'
    line = next(ln for ln in src.splitlines() if ln.startswith(head))
    vals = line[len(head):line.index('}')].split(', ')
    vals[int(m[2])] = m[3]
    return src.replace(line, head + ', '.join(vals) + '};')


def variants(names=None):
    """{copy: source of ell.cu}: 'base', the one-constant copies, the
    table copies and 'cut-l1' (`names`: the copies to build, each one
    edit or several joined by '+'; 'base' always included)."""
    src = (build.CSRC / 'ell.cu').read_text()
    edits = {}
    for key, (pat, values) in _CONSTANTS.items():
        head = pat.split('{}')[0]
        if src.count(head) != 1:
            raise RuntimeError(f"ell.cu no longer holds {pat!r} once")
        line = next(ln for ln in src.splitlines() if ln.startswith(head))
        for value in values:
            edits[f'{key}{value}'] = \
                lambda text, line=line, new=pat.format(value): \
                text.replace(line, new)
    if src.count(_CUT[0]) != 1:
        raise RuntimeError(f"ell.cu no longer holds {_CUT[0]!r} once")
    edits['cut-l1'] = lambda text: text.replace(*_CUT)
    if names is None:
        names = list(edits) + list(_TABLE_COPIES)
    out = {'base': src}
    for name in names:
        if name == 'base':
            continue
        text = src
        for part in name.split('+'):
            text = edits[part](text) if part in edits \
                else _table_edit(text, part)
        out[name] = text
    return out


def build_all(sources):
    """One nvcc per copy, all at once; {name: KernelLibrary} of the
    copies that build."""
    def one(name):
        text = sources[name]
        key = hashlib.sha256(text.encode()).hexdigest()[:16]
        out = build.BUILD_ROOT / 'ell_variants' / key
        out.mkdir(parents=True, exist_ok=True)
        so = out / 'lib.so'
        if not so.exists():
            (out / 'ell.cu').write_text(text)
            (out / 'mbarrier.cuh').write_text(
                (build.CSRC / 'mbarrier.cuh').read_text())
            done = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, '-Xptxas', '-v', '-shared',
                 '-o', str(so), str(out / 'ell.cu')], capture_output=True,
                text=True)
            (out / 'ptxas.log').write_text(done.stdout + done.stderr)
            if done.returncode:
                print(f"  {name}: nvcc failed\n{done.stderr[-2000:]}")
                return name, None
        lib = ctypes.CDLL(str(so))
        for fn in _FUNCS:
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        return name, lib

    with ThreadPoolExecutor(len(sources)) as ex:
        return {name: lib for name, lib in ex.map(one, sources)
                if lib is not None}


def ptxas_summary(log):
    """{(dtype, k, power): (registers, spill store bytes, spill load bytes)}
    of the windowed kernel's instances in an ``-Xptxas -v`` log."""
    out, key, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r'Compiling entry function .*ell_win_kernelI([df])Li(\d)'
                      r'ELi(\d)E', line)
        if m:
            key = ({'d': 'f64', 'f': 'f32'}[m[1]], int(m[2]), int(m[3]))
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and key:
            spill = (int(m[1]), int(m[2]))
        m = re.search(r'Used (\d+) registers', line)
        if m and key:
            out[key] = (int(m[1]),) + spill
            key, spill = None, (0, 0)
    return out


class _Lib:
    """A copy's library in the shape the package's launch helpers take."""

    def __init__(self, lib):
        self.lib = lib

    def check(self, rc, name):
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")


def _time_ms(fn, reps, inner=10):
    """Median of `reps` CUDA-event timings, each over `inner` calls back
    to back (so that the host's launch cost stays off the card's
    timeline), per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _first(kl, idx, val, X, power):
    m, width = idx.shape
    k = X.shape[0]
    out = torch.empty((k, m), dtype=val.dtype, device=X.device)
    Xt = X.t().contiguous()
    rc = kl.lib.bb_ell(idx.data_ptr(), val.data_ptr(), m, width,
                       Xt.data_ptr(), k, power,
                       int(val.dtype == torch.float64), out.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    kl.check(rc, 'bb_ell')
    return out


def _routes(libs, idx, val, layout, X, csr):
    """{route: fn(power)} for one orientation, dtype and k."""
    k = X.shape[0]
    f64 = int(val.dtype == torch.float64)
    out = {'first': lambda pw: _first(libs['base'], idx, val, X, pw)}

    def win(kl, win_bytes=None):
        rows_max = kl.lib.bb_ell_win_rows(k, f64)
        return lambda pw: ell_mod.win_launch(
            kl, idx, val, layout, X, pw,
            torch.empty((k, idx.shape[0]), dtype=val.dtype,
                        device=X.device), win_bytes, rows_max)
    for name, kl in libs.items():
        if name == 'cut-l1':
            out[name] = lambda pw, kl=kl: _first(kl, idx, val, X, pw)
        else:
            out['win' if name == 'base' else f'win-{name}'] = win(kl)
    for wb in _WIN_BYTES:
        out[f'win-winb{wb}'] = win(libs['base'], wb)
    if k == 1:
        out['cusparse'] = lambda pw: torch.mv(csr, X[0])[None]
    return out


def _csr(idx, val, layout, n_in):
    valid = layout.valid.long()
    live = torch.arange(idx.shape[1], device=idx.device)[None, :] \
        < valid[:, None]
    crow = torch.zeros(idx.shape[0] + 1, dtype=torch.int64,
                       device=idx.device)
    crow[1:] = torch.cumsum(valid, 0)
    return torch.sparse_csr_tensor(crow.int(), idx[live], val[live],
                                   size=(idx.shape[0], n_in),
                                   check_invariants=False)


def run(n, reps, ks=tuple(range(1, 9)), names=None, per_row=164,
        log=print):
    """Times of every route for each orientation, dtype and k; returns
    records."""
    from ..design.ell import dual_ell_from_scipy
    t0 = time.perf_counter()
    variants_src = variants(names)
    libs = {name: _Lib(lib) for name, lib in build_all(variants_src)
            .items()}
    if 'base' not in libs:
        raise RuntimeError("csrc/ell.cu does not build")
    for name in libs:
        key = hashlib.sha256(variants_src[name].encode()).hexdigest()[:16]
        log_path = build.BUILD_ROOT / 'ell_variants' / key / 'ptxas.log'
        summary = ptxas_summary(log_path.read_text()) \
            if log_path.exists() else {}
        log(f"  ptxas {name}: " + ', '.join(
            f"{d} k{k} {r}r" + (f" spills {st}/{ld} B" if st or ld else '')
            for (d, k, pw), (r, st, ld) in sorted(summary.items())
            if pw == 1))
    log(f"ell variants: built {sorted(libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    X = normal_design(n, per_row=per_row)
    (ri, rv), (ci, cv) = dual_ell_from_scipy(X, np.float64)
    p = X.shape[1]
    arrays = {}
    for dtype in (torch.float64, torch.float32):
        npd = np.float64 if dtype == torch.float64 else np.float32
        for orient, idx, val, n_in in (('col', ci, cv, n), ('row', ri, rv, p)):
            v = val.astype(npd)
            lay = ell_mod.EllLayout.from_numpy(idx, v, n_in, 'cuda')
            assert lay.ascending, orient
            i_d = torch.from_numpy(idx).cuda()
            v_d = torch.from_numpy(v).cuda()
            arrays[orient, dtype] = (i_d, v_d, lay, n_in,
                                     _csr(i_d, v_d, lay, n_in))
    log(f"design {n} x {p}, nnz {X.nnz}, col-ELL {ci.shape}, row-ELL "
        f"{ri.shape}, host build + layouts + upload "
        f"{time.perf_counter() - t0:.1f} s, on "
        f"{torch.cuda.get_device_name(0)}")
    del X, ri, rv, ci, cv
    gen = torch.Generator(device='cuda').manual_seed(0)
    recs = []
    for (orient, dtype), (idx, val, lay, n_in, csr) in arrays.items():
        item = val.element_size()
        m = idx.shape[0]
        for k in ks:
            V = torch.randn((k, n_in), generator=gen, device='cuda',
                            dtype=dtype)
            fns = _routes(libs, idx, val, lay, V, csr)
            for power in (1, 2):
                ref = fns['first'](power)
                for name, fn in fns.items():
                    if name in ('first', 'cut-l1', 'cusparse'):
                        continue
                    if not torch.equal(fn(power), ref):
                        raise AssertionError(
                            f"{name} {orient} {dtype} k={k} power {power}: "
                            f"other bits than the first traversal")
            order = list(fns) + list(fns)[::-1]
            times = {}
            for name in order:
                times.setdefault(name, []).append(
                    _time_ms(lambda fn=fns[name]: fn(1), reps))
            vectors = k * (n_in + m) * item
            bound = (idx.numel() * 4 + val.numel() * item + vectors) \
                / HBM_BYTES_PER_S * 1e3
            n_sm, rows_max = lay.card(dtype, k)
            plan = ell_mod.win_plan(dtype, k, m, n_in, n_sm, rows_max)
            bound_win = (lay.n_valid * (4 + item) + 4 * m * plan['n_win']
                         + vectors) / HBM_BYTES_PER_S * 1e3
            rule = 'win' if ell_mod.takes_window(
                dtype, k, m, n_in, lay.n_valid, n_sm, rows_max) else 'first'
            line = []
            for name in fns:
                ms = statistics.mean(times[name])
                recs.append(dict(orient=orient, dtype=str(dtype), k=k,
                                 route=name, ms=ms, turns=times[name],
                                 bound_ms=bound_win if name.startswith('win')
                                 else bound, rule=rule))
                line.append(f"{name} {ms:.4f}")
            faster = min(('first', 'win'),
                         key=lambda r: statistics.mean(times[r]))
            log(f"  {orient} {str(dtype)[6:]} k={k} (bound {bound:.4f} ms, "
                f"windowed {bound_win:.4f}; rule {rule}, faster {faster}"
                f"{'' if rule == faster else ' MISS'}): " + ', '.join(line))
            del V, fns
            torch.cuda.empty_cache()
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=262_144)
    ap.add_argument('--per-row', type=int, default=164,
                    help="standard-normal draws a row of the design")
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--ks', default='1,2,3,4,5,6,7,8')
    ap.add_argument('--variants', default=None,
                    help="comma-separated copies (default: all)")
    ap.add_argument('--out', default=None, help="JSON file of the records")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ell_variants: needs a CUDA device")
    names = None if args.variants is None else set(args.variants.split(','))
    ks = tuple(int(k) for k in args.ks.split(','))
    recs = run(args.n, args.reps, ks, names, args.per_row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=torch.cuda.get_device_name(0), n=args.n,
                 per_row=args.per_row, reps=args.reps, records=recs),
            indent=1))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
