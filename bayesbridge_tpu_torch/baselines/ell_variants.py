"""The ell gather kernel's traversals, copies of ``csrc/ell.cu`` with
other tuning constants, the cluster traversal that lost (kept here), and
cuts, timed in turns at the ell slice's col-ELL and row-ELL, on the card.

The design is the chip smoke's ell slice (``utils.simulate_data``
``normal_design``: n x 16,384, 164 standard-normal draws a row, seed 0;
``--per-row`` takes fewer for a sparser one, ``--n-in`` another number
of predictors, the row-ELL's inputs), stored as the port's dual row-ELL
in float64 and float32, with each orientation's
:class:`..kernels.ell.EllLayout`. Every copy is ``csrc/ell.cu`` with
``ell_cluster.cu`` (beside this file) appended. Routes:

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
``stage``      ``bb_ell_st`` of the sources at ``kernels.ell.stage_plan``:
               the staged traversal (a prefix of the vectors in each
               CTA's shared memory, the rest through L2);
``stage-b<bytes>`` the same with a stage of at most that many bytes;
``st-<copy>``  ``bb_ell_st`` of a copy: ``stwarps<n>`` sets ``kStWarps``,
               ``stahead<n>`` ``kStAhead`` (groups a warp has in flight),
               ``<SU64|SU32>k<k>=<n>`` one entry of ``kStUnrollF64`` /
               ``kStUnrollF32`` (32-slot runs a warp loads at once);
``cluster``    ``bb_ell_cl`` (``ell_cluster.cu``) at :func:`cluster_plan`:
               the k vectors spread over the shared memory of a cluster
               of C CTAs, every other CTA's inputs gathered over the
               SM-to-SM network (``mapa`` + ``ld.shared::cluster``),
               where a cluster of at most the card's largest size holds
               them;
``cluster-c<C>`` the same with C forced (2, 4, 8 or 16; where its CTAs
               hold only part of the vectors, the rest through L2);
``cl-<copy>``  ``bb_ell_cl`` of a copy: ``clwarps<n>`` sets ``kClWarps``,
               ``<CU64|CU32>k<k>=<n>`` one entry of ``kClUnrollF64`` /
               ``kClUnrollF32``;
``cut-l1``     ``bb_ell`` of a copy that gathers from ``xt[idx & mask]``,
               the first 128 KB of the interleaved vectors: the same
               instructions with a vector that fits L1. It changes the
               results and is timed only;
``cluster-local`` ``bb_ell_cl`` of a copy whose CTAs gather every slot
               from their own shared memory (the same address in their
               own slice): the cluster traversal without the SM-to-SM
               network. It changes the results and is timed only;
``cusparse``   ``torch.mv`` of the CSR of the same matrix (k = 1; a
               yardstick, never called by the port).

Every route but the cuts must give ``first``'s bits (power 1 and 2) and
the same bits on a rerun. The routes are timed in turns, forth and back,
for each orientation, dtype and k, CUDA events, median of ``--reps``
timings of 10 calls each; the line per route holds the mean of its two
turns beside the bound (the padded ELL arrays, the vectors and the
outputs once over 3,350 GB/s; for the windowed routes the valid slots
and the window pointers they read in place of the padded arrays), the
traversal the design's dispatch picks for the launch (``takes_window``
on the col-ELL, then ``takes_stage``) beside the fastest of ``first``,
``win`` and ``stage``, and for the cluster routes the bytes their CTAs
read from one another (``remote``) and its rate. ``--out`` writes the
records as JSON.

    python -m bayesbridge_tpu_torch.baselines.ell_variants \\
        [--n N] [--n-in P] [--per-row P] [--reps R] [--ks 1,2,...] \\
        [--orients row,col] [--variants a,b,...] [--out FILE]

``--variants`` names the copies to build (default: all) and the plan
routes to add (``cluster-c<C>``, ``stage-b<bytes>``; default: every
cluster size).
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
CLUSTER_SRC = Path(__file__).resolve().parent / 'ell_cluster.cu'
CHUNK = 256  # inputs a chunk of the cluster copy (kChunkShift)
CLUSTERS = (1, 2, 4, 8, 16)
# key: (the line that sets the constant, the values tried)
_CONSTANTS = {
    'warps': ('constexpr int kWinWarps = {};', (12, 24)),
    'stwarps': ('constexpr int kStWarps = {};', (8, 24, 32)),
    'stahead': ('constexpr int kStAhead = {};', (1, 3)),
    'clwarps': ('constexpr int kClWarps = {};', (8, 32)),
}
# The table copies tried by default: <R|U|SU|CU><64|32>k<k>=<value> sets
# one entry of kRowsF64 / kUnrollF64 / ... / kStUnrollF32 / kClUnrollF32.
_TABLE_COPIES = ('U64k1=6', 'R64k2=3', 'R64k8=4', 'U32k1=3', 'SU64k2=4',
                 'SU64k4=2', 'SU32k4=4', 'SU32k8=2')
_TABLES = {'R64': 'kRowsF64', 'U64': 'kUnrollF64', 'R32': 'kRowsF32',
           'U32': 'kUnrollF32', 'SU64': 'kStUnrollF64',
           'SU32': 'kStUnrollF32', 'CU64': 'kClUnrollF64',
           'CU32': 'kClUnrollF32'}
_ST_COPY = re.compile(r'(stwarps|stahead|SU)')  # copies of the staged one
_CL_COPY = re.compile(r'(clwarps|CU)')  # copies of the cluster traversal
_PLAN_ROUTE = re.compile(r'(cluster-c|stage-b)(\d+)')
_WIN_BYTES = (65536, 114688)  # other windows (plan win_bytes)
_CUT = ('load_k<K>(xt + (int64_t)__ldg(ir + s) * K, xj);',
        'load_k<K>(xt + (int64_t)(__ldg(ir + s) & (int)(131072 / '
        '(K * sizeof(T)) - 1)) * K, xj);')
_CUT_LOCAL = ('(uint32_t)(g & (C - 1))),', '(uint32_t)rank),')
_CUTS = ('cut-l1', 'cluster-local')
_FUNCS = ('bb_ell', 'bb_ell_win', 'bb_ell_win_rows', 'bb_ell_st',
          'bb_ell_st_fit')
_CL_FUNCS = {'bb_ell_cl': [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2,
             'bb_ell_cl_fit': [ctypes.c_int] * 4}


def _table_edit(src, name):
    """ell.cu with one table entry set, for a copy named like
    'R64k2=3'."""
    m = re.fullmatch(r'((?:CU|SU|R|U)(?:64|32))k([1-8])=(\d+)', name)
    if m is None:
        raise ValueError(f"no copy {name!r}")
    head = f'constexpr int {_TABLES[m[1]]}[kMaxVectors + 1] = {{'
    line = next(ln for ln in src.splitlines() if ln.startswith(head))
    vals = line[len(head):line.index('}')].split(', ')
    vals[int(m[2])] = m[3]
    return src.replace(line, head + ', '.join(vals) + '};')


def variants(names=None):
    """{copy: source}: csrc/ell.cu with ell_cluster.cu appended, as
    'base', the one-constant copies, the table copies and the cuts
    (`names`: the copies to build, each one edit or several joined by
    '+'; 'base' always included; plan routes are skipped)."""
    src = (build.CSRC / 'ell.cu').read_text() + '\n' \
        + CLUSTER_SRC.read_text()
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
    for name, cut in zip(_CUTS, (_CUT, _CUT_LOCAL)):
        if src.count(cut[0]) != 1:
            raise RuntimeError(f"ell.cu no longer holds {cut[0]!r} once")
        edits[name] = lambda text, cut=cut: text.replace(*cut)
    if names is None:
        names = list(edits) + list(_TABLE_COPIES)
    out = {'base': src}
    for name in names:
        if name == 'base' or _PLAN_ROUTE.fullmatch(name):
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
        for fn, argtypes in _CL_FUNCS.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return name, lib

    with ThreadPoolExecutor(len(sources)) as ex:
        return {name: lib for name, lib in ex.map(one, sources)
                if lib is not None}


def ptxas_summary(log):
    """{(kernel, dtype, k, power): (registers, spill store bytes, spill
    load bytes)} of the windowed ('win'), staged ('st') and cluster ('cl')
    kernels' instances in an ``-Xptxas -v`` log."""
    out, key, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r'Compiling entry function .*ell_(win|st|cl)_kernelI'
                      r'([df])Li(\d)ELi(\d)E', line)
        if m:
            key = (m[1], {'d': 'f64', 'f': 'f32'}[m[2]], int(m[3]),
                   int(m[4]))
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


def cluster_card(kl, device):
    """{'n_sm': SMs, 'max_cluster': 16 where the card holds a non-portable
    cluster of 16 CTAs of the cluster copy `kl`, else 8}."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    big = kl.lib.bb_ell_cl_fit(1, 1, 4, 1) > 0
    return dict(n_sm=n_sm, max_cluster=16 if big else 8)


def cluster_plan(dtype, k, n_in, card, cluster=None):
    """The cluster copy's staging for k vectors of n_in inputs: the inputs
    in chunks of CHUNK, chunk g in CTA g % C of a cluster of C. By default
    C is the smallest of CLUSTERS (up to the card's largest) whose CTAs
    hold every chunk within MAX_SMEM each, and None where none does;
    `cluster` forces C (the vectors past what its CTAs hold are gathered
    through L2). Returns dict(cluster=C, log2c, chunk_bytes (a bulk
    copy), chunks_cta (chunks a CTA stages), smem_bytes (a CTA's),
    n_staged (the inputs gathered from shared memory: below it), n_pad
    (rows of the padded interleaved vectors), staged (n_staged /
    n_in))."""
    item = 8 if dtype == torch.float64 else 4
    chunk_bytes = CHUNK * k * item
    n_chunks = -(-max(n_in, 1) // CHUNK)
    cap = ell_mod.STAGE_BYTES // chunk_bytes  # chunks a CTA holds
    if cluster is not None:
        c = cluster
        chunks_cta = min(-(-n_chunks // c), cap)
    else:
        fits = [c for c in CLUSTERS if c <= card['max_cluster']
                and -(-n_chunks // c) <= cap]
        if not fits:
            return None
        c = fits[0]
        chunks_cta = -(-n_chunks // c)
    if c not in CLUSTERS or chunks_cta < 1:
        raise ValueError(f"no cluster plan of {c} CTAs")
    n_staged = min(n_in, chunks_cta * c * CHUNK)
    return dict(cluster=c, log2c=c.bit_length() - 1, chunk_bytes=chunk_bytes,
                chunks_cta=chunks_cta, smem_bytes=chunks_cta * chunk_bytes,
                n_staged=n_staged,
                n_pad=max(n_chunks, chunks_cta * c) * CHUNK,
                staged=n_staged / max(n_in, 1))


def cluster_clusters(kl, k, f64, plan, m):
    """Clusters of a launch of the cluster copy: as many as the card holds
    at once, at most one a cluster's worth of rows."""
    fit = kl.lib.bb_ell_cl_fit(k, f64, plan['log2c'], plan['chunks_cta'])
    if fit < 1:
        raise RuntimeError(f"no cluster of {plan['cluster']} CTAs with "
                           f"{plan['smem_bytes']} bytes fits the card")
    return max(1, min(fit, -(-m // plan['cluster'])))


def cluster_launch(kl, idx, val, X, power, out, plan):
    """One launch of the cluster copy `kl` for X (k <= 8, n_in) into out
    (k, m) with `plan` (:func:`cluster_plan`)."""
    m, width = idx.shape
    k, n_in = X.shape
    f64 = int(val.dtype == torch.float64)
    n_cl = cluster_clusters(kl, k, f64, plan, m)
    Xt = torch.empty((plan['n_pad'], k), dtype=X.dtype, device=X.device)
    Xt[:n_in] = X.t()
    rc = kl.lib.bb_ell_cl(
        idx.data_ptr(), val.data_ptr(), m, width, Xt.data_ptr(), k, power,
        f64, plan['log2c'], plan['chunks_cta'], plan['n_staged'], n_cl,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kl.check(rc, 'bb_ell_cl')
    return out


def _launch(launch, kl, idx, val, X, plan):
    """fn(power): one launch of `launch` (stage or cluster) at `plan`."""
    k, m = X.shape[0], idx.shape[0]
    return lambda pw: launch(
        kl, idx, val, X, pw,
        torch.empty((k, m), dtype=val.dtype, device=X.device), plan)


def _routes(libs, idx, val, layout, X, csr, card, extra):
    """({route: fn(power)}, {cluster route: plan}) for one orientation,
    dtype and k; `extra`: the plan routes asked for."""
    k, n_in = X.shape
    f64 = int(val.dtype == torch.float64)
    base = libs['base']
    out = {'first': lambda pw: _first(base, idx, val, X, pw)}

    def win(kl, win_bytes=None):
        rows_max = kl.lib.bb_ell_win_rows(k, f64)
        return lambda pw: ell_mod.win_launch(
            kl, idx, val, layout, X, pw,
            torch.empty((k, idx.shape[0]), dtype=val.dtype,
                        device=X.device), win_bytes, rows_max)
    stage = ell_mod.stage_plan(val.dtype, k, n_in)
    plan = cluster_plan(val.dtype, k, n_in, card)
    plans = {}
    for name, kl in libs.items():
        if name == 'cut-l1':
            out[name] = lambda pw, kl=kl: _first(kl, idx, val, X, pw)
        elif _ST_COPY.match(name):
            out[f'st-{name}'] = _launch(ell_mod.stage_launch, kl, idx, val,
                                        X, stage)
        elif name == 'cluster-local' or _CL_COPY.match(name):
            if plan is not None:
                plans[name if name == 'cluster-local' else f'cl-{name}'] = \
                    (kl, plan)
        else:
            out['win' if name == 'base' else f'win-{name}'] = win(kl)
    for wb in _WIN_BYTES:
        out[f'win-winb{wb}'] = win(base, wb)
    out['stage'] = _launch(ell_mod.stage_launch, base, idx, val, X, stage)
    if plan is not None:
        plans['cluster'] = (base, plan)
    for kind, size in extra:
        if kind == 'stage-b':
            out[f'stage-b{size}'] = _launch(
                ell_mod.stage_launch, base, idx, val, X,
                ell_mod.stage_plan(val.dtype, k, n_in, size))
        elif size <= card['max_cluster'] and (plan is None
                                               or size != plan['cluster']):
            plans[f'cluster-c{size}'] = (base, cluster_plan(
                val.dtype, k, n_in, card, cluster=size))
    for name, (kl, pl) in plans.items():
        out[name] = _launch(cluster_launch, kl, idx, val, X, pl)
    if k == 1:
        out['cusparse'] = lambda pw: torch.mv(csr, X[0])[None]
    return out, {name: pl for name, (kl, pl) in plans.items()}


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


def _remote_slots(idx, plan, n_cl):
    """The slots whose k values a CTA of the cluster traversal reads from
    another CTA's shared memory (rows spread as ``bb_ell_cl`` spreads
    them over n_cl clusters), counted on the card."""
    m = idx.shape[0]
    c = plan['cluster']
    rows_cta = -(-m // (n_cl * c))
    n = 0
    for r in range(0, m, 1 << 16):
        rank = (torch.arange(r, min(m, r + (1 << 16)), device=idx.device)
                // rows_cta) % c
        j = idx[r:r + (1 << 16)].long()
        owner = (j // CHUNK) % c
        n += int(((owner != rank[:, None]) & (j < plan['n_staged'])).sum())
    return n


def run(n, reps, ks=tuple(range(1, 9)), names=None, per_row=164,
        n_in=16_384, orients=('col', 'row'), log=print):
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
            f"{kern} {d} k{k} {r}r" + (f" spills {st}/{ld} B" if st or ld
                                       else '')
            for (kern, d, k, pw), (r, st, ld) in sorted(summary.items())
            if pw == 1))
    log(f"ell variants: built {sorted(libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    card = cluster_card(libs['base'], 'cuda')
    extra = [(m[1], int(m[2])) for m in map(_PLAN_ROUTE.fullmatch,
                                            names or ()) if m]
    if names is None:  # every cluster size
        extra = [('cluster-c', c) for c in CLUSTERS[1:]]
    t0 = time.perf_counter()
    X = normal_design(n, n_in, per_row=per_row)
    (ri, rv), (ci, cv) = dual_ell_from_scipy(X, np.float64)
    p = X.shape[1]
    arrays = {}
    for dtype in (torch.float64, torch.float32):
        npd = np.float64 if dtype == torch.float64 else np.float32
        for orient, idx, val, size in (('col', ci, cv, n), ('row', ri, rv, p)):
            if orient not in orients:
                continue
            v = val.astype(npd)
            lay = ell_mod.EllLayout.from_numpy(idx, v, size, 'cuda')
            assert lay.ascending, orient
            i_d = torch.from_numpy(idx).cuda()
            v_d = torch.from_numpy(v).cuda()
            arrays[orient, dtype] = (i_d, v_d, lay, size,
                                     _csr(i_d, v_d, lay, size))
    log(f"design {n} x {p}, nnz {X.nnz}, col-ELL {ci.shape}, row-ELL "
        f"{ri.shape}, host build + layouts + upload "
        f"{time.perf_counter() - t0:.1f} s, on "
        f"{torch.cuda.get_device_name(0)}; card {card}")
    del X, ri, rv, ci, cv
    gen = torch.Generator(device='cuda').manual_seed(0)
    recs = []
    for (orient, dtype), (idx, val, lay, size, csr) in arrays.items():
        item = val.element_size()
        f64 = int(dtype == torch.float64)
        m, width = idx.shape
        for k in ks:
            V = torch.randn((k, size), generator=gen, device='cuda',
                            dtype=dtype)
            fns, plans = _routes(libs, idx, val, lay, V, csr, card, extra)
            for power in (1, 2):
                ref = fns['first'](power)
                for name, fn in fns.items():
                    if name in ('first', 'cusparse') + _CUTS:
                        continue
                    if not torch.equal(fn(power), ref):
                        raise AssertionError(
                            f"{name} {orient} {dtype} k={k} power {power}: "
                            f"other bits than the first traversal")
                    if not torch.equal(fn(power), ref):
                        raise AssertionError(f"{name}: a rerun differs")
            order = list(fns) + list(fns)[::-1]
            times = {}
            for name in order:
                times.setdefault(name, []).append(
                    _time_ms(lambda fn=fns[name]: fn(1), reps))
            vectors = k * (size + m) * item
            bound = (idx.numel() * 4 + val.numel() * item + vectors) \
                / HBM_BYTES_PER_S * 1e3
            n_sm, rows_max = lay.card(dtype, k)
            plan = ell_mod.win_plan(dtype, k, m, size, n_sm, rows_max)
            bound_win = (lay.n_valid * (4 + item) + 4 * m * plan['n_win']
                         + vectors) / HBM_BYTES_PER_S * 1e3
            # the traversal the design's dispatch gives the launch: the
            # col-ELL's layout first, the row-ELL has none
            if orient == 'col' and lay.windowed(dtype, k):
                rule = 'win'
            elif ell_mod.takes_stage(dtype, k, size):
                rule = 'stage'
            else:
                rule = 'first'
            line = []
            for name in fns:
                ms = statistics.mean(times[name])
                rec = dict(orient=orient, dtype=str(dtype), k=k, route=name,
                           ms=ms, turns=times[name],
                           bound_ms=bound_win if name.startswith('win')
                           else bound, rule=rule)
                text = f"{name} {ms:.4f}"
                if name in plans:
                    pl = plans[name]
                    n_cl = cluster_clusters(libs['base'], k, f64, pl, m)
                    remote = _remote_slots(idx, pl, n_cl) * k * item
                    rec.update(cluster=pl['cluster'], staged=pl['staged'],
                               clusters=n_cl, remote_gb=remote / 1e9)
                    text += (f" (C {pl['cluster']} x {n_cl}, staged "
                             f"{pl['staged']:.0%}, remote {remote / 1e9:.3f}"
                             f" GB at {remote / (ms / 1e3) / 1e9:.0f} GB/s)")
                elif name.startswith(('stage', 'st-')):
                    rec['staged'] = ell_mod.stage_plan(
                        dtype, k, size, int(name[7:]) if name.startswith(
                            'stage-b') else ell_mod.MAX_SMEM)['staged']
                    text += f" (staged {rec['staged']:.0%})"
                recs.append(rec)
                line.append(text)
            faster = min((r for r in ('first', 'win', 'stage')
                          if r in times),
                         key=lambda r: statistics.mean(times[r]))
            log(f"  {orient} {str(dtype)[6:]} k={k} (bound {bound:.4f} ms, "
                f"windowed {bound_win:.4f}; rule {rule}, fastest {faster}"
                f"{'' if rule == faster else ' MISS'}): " + ', '.join(line))
            del V, fns
            torch.cuda.empty_cache()
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=262_144)
    ap.add_argument('--n-in', type=int, default=16_384,
                    help="predictors of the design (the row-ELL's inputs)")
    ap.add_argument('--per-row', type=int, default=164,
                    help="standard-normal draws a row of the design")
    ap.add_argument('--orients', default='col,row')
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
    recs = run(args.n, args.reps, ks, names, args.per_row, args.n_in,
               tuple(args.orients.split(',')))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=torch.cuda.get_device_name(0), n=args.n,
                 n_in=args.n_in, per_row=args.per_row, reps=args.reps,
                 records=recs),
            indent=1))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
