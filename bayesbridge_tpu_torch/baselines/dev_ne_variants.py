"""Sweep A/B harness: how should the hybrid CG operator read the design?

Port of ``baselines/dev_ne_variants.py`` (the TPU harness). On synthetic
hybrid blocks generated on the device (int8 0/1 at density 0.5 beside
standard-normal f32, seeded ``torch.Generator``) it times, with CUDA
events, the median over ``--reps`` of a chain of ``--chain`` dependent
calls (each call's normalized outputs are the next call's v):

main mode
    ``composed`` (the row pass ``ne_rows`` then the column pass
    ``colpass``: the hybrid design's composed pair, two reads of X),
    ``ne_sweep`` (the fused sweep's two-pass route, also two reads),
    ``ne_oneread`` (the fused sweep's one-read route, the hybrid CG
    operator on the card), then each ``--variants`` spec through
    ``ne_onepass`` (one read). The TPU spec
    names map onto Hopper modes (printed): phase A v1 / wide / chunkwide
    / reshape -> fma, mxu2a / mxd2a -> mma2, mxu1a -> mma1, suffix s ->
    convert once; phase B v1 / fold8 -> fma, mxu2 -> mma2, mxu3 / mxuf
    -> mma3. Columns: ms, GB/s of the bytes the call reads, speed against
    ``composed``, and max|diff| / max|composed| over (out_e, out_f, u).
``--probe``
    ``stream_probe`` over about 2 GB of int8 (and its int32 view): the
    kinds i32 (stream), cvt (+ up-convert), mul (+ multiply), each beside
    the one ``torch.sum`` of the same stream (none for mul).
``--presolve``
    the pre-solve reductions per block (X'u1, X'u2, X'u3, (X.X)'u3):
    ``fused`` (``tdots_sweep``), ``mrhs`` (the composed design's
    ``tdots_sweep`` with the warm-start column u4), ``mrhs_sq`` (the fused
    read plus (Xf2)'u3 from a prestored Xf2 = Xf.Xf), ``seq4`` (one
    column pass per reduction, the binary block's square moment reused);
    the TPU's precision kinds ``mrhs_hi`` / ``mrhs_high`` map to mrhs.

Usage (on a machine with the card; ``--device cpu`` runs the plain
versions at a small size, for a rehearsal):

    python -m bayesbridge_tpu_torch.baselines.dev_ne_variants [--n N]
        [--pe PE] [--pf PF] [--variants v1:v1,...] [--reps R]
        [--chain K] [--budget KIB] [--probe [--probe-gb GB] | --presolve]
        [--device D]
"""

import argparse
import math
import statistics
import time

import torch

from ..kernels import layout
from ..kernels.ne_onepass import PANEL_BYTES, map_spec, ne_onepass
from ..kernels.ne_oneread import ne_oneread
from ..kernels.ne_sweep import colpass, ne_rows, ne_sweep
from ..kernels.stream_probe import stream_probe
from ..kernels.tdots_sweep import tdots_sweep

DEFAULT_VARIANTS = 'v1:v1,wide:v1,wide:fold8,wide:mxu2,wide:mxu3,wide:mxuf'
PRESOLVE_KINDS = ('fused', 'mrhs', 'mrhs_sq', 'seq4')
PRESOLVE_ALIASES = {'mrhs_hi': 'mrhs', 'mrhs_high': 'mrhs'}
PROBE_GB = 2.0
CHUNK = 1024


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def binary_block(n, p, g, device):
    """(n, padded_width(p)) int8 block of 0/1 at density 0.5, zero
    padding, filled in row chunks (no full-size float transient)."""
    X = torch.zeros((n, layout.padded_width(p)), dtype=torch.int8,
                    device=device)
    step = max(1, 2 ** 28 // (4 * max(p, 1)))
    for i in range(0, n, step):
        rows = min(step, n - i)
        X[i:i + rows, :p] = torch.rand((rows, p), generator=g,
                                       device=device) < 0.5
    return X


def normal_block(n, p, g, device):
    X = torch.zeros((n, layout.padded_width(p)), device=device)
    X[:, :p] = torch.randn((n, p), generator=g, device=device)
    return X


def make_inputs(n, pe, pf, device, seed=0):
    """(Xe, Xf, ve, vf, c, w) of the main mode."""
    g = _gen(device, seed)
    Xe = binary_block(n, pe, g, device)
    Xf = normal_block(n, pf, g, device)
    ve = torch.randn(pe, generator=g, device=device) / pe ** .5
    vf = torch.randn(pf, generator=g, device=device) / pf ** .5
    c = torch.randn(n, generator=g, device=device) * .1
    w = torch.rand(n, generator=g, device=device) + .1
    return Xe, Xf, ve, vf, c, w


def composed(Xe, Xf, ve, vf, c, w):
    """The hybrid design's composed pair: row pass, then column pass."""
    u = w * ne_rows([(Xe, ve), (Xf, vf)], c)
    oe, of = colpass([Xe, Xf], [ve.shape[0], vf.shape[0]], u)
    return oe, of, u


def fused_sweep(Xe, Xf, ve, vf, c, w):
    outs, u, _ = ne_sweep([(Xe, ve), (Xf, vf)], c, None, w, 'ne',
                          route='twopass')
    return outs[0], outs[1], u


def oneread_sweep(Xe, Xf, ve, vf, c, w):
    outs, u = ne_oneread([(Xe, ve), (Xf, vf)], c, w)
    return outs[0], outs[1], u


def onepass_fn(spec, panel_bytes=PANEL_BYTES):
    a_mode, b_mode, cvt = map_spec(spec)

    def fn(Xe, Xf, ve, vf, c, w):
        return ne_onepass(Xe, Xf, ve, vf, c, w, a_mode, b_mode, cvt,
                          panel_bytes=panel_bytes)
    return fn


def timed(run, reps, device):
    """Median seconds of run() over `reps`, after one warm-up; CUDA
    events on the card, the host clock on the CPU."""
    run()
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def chain_time(fn, Xe, Xf, ve, vf, c, w, chain, reps):
    """Seconds per call of `fn` in a chain of dependent calls."""
    def run():
        cve, cvf = ve, vf
        for _ in range(chain):
            oe, of, _ = fn(Xe, Xf, cve, cvf, c, w)
            cve = oe / torch.clamp_min(torch.linalg.vector_norm(oe), 1e-30)
            cvf = of / torch.clamp_min(torch.linalg.vector_norm(of), 1e-30)
        return cve, cvf
    return timed(run, reps, Xe.device) / chain


def rel_err(got, ref):
    """max |got - ref| / max |ref| over matching tensors."""
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return err / max(scale, 1e-30)


def run_main(n, pe, pf, variants, chain, reps, budget_kib, device,
             log=print):
    """The main mode at one shape; returns one record per row."""
    Xe, Xf, ve, vf, c, w = make_inputs(n, pe, pf, device)
    gb = (Xe[:, :pe].numel() + 4 * Xf[:, :pf].numel()) / 1e9
    log(f"n={n} pe={pe} pf={pf} stored={gb:.3f} GB budget={budget_kib}KiB "
        f"device={device}")
    rows = [('composed', None, composed, 2),
            ('ne_sweep', None, fused_sweep, 2),
            ('ne_oneread', None, oneread_sweep, 1)]
    for spec in variants:
        rows.append((spec, map_spec(spec),
                     onepass_fn(spec, budget_kib * 1024), 1))
    ref = composed(Xe, Xf, ve, vf, c, w)
    log(f"{'variant':>14} {'hopper (a, b, cvt)':>24} {'reads':>5} "
        f"{'ms':>9} {'GB/s':>7} {'vs_comp':>7} {'rel_err':>9}")
    out, t_comp = [], None
    for name, modes, fn, reads in rows:
        got = fn(Xe, Xf, ve, vf, c, w)
        err = rel_err(got, ref)
        del got
        t = chain_time(fn, Xe, Xf, ve, vf, c, w, chain, reps)
        t_comp = t if t_comp is None else t_comp
        rec = dict(name=name, modes=modes, reads=reads, ms=t * 1e3,
                   gbps=reads * gb / t, vs_composed=t_comp / t,
                   rel_err=err)
        out.append(rec)
        log(f"{name:>14} {str(modes or '-'):>24} {reads:>5} "
            f"{t * 1e3:9.3f} {reads * gb / t:7.0f} {t_comp / t:6.2f}x "
            f"{err:9.1e}")
    return out


def probe_block(n, gb_target, g, device):
    """The probes' (n, p8) int8 0/1 block of about `gb_target` GB, p8 a
    multiple of 1024 (where the TPU probe is defined)."""
    p8 = -(-int(gb_target * 1e9 / n) // CHUNK) * CHUNK
    return binary_block(n, p8, g, device)


def run_probes(n, chain, reps, device, log=print, gb_target=PROBE_GB):
    """The three probe kinds over about `gb_target` GB; returns records
    with the torch.sum time beside each (None for mul)."""
    X8 = probe_block(n, gb_target, _gen(device, 0), device)
    X32 = X8.view(torch.int32)
    p8 = X8.shape[1]
    gb = n * p8 / 1e9
    log(f"probes: n={n} p8={p8} bytes={gb:.3f} GB device={device}")
    library = {'i32': lambda: torch.sum(X32),
               'cvt': lambda: torch.sum(X8, dtype=torch.float32),
               'mul': None}
    out = []
    for kind, X in (('i32', X32), ('cvt', X8), ('mul', X8)):
        def run(kind=kind, X=X):
            s = torch.zeros((), device=device)
            for _ in range(chain):
                s = stream_probe(X, s * 1e-30, kind)
            return s
        t = timed(run, reps, device) / chain
        lib = library[kind]
        t_lib = timed(lib, reps, device) if lib is not None else None
        out.append(dict(kind=kind, ms=t * 1e3, gbps=gb / t,
                        library_ms=None if t_lib is None else t_lib * 1e3))
        log(f"  {kind:>4}: {t * 1e3:8.3f} ms {gb / t:7.0f} GB/s; torch.sum "
            + ('-' if t_lib is None else
               f"{t_lib * 1e3:8.3f} ms {gb / t_lib:7.0f} GB/s"))
    return out


def presolve_fn(kind):
    """f(Xe, Xf, Xf2, pe, pf, u1, u2, u3, u4) -> the 8 per-block
    reductions (e1, e2, e3, esq, f1, f2, f3, fsq) of one pre-solve
    structure."""
    kind = PRESOLVE_ALIASES.get(kind, kind)
    if kind not in PRESOLVE_KINDS:
        raise ValueError(f"unknown presolve kind {kind!r}")

    def run(Xe, Xf, Xf2, pe, pf, u1, u2, u3, u4):
        if kind == 'seq4':
            e1, f1 = colpass([Xe, Xf], [pe, pf], u1)
            e2, f2 = colpass([Xe, Xf], [pe, pf], u2)
            e3, f3 = colpass([Xe, Xf], [pe, pf], u3)
            (fsq,) = colpass([Xf2], [pf], u3)
            return e1, e2, e3, e3, f1, f2, f3, fsq
        be, bf = tdots_sweep([Xe, Xf], [pe, pf], u1, u2, u3,
                             u4 if kind == 'mrhs' else None)
        if kind == 'mrhs_sq':
            (fsq,) = colpass([Xf2], [pf], u3)
            bf = bf[:3] + (fsq,)
        return tuple(be[:4]) + tuple(bf[:4])
    return run


def run_presolve(n, pe, pf, chain, reps, device, log=print,
                 kinds=PRESOLVE_KINDS):
    """Each pre-solve structure at one shape; returns records."""
    g = _gen(device, 0)
    Xe = binary_block(n, pe, g, device)
    Xf = normal_block(n, pf, g, device)
    Xf2 = Xf * Xf
    u1, u2, u4 = (torch.randn(n, generator=g, device=device)
                  for _ in range(3))
    u3 = torch.rand(n, generator=g, device=device) + .1
    gb = (Xe[:, :pe].numel() + 4 * Xf[:, :pf].numel()) / 1e9
    log(f"presolve A/B: n={n} pe={pe} pf={pf} stored={gb:.3f} GB "
        f"device={device}")
    ref = [layout.rmatvec(X, p, u, square=sq) for X, p in ((Xe, pe),
                                                           (Xf, pf))
           for u, sq in ((u1, False), (u2, False), (u3, False), (u3, True))]
    out = []
    for kind in kinds:
        fn = presolve_fn(kind)
        got = fn(Xe, Xf, Xf2, pe, pf, u1, u2, u3, u4)
        err = max(rel_err([a], [b]) for a, b in zip(got, ref))
        del got

        def run(fn=fn):
            a1, a2, a3 = u1, u2, u3
            for _ in range(chain):
                outs = fn(Xe, Xf, Xf2, pe, pf, a1, a2, a3, u4)
                s = sum(o.sum() for o in outs) * 1e-30
                a1, a2, a3 = a1 + s, a2 + s, a3 + s
            return a1
        t = timed(run, reps, device) / chain
        out.append(dict(kind=kind, ms=t * 1e3, gbps=gb / t, rel_err=err))
        log(f"{kind:>9} {t * 1e3:8.3f} ms {gb / t:7.0f} GB/s_1sweep  "
            f"rel_err {err:9.1e}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--pe', default='45000',
                    help='comma list of exact-block widths')
    ap.add_argument('--pf', default='5000',
                    help='comma list of float-block widths (zipped)')
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--chain', type=int, default=20)
    ap.add_argument('--budget', type=int, default=PANEL_BYTES // 1024,
                    help="ne_onepass: row-panel bytes each CTA stages, KiB "
                         "(the TPU harness's per-step VMEM budget)")
    ap.add_argument('--variants', default=DEFAULT_VARIANTS)
    ap.add_argument('--probe', action='store_true',
                    help='run the stream/convert probes only')
    ap.add_argument('--probe-gb', type=float, default=PROBE_GB,
                    help='GB of int8 the probes stream')
    ap.add_argument('--presolve', action='store_true',
                    help='A/B the pre-solve structures only')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit("dev_ne_variants: no CUDA device; pass "
                             "--device cpu for a rehearsal")
        print(f"card: {torch.cuda.get_device_name(device)}", flush=True)
    if args.probe:
        run_probes(args.n, args.chain, args.reps, device,
                   gb_target=args.probe_gb)
        return 0
    pes = [int(x) for x in str(args.pe).split(',')]
    pfs = [int(x) for x in str(args.pf).split(',')]
    if args.presolve:
        run_presolve(args.n, pes[0], pfs[0], args.chain, args.reps, device)
        return 0
    for pe, pf in zip(pes, pfs):
        run_main(args.n, pe, pf, args.variants.split(','), args.chain,
                 args.reps, args.budget, device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
