#!/usr/bin/env python3
"""Drive the torch port's flagship path once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   TF32 is turned off for matmuls and cuDNN;
2. build the hand-written kernels from ``bayesbridge_tpu_torch/csrc``
   with nvcc for sm_90a;
3. each kernel against its plain PyTorch version on the card: every
   ne_sweep mode (ne / logit / linear, with and without logp) and
   tdots_sweep, int8 / bf16 / f32 exact blocks, one and two blocks, at a
   ragged small shape with garbage in the padding, then at the flagship
   block shapes with CUDA-event timings of kernel and plain version;
4. the slice: a 100,000 x 50,000 sparse logit design (90% binary
   columns at 10% density, as bench.py builds it) on the hybrid int8 +
   f32 backend, ``gibbs(30)`` with the CG sampler and bridge exponent
   0.5, launch counters showing that the kernels carried it, then 20
   more iterations through ``gibbs_resume`` timed;
5. resume on the card: ``gibbs(20)`` + ``gibbs_resume(10, merge=True)``
   must equal the ``gibbs(30)`` run exactly.

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it a JSON summary of the kernels, and the last line
``{"ok": true, "device": {...}}``. With no CUDA device it exits 1 and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

N_OBS, N_PRED = 100_000, 50_000
BINARY_FRAC = 0.9
RTOL = 1e-4  # relative to max|plain|: the two sum in different orders


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=10):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    import torch
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


def max_err(got, ref):
    """(max |got - ref|, max |ref|) over matching tensors."""
    errs, scale = 0.0, 0.0
    for g, r in zip(got, ref):
        errs = max(errs, float((g.float() - r.float()).abs().max()))
        scale = max(scale, float(r.float().abs().max()))
    return errs, scale


def check(name, got, ref):
    err, scale = max_err(got, ref)
    ok = err <= RTOL * scale + 1e-30
    log(f"  {name}: max_abs_err {err:.3e}  max|plain| {scale:.3e}  "
        f"rel {err / max(scale, 1e-30):.2e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version beyond rtol {RTOL}")
    return err


def random_block(kind, n, p, ld, gen, garbage=True):
    """(n, ld) stored block of `kind` with p logical columns; padding
    columns hold NaN (float kinds) or random bytes when `garbage`."""
    import torch
    dev = 'cuda'
    if kind == 'int8':
        X = torch.randint(-3, 4, (n, ld), generator=gen, device=dev,
                          dtype=torch.int8)
        if not garbage:
            X[:, p:] = 0
        return X
    X = torch.randn((n, ld), generator=gen, device=dev)
    X = X * (torch.rand((n, ld), generator=gen, device=dev) < 0.3)
    X = X.to(torch.bfloat16 if kind == 'bf16' else torch.float32)
    X[:, p:] = float('nan') if garbage else 0.0
    return X


def sweep_args(blocks_shape, n, gen, scalar_c):
    import torch
    dev = 'cuda'
    vs = [torch.randn(p, generator=gen, device=dev) for p in blocks_shape]
    c = torch.randn((), generator=gen, device=dev) if scalar_c \
        else torch.randn(n, generator=gen, device=dev)
    a = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    b = torch.rand(n, generator=gen, device=dev) + 0.5
    return vs, c, a, b


def kernel_checks():
    """Phase 3 at the ragged small shape: every mode, dtype and block
    count against the plain version."""
    import torch
    from bayesbridge_tpu_torch.kernels import layout
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        ne_sweep, ne_sweep_plain)
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_plain)
    n, pe, pf = 1037, 4097, 513
    gen = torch.Generator(device='cuda').manual_seed(1)
    log(f"kernel vs plain, ragged n={n} p_e={pe} p_f={pf} "
        f"(padding holds garbage), rtol {RTOL} of max|plain|")
    for kind in ('int8', 'bf16', 'f32'):
        Xe = random_block(kind, n, pe, layout.padded_width(pe), gen)
        Xf = random_block('f32', n, pf, layout.padded_width(pf), gen)
        for two in (False, True):
            Xs = [Xe, Xf] if two else [Xe]
            ps = [pe, pf] if two else [pe]
            tag = f"{kind}{'+f32' if two else ''}"
            for i, (mid, lp) in enumerate((('ne', False), ('logit', True),
                                           ('logit', False),
                                           ('linear', True))):
                vs, c, a, b = sweep_args(ps, n, gen, scalar_c=i % 2 == 0)
                blocks = list(zip(Xs, vs))
                a_ = None if mid == 'ne' else a
                got = ne_sweep(blocks, c, a_, b, mid, lp)
                ref = ne_sweep_plain(blocks, c, a_, b, mid, lp)
                torch.cuda.synchronize()
                check(f"ne_sweep[{mid}{',logp' if lp else ''}] {tag} outs",
                      got[0], ref[0])
                check(f"ne_sweep[{mid}] {tag} u", [got[1]], [ref[1]])
                if lp:
                    check(f"ne_sweep[{mid}] {tag} logp", [got[2]], [ref[2]])
            u1, u2, u3 = (torch.randn(n, generator=gen, device='cuda')
                          for _ in range(3))
            got = tdots_sweep(Xs, ps, u1, u2, u3)
            ref = tdots_sweep_plain(Xs, ps, u1, u2, u3)
            torch.cuda.synchronize()
            check(f"tdots_sweep {tag}",
                  [o for blk in got for o in blk],
                  [o for blk in ref for o in blk])


def flagship_blocks():
    """Blocks of the flagship's stored shapes: int8 0/1 at 10% density
    (45,000 columns) beside f32 (5,000 columns), zero-padded."""
    import torch
    from bayesbridge_tpu_torch.kernels import layout
    gen = torch.Generator(device='cuda').manual_seed(2)
    pe = int(N_PRED * BINARY_FRAC)
    pf = N_PRED - pe
    Xe = torch.zeros((N_OBS, layout.padded_width(pe)), dtype=torch.int8,
                     device='cuda')
    for i in range(0, N_OBS, 4096):
        rows = min(4096, N_OBS - i)
        Xe[i:i + rows, :pe] = (torch.rand((rows, pe), generator=gen,
                                          device='cuda') < 0.1)
    Xf = torch.zeros((N_OBS, layout.padded_width(pf)), device='cuda')
    Xf[:, :pf] = torch.randn((N_OBS, pf), generator=gen, device='cuda')
    return Xe, Xf, pe, pf, gen


def flagship_kernel_checks():
    """Phase 3 at the flagship block shapes: agreement and timings."""
    import torch
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        ne_sweep, ne_sweep_plain)
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_plain)
    Xe, Xf, pe, pf, gen = flagship_blocks()
    gb = (Xe.numel() + 4 * Xf.numel()) / 1e9
    log(f"kernel vs plain at the flagship blocks: {N_OBS} x {pe} int8 + "
        f"{N_OBS} x {pf} f32 ({gb:.3f} GB stored)")
    vs, c, a, b = sweep_args([pe, pf], N_OBS, gen, scalar_c=True)
    blocks = [(Xe, vs[0]), (Xf, vs[1])]
    u1, u2, u3 = (torch.randn(N_OBS, generator=gen, device='cuda')
                  for _ in range(3))
    results = {}
    cases = {
        'ne_sweep[ne]': (lambda: ne_sweep(blocks, c, None, b, 'ne'),
                         lambda: ne_sweep_plain(blocks, c, None, b, 'ne')),
        'ne_sweep[logit]': (
            lambda: ne_sweep(blocks, c * 0.01, a, b, 'logit', True),
            lambda: ne_sweep_plain(blocks, c * 0.01, a, b, 'logit', True)),
        'tdots_sweep': (
            lambda: tdots_sweep([Xe, Xf], [pe, pf], u1, u2, u3),
            lambda: tdots_sweep_plain([Xe, Xf], [pe, pf], u1, u2, u3)),
    }
    for name, (kern, plain) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if name == 'tdots_sweep':
            err = check(name, [o for blk in got for o in blk],
                        [o for blk in ref for o in blk])
        else:
            err = check(name + ' outs', got[0], ref[0])
            err = max(err, check(name + ' u', [got[1]], [ref[1]]))
            if got[2] is not None:
                check(name + ' logp', [got[2]], [ref[2]])
        del got, ref
        ms, plain_ms = time_ms(kern), time_ms(plain)
        # Bytes the design forces: ne reads X in both phases.
        reads = 1 if name == 'tdots_sweep' else 2
        log(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
            f"kernel reads {reads} x {gb:.3f} GB = "
            f"{reads * gb / (ms / 1e3):.1f} GB/s of 3350")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    del Xe, Xf, blocks
    torch.cuda.empty_cache()
    return results


def build_data():
    """The bench.py flagship data with the port's NumPy generator."""
    import numpy as np
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome)
    t0 = time.perf_counter()
    X = simulate_design(N_OBS, N_PRED, binary_frac=BINARY_FRAC, seed=0)
    beta = np.zeros(N_PRED)
    beta[:10] = 1.0
    outcome = simulate_outcome(X, beta, 'logit', seed=1)
    log(f"host data build: {time.perf_counter() - t0:.1f} s "
        f"({N_OBS} x {N_PRED}, nnz {X.nnz})")
    return X, outcome


def run_slice():
    """Phases 4 and 5. Returns the main path's launch counts."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionModel, RegressionCoefPrior)
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    X, outcome = build_data()
    t0 = time.perf_counter()
    model = RegressionModel(outcome, X, family='logit', dtype=np.float32,
                            device='cuda')
    torch.cuda.synchronize()
    design = model.design
    del X
    gb = design.storage_bytes() / 1e9
    log(f"design build + transfer: {time.perf_counter() - t0:.1f} s; "
        f"backend {design.backend}, X_exact {design.X_exact.dtype} "
        f"{tuple(design.X_exact.shape)}, X_float {design.X_float.dtype} "
        f"{tuple(design.X_float.shape)}, {gb:.3f} GB on the device")
    assert design.backend == 'hybrid'
    assert design.X_exact.dtype == torch.int8
    assert 6.0 < gb < 7.0, gb
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    samples, info = bridge.gibbs(n_iter=30, coef_sampler_type='cg', seed=0,
                                 params_to_save='all')
    torch.cuda.synchronize()
    counts = launch_counts()
    wall = time.perf_counter() - t0
    n_cg = info['_reg_coef_sampling_info']['n_cg_iter']
    log(f"gibbs(30) incl. MAP search: {wall:.1f} s; MAP "
        f"{info['_init_optim_info']}; n_cg_iter {n_cg.astype(int).tolist()}")
    log(f"launch counts of the main path: {counts}")
    assert np.all(np.isfinite(samples['logp'])), samples['logp']
    assert samples['coef'].shape == (N_PRED + 1, 30)
    assert np.all(np.isfinite(samples['coef']))
    assert n_cg.max() < 500, n_cg.max()
    assert counts['tdots_sweep'] >= 30, counts
    assert counts['ne_sweep[ne]'] >= int(np.sum(n_cg + 1)), counts
    assert counts['ne_sweep[logit]'] >= 1, counts
    log(f"logp: first {samples['logp'][0]:.6g}, last "
        f"{samples['logp'][-1]:.6g}; intercept mean "
        f"{samples['coef'][0].mean():.4f}; mean coef[1:11] "
        f"{samples['coef'][1:11].mean():.4f}, max |coef[11:]| mean "
        f"{np.abs(samples['coef'][11:]).mean():.2e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_more, i_more = bridge.gibbs_resume(info, 20)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cg_more = i_more['_reg_coef_sampling_info']['n_cg_iter']
    passes = float(np.mean(2 * (cg_more + 1) + 2))
    ips = 20 / secs
    log(f"steady state, 20 iterations via gibbs_resume: {ips:.4f} iter/s, "
        f"mean CG iterations {cg_more.mean():.2f}, design passes/iter "
        f"{passes:.2f} (ne sweep 2 per application, tdots 1, linear "
        f"predictor 1), achieved {passes * gb * ips:.1f} GB/s of 3350; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} "
        f"GB over the 50 iterations")
    assert np.all(np.isfinite(s_more['logp']))

    s20, i20 = bridge.gibbs(n_iter=20, coef_sampler_type='cg', seed=0,
                            params_to_save='all')
    s30, _ = bridge.gibbs_resume(i20, 10, merge=True, prev_samples=s20)
    for key in samples:
        if not np.array_equal(s30[key], samples[key]):
            raise AssertionError(f"resume != uninterrupted for {key}")
    log("resume check: gibbs(20) + gibbs_resume(10, merge=True) == "
        "gibbs(30) exactly")
    return counts


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import bayesbridge_tpu_torch  # noqa: F401  (fails outside the repo)
    from bayesbridge_tpu_torch.kernels import REGISTRY, load_library
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (float32 products in full float32)")

    kl = load_library()
    log(f"kernel build: {kl.build_seconds:.1f} s -> {kl.path.name}")
    for line in kl.ptxas_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ptxas: ' + line.strip())

    kernel_checks()
    flagship = flagship_kernel_checks()
    counts = run_slice()

    kernels = []
    for name, res in flagship.items():
        reg = REGISTRY['tdots_sweep' if name == 'tdots_sweep'
                       else 'ne_sweep']
        kernels.append(dict(name=name, route='cuda', source=reg['source'],
                            replaces=reg['replaces'],
                            launches=counts[name], **res))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
