#!/usr/bin/env python3
"""Drive the torch port's paths once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   TF32 is turned off for matmuls and cuDNN;
2. build the hand-written kernels from ``bayesbridge_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together);
3. each kernel against its plain PyTorch version on the card at ragged
   small shapes: every mode of ne_sweep's two-pass route (ne / logit /
   linear, with and without logp), its row pass (``ne_rows``) and column
   pass (``colpass``) alone, and tdots_sweep with four and five
   reductions,
   over int8 / bf16 / f32 exact blocks, one and two blocks, garbage in
   the padding; every variant of the one-read sweep ``ne_onepass`` (phase
   A fma / mma2 / mma1, phase B fma / mma2 / mma3, convert once or not)
   over rows spanning many panels; the one-read kernel ``ne_oneread``
   in every mode (the CG operator; logit and linear with and without
   logp) on every block pair the hybrid design builds (int8 / bf16 / f32
   exact block beside f32, or alone), with a rerun's bits and the
   ``ne_sweep`` route to it;
   ``stream_probe`` on aligned blocks; bitlut on bitmaps whose
   byte-groups and outputs fill no block (one with more table chunks
   per block than its stage ring holds), both orientations, and its
   byte-table and L2 modes against their plain versions; winell on
   packings with overfull cells and wincsr on windowed-CSR layouts with
   empty rows (one window, or windows of 64), both orientations,
   ``square`` off and on, with a rerun's bits; and small bitpack and
   winell designs (spill present) against their dense form;
4. the sweeps (``ne_sweep[ne]``, ``[logit]`` and ``[linear]`` on their
   two-pass route), their row and column passes, the five-reduction
   tdots_sweep, ``ne_oneread`` (also against the composed pair in
   turns), ``ne_oneread[linear]`` with logp, ``ne_oneread[logit]`` with
   logp (the MAP search's objective;
   also in turns against the two-pass link sweep and against the
   composed objective: row pass, loglik rows, column pass, the
   launches of these turns counted) and every ne_onepass variant at the
   flagship block shapes, and stream_probe over 2 GB, with CUDA-event
   timings of kernel and plain version, the bound and, where one PyTorch
   call computes the same function, that call's time;
5. the hybrid slices: a 100,000 x 50,000 sparse logit design (90% binary
   columns at 10% density, as bench.py builds it) on the hybrid int8 +
   f32 backend, first under the fused policy (``fused='1'``), then, on
   the same stored blocks, composed (block-ordered CG over the row and
   column passes, the warm start in the five-reduction pre-solve, the
   linear predictor from the CG loop): under 'auto', the default, where
   it composes the CG operator and the pre-solve (whichever way it takes
   the MAP search's objective), else under ``fused='0'`` and 'auto' in
   a slice of its own. The fused sweeps run on ``ne_oneread``. Each:
   ``gibbs(20)`` with the CG sampler and bridge exponent 0.5 (MAP search
   included), launch counters read right after it, 10 more iterations
   through ``gibbs_resume`` timed, resume on the card (``gibbs(13)`` +
   ``gibbs_resume(7, merge=True)`` must equal the ``gibbs(20)`` run
   exactly) and a profiler window (busy share, device ms per
   iteration); then the alternating A/B segments (4 rounds); then the
   MAP search's witness (the search with the fused objective, on
   ``ne_oneread[logit]``, and with the composed one on the same design,
   and the two objectives compared) and the two objectives' times in
   turns;
6. the dense and linear slices: (a) the linear model over the hybrid
   slices' stored blocks (y = X beta + N(0, 1) noise), under 'auto' (its
   MAP search on ``ne_oneread[linear]``, the CG operator and the
   pre-solve composed): ``gibbs(20)`` with the Jacobi preconditioner,
   launch counters read right after it, 10 resumed iterations timed,
   the resume check and a profiler window, then ``gibbs(10)`` with the
   prior preconditioner, and the one-read linear objective in turns
   against the two-pass sweep and the composed one; then the multichain
   phase on the same stored blocks: the chain-batched kernels
   (``ne_rows_k``, ``colpass_k``, ``tdots_sweep_k`` with five and four
   reductions) for 1, 2, 4 and 8 chains against their plain versions
   and, bit for bit, against the chains' single-vector launches, timed
   beside k x the single launch and the bound; ``gibbs_chains`` with 4
   overdispersed chains under 'auto' (the launch counts of the first
   call, ``gibbs_chains_resume`` timed against the single-chain 'auto'
   slice's iter/s, the exact-resume check, a profiler window, split
   R-hat and pooled ESS on coef[1:201], ESS/s); 2 chains against the
   chains run alone from their generators (equal CG iteration counts,
   coef within rtol 1e-6); a 2-chain fused ('1') run, whose launch
   counts show ``ne_oneread`` once per chain per application; then the
   Cox phase: Cox outcomes on the same X (beta ten ones, the censoring
   scale set for a censored fraction of 0.9), the model built through
   ``RegressionModel((event_time, censoring_time), X, family='cox')``
   (the factory sorts the rows and builds a hybrid of the same stored
   bytes; its build time printed), the row and column passes and their
   4-chain forms on its blocks against their plain versions, timed; HMC
   ``gibbs(6)`` (MAP search included; the launch counts must show one row
   and one column pass per gradient, Hessian matvec and MAP objective,
   and a row pass per iteration for the Hessian's weights and one for
   the log density), ``gibbs_resume(4)`` timed, the exact-resume check
   (``gibbs(4)`` + ``gibbs_resume(2, merge=True)`` equals the first
   ``gibbs(6)``), a 2-iteration profiler window; NUTS
   ``gibbs(4)``; logit HMC ``gibbs(4)`` on the hybrid slices' stored
   blocks under 'auto' (every gradient on ``ne_oneread[logit]``, which
   is checked and timed on those blocks); ``gibbs_chains`` with 4 Cox
   chains under HMC (``ne_rows_k`` / ``colpass_k``) and a 1-iteration
   profiler window; 2 Cox chains against the chains run alone for an
   iteration (equal bits); per iteration the gradient evaluations, step counts or tree
   heights, stepsizes, acceptance, Hessian matvecs and host syncs, and
   one gradient's time beside its bound (two reads for Cox, one for
   logit); (b) a dense logit
   design, X standard normal, 100,000 x 4,000, made on the card and
   stored as 4,004 float32 columns: ``ne_oneread``, its logit mode and
   ``tdots_sweep`` on the lone block against their plain versions, the
   CG operator also in turns against the cuBLAS pair
   ``X' (w * (X v))``; the Cholesky sampler (the default) in float32
   (``gibbs(20)``, its MAP search on ``ne_oneread[logit]``, 10 resumed
   iterations, the resume check, a profiler window), the Gram and the
   Cholesky factor timed in float32 and float64 beside their bounds,
   ``gibbs(10)`` in float64 (no kernel launched), and the CG sampler
   under ``fused='1'`` (the kernels on the lone block) and ``'auto'``
   (the cuBLAS pair), ``gibbs(20)`` each;
7. the bitpack slice: the same X with ``backend='bitpack'`` (bitmaps of
   5,632 x 106,496 and 12,512 x 49,152 bytes plus a 100,000 x 5,000 f32
   block); bitlut against its plain version on the design's bitmaps,
   timed beside its bound and beside cuSPARSE (``torch.sparse_csr_tensor
   @ v``) on the binary columns' CSR, and every mode of its source in
   turns (``baselines/bitlut_ablation.py``: the design's nibble tables,
   the first design's byte tables, nibble tables from L2, no lookups);
   the f32 side block's GEMV pair timed beside its bound; then a
   15-iteration chain on the composed CG path, and its MAP search against
   the hybrid's;
8. the winell slice: a 131,072 x 16,384 design with 164 standard-normal
   entries per row (``backend='auto'`` picks winell, which stores a
   windowed CSR on the card); wincsr against its plain version on the
   design's layouts, timed beside its bound and beside cuSPARSE on the
   full CSR; the windowed-ELL kernel winell, which no path runs any
   more, on the JAX package's packings (packed on the host on demand,
   copied to the card here), its products run once right after the
   counters are zeroed (the launches the kernels line reports, marked
   ``"path": "check-only"``), then checked and timed the same way; then
   the same chain, on wincsr;
9. the sweep A/B harness (``bayesbridge_tpu_torch.baselines.
   dev_ne_variants``) at the flagship block shape: the composed pair,
   ne_sweep's two-pass route, ne_oneread and the default one-read
   variants of ne_onepass, then ``--probe`` and ``--presolve``, its
   launch counters read right after it.

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it a JSON summary of the kernels (each with the ``path``
its launches were counted on, ``check-only`` where no path of the
package runs it), and the last line
``{"ok": true, "device": {...}}``. With no CUDA device it exits 1 and
prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

N_OBS, N_PRED = 100_000, 50_000
DENSE_N, DENSE_P = 100_000, 4_000
BINARY_FRAC = 0.9
WINELL_N, WINELL_P, WINELL_PER_ROW = 131_072, 16_384, 164
RTOL = 1e-4  # relative to max|plain|: the two sum in different orders
# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The FP64 tensor-core peak of the same data sheet (cuBLAS's DGEMM runs
# there): the float64 Gram's bound.
FP64_TC_OPS_PER_S = 67e12


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, inner=1):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up;
    with `inner` > 1, each timing spans that many calls back to back (a
    call shorter than its host-side launch would otherwise time the host)
    and counts per call."""
    import torch
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


def bound_ms(n_bytes, n_ops):
    """(least time in ms, 'bytes' | 'operations'): the larger of the bytes
    over the HBM rate and the float32 operations over the peak rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, 'bytes') if by_bytes >= by_ops \
        else (by_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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
    """Phase 3 for the sweeps: every mode of the two-pass route, dtype and
    block count against the plain version at a ragged small shape."""
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
                got = ne_sweep(blocks, c, a_, b, mid, lp, route='twopass')
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


def composed_and_onepass_checks():
    """Phase 3 for the composed products (ne_rows, colpass, tdots_sweep
    with u4), every ne_onepass variant and stream_probe."""
    import torch
    from bayesbridge_tpu_torch.kernels import layout
    from bayesbridge_tpu_torch.kernels.ne_onepass import (
        A_MODES, B_MODES, ne_onepass, ne_onepass_plain)
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        colpass, colpass_plain, ne_rows, ne_rows_plain)
    from bayesbridge_tpu_torch.kernels.stream_probe import (
        stream_probe, stream_probe_plain)
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_plain)
    n, pe, pf = 1037, 4097, 513
    gen = torch.Generator(device='cuda').manual_seed(4)
    log(f"row pass, column pass and five-reduction tdots vs plain, ragged "
        f"n={n} p_e={pe} p_f={pf} (padding holds garbage)")
    for kind in ('int8', 'bf16', 'f32'):
        Xe = random_block(kind, n, pe, layout.padded_width(pe), gen)
        Xf = random_block('f32', n, pf, layout.padded_width(pf), gen)
        for two in (False, True):
            Xs, ps = ([Xe, Xf], [pe, pf]) if two else ([Xe], [pe])
            tag = f"{kind}{'+f32' if two else ''}"
            vs, c, _, u = sweep_args(ps, n, gen, scalar_c=two)
            blocks = list(zip(Xs, vs))
            check(f"ne_rows {tag}", [ne_rows(blocks, c)],
                  [ne_rows_plain(blocks, c)])
            check(f"colpass {tag}", colpass(Xs, ps, u),
                  colpass_plain(Xs, ps, u))
            us = [torch.randn(n, generator=gen, device='cuda')
                  for _ in range(4)]
            check(f"tdots_sweep[u4] {tag}",
                  [o for blk in tdots_sweep(Xs, ps, *us) for o in blk],
                  [o for blk in tdots_sweep_plain(Xs, ps, *us) for o in blk])

    log(f"ne_onepass vs plain, every variant, ragged n={n} p_e={pe} "
        f"p_f={pf}, 2 KiB panels (1-2 rows, {n} panels) and 64 KiB")
    Xe = random_block('int8', n, pe, layout.padded_width(pe), gen)
    Xf = random_block('f32', n, pf, layout.padded_width(pf), gen)
    (ve, vf), c, _, w = sweep_args([pe, pf], n, gen, scalar_c=False)
    for a_mode in A_MODES:
        for b_mode in B_MODES:
            for cvt in (False, True):
                ref = ne_onepass_plain(Xe, Xf, ve, vf, c, w, a_mode, b_mode,
                                       cvt)
                for kib in (2, 64):
                    got = ne_onepass(Xe, Xf, ve, vf, c, w, a_mode, b_mode,
                                     cvt, panel_bytes=kib * 1024)
                    again = ne_onepass(Xe, Xf, ve, vf, c, w, a_mode, b_mode,
                                       cvt, panel_bytes=kib * 1024)
                    tag = f"{a_mode},{b_mode}{',cvt' if cvt else ''}"
                    check(f"ne_onepass[{tag}] {kib} KiB outs", got[:2],
                          ref[:2])
                    check(f"ne_onepass[{tag}] {kib} KiB u", [got[2]],
                          [ref[2]])
                    assert all(torch.equal(x, y) for x, y in
                               zip(got, again)), "ne_onepass not deterministic"

    oneread_checks(n, pe, pf, gen)

    log("stream_probe vs plain, aligned 96 x 4096 int8 (and its int32 view)")
    X8 = torch.randint(-128, 128, (96, 4096), generator=gen, device='cuda',
                       dtype=torch.int8)
    v = torch.randn(4096, generator=gen, device='cuda')
    seed = torch.tensor(3.0, device='cuda')
    for kind, X, vv in (('i32', X8.view(torch.int32), None), ('cvt', X8, None),
                        ('mul', X8, v)):
        check(f"stream_probe[{kind}]", [stream_probe(X, seed, kind, vv)],
              [stream_probe_plain(X, seed, kind, vv)])


def oneread_checks(n, pe, pf, gen):
    """The one-read kernel in every mode (the CG operator; logit and
    linear with and without logp) against the sweep's plain version on
    every block pair the hybrid design builds (exact int8 / bf16 beside
    f32, either alone, f32 alone), NaN in the float padding; two runs
    give the same bits, and ``ne_sweep`` routes each mode to it."""
    import torch
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, layout, reset_launch_counts)
    from bayesbridge_tpu_torch.kernels.ne_oneread import (
        ne_oneread, ne_oneread_link)
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        ne_sweep, ne_sweep_plain)
    log(f"ne_oneread vs plain, ragged n={n} p_e={pe} p_f={pf} (the last "
        f"panel partial, NaN in the float padding), every block pair and "
        f"mode")
    for pair in ('int8+f32', 'bf16+f32', 'int8', 'bf16', 'f32'):
        kinds = pair.split('+')
        Xs = [random_block(k, n, p, layout.padded_width(p), gen)
              for k, p in zip(kinds, (pe, pf))]
        vs, c, _, w = sweep_args([pe, pf][:len(kinds)], n, gen,
                                 scalar_c=len(kinds) == 1)
        blocks = list(zip(Xs, vs))
        ref = ne_sweep_plain(blocks, c, None, w, 'ne')
        got = ne_oneread(blocks, c, w)
        again = ne_oneread(blocks, c, w)
        check(f"ne_oneread {pair} outs", got[0], ref[0])
        check(f"ne_oneread {pair} u", [got[1]], [ref[1]])
        assert all(torch.equal(x, y) for x, y in
                   zip(got[0] + [got[1]], again[0] + [again[1]])), \
            "ne_oneread is not deterministic"
        reset_launch_counts()
        routed = ne_sweep(blocks, c, None, w, 'ne')
        assert launch_counts()['ne_oneread'] == 1, launch_counts()
        check(f"ne_sweep[ne] {pair} through the one-read route", routed[0],
              ref[0])
        for mid, lp in (('logit', True), ('logit', False), ('linear', True),
                        ('linear', False)):
            vs, c, a, b = sweep_args([pe, pf][:len(kinds)], n, gen,
                                     scalar_c=mid == 'logit')
            blocks = list(zip(Xs, vs))
            tag = f"ne_oneread[{mid}{',logp' if lp else ''}] {pair}"
            ref = ne_sweep_plain(blocks, c, a, b, mid, lp)
            got = ne_oneread_link(blocks, c, a, b, mid, lp)
            again = ne_oneread_link(blocks, c, a, b, mid, lp)
            check(f"{tag} outs", got[0], ref[0])
            check(f"{tag} u", [got[1]], [ref[1]])
            if lp:
                check(f"{tag} logp", [got[2]], [ref[2]])
            bits = got[0] + [got[1]] + ([got[2]] if lp else [])
            bits2 = again[0] + [again[1]] + ([again[2]] if lp else [])
            assert all(torch.equal(x, y) for x, y in zip(bits, bits2)), \
                f"{tag} is not deterministic"
            reset_launch_counts()
            routed = ne_sweep(blocks, c, a, b, mid, lp)
            counts = launch_counts()
            assert counts[f'ne_oneread[{mid}]'] == 1 \
                and counts[f'ne_sweep[{mid}]'] == 0, counts
            assert all(torch.equal(x, y) for x, y in zip(routed[0], got[0]))


def packed_kernel_checks():
    """Phase 3 for bitlut and winell: raw ragged bitmaps and packings with
    spill against the plain versions, then small bitpack and winell
    designs on the card against their dense form (float64)."""
    import numpy as np
    import scipy.sparse as sps
    import torch
    from bayesbridge_tpu_torch.design import SparseDesignMatrix
    from bayesbridge_tpu_torch.design.winell import pack_winell, plan_windows
    from bayesbridge_tpu_torch.kernels.bitlut import (
        bitlut, bitlut_plain, bitlut_variant, byte_lut_plain)
    from bayesbridge_tpu_torch.kernels.winell import winell, winell_plain
    gen = torch.Generator(device='cuda').manual_seed(3)
    log("bitlut vs plain, ragged bitmaps (byte-groups not a multiple of "
        "32, outputs not of 128; 23,000 groups: 5 table chunks per block, "
        "more than the stage ring's 4), and its byte-table and L2 modes")
    for g_pad, m_pad, n_out in ((8, 128, 1), (40, 384, 300),
                                (200, 8320, 8200), (23_000, 8320, 8200)):
        bits = torch.randint(0, 256, (g_pad, m_pad), generator=gen,
                             device='cuda', dtype=torch.uint8)
        v = torch.randn(8 * g_pad, generator=gen, device='cuda')
        ref = bitlut_plain(bits, v, n_out)
        for tag in ('dot', 'tdot'):
            got = bitlut(bits, v, n_out, tag)
            again = bitlut(bits, v, n_out, tag)
            check(f"bitlut[{tag}] G={g_pad} M={m_pad} n_out={n_out}",
                  [got], [ref])
            assert torch.equal(got, again), "bitlut is not deterministic"
        check(f"bitlut byte-table mode G={g_pad}",
              [bitlut_variant(bits, v, n_out, 'byte')],
              [bitlut_plain(bits, v, n_out, byte_lut_plain)])
        check(f"bitlut L2 mode G={g_pad}",
              [bitlut_variant(bits, v, n_out, 'nibble_l2')], [ref])

    rng = np.random.default_rng(4)
    n, p = 1037, 613
    dense = rng.standard_normal((n, p)) * (rng.random((n, p)) < .03)
    dense[::50, :200] = rng.standard_normal((len(range(0, n, 50)), 200))
    dense[:300, ::40] = rng.standard_normal((300, len(range(0, p, 40))))
    log(f"winell vs plain, packings of a {n} x {p} matrix with overfull "
        f"cells")
    for transpose in (False, True):
        X = sps.csr_matrix(dense.T if transpose else dense)
        n_out, n_in = X.shape
        W, K = plan_windows(n_in, n_out, X.nnz)
        idx, val, spill = pack_winell(X, W, K)
        assert spill is not None and spill.nnz > 0
        idx, val = torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda()
        v = torch.from_numpy(rng.standard_normal(n_in).astype(np.float32))
        v = v.cuda()
        for square in (False, True):
            got = winell(idx, val, v, n_out, W, K, square)
            again = winell(idx, val, v, n_out, W, K, square)
            check(f"winell{'[square]' if square else ''} "
                  f"{n_out}x{n_in} W={W} K={K} spill {spill.nnz}",
                  [got], [winell_plain(idx, val, v, n_out, W, K, square)])
            assert torch.equal(got, again), "winell is not deterministic"

    log(f"wincsr vs plain, layouts of the same {n} x {p} matrix (rows "
        f"150-189 empty) with one window or windows of 64")
    from bayesbridge_tpu_torch.design.wincsr import build_wincsr
    from bayesbridge_tpu_torch.kernels.wincsr import wincsr, wincsr_plain
    holes = dense.copy()
    holes[150:190] = 0.0
    for transpose in (False, True):
        X = sps.csr_matrix(holes.T if transpose else holes)
        v = torch.from_numpy(
            rng.standard_normal(X.shape[1]).astype(np.float32)).cuda()
        for window in (None, 64):
            m = build_wincsr(X, window).to('cuda')
            for square in (False, True):
                got = wincsr(m, v, square)
                again = wincsr(m, v, square)
                check(f"wincsr{'[square]' if square else ''} "
                      f"{X.shape[0]}x{X.shape[1]} window {m.window} "
                      f"lanes {m.lanes}", [got], [wincsr_plain(m, v, square)])
                assert torch.equal(got, again), "wincsr is not deterministic"

    log("small packed designs on the card against their dense form")
    mixed = (rng.random((n, p)) < .1).astype(np.float64)
    mixed[:, ::7] *= rng.standard_normal((n, len(range(0, p, 7))))
    for backend, X in (('bitpack', mixed), ('winell', dense)):
        design = SparseDesignMatrix(sps.csr_matrix(X), center_predictor=True,
                                    backend=backend, device='cuda')
        Xd = torch.from_numpy(design.toarray()).double().cuda()
        v = torch.randn(design.shape[1], generator=gen, device='cuda')
        w = torch.rand(n, generator=gen, device='cuda') + .1
        check(f"{backend} design dot", [design.dot(v)], [Xd @ v.double()])
        check(f"{backend} design Tdot", [design.Tdot(w)], [Xd.T @ w.double()])
        check(f"{backend} design Fisher diagonal",
              [design.compute_fisher_diag(w)], [(Xd * Xd).T @ w.double()])


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
    """Phase 4: the sweeps at the flagship block shapes, agreement,
    timings and bound. No single PyTorch call multiplies int8 by f32, so
    the sweeps have no library time. Returns (results, the launch counts
    of the link sweeps' in-turns timings)."""
    import torch
    import torch.nn.functional as F
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.kernels.ne_onepass import (
        A_MODES, B_MODES, ne_onepass, ne_onepass_plain)
    from bayesbridge_tpu_torch.kernels.ne_oneread import (
        CLUSTER, block_plan, fit_clusters, ne_oneread, ne_oneread_link)
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        colpass, colpass_plain, ne_rows, ne_rows_plain, ne_sweep,
        ne_sweep_plain)
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_plain)
    from bayesbridge_tpu_torch.kernels import layout, load_library
    Xe, Xf, pe, pf, gen = flagship_blocks()
    gb = (Xe.numel() + 4 * Xf.numel()) / 1e9
    log(f"kernel vs plain at the flagship blocks: {N_OBS} x {pe} int8 + "
        f"{N_OBS} x {pf} f32 ({gb:.3f} GB stored)")
    vs, c, a, b = sweep_args([pe, pf], N_OBS, gen, scalar_c=True)
    blocks = [(Xe, vs[0]), (Xf, vs[1])]
    u1, u2, u3, u4 = (torch.randn(N_OBS, generator=gen, device='cuda')
                      for _ in range(4))
    c_vec = torch.randn(N_OBS, generator=gen, device='cuda') * 0.1
    c_link = c * 0.01
    def flat(blks):
        return [[o for blk in blks for o in blk]]
    results = {}
    # name: (kernel, plain version, groups of outputs to compare: outs,
    # u, logp each against its own scale)
    cases = {
        'ne_sweep[ne]': (lambda: ne_sweep(blocks, c, None, b, 'ne',
                                          route='twopass'),
                         lambda: ne_sweep_plain(blocks, c, None, b, 'ne'),
                         lambda r: [r[0], [r[1]]]),
        'ne_oneread': (lambda: ne_oneread(blocks, c, b),
                       lambda: ne_sweep_plain(blocks, c, None, b, 'ne')[:2],
                       lambda r: [r[0], [r[1]]]),
        'ne_sweep[logit]': (
            lambda: ne_sweep(blocks, c_link, a, b, 'logit', True,
                             route='twopass'),
            lambda: ne_sweep_plain(blocks, c_link, a, b, 'logit', True),
            lambda r: [r[0], [r[1]], [r[2]]]),
        'ne_oneread[logit]': (
            lambda: ne_oneread_link(blocks, c_link, a, b, 'logit', True),
            lambda: ne_sweep_plain(blocks, c_link, a, b, 'logit', True),
            lambda r: [r[0], [r[1]], [r[2]]]),
        'ne_sweep[linear]': (
            lambda: ne_sweep(blocks, c_link, a, b, 'linear', True,
                             route='twopass'),
            lambda: ne_sweep_plain(blocks, c_link, a, b, 'linear', True),
            lambda r: [r[0], [r[1]], [r[2]]]),
        'ne_oneread[linear]': (
            lambda: ne_oneread_link(blocks, c_link, a, b, 'linear', True),
            lambda: ne_sweep_plain(blocks, c_link, a, b, 'linear', True),
            lambda r: [r[0], [r[1]], [r[2]]]),
        'tdots_sweep': (
            lambda: tdots_sweep([Xe, Xf], [pe, pf], u1, u2, u3),
            lambda: tdots_sweep_plain([Xe, Xf], [pe, pf], u1, u2, u3), flat),
        'ne_sweep[rows]': (lambda: [ne_rows(blocks, c)],
                           lambda: [ne_rows_plain(blocks, c)],
                           lambda r: [r]),
        'ne_sweep[cols]': (lambda: colpass([Xe, Xf], [pe, pf], u1),
                           lambda: colpass_plain([Xe, Xf], [pe, pf], u1),
                           lambda r: [r]),
        'tdots_sweep[u4]': (
            lambda: tdots_sweep([Xe, Xf], [pe, pf], u1, u2, u3, u4),
            lambda: tdots_sweep_plain([Xe, Xf], [pe, pf], u1, u2, u3, u4),
            flat),
    }
    n_elem = N_OBS * (pe + pf)
    vec = 4 * (pe + pf)  # one p-length vector in f32
    row = 4 * N_OBS      # one n-length vector in f32
    X_b = gb * 1e9
    # Bytes read once and written once, and float32 operations: ne,
    # logit and linear read X, v, b (and a) and write u and X'u, two FMAs
    # per element; the row pass reads X and v and writes t, the column
    # pass reads X and u and writes X'u, one FMA per element each; tdots
    # reads X and u1..u3 (u4) and writes 4 (5) p-vectors, four (five)
    # FMAs and a multiply per element; ne_onepass reads X, v, c, w and
    # writes u and X'u.
    work = {'ne_sweep[ne]': (X_b + 2 * vec + 2 * row, 4 * n_elem),
            'ne_oneread': (X_b + 2 * vec + 2 * row, 4 * n_elem),
            'ne_sweep[logit]': (X_b + 2 * vec + 3 * row, 4 * n_elem),
            'ne_oneread[logit]': (X_b + 2 * vec + 3 * row, 4 * n_elem),
            'ne_sweep[linear]': (X_b + 2 * vec + 3 * row, 4 * n_elem),
            'ne_oneread[linear]': (X_b + 2 * vec + 3 * row, 4 * n_elem),
            'tdots_sweep': (X_b + 4 * vec + 3 * row, 9 * n_elem),
            'ne_sweep[rows]': (X_b + vec + row, 2 * n_elem),
            'ne_sweep[cols]': (X_b + vec + row, 2 * n_elem),
            'tdots_sweep[u4]': (X_b + 5 * vec + 4 * row, 11 * n_elem),
            'ne_onepass': (X_b + 2 * vec + 3 * row, 4 * n_elem)}
    reads = {'ne_sweep[ne]': 2, 'ne_sweep[logit]': 2, 'ne_sweep[linear]': 2}
    # ne_sweep's modes are timed on their two-pass route; the fused sweep
    # takes the one-read route (ne_oneread) wherever its plan fits.
    for name, (kern, plain, outs) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = max(check(f"{name} [{i}]", g, r)
                  for i, (g, r) in enumerate(zip(outs(got), outs(ref))))
        del got, ref
        ms, plain_ms = time_ms(kern), time_ms(plain)
        bound, by = bound_ms(*work[name])
        k = reads.get(name, 1)
        log(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({by}); kernel reads {k} x {gb:.3f} GB = "
            f"{k * gb / (ms / 1e3):.1f} GB/s of 3350")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=None)

    # The one-read operator: a rerun's bits, its plan, and the composed
    # pair it replaces, timed in turns (pair, one-read, one-read, pair).
    got, again = ne_oneread(blocks, c, b), ne_oneread(blocks, c, b)
    assert all(torch.equal(x, y) for x, y in zip(
        got[0] + [got[1]], again[0] + [again[1]])), \
        "ne_oneread is not deterministic"
    del got, again
    codes = (layout.DTYPE_CODE[Xe.dtype], layout.DTYPE_CODE[Xf.dtype])
    p = block_plan(blocks)
    fit = fit_clusters(load_library(), codes, p)
    log(f"  ne_oneread plan: {p}, {fit} clusters of {CLUSTER} at once "
        f"({fit * CLUSTER} SMs)")

    def pair():
        return colpass([Xe, Xf], [pe, pf], b * ne_rows(blocks, c))
    turns = [time_ms(fn) for fn in (pair, lambda: ne_oneread(blocks, c, b),
                                    lambda: ne_oneread(blocks, c, b), pair)]
    log(f"  composed pair vs ne_oneread in turns (pair, one-read, one-read, "
        f"pair): {[round(t, 3) for t in turns]} ms; one-read "
        f"{(turns[1] + turns[2]) / 2:.3f} against the pair "
        f"{(turns[0] + turns[3]) / 2:.3f} ms (target: at most "
        f"{2 * results['ne_oneread']['bound_ms']:.3f}, twice the bound)")

    # The MAP search's objective (logit score, its loglik sum and X' u):
    # the one-read kernel's rerun bits, then in turns against the
    # two-pass link sweep and against the composed objective (the row
    # pass, the loglik rows, the column pass), the launches of these
    # turns counted.
    got = ne_oneread_link(blocks, c_link, a, b, 'logit', True)
    again = ne_oneread_link(blocks, c_link, a, b, 'logit', True)
    assert all(torch.equal(x, y) for x, y in zip(
        got[0] + [got[1], got[2]], again[0] + [again[1], again[2]])), \
        "ne_oneread[logit] is not deterministic"
    del got, again

    def oneread_link():
        return ne_oneread_link(blocks, c_link, a, b, 'logit', True)

    def twopass_link():
        return ne_sweep(blocks, c_link, a, b, 'logit', True,
                        route='twopass')

    def composed_link():
        t = ne_rows(blocks, c_link)
        lp = torch.sum(a * t - b * F.softplus(t))
        return colpass([Xe, Xf], [pe, pf], a - b * torch.sigmoid(t)), lp
    reset_launch_counts()
    link_turns = {}
    for other, fn in (('two-pass', twopass_link),
                      ('composed', composed_link)):
        ts = [time_ms(f) for f in (fn, oneread_link, oneread_link, fn)]
        link_turns[other] = ((ts[1] + ts[2]) / 2, (ts[0] + ts[3]) / 2)
        log(f"  {other} link vs ne_oneread[logit] in turns ({other}, "
            f"one-read, one-read, {other}): {[round(t, 3) for t in ts]} ms;"
            f" one-read {link_turns[other][0]:.3f} against "
            f"{link_turns[other][1]:.3f} ms (target: at most "
            f"{2 * results['ne_oneread[logit]']['bound_ms']:.3f}, twice "
            f"the bound)")
    torch.cuda.synchronize()
    turn_counts = launch_counts()
    log(f"  launch counts of the link turns: {turn_counts}")
    results['ne_oneread[logit]']['turns_ms'] = link_turns

    log("ne_onepass at the flagship blocks, every variant (one read of X; "
        "v, c, w as the harness's)")
    ve, vf = vs[0] / pe ** .5, vs[1] / pf ** .5
    w = b - 0.4
    onepass = {}
    for a_mode in A_MODES:
        for b_mode in B_MODES:
            for cvt in (False, True):
                tag = f"{a_mode},{b_mode}{',cvt' if cvt else ''}"

                def kern(a_mode=a_mode, b_mode=b_mode, cvt=cvt):
                    return ne_onepass(Xe, Xf, ve, vf, c_vec, w, a_mode,
                                      b_mode, cvt)
                ref = ne_onepass_plain(Xe, Xf, ve, vf, c_vec, w, a_mode,
                                       b_mode, cvt)
                got = kern()
                err = max(check(f"ne_onepass[{tag}] outs", got[:2], ref[:2]),
                          check(f"ne_onepass[{tag}] u", [got[2]], [ref[2]]))
                del got, ref
                onepass[tag] = (err, time_ms(kern, reps=5))
    bound, by = bound_ms(*work['ne_onepass'])
    for tag, (err, ms) in onepass.items():
        log(f"  ne_onepass[{tag}]: kernel {ms:.3f} ms, bound {bound:.3f} ms "
            f"({by}), {gb / (ms / 1e3):.1f} GB/s of 3350")
    # The kernels line carries the plain variant (phase A and B on the CUDA
    # cores, no convert-once); the log above has every variant.
    err, ms = onepass['fma,fma']
    plain_ms = time_ms(lambda: ne_onepass_plain(Xe, Xf, ve, vf, c_vec, w),
                       reps=3)
    results['ne_onepass'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by,
                                 library_ms=None)
    del Xe, Xf, blocks
    torch.cuda.empty_cache()
    return results, turn_counts


def probe_timings():
    """stream_probe over the harness's 2 GB int8 stream (and its int32
    view): agreement, timings of kernel, plain version and the one
    ``torch.sum`` that reads the same stream (none for mul), and the
    bound."""
    import torch
    from bayesbridge_tpu_torch.baselines.dev_ne_variants import (
        PROBE_GB, probe_block)
    from bayesbridge_tpu_torch.kernels.stream_probe import (
        stream_probe, stream_probe_plain)
    gen = torch.Generator(device='cuda').manual_seed(6)
    X8 = probe_block(N_OBS, PROBE_GB, gen, 'cuda')
    n_elem = X8.numel()
    log(f"stream_probe at {tuple(X8.shape)} int8 ({n_elem / 1e9:.3f} GB)")
    seed = torch.tensor(1e-3, device='cuda')
    library = {'i32': lambda: torch.sum(X8.view(torch.int32)),
               'cvt': lambda: torch.sum(X8, dtype=torch.float32),
               'mul': None}
    # Operations per byte: i32 one add per 4 bytes, cvt a convert and an
    # add per byte, mul a convert and an FMA per byte (v from cache).
    ops = {'i32': n_elem / 4, 'cvt': 2 * n_elem, 'mul': 3 * n_elem}
    results = {}
    for kind in ('i32', 'cvt', 'mul'):
        X = X8.view(torch.int32) if kind == 'i32' else X8
        kern = lambda X=X, k=kind: stream_probe(X, seed, k)  # noqa: E731
        plain = lambda X=X, k=kind: stream_probe_plain(X, seed, k)  # noqa
        err = check(f"stream_probe[{kind}]", [kern()], [plain()])
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=3)
        lib_ms = time_ms(library[kind]) if library[kind] else None
        bound, by = bound_ms(n_elem + 4, ops[kind])
        log(f"  stream_probe[{kind}]: kernel {ms:.4f} ms "
            f"({n_elem / 1e9 / (ms / 1e3):.1f} GB/s of 3350), plain "
            f"{plain_ms:.3f} ms, torch.sum "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound:.4f} ms ({by})")
        results[f'stream_probe[{kind}]'] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=lib_ms)
    del X8
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


def build_winell_data():
    """131,072 x 16,384 with 164 standard-normal entries per row at
    uniform columns (duplicates summed), seed 0, as
    baselines/bench_sparse_matvec.py builds it; logit outcome with
    beta[:10] = 1, seed 1."""
    import numpy as np
    import scipy.sparse as sps
    from bayesbridge_tpu_torch.utils.simulate_data import simulate_outcome
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    n, p, k = WINELL_N, WINELL_P, WINELL_PER_ROW
    cols = rng.integers(0, p, size=(n, k))
    X = sps.csr_matrix((np.ones(n * k), cols.ravel(),
                        np.arange(n + 1, dtype=np.int64) * k), shape=(n, p))
    X.sum_duplicates()
    X.data[:] = rng.standard_normal(X.nnz)
    X.eliminate_zeros()
    beta = np.zeros(p)
    beta[:10] = 1.0
    outcome = simulate_outcome(X, beta, 'logit', seed=1)
    log(f"host data build: {time.perf_counter() - t0:.1f} s "
        f"({n} x {p}, nnz {X.nnz})")
    return X, outcome


def device_csr_pair(X, col_map=None):
    """(A, A') as torch sparse CSR on the card (int32 indices, f32
    values) from a scipy CSR, keeping only the columns with col_map >= 0
    (renumbered to col_map) when given; the transpose is sorted on the
    card. For the library yardstick only."""
    import torch
    n = X.shape[0]
    dev = 'cuda'
    indptr = torch.from_numpy(X.indptr.astype('int64')).to(dev)
    cols = torch.from_numpy(X.indices).to(dev).long()
    vals = torch.from_numpy(X.data.astype('float32')).to(dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   indptr.diff())
    m = X.shape[1]
    if col_map is not None:
        jb = torch.from_numpy(col_map).to(dev)[cols]
        keep = jb >= 0
        rows, cols, vals = rows[keep], jb[keep], vals[keep]
        m = int(col_map.max()) + 1
        del jb, keep

    def csr(r, c, v, shape):
        crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(r, minlength=shape[0]), 0)
        return torch.sparse_csr_tensor(crow.int(), c.int(), v, size=shape,
                                       check_invariants=False)

    A = csr(rows, cols, vals, (n, m))
    order = torch.argsort(cols, stable=True)
    At = csr(cols[order], rows[order], vals[order], (m, n))
    return A, At


def packed_kernel_timings(design, X, kind):
    """bitlut, or wincsr and winell, at the design's stored shapes:
    agreement with the plain version (and a rerun's bits), CUDA-event
    timings of kernel, plain version and the cuSPARSE product (checked
    against the design's own product), and the bound; on bitpack also
    every mode of bitlut's source in turns (its ablation) and the f32
    side block's GEMV pair. Returns ({kernel name: result dict}, the
    winell kernel's launch counts on this phase or None)."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch.kernels.bitlut import bitlut, bitlut_plain
    n, p = design._shape_main
    counts = None
    gen = torch.Generator(device='cuda').manual_seed(5)
    results = {}
    if kind == 'bitpack':
        p_bin, gcol_pad, _, _, grow_pad, _, _ = design._bitpack_meta
        col_map = np.full(p, -1, dtype=np.int64)
        col_map[design.bin_cols.cpu().numpy()] = np.arange(p_bin)
        A, At = device_csr_pair(X, col_map)
        cases, ablate = {}, {}
        for tag, bits, g_pad, n_in, n_out, mat, own in (
                ('dot', design.bits_col, gcol_pad, p_bin, n, A,
                 design._bitpack_dot_bin),
                ('tdot', design.bits_row, grow_pad, n, p_bin, At,
                 design._bitpack_tdot_bin)):
            v = torch.zeros(8 * g_pad, device='cuda')
            v[:n_in] = torch.randn(n_in, generator=gen, device='cuda')
            # The function's bytes: the live byte-groups' rows of the
            # live output columns, v's n_in floats, the n_out outputs.
            g_live = -(-n_in // 8)
            ablate[tag] = (bits, v, n_out)
            cases[f'bitlut[{tag}]'] = dict(
                kern=lambda b=bits, v=v, m=n_out, t=tag: bitlut(b, v, m, t),
                plain=lambda b=bits, v=v, m=n_out: bitlut_plain(b, v, m),
                lib=lambda a=mat, v=v[:n_in]: torch.mv(a, v),
                own=lambda f=own, v=v[:n_in]: f(v), rerun=True, inner=20,
                work=(g_live * n_out + 4 * n_in + 4 * n_out,
                      g_live * n_out + 256 * 8 * g_live),
                desc=f"{tuple(bits.shape)} uint8 bitmap, n_out {n_out}")
        del A, At
    else:
        cases, counts = winell_cases(design, X, gen)
    for name, c in cases.items():
        got, ref = c['kern'](), c['plain']()
        torch.cuda.synchronize()
        err = check(f"{name} {c['desc']}", [got], [ref])
        if 'square' in c:
            err = max(err, check(f"{name}[square]", *map(
                lambda t: [t], c['square']())))
        if 'own' in c:
            check(f"{name}: cuSPARSE vs the design's product", [c['lib']()],
                  [c['own']()])
        if c.get('rerun'):
            assert torch.equal(got, c['kern']()), \
                f"{name} is not deterministic"
        del got, ref
        inner = c.get('inner', 1)
        ms, plain_ms = time_ms(c['kern'], inner=inner), time_ms(c['plain'])
        lib_ms = time_ms(c['lib'], inner=inner)
        bound, by = bound_ms(*c['work'])
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"cuSPARSE {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{c['work'][0] / 1e9:.4f} GB at "
            f"{c['work'][0] / 1e9 / (ms / 1e3):.1f} GB/s of 3350"
            + (f"; {inner} calls per timing" if inner > 1 else ''))
        if 'options' in c:
            c['options'](ms, lib_ms, bound)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms)
    del cases
    if kind == 'bitpack':
        bitpack_extras(design, ablate, results)
    torch.cuda.empty_cache()
    return results, counts


def bitpack_extras(design, ablate, results):
    """On the bitpack design: bitlut's byte-table mode (the first
    design's kernel) against its plain version, then every mode of ``csrc/bitlut.cu`` in
    turns (``baselines/bitlut_ablation.py``), added to the bitlut entries
    as ``ablation_ms``; then the f32 side block's GEMV pair
    (``layout.matvec`` / ``rmatvec``, as the design runs them) timed
    beside its bound."""
    import torch
    from bayesbridge_tpu_torch.baselines import bitlut_ablation
    from bayesbridge_tpu_torch.kernels import layout
    from bayesbridge_tpu_torch.kernels.bitlut import (
        bitlut_plain, bitlut_variant, byte_lut_plain)
    for tag, (bits, v, n_out) in ablate.items():
        check(f"bitlut[{tag}] byte-table mode on the design's bitmap",
              [bitlut_variant(bits, v, n_out, 'byte')],
              [bitlut_plain(bits, v, n_out, byte_lut_plain)])
        ms = bitlut_ablation.run(bits, v, n_out, label=f"[{tag}]", log=log)
        entry = results[f'bitlut[{tag}]']
        entry['ablation_ms'] = ms
        log(f"  bitlut[{tag}]: nibble tables {ms['nibble']:.4f} ms against "
            f"the byte table's {ms['byte']:.4f} in turns "
            f"({ms['nibble'] / ms['byte']:.2f} of its time); "
            f"{entry['bound_ms'] / entry['ms']:.0%} of the bound "
            f"{entry['bound_ms']:.4f} ms; cuSPARSE {entry['library_ms']:.4f}")
    X, p = design.X_float, design.n_float
    gen = torch.Generator(device='cuda').manual_seed(7)
    v = torch.randn(p, generator=gen, device='cuda')
    u = torch.randn(X.shape[0], generator=gen, device='cuda')
    bound, by = bound_ms(nbytes(X) + 4 * (p + X.shape[0]), 2 * X.numel())
    for name, fn in (('X_float v', lambda: layout.matvec(X, p, v)),
                     ("X_float' u", lambda: layout.rmatvec(X, p, u))):
        ms = time_ms(fn)
        log(f"  bitpack f32 side block {tuple(X.shape)} (row stride "
            f"{X.stride(0) * 4} B) {name}: {ms:.4f} ms, bound {bound:.4f} "
            f"ms ({by}), {nbytes(X) / 1e9 / (ms / 1e3):.1f} GB/s of 3350")


def winell_cases(design, X, gen):
    """packed_kernel_timings' cases on the winell design: the wincsr
    kernel on the design's windowed-CSR layouts (its path's product), and
    the windowed-ELL kernel on the JAX package's packings, packed on the
    host on demand and copied to the card here (no path runs it). The
    packings' products run once right after the counters are zeroed: the
    winell kernel's launches on this check, which the kernels line
    reports. Returns (cases, those launch counts)."""
    import torch
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.kernels.wincsr import wincsr, wincsr_plain
    from bayesbridge_tpu_torch.kernels.winell import winell, winell_plain
    n, p = design._shape_main
    w_dot, k_dot, w_tdot, k_tdot, _, _ = design._winell_meta
    A, At = device_csr_pair(X)
    vs = {'dot': torch.randn(p, generator=gen, device='cuda'),
          'tdot': torch.randn(n, generator=gen, device='cuda')}
    t0 = time.perf_counter()
    host = design.winell_packing()
    log(f"[winell] windowed-ELL packings on the host: "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{tuple(host['widx_dot'].shape)} (W {w_dot}, K {k_dot}) and "
        f"{tuple(host['widx_tdot'].shape)} (W {w_tdot}, K {k_tdot}), spill "
        f"ELL {host['sd_idx'].shape} and {host['st_idx'].shape}")
    packs = {tag: (torch.from_numpy(host[f'widx_{tag}']).cuda(),
                   torch.from_numpy(host[f'wval_{tag}']).cuda(), W, K, m)
             for tag, W, K, m in (('dot', w_dot, k_dot, n),
                                  ('tdot', w_tdot, k_tdot, p))}
    del host
    reset_launch_counts()
    for tag, (idx, val, W, K, n_out) in packs.items():
        winell(idx, val, vs[tag], n_out, W, K, tag=tag)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[winell] the windowed-ELL packings' products once on the card: "
        f"launch counts {counts}")
    cases = {}
    for tag, m, mat, own in (('dot', design.wc_dot, A,
                              design._winell_dot_main),
                             ('tdot', design.wc_tdot, At,
                              design._winell_tdot_main)):
        v = vs[tag]

        def options(ms, lib_ms, bound, m=m, tag=tag):
            nnz_bytes = 6 * X.nnz + 4 * (m.n_in + m.n_out)
            log(f"  wincsr[{tag}]: {ms / lib_ms:.2f} of cuSPARSE's time, "
                f"{bound / ms:.0%} of the layout's bound {bound:.4f} ms; "
                f"the nonzeros' bound (6 B each, v and out) "
                f"{nnz_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        cases[f'wincsr[{tag}]'] = dict(
            kern=lambda m=m, v=v, t=tag: wincsr(m, v, tag=t),
            plain=lambda m=m, v=v: wincsr_plain(m, v),
            square=lambda m=m, v=v, t=tag: (wincsr(m, v, True, t),
                                            wincsr_plain(m, v, True)),
            lib=lambda a=mat, v=v: torch.mv(a, v),
            own=lambda f=own, v=v: f(v), rerun=True, inner=20,
            options=options,
            work=(m.nbytes() + 4 * (m.n_in + m.n_out), 2 * X.nnz),
            desc=f"{m.idx.shape[0]} entries ({m.nbytes() / 1e9:.4f} GB), "
                 f"{m.n_win} window(s) of {m.window}, {m.lanes} lanes per "
                 f"row, n_out {m.n_out}")
    for tag, (idx, val, W, K, n_out) in packs.items():
        v = vs[tag]
        cases[f'winell[{tag}]'] = dict(
            kern=lambda i=idx, x=val, v=v, m=n_out, W=W, K=K, t=tag:
                winell(i, x, v, m, W, K, tag=t),
            plain=lambda i=idx, x=val, v=v, m=n_out, W=W, K=K:
                winell_plain(i, x, v, m, W, K),
            square=lambda i=idx, x=val, v=v, m=n_out, W=W, K=K, t=tag:
                (winell(i, x, v, m, W, K, True, t),
                 winell_plain(i, x, v, m, W, K, True)),
            lib=lambda a=A if tag == 'dot' else At, v=v: torch.mv(a, v),
            rerun=True, inner=20,
            work=(nbytes(idx, val, v) + 4 * n_out, 2 * idx.numel()),
            desc=f"{tuple(idx.shape)} int16 + f32 packing, W {W} K {K}, "
                 f"n_out {n_out}")
    return cases, counts


def run_chain(model, label, step_bytes, n_first=30, n_more=20,
              sampler='cg', options=None):
    """``gibbs(n_first)`` with the launch counts read right after it, then
    ``gibbs_resume(n_more)`` timed, then the exact-resume check and a
    profiler window; `sampler` None takes the package's default (Cholesky
    for a dense design). Returns (counts, n_cg of the first run (zeros
    off CG), its mcmc info, {'ips', 'mean_cg', 'busy', 'signal',
    'chain'}): steady-state iter/s, mean CG iterations of the timed
    iterations, the device's busy share, the mean of coef[1:11] over the
    first run, and (bridge, mcmc info after the timed iterations) to
    continue the chain from."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import BayesBridge, RegressionCoefPrior
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))
    n_pred = model.design.shape[1]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    kw = dict(coef_sampler_type=sampler, options=options, seed=0,
              params_to_save='all')
    samples, info = bridge.gibbs(n_iter=n_first, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    wall = time.perf_counter() - t0
    n_cg = info['_reg_coef_sampling_info'].get('n_cg_iter',
                                               np.zeros(n_first))
    log(f"[{label}] gibbs({n_first}) incl. MAP search: {wall:.1f} s; "
        f"sampler {info['coef_sampler_type']}, dtype "
        f"{samples['coef'].dtype}; MAP {info['_init_optim_info']}; "
        f"n_cg_iter {n_cg.astype(int).tolist()}")
    log(f"[{label}] launch counts of this path: {counts}")
    assert np.all(np.isfinite(samples['logp'])), samples['logp']
    assert samples['coef'].shape == (n_pred, n_first)
    assert np.all(np.isfinite(samples['coef']))
    assert n_cg.max() < 500, n_cg.max()
    signal = float(samples['coef'][1:11].mean())
    log(f"[{label}] logp: first {samples['logp'][0]:.6g}, last "
        f"{samples['logp'][-1]:.6g}; intercept mean "
        f"{samples['coef'][0].mean():.4f}; mean coef[1:11] "
        f"{signal:.4f}, |coef[11:]| mean "
        f"{np.abs(samples['coef'][11:]).mean():.2e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_more, i_more = bridge.gibbs_resume(info, n_more)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cg_more = i_more['_reg_coef_sampling_info'].get('n_cg_iter',
                                                    np.zeros(n_more))
    ips = n_more / secs
    gb_iter = float(np.mean([step_bytes(k) for k in cg_more])) / 1e9
    log(f"[{label}] steady state, {n_more} iterations via gibbs_resume: "
        f"{ips:.4f} iter/s, mean CG iterations {cg_more.mean():.2f}, design "
        f"bytes read per iteration {gb_iter:.3f} GB, achieved "
        f"{gb_iter * ips:.1f} GB/s of 3350; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB over the "
        f"{n_first + n_more} iterations")
    assert np.all(np.isfinite(s_more['logp']))

    n_a = n_first * 2 // 3
    s_a, i_a = bridge.gibbs(n_iter=n_a, **kw)
    s_b, _ = bridge.gibbs_resume(i_a, n_first - n_a, merge=True,
                                 prev_samples=s_a)
    for key in samples:
        if not np.array_equal(s_b[key], samples[key]):
            raise AssertionError(f"[{label}] resume != uninterrupted for "
                                 f"{key}")
    log(f"[{label}] resume check: gibbs({n_a}) + gibbs_resume("
        f"{n_first - n_a}, merge=True) == gibbs({n_first}) exactly")
    busy, dev_ms = profile_window(bridge, info, label)
    stats = dict(ips=ips, mean_cg=float(cg_more.mean()), busy=busy,
                 dev_ms=dev_ms, signal=signal, chain=(bridge, i_more))
    return counts, n_cg, info, stats


def profile_window(bridge, info, label, n_iter=3, resume=None):
    """torch.profiler over `n_iter` more iterations (``resume(n_iter)``,
    by default ``bridge.gibbs_resume(info, n_iter)``): (the device's busy
    share of the window's wall clock, profiler overhead included; device
    ms per iteration), both None where the profiler saw no device events,
    logged with the kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if resume is None:
            bridge.gibbs_resume(info, n_iter)
        else:
            resume(n_iter)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0.0)) / 1e3

    busy = sum(dev_ms(e) for e in kernels)
    if not kernels:
        log(f"[{label}] profiler: no device events (busy share not "
            f"measured)")
        return None, None
    log(f"[{label}] profiler over {n_iter} iterations: device busy "
        f"{busy:.1f} ms of {wall:.1f} ms wall ({100 * busy / wall:.1f}%, "
        f"idle {100 - 100 * busy / wall:.1f}%); device "
        f"{busy / n_iter:.2f} ms per iteration")
    for e in sorted(kernels, key=dev_ms, reverse=True)[:8]:
        log(f"    {dev_ms(e):9.2f} ms  {e.count:6d} x  {e.key[:90]}")
    return busy / wall, busy / n_iter


def map_search(model):
    """The chain's MAP search once more (``initialize_chain`` from
    ``gibbs``'s default start, seed 0): (MAP coef, optimizer info)."""
    from bayesbridge_tpu_torch import BayesBridge, RegressionCoefPrior
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))
    bridge.rg.set_seed(0)
    out = bridge.initialize_chain({'global_scale': 0.1}, 0.5)
    return out[0], out[5]


def composed_objective(model, coef):
    """(loglik, gradient) at coef from `dot`, the loglik rows and `Tdot`,
    the packed backends' MAP objective, on any design."""
    import torch
    design = model.design
    lin = design.dot(torch.as_tensor(coef, dtype=torch.float32,
                                     device='cuda'))
    return (float(model.loglik_from_lin_pred(lin)), design.Tdot(
        model.n_success - model.n_trial * torch.sigmoid(lin)))


def map_witness(model, label, ref=None):
    """Why a MAP search stops where it does: the search with the design's
    own objective and, on the hybrid design (`ref` None), once more with
    the composed objective on the same design, and the two objectives at
    the first MAP; on a packed design, its objective at the hybrid's MAP
    against the hybrid's composed one (`ref`, the hybrid's record).
    Returns the record."""
    import numpy as np

    def gap(a, b):  # max|a - b| / max|b|
        return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                     / np.abs(np.asarray(b)).max())

    coef, info = map_search(model)
    lp, grad = composed_objective(model, coef)
    grad = grad.cpu().numpy()
    log(f"[{label}] MAP witness: own objective {info}, composed loglik at "
        f"its MAP {lp:.9g}")
    assert np.isfinite(lp)
    if ref is not None:
        lp_r, grad_r = composed_objective(model, ref['coef'])
        log(f"[{label}] MAP witness: at the hybrid's MAP, this design's "
            f"minus the hybrid's composed loglik {lp_r - ref['lp']:.4g}, "
            f"gradient gap {gap(grad_r.cpu().numpy(), ref['grad']):.3g}; "
            f"MAP gap to the hybrid's {gap(coef, ref['coef']):.3g} "
            f"(gaps: max|a - b| / max|b|)")
        assert np.isfinite(lp_r)
        return None
    import torch
    fused_lp, fused_grad = model.compute_loglik_and_gradient(
        torch.as_tensor(coef, dtype=torch.float32, device='cuda'))
    coef_c, info_c = map_search(with_policy(model, '0'))
    lp_c = composed_objective(model, coef_c)[0]
    log(f"[{label}] MAP witness: composed objective on the same design "
        f"{info_c}, composed loglik at its MAP {lp_c:.9g}; at the first "
        f"MAP fused minus composed loglik {float(fused_lp) - lp:.4g}, "
        f"gradient gap {gap(fused_grad.cpu().numpy(), grad):.3g}; MAP gap "
        f"{gap(coef_c, coef):.3g} (gaps: max|a - b| / max|b|)")
    assert np.isfinite(lp_c) and np.isfinite(float(fused_lp))
    return {'coef': coef, 'lp': lp, 'grad': grad}


def with_policy(model, fused):
    """The model over the same stored design arrays under another fused
    policy (no second densify or transfer)."""
    import copy
    other = copy.copy(model)
    other.design = model.design.with_policy(fused)
    return other


def run_hybrid(X, outcome):
    """Phase 5: the fused slice, the composed slice on the same blocks,
    'auto' where it resolves to neither, the MAP witness and the link
    objective both ways. Returns ({slice: launch counts}, the MAP
    witness, the stored design for the linear slice)."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import RegressionModel
    from bayesbridge_tpu_torch.design import fusedne
    t0 = time.perf_counter()
    model = RegressionModel(outcome, X, family='logit', dtype=np.float32,
                            fused='1', device='cuda')
    torch.cuda.synchronize()
    design = model.design
    gb = design.storage_bytes() / 1e9
    log(f"[hybrid] design build + transfer: {time.perf_counter() - t0:.1f} "
        f"s; X_exact {design.X_exact.dtype} {tuple(design.X_exact.shape)}, "
        f"X_float {design.X_float.dtype} {tuple(design.X_float.shape)}, "
        f"{gb:.3f} GB on the device")
    assert design.backend == 'hybrid'
    assert design.X_exact.dtype == torch.int8
    assert 6.0 < gb < 7.0, gb
    # The fused slice, the composed one on the same stored blocks, and
    # 'auto' where it resolves to neither. Where 'auto' composes the CG
    # operator and the pre-solve, the composed slice runs 'auto' (the
    # default path): its steady state is the composed one whichever way
    # 'auto' takes the MAP search's objective.
    auto = {kind: fusedne.dispatch_mode(kind, 'auto') is not None
            for kind in fusedne.KINDS}
    steady = auto['quad'] or auto['presolve']
    policies = {'hybrid_fused': '1',
                'hybrid_composed': '0' if steady else 'auto'}
    own = steady and not all(auto.values())
    log(f"[hybrid] 'auto' resolves to {auto} (True = fused)"
        + ("" if own else
           f": the {'fused' if all(auto.values()) else 'composed'} slice"))
    if own:
        policies['hybrid_auto'] = 'auto'
    counts, stats, witness = {}, {}, None
    n_first = 20
    for label, policy in policies.items():
        m = with_policy(model, policy)
        fused = {kind: fusedne.dispatch_mode(kind, policy) is not None
                 for kind in fusedne.KINDS}
        # Reads of the stored blocks per iteration with k CG iterations:
        # per operator application 1 (fused: the one-read kernel) or 2
        # (the row and column passes), 1 pre-solve read; a fused pre-solve
        # adds the initial residual's application, a composed one the
        # warm start's row pass; a fused CG operator adds the linear
        # predictor's row pass.
        per_app = 1 if fused['quad'] else 2
        apps = int(fused['presolve'])
        extra = 1 + int(not fused['presolve']) + int(fused['quad'])
        counts[label], n_cg, info, stats[label] = run_chain(
            m, label, lambda k, a=apps, r=per_app, e=extra:
                ((k + a) * r + e) * gb * 1e9, n_first=n_first, n_more=10)
        c = counts[label]
        n_cg_sum = int(np.sum(n_cg))
        assert c['ne_sweep[ne]'] == 0, c  # no two-pass CG operator
        if fused['quad']:
            assert c['ne_oneread'] >= n_cg_sum + n_first * apps, c
            assert c['ne_sweep[rows]'] >= n_first, c
        else:
            assert c['ne_oneread'] == 0, c
            assert c['ne_sweep[rows]'] >= n_cg_sum, c
            assert c['ne_sweep[cols]'] >= n_cg_sum, c
        if fused['presolve']:
            assert c['tdots_sweep'] == n_first, c
            assert c['tdots_sweep[u4]'] == 0, c
        else:
            assert c['tdots_sweep[u4]'] == n_first, c
            assert c['tdots_sweep'] == 0, c
        # The MAP search: one objective evaluation per link sweep, on the
        # one-read kernel (never the two-pass one), or composed.
        n_map = info['_init_optim_info']['n_design_matvec'] // 2
        assert c['ne_sweep[logit]'] == 0, c
        if fused['link']:
            assert c['ne_oneread[logit]'] == n_map, (n_map, c)
        else:
            assert c['ne_oneread[logit]'] == 0, c
            assert c['ne_sweep[cols]'] >= n_map + (
                0 if fused['quad'] else n_cg_sum), c
        if label == 'hybrid_fused':
            witness = map_witness(m, label)
        del m
    for label, st in stats.items():
        busy = 'not measured' if st['busy'] is None \
            else f"{100 * st['busy']:.1f}%, {st['dev_ms']:.2f} ms per " \
                 f"iteration"
        log(f"[{label}] steady state {st['ips']:.4f} iter/s, mean CG "
            f"iterations {st['mean_cg']:.2f}, device busy {busy}, signal "
            f"mean coef[1:11] {st['signal']:.4f}")
    ab_segments({label: st.pop('chain') for label, st in stats.items()})

    beta = torch.as_tensor(witness['coef'], dtype=torch.float32,
                           device='cuda')
    composed = with_policy(model, '0')
    fns = {name: (lambda m=m: m.compute_loglik_and_gradient(beta))
           for name, m in (('fused', model), ('composed', composed))}
    ts = [time_ms(fns[k]) for k in ('composed', 'fused', 'fused',
                                    'composed')]
    log(f"[hybrid] MAP objective (loglik + gradient) at the MAP in turns "
        f"(composed, fused, fused, composed): {[round(t, 3) for t in ts]} "
        f"ms; fused (one-read link sweep) {(ts[1] + ts[2]) / 2:.3f} ms, "
        f"composed (row pass, loglik rows, column pass) "
        f"{(ts[0] + ts[3]) / 2:.3f} ms")
    del model, composed
    torch.cuda.empty_cache()
    return counts, witness, design, stats['hybrid_composed']['ips']


def ab_segments(chains, n_iter=10, rounds=4):
    """Steady-state A/B of the hybrid policies in one call: `rounds`
    rounds of `n_iter` iterations per chain through ``gibbs_resume``, each
    chain continuing from its last state, the order reversed every other
    round (ABBA), so drift of the host and of the chains' CG counts falls
    on both alike. Logs every segment and each policy's median."""
    import numpy as np
    import torch
    state = {label: info for label, (_, info) in chains.items()}
    ips = {label: [] for label in chains}
    cgs = {label: [] for label in chains}
    for r in range(rounds):
        order = list(chains) if r % 2 == 0 else list(chains)[::-1]
        for label in order:
            bridge = chains[label][0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state[label] = bridge.gibbs_resume(state[label], n_iter)
            torch.cuda.synchronize()
            ips[label].append(n_iter / (time.perf_counter() - t0))
            cgs[label].append(float(np.mean(
                state[label]['_reg_coef_sampling_info']['n_cg_iter'])))
    for label in chains:
        log(f"[{label}] A/B segments of {n_iter} iterations (ABBA order): "
            f"iter/s {[round(x, 4) for x in ips[label]]}, median "
            f"{statistics.median(ips[label]):.4f}; mean CG iterations "
            f"{[round(x, 2) for x in cgs[label]]}")
    return {label: statistics.median(v) for label, v in ips.items()}


def run_packed(X, outcome, backend, map_ref=None, n_first=15, n_more=10):
    """Phases 7 and 8: build, kernel timings at the design's shapes, the
    chain on the composed path; with `map_ref` (the hybrid's MAP witness
    on the same X), the MAP witness. Returns (kernel results, the chain's
    launch counts, the winell kernel's launch counts on the timing phase
    or None)."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import RegressionModel
    t0 = time.perf_counter()
    model = RegressionModel(outcome, X, family='logit', dtype=np.float32,
                            backend='bitpack' if backend == 'bitpack'
                            else 'auto', device='cuda')
    torch.cuda.synchronize()
    design = model.design
    gb = design.storage_bytes() / 1e9
    assert design.backend == backend, design.backend
    assert design.fused_ne_mode() is None
    if backend == 'bitpack':
        p_bin = design._bitpack_meta[0]
        shapes = (f"bits_col {tuple(design.bits_col.shape)}, bits_row "
                  f"{tuple(design.bits_row.shape)}, X_float "
                  f"{tuple(design.X_float.shape)} ({p_bin} binary columns)")
        assert tuple(design.bits_col.shape) == (5632, 106496)
        assert tuple(design.bits_row.shape) == (12512, 49152)
        assert 3.0 < gb < 3.4, gb
        dot_b = nbytes(design.bits_col, design.X_float)
        tdot_b = nbytes(design.bits_row, design.X_float)
    else:
        meta = design._winell_meta
        wc = design.wc_dot
        shapes = (f"windowed-CSR layouts on the card: X v "
                  f"{wc.nbytes() / 1e9:.4f} GB ({wc.n_win} window(s) of "
                  f"{wc.window}), X' u "
                  f"{design.wc_tdot.nbytes() / 1e9:.4f} GB "
                  f"({design.wc_tdot.n_win} windows of "
                  f"{design.wc_tdot.window}); the windowed-ELL plan (W, K) "
                  f"{meta[:2]} and {meta[2:4]}, spill {meta[4:]}")
        assert meta[4] or meta[5], "no spill at the winell design"
        assert 0.2 < gb < 0.35, gb
        dot_b = design.wc_dot.nbytes()
        tdot_b = design.wc_tdot.nbytes()
    steps = ', '.join(f"{k} {v:.1f} s"
                      for k, v in design.build_seconds.items())
    log(f"[{backend}] design build + transfer: "
        f"{time.perf_counter() - t0:.1f} s (host {steps}); {shapes}; "
        f"{gb:.3f} GB on the device")
    results, pack_counts = packed_kernel_timings(design, X, backend)
    del design
    # Per iteration: dot + Tdot per CG operator application (k + 1), two
    # pre-solve Tdots and the Fisher diagonal's two moments.
    counts, n_cg, info, _ = run_chain(
        model, backend, lambda k: (k + 1) * (dot_b + tdot_b) + 4 * tdot_b,
        n_first=n_first, n_more=n_more)
    kern = 'bitlut' if backend == 'bitpack' else 'wincsr'
    n_map = info['_init_optim_info']['n_design_matvec'] // 2
    need = int(np.sum(n_cg + 1))
    assert counts[f'{kern}[dot]'] >= need + n_map, counts
    assert counts[f'{kern}[tdot]'] >= need + 4 * n_first + n_map, counts
    assert counts['ne_sweep[ne]'] == counts['tdots_sweep'] == 0, counts
    assert counts['winell[dot]'] == counts['winell[tdot]'] == 0, counts
    if map_ref is not None:
        map_witness(model, backend, map_ref)
    del model
    torch.cuda.empty_cache()
    return results, counts, pack_counts


def run_linear_hybrid(design, X):
    """Phase 6 (a): the linear model over the hybrid slices' stored
    blocks (no second densify), y = X beta + N(0, 1) noise with beta as
    bench.py draws it: under 'auto' (the MAP search on
    ``ne_oneread[linear]``, the CG operator and the pre-solve composed)
    gibbs(20), 10 resumed iterations, the resume check and a profiler
    window with the Jacobi preconditioner, then gibbs(10) with the prior
    preconditioner; then the one-read linear objective in turns against
    the two-pass link sweep and against the composed objective at the
    design's blocks. Returns the launch counts of the first run."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import BayesBridge, RegressionCoefPrior
    from bayesbridge_tpu_torch.kernels.ne_oneread import ne_oneread_link
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        colpass, ne_rows, ne_sweep)
    from bayesbridge_tpu_torch.models import LinearModel
    beta = np.zeros(N_PRED)
    beta[:10] = 1.0
    y = LinearModel.simulate_outcome(X, beta, 1.0, seed=2)
    model = LinearModel(y, design.with_policy('auto'))
    gb = design.storage_bytes() / 1e9
    label = 'linear_hybrid'
    counts, n_cg, info, st = run_chain(
        model, label, lambda k: (2 * k + 2) * gb * 1e9, n_first=20,
        n_more=10)
    n_map = info['_init_optim_info']['n_design_matvec'] // 2
    n_cg_sum = int(np.sum(n_cg))
    assert n_map > 0 and counts['ne_oneread[linear]'] == n_map, (n_map,
                                                                 counts)
    assert counts['ne_sweep[linear]'] == 0 and counts['ne_oneread'] == 0, \
        counts
    assert counts['ne_sweep[rows]'] >= n_cg_sum, counts
    assert counts['tdots_sweep[u4]'] == 20, counts
    log(f"[{label}] steady state {st['ips']:.4f} iter/s, mean CG "
        f"iterations {st['mean_cg']:.2f} ('diag'), signal mean coef[1:11] "
        f"{st['signal']:.4f}, device busy "
        + ('not measured' if st['busy'] is None else
           f"{100 * st['busy']:.1f}%, {st['dev_ms']:.2f} ms per iteration"))
    assert abs(st['signal'] - 1.0) < 0.2, st['signal']

    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))
    t0 = time.perf_counter()
    samples, info_p = bridge.gibbs(10, seed=0, coef_sampler_type='cg',
                                   options={'cg_preconditioner': 'prior'},
                                   params_to_save=('coef', 'logp'))
    torch.cuda.synchronize()
    cg_p = info_p['_reg_coef_sampling_info']['n_cg_iter']
    assert np.all(np.isfinite(samples['logp']))
    log(f"[{label}] gibbs(10) with the prior preconditioner: "
        f"{time.perf_counter() - t0:.1f} s, n_cg_iter "
        f"{cg_p.astype(int).tolist()}, mean {cg_p.mean():.2f} against "
        f"{np.mean(n_cg[:10]):.2f} over the first 10 with 'diag'")

    # The MAP objective at the design's blocks: the one-read linear
    # sweep with its logp in turns against the two-pass sweep and against
    # the composed objective (row pass, loglik rows, column pass).
    gen = torch.Generator(device='cuda').manual_seed(6)
    (Xe, pe), (Xf, pf) = design._stored()
    vs = [torch.randn(p, generator=gen, device='cuda') * 0.02
          for p in (pe, pf)]
    blocks = [(Xe, vs[0]), (Xf, vs[1])]
    c = torch.zeros((), device='cuda')
    a = model.y
    b = torch.full_like(a, float(info['_markov_chain_state']['obs_prec']))

    def oneread():
        return ne_oneread_link(blocks, c, a, b, 'linear', True)

    def twopass():
        return ne_sweep(blocks, c, a, b, 'linear', True, route='twopass')

    def composed():
        r = a - ne_rows(blocks, c)
        return colpass([Xe, Xf], [pe, pf], b * r), \
            torch.sum(-0.5 * b * r * r)
    for other, fn in (('two-pass', twopass), ('composed', composed)):
        ts = [time_ms(f) for f in (fn, oneread, oneread, fn)]
        log(f"[{label}] {other} linear objective vs ne_oneread[linear] in "
            f"turns ({other}, one-read, one-read, {other}): "
            f"{[round(t, 3) for t in ts]} ms; one-read "
            f"{(ts[1] + ts[2]) / 2:.3f} against {(ts[0] + ts[3]) / 2:.3f} ms")
    del model, bridge
    return counts


MC_CHAINS = 4
MC_KS = (1, 2, 4, 8)  # chains per batched kernel call in the checks
# The coefficients the multichain phase's split R-hat and pooled ESS read:
# 1..200, the ten signal coefficients and 190 null ones.
MC_SUBSET = slice(1, 201)


def batched_kernel_checks(design):
    """The multichain phase, part 1: the chain-batched kernels at the
    hybrid phase's stored flagship blocks for k = 1, 2, 4, 8 chains, each
    against its plain version (RTOL of max|plain|) and against k
    single-vector launches (torch.equal), timed (CUDA events, median of
    10) beside k x the single launch and the bound (X's bytes once plus
    the k chains' vectors, or 2 n p k R operations at the float32 peak,
    the larger). Returns the kernels line's entries at k = 4, the
    chains of the phase's path."""
    import torch
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        colpass, colpass_k, colpass_k_plain, ne_rows, ne_rows_k,
        ne_rows_k_plain)
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_k, tdots_sweep_k_plain)
    gen = torch.Generator(device='cuda').manual_seed(7)
    Xs = [design.X_exact, design.X_float]
    ps = [design.n_exact, design.n_float]
    n, p = Xs[0].shape[0], sum(ps)
    x_bytes = nbytes(*Xs)

    def flat(blks):
        return [o for blk in blks for o in blk]

    results, single_ms = {}, {}
    log(f"[multichain] batched kernels at the stored flagship blocks "
        f"({n} x {ps[0]} {Xs[0].dtype} + {n} x {ps[1]} {Xs[1].dtype}, "
        f"{x_bytes / 1e9:.3f} GB)")
    for k in MC_KS:
        Vs = [torch.randn((k, q), generator=gen, device='cuda')
              for q in ps]
        c = torch.randn(k, generator=gen, device='cuda') * 0.1
        Us = [torch.randn((k, n), generator=gen, device='cuda')
              for _ in range(4)]
        blocks = list(zip(Xs, Vs))
        # name: (kernel, plain, chain i's single launches, vector floats
        # in and out, operations)
        cases = {
            'ne_rows_k': (
                lambda: [ne_rows_k(blocks, c)],
                lambda: [ne_rows_k_plain(blocks, c)],
                lambda i: [ne_rows([(X, V[i]) for X, V in blocks], c[i])],
                k * (p + n), 2 * n * p * k),
            'colpass_k': (
                lambda: colpass_k(Xs, ps, Us[0]),
                lambda: colpass_k_plain(Xs, ps, Us[0]),
                lambda i: colpass(Xs, ps, Us[0][i]),
                k * (n + p), 2 * n * p * k),
            'tdots_sweep_k[u4]': (
                lambda: flat(tdots_sweep_k(Xs, ps, *Us)),
                lambda: flat(tdots_sweep_k_plain(Xs, ps, *Us)),
                lambda i: flat(tdots_sweep(Xs, ps, *(u[i] for u in Us))),
                k * (4 * n + 5 * p), 2 * n * p * k * 5),
            'tdots_sweep_k': (
                lambda: flat(tdots_sweep_k(Xs, ps, *Us[:3])),
                lambda: flat(tdots_sweep_k_plain(Xs, ps, *Us[:3])),
                lambda i: flat(tdots_sweep(Xs, ps,
                                           *(u[i] for u in Us[:3]))),
                k * (3 * n + 4 * p), 2 * n * p * k * 4),
        }
        for name, (kern, plain, single, floats, ops) in cases.items():
            got = kern()
            err = check(f"[multichain] {name} k={k}", got, plain())
            for i in range(k):
                if not all(torch.equal(g[i], s)
                           for g, s in zip(got, single(i))):
                    raise AssertionError(
                        f"{name}: chain {i} of k={k} differs from its "
                        f"single-vector launch")
            del got
            ms = time_ms(kern)
            if k == 1:
                single_ms[name] = ms
            bound, by = bound_ms(x_bytes + 4 * floats, ops)
            log(f"  {name} k={k}: {ms:.3f} ms; k x single "
                f"{k * single_ms[name]:.3f} ms; bound {bound:.3f} ms "
                f"({by}); {100 * bound / ms:.0f}% of the bound; the "
                f"k single launches' bits")
            if k == MC_CHAINS:
                results[name] = dict(
                    max_abs_err=err, ms=ms,
                    plain_ms=time_ms(lambda: plain(), reps=3),
                    bound_ms=bound, bound_by=by, library_ms=None)
        del Vs, Us, blocks
    torch.cuda.empty_cache()
    return results


def overdispersed_inits(model, n_chains):
    """Per-chain starts: the intercept at its MLE, the other coefficients
    N(0, (0.05 (c + 1))^2) and the global scale 0.05 * 2^c for chain c,
    local scales one (no MAP search)."""
    import numpy as np
    p = model.n_pred
    inits = []
    for c in range(n_chains):
        coef = np.random.default_rng(100 + c).standard_normal(p) \
            * 0.05 * (c + 1)
        coef[0] = model.calc_intercept_mle()
        inits.append({'coef': coef, 'global_scale': 0.05 * 2 ** c,
                      'local_scale': np.ones(p - 1)})
    return inits


def run_multichain(design, outcome, single_ips):
    """The multichain phase on the hybrid phase's stored flagship blocks
    (no second densify): the batched kernels' checks and timings, then
    gibbs_chains with MC_CHAINS overdispersed chains under 'auto' (the
    launch counts read right after the first call, gibbs_chains_resume
    timed, the exact-resume check, a profiler window, split R-hat and
    pooled ESS), then chain c against the chain run alone, then a short
    fused ('1') run. Returns (kernel results, {path: launch counts})."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, gibbs_chains)
    from bayesbridge_tpu_torch import step as step_mod
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.models import LogisticModel
    from bayesbridge_tpu_torch.multichain import (
        _stack_chain_inits, gibbs_chains_resume)
    from bayesbridge_tpu_torch.utils.mcmc_summarizer import (
        compute_multichain_ess, compute_split_rhat)
    results = batched_kernel_checks(design)
    model = LogisticModel(*outcome, design.with_policy('auto'))
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))
    inits = overdispersed_inits(model, MC_CHAINS)
    label, k = 'multichain', MC_CHAINS
    n_first, n_more = 12, 8
    kw = dict(seed=0, init=inits, coef_sampler_type='cg',
              params_to_save=('coef', 'logp'))
    reset_launch_counts()
    t0 = time.perf_counter()
    samples, info = gibbs_chains(bridge, n_first, k, **kw)
    torch.cuda.synchronize()
    counts = {label: launch_counts()}
    n_cg = info['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}] gibbs_chains({n_first}, {k} chains): "
        f"{time.perf_counter() - t0:.1f} s; n_cg_iter per chain "
        f"{n_cg.astype(int).tolist()}")
    log(f"[{label}] launch counts of this path: {counts[label]}")
    c = counts[label]
    assert samples['coef'].shape == (k, model.n_pred, n_first)
    assert np.all(np.isfinite(samples['coef']))
    assert np.all(np.isfinite(samples['logp'])), samples['logp']
    # One row and one column pass per CG iteration in which a chain runs,
    # for all its running chains (up to 4 per launch beside an int8
    # block; a lone running chain takes the single-vector launch); one
    # batched row pass per draw for the warm start, one per chain for
    # the inits' linear predictors; one five-reduction pre-solve per
    # draw.
    apps = int(n_cg.max(0).sum())
    assert c['ne_rows_k'] > 0 and c['colpass_k'] > 0, c
    assert c['colpass_k'] + c['ne_sweep[cols]'] == apps, (apps, c)
    assert c['ne_rows_k'] + c['ne_sweep[rows]'] == apps + n_first + k, \
        (apps, c)
    assert c['tdots_sweep_k[u4]'] == n_first, c
    assert c['tdots_sweep[u4]'] == c['ne_oneread'] == 0, c

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_more, i_more = gibbs_chains_resume(bridge, info, n_more)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ips = n_more / secs
    cg_more = i_more['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}] steady state, {n_more} iterations via "
        f"gibbs_chains_resume: {ips:.4f} iter/s of {k} chains = "
        f"{k * ips:.4f} chain-iterations/s against the single-chain "
        f"'auto' slice's {single_ips:.4f} iter/s in this run "
        f"({k * ips / single_ips:.2f}x); mean CG iterations per chain "
        f"{np.round(cg_more.mean(1), 2).tolist()}")

    n_a = n_first * 2 // 3
    s_a, i_a = gibbs_chains(bridge, n_a, k, **kw)
    s_b, _ = gibbs_chains_resume(bridge, i_a, n_first - n_a, merge=True,
                                 prev_samples=s_a)
    for key in samples:
        if not np.array_equal(s_b[key], samples[key]):
            raise AssertionError(f"[{label}] resume != uninterrupted for "
                                 f"{key}")
    log(f"[{label}] resume check: gibbs_chains({n_a}) + "
        f"gibbs_chains_resume({n_first - n_a}, merge=True) == "
        f"gibbs_chains({n_first}) exactly")
    busy, dev_ms = profile_window(
        bridge, i_more, label,
        resume=lambda n: gibbs_chains_resume(bridge, i_more, n))

    draws = np.concatenate((samples['coef'], s_more['coef']), -1)[
        :, MC_SUBSET]
    rhat = compute_split_rhat(draws)
    ess = compute_multichain_ess(draws)
    n_draws = draws.shape[-1]
    log(f"[{label}] coef[1:201] over {n_draws} iterations of {k} chains "
        f"(overdispersed starts, no burn-in): split R-hat median "
        f"{np.median(rhat):.3f}, max {rhat.max():.3f}; pooled ESS median "
        f"{np.median(ess):.2f}, min {ess.min():.2f}; ESS/s "
        f"{np.median(ess) * ips / n_draws:.4f} (median pooled ESS per "
        f"iteration x the steady iter/s)")
    assert np.all(np.isfinite(rhat)) and np.all(ess > 0)
    mc = dict(ips=ips, chain_ips=k * ips, single_ips=single_ips,
              mean_cg=float(cg_more.mean()), busy=busy, dev_ms=dev_ms,
              rhat_median=float(np.median(rhat)),
              ess_median=float(np.median(ess)))

    # Chain c of a 2-chain run against the chain run alone from its
    # generator.
    n_x = 3
    s2, i2 = gibbs_chains(bridge, n_x, 2, seed=3, init=inits[:2],
                          coef_sampler_type='cg', params_to_save=('coef',))
    cfg = bridge._step_config(bridge._resolve_options('cg', None))
    bridge.rg.set_seed(3)
    starts = _stack_chain_inits(bridge, inits[:2], 2)
    gens = bridge.rg.spawn(2)
    for i in range(2):
        coef, obs_prec, lscale, gscale = (s[i] for s in starts)
        carry = step_mod.init_carry('cuda', coef, obs_prec, gscale, lscale)
        _, out = step_mod.run_chain(cfg, model, gens[i], carry, 0, n_x, 1,
                                    0, save_keys=('coef',))
        alone = np.stack([v.cpu().numpy() for v in out['coef']], -1)
        diff = float(np.abs(alone - s2['coef'][i]).max())
        np.testing.assert_array_equal(
            i2['_reg_coef_sampling_info']['n_cg_iter'][i], out['n_cg_iter'])
        np.testing.assert_allclose(s2['coef'][i], alone, rtol=1e-6,
                                   atol=1e-7)
        log(f"[{label}] chain {i} of 2 against the chain alone: n_cg_iter "
            f"{out['n_cg_iter']} equal, max |coef diff| {diff:.3g}")

    # The fused policy: the one-read CG operator once per chain per
    # application, the four-reduction pre-solve batched.
    fused = BayesBridge(LogisticModel(*outcome, design.with_policy('1')),
                        RegressionCoefPrior(bridge_exponent=0.5))
    reset_launch_counts()
    s_f, i_f = gibbs_chains(fused, n_x, 2, seed=4, init=inits[:2],
                            coef_sampler_type='cg', params_to_save=('coef',))
    torch.cuda.synchronize()
    counts['multichain_fused'] = cf = launch_counts()
    n_cg_f = i_f['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}_fused] gibbs_chains({n_x}, 2 chains, fused='1'): "
        f"n_cg_iter {n_cg_f.astype(int).tolist()}; launch counts {cf}")
    assert np.all(np.isfinite(s_f['coef']))
    # Each chain: its CG iterations plus the initial residual's
    # application per draw.
    assert cf['ne_oneread'] == int(n_cg_f.sum()) + 2 * n_x, cf
    assert cf['tdots_sweep_k'] == n_x and cf['ne_rows_k'] == n_x, cf
    del model, bridge, fused
    torch.cuda.empty_cache()
    return results, counts, mc


COX_CHAINS = 4
# The least time of one Cox gradient (or Hessian matvec) and of one logit
# gradient at the flagship blocks: X read twice (the row pass, then the
# column pass: the risk-set sums need all of X beta before X' u starts)
# and once (ne_oneread's link mode), 6.504 GB over 3,350 GB/s a read.
READ_MS = 6.504e9 / HBM_BYTES_PER_S * 1e3  # at N_OBS x N_PRED


def cox_kernel_checks(design):
    """The Cox phase's kernels at its own stored blocks (the factory's
    sorted hybrid): the row pass and the column pass for one chain, and
    their chain-batched forms for COX_CHAINS chains, each against its
    plain version (RTOL of max|plain|), the batched ones bit for bit
    against single launches, timed (CUDA events, median of 10) beside
    the bound. Returns the kernels line's entries."""
    import torch
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        colpass, colpass_k, colpass_k_plain, colpass_plain, ne_rows,
        ne_rows_k, ne_rows_k_plain, ne_rows_plain)
    gen = torch.Generator(device='cuda').manual_seed(11)
    Xs = [design.X_exact, design.X_float]
    ps = [design.n_exact, design.n_float]
    n, p = Xs[0].shape[0], sum(ps)
    x_bytes = nbytes(*Xs)
    k = COX_CHAINS
    Vs = [torch.randn((k, q), generator=gen, device='cuda') for q in ps]
    c = torch.randn(k, generator=gen, device='cuda') * 0.1
    U = torch.randn((k, n), generator=gen, device='cuda')
    blocks = list(zip(Xs, Vs))
    one = [(X, V[0].contiguous()) for X, V in blocks]
    # name: (kernel, plain, chain i's single launches or None, vector
    # floats in and out, operations)
    cases = {
        'ne_sweep[rows]@cox': (
            lambda: [ne_rows(one, c[0])],
            lambda: [ne_rows_plain(one, c[0])], None, p + n, 2 * n * p),
        'ne_sweep[cols]@cox': (
            lambda: colpass(Xs, ps, U[0]),
            lambda: colpass_plain(Xs, ps, U[0]), None, n + p, 2 * n * p),
        'ne_rows_k@cox': (
            lambda: [ne_rows_k(blocks, c)],
            lambda: [ne_rows_k_plain(blocks, c)],
            lambda i: [ne_rows([(X, V[i]) for X, V in blocks], c[i])],
            k * (p + n), 2 * n * p * k),
        'colpass_k@cox': (
            lambda: colpass_k(Xs, ps, U),
            lambda: colpass_k_plain(Xs, ps, U),
            lambda i: colpass(Xs, ps, U[i]), k * (n + p), 2 * n * p * k),
    }
    results = {}
    log(f"[cox] kernels at the Cox design's stored blocks ({n} x {ps[0]} "
        f"{Xs[0].dtype} + {n} x {ps[1]} {Xs[1].dtype}, "
        f"{x_bytes / 1e9:.3f} GB)")
    for name, (kern, plain, single, floats, ops) in cases.items():
        got = kern()
        err = check(name, got, plain())
        if single is not None:
            for i in range(k):
                if not all(torch.equal(g[i], s)
                           for g, s in zip(got, single(i))):
                    raise AssertionError(f"{name}: chain {i} differs from "
                                         f"its single-vector launch")
        ms = time_ms(kern)
        bound, by = bound_ms(x_bytes + 4 * floats, ops)
        log(f"  {name}: {ms:.3f} ms; bound {bound:.3f} ms ({by}); "
            f"{100 * bound / ms:.0f}% of the bound"
            + ("" if single is None else "; the single launches' bits"))
        results[name] = dict(max_abs_err=err, ms=ms,
                             plain_ms=time_ms(lambda: plain(), reps=3),
                             bound_ms=bound, bound_by=by, library_ms=None)
    del Vs, U, blocks, one
    torch.cuda.empty_cache()
    return results


def hmc_iteration_log(label, info, n_iter, secs, lockstep, dev_ms=None):
    """Per-iteration HMC / NUTS statistics of a run and its host syncs;
    returns the gradient evaluations per iteration."""
    import numpy as np
    si = info['_reg_coef_sampling_info']
    n_grad = si['n_grad_evals']
    for key in ('n_grad_evals', 'n_integrator_step', 'tree_height',
                'n_hessian_matvec'):
        if key in si:
            log(f"[{label}] {key} per iteration "
                f"{np.asarray(si[key]).astype(int).tolist()}")
    for key in ('stepsize', 'accept_prob', 'ave_accept_prob',
                'stability_limit_est'):
        if key in si:
            log(f"[{label}] {key} per iteration "
                f"{np.round(np.asarray(si[key]), 5).tolist()}")
    evals = int(np.sum(n_grad) + np.sum(si['n_hessian_matvec']))
    log(f"[{label}] {n_iter} iterations in {secs:.2f} s: "
        f"{n_iter / secs:.4f} iter/s, {evals / secs:.1f} gradient and "
        f"Hessian evaluations per second; lockstep host syncs per "
        f"iteration {lockstep['host'] / n_iter:.1f}, target calls per "
        f"iteration {lockstep['eval'] / n_iter:.1f}"
        + ("" if dev_ms is None else
           f"; device {dev_ms:.2f} ms per iteration"))
    return np.asarray(n_grad)


def run_cox(X, logit_outcome, logit_design):
    """The Cox phase at the flagship's width: Cox outcomes on the
    flagship X (beta ten ones, censoring fraction 0.9), the model built
    through the factory (the sorted rows' hybrid), its kernels checked,
    then HMC (MAP search, counts, resume timed, exact resume, a profiler
    window), NUTS, logit HMC on the hybrid slices' stored blocks
    (``ne_oneread[logit]`` per gradient), COX_CHAINS Cox chains under
    HMC (``ne_rows_k`` / ``colpass_k``), and 2 Cox chains against the
    chains run alone. Returns (kernel results, {path: launch counts},
    summary)."""
    import warnings
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel, gibbs_chains)
    from bayesbridge_tpu_torch import step as step_mod
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.kernels.ne_oneread import ne_oneread_link
    from bayesbridge_tpu_torch.kernels.ne_sweep import ne_sweep_plain
    from bayesbridge_tpu_torch.models import CoxModel, LogisticModel
    from bayesbridge_tpu_torch.multichain import (
        _stack_chain_inits, gibbs_chains_resume)
    from bayesbridge_tpu_torch.utils.chains import LOCKSTEP

    def lockstep_reset():
        LOCKSTEP.update(host=0, eval=0)

    beta = np.zeros(N_PRED)
    beta[:10] = 1.0
    event, censor = CoxModel.simulate_outcome(X, beta, censoring_frac=.9,
                                              seed=2)
    n_event = int(np.isfinite(event).sum())
    assert 0 < n_event < N_OBS, n_event
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        model = RegressionModel((event, censor), X, family='cox',
                                dtype=np.float32, device='cuda')
    torch.cuda.synchronize()
    design = model.design
    gb = design.storage_bytes() / 1e9
    log(f"[cox] {n_event} events of {N_OBS}; model build (sort + hybrid "
        f"+ transfer): {time.perf_counter() - t0:.1f} s; warnings "
        f"{[str(w.message)[:60] for w in caught]}; X_exact "
        f"{design.X_exact.dtype} {tuple(design.X_exact.shape)}, X_float "
        f"{tuple(design.X_float.shape)}, {gb:.3f} GB on the device")
    assert design.backend == 'hybrid' and not design.intercept_added
    # The logit design's blocks, its rows sorted: the same stored bytes.
    assert design.X_exact.dtype == torch.int8, design.X_exact.dtype
    assert design.storage_bytes() == logit_design.storage_bytes(), gb
    results = cox_kernel_checks(design)
    # Per gradient (and per Hessian matvec): one row and one column pass.
    grad_ms = time_ms(lambda: model.compute_loglik_and_gradient(
        torch.zeros(N_PRED, device='cuda')))
    log(f"[cox] one gradient (loglik, risk-set sums, X' u): {grad_ms:.3f} "
        f"ms against its bound of two reads, {2 * READ_MS:.3f} ms")

    prior = RegressionCoefPrior(bridge_exponent=0.5)
    bridge = BayesBridge(model, prior)
    counts, summary = {}, {'grad_ms': grad_ms}
    label = 'cox_hmc'
    n_first, n_more = 6, 4
    reset_launch_counts()
    lockstep_reset()
    t0 = time.perf_counter()
    samples, info = bridge.gibbs(n_first, seed=0, coef_sampler_type='hmc',
                                 params_to_save='all')
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts[label] = c = launch_counts()
    log(f"[{label}] gibbs({n_first}) incl. MAP search: {secs:.1f} s; MAP "
        f"{info['_init_optim_info']}; launch counts {c}")
    n_grad = hmc_iteration_log(label, info, n_first, secs, dict(LOCKSTEP))
    si = info['_reg_coef_sampling_info']
    assert samples['coef'].shape == (N_PRED, n_first)
    assert np.all(np.isfinite(samples['coef']))
    assert np.all(np.isfinite(samples['logp'])), samples['logp']
    assert 'obs_prec' not in samples
    # A gradient and a Hessian matvec each take one row and one column
    # pass; each iteration adds a row pass for the Hessian operator's
    # weights and one for the log density; each MAP objective one pair.
    n_map = info['_init_optim_info']['n_design_matvec'] // 2
    n_cols = n_map + int(np.sum(n_grad) + np.sum(si['n_hessian_matvec']))
    assert c['ne_sweep[cols]'] == n_cols, (n_cols, c)
    assert c['ne_sweep[rows]'] == n_cols + 2 * n_first, (n_cols, c)
    assert c['ne_oneread'] == c['ne_oneread[logit]'] == 0, c
    assert c['ne_rows_k'] == c['colpass_k'] == 0, c

    torch.cuda.synchronize()
    lockstep_reset()
    t0 = time.perf_counter()
    _, i_more = bridge.gibbs_resume(info, n_more)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    hmc_iteration_log(f'{label}_resume', i_more, n_more, secs,
                      dict(LOCKSTEP))
    summary['ips'] = n_more / secs

    # Exact resume: the first run again in two parts (its MAP search
    # repeated, deterministic).
    s_a, i_a = bridge.gibbs(4, seed=0, coef_sampler_type='hmc',
                            params_to_save='all')
    s_b, _ = bridge.gibbs_resume(i_a, n_first - 4, merge=True,
                                 prev_samples=s_a)
    for key in samples:
        if not np.array_equal(s_b[key], samples[key]):
            raise AssertionError(f"[{label}] resume != uninterrupted for "
                                 f"{key}")
    log(f"[{label}] resume check: gibbs(4) + gibbs_resume({n_first - 4}, "
        f"merge=True) == gibbs({n_first}) exactly (the stepsize adapter "
        f"carried in mcmc_info)")
    # The later runs start from the first run's start (no MAP search).
    init = {key: val for key, val in info['init'].items()
            if val is not None}
    n_prof = 2
    lockstep_reset()
    busy, dev_ms = profile_window(bridge, i_more, label, n_iter=n_prof)
    summary.update(busy=busy, dev_ms=dev_ms)

    label = 'cox_nuts'
    reset_launch_counts()
    lockstep_reset()
    t0 = time.perf_counter()
    s_n, i_n = bridge.gibbs(4, seed=2, init=init, coef_sampler_type='nuts',
                            params_to_save='all')
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts[label] = launch_counts()
    hmc_iteration_log(label, i_n, 4, secs, dict(LOCKSTEP))
    assert np.all(np.isfinite(s_n['coef']))
    assert counts[label]['ne_sweep[cols]'] > 0, counts[label]
    summary['nuts_ips'] = 4 / secs

    # Logit HMC on the hybrid slices' stored blocks ('auto': the
    # gradient on ne_oneread's logit mode, the Hessian matvec composed).
    label = 'logit_hmc'
    logit = BayesBridge(LogisticModel(*logit_outcome,
                                      logit_design.with_policy('auto')),
                        prior)
    reset_launch_counts()
    lockstep_reset()
    t0 = time.perf_counter()
    s_l, i_l = logit.gibbs(4, seed=0, coef_sampler_type='hmc',
                           params_to_save=('coef', 'logp'))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts[label] = c = launch_counts()
    log(f"[{label}] gibbs(4) incl. MAP search: {secs:.1f} s; MAP "
        f"{i_l['_init_optim_info']}; launch counts {c}")
    n_grad_l = hmc_iteration_log(label, i_l, 4, secs, dict(LOCKSTEP))
    assert np.all(np.isfinite(s_l['coef']))
    n_map = i_l['_init_optim_info']['n_design_matvec'] // 2
    assert c['ne_oneread[logit]'] == n_map + int(np.sum(n_grad_l)), c
    assert c['ne_sweep[cols]'] == int(np.sum(
        i_l['_reg_coef_sampling_info']['n_hessian_matvec'])), c
    w = logit_design.with_policy('auto')
    v = torch.zeros(logit.model.n_pred, device='cuda')
    ones = torch.ones(N_OBS, device='cuda')
    logit_ms = time_ms(lambda: logit.model.compute_loglik_and_gradient(v))
    log(f"[{label}] one gradient (ne_oneread[logit]): {logit_ms:.3f} ms "
        f"against its bound of one read, {READ_MS:.3f} ms; one Hessian "
        f"matvec (the row and column passes) "
        f"{time_ms(lambda: w.quad_matvec(v, ones)):.3f} ms")
    summary.update(logit_grad_ms=logit_ms, logit_ips=4 / secs)
    # The kernel of that gradient on the same stored blocks, against its
    # plain version (outputs, link rows, loglik each at its own scale).
    gen = torch.Generator(device='cuda').manual_seed(12)
    Xs = [logit_design.X_exact, logit_design.X_float]
    blocks = [(X, torch.randn(q, generator=gen, device='cuda') * 0.01)
              for X, q in zip(Xs, (logit_design.n_exact,
                                   logit_design.n_float))]
    c0 = torch.zeros((), device='cuda')
    a, b = logit.model.n_success, logit.model.n_trial
    got = ne_oneread_link(blocks, c0, a, b, 'logit', True)
    ref = ne_sweep_plain(blocks, c0, a, b, 'logit', True)
    err = max(check(f"ne_oneread[logit]@logit_hmc [{i}]", g, r)
              for i, (g, r) in enumerate(zip(
                  (got[0], [got[1]], [got[2]]),
                  (ref[0], [ref[1]], [ref[2]]))))
    del got, ref
    n_elem = N_OBS * (logit_design.n_exact + logit_design.n_float)
    bound, by = bound_ms(nbytes(*Xs) + 8 * (logit_design.n_exact
                                            + logit_design.n_float)
                         + 12 * N_OBS, 4 * n_elem)
    results['ne_oneread[logit]@logit_hmc'] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ne_oneread_link(blocks, c0, a, b, 'logit', True)),
        plain_ms=time_ms(lambda: ne_sweep_plain(blocks, c0, a, b, 'logit',
                                                True), reps=3),
        bound_ms=bound, bound_by=by, library_ms=None)
    log(f"  ne_oneread[logit]@logit_hmc: "
        f"{results['ne_oneread[logit]@logit_hmc']['ms']:.3f} ms; bound "
        f"{bound:.3f} ms ({by})")
    del logit, w, blocks

    # COX_CHAINS chains under HMC: the batched row and column passes.
    label, k = 'cox_chains', COX_CHAINS
    reset_launch_counts()
    lockstep_reset()
    t0 = time.perf_counter()
    s_c, i_c = gibbs_chains(bridge, 2, k, seed=5, init=init,
                            coef_sampler_type='hmc',
                            params_to_save=('coef', 'logp'))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts[label] = c = launch_counts()
    log(f"[{label}] gibbs_chains(2, {k} chains): {secs:.1f} s; n_grad_evals "
        f"per chain {i_c['_reg_coef_sampling_info']['n_grad_evals'].astype(int).tolist()}; "
        f"lockstep host syncs {LOCKSTEP['host']}, target calls "
        f"{LOCKSTEP['eval']}; launch counts {c}")
    assert np.all(np.isfinite(s_c['coef']))
    assert c['ne_rows_k'] > 0 and c['colpass_k'] > 0, c
    busy_c, dev_ms_c = profile_window(
        bridge, i_c, label, n_iter=1,
        resume=lambda n: gibbs_chains_resume(bridge, i_c, n))
    summary.update(chains_busy=busy_c, chains_dev_ms=dev_ms_c)

    # 2 chains against the chains run alone: equal bits.
    n_x = 1
    s2, i2 = gibbs_chains(bridge, n_x, 2, seed=6, init=init,
                          coef_sampler_type='hmc', params_to_save=('coef',))
    cfg = bridge._step_config(bridge._resolve_options('hmc', None))
    bridge.rg.set_seed(6)
    starts = _stack_chain_inits(bridge, init, 2)
    gens = bridge.rg.spawn(2)
    for i in range(2):
        coef, obs_prec, lscale, gscale = (s[i] for s in starts)
        carry = step_mod.init_carry('cuda', coef, obs_prec, gscale, lscale,
                                    cfg=cfg)
        _, out = step_mod.run_chain(cfg, model, gens[i], carry, 0, n_x, 1,
                                    0, save_keys=('coef',))
        alone = np.stack([v.cpu().numpy() for v in out['coef']], -1)
        if not np.array_equal(alone, s2['coef'][i]):
            raise AssertionError(f"[cox_chains] chain {i} of 2 differs "
                                 f"from the chain run alone")
        log(f"[cox_chains] chain {i} of 2 against the chain alone: equal "
            f"bits; n_grad_evals {out['n_grad_evals']}")
    del model, bridge, design
    torch.cuda.empty_cache()
    return results, counts, summary


def dense_block_checks(design, label):
    """The kernels on the dense design's lone float32 block (zero row
    offset, p + 1 columns in whole 16-byte rows): each against its plain
    version at RTOL, a rerun's bits, CUDA-event times beside the bound and
    the plain version, the CG operator also beside the cuBLAS pair
    ``X' (w * (X v))`` (its library time) in turns. Returns {name:
    result}."""
    import torch
    from bayesbridge_tpu_torch.kernels import layout, load_library
    from bayesbridge_tpu_torch.kernels.ne_oneread import (
        CLUSTER, block_plan, fit_clusters, ne_oneread, ne_oneread_link)
    from bayesbridge_tpu_torch.kernels.ne_sweep import ne_sweep_plain
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_plain)
    X, p = design.X, design.shape[1]
    n = X.shape[0]
    Xm = design.X_main
    gen = torch.Generator(device='cuda').manual_seed(7)
    v = torch.randn(p, generator=gen, device='cuda') / p ** .5
    blocks = [(X, v)]
    c = torch.zeros((), device='cuda')
    w = torch.rand(n, generator=gen, device='cuda') + 0.1
    a = (torch.rand(n, generator=gen, device='cuda') < 0.5).float()
    us = [torch.randn(n, generator=gen, device='cuda') for _ in range(3)]
    plan = block_plan(blocks)
    fit = fit_clusters(load_library(), (layout.DTYPE_CODE[X.dtype], -1),
                       plan)
    log(f"[{label}] kernels on the lone f32 block: {n} x {p} stored as "
        f"{tuple(X.shape)} ({X.shape[1] * 4} B rows), one-read plan "
        f"{plan}, {fit} clusters of {CLUSTER} at once")
    x_bytes = n * p * 4
    vec, row = 4 * p, 4 * n
    cases = {
        'ne_oneread@dense': (
            lambda: ne_oneread(blocks, c, w),
            lambda: ne_sweep_plain(blocks, c, None, w, 'ne')[:2],
            lambda r: [r[0], [r[1]]],
            (x_bytes + 2 * vec + 2 * row, 4 * n * p)),
        'ne_oneread[logit]@dense': (
            lambda: ne_oneread_link(blocks, c, a, w, 'logit', True),
            lambda: ne_sweep_plain(blocks, c, a, w, 'logit', True),
            lambda r: [r[0], [r[1]], [r[2]]],
            (x_bytes + 2 * vec + 3 * row, 4 * n * p)),
        'tdots_sweep@dense': (
            lambda: tdots_sweep([X], [p], *us),
            lambda: tdots_sweep_plain([X], [p], *us),
            lambda r: [list(r[0])],
            (x_bytes + 4 * vec + 3 * row, 9 * n * p)),
    }
    results = {}
    for name, (kern, plain, outs, work) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = max(check(f"{name} [{i}]", g, r)
                  for i, (g, r) in enumerate(zip(outs(got), outs(ref))))
        again = kern()
        assert all(torch.equal(x, y) for x, y in zip(
            [t for grp in outs(got) for t in grp],
            [t for grp in outs(again) for t in grp])), \
            f"{name} is not deterministic"
        del got, ref, again
        ms, plain_ms = time_ms(kern), time_ms(plain)
        bound, by = bound_ms(*work)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound:.4f} ms ({by}), {x_bytes / 1e9 / (ms / 1e3):.1f} GB/s "
            f"of 3350")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=None)

    def pair():
        return Xm.T @ (w * (Xm @ v))
    check("cuBLAS pair vs ne_oneread@dense", [pair()],
          [ne_oneread(blocks, c, w)[0][0]])
    ts = [time_ms(f) for f in (pair, cases['ne_oneread@dense'][0],
                               cases['ne_oneread@dense'][0], pair)]
    lib = (ts[0] + ts[3]) / 2
    log(f"  cuBLAS pair X' (w * (X v)) vs ne_oneread@dense in turns (pair, "
        f"one-read, one-read, pair): {[round(t, 4) for t in ts]} ms; "
        f"one-read {(ts[1] + ts[2]) / 2:.4f} against the pair {lib:.4f} ms, "
        f"bound {results['ne_oneread@dense']['bound_ms']:.4f} ms")
    results['ne_oneread@dense']['library_ms'] = lib
    return results


def run_dense():
    """Phase 6 (b): dense logit, X standard normal, n = 100,000 and
    p = 4,000 (BASELINE.json configs 0-1's family at the flagship's n),
    made on the card, on one stored X: the Cholesky sampler in float32
    (the default; gibbs(20), 10 resumed iterations timed, the resume
    check, a profiler window), the Gram and the factor timed beside their
    bounds; the Cholesky sampler in float64 (gibbs(10), the float64 Gram
    beside the FP64 tensor-core peak); the CG sampler in float32 under
    fused='1' (the one-read kernel and tdots_sweep on the lone block) and
    under 'auto' (the cuBLAS pair), gibbs(20) each; each kernel on the
    block against its plain version. Returns ({path: launch counts},
    {kernel: result})."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel)
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.models import LogisticModel
    t0 = time.perf_counter()
    gen = torch.Generator(device='cuda').manual_seed(3)
    X = torch.randn((DENSE_N, DENSE_P), generator=gen, device='cuda')
    beta = torch.zeros(DENSE_P, device='cuda')
    beta[:10] = 1.0
    prob = torch.sigmoid(X @ beta)
    n_success = torch.bernoulli(prob, generator=gen).cpu().numpy()
    model = RegressionModel((n_success, np.ones(DENSE_N)), X,
                            family='logit', device='cuda')
    del X, prob
    torch.cuda.synchronize()
    design = model.design
    gb = design.storage_bytes() / 1e9
    log(f"[dense] X made on the card and stored: "
        f"{time.perf_counter() - t0:.1f} s; {tuple(design.X.shape)} "
        f"{design.dtype}, {gb:.4f} GB ({design.shape[1]} columns)")
    results = dense_block_checks(design, 'dense')
    counts = {}

    # The Cholesky path: per iteration the design is read by the score's
    # Tdot, the Fisher diagonal, the Gram and the linear predictor's dot.
    def reads(k):
        return 4 * gb * 1e9
    counts['dense_cholesky'], _, info, st = run_chain(
        model, 'dense_cholesky', reads, n_first=20, n_more=10, sampler=None)
    c = counts['dense_cholesky']
    n_map = info['_init_optim_info']['n_design_matvec'] // 2
    assert info['coef_sampler_type'] == 'cholesky'
    assert c['ne_oneread[logit]'] == n_map > 0, (n_map, c)
    assert c['ne_oneread'] == c['tdots_sweep'] == 0, c
    log(f"[dense_cholesky] steady state {st['ips']:.4f} iter/s, signal "
        f"mean coef[1:11] {st['signal']:.4f}, device busy "
        + ('not measured' if st['busy'] is None else
           f"{100 * st['busy']:.1f}%, {st['dev_ms']:.2f} ms per iteration"))
    n, p = design.shape
    w = torch.rand(n, generator=gen, device='cuda') * 0.25 + 0.01
    gram_ops = 2.0 * n * p * p
    for dt, peak, what in ((torch.float32, F32_OPS_PER_S,
                            'float32 67 TFLOP/s (no tensor cores)'),
                           (torch.float64, FP64_TC_OPS_PER_S,
                            'FP64 tensor cores 67 TFLOP/s')):
        d = design if dt == torch.float32 else design.to_dtype(dt)
        wd = w.to(dt)
        ms = time_ms(lambda: d.compute_fisher_info(wd), reps=5)
        prec = d.compute_fisher_info(wd) + torch.eye(p, dtype=dt,
                                                     device='cuda')
        chol_ms = time_ms(lambda: torch.linalg.cholesky_ex(prec), reps=5)
        log(f"[dense] {dt} Gram X'WX ({n} x {p}): {ms:.2f} ms against "
            f"{gram_ops / peak * 1e3:.2f} ms ({gram_ops / 1e12:.3f} TFLOP "
            f"over the data sheet's {what}), "
            f"{gram_ops / (ms / 1e3) / 1e12:.1f} TFLOP/s; Cholesky factor "
            f"{chol_ms:.2f} ms "
            f"({p ** 3 / 3 / 1e9:.1f} GFLOP)")
        del prec
    model64 = LogisticModel(n_success, np.ones(DENSE_N), d)
    bridge = BayesBridge(model64, RegressionCoefPrior(bridge_exponent=0.5))
    t1 = time.perf_counter()
    reset_launch_counts()
    s64, _ = bridge.gibbs(10, seed=0, params_to_save=('coef', 'logp'))
    torch.cuda.synchronize()
    c64 = launch_counts()
    assert s64['coef'].dtype == np.float64 and np.all(
        np.isfinite(s64['logp'])), s64['logp']
    assert not any(c64.values()), c64  # float64 reaches no kernel
    log(f"[dense_cholesky_f64] gibbs(10) incl. MAP search: "
        f"{time.perf_counter() - t1:.1f} s; mean coef[1:11] "
        f"{s64['coef'][1:11].mean():.4f}; no kernel launched")
    del bridge, model64, d
    torch.cuda.empty_cache()

    for label, policy in (('dense_cg_fused', '1'), ('dense_cg_auto', 'auto')):
        m = with_policy(model, policy)
        bridge = BayesBridge(m, RegressionCoefPrior(bridge_exponent=0.5))
        reset_launch_counts()
        t1 = time.perf_counter()
        s, i = bridge.gibbs(20, seed=0, coef_sampler_type='cg',
                            params_to_save=('coef', 'logp'))
        torch.cuda.synchronize()
        counts[label] = c = launch_counts()
        n_cg = i['_reg_coef_sampling_info']['n_cg_iter']
        assert np.all(np.isfinite(s['logp'])), s['logp']
        if policy == '1':
            assert c['ne_oneread'] >= int(n_cg.sum()) + 20, c
            assert c['tdots_sweep'] == 20 and c['ne_sweep[ne]'] == 0, c
        else:
            assert c['ne_oneread'] == c['tdots_sweep'] == 0, c
        log(f"[{label}] gibbs(20) incl. MAP search: "
            f"{time.perf_counter() - t1:.1f} s; mean CG iterations "
            f"{n_cg.mean():.2f}; mean coef[1:11] "
            f"{s['coef'][1:11].mean():.4f}; launch counts {c}")
        del bridge, m
    del model, design
    torch.cuda.empty_cache()
    return counts, results


def run_harness():
    """Phase 9: the sweep A/B harness at the flagship block shape, with the
    launch counts of its run. Returns the counts."""
    import torch
    from bayesbridge_tpu_torch.baselines import dev_ne_variants as harness
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    pe = int(N_PRED * BINARY_FRAC)
    dev = torch.device('cuda')
    reset_launch_counts()
    harness.run_main(N_OBS, pe, N_PRED - pe,
                     harness.DEFAULT_VARIANTS.split(','), chain=10, reps=5,
                     budget_kib=harness.PANEL_BYTES // 1024, device=dev,
                     log=log)
    torch.cuda.empty_cache()
    harness.run_probes(N_OBS, 10, 5, dev, log=log)
    torch.cuda.empty_cache()
    harness.run_presolve(N_OBS, pe, N_PRED - pe, 10, 5, dev, log=log)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[harness] launch counts of this path: {counts}")
    assert counts['ne_onepass'] > 0 and counts['ne_sweep[rows]'] > 0, counts
    assert counts['ne_sweep[ne]'] > 0 and counts['ne_oneread'] > 0, counts
    assert all(counts[f'stream_probe[{k}]'] > 0
               for k in ('i32', 'cvt', 'mul')), counts
    torch.cuda.empty_cache()
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

    def phase(name, t0):
        log(f"== phase {name}: {time.perf_counter() - t0:.1f} s")
        return time.perf_counter()

    t0 = time.perf_counter()
    kl = load_library()
    log(f"kernel build: {kl.build_seconds:.1f} s -> {kl.path.name}")
    for line in kl.ptxas_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ptxas: ' + line.strip())
    t0 = phase('build', t0)
    kernel_checks()
    composed_and_onepass_checks()
    packed_kernel_checks()
    t0 = phase('ragged kernel checks', t0)
    results, link_turns = flagship_kernel_checks()
    results.update(probe_timings())
    t0 = phase('flagship kernel checks', t0)
    X, outcome = build_data()
    counts, witness, design, composed_ips = run_hybrid(X, outcome)
    counts['link_turns'] = link_turns
    t0 = phase('hybrid slices', t0)
    counts['linear_hybrid'] = run_linear_hybrid(design, X)
    t0 = phase('linear slice', t0)
    res, mc_counts, mc = run_multichain(design, outcome, composed_ips)
    results.update(res)
    counts.update(mc_counts)
    log(f"[multichain] summary: {json.dumps(mc)}")
    t0 = phase('multichain', t0)
    res, cox_counts, cox = run_cox(X, outcome, design)
    results.update(res)
    counts.update(cox_counts)
    log(f"[cox] summary: {json.dumps(cox)}")
    t0 = phase('cox', t0)
    del design
    torch.cuda.empty_cache()
    dense_counts, res = run_dense()
    counts.update(dense_counts)
    results.update(res)
    t0 = phase('dense slice', t0)
    res, counts['bitpack'], _ = run_packed(X, outcome, 'bitpack', witness)
    results.update(res)
    del X, outcome
    t0 = phase('bitpack slice', t0)
    X, outcome = build_winell_data()
    res, counts['winell'], counts['winell_packing'] = run_packed(
        X, outcome, 'winell')
    results.update(res)
    del X, outcome
    t0 = phase('winell slice', t0)
    counts['harness'] = run_harness()
    phase('harness', t0)

    # The path whose run each kernel's launch count is read from. The
    # linear model's MAP search runs the one-read kernel's 'linear' mode
    # on the flagship blocks; the dense design's lone block takes the
    # one-read kernel and tdots_sweep on the fused CG slice and the logit
    # link on the Cholesky slice's MAP search ('@dense' entries: the same
    # counters, timed at the dense block). The two-pass route's 'linear'
    # mode runs on no path: its timing is logged above and left out of
    # the line. The
    # fused sweep takes the one-read route on the hybrid slice in every
    # mode, so the sweep's two-pass 'ne' route is counted in the harness,
    # which times it beside the composed pair, and its two-pass 'logit'
    # route on the flagship phase's link turns (check-only); the winell
    # slice runs wincsr, so the windowed-ELL kernel is counted on the
    # winell timing phase, whose packings' products it computes once
    # before its checks (check-only).
    path_of = {'ne_sweep[ne]': 'harness',
               'ne_oneread': 'hybrid_fused',
               'ne_oneread[logit]': 'hybrid_fused',
               'ne_sweep[logit]': 'link_turns',
               'tdots_sweep': 'hybrid_fused',
               'ne_sweep[rows]': 'hybrid_composed',
               'ne_sweep[cols]': 'hybrid_composed',
               'tdots_sweep[u4]': 'hybrid_composed',
               'ne_onepass': 'harness',
               'ne_oneread[linear]': 'linear_hybrid',
               'ne_oneread@dense': 'dense_cg_fused',
               'ne_oneread[logit]@dense': 'dense_cholesky',
               'tdots_sweep@dense': 'dense_cg_fused',
               'ne_rows_k': 'multichain',
               'colpass_k': 'multichain',
               'tdots_sweep_k[u4]': 'multichain',
               'tdots_sweep_k': 'multichain_fused',
               'ne_sweep[rows]@cox': 'cox_hmc',
               'ne_sweep[cols]@cox': 'cox_hmc',
               'ne_rows_k@cox': 'cox_chains',
               'colpass_k@cox': 'cox_chains',
               'ne_oneread[logit]@logit_hmc': 'logit_hmc'}
    kernels = []
    for name, res in results.items():
        counter = name.split('@')[0]
        base = counter.split('[')[0]
        path = path_of.get(name, {'bitlut': 'bitpack', 'wincsr': 'winell',
                                  'winell': 'winell_packing',
                                  'stream_probe': 'harness'}.get(base))
        if path is None:
            continue
        launches = counts[path][counter]
        assert launches > 0, (name, path, counts[path])
        kernels.append(dict(
            name=name, route='cuda', source=REGISTRY[base]['source'],
            replaces=REGISTRY[base]['replaces'], launches=launches, **res,
            path='check-only' if path in ('winell_packing', 'link_turns')
            else path))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
