#!/usr/bin/env python3
"""Drive the torch port's paths once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
   TF32 is turned off for matmuls and cuDNN;
2. build the hand-written kernels from ``bayesbridge_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together),
   while the host builds the flagship data in a thread;
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
   iteration; the same iterations again on the host-driven CG loop,
   whose trace holds every kernel the graphs launch); then the
   alternating A/B segments (2 rounds); then the
   MAP search's witness (the search with the fused objective, on
   ``ne_oneread[logit]``, and with the composed one on the same design,
   and the two objectives compared) and the two objectives' times in
   turns; then the draws phase: ``pg_draw`` at the composed chain's
   linear predictor (n = 100,000) and ``ts_draw`` at its (coef /
   gscale)^2 (p = 50,000, alpha 0.25), then at fixed-tilt grids of
   100,000 lanes (PG z in 0, 0.1, 1, 4, 20, 40; tilted stable at alpha
   0.25 and 0.5, tilts 1e-30 to 1e4 and 16, the crossover's edge), in
   float32 and float64, each against its plain rounds by KS (p > 1e-4)
   and the closed-form moments, with the rounds a lane took and no
   capped lane; ``ts_draw`` (T threads a lane on round-indexed Philox
   streams) against its plain sweep (``draws.tilted_stable_indexed_plain``,
   the same keys) on 4,000 of the flagship's lanes (attempts equal on
   99.9%, values within rtol 1e-4 / 1e-10 where they are), its first
   design (``ts_draw[first]``, one thread a lane) against the plain
   rounds by KS; both draws timed at the flagship shapes (each kernel
   alone from a profiler trace, the wrapper by CUDA events and the host
   clock) beside the plain rounds, the tilted-stable designs in turns
   (``baselines.device_loop_turns``: the regrouping design from T = 1-32
   and the first design, 1 and 4 chains, float32 and float64; again at
   the ell slice's p = 16,384 and state, with its bound from the rounds
   there: ``ts_draw@ell64``), and run under
   ``torch.cuda.set_sync_debug_mode('error')`` (every chain phase of
   the smoke asserts ``ts_draw``, and on logit ``pg_draw``, at least
   once an iteration); then the int4 phase (``BB_HYBRID_INT4=1``): the nibble modes of
   the row pass, the column pass and the pre-solve (four and five
   reductions; its binary mode on 0/1 blocks) against their plain
   versions (rtol 1e-4 of max|plain|) at ragged small shapes (values in
   [-8, 7] and 0/1, widths not a multiple of 32, one and two blocks,
   random padding nibbles) and on the hybrid slices' stored int8 block
   packed on the card (``with_exact_tier``: 100,000 x 45,000 packed
   beside the f32 block; the pre-solve in both modes), reruns and the
   int8 modes on the same values bit for bit, each timed in turns with
   its int8 mode beside its bound; the logit chain on the packed design
   under 'auto' (``gibbs(10)`` + ``gibbs_resume(10)``, the exact-resume
   check, a profiler window beside the int8 'auto' slice's device ms),
   ``gibbs(5)`` against the int8 design under '0' bit for bit and a
   profiler window over the same 3 iterations of that chain on each
   storage, 2 chains
   against the chains alone, and the public constructor at 4,000 x 600,
   which must store int4 under 'auto' and int8 under '1';
6. the dense and linear slices: (a) the linear model over the hybrid
   slices' stored blocks (y = X beta + N(0, 1) noise), under 'auto' (its
   MAP search on ``ne_oneread[linear]``, the CG operator and the
   pre-solve composed): ``gibbs(20)`` with the Jacobi preconditioner,
   launch counters read right after it, 10 resumed iterations timed,
   the resume check and a profiler window, then ``gibbs(5)`` with the
   prior preconditioner, and the one-read linear objective in turns
   against the two-pass sweep and the composed one; then the multichain
   phase on the same stored blocks: the chain-batched kernels
   (``ne_rows_k``, ``colpass_k``, ``tdots_sweep_k`` with five and four
   reductions) for 1, 2, 4 and 8 chains against their plain versions
   and, bit for bit, against the chains' single-vector launches, each
   call made twice for the same bits and its launches per call logged
   (one for every k up to 8), timed beside k x the single launch and the
   bound; ``gibbs_chains`` with 4
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
   logit); then the sharded phase on the same stored blocks: a mesh
   of 4 (four cards where the machine has them, else ``[cuda:0] * 4``,
   each shard a row view of the blocks), the sharded products (dot,
   Tdot, the fused and the composed CG operator, the pre-solve fused and
   composed, the Fisher diagonal, the logit link, and the 4-chain forms)
   against the unsharded design's (rtol 1e-4 of max), each rerun for the
   same bits and each launching its kernel once per shard; the price of
   a gather; ``gibbs(10)`` + ``gibbs_resume(10)`` under ``'1'`` and
   ``'auto'`` with the exact-resume check and a profiler window, beside
   the unsharded slices' in the same run; one CG solve from the same
   state sharded and unsharded; 4 chains on the mesh against the chains
   alone; and an NCCL process group of one (``initialize_multihost``,
   ``host_local_to_global``), whose 2 iterations must equal the one-shard
   single-process run bit for bit; then the 2-d phase on the same
   stored blocks under 'auto': a 2 x 2 obs x pred grid (four cards
   where the machine has them, else ``[cuda:0] * 4``, each piece a copy
   cut at 32 exact and 4 float columns), the products (dot, Tdot, the
   composed CG operator, the Fisher diagonal, the five-reduction
   pre-solve, their 4-chain forms) against the unsharded design's (rtol
   1e-4 of max), each rerun for the same bits and launching its kernel
   once a piece; the row pass, column pass and pre-solve timed on a
   piece (the kernels line's ``@mesh2d`` entries); the same products on
   1 x 4 and 4 x 1, the latter equal to the 1-d mesh of 4 bit for bit;
   ``gibbs(10)`` + ``gibbs_resume(10)`` with the exact-resume check and
   a profiler window beside the unsharded and 1-d slices' device ms;
   one CG solve sharded and unsharded; the block packed as int4 on the
   same grid, equal to the int8 pieces bit for bit; (b) a dense logit
   design, X standard normal, 100,000 x 4,000, made on the card and
   stored as 4,004 float32 columns: ``ne_oneread``, its logit mode and
   ``tdots_sweep`` on the lone block against their plain versions, the
   CG operator also in turns against the cuBLAS pair
   ``X' (w * (X v))``; the Cholesky sampler (the default) in float32
   (``gibbs(20)``, its MAP search on ``ne_oneread[logit]``, 10 resumed
   iterations, the resume check, a profiler window), the Gram and the
   Cholesky factor timed in float32 and float64 beside their bounds,
   ``gibbs(10)`` in float64 (no product kernel launched, only the
   draws), and the CG sampler
   under ``fused='1'`` (the kernels on the lone block) and ``'auto'``
   (the cuBLAS pair), ``gibbs(20)`` each and a profiler window; before
   the chains, the design
   on the 2 x 2 grid (its stored columns cut at 4), the products and the
   float32 Gram against the unsharded ones;
7. the bitpack slice: the same X with ``backend='bitpack'`` (bitmaps of
   5,632 x 106,496 and 12,512 x 49,152 bytes plus a 100,000 x 5,000 f32
   block); bitlut against its plain version on the design's bitmaps,
   timed beside its bound and beside cuSPARSE (``torch.sparse_csr_tensor
   @ v``) on the binary columns' CSR, and every mode of its source in
   turns (``baselines/bitlut_ablation.py``: the design's nibble tables,
   the first design's byte tables, nibble tables from L2, no lookups);
   the f32 side block's GEMV pair timed beside its bound; the design on
   the 2 x 2 grid (binary columns cut at 8, each piece its own bitmaps),
   the products with bitlut launched once a piece, bitlut timed on a
   piece; then a 15-iteration chain on the composed CG path, and its MAP
   search against the hybrid's;
8. the winell slice: a 131,072 x 16,384 design with 164 standard-normal
   entries per row (``backend='auto'`` picks winell, which stores a
   windowed CSR on the card); wincsr against its plain version on the
   design's layouts, timed beside its bound and beside cuSPARSE on the
   full CSR; the windowed-ELL kernel winell, which no path runs any
   more, on the JAX package's packings (packed on the host on demand,
   copied to the card here), its products run once right after the
   counters are zeroed (the launches the kernels line reports, marked
   ``"path": "check-only"``), then checked and timed the same way; the
   design on the 2 x 2 grid, which warns and splits rows only, every
   product equal to the 1-d mesh of 2's bit for bit; then the same
   chain, on wincsr;
9. the ell slice: 262,144 x 16,384 with 164 standard-normal entries per
   row (``utils.simulate_data.normal_design``, as
   ``baselines/bench_sparse_matvec.py`` ``build_sparse`` builds it at its
   defaults), logit outcome; (a) float64 under ``backend='auto'``, which
   picks ell (the dual row-ELL of X and X') with the JAX package's
   warning: the gather kernel ``ell_matvec_k`` in both orientations,
   power 1 and 2, for 1, 2, 4 and 8 vectors a launch against its plain
   version (rtol 1e-12 of max|plain|) and bit for bit against single
   launches, each call rerun for the same bits, each launch on the
   traversal the dispatch gives it (the col-ELL's windowed one,
   ``ell[tdot_win]``, where ``kernels.ell.takes_window`` gives the
   launch to it by its bytes), the col-ELL's two traversals to the same
   bits at every k, each traversal timed beside its bound (the first
   one's over the padded slots, the windowed one's over the valid slots
   and the window pointers it reads; both beside the nonzeros alone) and
   cuSPARSE (at k = 2, 4 and 8 on the k vectors at once); the design
   on a 4-shard mesh (each shard's col-ELL built from its rows, the
   traversal each takes logged), its products against the unsharded
   design's at 1e-12 of max; ``gibbs(20)`` with CG, 'diag' and bridge
   exponent 0.5
   (launch counts read right after it), ``gibbs_resume(10)`` timed, the
   exact-resume check, a profiler window, 2 chains against the chains
   run alone, the design on the 2 x 2 grid (the row-ELL cut by rows,
   the col-ELL by predictors, each col-ELL piece's traversal logged),
   its products against the unsharded design's at 1e-12 of max,
   ``gibbs(5)`` on it and the kernel timed on a row and a col-ELL piece,
   and 5 sweeps of the public component updates with finite
   log densities, the last above the first; (b) the same X in float32 with
   ``backend='ell'`` forced: the kernel checks and timings, ``gibbs(10)``;
   both slices' chains must run the col-ELL on the traversal the
   dispatch gives one vector (the windowed one);
10. the sweep A/B harness (``bayesbridge_tpu_torch.baselines.
   dev_ne_variants``) at the flagship block shape: the composed pair,
   ne_sweep's two-pass route, ne_oneread and the default one-read
   variants of ne_onepass, then ``--probe`` and ``--presolve``, its
   launch counters read right after it.

Every CG solve on one card runs as the device loop (``ops/cg.py``: one
launch of a CUDA graph whose conditional WHILE node loops the captured
iteration, the design's products and ``cg_update``, csrc/cg_loop.cu).
The cg_loop phase runs inside the slices, after each chain, on its
design at full width: the hybrid slices fused and composed, int4, the
dense CG slices, bitpack, winell, ell float64 and float32 and the 4-shard
mesh: one solve of 4 chains (different iteration counts, one that starts
converged) both ways, the host-driven loop and the device loop, with the
same n_cg_iter, coef within RTOL (1e-12 in float64), a rerun's bits from
the cached graph with one host read, the launch counters at the captured
iteration's launches times max(n_iter), each chain equal to the chain
alone bit for bit, each way's wall ms, the graph pool's bytes and the
CUDA versions; ``cg_start`` and ``cg_update``'s two routes (the cluster
kernel ``cg_iter`` the path takes, the first design's three kernels) are
checked against their plain versions and each other (the same bits) at
the composed flagship chain's shape, winell's and ell float64's, the
update's routes timed in turns at 1 and 4 chains
(``baselines.device_loop_turns``), ``cg_start`` by CUDA events (median
of 10), each beside the bound: each vector read or written once over
3,350 GB/s. Every
profiler window also splits each iteration's host wall ms and device ms
between the CG solve and the rest of the step (``utils.profiling.
span_stats`` over the step's ``gibbs:*`` spans), summarized at the end.

Every one-card CG chain runs the Gibbs step as one CUDA graph, one
replay an iteration (``step.takes_step_graph``, ``kernels/
step_graph.py``). Each of its profiler windows runs three ways from the
same state: the graph step (one replay an iteration, no host read
between replays), the eager step (``eager_step()``: the same bits, every
sample, state and generator), and the eager step on the host-driven CG
loop, whose trace gives the device ms. The graph and the eager step are
also timed untraced over 12 iterations from the same state: the wall
ms an iteration from the run's first step to its end, the device ms an
iteration, a call's ms before its first step and the steady busy share
(``step_ab``,
summarized as ``[step_ab]``); a graph holding a WHILE node is tried as a
child graph node once (CUDA refuses it).

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it a JSON summary of the kernels (each with the ``path``
its launches were counted on, ``check-only`` where no path of the
package runs it), and the last line
``{"ok": true, "device": {...}}``. With no CUDA device it exits 1 and
prints no result.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_OBS, N_PRED = 100_000, 50_000
DENSE_N, DENSE_P = 100_000, 4_000
BINARY_FRAC = 0.9
WINELL_N = 131_072
ELL_N = 262_144  # baselines/bench_sparse_matvec.py's default n
# The columns and draws per row of baselines/bench_sparse_matvec.py's
# general-valued designs (the winell and ell slices).
SPARSE_P, SPARSE_PER_ROW = 16_384, 164
RTOL = 1e-4  # relative to max|plain|: the two sum in different orders
# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The FP64 tensor-core peak of the same data sheet (cuBLAS's DGEMM runs
# there): the float64 Gram's bound.
FP64_TC_OPS_PER_S = 67e12
# Float64 outside the tensor cores (the same data sheet): the ell
# kernel's float64 FMAs.
FP64_OPS_PER_S = 34e12


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


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """(least time in ms, 'bytes' | 'operations'): the larger of the bytes
    over the HBM rate and the operations over their peak rate (float32
    outside the tensor cores unless `ops_per_s` says otherwise)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
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


def build_normal_data(n):
    """n x 16,384 with 164 standard-normal entries per row at uniform
    columns (duplicates summed), seed 0, as
    baselines/bench_sparse_matvec.py ``build_sparse`` builds it (its
    defaults at n = 262,144, density 0.01, values 'normal'); logit
    outcome with beta[:10] = 1, seed 1."""
    import numpy as np
    from bayesbridge_tpu_torch.utils.simulate_data import (
        normal_design, simulate_outcome)
    t0 = time.perf_counter()
    p = SPARSE_P
    X = normal_design(n, p, SPARSE_PER_ROW, seed=0)
    beta = np.zeros(p)
    beta[:10] = 1.0
    outcome = simulate_outcome(X, beta, 'logit', seed=1)
    log(f"host data build: {time.perf_counter() - t0:.1f} s "
        f"({n} x {p}, nnz {X.nnz})")
    return X, outcome


def device_csr_pair(X, col_map=None, dtype='float32'):
    """(A, A') as torch sparse CSR on the card (int32 indices, values in
    `dtype`) from a scipy CSR, keeping only the columns with col_map >= 0
    (renumbered to col_map) when given; the transpose is sorted on the
    card. For the library yardstick only."""
    import torch
    n = X.shape[0]
    dev = 'cuda'
    indptr = torch.from_numpy(X.indptr.astype('int64')).to(dev)
    cols = torch.from_numpy(X.indices).to(dev).long()
    vals = torch.from_numpy(X.data.astype(dtype)).to(dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   indptr.diff())
    m = X.shape[1]
    if col_map is not None:
        jb = torch.from_numpy(col_map).to(dev)[cols]
        keep = jb >= 0
        rows, cols, vals = rows[keep], jb[keep], vals[keep]
        m = int(col_map.max()) + 1
        del jb, keep

    A = csr_tensor(rows, cols, vals, (n, m))
    order = torch.argsort(cols, stable=True)
    At = csr_tensor(cols[order], rows[order], vals[order], (m, n))
    return A, At


def csr_tensor(r, c, v, shape):
    """A torch sparse CSR matrix on r's device from entries sorted by row
    (int32 indices)."""
    import torch
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=r.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=shape[0]), 0)
    return torch.sparse_csr_tensor(crow.int(), c.int(), v, size=shape,
                                   check_invariants=False)


def bitmap_csr(bits, n_in, n_out):
    """The (n_out, n_in) 0/1 matrix of a bitlut bitmap (byte bits[g, m]
    bit b = entry (m, 8g + b)) as a float32 CSR on the card, for the
    library yardstick."""
    import torch
    rows, cols = [], []
    for b in range(8):
        g, m = torch.nonzero((bits >> b) & 1, as_tuple=True)
        keep = (m < n_out) & (8 * g + b < n_in)
        rows.append(m[keep])
        cols.append(8 * g[keep] + b)
    rows, cols = torch.cat(rows), torch.cat(cols)
    order = torch.argsort(rows * n_in + cols)
    return csr_tensor(rows[order], cols[order],
                      torch.ones(order.numel(), device=bits.device),
                      (n_out, n_in))


def ell_csr(idx, val, n_in):
    """The (rows, n_in) matrix of ELL arrays (row i's entries val[i, s] at
    column idx[i, s], zero values padding) as a CSR in val's dtype, for
    the library yardstick."""
    import torch
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] \
        .expand_as(idx)
    keep = val != 0
    return csr_tensor(rows[keep], idx[keep].long(), val[keep],
                      (idx.shape[0], n_in))


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
    assert_draws(label, counts, n_first, model.name)
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


def _traced_window(label, n_iter, run):
    """One profiler window (``utils.profiling.trace``) over ``run()``:
    (wall ms, the device events by kernel from ``op_stats_from_trace``,
    the spans from ``span_stats``, the ms of each graph launch by CUDA
    events (the CG solve's graphs, the step graph's replays), what run()
    returned)."""
    import shutil
    import tempfile
    import torch
    from bayesbridge_tpu_torch.kernels.cg_loop import timed_launches
    from bayesbridge_tpu_torch.utils.profiling import (
        annotate, op_stats_from_trace, span_stats, trace)
    torch.cuda.synchronize()
    log_dir = tempfile.mkdtemp(prefix='bb-profile-')
    try:
        with timed_launches() as graphs, trace(log_dir):
            t0 = time.perf_counter()
            with annotate(f'{label} window'):
                result = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = op_stats_from_trace(log_dir, device_only=True)
        spans = span_stats(log_dir, 'gibbs:')
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return wall, rows, spans, [a.elapsed_time(b) for a, b in graphs], result


@contextlib.contextmanager
def eager_step():
    """Within the block every Gibbs run steps eagerly (``step.run_chains``
    as where ``takes_step_graph`` is False; its CG solves still on the
    device loop where they take it)."""
    from bayesbridge_tpu_torch import step
    saved = step.takes_step_graph
    step.takes_step_graph = lambda cfg, model, k: False
    try:
        yield
    finally:
        step.takes_step_graph = saved


@contextlib.contextmanager
def host_loop():
    """Within the block every Gibbs run steps eagerly and every CG solve
    takes the host-driven loop (``ops.cg.host_solve``): the same body,
    one host read an iteration."""
    from bayesbridge_tpu_torch.ops import cg
    saved = cg.takes_device_loop
    cg.takes_device_loop = lambda design, device: False
    try:
        with eager_step():
            yield
    finally:
        cg.takes_device_loop = saved


def _same_run(a, b, label, path=''):
    """Two runs' (samples, info) equal bit for bit: every sample, the
    sampling info, the final and resume states and the generators'."""
    import numpy as np
    import torch
    if isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray) \
            and isinstance(b, (tuple, list)):
        assert len(a) == len(b), (label, path)
        for i, (x, y) in enumerate(zip(a, b)):
            _same_run(x, y, label, f'{path}[{i}]')
        return
    if isinstance(a, dict):
        for key in a:
            if key in ('runtime', '_init_optim_info'):
                continue
            assert key in b, (label, path, key)
            _same_run(a[key], b[key], label, f'{path}.{key}')
        return
    if torch.is_tensor(a):
        a, b = a.cpu().numpy(), b.cpu().numpy()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (label, path)
    else:
        assert a == b, (label, path, a, b)


# The step graph against the eager step, per profiler window, by label.
STEP_AB = {}


def _run_timed(run, n):
    """run(n) timed on the host clock, the card synchronized before and
    after: (ms from its first step, a replay or an eager step, to its
    end; ms of the whole call; ms of its graph launches by CUDA
    events)."""
    import torch
    from bayesbridge_tpu_torch import step as step_mod
    from bayesbridge_tpu_torch.kernels.cg_loop import timed_launches
    from bayesbridge_tpu_torch.kernels.step_graph import StepGraph
    first = []
    replay, step_into = StepGraph.replay, step_mod.step_into

    def mark(fn):
        def wrapped(*args):
            if not first:
                first.append(time.perf_counter())
            return fn(*args)
        return wrapped
    StepGraph.replay, step_mod.step_into = mark(replay), mark(step_into)
    try:
        torch.cuda.synchronize()
        with timed_launches() as graphs:
            t0 = time.perf_counter()
            run(n)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    finally:
        StepGraph.replay, step_mod.step_into = replay, step_into
    return ((t1 - first[0]) * 1e3, (t1 - t0) * 1e3,
            sum(a.elapsed_time(b) for a, b in graphs))


def step_ab(label, bridge, n_iter, graph_win, eager_win, replays, resume,
            n_timed=12):
    """Log and keep (STEP_AB) a window's graph step against the eager
    step from the same state, per iteration: the traced window's wall
    ms, device ms by CUDA events (the graphs' launches plus the other
    device work the host launched in the window: ``span_stats``) and busy
    share; untraced, over `n_timed` iterations from the same state, the
    wall ms an iteration (from the run's first step to its end: the
    iterations and the one read at the end), a call's ms before its first
    step, the device ms an iteration (the step graph's replays by CUDA
    events; the eager step runs the same kernels to the same bits) and
    the steady busy share (the one over the other); the step graph's
    build seconds and pool MB, and the window's mean CG iterations (a
    chain's, over its chains)."""
    import numpy as np
    from bayesbridge_tpu_torch.kernels.step_graph import _graphs_of
    n_cg = graph_win[4][1]['_reg_coef_sampling_info'].get('n_cg_iter')
    out = {'mean_cg': None if n_cg is None else float(np.mean(n_cg))}
    for name, (wall, _, spans, graphs, _) in (('graph', graph_win),
                                             ('eager', eager_win)):
        events = spans['']['device_ms'] + sum(graphs)
        out[f'{name}_wall_ms'] = round(wall / n_iter, 4)
        out[f'{name}_device_ms'] = round(events / n_iter, 4)
        out[f'{name}_busy'] = round(events / wall, 4)
        with contextlib.ExitStack() as stack:
            if name == 'eager':
                stack.enter_context(eager_step())
            steps, whole, graph_ms = _run_timed(resume, n_timed)
        out[f'{name}_step_ms'] = round(steps / n_timed, 4)
        out[f'{name}_call_ms'] = round(whole - steps, 4)
        if name == 'graph':
            out['step_device_ms'] = round(graph_ms / n_timed, 4)
        out[f'{name}_steady_busy'] = round(
            out['step_device_ms'] * n_timed / steps, 4)
    graphs = list(_graphs_of(bridge.model.design).values())
    out.update(replays=replays, step_graphs=len(graphs),
               build_s=round(sum(g.build_seconds for g in graphs), 3),
               pool_mb=round(sum(g.pool_bytes for g in graphs) / 1e6, 3))
    STEP_AB[label] = out
    log(f"[{label}] step graph against the eager step, the same "
        f"{n_iter} iterations (the same bits): window wall "
        f"{out['graph_wall_ms']:.2f} / {out['eager_wall_ms']:.2f} ms an "
        f"iteration, device {out['graph_device_ms']:.2f} / "
        f"{out['eager_device_ms']:.2f} ms by events, busy "
        f"{100 * out['graph_busy']:.1f}% / {100 * out['eager_busy']:.1f}%; "
        f"untraced, an iteration's wall {out['graph_step_ms']:.2f} / "
        f"{out['eager_step_ms']:.2f} ms, device {out['step_device_ms']:.2f}"
        f" ms (steady busy "
        f"{100 * out['graph_steady_busy']:.1f}% / "
        f"{100 * out['eager_steady_busy']:.1f}%), a call's ms before its "
        f"first step {out['graph_call_ms']:.1f} / "
        f"{out['eager_call_ms']:.1f}; "
        f"{replays} replays, no host read between them; mean CG "
        f"iterations {out['mean_cg']}; {len(graphs)} step graph(s) on the "
        f"design, built in {out['build_s']:.2f} s, pool "
        f"{out['pool_mb']:.2f} MB")


def profile_window(bridge, info, label, n_iter=3, resume=None):
    """A profiler window over `n_iter` more iterations (``resume(n_iter)``,
    by default ``bridge.gibbs_resume(info, n_iter)``): (the device's busy
    share of the window's wall clock, profiler overhead included; device
    ms per iteration), both None where the profiler saw no device events,
    logged with the kernels that took the most device time and with the
    split of each iteration between the CG solve and the rest of the step
    (:func:`log_split`).

    The device ms is the sum of the device events of the trace, as in
    the windows before the device loop. The trace misses some kernels a
    CUDA graph launches, so where the CG loop's graphs ran, the window is
    run again from the same state with every solve on the host loop
    (:func:`host_loop`; a resume replays the same draws, the same
    kernels), and that run's trace gives the device ms of both. Logged
    beside it: the device loop's own measure, the work the host launched
    (``span_stats``) plus the graphs' time by CUDA events, which also
    holds the gaps between a graph's nodes; and the host loop's wall."""
    if resume is None:
        def resume(n):
            return bridge.gibbs_resume(info, n)
    from bayesbridge_tpu_torch.gibbs_util import SamplerOptions
    from bayesbridge_tpu_torch.step import takes_step_graph
    with ReplayReads() as rr:
        window = _traced_window(label, n_iter, lambda: resume(n_iter))
    wall, rows, spans, graphs, result = window
    host = None
    cfg = bridge._step_config(SamplerOptions.from_info(info['options']))
    if takes_step_graph(cfg, bridge.model, info.get('n_chains', 1)):
        assert rr.marks, (label, 'no step graph replay')
    if rr.marks:
        # The step graph ran: one replay an iteration, no host read
        # between them; the same iterations on the eager step give the
        # same bits.
        assert len(rr.marks) == n_iter and rr.between == 0, (
            label, len(rr.marks), rr.between)
        with eager_step():
            resume(1)  # lazy work off the clock (the CG solve's graph)
            eager = _traced_window(label, n_iter, lambda: resume(n_iter))
        _same_run(result, eager[4], label)
        step_ab(label, bridge, n_iter, window, eager, len(rr.marks),
                resume)
        # The split of the step between its phases: the eager step's.
        spans, graphs = eager[2], eager[3]
    if graphs:
        with host_loop():
            host = _traced_window(label, n_iter, lambda: resume(n_iter))
        rows = host[1]
    if not rows:
        log(f"[{label}] profiler: no device events (busy share not "
            f"measured)")
        return None, None
    busy = sum(r['self_us'] for r in rows) / 1e3
    graph_ms = sum(graphs)
    log(f"[{label}] profiler over {n_iter} iterations: device busy "
        f"{busy:.1f} ms of {wall:.1f} ms wall ({100 * busy / wall:.1f}%, "
        f"idle {100 - 100 * busy / wall:.1f}%); device "
        f"{busy / n_iter:.2f} ms per iteration")
    if host is not None:
        events = spans['']['device_ms'] + graph_ms
        log(f"[{label}] the same iterations on the host loop: {host[0]:.1f} "
            f"ms wall, busy {100 * busy / host[0]:.1f}% (device ms from "
            f"this run's trace, above); the CG device loop by its own "
            f"measure: {events:.1f} ms ({len(graphs)} CG graph launches, "
            f"{graph_ms:.2f} ms by CUDA events, gaps between nodes "
            f"included)")
    for r in rows[:8]:
        log(f"    {r['self_us'] / 1e3:9.2f} ms  {r['occurrences']:6d} x  "
            f"{r['name'][:90]}")
    if len(spans) > 1:
        log_split(label, spans, n_iter, graph_ms,
                  None if host is None else host[2])
    return busy / wall, busy / n_iter


# The per-iteration split of every profiler window between the CG solve
# and the rest of the Gibbs step (utils.profiling.span_stats), by label.
SPLITS = {}


def log_split(label, spans, n_iter, graph_ms=0.0, host_spans=None):
    """Log (and keep in SPLITS) a window's spans per iteration: the step's
    host wall and device ms, the CG solve's, the pre-solve's, and the rest
    of the step's. Where the CG loop's graphs ran (`graph_ms`, their time
    by CUDA events), the device ms come from `host_spans`, the same
    iterations on the host loop, whose walls are kept beside
    (``host_*_wall_ms``), and ``cg_event_ms`` is the device loop's own
    measure of the CG solve (the graphs' events and the work the host
    launched in the span)."""
    dev = spans if host_spans is None else host_spans

    def per(table, name, key):
        return table.get(name, {}).get(key, 0.0) / n_iter

    split = {key: round(per(table, name, field), 4)
             for key, table, name, field in (
                 ('step_wall_ms', spans, 'gibbs:step', 'wall_ms'),
                 ('step_device_ms', dev, 'gibbs:step', 'device_ms'),
                 ('cg_wall_ms', spans, 'gibbs:cg_solve', 'wall_ms'),
                 ('cg_device_ms', dev, 'gibbs:cg_solve', 'device_ms'),
                 ('presolve_wall_ms', spans, 'gibbs:cg_presolve', 'wall_ms'),
                 ('presolve_device_ms', dev, 'gibbs:cg_presolve',
                  'device_ms'))}
    split['rest_wall_ms'] = round(split['step_wall_ms']
                                  - split['cg_wall_ms'], 4)
    split['rest_device_ms'] = round(split['step_device_ms']
                                    - split['cg_device_ms'], 4)
    if host_spans is not None:
        split['cg_event_ms'] = round(
            per(spans, 'gibbs:cg_solve', 'device_ms') + graph_ms / n_iter, 4)
        for key, name in (('host_step_wall_ms', 'gibbs:step'),
                          ('host_cg_wall_ms', 'gibbs:cg_solve')):
            split[key] = round(per(host_spans, name, 'wall_ms'), 4)
    SPLITS[label] = split
    log(f"[{label}] per iteration: step {split['step_wall_ms']:.2f} ms wall "
        f"/ {split['step_device_ms']:.2f} ms device; CG solve "
        f"{split['cg_wall_ms']:.2f} / {split['cg_device_ms']:.2f}; pre-solve "
        f"{split['presolve_wall_ms']:.2f} / "
        f"{split['presolve_device_ms']:.2f}; the rest of the step "
        f"{split['rest_wall_ms']:.2f} / {split['rest_device_ms']:.2f}"
        + ("" if host_spans is None else
           f"; on the host loop step {split['host_step_wall_ms']:.2f} / CG "
           f"solve {split['host_cg_wall_ms']:.2f} ms wall; the device "
           f"loop's CG solve by CUDA events {split['cg_event_ms']:.2f} ms"))


# The cg_loop phase: CG_K chains a solve, the summary of each backend's
# solve both ways by label.
CG_K = 4
CG_LOOP = {}
CG_SEED = 31
# The kernels line's entries of cg_start and cg_update, filled where the
# slices hold their designs.
CG_RESULTS = {}


def cg_inputs(design, k, seed, lin):
    """The (k, .) inputs of ``ops.cg.host_solve`` / ``device_solve`` at
    the design's full width, made on the card from `seed`: exponential
    weights, prior scales in [0.3, 3] (the intercept's 1e-3), right-hand
    sides X'(w eps), the perturbation, starts, the Jacobi preconditioner,
    and with `lin` the warm start's reductions; the last chain's residual
    starts at 0 (it takes no iteration)."""
    import torch
    n, p = design.shape
    dt, dev = design.dtype, design.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=dt, device=dev)

    w = torch.empty((k, n), dtype=dt, device=dev).exponential_(
        generator=g) * .25 + .05
    pps = torch.rand((k, p), generator=g, dtype=dt, device=dev) * 2.7 + .3
    pps[:, 0] = 1e-3
    z = design.Tdot(rnd(k, n) * w)
    pert, coef = rnd(k, p) * 2, rnd(k, p) * .1
    for v in (z, pert, coef):
        v[-1] = 0
    s = 1 / torch.sqrt(pps ** 2 + design.compute_fisher_diag(w))
    inp = {'z': z, 'pert': pert, 'pps': pps, 's': s, 'w': w, 'coef': coef}
    if lin:
        inp['lin0'] = design.dot(coef)
        inp['warm'] = design.Tdot(w * inp['lin0'])
    return inp


class HostReads:
    """Counts reads from the card to the host (Tensor.cpu, .item,
    .tolist, .numpy, bool/int/float of a CUDA tensor) inside the block."""

    NAMES = ('cpu', 'item', 'tolist', 'numpy', '__bool__', '__int__',
             '__float__')

    def __enter__(self):
        import torch
        self.n, self.saved = 0, {}
        for name in self.NAMES:
            orig = self.saved[name] = getattr(torch.Tensor, name)

            def wrap(t, *args, _orig=orig, **kw):
                if t.device.type == 'cuda':
                    self.n += 1
                return _orig(t, *args, **kw)
            setattr(torch.Tensor, name, wrap)
        return self

    def __exit__(self, *exc):
        import torch
        for name, orig in self.saved.items():
            setattr(torch.Tensor, name, orig)


class ReplayReads(HostReads):
    """:class:`HostReads` that also notes the count at each step-graph
    replay: a read between the first and the last replay of a run would
    be a read inside the run (``replays`` counts them)."""

    def __enter__(self):
        from bayesbridge_tpu_torch.kernels.step_graph import StepGraph
        super().__enter__()
        self.marks, self.orig = [], StepGraph.replay

        def replay(graph, _orig=self.orig):
            self.marks.append(self.n)
            return _orig(graph)
        StepGraph.replay = replay
        return self

    def __exit__(self, *exc):
        from bayesbridge_tpu_torch.kernels.step_graph import StepGraph
        StepGraph.replay = self.orig
        super().__exit__(*exc)

    @property
    def between(self):
        return self.marks[-1] - self.marks[0] if self.marks else 0


def cg_loop_case(design, label):
    """The cg_loop phase on one design: one solve of CG_K chains (chains
    of different iteration counts, one that starts converged) at the
    design's full width both ways, the host-driven loop
    (``ops.cg.host_solve``) and the device loop (``device_solve``: one
    graph launch), with the chain's options (the warm start and the
    linear predictor where the CG operator composes). Checks: the same
    n_cg_iter and convergence, coef and the linear predictor within RTOL
    of max|host| (1e-12 in float64); a rerun's bits with the graph taken
    from the cache and one host read; the launch counters at the
    captured iteration's launches times the card's count of its runs,
    max(n_iter) of the host loop; each chain equal to
    the chain alone bit for bit. Logs each way's wall ms (median of 3;
    the device loop's first call with its capture), the graph pool's
    bytes and the CUDA versions."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.kernels import load_library
    from bayesbridge_tpu_torch.kernels.cg_loop import (
        child_while_error, cuda_versions)
    from bayesbridge_tpu_torch.ops import cg
    lin = design.fused_ne_mode('quad') is None
    inp = cg_inputs(design, CG_K, CG_SEED, lin)
    atol = 1e-5 * np.sqrt(design.shape[1])
    tol = 1e-12 if design.dtype == torch.float64 else RTOL
    assert cg.takes_device_loop(design, design.device), label

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def host():
        return cg.host_solve(design, inp, 500, atol, lin)

    def device(one=inp):
        return cg.device_solve(design, one, 500, atol, lin)

    ref, _ = timed(host)
    before = set(cg._loops_of(design))
    got, first_ms = timed(device)
    (key,) = set(cg._loops_of(design)) - before
    loop = cg._loops_of(design)[key]
    n_iter = ref[2]['n_cg_iter']
    for name in ('n_cg_iter', 'cg_converged'):
        assert np.array_equal(got[2][name], ref[2][name]), (label, name)
    assert n_iter[-1] == 0 and (n_iter[:-1] > 0).all(), (label, n_iter)
    err, scale = max_err([g for g in got[:2] if g is not None],
                         [r for r in ref[:2] if r is not None])
    assert err <= tol * scale, (label, err, scale)
    same = all(g is None or torch.equal(g, r)
               for g, r in zip(got[:2], ref[:2]))
    reset_launch_counts()
    with HostReads() as reads:
        again, _ = timed(device)
    counts = launch_counts()
    assert reads.n == 1, (label, reads.n)
    assert cg._loops_of(design)[key] is loop
    assert all(g is None or torch.equal(g, a)
               for g, a in zip(got[:2], again[:2])), label
    iters = int(n_iter.max())
    assert counts['cg_update'] == iters and counts['cg_start'] == 1, counts
    want = {}
    for rec, times in zip(loop.graph.counts, (1, iters)):
        for counter, name, n in rec:
            cell = want.setdefault((id(counter), name), [counter, name, 0])
            cell[2] += n * times
    for counter, name, n in want.values():
        assert counter[name] == n, (label, name, counter[name], n)
    host_ms = statistics.median(timed(host)[1] for _ in range(3))
    dev_ms = statistics.median(timed(device)[1] for _ in range(3))
    for c in range(CG_K):
        alone = device({k: v[c:c + 1] for k, v in inp.items()})
        assert alone[2]['n_cg_iter'][0] == n_iter[c], (label, c)
        assert all(g is None or torch.equal(a[0], g[c])
                   for g, a in zip(got[:2], alone[:2])), (label, c)
    per_iteration = {}
    for _, name, n in loop.graph.counts[1]:
        per_iteration[name] = per_iteration.get(name, 0) + n
    built, runtime, driver = cuda_versions()
    if not CG_LOOP:
        rc = child_while_error()
        log(f"[{label}] a graph holding a WHILE node as another's child "
            f"graph node: cudaGraphAddChildGraphNode returns {rc} ("
            f"{load_library().lib.bb_error_string(abs(rc)).decode()}); the "
            f"step graph adds its WHILE node to the capture itself")
    CG_LOOP[label] = dict(
        n_cg_iter=n_iter.astype(int).tolist(), host_ms=host_ms,
        device_ms=dev_ms, first_ms=first_ms, pool_bytes=loop.graph.pool_bytes,
        same_bits_as_host=same, rel_err=err / max(scale, 1e-300),
        launches_per_iteration=per_iteration)
    log(f"[{label}] cg_loop: {CG_K} chains, n_cg_iter "
        f"{n_iter.astype(int).tolist()}, host-driven {host_ms:.2f} ms, "
        f"device loop {dev_ms:.2f} ms (first call, its capture included, "
        f"{first_ms:.1f} ms); one host read; the same bits as the host "
        f"loop: {same} (rel err {err / max(scale, 1e-300):.2e}); each "
        f"chain equal to the chain alone bit for bit; the iteration's "
        f"launches {CG_LOOP[label]['launches_per_iteration']}; graph pool "
        f"{loop.graph.pool_bytes / 1e6:.2f} MB; CUDA built {built}, runtime "
        f"{runtime}, driver {driver}, torch {torch.version.cuda}")
    del inp, ref, got, again


def device_ms(fn, reps=10, inner=20):
    """Median of `reps` CUDA-event timings of `inner` back-to-back calls
    of fn() (per call), the stream first held by a spin kernel so that
    the host's launches queue up behind it and the events time the
    device's work alone, not the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# The launches of the update's harness turns (cg_kernel_results), where
# the kernels line reads the three-kernel route's launches (check-only).
CG_TURN_COUNTS = {}


def cg_kernel_results(design, suffix=''):
    """cg_start and cg_update's two routes at one chain's state of the
    design's shape (the main path's: the linear predictor where the CG
    operator composes), against their plain versions from the same state
    (RTOL of max|plain|, 1e-12 in float64), the cluster route equal to the
    three kernels bit for bit. cg_start timed by CUDA events (median of
    10, the device's time: :func:`device_ms`); the update's two routes in
    turns (``baselines.device_loop_turns``) at 1 and CG_K chains; each
    beside its bound (bytes: each input vector read once, each output
    written once, over the HBM rate; operations over the type's rate) and
    the plain version; no PyTorch call computes either. Timing runs CG on
    the diagonal part (out = 0), every call a step. Returns entries
    'cg_start', 'cg_update' (the cluster route) and 'cg_update[three]',
    each with `suffix`."""
    import torch
    from bayesbridge_tpu_torch.baselines.device_loop_turns import (
        cg_update_turns)
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.kernels.cg_loop import (
        CgState, cg_start, cg_start_plain, cg_update, cg_update_plain,
        update_route)
    n, p = design.shape
    lin = design.fused_ne_mode('quad') is None
    dt, dev = design.dtype, design.device
    tol = 1e-12 if dt == torch.float64 else RTOL
    g = torch.Generator(device=dev).manual_seed(CG_SEED)
    names = ('x', 'r', 'p', 'sp', 'b', 's', 'd', 'y', 'rs', 'thresh',
             'atol', 'n_iter', 'running')

    def state():
        st = CgState(1, p, n if lin else 0, dt, dev, maxiter=1 << 30)
        for name in ('x', 'r', 'b') + (('y',) if lin else ()):
            t = getattr(st, name)
            t.copy_(torch.randn(t.shape, generator=g, dtype=dt, device=dev))
        st.s.copy_(torch.rand((1, p), generator=g, dtype=dt, device=dev)
                   + .5)
        st.d.copy_(torch.rand((1, p), generator=g, dtype=dt, device=dev)
                   + .5)
        return st

    def twin(st):
        other = CgState(1, p, n if lin else 0, dt, dev, maxiter=1 << 30)
        for name in names:
            v = getattr(st, name)
            if v is not None:
                getattr(other, name).copy_(v)
        return other

    vecs = ('x', 'r', 'p', 'sp', 'y', 'rs')

    def agree(name, a, b):
        got = [getattr(a, v) for v in vecs if getattr(a, v) is not None]
        ref = [getattr(b, v) for v in vecs if getattr(b, v) is not None]
        err, scale = max_err(got, ref)
        assert err <= tol * scale, (name, err, scale)
        assert torch.equal(a.running, b.running)
        assert torch.equal(a.n_iter, b.n_iter)
        return err

    out = torch.randn((1, p), generator=g, dtype=dt, device=dev)
    t = torch.randn((1, n), generator=g, dtype=dt, device=dev) if lin \
        else None
    st = state()
    plain = twin(st)
    cg_start(st)
    cg_start_plain(plain)
    err_start = agree('cg_start', st, plain)
    assert update_route(st) == 'cluster', (p, dt)
    errs, after = {}, {}
    for route in ('cluster', 'three'):
        a, plain = twin(st), twin(st)
        cg_update(a, out, t, route=route)
        cg_update_plain(plain, out, t)
        errs[route] = agree(f'cg_update[{route}]', a, plain)
        after[route] = a
    assert all(getattr(after['cluster'], v) is None
               or torch.equal(getattr(after['cluster'], v),
                              getattr(after['three'], v))
               for v in vecs + ('n_iter', 'running')), suffix
    item = torch.empty((), dtype=dt).element_size()
    rate = FP64_OPS_PER_S if dt == torch.float64 else F32_OPS_PER_S
    zero_out = torch.zeros_like(out)
    zero_t = None if t is None else torch.zeros_like(t)
    reset_launch_counts()
    turns = {k: cg_update_turns(p, n if lin else 0, dt, k, dev)
             for k in (1, CG_K)}
    for key, v in launch_counts().items():
        CG_TURN_COUNTS[key] = CG_TURN_COUNTS.get(key, 0) + v
    a = state()
    cg_start(a)
    a.thresh.zero_()  # every timed call a step
    start_ms = device_ms(lambda: cg_start(a))
    b = state()
    cg_start(b)
    b.thresh.zero_()
    start_plain = device_ms(lambda: cg_start_plain(b), inner=5)
    update_plain = device_ms(
        lambda: cg_update_plain(b, zero_out, zero_t), inner=5)
    # The update's work a chain: Ap (3 operations an element), p . Ap (2),
    # x, r (2 each), r . r (2), p (2), sp (1); y (2 an element of n).
    rows = {'cg_start': (err_start, start_ms, start_plain, 5 * p, 5 * p,
                         None),
            'cg_update': (errs['cluster'], turns[1]['cluster'],
                          update_plain, 10 * p + (3 * n if lin else 0),
                          14 * p + (2 * n if lin else 0), 'cluster'),
            'cg_update[three]': (errs['three'], turns[1]['three'],
                                 update_plain,
                                 10 * p + (3 * n if lin else 0),
                                 14 * p + (2 * n if lin else 0), 'three')}
    results = {}
    for name, (err, ms, plain_ms, vectors, ops, route) in rows.items():
        bound, by = bound_ms(vectors * item, ops, rate)
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=by, library_ms=None)
        if route is not None:
            res['ms_chains'] = turns[CG_K][route]
            res['bound_ms_chains'] = CG_K * bound
        results[name + suffix] = res
        log(f"  {name}{suffix} ({dt}, p = {p}"
            + (f", n = {n}" if lin else "") + f"): kernel {ms:.4f} ms"
            + ("" if route is None else
               f" ({CG_K} chains {turns[CG_K][route]:.4f} ms)")
            + f", plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}), "
            f"{100 * bound / ms:.1f}% of it; max_abs_err {err:.3e}")
    log(f"  cg_update{suffix} routes in turns (device ms an iteration): "
        f"{json.dumps({k: {r: round(v, 5) for r, v in tu.items()} for k, tu in turns.items()})}"
        f"; the cluster route's bits equal the three kernels'")
    return results


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
    steps = ', '.join(f"{k} {v:.1f} s"
                      for k, v in design.build_seconds.items())
    log(f"[hybrid] design build + transfer: {time.perf_counter() - t0:.1f} "
        f"s (steps: {steps}); X_exact {design.X_exact.dtype} "
        f"{tuple(design.X_exact.shape)}, "
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
        cg_loop_case(m.design, label)
        if label == 'hybrid_composed':
            CG_RESULTS.update(cg_kernel_results(m.design))
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
    # The composed chain's state after its timed iterations, for the
    # draws phase.
    chain_state = stats['hybrid_composed']['chain'][1][
        '_markov_chain_state_raw']
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
    composed = stats['hybrid_composed']
    composed.pop('chain', None)
    composed['state'] = chain_state
    return counts, witness, design, composed


# The draws phase's fixed-tilt grids, 100,000 lanes each: Polya-Gamma at
# these z; tilted stable at these (alpha, tilt), both sides of the
# tilt**alpha < 2 crossover (16 at alpha 0.25 is its edge).
DRAW_LANES = 100_000
PG_GRID = (0.0, 0.1, 1.0, 4.0, 20.0, 40.0)
TS_GRID = ((0.25, 16.0),) + tuple((a, t) for a in (0.25, 0.5)
                                  for t in (1e-30, 1e-6, 0.1, 1.0, 100.0,
                                            1e4))
# Floating-point operations the draws' lanes need, counted from
# csrc/polya_gamma.cu and csrc/tilted_stable.cu with a library call (exp,
# log, sin, sqrt, ...) as one operation and Philox's integer work left out:
# the operations side of the draws' bound, with the rounds the lanes took
# (a lower bound). Polya-Gamma: 48 a round (the proposal, the series' first
# terms), 30 a lane (its masses); tilted stable: 46 a divide-and-conquer
# round (Kanter's draw and its test), 80 a double-rejection round (the
# auxiliary proposal and its test), 75 more for its accepting round's final
# proposal, 25 a lane (its method, scale or constants).
DRAW_OPS = {'pg_round': 48, 'pg_lane': 30, 'ts_dc': 46, 'ts_dr': 80,
            'ts_dr_final': 75, 'ts_lane': 25}
# The draws phase's launches off the path (the first tilted-stable design's
# checks), where the kernels line reads them (check-only).
DRAW_COUNTS = {}


def draw_ops(kind, attempts, plan=None):
    """The operations of the lanes' draws (DRAW_OPS) from their rounds
    `attempts` and, for the tilted stable, their `plan` (0: double
    rejection)."""
    att = attempts.double()
    if kind == 'pg':
        return DRAW_OPS['pg_round'] * float(att.sum()) \
            + DRAW_OPS['pg_lane'] * att.numel()
    dr = plan == 0
    return (DRAW_OPS['ts_dc'] * float(att[~dr].sum())
            + DRAW_OPS['ts_dr'] * float(att[dr].sum())
            + DRAW_OPS['ts_dr_final'] * int(dr.sum())
            + DRAW_OPS['ts_lane'] * att.numel())


def pg_moments(z):
    """Closed-form mean and variance of PG(1, z), elementwise (z = 0: 1/4
    and 1/24)."""
    import numpy as np
    z = np.abs(np.asarray(z, np.float64))
    safe = np.where(z < 1e-4, 1.0, z)
    mean = np.where(z < 1e-4, 0.25, np.tanh(safe / 2) / (2 * safe))
    var = np.where(z < 1e-4, 1 / 24, (np.tanh(safe / 2) - (safe / 2)
                                      / np.cosh(safe / 2) ** 2)
                   / (2 * safe ** 3))
    return mean, var


def ts_moments(alpha, tilt):
    """Closed-form mean, variance and Var(r^2) of the standardized
    residual r of the tilted stable with Laplace transform exp(-s^alpha),
    elementwise (its cumulants are alpha (1-alpha)...(m-1-alpha)
    t^(alpha-m), so Var(r^2) = 2 + (2-alpha)(3-alpha) / (alpha (1-alpha))
    t^-alpha)."""
    import numpy as np
    t = np.maximum(np.asarray(tilt, np.float64), np.finfo(np.float32).tiny)
    return alpha * t ** (alpha - 1), alpha * (1 - alpha) * t ** (alpha - 2), \
        2 + (2 - alpha) * (3 - alpha) / (alpha * (1 - alpha)) * t ** -alpha


def draw_check(name, kern, plain, moments, attempts, var_from):
    """A draw of the kernel against its plain version: KS (p > 1e-4), the
    kernel's standardized residuals r = (x - mean) / sd (mean of r within
    6 / sqrt(n); mean of r^2 within 6 of its standard errors of 1 over
    the lanes where `var_from` holds, the standard error from Var(r^2)
    where `moments` gives it, else 10% + 6 / sqrt(n) as in
    tests/test_torch_random.py), and its rounds per lane. Returns (KS
    statistic, KS p, mean and max rounds)."""
    import numpy as np
    from scipy.stats import ks_2samp
    k = kern.double().cpu().numpy().reshape(-1)
    p = plain.double().cpu().numpy().reshape(-1)
    assert np.all(np.isfinite(k)) and np.all(k > 0), name
    ks = ks_2samp(k, p)
    mean, var = moments[:2]
    r = (k - mean) / np.sqrt(var)
    n, n_sel = r.size, max(1, int(var_from.sum()))
    r2 = float(np.mean(r[var_from] ** 2)) if var_from.any() else 1.0
    r2_tol = 6 * np.sqrt(np.mean(moments[2][var_from]) / n_sel) \
        if len(moments) > 2 and var_from.any() else 0.1 + 6 / np.sqrt(n_sel)
    att = attempts.double()
    mean_att, max_att = float(att.mean()), int(attempts.max())
    ok = ks.pvalue > 1e-4 and abs(r.mean()) < 6 / np.sqrt(n) \
        and abs(r2 - 1) < r2_tol
    log(f"  {name}: KS D {ks.statistic:.5f} p {ks.pvalue:.3g}; kernel "
        f"mean residual {r.mean():+.5f} (6/sqrt(n) {6 / np.sqrt(n):.5f}), "
        f"mean r^2 {r2:.4f} (tolerance {r2_tol:.4f}, {n_sel} lanes); "
        f"rounds a lane mean {mean_att:.3f}, max {max_att}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the kernel's draws disagree with "
                             f"the plain version or the closed form")
    return float(ks.statistic), float(ks.pvalue), mean_att, max_att


def draw_kernel_ms(lin_pred, tilt, alpha, gens, calls=20):
    """Device ms per launch of the Polya-Gamma and tilted-stable kernels
    alone, from a profiler trace of `calls` draws of each at the flagship
    shapes, float32 and float64: {('pg' | 'ts', dtype tag): ms}."""
    import shutil
    import tempfile
    import torch
    from bayesbridge_tpu_torch.kernels import draws
    from bayesbridge_tpu_torch.utils.profiling import (
        op_stats_from_trace, trace)
    out = {}
    for dtype, tag, ctype in ((torch.float32, 'float32', 'float'),
                              (torch.float64, 'float64', 'double')):
        z = lin_pred.to(dtype)[None].contiguous()
        t = tilt.to(dtype)[None].contiguous()
        g = gens()
        draws.polya_gamma_draw(g, z)
        draws.tilted_stable_draw(g, alpha, t)
        torch.cuda.synchronize()
        log_dir = tempfile.mkdtemp(prefix='bb-draws-')
        try:
            with trace(log_dir):
                # One untimed pair first: in the smoke (torch 2.11) the
                # trace misses the first launch of its window, every time.
                draws.polya_gamma_draw(g, z)
                draws.tilted_stable_draw(g, alpha, t)
                torch.cuda.synchronize()
                for _ in range(calls):
                    draws.polya_gamma_draw(g, z)
                    draws.tilted_stable_draw(g, alpha, t)
                torch.cuda.synchronize()
            rows = op_stats_from_trace(log_dir, device_only=True)
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        for kind in ('pg', 'ts'):
            kname = {'pg': 'pg_kernel', 'ts': 'ts_regroup_kernel'}[kind]
            row = [r for r in rows if f'{kname}<{ctype}>' in r['name']]
            # The timed calls' launches, and the first pair's where the
            # trace holds it.
            assert row and row[0]['occurrences'] in (calls, calls + 1), \
                (kind, tag, rows)
            out[(kind, tag)] = row[0]['self_us'] / 1e3 \
                / row[0]['occurrences']
    return out


def ts_against_indexed_plain(tilt, alpha, gens, tag, sample=4000):
    """ts_draw's kernel against its plain sweep
    (``draws.tilted_stable_indexed_plain``) on `sample` lanes of one
    launch at `tilt` (1, p), the same key: the plan equal, attempts equal
    on at least 99.9% of the lanes, the values within rtol 1e-4 (float32)
    / 1e-10 (float64) where they are. Returns (share of equal attempts,
    max relative error there, max absolute error there)."""
    import torch
    from bayesbridge_tpu_torch.kernels import draws
    dev = tilt.device
    seeds = [g.initial_seed() for g in gens]
    keys = draws.chain_keys([torch.Generator(device=dev).manual_seed(sd)
                             for sd in seeds], dev)
    att = torch.empty(tilt.shape, dtype=torch.int32, device=dev)
    plan = torch.empty_like(att)
    kern = draws.tilted_stable_draw(gens, alpha, tilt, attempts=att,
                                    plan=plan)
    pick = torch.randperm(tilt.shape[1], generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)[:sample]
    val, p_att, p_plan, _ = draws.tilted_stable_indexed_plain(
        keys, alpha, tilt[:, pick].contiguous(), threads_per_lane=4,
        lanes=pick)
    assert torch.equal(p_plan, plan[:, pick]), tag
    same = p_att == att[:, pick]
    share = float(same.double().mean())
    ref = kern[:, pick][same].double()
    diff = (val[same].double() - ref).abs()
    rel = float((diff / ref.abs().clamp_min(1e-300)).max())
    tol = 1e-4 if tilt.dtype == torch.float32 else 1e-10
    log(f"  ts_draw {tag} against its plain sweep on {sample} lanes: plan "
        f"equal; attempts equal on {100 * share:.2f}%; max rel error "
        f"{rel:.3e} where equal (tolerance {tol:g}), max abs error "
        f"{float(diff.max()):.3e}")
    assert share >= 0.999 and rel <= tol, (tag, share, rel)
    return share, rel, float(diff.max())


def run_draws(design, state):
    """The draws phase on the hybrid slice's stored flagship blocks and
    its composed chain's state: Polya-Gamma draws at its linear predictor
    (n = 100,000) and tilted-stable draws at its (coef / gscale)^2
    (p = 50,000, alpha 0.25), then the fixed-tilt grids at 100,000 lanes,
    in float32 and float64: each kernel against its plain version (KS)
    and the closed form, rounds per lane, capped lanes (none allowed);
    the tilted-stable kernel against its plain sweep on a sample of lanes
    and its first design against the plain rounds (KS); each kernel's ms
    from a profiler trace, the wrapper's by CUDA events and by the host
    clock, against the plain version's; the tilted-stable designs in
    turns (``baselines.device_loop_turns``: the regrouping design from
    each T and the first design, 1 and 4 chains); both draws under
    torch.cuda.set_sync_debug_mode('error').
    Returns {'pg_draw': result, 'ts_draw': result, 'ts_draw[first]':
    result} (float32, the flagship chain's dtype) and a summary."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch.baselines.device_loop_turns import (
        ts_draw_turns)
    from bayesbridge_tpu_torch.kernels import (
        draws, launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.random.polya_gamma import (
        sample_polya_gamma_chains, sample_polya_gamma_plain)
    from bayesbridge_tpu_torch.random.tilted_stable import (
        sample_tilted_stable_chains, sample_tilted_stable_plain)
    dev = torch.device('cuda')
    coef = torch.as_tensor(state['coef'], dtype=torch.float32, device=dev)
    gscale = float(state['global_scale'])
    lin_pred = design.dot(coef)
    tilt_f = (coef[1:] / gscale) ** 2
    alpha = 0.25  # bridge exponent 0.5
    tn = tilt_f.double().cpu().numpy()
    log(f"[draws] flagship state: lin_pred {tuple(lin_pred.shape)} "
        f"(|z| median {float(lin_pred.abs().median()):.3f}, max "
        f"{float(lin_pred.abs().max()):.3f}); tilt (coef/gscale)^2 "
        f"{tuple(tilt_f.shape)}, gscale {gscale:.4g}, tilt quantiles "
        f"(0, .01, .5, .99, 1) "
        f"{np.quantile(tn, [0, .01, .5, .99, 1]).tolist()}, share on "
        f"divide-and-conquer (tilt**alpha < 2) "
        f"{np.mean(np.maximum(tn, 1.1754944e-38) ** alpha < 2):.4f}")
    seed = iter(range(1000, 2000))

    def gens(k=1):
        return [torch.Generator(device=dev).manual_seed(next(seed))
                for _ in range(k)]

    def pg_pair(z):
        att = torch.empty(z.shape, dtype=torch.int32, device=dev)
        kern = draws.polya_gamma_draw(gens(), z, None, attempts=att)
        return kern, sample_polya_gamma_plain(gens(), None, z), att

    def ts_pair(a, t, first=False):
        att = torch.empty(t.shape, dtype=torch.int32, device=dev)
        plan = torch.empty_like(att)
        fn = draws.tilted_stable_draw_first if first \
            else draws.tilted_stable_draw
        kern = fn(gens(), a, t, attempts=att, plan=plan)
        return kern, sample_tilted_stable_plain(gens(), a, t), att, plan

    draws.reset_capped(dev)
    summary, results, flagship = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        z = lin_pred.to(dtype)[None].contiguous()
        t = tilt_f.to(dtype)[None].contiguous()
        zn, tn = z.double().cpu().numpy()[0], t.double().cpu().numpy()[0]
        kern, plain, att = pg_pair(z)
        summary[f'pg flagship {tag}'] = draw_check(
            f"pg_draw flagship {tag}", kern, plain, pg_moments(zn), att,
            np.ones(zn.size, bool))
        flagship[('pg', tag)] = (att, None)
        kern, plain, att, plan = ts_pair(alpha, t)
        summary[f'ts flagship {tag}'] = draw_check(
            f"ts_draw flagship {tag}", kern, plain, ts_moments(alpha, tn),
            att, tn >= 0.1)
        flagship[('ts', tag)] = (att, plan)
        reset_launch_counts()
        kern, plain, att, plan = ts_pair(alpha, t, first=True)
        summary[f'ts first flagship {tag}'] = draw_check(
            f"ts_draw[first] flagship {tag}", kern, plain,
            ts_moments(alpha, tn), att, tn >= 0.1)
        for key, v in launch_counts().items():
            DRAW_COUNTS[key] = DRAW_COUNTS.get(key, 0) + v
        flagship[('ts_first', tag)] = (att, plan)
        summary[f'ts indexed plain {tag}'] = ts_against_indexed_plain(
            t, alpha, gens(), f"flagship {tag}")
        zg = torch.tensor(np.repeat(PG_GRID, DRAW_LANES), dtype=dtype,
                          device=dev)[None]
        kern, plain, att = pg_pair(zg)
        for i, zi in enumerate(PG_GRID):
            sl = slice(i * DRAW_LANES, (i + 1) * DRAW_LANES)
            summary[f'pg z={zi} {tag}'] = draw_check(
                f"pg_draw z={zi} {tag}", kern[:, sl], plain[:, sl],
                pg_moments(np.full(DRAW_LANES, zi)), att[:, sl],
                np.ones(DRAW_LANES, bool))
        for a in (0.25, 0.5):
            grid = [tt for aa, tt in TS_GRID if aa == a]
            tg = torch.tensor(np.repeat(grid, DRAW_LANES), dtype=dtype,
                              device=dev)[None]
            kern, plain, att, _ = ts_pair(a, tg)
            for i, ti in enumerate(grid):
                sl = slice(i * DRAW_LANES, (i + 1) * DRAW_LANES)
                summary[f'ts alpha={a} tilt={ti:g} {tag}'] = draw_check(
                    f"ts_draw alpha={a} tilt={ti:g} {tag}", kern[:, sl],
                    plain[:, sl], ts_moments(a, np.full(DRAW_LANES, ti)),
                    att[:, sl], np.full(DRAW_LANES, ti >= 0.1))
    torch.cuda.synchronize()
    capped = draws.capped_lanes(dev)
    log(f"[draws] capped lanes (Polya-Gamma, tilted stable) over the "
        f"phase's kernel draws: {capped}")
    assert capped == (0, 0), capped

    # The tilted-stable designs in turns at the flagship's tilt, kernels
    # alone on fixed keys: the regrouping design from each T against the
    # first design.
    turns = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        for k in (1, CG_K):
            turns[(tag, k)] = ts_draw_turns(tilt_f.to(dtype), alpha, k)
            log(f"  ts_draw turns, flagship p = {tilt_f.numel()}, {tag}, "
                f"{k} chain(s), device ms a launch: "
                f"{json.dumps({n: round(v, 5) for n, v in turns[(tag, k)].items()})}")

    # Timings at the flagship shapes: each kernel alone from a profiler
    # trace of 20 calls (a call's host work, some 40-90 us, is longer
    # than the Polya-Gamma kernel, so events over back-to-back calls time
    # the host); the wrapper (the key draw and the kernel) by CUDA events
    # and by the host clock, the plain rounds by both (they sync with the
    # host every round).
    kernel_ms = draw_kernel_ms(lin_pred, tilt_f, alpha, gens)
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        rate = FP64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
        z = lin_pred.to(dtype)[None].contiguous()
        t = tilt_f.to(dtype)[None].contiguous()
        g1, g2 = gens(), gens()
        for name, kern, plain, x, kind in (
                ('pg_draw', lambda: sample_polya_gamma_chains(g1, None, z),
                 lambda: sample_polya_gamma_plain(g2, None, z), z, 'pg'),
                ('ts_draw',
                 lambda: sample_tilted_stable_chains(g1, alpha, t),
                 lambda: sample_tilted_stable_plain(g2, alpha, t), t,
                 'ts')):
            ms = time_ms(kern, reps=10, inner=10)
            plain_ms = time_ms(plain, reps=3)
            walls = []
            for fn, reps in ((kern, 20), (plain, 3)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3 / reps)
            rows = [(name, kind, kernel_ms[(kind, tag)])]
            if kind == 'ts':
                auto = turns[(tag, 1)]['auto']
                path = f'R={auto}'
                rows = [(name, kind, turns[(tag, 1)][path]),
                        ('ts_draw[first]', 'ts_first',
                         turns[(tag, 1)]['first'])]
            for row_name, key, k_ms in rows:
                att, plan = flagship[(key, tag)]
                ops = draw_ops(kind, att, plan)
                bound, by = bound_ms(2 * nbytes(x) + 8, ops, rate)
                sm = summary[{'pg': 'pg flagship', 'ts': 'ts flagship',
                              'ts_first': 'ts first flagship'}[key]
                             + f' {tag}']
                log(f"  {row_name} {tag} at {tuple(x.shape)}: kernel "
                    f"{k_ms:.4f} ms ("
                    + ("profiler" if kind == 'pg' else
                       "events, in turns" if key == 'ts_first' else
                       f"events, in turns ({path}); profiler "
                       f"{kernel_ms[('ts', tag)]:.4f} ms")
                    + f"); wrapper {ms:.4f} ms "
                    f"(events), {walls[0]:.4f} ms (host clock, 20 calls); "
                    f"plain {plain_ms:.2f} ms (events), {walls[1]:.2f} ms "
                    f"(host clock); bound {bound:.5f} ms ({by}: "
                    f"{ops:.4g} operations at {rate / 1e12:g} TFLOP/s, "
                    f"{100 * bound / k_ms:.2f}% of the kernel); rounds a "
                    f"lane mean {sm[2]:.3f}, max {sm[3]}")
                if dtype == torch.float32:
                    results[row_name] = dict(
                        max_abs_err=sm[0], ms=k_ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, library_ms=None,
                        wrapper_ms=ms, wall_ms=walls[0],
                        plain_wall_ms=walls[1], rounds_mean=sm[2],
                        rounds_max=sm[3])
                    if row_name == 'ts_draw':
                        results[row_name]['threads_per_lane'] = auto

    # No host sync in either draw, through the dispatch points the chain
    # step calls.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        sample_polya_gamma_chains(gens(), None, lin_pred[None])
        sample_tilted_stable_chains(gens(), alpha, tilt_f[None])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[draws] both draws ran under torch.cuda.set_sync_debug_mode("
        "'error')")
    return results, {k: [round(x, 5) for x in v[:3]] + list(v[3:])
                     for k, v in summary.items()}


INT4_NAMES = {'rows': 'ne_rows_i4', 'cols': 'colpass_i4',
              'tdots4': 'tdots_i4', 'tdots5': 'tdots_i4[u4]',
              'tdots4bin': 'tdots_i4[bin]', 'tdots5bin': 'tdots_i4[u4,bin]'}


def int4_modes(Xe, Xf, pe, pf, gen, binary=False):
    """{mode: (kernel, plain version)} of the row pass, the column pass
    and the pre-solve with four and five reductions (with `binary`, for a
    0/1 block, also the pre-solve's binary mode), each a function of the
    first block X0 (beside Xf where given) returning its outputs as a
    list, on fresh random operands."""
    import torch
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        colpass, colpass_plain, ne_rows, ne_rows_plain)
    from bayesbridge_tpu_torch.kernels import layout
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_plain)
    n = Xe.shape[0]
    two = Xf is not None
    ps = [pe, pf] if two else [pe]
    vs = [torch.randn(p, generator=gen, device='cuda') for p in ps]
    c = torch.randn(n, generator=gen, device='cuda')
    us = [torch.randn(n, generator=gen, device='cuda') for _ in range(4)]

    def blocks(X0):
        return [X0, Xf] if two else [X0]

    def flat(r):
        return [o for blk in r for o in blk]
    modes = {
        'rows': (lambda X0: [ne_rows(list(zip(blocks(X0), vs)), c)],
                 lambda X0: [ne_rows_plain(list(zip(blocks(X0), vs)), c)]),
        'cols': (lambda X0: colpass(blocks(X0), ps, us[0]),
                 lambda X0: colpass_plain(blocks(X0), ps, us[0])),
    }
    for k in (4, 5):
        u = us[:k - 1]
        for bin_mode in ((False, True) if binary else (False,)):
            mode = f'tdots{k}' + ('bin' if bin_mode else '')
            # Over the int8 block, the same call is the int8 mode.
            modes[mode] = (
                lambda X0, u=u, b=bin_mode: flat(tdots_sweep(
                    blocks(X0), ps, *u, binary=b and layout.is_int4(X0))),
                lambda X0, u=u: flat(tdots_sweep_plain(blocks(X0), ps, *u)))
    return modes


def same_bits(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def int4_kernel_checks(design):
    """The int4 phase's kernel checks: (a) each nibble mode against its
    plain version (rtol RTOL of max|plain|) at ragged small shapes (values
    in [-8, 7], and 0/1 blocks whose pre-solve also runs its binary mode;
    logical widths not a multiple of 32, one and two blocks, random bits
    in the padding nibbles) and on the flagship's stored 0/1 int8 block
    packed on the card (the pre-solve in both modes), each call rerun for
    the same bits; (b) against the int8 mode on the same values, bit for
    bit; (c) timed in turns with the int8 mode (int8, int4, int4, int8;
    CUDA events, median of 10 each) beside the bound (bytes over 3,350
    GB/s or float32 operations over 67 TFLOP/s, the larger) and the plain
    version. The pre-solve's non-binary mode does the same loads and
    arithmetic on any values; its times on a [-8, 7] block of the
    flagship's shape, and those of the first nibble design, come from
    ``baselines/presolve_i4_variants.py``. No PyTorch call multiplies
    packed int4 by float32: no library time. Returns (the kernels line's
    results, the int4 design, the launch counts of these checks)."""
    import torch
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, layout, reset_launch_counts)
    gen = torch.Generator(device='cuda').manual_seed(13)
    reset_launch_counts()
    for n, pe, pf, binary in ((1037, 4097, 513, False),
                              (1037, 45, 0, False),
                              (3001, 8191, 100, False),
                              (1045, 4097, 513, True), (1045, 45, 0, True),
                              (2999, 8191, 100, True)):
        w = layout.padded_width(pe, int4=True)
        if binary:
            X8 = (torch.rand((n, w), generator=gen, device='cuda')
                  < 0.2).to(torch.int8)
        else:
            X8 = torch.randint(-8, 8, (n, w), generator=gen, device='cuda',
                               dtype=torch.int8)
        X4 = layout.pack_int4(X8)  # padding nibbles random
        X8[:, pe:] = torch.randint(-100, 100, (n, X8.shape[1] - pe),
                                   generator=gen, device='cuda',
                                   dtype=torch.int8)
        Xf = random_block('f32', n, pf, layout.padded_width(pf), gen) \
            if pf else None
        log(f"[int4] nibble modes, ragged n={n} p_int4={pe} p_f32={pf} "
            f"({'0/1' if binary else '[-8, 7]'} values; padding holds "
            f"garbage)")
        for mode, (kern, plain) in int4_modes(X4, Xf, pe, pf, gen,
                                              binary).items():
            got, again, ref = kern(X4), kern(X4), plain(X4)
            i8 = kern(X8)
            torch.cuda.synchronize()
            check(f"{INT4_NAMES[mode]} (n={n}, p={pe}+{pf})", got, ref)
            assert same_bits(got, again), (mode, 'rerun')
            assert same_bits(got, i8), (mode, 'int8 bits')
        log("  reruns give the same bits; every mode equals the int8 mode "
            "on the same values bit for bit")

    # The flagship's stored 0/1 int8 block, packed on the card.
    t0 = time.perf_counter()
    d4 = design.with_policy('auto').with_exact_tier('int4')
    torch.cuda.synchronize()
    Xe8, Xe4, Xf = design.X_exact, d4.X_exact, design.X_float
    pe, pf = design.n_exact, design.n_float
    for i in range(0, Xe8.shape[0], 8192):
        assert torch.equal(layout.unpack_int4(Xe4[i:i + 8192], pe),
                           Xe8[i:i + 8192, :pe])
    gb4 = nbytes(Xe4, Xf) / 1e9
    log(f"[int4] flagship block packed on the card in "
        f"{time.perf_counter() - t0:.2f} s: {tuple(Xe8.shape)} int8 -> "
        f"{tuple(Xe4.shape)} uint8 (unpacks to the int8 block exactly); "
        f"{gb4:.4f} GB with the f32 block against "
        f"{nbytes(Xe8, Xf) / 1e9:.4f} GB; the design takes the binary "
        f"pre-solve: {d4.int4_binary}")
    assert d4.int4_binary
    n_elem = N_OBS * (pe + pf)
    vec, row = 4 * (pe + pf), 4 * N_OBS
    work = {'rows': (vec + row, 2 * n_elem), 'cols': (vec + row, 2 * n_elem),
            'tdots4': (4 * vec + 3 * row, 9 * n_elem),
            'tdots5': (5 * vec + 4 * row, 11 * n_elem)}
    results = {}
    for mode, (kern, plain) in int4_modes(Xe4, Xf, pe, pf, gen,
                                          binary=True).items():
        name = INT4_NAMES[mode]
        got, again, ref, i8 = kern(Xe4), kern(Xe4), plain(Xe4), kern(Xe8)
        torch.cuda.synchronize()
        err = check(f"{name} (flagship)", got, ref)
        assert same_bits(got, again), (mode, 'rerun')
        assert same_bits(got, i8), (mode, 'int8 bits')
        del got, again, ref, i8
        turns = [time_ms(lambda X=X: kern(X))
                 for X in (Xe8, Xe4, Xe4, Xe8)]
        ms, ms8 = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        plain_ms = time_ms(lambda: plain(Xe4), reps=3)
        extra, ops = work[mode.replace('bin', '')]
        bound, by = bound_ms(gb4 * 1e9 + extra, ops)
        bound8 = bound_ms(nbytes(Xe8, Xf) + extra, ops)[0]
        log(f"  {name}: in turns (int8, int4, int4, int8) "
            f"{[round(t, 3) for t in turns]} ms: int4 {ms:.3f} ms "
            f"({100 * bound / ms:.0f}% of its bound {bound:.3f} ms, {by}), "
            f"int8 {ms8:.3f} ms ({100 * bound8 / ms8:.0f}% of "
            f"{bound8:.3f}); plain {plain_ms:.3f} ms; rerun bits and the "
            f"int8 mode's bits equal")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=None,
                             int8_ms=ms8)
    torch.cuda.synchronize()
    return results, d4, launch_counts()


def run_int4(design, outcome, int8_auto):
    """The int4 phase, after the hybrid slices, on their stored blocks
    with ``BB_HYBRID_INT4=1``: the kernel checks (int4_kernel_checks),
    then (d) the logit chain on the packed design under 'auto' (MAP search
    composed: no fused sweep over int4) through run_chain (gibbs(10) +
    gibbs_resume(10), the exact-resume check, a profiler window) beside
    the int8 'auto' slice's device ms (another chain, at another
    iteration), and gibbs(5) against the int8 design under '0' (composed
    everywhere, as 'auto' is over int4: the same bits), then a profiler
    window over the same 3 further iterations of that chain on each
    storage (the same work); (e) the public constructor at a small size, which picks
    int4 under 'auto' and int8 under '1'; (f) 2 chains against the chains
    alone. Returns (kernel results, {path: launch counts}, summary)."""
    import os
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel)
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.models import LogisticModel
    from bayesbridge_tpu_torch.utils.simulate_data import (
        simulate_design, simulate_outcome)
    before = os.environ.get('BB_HYBRID_INT4')
    os.environ['BB_HYBRID_INT4'] = '1'
    try:
        results, d4, check_counts = int4_kernel_checks(design)
        counts = {'int4_checks': check_counts}
        label = 'hybrid_int4'
        model = LogisticModel(*outcome, d4)
        gb = d4.storage_bytes() / 1e9
        assert d4.fused_ne_mode('link') is None \
            and d4.fused_ne_mode('quad') is None
        c, n_cg, info, st = run_chain(
            model, label, lambda k: (2 * k + 2) * gb * 1e9, n_first=10,
            n_more=10)
        counts[label] = c
        n_cg_sum = int(np.sum(n_cg))
        # No int8 pass, no fused sweep: the MAP search composes on int4.
        assert all(c[k] == 0 for k in (
            'ne_sweep[rows]', 'ne_sweep[cols]', 'tdots_sweep[u4]',
            'ne_oneread', 'ne_oneread[logit]', 'ne_sweep[logit]')), c
        assert c['ne_rows_i4'] >= n_cg_sum and c['colpass_i4'] >= n_cg_sum, c
        # The flagship's exact block is 0/1: the binary pre-solve.
        assert c['tdots_i4[u4,bin]'] == 10 and c['tdots_i4[u4]'] == 0, c
        cg_loop_case(d4, label)
        dev = 'not measured' if st['dev_ms'] is None or \
            int8_auto['dev_ms'] is None else \
            f"{st['dev_ms']:.2f} against {int8_auto['dev_ms']:.2f} " \
            f"({100 * (st['dev_ms'] / int8_auto['dev_ms'] - 1):+.1f}%)"
        log(f"[{label}] device ms per iteration, int4 'auto' against the "
            f"int8 'auto' slice in this run: {dev}; steady iter/s "
            f"{st['ips']:.4f} against {int8_auto['ips']:.4f}; mean CG "
            f"iterations {st['mean_cg']:.2f} against "
            f"{int8_auto['mean_cg']:.2f}; {gb:.3f} GB stored")

        # The int8 design composed everywhere: the same draws. Then the
        # same 3 iterations of that one chain (equal bits, so equal CG
        # iterations) profiled on each storage.
        kw = dict(seed=5, coef_sampler_type='cg', params_to_save='all')
        prior = RegressionCoefPrior(bridge_exponent=0.5)
        b4 = BayesBridge(model, prior)
        b8 = BayesBridge(LogisticModel(*outcome, design.with_policy('0')),
                         prior)
        s4, i4 = b4.gibbs(5, **kw)
        s8, i8 = b8.gibbs(5, **kw)
        for key in s4:
            if not np.array_equal(s4[key], s8[key]):
                raise AssertionError(f"[{label}] int4 'auto' != int8 '0' "
                                     f"for {key}")
        log(f"[{label}] gibbs(5) on int4 under 'auto' equals gibbs(5) on "
            f"int8 under '0' bit for bit (n_cg_iter "
            f"{i4['_reg_coef_sampling_info']['n_cg_iter'].astype(int).tolist()})")
        same4 = profile_window(b4, i4, f'{label} same chain')[1]
        same8 = profile_window(b8, i8, "int8 '0' same chain")[1]
        if same4 is not None and same8 is not None:
            log(f"[{label}] the same 3 iterations of one chain: int4 "
                f"{same4:.2f} device ms per iteration against int8 "
                f"{same8:.2f} ({100 * (same4 / same8 - 1):+.1f}%)")
        del b4, b8

        # (f) 2 chains against the chains alone.
        bridge = BayesBridge(model, prior)
        reset_launch_counts()
        chains_against_alone(bridge, overdispersed_inits(model, 2), label,
                             2)
        torch.cuda.synchronize()
        counts['int4_chains'] = cc = launch_counts()
        assert_draws(label + ' chains', cc, 2)
        log(f"[{label}] launch counts of the 2-chain run and the chains "
            f"alone: {cc}")
        assert cc['ne_rows_i4[chains]'] > 0 and cc['colpass_i4[chains]'] \
            > 0 and cc['tdots_i4[u4,bin,chains]'] > 0, cc
        assert cc['ne_rows_k'] == cc['colpass_k'] == 0, cc
        del model, bridge, d4
        torch.cuda.empty_cache()

        # (e) the public constructor at a small size.
        Xs = simulate_design(4000, 600, binary_frac=BINARY_FRAC, seed=7)
        beta = np.zeros(600)
        beta[:10] = 1.0
        ys = simulate_outcome(Xs, beta, 'logit', seed=8)
        tiers = {}
        for fused in ('auto', '1'):
            m = RegressionModel(ys, Xs, family='logit', dtype=np.float32,
                                fused=fused, device='cuda')
            tiers[fused] = str(m.design.X_exact.dtype)
            dense = m.design.toarray()
            v = np.random.default_rng(9).standard_normal(dense.shape[1])
            got = m.design.dot(v).cpu().numpy()
            err = float(np.abs(got - dense @ v).max()
                        / np.abs(dense @ v).max())
            assert err < RTOL, (fused, err)
        log(f"[int4] RegressionModel at 4,000 x 600 with BB_HYBRID_INT4=1: "
            f"'auto' stores {tiers['auto']}, '1' {tiers['1']} (the fused "
            f"CG operator demotes to int8)")
        assert tiers == {'auto': 'torch.uint8', '1': 'torch.int8'}, tiers
    finally:
        if before is None:
            os.environ.pop('BB_HYBRID_INT4', None)
        else:
            os.environ['BB_HYBRID_INT4'] = before
    summary = dict(dev_ms=st['dev_ms'], int8_dev_ms=int8_auto['dev_ms'],
                   same_chain_ms=same4, same_chain_int8_ms=same8,
                   ips=st['ips'], int8_ips=int8_auto['ips'],
                   mean_cg=st['mean_cg'], busy=st['busy'], gb=gb)
    return results, counts, summary


def ab_segments(chains, n_iter=10, rounds=2):
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


def run_packed(X, outcome, backend, m2d, map_ref=None, n_first=15,
               n_more=10):
    """Phases 7 and 8: build, kernel timings at the design's shapes, the
    design on the 2-d phase's (2, 2) grid (``mesh2d_packed``, into `m2d`),
    the chain on the composed path; with `map_ref` (the hybrid's MAP
    witness on the same X), the MAP witness. Returns (kernel results, the
    chain's launch counts, the winell kernel's launch counts on the timing
    phase or None)."""
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
        f"{time.perf_counter() - t0:.1f} s (steps: {steps}); {shapes}; "
        f"{gb:.3f} GB on the device")
    results, pack_counts = packed_kernel_timings(design, X, backend)
    mesh2d_packed(design, backend, m2d)
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
    cg_loop_case(model.design, backend)
    if backend == 'winell':
        CG_RESULTS.update(cg_kernel_results(model.design, '@winell'))
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
    window with the Jacobi preconditioner, then gibbs(5) with the prior
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
    samples, info_p = bridge.gibbs(5, seed=0, coef_sampler_type='cg',
                                   options={'cg_preconditioner': 'prior'},
                                   params_to_save=('coef', 'logp'))
    torch.cuda.synchronize()
    cg_p = info_p['_reg_coef_sampling_info']['n_cg_iter']
    assert np.all(np.isfinite(samples['logp']))
    log(f"[{label}] gibbs(5) with the prior preconditioner: "
        f"{time.perf_counter() - t0:.1f} s, n_cg_iter "
        f"{cg_p.astype(int).tolist()}, mean {cg_p.mean():.2f} against "
        f"{np.mean(n_cg[:5]):.2f} over the first 5 with 'diag'")

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
# Entries of the sharded phase's mesh.
SHARDS = 4
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
    the larger). Each call is made twice on the same inputs, which must
    give the same bits, and its launches per call are logged (one for
    every k up to 8). Returns the kernels line's
    entries at k = 4, the chains of the phase's path."""
    import torch
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
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
        # The launch counter of each kernel, the single-vector one at k = 1.
        counters = {'ne_rows_k': ('ne_rows_k', 'ne_sweep[rows]'),
                    'colpass_k': ('colpass_k', 'ne_sweep[cols]'),
                    'tdots_sweep_k[u4]': ('tdots_sweep_k[u4]',
                                          'tdots_sweep[u4]'),
                    'tdots_sweep_k': ('tdots_sweep_k', 'tdots_sweep')}
        for name, (kern, plain, single, floats, ops) in cases.items():
            reset_launch_counts()
            got = kern()
            per_call = launch_counts()[counters[name][k == 1]]
            again = kern()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} k={k}: a rerun on the same "
                                     f"inputs gave other bits")
            del again
            log(f"  {name} k={k}: {per_call} launch(es) per call; a rerun "
                f"gives the same bits")
            if k > 1 and k <= 8 and per_call != 1:
                raise AssertionError(f"{name} k={k}: {per_call} launches "
                                     f"per call, not one")
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


def chains_against_alone(bridge, inits, label, n_x, seed=3, n_chains=2,
                         mesh=None):
    """Chain c of an `n_chains`-chain CG ``gibbs_chains`` run of `n_x`
    iterations (over `mesh`'s devices where one is given) against the
    chain run alone from its generator (``step.run_chain`` in the
    bridge's dtype): equal CG iteration counts, coef within rtol
    1e-6."""
    import numpy as np
    from bayesbridge_tpu_torch import gibbs_chains
    from bayesbridge_tpu_torch import step as step_mod
    from bayesbridge_tpu_torch.multichain import _stack_chain_inits
    s2, i2 = gibbs_chains(bridge, n_x, n_chains, seed=seed, init=inits,
                          coef_sampler_type='cg', params_to_save=('coef',),
                          mesh=mesh)
    cfg = bridge._step_config(bridge._resolve_options('cg', None))
    bridge.rg.set_seed(seed)
    starts = _stack_chain_inits(bridge, inits, n_chains)
    gens = bridge.rg.spawn(n_chains)
    for i in range(n_chains):
        coef, obs_prec, lscale, gscale = (s[i] for s in starts)
        carry = step_mod.init_carry('cuda', coef, obs_prec, gscale, lscale,
                                    dtype=bridge.dtype)
        _, out = step_mod.run_chain(cfg, bridge.model, gens[i], carry, 0,
                                    n_x, 1, 0, save_keys=('coef',))
        alone = np.stack([v.cpu().numpy() for v in out['coef']], -1)
        diff = float(np.abs(alone - s2['coef'][i]).max())
        np.testing.assert_array_equal(
            i2['_reg_coef_sampling_info']['n_cg_iter'][i], out['n_cg_iter'])
        np.testing.assert_allclose(s2['coef'][i], alone, rtol=1e-6,
                                   atol=1e-7)
        log(f"[{label}] chain {i} of {n_chains} against the chain alone: "
            f"n_cg_iter {out['n_cg_iter']} equal, max |coef diff| "
            f"{diff:.3g}")


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
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.models import LogisticModel
    from bayesbridge_tpu_torch.multichain import gibbs_chains_resume
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
    assert_draws(label, counts[label], n_first)
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
    # for all its running chains (up to 8 per launch; a lone running
    # chain takes the single-vector launch); one
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

    n_x = 3
    chains_against_alone(bridge, inits[:2], label, n_x)

    # The fused policy: the one-read CG operator once per chain per
    # application, the four-reduction pre-solve batched.
    fused = BayesBridge(LogisticModel(*outcome, design.with_policy('1')),
                        RegressionCoefPrior(bridge_exponent=0.5))
    reset_launch_counts()
    s_f, i_f = gibbs_chains(fused, n_x, 2, seed=4, init=inits[:2],
                            coef_sampler_type='cg', params_to_save=('coef',))
    torch.cuda.synchronize()
    counts['multichain_fused'] = cf = launch_counts()
    assert_draws('multichain_fused', cf, n_x)
    n_cg_f = i_f['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}_fused] gibbs_chains({n_x}, 2 chains, fused='1'): "
        f"n_cg_iter {n_cg_f.astype(int).tolist()}; launch counts {cf}")
    assert np.all(np.isfinite(s_f['coef']))
    # Each chain: one application per iteration of the solve (a chain
    # that has stopped rides along until the last one stops: the fused
    # operator launches once per chain) plus the initial residual's per
    # draw.
    ridden = 2 * int(n_cg_f.max(0).sum())
    assert cf['ne_oneread'] == ridden + 2 * n_x, cf
    log(f"[{label}_fused] the one-read CG operator launched {ridden} times "
        f"for {int(n_cg_f.sum())} chain-iterations: "
        f"{ridden - int(n_cg_f.sum())} launches for chains that had "
        f"stopped")
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
    # The batched passes at 2 and 8 chains too, each chain its single
    # launch's bits, timed beside the bound (log only).
    for kk in (2, 8):
        Vk = [torch.randn((kk, q), generator=gen, device='cuda')
              for q in ps]
        ck = torch.randn(kk, generator=gen, device='cuda') * 0.1
        Uk = torch.randn((kk, n), generator=gen, device='cuda')
        bk = list(zip(Xs, Vk))
        T, cols = ne_rows_k(bk, ck), colpass_k(Xs, ps, Uk)
        for i in range(kk):
            if not (torch.equal(T[i], ne_rows([(X, V[i]) for X, V in bk],
                                              ck[i]))
                    and all(torch.equal(g[i], s) for g, s in
                            zip(cols, colpass(Xs, ps, Uk[i])))):
                raise AssertionError(f"[cox] k={kk}: chain {i} differs "
                                     f"from its single-vector launches")
        for name, fn in (('ne_rows_k@cox', lambda: ne_rows_k(bk, ck)),
                         ('colpass_k@cox', lambda: colpass_k(Xs, ps, Uk))):
            ms = time_ms(fn)
            bound, by = bound_ms(x_bytes + 4 * kk * (p + n), 2 * n * p * kk)
            log(f"  {name} k={kk}: {ms:.3f} ms; bound {bound:.3f} ms "
                f"({by}); {100 * bound / ms:.0f}% of the bound; the single "
                f"launches' bits")
        del Vk, Uk, bk, T, cols
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
    assert_draws(label, c, n_first, 'cox')
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
    assert_draws(label, counts[label], 4, 'cox')
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
    assert_draws(label, c, 4)
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
    assert_draws(label, c, 2, 'cox')
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

    # The pre-solve's library time: one torch.matmul X' U over the three
    # linear reductions (the squared-column moment, the fourth, has no
    # one-call counterpart: it reads X once more).
    U = torch.stack(us, 1)

    def matmul():
        return Xm.T @ U
    got = tdots_sweep([X], [p], *us)[0]
    check("torch.matmul X' U vs tdots_sweep@dense's X'u1..u3",
          [matmul().T.contiguous()], [torch.stack(got[:3])])
    results['tdots_sweep@dense']['library_ms'] = time_ms(matmul)
    log(f"  torch.matmul X' [u1 u2 u3] (the pre-solve's three linear "
        f"reductions): {results['tdots_sweep@dense']['library_ms']:.4f} "
        f"ms against tdots_sweep@dense's "
        f"{results['tdots_sweep@dense']['ms']:.4f} ms (four)")
    return results


def run_dense(m2d):
    """Phase 6 (b): dense logit, X standard normal, n = 100,000 and
    p = 4,000 (BASELINE.json configs 0-1's family at the flagship's n),
    made on the card, on one stored X: the Cholesky sampler in float32
    (the default; gibbs(20), 10 resumed iterations timed, the resume
    check, a profiler window), the Gram and the factor timed beside their
    bounds; the Cholesky sampler in float64 (gibbs(10), the float64 Gram
    beside the FP64 tensor-core peak); the CG sampler in float32 under
    fused='1' (the one-read kernel and tdots_sweep on the lone block) and
    under 'auto' (the cuBLAS pair), gibbs(20) each; each kernel on the
    block against its plain version; the design on the 2-d phase's (2, 2)
    grid (``mesh2d_backend``, into `m2d`). Returns ({path: launch counts},
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
    # The 2-d phase: the design's stored columns on the (2, 2) grid, the
    # float32 Gram among its products.
    sd = mesh2d_backend('mesh2d_dense', design, RTOL, m2d, gram=True)
    del sd
    torch.cuda.empty_cache()

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
    assert_draws('dense f64', c64, 10)
    assert s64['coef'].dtype == np.float64 and np.all(
        np.isfinite(s64['logp'])), s64['logp']
    # A float64 dense design reaches no product kernel, only the draws.
    assert not any(n for k, n in c64.items()
                   if k not in ('pg_draw', 'ts_draw')), c64
    log(f"[dense_cholesky_f64] gibbs(10) incl. MAP search: "
        f"{time.perf_counter() - t1:.1f} s; mean coef[1:11] "
        f"{s64['coef'][1:11].mean():.4f}; no product kernel launched, "
        f"draws {c64['pg_draw']} pg_draw, {c64['ts_draw']} ts_draw")
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
        assert_draws(label, c, 20)
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
        profile_window(bridge, i, label)
        cg_loop_case(m.design, label)
        del bridge, m
    del model, design
    torch.cuda.empty_cache()
    return counts, results


ELL_KS = (1, 2, 4, 8)  # vectors per ell_matvec_k launch in the checks


def ell_kernel_checks(design, X):
    """``ell_matvec_k`` on the ell design's row-ELL (X v, tag 'dot') and
    col-ELL (X' u and the Fisher moments, tag 'tdot', through the design's
    layout: the windowed traversal where ``takes_window`` says so), power 1
    and 2, k = 1, 2, 4, 8 vectors a launch, against its plain version
    (rtol 1e-12 of max|plain| in float64, 1e-4 in float32), each vector
    bit for bit its single launch, each call made twice for the same bits;
    every traversal gives the same bits for every k (the first one, the
    col-ELL's windowed one and the row-ELL's staged one, each launched
    directly where the dispatch does not take it), and each launch
    advances its own counter. CUDA-event times of each traversal for each
    k beside its bound, in turns on the row-ELL (first, staged, staged,
    first), at k = 1 of the plain version and of cuSPARSE
    (``torch.sparse_csr_tensor`` of X and of X', the design's dtype,
    ``torch.mv``; checked against the kernel), and at k = 2, 4, 8 of
    cuSPARSE on the k vectors (``torch.sparse.mm``). Returns {name: result
    dict}: 'ell[dot]', 'ell[tdot]' (the first traversal on the col-ELL),
    'ell[tdot_win]' (the windowed one) at k = 1, power 1, and
    'ell[dot_st]' (the staged one) at k = MC_CHAINS, the chains' launch,
    with '@f32' for a float32 design."""
    import torch
    from bayesbridge_tpu_torch.kernels import launch_counts, load_library
    from bayesbridge_tpu_torch.kernels.ell import (
        ell_matvec_k, ell_matvec_k_plain, stage_launch, stage_plan,
        takes_stage, win_launch, win_plan)
    f64 = design.dtype == torch.float64
    rtol = 1e-12 if f64 else RTOL
    item = 8 if f64 else 4
    rate = FP64_OPS_PER_S if f64 else F32_OPS_PER_S
    suffix = '' if f64 else '@f32'
    gen = torch.Generator(device='cuda').manual_seed(11)
    A, At = device_csr_pair(X, dtype='float64' if f64 else 'float32')
    lay = design.col_layout
    assert lay.ascending and lay.win_ptr is not None, \
        "the col-ELL has no window pointers"
    taken = [k for k in range(1, 9) if lay.windowed(design.dtype, k)]
    assert 1 in taken, "one vector does not take the windowed traversal"
    kl = load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def windowed(V, power):  # the windowed traversal, uncounted
        out = torch.empty((V.shape[0], lay.valid.shape[0]),
                          dtype=V.dtype, device='cuda')
        return win_launch(kl, design.col_idx, design.col_val, lay, V, power,
                          out)

    def first(idx, val, V, power):  # the first traversal, uncounted
        m, width = idx.shape
        out = torch.empty((V.shape[0], m), dtype=V.dtype, device='cuda')
        Vt = V.t().contiguous()
        kl.check(kl.lib.bb_ell(idx.data_ptr(), val.data_ptr(), m, width,
                               Vt.data_ptr(), V.shape[0], power, int(f64),
                               out.data_ptr(), stream), 'bb_ell')
        return out

    def staged(idx, val, V, power):  # the staged traversal, uncounted
        out = torch.empty((V.shape[0], idx.shape[0]), dtype=V.dtype,
                          device='cuda')
        return stage_launch(kl, idx, val, V, power, out, stage_plan(
            design.dtype, V.shape[0], V.shape[1]))

    results = {}
    for tag, idx, val, mat, layout in (
            ('dot', design.row_idx, design.row_val, A, None),
            ('tdot', design.col_idx, design.col_val, At, lay)):
        m, width = idx.shape
        n_in = mat.shape[1]
        assert tuple(mat.shape) == (m, n_in)
        name = f'ell[{tag}]{suffix}'
        # the row-ELL's staged traversal at every k (the dispatch takes it
        # where takes_stage says so)
        plans = {k: stage_plan(design.dtype, k, n_in)
                 for k in ELL_KS} if layout is None else {}
        V = torch.randn((max(ELL_KS), n_in), generator=gen, device='cuda',
                        dtype=design.dtype)
        errs, picked = {}, {}
        for power in (1, 2):
            for k in ELL_KS:
                before = launch_counts()
                got = ell_matvec_k(idx, val, V[:k], power, tag, layout)
                delta = {key: n - before[key]
                         for key, n in launch_counts().items()}
                if layout is not None and layout.windowed(design.dtype, k):
                    key = f'ell[{tag}_win]'
                elif takes_stage(design.dtype, k, n_in):
                    key = f'ell[{tag}_st]'
                else:
                    key = f'ell[{tag}]'
                picked[k] = key
                assert delta[key] == 1 and sum(delta.values()) == 1, \
                    (name, k, delta)
                again = ell_matvec_k(idx, val, V[:k], power, tag, layout)
                ref = ell_matvec_k_plain(idx, val, V[:k], power)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                errs[power, k] = err
                if not err <= rtol * scale:
                    raise AssertionError(
                        f"{name} power {power} k {k}: kernel disagrees with "
                        f"its plain version: {err:.3e} of {scale:.3e}, "
                        f"beyond rtol {rtol}")
                assert torch.equal(got, again), \
                    f"{name} power {power} k {k} is not deterministic"
                for c in range(k):
                    assert torch.equal(got[c], ell_matvec_k(
                        idx, val, V[c], power, tag, layout)), \
                        f"{name} power {power}: vector {c} of {k} differs " \
                        f"from its single launch"
                # The first traversal: on the col-ELL through the wrapper
                # without the layout (counted; its inputs are never
                # staged), on the row-ELL launched directly.
                once = ell_matvec_k(idx, val, V[:k], power, tag) \
                    if layout is not None else first(idx, val, V[:k], power)
                assert torch.equal(once, got), \
                    f"{name} power {power} k {k}: the first traversal differs"
                if layout is not None:
                    assert torch.equal(windowed(V[:k], power), got), \
                        f"{name} power {power} k {k}: the traversals differ"
                if k in plans:
                    once = staged(idx, val, V[:k], power)
                    assert torch.equal(once, got) and torch.equal(
                        staged(idx, val, V[:k], power), once), \
                        f"{name} power {power} k {k}: the staged traversal " \
                        f"differs"
                del got, again, ref
        shares = [round(p['staged'], 3) for p in plans.values()]
        log(f"  {name} ({m} x {width} ELL, {design.dtype}): max_abs_err "
            f"against the plain version, power 1 / 2 at k = "
            f"{'/'.join(map(str, ELL_KS))}: "
            f"{[f'{errs[1, k]:.2e}' for k in ELL_KS]} / "
            f"{[f'{errs[2, k]:.2e}' for k in ELL_KS]} (rtol {rtol} of "
            f"max|plain|); every vector its single launch's bits, every "
            f"call's rerun the same bits; the dispatch's traversal at k = "
            f"{'/'.join(map(str, ELL_KS))}: {[picked[k] for k in ELL_KS]}, "
            f"every other traversal its bits"
            + (f" (the windowed one taken at k in {taken}, takes_window)"
               if layout is not None else '')
            + (f"; the staged traversal's stage holds {shares} of the "
               f"vectors" if plans else ''))
        v = V[0].contiguous()
        check(f"{name}: cuSPARSE vs the kernel", [torch.mv(mat, v)],
              [ell_matvec_k(idx, val, v, 1, tag, layout)])
        nnz = mat._nnz()
        traversals = {name: lambda Vk: first(idx, val, Vk, 1)}
        if layout is not None:
            traversals[f'ell[tdot_win]{suffix}'] = \
                lambda Vk: windowed(Vk, 1)
        if plans:
            traversals[f'ell[dot_st]{suffix}'] = \
                lambda Vk: staged(idx, val, Vk, 1)
        entries = {}
        for k in ELL_KS:
            Vk = V[:k]
            names = list(traversals)
            turns = {}
            for label in names + names[::-1]:  # in turns
                turns.setdefault(label, []).append(time_ms(
                    lambda fn=traversals[label]: fn(Vk), inner=20))
            lib_k = None
            if k > 1:
                # cuSPARSE on k vectors at once (the same function as
                # one launch of k), checked against the kernel.
                VkT = Vk.T.contiguous()
                check(f"{name}: cuSPARSE on {k} vectors vs the kernel",
                      [torch.sparse.mm(mat, VkT).T], [first(idx, val, Vk, 1)])
                lib_k = time_ms(lambda: torch.sparse.mm(mat, VkT), inner=20)
                log(f"  {name} k={k}: cuSPARSE (torch.sparse.mm, "
                    f"{k} columns) {lib_k:.4f} ms")
            for label in names:
                ms = sum(turns[label]) / len(turns[label])
                if label.startswith('ell[tdot_win]'):
                    # the valid slots and the window pointers it reads
                    plan = win_plan(design.dtype, k, m, n_in,
                                    *lay.card(design.dtype, k))
                    work = (lay.n_valid * (4 + item) + 4 * m * plan['n_win']
                            + k * (n_in + m) * item, 2 * k * lay.n_valid)
                else:  # every padded slot
                    work = (nbytes(idx, val) + k * (n_in + m) * item,
                            2 * k * m * width)
                bound, by = bound_ms(*work, ops_per_s=rate)
                taken_by = ' (the dispatch\'s)' if picked[k].replace(
                    ']', ']' + suffix, 1) == label else ''
                log(f"  {label} k={k}: {ms:.4f} ms{taken_by} ({ms / k:.4f} "
                    f"per vector; turns {[round(t, 4) for t in turns[label]]}"
                    f"); bound {bound:.4f} ms ({by}), {bound / ms:.0%} of it; "
                    f"{work[0] / 1e9:.4f} GB at "
                    f"{work[0] / 1e9 / (ms / 1e3):.1f} GB/s of 3350")
                want_k = MC_CHAINS if label.startswith('ell[dot_st]') else 1
                if k == want_k:
                    entries[label] = dict(
                        max_abs_err=errs[1, k], ms=ms, bound_ms=bound,
                        bound_by=by, library_ms=lib_k)
        for label, entry in entries.items():
            k = MC_CHAINS if label.startswith('ell[dot_st]') else 1
            Vk = V[:k] if k > 1 else v
            entry['plain_ms'] = time_ms(
                lambda: ell_matvec_k_plain(idx, val, Vk, 1))
            if k == 1:
                entry['library_ms'] = time_ms(lambda: torch.mv(mat, v),
                                              inner=20)
            # The bound above counts what the traversal reads (the first:
            # every padded slot); this one counts the nonzeros alone, so
            # that the padding's share of the bytes shows beside it.
            nnz_bound, _ = bound_ms(nnz * (4 + item) + k * (n_in + m) * item,
                                    2 * k * nnz, ops_per_s=rate)
            over = 'the valid slots and pointers' \
                if label.startswith('ell[tdot_win]') else 'the padded slots'
            log(f"  {label} k={k}: kernel {entry['ms']:.4f} ms, plain "
                f"{entry['plain_ms']:.3f} ms, cuSPARSE "
                f"{entry['library_ms']:.4f} ms, bound "
                f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}) over "
                f"{over}, {nnz_bound:.4f} ms over the nonzeros alone "
                f"({nnz_bound / entry['ms']:.0%} of the kernel's time); the "
                f"{nbytes(idx, val) / 1e9:.4f} GB ELL arrays hold {nnz} "
                f"nonzeros in {m * width} slots ({card_line()})")
            results[label] = entry
        del V
    del A, At
    torch.cuda.empty_cache()
    return results


def ell_chains(bridge, model):
    """MC_CHAINS float64 chains on the ell design (its single chain's
    bridge, no new build): ``gibbs_chains`` with CG from overdispersed
    starts, the launch counts read right after it (the chain-batched
    row-ELL products on the staged traversal, ``ell[dot_st]``),
    ``gibbs_chains_resume`` timed, the exact-resume check, a profiler
    window (device ms per step of all the chains), then each chain
    against the chain run alone. Returns ({path: launch counts}'s entry,
    summary)."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import gibbs_chains
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.multichain import gibbs_chains_resume
    label, k = 'ell64_chains', MC_CHAINS
    inits = overdispersed_inits(model, k)
    n_first, n_more = 8, 6
    kw = dict(seed=0, init=inits, coef_sampler_type='cg',
              params_to_save=('coef', 'logp'))
    reset_launch_counts()
    t0 = time.perf_counter()
    samples, info = gibbs_chains(bridge, n_first, k, **kw)
    torch.cuda.synchronize()
    c = launch_counts()
    assert_draws(label, c, n_first)
    n_cg = info['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}] gibbs_chains({n_first}, {k} chains): "
        f"{time.perf_counter() - t0:.1f} s; n_cg_iter per chain "
        f"{n_cg.astype(int).tolist()}; launch counts of this path: {c}")
    assert samples['coef'].shape == (k, model.n_pred, n_first)
    assert np.all(np.isfinite(samples['coef']))
    assert np.all(np.isfinite(samples['logp'])), samples['logp']
    # At least one row-ELL product per CG operator application of the
    # running chains, up to 8 chains a launch: the staged traversal where
    # takes_stage gives it the launch, the first one otherwise (a lone
    # running chain's vector fits L1).
    apps = int(n_cg.max(0).sum())
    assert c['ell[dot_st]'] > 0, c
    assert c['ell[dot]'] + c['ell[dot_st]'] >= apps, (apps, c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_more, i_more = gibbs_chains_resume(bridge, info, n_more)
    torch.cuda.synchronize()
    ips = n_more / (time.perf_counter() - t0)
    cg_more = i_more['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}] steady state, {n_more} iterations via "
        f"gibbs_chains_resume: {ips:.4f} iter/s of {k} chains = "
        f"{k * ips:.4f} chain-iterations/s; mean CG iterations per chain "
        f"{np.round(cg_more.mean(1), 2).tolist()}")
    n_a = n_first // 2
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
    chains_against_alone(bridge, inits, label, 3, n_chains=k)
    return c, dict(ips=ips, chain_ips=k * ips, mean_cg=float(cg_more.mean()),
                   busy=busy, dev_ms=dev_ms)


def mesh2d_ell(model, m2d):
    """The ell float64 design on the (2, 2) grid: row-ELL pieces by rows,
    col-ELL pieces by predictors; products within 1e-12 of max of the
    unsharded design's, each row piece's X v and each col-ELL piece's X' u
    and Fisher diagonal launched once (``ell_grid_launches``); ``gibbs(5)`` on the grid (launch counts for the
    kernels line) with each col-ELL piece's traversal logged; the kernel
    timed on a row piece and a col-ELL piece."""
    import copy
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import BayesBridge, RegressionCoefPrior
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    sd = mesh2d_backend('mesh2d_ell', model.design, 1e-12, m2d,
                        ell_grid_launches)
    log(f"[mesh2d_ell] col-ELL pieces' traversal for 1 vector "
        f"{sd.traversals(1)}, for 4 {sd.traversals(4)}")
    grid_model = copy.copy(model)
    grid_model.design = sd
    bridge = BayesBridge(grid_model, RegressionCoefPrior(bridge_exponent=0.5))
    reset_launch_counts()
    t0 = time.perf_counter()
    samples, info = bridge.gibbs(5, seed=0, coef_sampler_type='cg',
                                 params_to_save='all')
    torch.cuda.synchronize()
    m2d['counts']['mesh2d_ell'] = c = launch_counts()
    assert_draws('mesh2d_ell', c, 5)
    n_cg = info['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[mesh2d_ell] gibbs(5) on the grid incl. MAP search: "
        f"{time.perf_counter() - t0:.1f} s; n_cg_iter "
        f"{n_cg.astype(int).tolist()}; launch counts "
        f"{ {k: n for k, n in c.items() if n} }")
    assert np.all(np.isfinite(samples['logp']))
    assert np.all(np.isfinite(samples['coef']))
    assert c['ell[dot]'] >= 2 * int(np.sum(n_cg + 1)), c
    m2d['results'].update(ell_piece_timings(sd))
    del sd, grid_model, bridge
    torch.cuda.empty_cache()


def ell_grid_launches(sd):
    """{product: {counters: launches}} of the ell grid `sd`: X v once a
    row-ELL piece, X' u once a col-ELL piece (up to 8 chains a launch),
    on whichever traversal each launch takes; the Fisher diagonal once a
    col-ELL piece for the squares and, centred, once for the sums."""
    rows, cols = len(sd.local_shards()), len(sd.col_shards)
    dot = ('ell[dot]', 'ell[dot_st]')
    tdot = ('ell[tdot]', 'ell[tdot_win]', 'ell[tdot_st]')
    diag = cols * (1 + int(sd.centered))
    return {'dot': {dot: rows}, 'dot 4 chains': {dot: rows},
            'Tdot': {tdot: cols}, 'Tdot 4 chains': {tdot: cols},
            'quad': {dot: rows, tdot: cols},
            'fisher diag': {tdot: diag}, 'fisher diag 4 chains': {tdot: diag}}


def run_ell(X, outcome, m2d):
    """Phase 9: the ell slice on the 262,144 x 16,384 design. (a) float64
    under ``backend='auto'``, which must pick ell with the JAX package's
    warning: the kernel checks and timings, ``gibbs(20)`` with CG,
    'diag' and bridge exponent 0.5 (launch counts read right after it),
    ``gibbs_resume(10)`` timed, the exact-resume check and a profiler
    window (``run_chain``), MC_CHAINS chains on the same design
    (``ell_chains``: the row-ELL's staged traversal, resume, profiler
    window, each chain against the chain alone), and 5 sweeps of the
    reference-style loop through the public component methods, and the
    design on the 2-d phase's (2, 2) grid (``mesh2d_ell``, into `m2d`);
    (b) the same X in float32 with ``backend='ell'`` forced: the kernel
    checks and timings, then ``gibbs(10)``. Returns (kernel results,
    {path: launch counts})."""
    import warnings
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import (
        BayesBridge, RegressionCoefPrior, RegressionModel)
    from bayesbridge_tpu_torch.baselines.device_loop_turns import (
        ts_draw_turns)
    from bayesbridge_tpu_torch.kernels import (
        draws, launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.random.tilted_stable import (
        sample_tilted_stable_plain)
    counts = {}
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        model = RegressionModel(outcome, X, family='logit',
                                dtype=np.float64, device='cuda')
    torch.cuda.synchronize()
    design = model.design
    said = [str(w.message) for w in caught if '32-bit' in str(w.message)]
    assert design.backend == 'ell', design.backend
    assert said, [str(w.message) for w in caught]
    gb = design.storage_bytes() / 1e9
    log(f"[ell64] backend='auto' in float64 picks '{design.backend}' and "
        f"warns: \"{said[0][:110]}...\"; design build + transfer: "
        f"{time.perf_counter() - t0:.1f} s (host dual ELL "
        f"{design.build_seconds['ell']:.1f} s); row-ELL "
        f"{tuple(design.row_idx.shape)}, col-ELL "
        f"{tuple(design.col_idx.shape)}, {gb:.3f} GB on the device")
    assert design.row_idx.shape[0] == ELL_N
    assert design.row_idx.shape[1] <= SPARSE_PER_ROW
    reset_launch_counts()
    results = ell_kernel_checks(design, X)
    counts['ell64_checks'] = launch_counts()
    dot_b = nbytes(design.row_idx, design.row_val)
    tdot_b = nbytes(design.col_idx, design.col_val)
    n_first = 20
    # Per iteration: dot + Tdot per CG operator application (k + 1), two
    # pre-solve Tdots and the Fisher diagonal's two moments.
    counts['ell64'], n_cg, info, stats = run_chain(
        model, 'ell64', lambda k: (k + 1) * (dot_b + tdot_b) + 4 * tdot_b,
        n_first=n_first, n_more=10)
    c = counts['ell64']
    n_map = info['_init_optim_info']['n_design_matvec'] // 2
    need = int(np.sum(n_cg + 1))
    # One chain: every col-ELL launch serves one vector, on the traversal
    # the dispatch gives k = 1.
    tdot = 'ell[tdot_win]' if design.col_layout.windowed(design.dtype, 1) \
        else 'ell[tdot]'
    assert c['ell[dot]'] >= need + n_map, c
    assert c[tdot] >= need + 4 * n_first + n_map, c
    # Beside the draws and the CG loop's update kernels, every launch is
    # one of the two traversals.
    assert sum(c.values()) - c['pg_draw'] - c['ts_draw'] - c['cg_start'] \
        - c['cg_update'] == c['ell[dot]'] + c[tdot], c
    bridge = stats['chain'][0]
    cg_loop_case(design, 'ell64')
    CG_RESULTS.update(cg_kernel_results(design, '@ell64'))
    counts['ell64_chains'], chains = ell_chains(bridge, model)
    log(f"[ell64_chains] summary: {json.dumps(chains)}")
    errs, traversals = sharded_ell_checks(design)
    log(f"[ell64_sharded] summary: "
        f"{json.dumps(dict(errs=errs, traversals=traversals))}")
    mesh2d_ell(model, m2d)

    # The reference-style loop through the public component methods.
    alpha = bridge.prior.bridge_exp
    bridge.rg.set_seed(7)
    coef = np.zeros(bridge.n_pred)
    gscale, lscale = 0.1, np.ones(bridge.n_pred - bridge.n_unshrunk)
    obs_prec = bridge.initialize_obs_precision({}, coef)
    logp0 = bridge.compute_posterior_logprob(coef, gscale, obs_prec, alpha)
    logps, n_cg_c = [], []
    t0 = time.perf_counter()
    for _ in range(5):
        coef, c_info = bridge.update_regress_coef(coef, obs_prec, gscale,
                                                  lscale, 'cg')
        n_cg_c.append(int(c_info['n_cg_iter']))
        obs_prec = bridge.update_obs_precision(coef)
        shrunk = coef[bridge.n_unshrunk:]
        gscale = bridge.update_global_scale(gscale, shrunk, alpha)
        lscale = bridge.update_local_scale(gscale, shrunk, alpha)
        logps.append(bridge.compute_posterior_logprob(coef, gscale,
                                                      obs_prec, alpha))
    log(f"[ell64] 5 sweeps of the public component updates: "
        f"{time.perf_counter() - t0:.1f} s; n_cg_iter {n_cg_c}; logp at "
        f"the start {logp0:.6g}, then {[f'{x:.6g}' for x in logps]}; "
        f"mean coef[1:11] {coef[1:11].mean():.4f}")
    assert np.all(np.isfinite(logps)) and logps[-1] > logps[0], logps
    # ts_draw at this design's width (p = 16,384) and state: the kernel
    # against its plain sweep in float64, the designs in turns (the
    # starting T is larger at fewer lanes), each beside its bound from the
    # rounds the lanes took at this tilt (one draw through the wrapper)
    # and the plain rounds' time; the float64 chain's entry in the
    # kernels line.
    # The step's tilt, (coef / gscale)^2 at characteristic exponent
    # bridge_exp / 2 (step.update_local_scale).
    tilt = torch.as_tensor((shrunk / gscale) ** 2, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(77)
    _, _, ts_err = ts_against_indexed_plain(
        tilt[None], alpha / 2, [gen], f"ell64 p = {tilt.numel()} float64")
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split('.')[-1]
        rate = FP64_OPS_PER_S if dtype == torch.float64 else F32_OPS_PER_S
        x = tilt.to(dtype)[None].contiguous()
        att = torch.empty(x.shape, dtype=torch.int32, device='cuda')
        plan = torch.empty_like(att)
        draws.tilted_stable_draw(
            [torch.Generator(device='cuda').manual_seed(78)], alpha / 2, x,
            attempts=att, plan=plan)
        ops = draw_ops('ts', att, plan)
        bound, by = bound_ms(2 * nbytes(x) + 8, ops, rate)
        rounds_mean, rounds_max = float(att.double().mean()), int(att.max())
        g_plain = [torch.Generator(device='cuda').manual_seed(79)]
        plain_ms = time_ms(
            lambda: sample_tilted_stable_plain(g_plain, alpha / 2, x),
            reps=3)
        for k in (1, CG_K):
            turns = ts_draw_turns(x[0], alpha / 2, k)
            auto = turns['auto']
            log(f"  ts_draw turns, ell p = {tilt.numel()}, {tag}, {k} "
                f"chain(s), device ms a launch: "
                f"{json.dumps({n: round(v, 5) for n, v in turns.items()})}")
            if k > 1:
                continue
            ms = turns[f'R={auto}']
            log(f"  ts_draw@ell64 {tag} at {tuple(x.shape)}: kernel "
                f"{ms:.4f} ms (events, in turns, R={auto}), first design "
                f"{turns['first']:.4f} ms; plain {plain_ms:.2f} ms; bound "
                f"{bound:.6f} ms ({by}: {ops:.4g} operations at "
                f"{rate / 1e12:g} TFLOP/s, {100 * bound / ms:.2f}% of the "
                f"kernel; bytes {nbytes(x) * 2 / HBM_BYTES_PER_S * 1e3:.6f} "
                f"ms); rounds a lane mean {rounds_mean:.3f}, max "
                f"{rounds_max}")
            if dtype == torch.float64:
                results['ts_draw@ell64'] = dict(
                    max_abs_err=ts_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None,
                    first_ms=turns['first'], threads_per_lane=auto,
                    rounds_mean=rounds_mean, rounds_max=rounds_max)
    del model, design, bridge, stats, info
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = RegressionModel(outcome, X, family='logit', dtype=np.float32,
                            backend='ell', device='cuda')
    torch.cuda.synchronize()
    design = model.design
    log(f"[ell32] backend='ell' in float32: design build + transfer "
        f"{time.perf_counter() - t0:.1f} s (host dual ELL "
        f"{design.build_seconds['ell']:.1f} s); "
        f"{design.storage_bytes() / 1e9:.3f} GB on the device")
    reset_launch_counts()
    results.update(ell_kernel_checks(design, X))
    counts['ell32_checks'] = launch_counts()
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))
    reset_launch_counts()
    t0 = time.perf_counter()
    samples, info32 = bridge.gibbs(10, seed=0, coef_sampler_type='cg',
                                   params_to_save='all')
    torch.cuda.synchronize()
    counts['ell32'] = c = launch_counts()
    assert_draws('ell32', c, 10)
    n_cg = info32['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[ell32] gibbs(10) incl. MAP search: "
        f"{time.perf_counter() - t0:.1f} s; dtype {samples['coef'].dtype}; "
        f"MAP {info32['_init_optim_info']}; n_cg_iter "
        f"{n_cg.astype(int).tolist()}; mean coef[1:11] "
        f"{samples['coef'][1:11].mean():.4f}; launch counts {c}")
    assert samples['coef'].dtype == np.float32
    assert np.all(np.isfinite(samples['coef']))
    assert np.all(np.isfinite(samples['logp']))
    tdot = 'ell[tdot_win]' if design.col_layout.windowed(design.dtype, 1) \
        else 'ell[tdot]'
    assert c['ell[dot]'] >= int(np.sum(n_cg + 1)), c
    assert c[tdot] >= int(np.sum(n_cg + 1)) + 4 * 10, c
    # Beside the draws and the CG loop's update kernels, every launch is
    # one of the two traversals.
    assert sum(c.values()) - c['pg_draw'] - c['ts_draw'] - c['cg_start'] \
        - c['cg_update'] == c['ell[dot]'] + c[tdot], c
    cg_loop_case(design, 'ell32')
    del model, design, bridge
    torch.cuda.empty_cache()
    return results, counts


def sharded_mesh():
    """The 4-entry mesh of the sharded phase: four cards where the machine
    has them, else four shards on card 0 (row views of its blocks)."""
    import torch
    from bayesbridge_tpu_torch.parallel import make_mesh
    if torch.cuda.device_count() >= SHARDS:
        devices = [torch.device('cuda', i) for i in range(SHARDS)]
        how = f'{SHARDS} cards'
    else:
        devices = [torch.device('cuda', 0)] * SHARDS
        how = (f'one card: [cuda:0] * {SHARDS}, each shard a row view of '
               f'the stored blocks')
    log(f"[sharded] mesh of {SHARDS} on {how}")
    return make_mesh(devices=devices)


def rel_err(got, ref):
    """max |got - ref| / max |ref| in float64, over matching tensors."""
    err = max(float((g.double() - r.double()).abs().max())
              for g, r in zip(got, ref))
    return err / max(float(r.double().abs().max()) for r in ref)


def sharded_checks(label, pairs, tol, launches=None):
    """Each (name, fn) of `pairs` on the unsharded design (fn(False)) and
    the sharded one (fn(True)): the sharded result within `tol` of max
    |unsharded|, the same bits on a rerun (each shard's product again).
    `launches` {name: {counter: launches per call}} are asserted on the
    counts of the first sharded call (a tuple of counters: their sum, one
    launch on whichever traversal the dispatch took). Returns {name:
    relative error}."""
    import torch
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    errs = {}
    for name, fn in pairs:
        ref = as_tuple(fn(False))
        reset_launch_counts()
        got = as_tuple(fn(True))
        torch.cuda.synchronize()
        counts = {k: c for k, c in launch_counts().items() if c}
        same = all(torch.equal(a, b) for a, b in zip(got, as_tuple(fn(True))))
        errs[name] = err = rel_err(got, ref)
        log(f"[{label}] {name}: rel err {err:.3e} (tol {tol:g}); rerun "
            f"{'same bits' if same else 'DIFFERENT BITS'}; launches {counts}")
        assert err <= tol, (name, err)
        assert same, name
        assert_launches(name, counts, (launches or {}).get(name, {}))
    return errs


def assert_launches(name, counts, want):
    """Each {counter (or tuple of counters, summed): launches} of `want`
    holds in `counts`."""
    for counter, n in want.items():
        keys = counter if isinstance(counter, tuple) else (counter,)
        assert sum(counts.get(k, 0) for k in keys) == n, (name, counter,
                                                           counts)


def assert_draws(label, counts, n_iter, family='logit'):
    """Every chain phase draws on the kernels: ``ts_draw`` (the local
    scales) and, for logit, ``pg_draw`` (the observation precisions) at
    least once an iteration."""
    want = {'ts_draw': n_iter}
    if family == 'logit':
        want['pg_draw'] = n_iter
    short = {k: counts[k] for k, n in want.items() if counts[k] < n}
    assert not short, (label, short, 'want at least', want)


def sharded_flagship_checks(design, sd_f, sd_c):
    """The sharded products on the flagship blocks against the unsharded
    design's, fused (``sd_f``, policy '1') and composed (``sd_c``,
    'auto'), one vector and 4 chains' rows, with the launches of each
    sharded call: one per shard."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(11)
    n, p = design.shape
    v = torch.randn(p, generator=g, device='cuda') * .01
    u = torch.randn(n, generator=g, device='cuda')
    w = torch.rand(n, generator=g, device='cuda') + .1
    a = (torch.rand(n, generator=g, device='cuda') < .5).float()
    V = torch.randn((4, p), generator=g, device='cuda') * .01
    U = torch.randn((4, n), generator=g, device='cuda')
    W = torch.rand((4, n), generator=g, device='cuda') + .1
    fused, comp = design.with_policy('1'), design.with_policy('auto')
    perm, _, off = comp.cg_blockorder_ctx()

    def f(sharded):
        return sd_f if sharded else fused

    def c(sharded):
        return sd_c if sharded else comp

    pairs = [
        ('dot', lambda s: c(s).dot(v)),
        ('Tdot', lambda s: c(s).Tdot(u)),
        ('quad fused', lambda s: f(s).quad_matvec(v, w)),
        ('quad composed', lambda s: c(s).quad_matvec_blockorder(
            v[perm], w, off, return_t=True)),
        ('presolve fused', lambda s: f(s).presolve_reductions(u, u * w, w)),
        ('presolve composed', lambda s: c(s).presolve_reductions(
            u, u * w, w, w * u)),
        ('fisher diag', lambda s: c(s).compute_fisher_diag(w)),
        ('link logit', lambda s: c(s).fused_link_grad(
            v, a, torch.ones_like(w), 'logit')),
        ('dot 4 chains', lambda s: c(s).dot(V)),
        ('Tdot 4 chains', lambda s: c(s).Tdot(U)),
        ('quad composed 4 chains', lambda s: c(s).quad_matvec_blockorder(
            V[:, perm].contiguous(), W, off)),
        ('presolve composed 4 chains', lambda s: c(s).presolve_reductions(
            U, U * W, W, W * U)),
    ]
    launches = {'quad fused': {'ne_oneread': SHARDS},
                'quad composed': {'ne_sweep[rows]': SHARDS,
                                  'ne_sweep[cols]': SHARDS},
                'link logit': {'ne_oneread[logit]': SHARDS},
                'presolve fused': {'tdots_sweep': SHARDS},
                'presolve composed': {'tdots_sweep[u4]': SHARDS},
                'quad composed 4 chains': {'ne_rows_k': SHARDS,
                                           'colpass_k': SHARDS}}
    return sharded_checks('sharded', pairs, RTOL, launches)


def sharded_chain(model, label, check_resume=True):
    """``gibbs(10)`` with CG (launch counts read right after it),
    ``gibbs_resume(10)`` timed, with `check_resume` the exact-resume
    check (``gibbs(7)`` + ``gibbs_resume(3, merge=True)``), and a
    profiler window. Returns
    {ips, dev_ms, busy, n_cg, mean_cg, counts, combines, samples}."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import BayesBridge, RegressionCoefPrior
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))
    kw = dict(seed=0, coef_sampler_type='cg', params_to_save='all')
    reset_launch_counts()
    t0 = time.perf_counter()
    samples, info = bridge.gibbs(10, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert_draws(label, counts, 10)
    n_cg = info['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}] gibbs(10) incl. MAP search: "
        f"{time.perf_counter() - t0:.1f} s; n_cg_iter "
        f"{n_cg.astype(int).tolist()}; launch counts "
        f"{ {k: n for k, n in counts.items() if n} }")
    assert np.all(np.isfinite(samples['logp']))
    assert np.all(np.isfinite(samples['coef']))
    design = model.design
    c0 = getattr(design, 'combine_count', 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, more = bridge.gibbs_resume(info, 10)
    torch.cuda.synchronize()
    ips = 10 / (time.perf_counter() - t0)
    combines = (getattr(design, 'combine_count', 0) - c0) / 10
    cg_more = more['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}] steady state, 10 iterations via gibbs_resume: "
        f"{ips:.4f} iter/s, mean CG iterations {cg_more.mean():.2f}"
        + (f", {combines:.1f} gather-and-combine steps an iteration"
           if combines else ""))
    if check_resume:
        s_a, i_a = bridge.gibbs(7, **kw)
        s_b, _ = bridge.gibbs_resume(i_a, 3, merge=True, prev_samples=s_a)
        for key in samples:
            if not np.array_equal(s_b[key], samples[key]):
                raise AssertionError(f"[{label}] resume != uninterrupted "
                                     f"for {key}")
        log(f"[{label}] resume check: gibbs(7) + gibbs_resume(3, "
            f"merge=True) == gibbs(10) exactly")
    busy, dev_ms = profile_window(bridge, more, label)
    return dict(ips=ips, dev_ms=dev_ms, busy=busy, n_cg=n_cg,
                mean_cg=float(cg_more.mean()), counts=counts,
                combines=combines, samples=samples)


def sharded_cg_solve(design, sd, label='sharded'):
    """One CG solve from the same state on the unsharded and the sharded
    composed design (the block-ordered operator on the 1-d mesh, dot and
    Tdot on a 2-d one): both n_cg_iter and the solutions' relative error.
    Returns the error."""
    import torch
    from bayesbridge_tpu_torch.ops.cg import (
        sample_gaussian_cg, takes_device_loop)
    g = torch.Generator(device='cuda').manual_seed(12)
    n, p = design.shape
    obs_prec = torch.rand(n, generator=g, device='cuda') * .25 + .05
    pps = torch.cat((torch.full((1,), 1e-3, device='cuda'),
                     1 / (torch.rand(p - 1, generator=g, device='cuda')
                          * 2.95 + .05)))
    z = design.Tdot(obs_prec * torch.randn(n, generator=g, device='cuda'))
    pert = torch.randn(p, generator=g, device='cuda')
    precond = 1 / torch.sqrt(pps ** 2 + design.compute_fisher_diag(obs_prec))
    out = {}
    for name, d in (('unsharded', design), ('sharded', sd)):
        coef, info = sample_gaussian_cg(
            None, d, obs_prec, pps, z, coef_cg_init=torch.zeros_like(z),
            precond_scale=precond, atol=1e-5 * p ** .5, perturbation=pert)
        out[name] = (coef, info['n_cg_iter'])
    err = rel_err([out['sharded'][0]], [out['unsharded'][0]])
    log(f"[{label}] one CG solve from the same state: n_cg_iter unsharded "
        f"{out['unsharded'][1]}, sharded {out['sharded'][1]}; solutions' "
        f"relative error {err:.3e}")
    assert abs(out['sharded'][1] - out['unsharded'][1]) <= 2, out
    assert err < 1e-3, err
    if takes_device_loop(sd, sd.device):  # the mesh's pieces on one card
        cg_loop_case(sd, label)
    return err


def nccl_of_one(design, outcome, init, ref_samples):
    """An NCCL process group of one process: the global mesh, the design
    and the outcome handed over by host_local_to_global, 2 iterations
    from `init`, which must equal the one-shard single-process run bit
    for bit."""
    import socket
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import BayesBridge, RegressionCoefPrior
    from bayesbridge_tpu_torch.models import LogisticModel
    from bayesbridge_tpu_torch.parallel import distributed
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    distributed.initialize_multihost(f'tcp://127.0.0.1:{port}', 1, 0,
                                     device='cuda')
    try:
        assert torch.distributed.get_backend() == 'nccl'
        mesh = distributed.global_mesh()
        sd = distributed.host_local_to_global(design, mesh)
        n_success = distributed.host_local_to_global(outcome[0], mesh)
        n_trial = distributed.host_local_to_global(outcome[1], mesh)
        bridge = BayesBridge(LogisticModel(n_success, n_trial, sd),
                             RegressionCoefPrior(bridge_exponent=0.5))
        samples, _ = bridge.gibbs(2, seed=0, init=init,
                                  coef_sampler_type='cg',
                                  params_to_save='all')
        torch.cuda.synchronize()
        for key in ref_samples:
            if not np.array_equal(samples[key], ref_samples[key]):
                raise AssertionError(f"[nccl] {key} differs from the "
                                     f"single-process one-shard run")
        log(f"[nccl] process group of one (backend nccl, {mesh}): 2 "
            f"iterations through host_local_to_global, "
            f"{sd.combine_count} gathers by all_gather, equal to the "
            f"one-shard single-process run bit for bit")
    finally:
        torch.distributed.destroy_process_group()


def run_sharded(design, outcome):
    """The sharded phase on the flagship's stored blocks: the 4-entry
    mesh; the sharded products against the unsharded design's with their
    per-shard launches; the price of a gather; ``gibbs(10)`` +
    ``gibbs_resume(10)`` under the fused policy and 'auto', each beside
    the unsharded slice's device ms in the same run; one CG solve
    sharded and unsharded; ``gibbs_chains`` on the mesh against the
    chains alone; the NCCL process group of one. Returns (counts,
    summary)."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import BayesBridge, RegressionCoefPrior
    from bayesbridge_tpu_torch.models import LogisticModel
    from bayesbridge_tpu_torch.parallel import make_mesh, shard_design
    mesh = sharded_mesh()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sd_f = shard_design(design.with_policy('1'), mesh)
    sd_c = sd_f.with_policy('auto')
    torch.cuda.synchronize()
    log(f"[sharded] shard_design: {time.perf_counter() - t0:.2f} s; rows "
        f"{[b - a for a, b in sd_f.bounds]}; shards' stored bytes "
        f"{sd_f.storage_bytes() / 1e9:.3f} GB, new device bytes "
        f"{(torch.cuda.memory_allocated() - before) / 1e9:.4f} GB")
    summary = {'product_errs': sharded_flagship_checks(design, sd_f, sd_c)}

    # The price of one gather-and-combine step at the flagship's shapes.
    p = design.shape[1]
    parts_p = [torch.randn(p, device='cuda') for _ in range(SHARDS)]
    parts_n = [torch.randn(b - a, device='cuda') for a, b in sd_f.bounds]
    sum_ms = time_ms(lambda: sd_f._sum(parts_p), reps=20, inner=10)
    cat_ms = time_ms(lambda: sd_f._cat(parts_n), reps=20, inner=10)
    log(f"[sharded] gather-and-combine: the sum of {SHARDS} p-partials "
        f"{sum_ms:.4f} ms, the concatenation of {SHARDS} row blocks "
        f"{cat_ms:.4f} ms (CUDA events, device time)")
    summary.update(sum_ms=sum_ms, cat_ms=cat_ms)

    counts = {}
    for policy, sd in (('1', sd_f), ('auto', sd_c)):
        tag = 'fused' if policy == '1' else 'auto'
        res = sharded_chain(LogisticModel(*outcome, sd), f'sharded_{tag}')
        # The unsharded slice beside it (its resume was checked in the
        # hybrid phase).
        base = sharded_chain(LogisticModel(
            *outcome, design.with_policy(policy)), f'unsharded_{tag}',
            check_resume=False)
        counts[f'sharded_{tag}'] = res['counts']
        key = 'ne_oneread' if policy == '1' else 'ne_sweep[rows]'
        log(f"[sharded_{tag}] {key} launches {res['counts'][key]} against "
            f"the unsharded {base['counts'][key]} (n_cg_iter sharded "
            f"{res['n_cg'].astype(int).tolist()}, unsharded "
            f"{base['n_cg'].astype(int).tolist()})")
        gather_ms = res['combines'] * max(sum_ms, cat_ms)
        dev = {'sharded': res['dev_ms'], 'unsharded': base['dev_ms']}
        log(f"[sharded_{tag}] device ms per iteration {dev['sharded']} "
            f"sharded against {dev['unsharded']} unsharded in this run; "
            f"iter/s {res['ips']:.4f} against {base['ips']:.4f}; the "
            f"gathers at most {gather_ms:.3f} ms an iteration "
            f"({res['combines']:.1f} steps)")
        summary[tag] = {k: res[k] for k in ('ips', 'dev_ms', 'busy',
                                            'mean_cg', 'combines')}
        summary[tag]['unsharded'] = {k: base[k] for k in
                                     ('ips', 'dev_ms', 'busy', 'mean_cg')}
        summary[tag]['gather_ms'] = gather_ms
    summary['cg_err'] = sharded_cg_solve(design.with_policy('auto'), sd_c)

    model = LogisticModel(*outcome, design.with_policy('auto'))
    bridge = BayesBridge(model, RegressionCoefPrior(bridge_exponent=0.5))
    t0 = time.perf_counter()
    chains_against_alone(bridge, overdispersed_inits(model, SHARDS),
                         'sharded_chains', 3, n_chains=SHARDS, mesh=mesh)
    log(f"[sharded_chains] {SHARDS} chains on the mesh, each against the "
        f"chain alone: {time.perf_counter() - t0:.1f} s")

    # From a given start (no MAP search): 2 iterations, one shard.
    init = {'coef': np.zeros(design.shape[1]), 'global_scale': 0.1,
            'local_scale': np.ones(design.shape[1] - 1)}
    one = LogisticModel(*outcome, shard_design(
        design.with_policy('auto'), make_mesh(devices=[mesh.devices[0]])))
    ref, _ = BayesBridge(one, RegressionCoefPrior(bridge_exponent=0.5)) \
        .gibbs(2, seed=0, init=init, coef_sampler_type='cg',
               params_to_save='all')
    nccl_of_one(design.with_policy('auto'), outcome, init, ref)
    log(f"[sharded] peak device memory in the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del sd_f, sd_c
    torch.cuda.empty_cache()
    return counts, summary


def sharded_ell_checks(design):
    """The ell float64 slice's design on the 4-entry mesh: each shard's
    col-ELL traversal for 1 and 4 vectors, the products against the
    unsharded design's at 1e-12 of max. Returns ({name: relative
    error}, {k: each shard's traversal for k vectors})."""
    import torch
    from bayesbridge_tpu_torch.parallel import shard_design
    mesh = sharded_mesh()
    t0 = time.perf_counter()
    sd = shard_design(design, mesh)
    torch.cuda.synchronize()
    whole = 'windowed' if design.col_layout.windowed(design.dtype, 1) \
        else 'first'
    traversals = {1: sd.traversals(1), 4: sd.traversals(4)}
    log(f"[ell64_sharded] shard_design: {time.perf_counter() - t0:.1f} s "
        f"(each shard's col-ELL built again from its rows); col-ELL "
        f"shapes {[tuple(s.col_idx.shape) for _, s in sd.local_shards()]}; "
        f"traversal for 1 vector {traversals[1]}, for 4 {traversals[4]} "
        f"(unsharded, 1 vector: {whole})")
    g = torch.Generator(device='cuda').manual_seed(13)
    n, p = design.shape
    f64 = dict(device='cuda', dtype=torch.float64)
    v = torch.randn(p, generator=g, **f64)
    u = torch.randn(n, generator=g, **f64)
    w = torch.rand(n, generator=g, **f64) + .1
    V = torch.randn((4, p), generator=g, **f64)
    U = torch.randn((4, n), generator=g, **f64)
    dsg = {False: design, True: sd}
    pairs = [('dot', lambda s: dsg[s].dot(v)),
             ('Tdot', lambda s: dsg[s].Tdot(u)),
             ('quad', lambda s: dsg[s].quad_matvec(v, w)),
             ('fisher diag', lambda s: dsg[s].compute_fisher_diag(w)),
             ('dot 4 chains', lambda s: dsg[s].dot(V)),
             ('Tdot 4 chains', lambda s: dsg[s].Tdot(U))]
    errs = sharded_checks('ell64_sharded', pairs, 1e-12,
                          {'dot': {'ell[dot]': SHARDS}})
    del sd
    torch.cuda.empty_cache()
    return errs, traversals


MESH2D = (2, 2)


def mesh2d_mesh(grid=MESH2D):
    """A mesh of the 2-d phase: four cards as `grid` where the machine
    has them, else ``[cuda:0] * 4`` as `grid` (every piece a copy on card
    0)."""
    import torch
    from bayesbridge_tpu_torch.parallel import make_mesh
    r, c = grid
    if torch.cuda.device_count() >= r * c:
        devices = [torch.device('cuda', i) for i in range(r * c)]
    else:
        devices = [torch.device('cuda', 0)] * (r * c)
    return make_mesh(grid, devices=devices)


def mesh2d_pairs(design, sd, seed=21, scale=1.0, gram=False):
    """(name, fn) of the 2-d phase's products, fn(False) on the unsharded
    `design`, fn(True) on the sharded `sd`: dot, Tdot, the composed CG
    operator, the Fisher diagonal, the five-reduction pre-solve where the
    design has one, their 4-chain forms, and with `gram` the Fisher
    information (``compute_fisher_info``)."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    n, p = design.shape
    kw = dict(generator=g, device='cuda', dtype=design.dtype)
    v, u = torch.randn(p, **kw) * scale, torch.randn(n, **kw)
    w = torch.rand(n, **kw) + .1
    V, U = torch.randn((4, p), **kw) * scale, torch.randn((4, n), **kw)
    W = torch.rand((4, n), **kw) + .1
    d = {False: design, True: sd}
    pairs = [('dot', lambda s: d[s].dot(v)),
             ('Tdot', lambda s: d[s].Tdot(u)),
             ('quad', lambda s: d[s].quad_matvec(v, w)),
             ('fisher diag', lambda s: d[s].compute_fisher_diag(w)),
             ('dot 4 chains', lambda s: d[s].dot(V)),
             ('Tdot 4 chains', lambda s: d[s].Tdot(U)),
             ('fisher diag 4 chains', lambda s: d[s].compute_fisher_diag(W))]
    if design.has_presolve_reductions():
        pairs += [('presolve', lambda s: d[s].presolve_reductions(
                      u, u * w, w, w * u)),
                  ('presolve 4 chains', lambda s: d[s].presolve_reductions(
                      U, U * W, W, W * U))]
    if gram:
        pairs.append(('gram', lambda s: d[s].compute_fisher_info(w)))
    return pairs


def hybrid_launches(n_pieces, int4=False):
    """{product: {counter: launches}} of a hybrid grid of `n_pieces`
    pieces: each product's kernel once a piece (the int8 or the nibble
    modes; the flagship's packed block is 0/1, the pre-solve's binary
    mode)."""
    if int4:
        rows, cols, tdots, u4 = ('ne_rows_i4', 'colpass_i4',
                                 'tdots_i4[bin]', 'tdots_i4[u4,bin]')
        rows_k, cols_k, u4_k = ('ne_rows_i4[chains]', 'colpass_i4[chains]',
                                'tdots_i4[u4,bin,chains]')
    else:
        rows, cols, tdots, u4 = ('ne_sweep[rows]', 'ne_sweep[cols]',
                                 'tdots_sweep', 'tdots_sweep[u4]')
        rows_k, cols_k, u4_k = 'ne_rows_k', 'colpass_k', 'tdots_sweep_k[u4]'
    each = {'dot': {rows: 1}, 'Tdot': {cols: 1}, 'quad': {rows: 1, cols: 1},
            'fisher diag': {tdots: 1}, 'presolve': {u4: 1},
            'dot 4 chains': {rows_k: 1}, 'Tdot 4 chains': {cols_k: 1},
            'fisher diag 4 chains': {'tdots_sweep_k': 1},
            'presolve 4 chains': {'tdots_sweep_k[u4]': 1}}
    if int4:  # the nibble modes take a chain a launch
        each.update({'dot 4 chains': {rows_k: 4},
                     'Tdot 4 chains': {cols_k: 4},
                     'fisher diag 4 chains': {'tdots_i4[bin,chains]': 4},
                     'presolve 4 chains': {u4_k: 4}})
    return {name: {k: n * n_pieces for k, n in c.items()}
            for name, c in each.items()}


def mesh2d_layout(label, sd, mesh, t0, before):
    """Log the grid's layout: rows, each column piece's columns, bytes."""
    import torch
    torch.cuda.synchronize()
    r, c = mesh.grid
    how = ('four cards' if len(set(mesh.devices)) > 1
           else '[cuda:0] * 4, each piece a copy on card 0')
    if sd.col_shards is not None:
        what = (f"col-ELL pieces "
                f"{[tuple(p.col_idx.shape) for p in sd.col_shards]}")
    else:
        what = f"columns of row 0's pieces {[piece_columns(p) for p in sd.shards[:len(sd.col_pieces)]]}"
    log(f"[{label}] shard_design on {r} x {c} ({how}): "
        f"{time.perf_counter() - t0:.2f} s; rows "
        f"{[b - a for a, b in sd.bounds]}, {len(sd.col_pieces)} column "
        f"piece(s), {what}; "
        f"pieces' stored bytes {sd.storage_bytes() / 1e9:.3f} GB, new "
        f"device bytes {(torch.cuda.memory_allocated() - before) / 1e9:.3f} "
        f"GB")


def piece_columns(piece):
    """A piece's columns: (exact, float) of a hybrid piece, (binary,
    float) of a bitpack one, else its width."""
    backend = getattr(piece, 'backend', None)
    if backend == 'hybrid':
        return piece.n_exact, piece.n_float
    if backend == 'bitpack':
        return piece._bitpack_meta[0], piece.n_float
    return piece.shape[1]


def timed_case(name, kern, plain, work, rate=None, lib=None):
    """A kernel against its plain version (rtol of `check`), timed beside
    it and its bound, and beside `lib` (one PyTorch call of the same
    function, checked against the kernel) where given. Returns the result
    dict of the kernels line."""
    import torch
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = max(check(f"{name} [{i}]", [g], [r])
              for i, (g, r) in enumerate(zip(got, ref)))
    if lib is not None:
        check(f"{name}: cuSPARSE vs the kernel", [lib()], [got[0]])
    del got, ref
    ms, plain_ms = time_ms(kern), time_ms(plain)
    lib_ms = None if lib is None else time_ms(lib)
    bound, by = bound_ms(*work) if rate is None else bound_ms(*work, rate)
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of it"
        + ("" if lib is None else f"; cuSPARSE {lib_ms:.4f} ms"))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def hybrid_piece_timings(sd):
    """The 2-d path's kernels on piece (0, 0) of the flagship grid: the
    row pass, the column pass and the five-reduction pre-solve over the
    piece's copies, against their plain versions, timed beside their
    bounds. Returns {name@mesh2d: result}."""
    import torch
    from bayesbridge_tpu_torch.kernels.ne_sweep import (
        colpass, colpass_plain, ne_rows, ne_rows_plain)
    from bayesbridge_tpu_torch.kernels.tdots_sweep import (
        tdots_sweep, tdots_sweep_plain)
    piece = sd.shards[0]
    Xs, ps = piece._hybrid_Xs()
    m = piece.shape[0]
    g = torch.Generator(device='cuda').manual_seed(23)
    vs = [torch.randn(p, generator=g, device='cuda') for p in ps]
    blocks = list(zip(Xs, vs))
    c = torch.randn((), generator=g, device='cuda')
    us = [torch.randn(m, generator=g, device='cuda') for _ in range(4)]
    log(f"[mesh2d] the path's kernels on piece (0, 0): {m} rows, blocks "
        f"{[(tuple(X.shape), str(X.dtype)) for X in Xs]}")
    n_elem, vec, row = m * sum(ps), 4 * sum(ps), 4 * m
    X_b = nbytes(*Xs)

    def flat(r):
        return [o for blk in r for o in blk]
    cases = {
        'ne_sweep[rows]': (lambda: [ne_rows(blocks, c)],
                           lambda: [ne_rows_plain(blocks, c)],
                           (X_b + vec + row, 2 * n_elem)),
        'ne_sweep[cols]': (lambda: colpass(Xs, ps, us[0]),
                           lambda: colpass_plain(Xs, ps, us[0]),
                           (X_b + vec + row, 2 * n_elem)),
        'tdots_sweep[u4]': (lambda: flat(tdots_sweep(Xs, ps, *us)),
                            lambda: flat(tdots_sweep_plain(Xs, ps, *us)),
                            (X_b + 5 * vec + 4 * row, 11 * n_elem))}
    return {f'{name}@mesh2d': timed_case(f'{name}@mesh2d', *case)
            for name, case in cases.items()}


def run_mesh2d(design, outcome, sharded, m2d):
    """The 2-d phase on the flagship's stored blocks ('auto', composed):
    the (2, 2) grid's products against the unsharded design's with one
    launch per piece and a rerun's bits; the path's kernels timed on a
    piece; the same products on (1, 4) and (4, 1), the latter equal to
    the 1-d mesh of 4 bit for bit; ``gibbs(10)`` + ``gibbs_resume(10)``
    with the exact-resume check and a profiler window, beside the
    unsharded and the 1-d slices' device ms from the sharded phase
    (`sharded`, its summary); one CG solve sharded and unsharded; the
    packed int4 block on the same grid, equal to the int8 pieces bit for
    bit. Writes its counts, kernel results and summary into `m2d`."""
    import os
    import torch
    from bayesbridge_tpu_torch.models import LogisticModel
    from bayesbridge_tpu_torch.parallel import shard_design
    comp = design.with_policy('auto')
    mesh = mesh2d_mesh()
    torch.cuda.reset_peak_memory_stats()
    t0, before = time.perf_counter(), torch.cuda.memory_allocated()
    sd = shard_design(comp, mesh, pred_axis='pred')
    mesh2d_layout('mesh2d', sd, mesh, t0, before)
    assert sd.fused_ne_mode('quad') is None and sd.cg_blockorder_ctx() is None
    n_pieces = len(sd.local_shards())
    summary = {'errs': sharded_checks(
        'mesh2d', mesh2d_pairs(comp, sd, scale=.01), RTOL,
        hybrid_launches(n_pieces))}
    m2d['results'].update(hybrid_piece_timings(sd))

    for grid in ((1, 4), (4, 1)):
        t0, before = time.perf_counter(), torch.cuda.memory_allocated()
        other = shard_design(comp, mesh2d_mesh(grid), pred_axis='pred')
        label = f'mesh2d_{grid[0]}x{grid[1]}'
        mesh2d_layout(label, other, mesh2d_mesh(grid), t0, before)
        pairs = mesh2d_pairs(comp, other, scale=.01)
        summary[label] = sharded_checks(label, pairs, RTOL, hybrid_launches(
            len(other.local_shards())))
        if grid == (4, 1):
            one_d = mesh2d_pairs(comp, shard_design(comp, sharded_mesh()),
                                 scale=.01)
            for (name, fn), (_, fn1) in zip(pairs, one_d):
                a, b = fn(True), fn1(True)
                a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
                assert all(torch.equal(x, y) for x, y in zip(a, b)), name
            log(f"[{label}] every product equals the 1-d mesh of 4's bit "
                f"for bit")
        del other, pairs
        torch.cuda.empty_cache()

    res = sharded_chain(LogisticModel(*outcome, sd), 'mesh2d_auto')
    c = res['counts']
    assert c['ne_oneread'] == c['ne_oneread[logit]'] == 0, c
    assert c['ne_sweep[rows]'] > 0 and c['ne_sweep[cols]'] > 0, c
    assert c['tdots_sweep[u4]'] >= 10 * n_pieces, c
    m2d['counts']['mesh2d'] = c
    dev = {'mesh2d': res['dev_ms'],
           '1-d of 4': sharded['auto']['dev_ms'],
           'unsharded': sharded['auto']['unsharded']['dev_ms']}
    busy = {'mesh2d': res['busy'], '1-d of 4': sharded['auto']['busy'],
            'unsharded': sharded['auto']['unsharded']['busy']}
    log(f"[mesh2d_auto] device ms per iteration {dev} (busy share {busy}); "
        f"iter/s {res['ips']:.4f} against the 1-d {sharded['auto']['ips']:.4f}"
        f" and unsharded {sharded['auto']['unsharded']['ips']:.4f} (the "
        f"sharded phase, this run); on one card the grid's cost, not a "
        f"speed-up")
    summary['chain'] = dict(dev_ms=dev, busy=busy, ips=res['ips'],
                            mean_cg=res['mean_cg'],
                            combines=res['combines'])
    summary['cg_err'] = sharded_cg_solve(comp, sd, label='mesh2d')

    # The packed int4 block on the same grid: the int8 pieces' bits.
    t0 = time.perf_counter()
    os.environ['BB_HYBRID_INT4'] = '1'
    try:
        d4 = comp.with_exact_tier('int4')
        s4 = shard_design(d4, mesh, pred_axis='pred')
    finally:
        del os.environ['BB_HYBRID_INT4']
    torch.cuda.synchronize()
    assert all(s.X_exact.dtype == torch.uint8 and s.int4_binary
               for _, s in s4.local_shards())
    log(f"[mesh2d_int4] the flagship's block packed on the card and put on "
        f"{mesh.grid}: {time.perf_counter() - t0:.1f} s; pieces' stored "
        f"bytes {s4.storage_bytes() / 1e9:.3f} GB")
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    want = hybrid_launches(n_pieces, int4=True)
    for (name, f8), (_, f4) in zip(mesh2d_pairs(comp, sd, scale=.01),
                                   mesh2d_pairs(d4, s4, scale=.01)):
        a = f8(True)
        reset_launch_counts()
        b = f4(True)
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts().items() if n}
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        for counter, n in want.get(name, {}).items():
            assert counts.get(counter, 0) == n, (name, counter, counts)
        log(f"[mesh2d_int4] {name}: equal to the int8 pieces bit for bit; "
            f"launches {counts}")
    log(f"[mesh2d] peak device memory in the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del s4, d4, sd
    torch.cuda.empty_cache()
    m2d['summary']['hybrid'] = summary


def mesh2d_backend(label, design, tol, m2d, launches=None, gram=False):
    """`design` on the (2, 2) grid: its products against the unsharded
    design's within `tol` of max, a rerun's bits, launches(sd) {product:
    {counter: launches}} asserted. Returns the sharded design (the caller
    frees it)."""
    import torch
    from bayesbridge_tpu_torch.parallel import shard_design
    mesh = mesh2d_mesh()
    t0, before = time.perf_counter(), torch.cuda.memory_allocated()
    sd = shard_design(design, mesh, pred_axis='pred')
    mesh2d_layout(label, sd, mesh, t0, before)
    m2d['summary'][label] = sharded_checks(
        label, mesh2d_pairs(design, sd, gram=gram), tol,
        None if launches is None else launches(sd))
    return sd


def mesh2d_packed(design, backend, m2d):
    """The 2-d phase on a packed design. bitpack: the (2, 2) grid's
    products within rtol 1e-4 of max with bitlut launched once a piece
    (the checks' launch counts kept for the kernels line, check-only) and
    bitlut timed on a piece. winell: the grid warns and shards over
    ``obs`` only, wincsr launched once a row block per vector, every
    product equal to the 1-d mesh of 2's bit for bit."""
    import warnings
    import torch
    from bayesbridge_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from bayesbridge_tpu_torch.parallel import make_mesh, shard_design
    if backend == 'bitpack':
        sd = mesh2d_backend(
            'mesh2d_bitpack', design, RTOL, m2d, lambda sd: {
                'dot': {'bitlut[dot]': len(sd.local_shards())},
                'Tdot': {'bitlut[tdot]': len(sd.local_shards())}})
        # The launches of one X v and one X' u on the grid.
        n, p = design.shape
        reset_launch_counts()
        sd.dot(torch.ones(p, device='cuda'))
        sd.Tdot(torch.ones(n, device='cuda'))
        torch.cuda.synchronize()
        m2d['counts']['mesh2d_bitpack_checks'] = launch_counts()
        m2d['results'].update(bitpack_piece_timings(sd))
        del sd
        torch.cuda.empty_cache()
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        sd = shard_design(design, mesh2d_mesh(), pred_axis='pred')
    said = [str(w.message) for w in caught]
    assert any('observation axis only' in w for w in said), said
    one_d = shard_design(design, make_mesh(devices=[
        mesh2d_mesh().devices[0]] * MESH2D[0]))
    assert sd.n_shards == MESH2D[0] and len(sd.col_pieces) == 1
    # wincsr once a row block per vector (the Fisher diagonal: squares,
    # and centred the sums).
    r, diag = MESH2D[0], 1 + int(design.centered)
    want = {'dot': {'wincsr[dot]': r}, 'Tdot': {'wincsr[tdot]': r},
            'quad': {'wincsr[dot]': r, 'wincsr[tdot]': r},
            'fisher diag': {'wincsr[tdot]': diag * r},
            'dot 4 chains': {'wincsr[dot]': 4 * r},
            'Tdot 4 chains': {'wincsr[tdot]': 4 * r},
            'fisher diag 4 chains': {'wincsr[tdot]': 4 * diag * r}}
    for (name, fn), (_, fn1) in zip(mesh2d_pairs(design, sd),
                                    mesh2d_pairs(design, one_d)):
        reset_launch_counts()
        a = fn(True)
        torch.cuda.synchronize()
        assert_launches(name, launch_counts(), want[name])
        b = fn1(True)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    log(f"[mesh2d_winell] the {MESH2D} grid warns (\"{said[0][:70]}...\") "
        f"and shards over obs only: {sd.n_shards} row blocks, wincsr "
        f"launched once a row block per vector, every product equal to "
        f"the 1-d mesh of {MESH2D[0]}'s bit for bit")
    del sd, one_d
    torch.cuda.empty_cache()


def bitpack_piece_timings(sd):
    """bitlut on piece (0, 0)'s bitmaps of the bitpack grid, both
    orientations, against its plain version, timed beside its bound.
    Returns {name@mesh2d: result}."""
    import torch
    from bayesbridge_tpu_torch.kernels.bitlut import bitlut, bitlut_plain
    piece = sd.shards[0]
    p_bin, gcol_pad, _, _, grow_pad, _, _ = piece._bitpack_meta
    m = piece.shape[0]
    g = torch.Generator(device='cuda').manual_seed(24)
    results = {}
    for tag, bits, g_pad, n_in, n_out in (
            ('dot', piece.bits_col, gcol_pad, p_bin, m),
            ('tdot', piece.bits_row, grow_pad, m, p_bin)):
        v = torch.zeros(8 * g_pad, device='cuda')
        v[:n_in] = torch.randn(n_in, generator=g, device='cuda')
        g_live = -(-n_in // 8)
        name = f'bitlut[{tag}]@mesh2d'
        log(f"[mesh2d_bitpack] {name} on piece (0, 0): "
            f"{tuple(bits.shape)} bitmap, n_out {n_out}")
        mat = bitmap_csr(bits, n_in, n_out)
        results[name] = timed_case(
            name, lambda b=bits, v=v, k=n_out, t=tag: [bitlut(b, v, k, t)],
            lambda b=bits, v=v, k=n_out: [bitlut_plain(b, v, k)],
            (g_live * n_out + 4 * n_in + 4 * n_out,
             g_live * n_out + 256 * 8 * g_live),
            lib=lambda a=mat, v=v[:n_in]: torch.mv(a, v))
        del mat
    return results


def ell_piece_timings(sd):
    """``ell_matvec_k`` on the ell grid's row piece 0 (X v) and col-ELL
    piece 0 (X' u, on the traversal the dispatch gives one vector),
    against its plain version, timed beside its bound over the nonzeros.
    Returns {name@mesh2d: result}."""
    import torch
    from bayesbridge_tpu_torch.kernels.ell import (
        ell_matvec_k, ell_matvec_k_plain)
    row, col = sd.shards[0], sd.col_shards[0]
    f64 = sd.dtype == torch.float64
    item = 8 if f64 else 4
    g = torch.Generator(device='cuda').manual_seed(25)
    results = {}
    for tag, idx, val, lay, n_in in (
            ('dot', row.row_idx, row.row_val, None, sd.shape[1] - 1),
            ('tdot', col.col_idx, col.col_val, col.col_layout, sd.shape[0])):
        V = torch.randn((1, n_in), generator=g, device='cuda',
                        dtype=sd.dtype)
        key = 'ell[tdot_win]' if lay is not None \
            and lay.windowed(sd.dtype, 1) else f'ell[{tag}]'
        nnz = int((val != 0).sum())
        m = idx.shape[0]
        log(f"[mesh2d_ell] {key}@mesh2d on {'row' if lay is None else 'col'}"
            f"-ELL piece 0: {tuple(idx.shape)}, {nnz} nonzeros")
        mat = ell_csr(idx, val, n_in)
        results[f'{key}@mesh2d'] = timed_case(
            f'{key}@mesh2d',
            lambda i=idx, v=val, l=lay, t=tag: [ell_matvec_k(i, v, V, 1, t,
                                                             l)],
            lambda i=idx, v=val: [ell_matvec_k_plain(i, v, V, 1)],
            (nnz * (4 + item) + (n_in + m) * item, 2 * nnz),
            FP64_OPS_PER_S if f64 else F32_OPS_PER_S,
            lib=lambda a=mat, v=V[0]: torch.mv(a, v)[None])
        del mat
    return results


def run_harness():
    """Phase 10: the sweep A/B harness at the flagship block shape, with the
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
    # The host builds the flagship data in a thread while nvcc compiles
    # the kernels in processes of its own; the data is waited for before
    # the first kernel is timed.
    with ThreadPoolExecutor(1) as pool:
        data = pool.submit(build_data)
        kl = load_library()
        log(f"kernel build: {kl.build_seconds:.1f} s -> {kl.path.name}")
        for line in kl.ptxas_log.splitlines():
            # The nibble modes' entry names too, beside their registers.
            if 'registers' in line or 'spill' in line or 'Nib4' in line \
                    or 'tdots_i4' in line or 'pg_kernel' in line \
                    or 'ts_kernel' in line or 'ts_regroup' in line \
                    or 'cg_iter' in line \
                    or 'cg_loop' in line:
                log('  ptxas: ' + line.strip())
        X, outcome = data.result()
    t0 = phase('build and flagship data', t0)
    kernel_checks()
    composed_and_onepass_checks()
    packed_kernel_checks()
    t0 = phase('ragged kernel checks', t0)
    results, link_turns = flagship_kernel_checks()
    results.update(probe_timings())
    t0 = phase('flagship kernel checks', t0)
    counts, witness, design, composed = run_hybrid(X, outcome)
    counts['link_turns'] = link_turns
    composed_ips = composed['ips']
    t0 = phase('hybrid slices', t0)
    res, dr = run_draws(design, composed.pop('state'))
    results.update(res)
    log(f"[draws] summary (KS D, KS p, rounds mean, rounds max): "
        f"{json.dumps(dr)}")
    t0 = phase('draws', t0)
    res, i4_counts, i4 = run_int4(design, outcome, composed)
    results.update(res)
    counts.update(i4_counts)
    log(f"[int4] summary: {json.dumps(i4)}")
    t0 = phase('int4', t0)
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
    sh_counts, sharded = run_sharded(design, outcome)
    counts.update(sh_counts)
    log(f"[sharded] summary: {json.dumps(sharded)}")
    t0 = phase('sharded', t0)
    # The 2-d phase's record: its launch counts by path, its kernel
    # results and its summary, filled by the slices that hold each design.
    m2d = {'counts': {}, 'results': {}, 'summary': {}}
    run_mesh2d(design, outcome, sharded, m2d)
    t0 = phase('mesh2d (flagship, int4)', t0)
    del design
    torch.cuda.empty_cache()
    dense_counts, res = run_dense(m2d)
    counts.update(dense_counts)
    results.update(res)
    t0 = phase('dense slice', t0)
    res, counts['bitpack'], _ = run_packed(X, outcome, 'bitpack', m2d,
                                           witness)
    results.update(res)
    del X, outcome
    t0 = phase('bitpack slice', t0)
    X, outcome = build_normal_data(WINELL_N)
    res, counts['winell'], counts['winell_packing'] = run_packed(
        X, outcome, 'winell', m2d)
    results.update(res)
    del X, outcome
    t0 = phase('winell slice', t0)
    X, outcome = build_normal_data(ELL_N)
    res, ell_counts = run_ell(X, outcome, m2d)
    results.update(res)
    counts.update(ell_counts)
    del X, outcome
    t0 = phase('ell slice', t0)
    counts['harness'] = run_harness()
    phase('harness', t0)
    log(f"[mesh2d] summary: {json.dumps(m2d['summary'])}")
    counts.update(m2d['counts'])
    results.update(m2d['results'])
    results.update(CG_RESULTS)
    counts['cg_turns'] = CG_TURN_COUNTS
    counts['draws_checks'] = DRAW_COUNTS
    log(f"[cg_loop] summary: {json.dumps(CG_LOOP)}")
    log(f"[splits] per iteration: {json.dumps(SPLITS)}")
    log(f"[step_ab] per iteration, graph against eager: "
        f"{json.dumps(STEP_AB)}")

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
               'pg_draw': 'hybrid_composed', 'ts_draw': 'hybrid_composed',
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
               'ne_oneread[logit]@logit_hmc': 'logit_hmc',
               'ell[dot]': 'ell64', 'ell[tdot_win]': 'ell64',
               'ell[dot]@f32': 'ell32', 'ell[tdot_win]@f32': 'ell32',
               'ell[dot_st]': 'ell64_chains',
               'ell[dot_st]@f32': 'ell32_checks',
               'ne_rows_i4': 'hybrid_int4', 'colpass_i4': 'hybrid_int4',
               'tdots_i4[u4,bin]': 'hybrid_int4',
               'cg_start': 'hybrid_composed', 'cg_update': 'hybrid_composed',
               'cg_update@ell64': 'ell64', 'cg_start@ell64': 'ell64',
               'cg_update@winell': 'winell', 'cg_start@winell': 'winell',
               'ts_draw@ell64': 'ell64',
               'cg_update[three]': 'cg_turns',
               'cg_update[three]@ell64': 'cg_turns',
               'cg_update[three]@winell': 'cg_turns',
               'ts_draw[first]': 'draws_checks'}
    # The pre-solve's other nibble modes: the four-reduction ones are the
    # fused pre-solve's, which no int4 design runs (it composes), and the
    # flagship's exact block is 0/1; each counted on its checks
    # (check-only) unless a path ran it.
    for name in ('tdots_i4', 'tdots_i4[bin]', 'tdots_i4[u4]'):
        path_of[name] = 'hybrid_int4' if counts['hybrid_int4'][name] \
            else 'int4_checks'
    # The col-ELL's first traversal: on the ell slices where the dispatch
    # gives it a chain's launches, else counted on their kernel checks
    # (check-only). The row-ELL's staged traversal runs on the float64
    # chains (several vectors a launch); the float32 slice runs one chain,
    # so its staged launches are its kernel checks' (check-only).
    for suffix, path in (('', 'ell64'), ('@f32', 'ell32')):
        path_of[f'ell[tdot]{suffix}'] = \
            path if counts[path]['ell[tdot]'] else path + '_checks'
    # The 2-d phase's kernels, each under the 2-d path that ran it: the
    # flagship grid's chain, the ell grid's chain, the bitpack grid's
    # product checks (check-only: no chain runs on that grid).
    for name in m2d['results']:
        path_of[name] = {'ell': 'mesh2d_ell',
                         'bitlut': 'mesh2d_bitpack_checks'}.get(
            name.split('[')[0], 'mesh2d')
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
            path='check-only' if path in ('winell_packing', 'link_turns',
                                          'ell64_checks', 'ell32_checks',
                                          'int4_checks',
                                          'mesh2d_bitpack_checks',
                                          'cg_turns', 'draws_checks')
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
