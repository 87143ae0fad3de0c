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
   small shapes: every ne_sweep mode (ne / logit / linear, with and
   without logp) and tdots_sweep over int8 / bf16 / f32 exact blocks,
   one and two blocks, garbage in the padding; bitlut on bitmaps whose
   byte-groups and outputs fill no block, both orientations; winell on
   packings with overfull cells, both orientations, ``square`` off and
   on; and small bitpack and winell designs (spill present) against
   their dense form;
4. ne_sweep and tdots_sweep at the flagship block shapes, with
   CUDA-event timings of kernel and plain version and the bound;
5. the hybrid slice: a 100,000 x 50,000 sparse logit design (90% binary
   columns at 10% density, as bench.py builds it) on the hybrid int8 +
   f32 backend, ``gibbs(30)`` with the CG sampler and bridge exponent
   0.5 (MAP search included), launch counters read right after it, 20
   more iterations through ``gibbs_resume`` timed, and resume on the
   card: ``gibbs(20)`` + ``gibbs_resume(10, merge=True)`` must equal the
   ``gibbs(30)`` run exactly; then the MAP search's witness: the search
   again with the fused objective and with the composed one (``dot``,
   then ``Tdot``) on the same design, and the two objectives compared;
6. the bitpack slice: the same X with ``backend='bitpack'`` (bitmaps of
   5,632 x 106,496 and 12,512 x 49,152 bytes plus a 100,000 x 5,000 f32
   block); bitlut against its plain version on the design's bitmaps,
   timed beside its bound and beside cuSPARSE (``torch.sparse_csr_tensor
   @ v``) on the binary columns' CSR; then the chain of phase 5 on the
   composed CG path, and its MAP search against the hybrid's;
7. the winell slice: a 131,072 x 16,384 design with 164 standard-normal
   entries per row (``backend='auto'`` picks winell); winell against its
   plain version on the design's packings, timed beside its bound and
   beside cuSPARSE on the full CSR; then the same chain.

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
WINELL_N, WINELL_P, WINELL_PER_ROW = 131_072, 16_384, 164
RTOL = 1e-4  # relative to max|plain|: the two sum in different orders
# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    """Phase 3 for the sweeps: every mode, dtype and block count against
    the plain version at a ragged small shape."""
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


def packed_kernel_checks():
    """Phase 3 for bitlut and winell: raw ragged bitmaps and packings with
    spill against the plain versions, then small bitpack and winell
    designs on the card against their dense form (float64)."""
    import numpy as np
    import scipy.sparse as sps
    import torch
    from bayesbridge_tpu_torch.design import SparseDesignMatrix
    from bayesbridge_tpu_torch.design.winell import pack_winell, plan_windows
    from bayesbridge_tpu_torch.kernels.bitlut import bitlut, bitlut_plain
    from bayesbridge_tpu_torch.kernels.winell import winell, winell_plain
    gen = torch.Generator(device='cuda').manual_seed(3)
    log("bitlut vs plain, ragged bitmaps (byte-groups not a multiple of "
        "32, outputs not of 128)")
    for g_pad, m_pad, n_out in ((8, 128, 1), (40, 384, 300),
                                (200, 8320, 8200)):
        bits = torch.randint(0, 256, (g_pad, m_pad), generator=gen,
                             device='cuda', dtype=torch.uint8)
        v = torch.randn(8 * g_pad, generator=gen, device='cuda')
        for tag in ('dot', 'tdot'):
            got = bitlut(bits, v, n_out, tag)
            again = bitlut(bits, v, n_out, tag)
            check(f"bitlut[{tag}] G={g_pad} M={m_pad} n_out={n_out}",
                  [got], [bitlut_plain(bits, v, n_out)])
            assert torch.equal(got, again), "bitlut is not deterministic"

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
    the sweeps have no library time."""
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
    n_elem = N_OBS * (pe + pf)
    vec = 4 * (pe + pf)  # one p-length vector in f32
    row = 4 * N_OBS      # one n-length vector in f32
    # Bytes read once and written once, and float32 operations: ne and
    # logit read X, v, b (and a) and write u and X'u, two FMAs per
    # element; tdots reads X and u1..u3 and writes 4 p-vectors, four FMAs
    # and a multiply per element.
    work = {'ne_sweep[ne]': (gb * 1e9 + 2 * vec + 2 * row, 4 * n_elem),
            'ne_sweep[logit]': (gb * 1e9 + 2 * vec + 3 * row, 4 * n_elem),
            'tdots_sweep': (gb * 1e9 + 4 * vec + 3 * row, 9 * n_elem)}
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
        bound, by = bound_ms(*work[name])
        reads = 1 if name == 'tdots_sweep' else 2
        log(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({by}); kernel reads {reads} x {gb:.3f} GB = "
            f"{reads * gb / (ms / 1e3):.1f} GB/s of 3350")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=None)
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
    """bitlut or winell at the design's stored shapes: agreement with the
    plain version, CUDA-event timings of kernel, plain version and the
    cuSPARSE product (checked against the design's own product), and
    the bound. Returns {kernel name: result dict}."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch.kernels.bitlut import bitlut, bitlut_plain
    from bayesbridge_tpu_torch.kernels.winell import winell, winell_plain
    n, p = design._shape_main
    gen = torch.Generator(device='cuda').manual_seed(5)
    results = {}
    if kind == 'bitpack':
        p_bin, gcol_pad, _, _, grow_pad, _, _ = design._bitpack_meta
        col_map = np.full(p, -1, dtype=np.int64)
        col_map[design.bin_cols.cpu().numpy()] = np.arange(p_bin)
        A, At = device_csr_pair(X, col_map)
        cases = {}
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
            cases[f'bitlut[{tag}]'] = dict(
                kern=lambda b=bits, v=v, m=n_out, t=tag: bitlut(b, v, m, t),
                plain=lambda b=bits, v=v, m=n_out: bitlut_plain(b, v, m),
                lib=lambda a=mat, v=v[:n_in]: torch.mv(a, v),
                own=lambda f=own, v=v[:n_in]: f(v),
                work=(g_live * n_out + 4 * n_in + 4 * n_out,
                      g_live * n_out + 256 * 8 * g_live),
                desc=f"{tuple(bits.shape)} uint8 bitmap, n_out {n_out}")
    else:
        w_dot, k_dot, w_tdot, k_tdot, _, _ = design._winell_meta
        A, At = device_csr_pair(X)
        cases = {}
        for tag, idx, val, W, K, n_in, n_out, mat, own in (
                ('dot', design.widx_dot, design.wval_dot, w_dot, k_dot, p, n,
                 A, design._winell_dot_main),
                ('tdot', design.widx_tdot, design.wval_tdot, w_tdot, k_tdot,
                 n, p, At, design._winell_tdot_main)):
            v = torch.randn(n_in, generator=gen, device='cuda')
            cases[f'winell[{tag}]'] = dict(
                kern=lambda i=idx, x=val, v=v, m=n_out, W=W, K=K, t=tag:
                    winell(i, x, v, m, W, K, tag=t),
                plain=lambda i=idx, x=val, v=v, m=n_out, W=W, K=K:
                    winell_plain(i, x, v, m, W, K),
                square=lambda i=idx, x=val, v=v, m=n_out, W=W, K=K, t=tag:
                    (winell(i, x, v, m, W, K, True, t),
                     winell_plain(i, x, v, m, W, K, True)),
                lib=lambda a=mat, v=v: torch.mv(a, v),
                own=lambda f=own, v=v: f(v),
                work=(nbytes(idx, val, v) + 4 * n_out, 2 * idx.numel()),
                desc=f"{tuple(idx.shape)} int16 + f32 packing, W {W} K {K}, "
                     f"n_out {n_out}")
    for name, c in cases.items():
        got, ref = c['kern'](), c['plain']()
        torch.cuda.synchronize()
        err = check(f"{name} {c['desc']}", [got], [ref])
        if 'square' in c:
            err = max(err, check(f"{name}[square]", *map(
                lambda t: [t], c['square']())))
        check(f"{name}: cuSPARSE vs the design's product", [c['lib']()],
              [c['own']()])
        del got, ref
        ms, plain_ms = time_ms(c['kern']), time_ms(c['plain'])
        lib_ms = time_ms(c['lib'])
        bound, by = bound_ms(*c['work'])
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"cuSPARSE {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{c['work'][0] / 1e9:.4f} GB at "
            f"{c['work'][0] / 1e9 / (ms / 1e3):.1f} GB/s of 3350")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms)
    del A, At, cases
    torch.cuda.empty_cache()
    return results


def run_chain(model, label, step_bytes, n_first=30, n_more=20):
    """``gibbs(n_first)`` with the launch counts read right after it, then
    ``gibbs_resume(n_more)`` timed, then the exact-resume check. Returns
    (counts, n_cg of the first run, its mcmc info)."""
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
    samples, info = bridge.gibbs(n_iter=n_first, coef_sampler_type='cg',
                                 seed=0, params_to_save='all')
    torch.cuda.synchronize()
    counts = launch_counts()
    wall = time.perf_counter() - t0
    n_cg = info['_reg_coef_sampling_info']['n_cg_iter']
    log(f"[{label}] gibbs({n_first}) incl. MAP search: {wall:.1f} s; MAP "
        f"{info['_init_optim_info']}; n_cg_iter {n_cg.astype(int).tolist()}")
    log(f"[{label}] launch counts of this path: {counts}")
    assert np.all(np.isfinite(samples['logp'])), samples['logp']
    assert samples['coef'].shape == (n_pred, n_first)
    assert np.all(np.isfinite(samples['coef']))
    assert n_cg.max() < 500, n_cg.max()
    log(f"[{label}] logp: first {samples['logp'][0]:.6g}, last "
        f"{samples['logp'][-1]:.6g}; intercept mean "
        f"{samples['coef'][0].mean():.4f}; mean coef[1:11] "
        f"{samples['coef'][1:11].mean():.4f}, |coef[11:]| mean "
        f"{np.abs(samples['coef'][11:]).mean():.2e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_more, i_more = bridge.gibbs_resume(info, n_more)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cg_more = i_more['_reg_coef_sampling_info']['n_cg_iter']
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
    s_a, i_a = bridge.gibbs(n_iter=n_a, coef_sampler_type='cg', seed=0,
                            params_to_save='all')
    s_b, _ = bridge.gibbs_resume(i_a, n_first - n_a, merge=True,
                                 prev_samples=s_a)
    for key in samples:
        if not np.array_equal(s_b[key], samples[key]):
            raise AssertionError(f"[{label}] resume != uninterrupted for "
                                 f"{key}")
    log(f"[{label}] resume check: gibbs({n_a}) + gibbs_resume("
        f"{n_first - n_a}, merge=True) == gibbs({n_first}) exactly")
    profile_window(bridge, info, label)
    return counts, n_cg, info


def profile_window(bridge, info, label, n_iter=3):
    """torch.profiler over `n_iter` more iterations: the device's busy
    share of the window's wall clock (profiler overhead included) and
    the kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bridge.gibbs_resume(info, n_iter)
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
        return
    log(f"[{label}] profiler over {n_iter} iterations: device busy "
        f"{busy:.1f} ms of {wall:.1f} ms wall ({100 * busy / wall:.1f}%, "
        f"idle {100 - 100 * busy / wall:.1f}%)")
    for e in sorted(kernels, key=dev_ms, reverse=True)[:8]:
        log(f"    {dev_ms(e):9.2f} ms  {e.count:6d} x  {e.key[:90]}")


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
    model.design.fused_link_grad = lambda *args: None  # compose instead
    try:
        coef_c, info_c = map_search(model)
    finally:
        del model.design.fused_link_grad
    lp_c = composed_objective(model, coef_c)[0]
    log(f"[{label}] MAP witness: composed objective on the same design "
        f"{info_c}, composed loglik at its MAP {lp_c:.9g}; at the first "
        f"MAP fused minus composed loglik {float(fused_lp) - lp:.4g}, "
        f"gradient gap {gap(fused_grad.cpu().numpy(), grad):.3g}; MAP gap "
        f"{gap(coef_c, coef):.3g} (gaps: max|a - b| / max|b|)")
    assert np.isfinite(lp_c) and np.isfinite(float(fused_lp))
    return {'coef': coef, 'lp': lp, 'grad': grad}


def run_hybrid(X, outcome):
    """Phase 5. Returns the path's launch counts and its MAP witness."""
    import numpy as np
    import torch
    from bayesbridge_tpu_torch import RegressionModel
    t0 = time.perf_counter()
    model = RegressionModel(outcome, X, family='logit', dtype=np.float32,
                            device='cuda')
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
    # Reads of the stored blocks per iteration: 2 per ne sweep (k CG
    # iterations + the initial residual), 1 tdots sweep, 1 linear
    # predictor.
    counts, n_cg, _ = run_chain(
        model, 'hybrid', lambda k: (2 * (k + 1) + 2) * gb * 1e9)
    assert counts['tdots_sweep'] >= 30, counts
    assert counts['ne_sweep[ne]'] >= int(np.sum(n_cg + 1)), counts
    assert counts['ne_sweep[logit]'] >= 1, counts
    witness = map_witness(model, 'hybrid')
    del model, design
    torch.cuda.empty_cache()
    return counts, witness


def run_packed(X, outcome, backend, map_ref=None):
    """Phases 6 and 7: build, kernel timings at the design's shapes, the
    chain on the composed path; with `map_ref` (the hybrid's MAP witness
    on the same X), the MAP witness. Returns (kernel results, launch
    counts)."""
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
        shapes = (f"packings {tuple(design.widx_dot.shape)} (W {meta[0]}, "
                  f"K {meta[1]}) and {tuple(design.widx_tdot.shape)} (W "
                  f"{meta[2]}, K {meta[3]}); spill ELL "
                  f"{tuple(design.sd_idx.shape)} and "
                  f"{tuple(design.st_idx.shape)}")
        assert meta[4] or meta[5], "no spill at the winell design"
        assert 0.75 < gb < 0.9, gb
        dot_b = nbytes(design.widx_dot, design.wval_dot, design.sd_idx,
                       design.sd_val)
        tdot_b = nbytes(design.widx_tdot, design.wval_tdot, design.st_idx,
                        design.st_val)
    steps = ', '.join(f"{k} {v:.1f} s"
                      for k, v in design.build_seconds.items())
    log(f"[{backend}] design build + transfer: "
        f"{time.perf_counter() - t0:.1f} s (host {steps}); {shapes}; "
        f"{gb:.3f} GB on the device")
    results = packed_kernel_timings(design, X, backend)
    del design
    # Per iteration: dot + Tdot per CG operator application (k + 1), two
    # pre-solve Tdots and the Fisher diagonal's two moments.
    counts, n_cg, info = run_chain(
        model, backend, lambda k: (k + 1) * (dot_b + tdot_b) + 4 * tdot_b)
    kern = 'bitlut' if backend == 'bitpack' else 'winell'
    n_map = info['_init_optim_info']['n_design_matvec'] // 2
    need = int(np.sum(n_cg + 1))
    assert counts[f'{kern}[dot]'] >= need + n_map, counts
    assert counts[f'{kern}[tdot]'] >= need + 4 * 30 + n_map, counts
    assert counts['ne_sweep[ne]'] == counts['tdots_sweep'] == 0, counts
    if map_ref is not None:
        map_witness(model, backend, map_ref)
    del model
    torch.cuda.empty_cache()
    return results, counts


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
    packed_kernel_checks()
    t0 = phase('ragged kernel checks', t0)
    results = flagship_kernel_checks()
    t0 = phase('flagship sweep checks', t0)
    X, outcome = build_data()
    counts = {}
    counts['hybrid'], witness = run_hybrid(X, outcome)
    t0 = phase('hybrid slice', t0)
    res, counts['bitpack'] = run_packed(X, outcome, 'bitpack', witness)
    results.update(res)
    del X, outcome
    t0 = phase('bitpack slice', t0)
    X, outcome = build_winell_data()
    res, counts['winell'] = run_packed(X, outcome, 'winell')
    results.update(res)
    del X, outcome
    phase('winell slice', t0)

    kernels = []
    for name, res in results.items():
        base = name.split('[')[0]
        path = {'ne_sweep': 'hybrid', 'tdots_sweep': 'hybrid',
                'bitlut': 'bitpack', 'winell': 'winell'}[base]
        kernels.append(dict(
            name=name, route='cuda', source=REGISTRY[base]['source'],
            replaces=REGISTRY[base]['replaces'],
            launches=counts[path][name], **res))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
