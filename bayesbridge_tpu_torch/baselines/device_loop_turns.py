"""The CG update's two routes and the tilted-stable draw's two designs,
timed in turns on the card.

``cg_update`` (``csrc/cg_loop.cu``): the cluster route (``cg_iter``, one
kernel an iteration) against the first design's three kernels
(``cg_ap``, ``cg_step``, ``cg_dir``) from states of the same shape, CG
on the diagonal part (out = 0) with the threshold at 0 so that every
call steps, and two cuts of the cluster route: every chain's flag clear
(the launch alone) and no linear predictor. ``ts_draw``
(``csrc/tilted_stable.cu``): the regrouping design from T = 1, 2, 4, 8,
16, 32 threads a lane (and the wrapper's own T) against the first design
(one thread a lane), the kernels alone on fixed keys (the wrappers' key
draws left out). Each design is timed by CUDA events
around `inner` back-to-back calls with the stream first held by a spin
kernel (the device's time, not the host's launch rate), the designs in
alternating order rep by rep, the median of `reps` per design.
``chip_smoke.py`` runs both at the main path's shapes; on the card:

    python -m bayesbridge_tpu_torch.baselines.device_loop_turns \\
        [--m 50001] [--n 100000] [--p 50000] [--ks 1,4] [--out FILE]

(synthetic inputs: the update at m, n in both dtypes; the draw at p
lanes of tilts exp(N(0, 6^2)) at alpha 0.25.)
"""

import argparse
import ctypes
import json
import statistics

import torch

from ..kernels import cg_loop, draws, load_library

THREADS = (1, 2, 4, 8, 16, 32)


def spin_ms(fn, inner, setup=None):
    """Device ms per call of `inner` calls of fn() queued behind a spin
    kernel, by CUDA events; setup(), where given, runs first, untimed."""
    if setup is not None:
        setup()
    torch.cuda._sleep(10_000_000)  # some 6 ms: the host queues the calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def in_turns(fns, reps=10, inner=20, setups=None):
    """{name: median device ms per call} of the callables `fns`, each
    warmed up, then timed once a rep, forward and backward in turn, after
    its untimed setups[name]() where given."""
    names = list(fns)
    setups = setups or {}
    for name, fn in fns.items():
        if name in setups:
            setups[name]()
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            times[name].append(spin_ms(fns[name], inner, setups.get(name)))
    return {name: statistics.median(v) for name, v in times.items()}


def cg_state(k, m, n, dtype, device, seed=31):
    """A CgState of k chains at (m, n) from `seed`, and fn() that restarts
    it (cg_start from the saved start, the threshold at 0): every update
    of the next few dozen steps (float32 rs underflows after some 30 on
    the diagonal part) steps every chain."""
    g = torch.Generator(device=device).manual_seed(seed)
    st = cg_loop.CgState(k, m, n, dtype, device, maxiter=1 << 30)
    for name in ('x', 'r', 'b') + (('y',) if n else ()):
        t = getattr(st, name)
        t.copy_(torch.randn(t.shape, generator=g, dtype=dtype,
                            device=device))
    for name in ('s', 'd'):
        getattr(st, name).copy_(torch.rand((k, m), generator=g, dtype=dtype,
                                           device=device) + .5)
    saved = {name: getattr(st, name).clone()
             for name in ('x', 'r') + (('y',) if n else ())}

    def restart():
        for name, v in saved.items():
            getattr(st, name).copy_(v)
        cg_loop.cg_start(st)
        st.thresh.zero_()
    restart()
    return st, restart


def cg_update_turns(m, n, dtype, k, device='cuda', reps=10, inner=20):
    """{route or cut: ms} per call (an iteration of k chains) at vectors
    of length m (and a linear predictor of n; 0: none), each on its own
    state, restarted before each timed batch of `inner` calls so that
    every call steps every chain: 'three', and where the cluster route
    takes m, 'cluster' and its cuts 'frozen' (every flag cleared after the
    restart: the launch alone) and 'no-y' (where n > 0: the same vectors
    without the linear predictor)."""
    cases = {'three': ('three', n, False)}
    if cg_loop.route_for(device, dtype, m, n) == 'cluster':
        cases['cluster'] = ('cluster', n, False)
        cases['frozen'] = ('cluster', n, True)
        if n:
            cases['no-y'] = ('cluster', 0, False)
    fns, setups = {}, {}
    for name, (route, n_y, frozen) in cases.items():
        st, restart = cg_state(k, m, n_y, dtype, device)
        out = torch.zeros((k, m), dtype=dtype, device=device)
        t = torch.zeros((k, n_y), dtype=dtype, device=device) if n_y \
            else None

        def setup(restart=restart, st=st, frozen=frozen):
            restart()
            if frozen:
                st.running.zero_()
        setups[name] = setup
        fns[name] = (lambda st=st, out=out, t=t, route=route:
                     cg_loop.cg_update(st, out, t, route=route))
    return in_turns(fns, reps, inner, setups)


def cluster_capacity(m, n, dtype):
    """(blocks a chain, clusters of cg_iter the card holds at once) for
    vectors of length m and a linear predictor of n."""
    lib = load_library().lib
    f64 = int(dtype == torch.float64)
    clusters = lib.bb_cg_iter_clusters(f64, lib.bb_cg_blocks(m), n)
    return lib.bb_cg_iter_blocks(f64, lib.bb_cg_blocks(m), n), clusters


def ts_launcher(tilt, alpha, design, threads_per_lane=1, keys=None):
    """fn() launching one tilted-stable kernel on `tilt` (k, n) with fixed
    keys, uncounted: `design` 'regroup' (threads_per_lane at the start,
    the warp's threads regrouped among its lanes still running every
    sweep) or 'first'."""
    kl = load_library()
    x = tilt.contiguous()
    if keys is None:
        keys = torch.tensor([0x243F6A8885A308D3 + c
                             for c in range(x.shape[0])],
                            dtype=torch.int64, device=x.device)
    out = torch.empty_like(x)
    counter = torch.zeros(1, dtype=torch.int64, device=x.device)
    f64 = int(x.dtype == torch.float64)
    dc_rounds = draws.ts_dc_rounds(None)
    args_head = (f64, x.data_ptr(), keys.data_ptr(), x.shape[0], x.shape[1],
                 float(alpha), 0, draws.TS_MAX_ROUNDS, dc_rounds,
                 draws.TS_MAX_PARTITION)

    def launch():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if design == 'regroup':
            rc = kl.lib.bb_ts_draw(*args_head,
                                   threads_per_lane.bit_length() - 1,
                                   out.data_ptr(),
                                   counter.data_ptr(), None, None,
                                   ctypes.c_void_p(stream))
        else:
            rc = kl.lib.bb_ts_draw_first(*args_head, out.data_ptr(),
                                         counter.data_ptr(), None, None,
                                         ctypes.c_void_p(stream))
        kl.check(rc, f'ts_draw ({design})')
    return launch


def ts_draw_turns(tilt, alpha, k, threads=THREADS, reps=10, inner=10):
    """{'first': ms, 'R=1': ms, ..., 'auto': T} per launch at `tilt` (1,
    p) repeated over k chains: the first design and the regrouping design
    from each T ('R='), in turns; 'auto' is the T the wrapper picks."""
    x = tilt.reshape(1, -1).expand(k, -1).contiguous()
    fns = {'first': ts_launcher(x, alpha, 'first')}
    for t in threads:
        fns[f'R={t}'] = ts_launcher(x, alpha, 'regroup', t)
    res = in_turns(fns, reps, inner)
    res['auto'] = draws.ts_threads_per_lane(x.numel(), x.device)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--m', type=int, default=50_001)
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--p', type=int, default=50_000)
    ap.add_argument('--ks', default='1,4')
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("device_loop_turns: needs a CUDA device")
    dev = torch.device('cuda')
    ks = [int(k) for k in args.ks.split(',')]
    print(torch.cuda.get_device_name(0))
    res = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        for k in ks:
            r = cg_update_turns(args.m, args.n, dtype, k, dev, args.reps)
            res[f'cg_update {tag} k={k}'] = r
            print(f"cg_update m={args.m} n={args.n} {tag} k={k}: {r}; "
                  f"(blocks a cluster, clusters at once) "
                  f"{cluster_capacity(args.m, args.n, dtype)}")
        g = torch.Generator(device=dev).manual_seed(5)
        tilt = torch.exp(torch.randn(args.p, generator=g, device=dev,
                                     dtype=dtype) * 6)
        for k in ks:
            r = ts_draw_turns(tilt, 0.25, k, reps=args.reps)
            res[f'ts_draw {tag} k={k}'] = r
            print(f"ts_draw p={args.p} {tag} k={k}: {r}")
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)


if __name__ == '__main__':
    main()
