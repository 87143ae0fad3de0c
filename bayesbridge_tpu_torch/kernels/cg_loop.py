"""The CG solve's update kernels and its device loop: wrappers, plain
versions and the graph.

Counterpart of the body of the JAX package's CG ``lax.while_loop``
(``bayesbridge_tpu/ops/cg.py:173-210``) outside the design products:
:func:`cg_start` sets the loop up from the initial residual and
:func:`cg_update` takes one iteration's step for every chain whose flag
is set, given the operator's design part ``out`` (and its forward
intermediate ``t`` where the loop keeps the linear predictor). On a CUDA
tensor each launches ``csrc/cg_loop.cu``, on a CPU tensor it runs its
plain version, the same formulas in torch with the sums in
:func:`..utils.chains.rdot`. :func:`cg_update` takes one of two routes
by the vectors' length and the device's room for a cluster
(:func:`update_route`), both with the same bits: ``'cluster'``, one
kernel an iteration (``cg_iter``: the chain's blocks as one thread-block
cluster, m up to 65,536 in float32 and 32,768 in float64), and
``'three'``, the first design's ``cg_ap``, ``cg_step`` and ``cg_dir``,
for longer vectors or a device that holds no such cluster.

:class:`SolveGraph` holds one captured solve: the prologue (whatever
``setup`` launches, then ``cg_start``) and one iteration (``step``:
the design products and ``cg_update``), each captured with
``torch.cuda.graph`` into one private memory pool, then joined by
``bb_cg_graph_finish`` into a graph that runs the prologue and loops the
iteration inside a conditional WHILE node while any chain runs. The
kernels that set the node's condition take its handle from the state.

Inside the capture of a whole Gibbs step (``kernels.step_graph``) the
loop is built in the graph being captured instead: :func:`capture_handle`
makes the WHILE node's condition on that graph, and, once the prologue is
captured, :func:`capture_while` appends the node after it and starts
capturing a second stream (:func:`body_stream`) into the node's body,
which :func:`end_body_capture` ends (``bb_cg_capture_handle``,
``bb_cg_capture_while``, ``bb_cg_capture_end``; ``ops.cg.LoopCapture``).
:func:`cluster_while_runs` checks that a cluster launch loops in such a
body.

Launch counters: ``launches['start']``, ``launches['update']`` (one
call on the cluster route: one ``cg_iter`` launch, an iteration) and
``launches['update_three']`` (one call on the three-kernel route). A
wrapper counts where Python calls it; inside a capture that is once, so
:func:`.build.recording` keeps the captures' counts aside (and drops the
warm-up's, scratch work before them), and a solve adds the prologue's
once and the iteration's times the iterations the card ran
(:meth:`SolveGraph.count`): the state's counter ``iters``, which
``cg_start`` zeroes and the update advances once a run of the iteration,
read with the chains' counts at the solve's end.
"""

import ctypes
import gc
import threading
import weakref
from contextlib import contextmanager

import torch

from .build import count_launch, load_library, recording
from ..utils.chains import rdot, rnorm

launches = {'start': 0, 'update': 0, 'update_three': 0}
ROUTES = ('cluster', 'three')
_DTYPES = (torch.float32, torch.float64)
_VECTORS = ('x', 'r', 'p', 'sp', 'ap', 'out', 's', 'd', 'b', 'y', 't', 'rs',
            'thresh', 'alpha', 'beta', 'atol', 'n_iter', 'running', 'moved',
            'partial', 'ticket', 'done', 'iters')


def indexed(device):
    """`device` as a torch.device, a CUDA device with its index (the
    current one where it has none), so that devices compare equal."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


class CgArgs(ctypes.Structure):
    """csrc/cg_loop.cu's CgArgs."""
    _fields_ = [(name, ctypes.c_void_p) for name in _VECTORS] + [
        ('m', ctypes.c_longlong), ('n', ctypes.c_longlong),
        ('handle', ctypes.c_ulonglong), ('floor_eps', ctypes.c_double),
        ('k', ctypes.c_int),
        ('nb', ctypes.c_int), ('maxiter', ctypes.c_int),
        ('has_handle', ctypes.c_int)]


class CgState:
    """The loop's state for k chains, every tensor with k rows: the
    iterate x, the residual r, the direction p, the operator's next input
    sp = s p, the right-hand side b, the preconditioner s and the
    diagonal d of the operator (D P D), the linear predictor y ((k, n),
    or None), the squared residual norm rs, the threshold thresh, and the
    int32 iteration counts n_iter and flags running; atol is one value,
    and iters one int32, the runs of the iteration since the start.
    `floor_eps` is the eps of the float32 floor on the tolerance (the
    inputs' type's, which can be narrower than `dtype`; default
    `dtype`'s). On a CUDA device also the kernels' scratch: Ap, alpha,
    beta, moved, the sums' partials and tickets, and the condition
    handle of the graph that loops this state (0: none)."""

    def __init__(self, k, m, n, dtype, device, maxiter, floor_eps=None):
        if dtype not in _DTYPES:
            raise ValueError(f"the CG loop runs in float32 or float64, not "
                             f"{dtype}")

        def vec(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)

        self.k, self.m, self.n, self.maxiter = k, m, n, int(maxiter)
        self.dtype, self.device = dtype, indexed(device)
        self.floor_eps = float(torch.finfo(dtype).eps if floor_eps is None
                               else floor_eps)
        self.x, self.r, self.p, self.sp, self.b, self.s, self.d = (
            vec(k, m) for _ in range(7))
        self.y = vec(k, n) if n else None
        self.rs, self.thresh = vec(k), vec(k)
        self.atol = vec(1)
        self.n_iter = vec(k, dt=torch.int32)
        self.running = vec(k, dt=torch.int32)
        self.iters = vec(1, dt=torch.int32)
        self.handle = 0
        if self.device.type == 'cuda':
            self.nb = load_library().lib.bb_cg_blocks(m)
            self.ap, self.alpha, self.beta = vec(k, m), vec(k), vec(k)
            self.moved = vec(k, dt=torch.int32)
            self.partial = vec(k * 2 * self.nb)
            self.ticket = vec(k, dt=torch.int32)
            self.done = vec(1, dt=torch.int32)

    def args(self, out=None, t=None):
        """The kernels' CgArgs over this state and the operator's output
        `out` (and `t`)."""
        a = CgArgs()
        for name in _VECTORS:
            v = {'out': out, 't': t}.get(name, getattr(self, name, None))
            setattr(a, name, None if v is None else v.data_ptr())
        a.m, a.n, a.k, a.nb = self.m, self.n, self.k, self.nb
        a.maxiter, a.floor_eps = self.maxiter, self.floor_eps
        a.handle, a.has_handle = self.handle, int(self.handle != 0)
        return a

    def converged(self):
        """(k,) bools: rs <= thresh (ops/cg.py:212-215)."""
        return self.rs <= self.thresh


def _check(st, *vecs):
    for v in vecs:
        if v is not None and (v.dtype != st.dtype or v.device != st.device
                              or not v.is_contiguous()):
            raise ValueError(f"the CG loop's vectors must be contiguous "
                             f"{st.dtype} on {st.device}")


def _launch(name, st, a):
    kl = load_library()
    fn = getattr(kl.lib, name)
    with torch.cuda.device(st.device):
        stream = torch.cuda.current_stream(st.device).cuda_stream
        rc = fn(int(st.dtype == torch.float64), ctypes.byref(a), stream)
    kl.check(rc, name)


def cg_start_plain(st):
    """p = r, sp = s r, rs = r . r, thresh = max(atol, 50 eps |b|)^2 with
    eps = st.floor_eps, n_iter = 0, running = rs > thresh and maxiter > 0
    (ops/cg.py:166-174, 194), iters = 0, in place."""
    st.p.copy_(st.r)
    st.sp.copy_(st.s * st.r)
    st.rs.copy_(rdot(st.r, st.r))
    tol = torch.maximum(st.atol, 50.0 * st.floor_eps * rnorm(st.b))
    st.thresh.copy_(tol ** 2)
    st.n_iter.zero_()
    st.iters.zero_()
    st.running.copy_((st.rs > st.thresh) & (st.maxiter > 0))


def cg_start(st):
    """:func:`cg_start_plain` on the card (``cg_start``, which also sets
    the loop's condition where ``st.handle`` is a graph's)."""
    if st.device.type == 'cpu':
        return cg_start_plain(st)
    if st.device.type != 'cuda':
        raise ValueError(f"no cg_start for device {st.device}")
    _launch('bb_cg_start', st, st.args())
    count_launch(launches, 'start')


def cg_update_plain(st, out, t=None):
    """One CG iteration (ops/cg.py:177-189, 198-206) for the chains whose
    flag is set, in place; the other rows stay as they are. `out` is the
    operator's design part at sp, `t` its forward intermediate (with the
    linear predictor). Advances st.iters by one."""
    run = st.running.bool()
    keep = run[:, None]
    Ap = st.d * st.p + st.s * out
    alpha = st.rs / rdot(st.p, Ap)
    x = st.x + alpha[:, None] * st.p
    r = st.r - alpha[:, None] * Ap
    rs_new = rdot(r, r)
    p = r + (rs_new / st.rs)[:, None] * st.p
    if st.y is not None:
        st.y.copy_(torch.where(keep, st.y + alpha[:, None] * t, st.y))
    st.x.copy_(torch.where(keep, x, st.x))
    st.r.copy_(torch.where(keep, r, st.r))
    st.p.copy_(torch.where(keep, p, st.p))
    st.sp.copy_(torch.where(keep, st.s * p, st.sp))
    n_iter = st.n_iter + run.to(torch.int32)
    st.running.copy_(run & (rs_new > st.thresh) & (n_iter < st.maxiter))
    st.n_iter.copy_(n_iter)
    st.rs.copy_(torch.where(run, rs_new, st.rs))
    st.iters.add_(1)


_ROUTES = {}


def route_for(device, dtype, m, n):
    """The route :func:`cg_update` takes on the CUDA device `device` for
    vectors of length m in `dtype` and a linear predictor of n (0: none):
    ``'cluster'`` where ``cg_iter`` takes m and the device holds at least
    one of its clusters at that shape (``bb_cg_iter_fits``), else
    ``'three'``. Kept per device, type and shape; raises on a CUDA
    error."""
    device = indexed(device)
    f64 = int(dtype == torch.float64)
    key = (device.index, f64, m, n)
    if key not in _ROUTES:
        kl = load_library()
        with torch.cuda.device(device):
            rc = kl.lib.bb_cg_iter_fits(f64, m, n)
        if rc < 0:
            kl.check(-rc, 'bb_cg_iter_fits')
        _ROUTES[key] = 'cluster' if rc else 'three'
    return _ROUTES[key]


def update_route(st):
    """The route :func:`cg_update` takes on the card for the state `st`
    (:func:`route_for` at its device, type and shape)."""
    return route_for(st.device, st.dtype, st.m,
                     0 if st.y is None else st.n)


def cg_update(st, out, t=None, route=None):
    """:func:`cg_update_plain` on the card: on the route `route` (None:
    :func:`update_route`'s; ``'cluster'`` raises where ``cg_iter`` does
    not take the shape), whose update sets the loop's condition to
    any(running) where ``st.handle`` is a graph's."""
    out = out.to(st.dtype).contiguous()
    if t is not None:
        t = t.to(st.dtype).contiguous()
    if (st.y is None) != (t is None) or out.shape != (st.k, st.m):
        raise ValueError("cg_update: out must be (k, m), and t given "
                         "exactly where the state keeps y")
    if route not in (None,) + ROUTES:
        raise ValueError(f"cg_update: no route {route!r}")
    if st.device.type == 'cpu':
        return cg_update_plain(st, out, t)
    if st.device.type != 'cuda':
        raise ValueError(f"no cg_update for device {st.device}")
    _check(st, out, t)
    route = route or update_route(st)
    if route == 'cluster':
        _launch('bb_cg_iter', st, st.args(out, t))
        count_launch(launches, 'update')
    else:
        _launch('bb_cg_update', st, st.args(out, t))
        count_launch(launches, 'update_three')


def cuda_versions():
    """(built against, runtime, driver) CUDA versions of the kernel
    library, each 1000 * major + 10 * minor."""
    out = (ctypes.c_int * 3)()
    load_library().lib.bb_cg_versions(out)
    return tuple(out)


def _raise_graph(rc, what):
    built, runtime, driver = cuda_versions()
    raise RuntimeError(
        f"CG device loop: {what} failed with CUDA error {rc} "
        f"({load_library().lib.bb_error_string(rc).decode()}); conditional "
        f"WHILE nodes need CUDA 12.3 or later (library built with "
        f"{built}, runtime {runtime}, driver {driver}; torch "
        f"{torch.version.cuda})")


_BODY_STREAMS = {}
_BODY_LOCK = threading.Lock()


def body_stream(device):
    """The stream that captures the CG loop's body inside a step graph's
    capture, one per device (made on first use; the captures take turns,
    ``kernels.step_graph``)."""
    device = indexed(device)
    key = device.index
    with _BODY_LOCK:
        if key not in _BODY_STREAMS:
            _BODY_STREAMS[key] = torch.cuda.Stream(device=device)
        return _BODY_STREAMS[key]


def capture_handle(stream):
    """A condition handle made on the graph that `stream` (a
    torch.cuda.Stream) is capturing, default 0 at each launch."""
    handle = ctypes.c_ulonglong()
    rc = load_library().lib.bb_cg_capture_handle(
        ctypes.c_void_p(stream.cuda_stream), ctypes.byref(handle))
    if rc:
        _raise_graph(rc, 'the condition handle in a capture')
    return handle.value


def capture_while(stream, handle, body):
    """Append WHILE(`handle`) to the graph `stream` is capturing, after
    everything captured so far, and begin capturing the stream `body`
    into the node's body graph."""
    rc = load_library().lib.bb_cg_capture_while(
        ctypes.c_void_p(stream.cuda_stream), ctypes.c_ulonglong(handle),
        ctypes.c_void_p(body.cuda_stream))
    if rc:
        _raise_graph(rc, 'the WHILE node in a capture')


def end_body_capture(body):
    """End the capture of the WHILE node's body on the stream `body`."""
    rc = load_library().lib.bb_cg_capture_end(
        ctypes.c_void_p(body.cuda_stream))
    if rc:
        _raise_graph(rc, 'the end of the WHILE body\'s capture')


def child_while_error():
    """The CUDA error with which a graph holding a WHILE node is refused
    as another graph's child node (0 where it is taken; negative where
    the probe itself failed): why the step graph adds its WHILE node
    during the capture rather than the CG solve's graph as a child."""
    return load_library().lib.bb_cg_child_while_probe()


def cluster_while_runs(want=5):
    """The runs of a WHILE node's body that holds one cluster launch
    (captured as the step graph captures the CG iteration) and loops
    until `want` runs (``bb_cg_cluster_while_probe``): `want` where CUDA
    takes a cluster kernel in a conditional body."""
    runs = ctypes.c_int()
    rc = load_library().lib.bb_cg_cluster_while_probe(
        int(want), ctypes.byref(runs))
    if rc:
        _raise_graph(rc, 'a cluster launch in a WHILE body')
    return runs.value


class SolveGraph:
    """One solve's graph over the state `st`: ``setup()`` (torch ops
    and design products that fill st.x, st.r, st.b, st.s, st.d and st.y
    from static inputs) then :func:`cg_start`, and ``step()`` (the
    operator at st.sp, then :func:`cg_update`) looped while any chain
    runs. ``warm()`` runs the same work once on scratch copies before
    the captures, so that lazy work (the library's load, layouts,
    handles) happens outside them. `counters` gives the (object,
    attribute) pairs of other counters a product advances (the design's
    matvec counts), restored after the captures and advanced by
    :meth:`count`; the graph holds the objects weakly (the design keeps
    its graphs). The interpreter's garbage collector is off during the
    captures: a collection there could free another graph or its memory
    pool, a call that ends the capture."""

    def __init__(self, st, setup, step, warm, counters=()):
        if st.device.type != 'cuda':
            raise ValueError("SolveGraph: a CUDA state")
        self.st = st
        lib = load_library().lib
        before = [getattr(o, a) for o, a in counters]
        with recording():
            warm()
        torch.cuda.synchronize(st.device)
        graph, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
        rc = lib.bb_cg_graph_new(ctypes.byref(graph), ctypes.byref(handle))
        if rc:
            _raise_graph(rc, 'cudaGraphConditionalHandleCreate')
        self._graph = graph
        st.handle = handle.value
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(st.device)
        self.captures, self.counts, self.matvecs = [], [], []
        pool = None
        gc.disable()
        try:
            for fn in (lambda: (setup(), cg_start(st)), step):
                g = torch.cuda.CUDAGraph(keep_graph=True)
                mark = [getattr(o, a) for o, a in counters]
                with recording() as rec:
                    with torch.cuda.device(st.device), torch.cuda.graph(
                            g, pool=pool, capture_error_mode='thread_local'):
                        fn()
                self.counts.append(rec)
                self.matvecs.append([getattr(o, a) - v for (o, a), v
                                     in zip(counters, mark)])
                self.captures.append(g)
                pool = g.pool()
        finally:
            gc.enable()
        for (o, a), v in zip(counters, before):
            setattr(o, a, v)
        self._counters = [(weakref.ref(o), a) for o, a in counters]
        self.pool_bytes = torch.cuda.memory_reserved(st.device) - reserved
        exec_ = ctypes.c_void_p()
        rc = lib.bb_cg_graph_finish(
            graph, handle, ctypes.c_void_p(self.captures[0].raw_cuda_graph()),
            ctypes.c_void_p(self.captures[1].raw_cuda_graph()),
            ctypes.byref(exec_))
        if rc:
            _raise_graph(rc, 'the WHILE graph\'s instantiation')
        self._exec = exec_
        self.lock = threading.Lock()

    def launch(self):
        """One launch of the solve on the current stream (bracketed by
        CUDA events inside :func:`timed_launches`)."""
        kl = load_library()
        timed = _TIMED
        with torch.cuda.device(self.st.device):
            stream = torch.cuda.current_stream(self.st.device)
            if timed is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            rc = kl.lib.bb_cg_graph_launch(self._exec, stream.cuda_stream)
            if timed is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                timed.append((start, end))
        kl.check(rc, 'CG device loop')

    def count(self, iterations):
        """Advance the counters by one solve that ran `iterations`
        iterations of the loop: the prologue's launches once, the
        iteration's `iterations` times."""
        for rec, times in zip(self.counts, (1, iterations)):
            for counter, key, n in rec:
                count_launch(counter, key, n * times)
        for deltas, times in zip(self.matvecs, (1, iterations)):
            for (ref, a), v in zip(self._counters, deltas):
                o = ref()
                if o is not None:
                    setattr(o, a, getattr(o, a) + v * times)

    def __del__(self):
        try:
            load_library().lib.bb_cg_graph_free(
                getattr(self, '_exec', None), self._graph)
        except Exception:  # noqa: BLE001  (no raise under GC)
            pass


_TIMED = None  # the (start, end) events of the graph launches, or None


@contextmanager
def timed_launches():
    """Within the block, every graph launch (in any thread: a solve
    graph's, and a step graph's replay, ``kernels.step_graph``) is
    bracketed by CUDA events, collected in the yielded list as (start,
    end) pairs: after a synchronize, ``start.elapsed_time(end)`` is the
    graph's time on the card, which a profiler trace does not always
    hold (its kernels launched by the graph carry no launch call of their
    own, and those launched as clusters are missing from the trace)."""
    global _TIMED
    prev, _TIMED = _TIMED, []
    try:
        yield _TIMED
    finally:
        _TIMED = prev
