"""One Gibbs iteration of k chains as one CUDA graph on one card.

Counterpart of the JAX package's chain runner, ``run_chain``
(``bayesbridge_tpu/step.py:320-376``): a ``lax.scan`` of
``lax.fori_loop``s over the jitted Gibbs step, one device program for
the whole run. Here the step is :func:`..step.step_into` over fixed
buffers (:class:`..step.StepState`), captured once with
``torch.cuda.graph`` into a :class:`StepGraph`: the b-vector noise, the
warm start and the pre-solve reductions, the preconditioner, the CG solve
(its prologue inline, then a conditional WHILE node whose body is the
captured iteration, ``ops.cg.LoopCapture``), the coefficient read-out and
the summarizer, the Polya-Gamma or Gamma observation precision, the
scales, the log density and every counter. Each iteration is one
``replay()``; the host runs ahead of the card and waits on it only at
the run's end (``step.run_chains``). The graph replays the kernels the
eager step launches, on the same inputs, so it gives the eager step's
bits.

Random draws: the chains draw from generators private to the graph,
registered with it (``CUDAGraph.register_generator_state``), whose
states a run sets from the chains' generators and hands back at its end.
``replay()`` runs torch's prologue for each: the captured kernels read
the generator's seed and Philox offset from the card, set at each replay
to the generator's current offset, which then advances by what one eager
step consumes. A graph launched outside ``replay()`` would rerun the
capture's offsets, and every iteration would draw the same noise.

Discipline (as the CG solve's graph, ``kernels.cg_loop.SolveGraph``): a
warm-up on scratch copies before the capture (lazy layouts, handles,
library workspaces; the CG loop's body stream included); the
interpreter's collector off during the capture; the design's memo off;
the step's allocations from the graph's pool, the WHILE body's from a
second pool of the graph's own; every tensor made outside the capture
that the graph reads kept alive with it (the state's buffers, the
configuration's cached tensors); the graph kept on the design that owns
it, for its model (:func:`graph_of`), never shared with a shallow copy
of either.

Launch counters: the capture's launches are recorded aside
(``build.recording``); a run adds the step's once a replay and the CG
iteration's times the runs of the iteration the card counted, read with
the outputs at the run's end, and checks those against the sum of each
solve's max(n_cg_iter).
"""

import gc
import threading
import time
import weakref

import torch

from . import cg_loop
from .build import count_launch, recording
from .cg_loop import indexed
from ..ops import cg
from ..utils.profiling import annotate

_GRAPHS_ATTR = '_step_graphs'
_BUILD_LOCK = threading.Lock()


def _graphs_of(design):
    """The design's step graphs by key, kept on the design with a weak
    reference to it (a shallow copy captures its own, as
    ``ops.cg._loops_of``)."""
    owner, graphs = design.__dict__.get(_GRAPHS_ATTR, (None, None))
    if owner is None or owner() is not design:
        graphs = {}
        design.__dict__[_GRAPHS_ATTR] = (weakref.ref(design), graphs)
    return graphs


def _layout(tree, path=()):
    """The (path, dtype, shape) of every tensor of a carry."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += _layout(val, path + (key,))
        else:
            val = torch.as_tensor(val)
            out.append((path + (key,), val.dtype, tuple(val.shape)))
    return tuple(out)


def graph_of(cfg, model, gens, carry, step, make_state):
    """The step graph of `model` (its design on one CUDA device) for this
    configuration (``cfg.key()``: every setting the step reads), chain
    count, carry layout and device, captured on first use (`step` the
    step function, `make_state` the state class) and kept on the
    design."""
    design = model.design
    device = indexed(design.device)
    key = (id(model), cfg.key(), len(gens), _layout(carry), device)
    with _BUILD_LOCK:
        graphs = _graphs_of(design)
        graph = graphs.get(key)
        if graph is None or graph.model() is not model:
            graph = graphs[key] = StepGraph(cfg, model, gens, carry, step,
                                            make_state)
    return graph


class StepGraph:
    """One Gibbs step of k chains captured on the card. ``state`` is the
    chain in fixed buffers (a :class:`..step.StepState`), ``gens`` the
    graph's generators, ``lock`` held for a run. A run: :meth:`load`,
    :meth:`replay` once an iteration, :meth:`finish` with the CG
    accumulators read to the host, :meth:`store`. ``build_seconds`` and
    ``pool_bytes`` describe the capture."""

    def __init__(self, cfg, model, gens, carry, step, make_state):
        t0 = time.perf_counter()
        design = model.design
        self.device = device = indexed(design.device)
        self.model = weakref.ref(model)
        # The configuration of the capture, kept: the graph reads the
        # tensors it caches (``cfg.prior_sd_on``), and a run's own cfg
        # (equal by ``cfg.key()``) may be gone before the next run.
        self.cfg = cfg
        self.gens = [torch.Generator(device=device) for _ in gens]
        for mine, theirs in zip(self.gens, gens):
            mine.set_state(theirs.get_state())
        counters = design.counters()
        before = [getattr(o, a) for o, a in counters]
        memo, design.memoized = design.memoized, False
        try:
            # The warm-up: the same step once on scratch copies (its
            # draws from the graph's generators, whose states each run
            # sets), the CG solves on the host loop.
            scratch = make_state(carry)
            with recording(), cg.solving(cg.WarmUp()):
                step(cfg, model, self.gens, scratch)
            torch.cuda.synchronize(device)
            self.state = make_state(carry, like=scratch)
            del scratch
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            self.graph = graph = torch.cuda.CUDAGraph()
            for gen in self.gens:
                graph.register_generator_state(gen)
            self.loops = loops = cg.LoopCapture(device, counters)
            mark = [getattr(o, a) for o, a in counters]
            gc.disable()
            try:
                with recording() as rec, cg.solving(loops):
                    with torch.cuda.device(device), torch.cuda.graph(
                            graph, capture_error_mode='thread_local'):
                        step(cfg, model, self.gens, self.state)
            finally:
                gc.enable()
            self.counts = rec
            # The design counters' steps of the CG bodies (a run adds them
            # times the runs of the iteration) and of the rest of the
            # step (once a replay).
            self.bodies = [sum(deltas) for deltas in zip(*loops.matvecs)] \
                or [0] * len(counters)
            self.matvecs = [getattr(o, a) - v - body for (o, a), v, body
                            in zip(counters, mark, self.bodies)]
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        finally:
            design.memoized = memo
            for (o, a), v in zip(counters, before):
                setattr(o, a, v)
        self._counters = [(weakref.ref(o), a) for o, a in counters]
        self.replays = 0
        self.lock = threading.Lock()
        self.build_seconds = time.perf_counter() - t0

    def load(self, carry, gens):
        """Start a run: the carry's values into the state's buffers, the
        chains' generator states into the graph's."""
        self.state.load(carry)
        for mine, theirs in zip(self.gens, gens):
            mine.set_state(theirs.get_state())
        self.replays = 0

    def replay(self):
        """One Gibbs iteration: one launch of the graph on the current
        stream (bracketed by CUDA events inside
        ``cg_loop.timed_launches``)."""
        timed = cg_loop._TIMED
        with torch.cuda.device(self.device), annotate('gibbs:step'):
            if timed is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            self.graph.replay()
            if timed is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                timed.append((start, end))
        self.replays += 1

    def finish(self, acc):
        """End a run given the CG accumulators read to the host, [runs of
        the loop's iteration, sum of max(n_cg_iter)]: check that they
        agree and advance the launch and design counters by the run."""
        runs, want = int(acc[0]), int(acc[1])
        if runs != want:
            raise RuntimeError(
                f"step graph: the CG iteration ran {runs} times over "
                f"{self.replays} iterations, the solves' max(n_cg_iter) "
                f"sum to {want}")
        for counter, key, n in self.counts:
            count_launch(counter, key, n * self.replays)
        for rec in self.loops.counts:
            for counter, key, n in rec:
                count_launch(counter, key, n * runs)
        for (ref, a), v, body in zip(self._counters, self.matvecs,
                                     self.bodies):
            o = ref()
            if o is not None:
                setattr(o, a, getattr(o, a) + v * self.replays + body * runs)

    def store(self, gens):
        """Hand the graph's generator states back to the chains'."""
        for mine, theirs in zip(self.gens, gens):
            theirs.set_state(mine.get_state())

    def __del__(self):
        # The executable graph first, then the WHILE bodies' pool.
        try:
            self.graph = None
            loops = getattr(self, 'loops', None)
            if loops is not None:
                torch._C._cuda_releasePool(self.device.index, loops.pool)
        except Exception:  # noqa: BLE001  (no raise under GC)
            pass
