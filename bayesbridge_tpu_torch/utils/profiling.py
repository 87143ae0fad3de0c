"""Profiling helpers.

Port of ``bayesbridge_tpu/utils/profiling.py`` on ``torch.profiler``.
The sampler's own counters (design matvec counts, CG iterations) ride in
``mcmc_info['_reg_coef_sampling_info']``; for an op-level timeline these
wrappers record host and device activity of a block and write it as a
Chrome trace (open it in Perfetto or ``chrome://tracing``):

    from bayesbridge_tpu_torch.utils.profiling import (
        annotate, op_stats_from_trace, trace)

    with trace('bb-profile'):
        with annotate('resume'):
            bridge.gibbs_resume(info, 3)
    rows = op_stats_from_trace('bb-profile')  # device ops, by name
    spans = span_stats('bb-profile')  # time inside each annotate span

Named regions inside user code are marked with ``annotate("label")``;
the eager Gibbs step marks its phases (``gibbs:step``, and inside it
``gibbs:coef`` with ``gibbs:cg_presolve`` and ``gibbs:cg_solve``, then
``gibbs:lin_pred``, ``gibbs:obs_prec``, ``gibbs:scales``,
``gibbs:logp``); where the step runs as a graph, one ``gibbs:step``
span holds each replay, whose device work the trace does not attribute
(``kernels.cg_loop.timed_launches`` times it).
"""

import glob
import json
import os
from contextlib import contextmanager

import torch

TRACE_FILE = 'trace.json'
# Chrome-trace categories of work that ran on the card.
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


@contextmanager
def trace(log_dir):
    """Record the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA activity where a card is visible) and write it to
    ``log_dir/trace.json`` as a Chrome trace. Reentrancy-safe: a nested
    call records nothing of its own, the outermost block covers it.
    Yields the profiler (None inside a nested call)."""
    if getattr(trace, '_active', False):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    trace._active = True
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    finally:
        trace._active = False


def annotate(name):
    """Context manager naming a region on the profiler timeline."""
    return torch.profiler.record_function(name)


def _trace_events(log_dir):
    """The complete ('X') events of every :func:`trace` capture under
    `log_dir`."""
    paths = sorted(glob.glob(os.path.join(log_dir, '**', TRACE_FILE),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f'no {TRACE_FILE} under {log_dir}')
    events = []
    for path in paths:
        with open(path) as f:
            data = json.load(f)
        events += [e for e in (data.get('traceEvents', [])
                               if isinstance(data, dict) else data)
                   if e.get('ph') == 'X' and 'dur' in e]
    return events


def _self_times(events):
    """Each complete event's duration less its children's on the same
    thread (events nest by their time spans)."""
    self_us = {}
    by_thread = {}
    for i, e in enumerate(events):
        by_thread.setdefault((e.get('pid'), e.get('tid')), []).append(i)
    for ids in by_thread.values():
        ids.sort(key=lambda i: (events[i]['ts'], -events[i]['dur']))
        stack = []  # (index, end)
        for i in ids:
            start = events[i]['ts']
            while stack and stack[-1][1] <= start:
                stack.pop()
            self_us[i] = float(events[i]['dur'])
            if stack:
                self_us[stack[-1][0]] -= float(events[i]['dur'])
            stack.append((i, start + events[i]['dur']))
    return self_us


def op_stats_from_trace(log_dir, device_only=True):
    """Parse a :func:`trace` capture into per-op timing rows, one per
    (device or host, category, name)::

        {'device': bool, 'type': 'kernel', 'name': 'void ...',
         'occurrences': 12, 'total_us': 340.2, 'self_us': 340.2,
         'flop_rate_gflops': None, 'memory_bw_gbps': None,
         'bound_by': None}

    the keys of the JAX package's rows (profiling.py:54-118); torch's
    profiler measures no FLOP rate, bandwidth or bound, so those are
    None. `device_only` keeps the card's kernels, copies and fills;
    ``self_us`` is the time less the nested host events' (on the card,
    the time)."""
    events = _trace_events(log_dir)
    rows = {}
    self_us = _self_times(events)
    for i, e in enumerate(events):
        cat = e.get('cat', '')
        on_device = cat in DEVICE_CATEGORIES
        if device_only and not on_device:
            continue
        row = rows.setdefault((on_device, cat, e.get('name', '')), {
            'device': on_device, 'type': cat, 'name': e.get('name', ''),
            'occurrences': 0, 'total_us': 0.0, 'self_us': 0.0,
            'flop_rate_gflops': None, 'memory_bw_gbps': None,
            'bound_by': None})
        row['occurrences'] += 1
        row['total_us'] += float(e['dur'])
        row['self_us'] += float(e['dur']) if on_device else self_us[i]
    return sorted(rows.values(), key=lambda r: -r['total_us'])


def span_stats(log_dir, prefix=''):
    """Host and device time of the :func:`annotate` spans (those whose
    name starts with `prefix`) of a :func:`trace` capture, by name::

        {'gibbs:cg_solve': {'count': 3, 'wall_ms': 41.2,
                            'device_ms': 12.9}, ...}

    and under ``''`` the whole capture's (``count`` 1, ``wall_ms`` None).
    ``wall_ms`` sums the spans' durations on the host's clock;
    ``device_ms`` sums the device events (kernels, copies, fills) whose
    launch call the host made inside a span of that name (matched by its
    correlation id), wherever on the device's timeline they ran. Work a
    CUDA graph ran is left out: its kernels carry the graph launch's
    correlation id or none, and the trace misses some of them
    (``kernels.cg_loop.timed_launches`` times the CG loop's graphs)."""
    events = _trace_events(log_dir)
    spans = [e for e in events if e.get('cat') == 'user_annotation'
             and e.get('name', '').startswith(prefix)]
    calls = {e['args']['correlation']: e for e in events
             if e.get('cat') in ('cuda_runtime', 'cuda_driver')
             and 'correlation' in e.get('args', {})}
    out = {'': {'count': 1, 'wall_ms': None, 'device_ms': 0.0}}
    for e in spans:
        row = out.setdefault(e['name'], {'count': 0, 'wall_ms': 0.0,
                                         'device_ms': 0.0})
        row['count'] += 1
        row['wall_ms'] += e['dur'] / 1e3
    for d in events:
        if d.get('cat') not in DEVICE_CATEGORIES:
            continue
        call = calls.get(d.get('args', {}).get('correlation'))
        if call is None or 'GraphLaunch' in call.get('name', ''):
            continue
        out['']['device_ms'] += d['dur'] / 1e3
        where = (call.get('pid'), call.get('tid'))
        for e in spans:
            if (e.get('pid'), e.get('tid')) == where \
                    and e['ts'] <= call['ts'] < e['ts'] + e['dur']:
                out[e['name']]['device_ms'] += d['dur'] / 1e3
    return out
