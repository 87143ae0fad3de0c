"""Per-lane rejection loops in PyTorch, for one chain or several side by
side: the plain route of the Polya-Gamma and tilted-stable samplers.

The JAX package runs its rejection samplers through a lane-compaction
loop (``bayesbridge_tpu/random/rejection.py``) shaped by the TPU's
lane width, one device program per draw. On the card the port runs them
as hand-written kernels, one thread a lane (``csrc/polya_gamma.cu``,
``csrc/tilted_stable.cu``, :mod:`..kernels.draws`); the rounds here are
their plain versions, which the CPU runs (and the chip smoke calls on
the card to compare). Eager PyTorch compacts for free: each round draws
only for the lanes still running, picked by boolean indexing, so the
straggler tail costs what it draws. The host syncs a fixed number of
times per round, however many chains run.

Every lane runs its own chain to its own acceptance (no replicas, the
``tail_replicas=1`` semantics of the JAX loop): a first-finisher pick
among replicated chains would bias any sampler whose acceptance time
correlates with its value, as the Polya-Gamma two-piece proposal's does.

Several Markov chains run their rounds side by side: the lanes are laid
out chain after chain, and each chain's lanes draw from that chain's
own generator (:class:`LaneStreams`), in the amounts and the order its
loop alone would draw them. Chain c of a batch therefore gets the same
numbers as chain c run alone, draw for draw; the JAX package keeps the
same property under ``vmap`` with one key per chain.
"""

import itertools

import torch


class LaneStreams:
    """Generators for lanes laid out chain after chain: chain c owns the
    next ``counts[c]`` lanes and draws them from ``gens[c]``."""

    def __init__(self, gens, counts):
        self.gens = list(gens)
        self.counts = [int(c) for c in counts]

    def draw(self, fn, like):
        """fn(gen, count) per chain with lanes, concatenated in lane
        order; a chain without lanes draws nothing."""
        parts = [fn(g, c) for g, c in zip(self.gens, self.counts) if c]
        if not parts:
            return torch.empty(0, dtype=like.dtype, device=like.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)


def _streams(gen, n):
    return gen if isinstance(gen, LaneStreams) else LaneStreams([gen], [n])


def uniform_open(gen, shape, like):
    """Uniform on (0, 1) with `like`'s dtype and device, one per lane of
    the 1-d `shape`: open at zero so downstream logs stay finite. `gen`
    is a torch.Generator or a :class:`LaneStreams`."""
    tiny = torch.finfo(like.dtype).tiny
    return _streams(gen, shape[0]).draw(
        lambda g, c: torch.rand(c, generator=g, dtype=like.dtype,
                                device=like.device), like).clamp_min_(tiny)


def normal(gen, shape, like):
    return _streams(gen, shape[0]).draw(
        lambda g, c: torch.randn(c, generator=g, dtype=like.dtype,
                                 device=like.device), like)


def _keep_counts(keep, counts):
    """Per-chain number of True entries of `keep` (lanes chain after
    chain, `counts` per chain), read to the host in one sync."""
    chain = torch.repeat_interleave(
        torch.arange(len(counts), device=keep.device),
        torch.as_tensor(counts, device=keep.device))
    return torch.zeros(len(counts), dtype=torch.int64,
                       device=keep.device).index_add_(
        0, chain, keep.to(torch.int64)).tolist()


def run_rejection(gen, params, state, attempt, value_init, max_rounds,
                  latch='on_accept', widen_to=0, counts=None):
    """Run every lane's chain until it accepts or `max_rounds` pass.

    attempt(streams, params, state) -> (state, value, ok) makes one
    proposal round for the given (active) lanes; params and state are
    dicts of equal-length 1-d tensors, `streams` a :class:`LaneStreams`
    over them. `latch='on_accept'` records a lane's value when it
    accepts (a capped lane keeps its `value_init` entry);
    'every_round' records the candidate on every round the lane runs
    (for chains whose value accumulates, a capped lane keeps its
    progress).

    `gen` is one torch.Generator, or a sequence of them with `counts`
    (lanes per Markov chain, the lanes laid out chain after chain): the
    chains' rounds run side by side, each chain's lanes drawing from its
    own generator.

    `widen_to` (memoryless chains only: empty `state`, iid attempts):
    once a chain has fewer than `widen_to` lanes left, each round makes
    ``widen_to // lanes`` attempts per lane of that chain side by side
    and keeps each lane's first accepted attempt in attempt order — the
    same law as making them one after another, in far fewer rounds for
    the straggler tail. A round still counts once against `max_rounds`.
    """
    if widen_to and (state or latch != 'on_accept'):
        raise ValueError("widen_to needs memoryless on_accept chains")
    gens = [gen] if counts is None else list(gen)
    counts = [value_init.shape[0]] if counts is None else list(counts)
    value = value_init.clone()
    idx = torch.arange(value.shape[0], device=value.device)
    for _ in range(max_rounds):
        if not sum(counts):
            break
        widths = [widen_to // c if widen_to and c else 1 for c in counts]
        if max(widths) > 1:
            val, ok = _wide_attempt(gens, counts, widths, params, attempt)
        else:
            state, val, ok = attempt(LaneStreams(gens, counts), params,
                                     state)
        if latch == 'every_round':
            value[idx] = val
        else:
            value[idx[ok]] = val[ok]
        keep = ~ok
        idx = idx[keep]
        counts = [idx.numel()] if len(counts) == 1 \
            else _keep_counts(keep, counts)
        params = {key: v[keep] for key, v in params.items()}
        state = {key: v[keep] for key, v in state.items()}
    return value


def _wide_attempt(gens, counts, widths, params, attempt):
    """One round with ``widths[c]`` attempts per lane of chain c: (value,
    ok) of each lane's first accepted attempt."""
    starts = [0, *itertools.accumulate(counts)][:-1]
    wide = {key: torch.cat([v[s:s + c].repeat(w) for s, c, w
                            in zip(starts, counts, widths)])
            for key, v in params.items()}
    _, val, ok = attempt(
        LaneStreams(gens, [c * w for c, w in zip(counts, widths)]), wide,
        {})
    vals, oks, s = [], [], 0
    for c, w in zip(counts, widths):
        ok_c = ok[s:s + c * w].view(w, c)
        val_c = val[s:s + c * w].view(w, c)
        first = ok_c.to(torch.int8).argmax(dim=0, keepdim=True)
        vals.append(val_c.gather(0, first)[0])
        oks.append(ok_c.any(dim=0))
        s += c * w
    return torch.cat(vals), torch.cat(oks)
