"""Per-lane rejection loops in PyTorch.

The JAX package runs its rejection samplers through a lane-compaction
loop (``bayesbridge_tpu/random/rejection.py``) shaped by the TPU's
lane width. Eager PyTorch compacts for free: each round draws only for
the lanes still running, picked by boolean indexing, so the straggler
tail costs what it draws. One host sync per round reads how many lanes
remain.

Every lane runs its own chain to its own acceptance (no replicas, the
``tail_replicas=1`` semantics of the JAX loop): a first-finisher pick
among replicated chains would bias any sampler whose acceptance time
correlates with its value, as the Polya-Gamma two-piece proposal's does.
"""

import torch


def uniform_open(gen, shape, like):
    """Uniform on (0, 1) with `like`'s dtype and device: open at zero so
    downstream logs stay finite."""
    tiny = torch.finfo(like.dtype).tiny
    return torch.rand(shape, generator=gen, dtype=like.dtype,
                      device=like.device).clamp_min_(tiny)


def normal(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def run_rejection(gen, params, state, attempt, value_init, max_rounds,
                  latch='on_accept', widen_to=0):
    """Run every lane's chain until it accepts or `max_rounds` pass.

    attempt(gen, params, state) -> (state, value, ok) makes one proposal
    round for the given (active) lanes; params and state are dicts of
    equal-length 1-d tensors. `latch='on_accept'` records a lane's value
    when it accepts (a capped lane keeps its `value_init` entry);
    'every_round' records the candidate on every round the lane runs (for
    chains whose value accumulates, a capped lane keeps its progress).

    `widen_to` (memoryless chains only: empty `state`, iid attempts):
    once fewer than `widen_to` lanes remain, each round makes
    ``widen_to // lanes`` attempts per lane side by side and keeps each
    lane's first accepted attempt in attempt order — the same law as
    making them one after another, in far fewer rounds for the straggler
    tail. A round still counts once against `max_rounds`.
    """
    if widen_to and (state or latch != 'on_accept'):
        raise ValueError("widen_to needs memoryless on_accept chains")
    value = value_init.clone()
    idx = torch.arange(value.shape[0], device=value.device)
    for _ in range(max_rounds):
        if idx.numel() == 0:
            break
        k = widen_to // idx.numel() if widen_to else 1
        if k > 1:
            wide = {key: v.repeat(k) for key, v in params.items()}
            _, val, ok = attempt(gen, wide, {})
            ok, val = ok.view(k, -1), val.view(k, -1)
            first = ok.to(torch.int8).argmax(dim=0, keepdim=True)
            val = val.gather(0, first)[0]
            ok = ok.any(dim=0)
        else:
            state, val, ok = attempt(gen, params, state)
        if latch == 'every_round':
            value[idx] = val
        else:
            value[idx[ok]] = val[ok]
        keep = ~ok
        idx = idx[keep]
        params = {key: v[keep] for key, v in params.items()}
        state = {key: v[keep] for key, v in state.items()}
    return value
