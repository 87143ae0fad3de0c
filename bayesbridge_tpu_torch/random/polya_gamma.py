"""Vectorized Polya-Gamma sampler (Devroye's alternating-series method).

Port of ``bayesbridge_tpu/random/polya_gamma.py`` (reference:
bayesbridge/random/polya_gamma/polya_gamma.pyx:15-216). A PG(1, tilt)
draw is ``X = J*(|tilt|/2) / 4`` where J* is the tilted Jacobi
distribution, sampled by accept/reject with a proposal mixing a
left-truncated exponential (right piece) and a right-truncated
inverse-Gaussian (left piece), split at 2/pi, and an alternating-series
acceptance test truncated at 100 terms.

:func:`sample_polya_gamma_chains` draws for several Markov chains at
once, each chain's lanes from its own generator, and equals the chains
drawn one at a time. It is the one dispatch point: on the card the
hand-written kernel ``csrc/polya_gamma.cu`` runs each lane's rejection
chain in a thread (:mod:`..kernels.draws`); on the CPU the plain version
(:func:`sample_polya_gamma_plain`) flattens the scalar nested loops into
one lane-parallel state machine run by :func:`.rejection.run_rejection`
on a ``torch.Generator``: each round advances every unfinished lane by
one attempt of whatever stage it is in. Integer shapes > 1 expand each
lane into ``shape`` unit-shape lanes and sum back.
"""

import math

import numpy as np
import torch

from ..kernels.draws import PG_MAX_ROUNDS as _MAX_REJECTION_ROUNDS
from ..kernels.draws import polya_gamma_draw
from .rejection import normal, run_rejection, uniform_open

THRESHOLD = 2.0 / math.pi  # proposal split point (polya_gamma.pyx:26)
MAX_SERIES_TERMS = 100     # series truncation (polya_gamma.pyx:27)


def _log_series_term(n, x):
    """log of the n-th term of the Jacobi density alternating series
    (polya_gamma.pyx:142-148)."""
    n_half = n + 0.5
    log_base = math.log(math.pi * n_half)
    small_x = log_base - 1.5 * torch.log(0.5 * x * math.pi) \
        - 2.0 * n_half ** 2 / x
    large_x = log_base - 0.5 * x * math.pi ** 2 * n_half ** 2
    return torch.where(x <= THRESHOLD, small_x, large_x)


def _series_term(n, x):
    return torch.exp(_log_series_term(n, x))


def _prob_right_piece(tilt, exp_rate):
    """Probability that the proposal comes from the exponential (right)
    piece (polya_gamma.pyx:131-140)."""
    log_mass_expo = -torch.log(exp_rate) - exp_rate * THRESHOLD \
        + math.log(0.25 * math.pi)
    sqrt_t = math.sqrt(THRESHOLD)
    log_ndtr = torch.special.log_ndtr
    log_mass_invg_1 = -tilt + log_ndtr((THRESHOLD * tilt - 1.0) / sqrt_t)
    log_mass_invg_2 = tilt + log_ndtr(-(THRESHOLD * tilt + 1.0) / sqrt_t)
    mass_ratio = torch.exp(log_mass_invg_1 - log_mass_expo) \
        + torch.exp(log_mass_invg_2 - log_mass_expo)
    return 1.0 / (1.0 + mass_ratio)


def _series_acceptance(u, x, zeroth_term, max_terms):
    """Devroye's alternating-series accept test, truncated at `max_terms`
    (polya_gamma.pyx:150-174): odd partial sums lower-bound the density
    (accept if U <= sum), even ones upper-bound it (reject if U > sum);
    a lane still undecided at the cap takes the lower bound (accepts)."""
    acc = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    partial = zeroth_term.clone()
    active = torch.arange(x.shape[0], device=x.device)
    sign, n = -1.0, 1
    while active.numel() and n < max_terms:
        xa = x[active]
        part = partial[active] + sign * _series_term(float(n), xa)
        ua = u[active]
        if sign < 0:
            newly_acc = ua <= part
            newly_rej = torch.zeros_like(newly_acc)
        else:
            newly_rej = ua > part
            newly_acc = torch.zeros_like(newly_rej)
        hit_cap = n + 1 >= max_terms
        acc[active] = newly_acc | (~newly_rej & hit_cap)
        partial[active] = part
        done = newly_acc | newly_rej | hit_cap
        active = active[~done]
        sign, n = -sign, n + 1
    return acc


def _invgauss_attempt(gen, rate):
    """One joint attempt at an Inverse-Gaussian(1/rate, shape=1) draw
    truncated to (0, 2/pi) (polya_gamma.pyx:192-216): the inverted
    truncated chi-squared with its two acceptance tests in one shot when
    the mean exceeds the threshold, else Michael-Schucany-Haas accepted
    below the threshold. Returns (candidate, accepted) per lane."""
    shape = rate.shape
    mean = 1.0 / rate
    use_chisq = mean > THRESHOLD
    u1 = uniform_open(gen, shape, rate)
    u2 = uniform_open(gen, shape, rate)
    u3 = uniform_open(gen, shape, rate)
    v = normal(gen, shape, rate) ** 2

    e = 0.5 * math.pi - 2.0 * torch.log1p(-u1)
    x_a = 1.0 / e
    ok_a = (u2 <= torch.sqrt(0.5 * math.pi / e)) \
        & (torch.log(u3) < -0.5 * x_a * rate ** 2)

    mv = mean * v
    x_b = mean + 0.5 * mean * (mv - torch.sqrt(4.0 * mv + mv ** 2))
    flip = u2 > mean / (mean + x_b)
    x_b = torch.where(flip, mean ** 2 / x_b, x_b)
    ok_b = x_b < THRESHOLD
    return torch.where(use_chisq, x_a, x_b), torch.where(use_chisq, ok_a,
                                                         ok_b)


def _rand_tilted_jacobi(gens, counts, tilt, max_rounds):
    """Tilted Jacobi J*(tilt) draws (polya_gamma.pyx:103-129). Lane
    stages: acquiring a proposal (the inverse-Gaussian piece may take
    several rounds), then the series test; a failed series test restarts
    the lane."""
    exp_rate = 0.5 * tilt ** 2 + 0.125 * math.pi ** 2
    p_right = _prob_right_piece(tilt, exp_rate)
    rate = torch.clamp_min(tilt, 1e-7)

    def attempt(g, p, s):
        lanes = p['rate'].shape
        fresh = ~s['ig_pending']
        from_right = uniform_open(g, lanes, p['rate']) < p['p_right']
        x_right = THRESHOLD - torch.log1p(
            -uniform_open(g, lanes, p['rate'])) / p['exp_rate']
        ig_lane = (fresh & ~from_right) | s['ig_pending']
        ig_cand, ig_ok = _invgauss_attempt(g, p['rate'])
        right = fresh & from_right
        have_x = right | (ig_lane & ig_ok)
        x = torch.where(right, x_right, ig_cand)
        ig_pending = ig_lane & ~ig_ok
        zeroth = _series_term(0.0, x)
        u = uniform_open(g, lanes, p['rate']) * zeroth
        ok = torch.zeros_like(have_x)
        ok[have_x] = _series_acceptance(u[have_x], x[have_x],
                                        zeroth[have_x], MAX_SERIES_TERMS)
        return dict(ig_pending=ig_pending), x, ok

    return run_rejection(
        gens, params=dict(exp_rate=exp_rate, p_right=p_right, rate=rate),
        state=dict(ig_pending=torch.zeros(tilt.shape, dtype=torch.bool,
                                          device=tilt.device)),
        attempt=attempt, value_init=torch.zeros_like(tilt),
        max_rounds=max_rounds, counts=counts)


def _unit_shape_chains(gens, tilt, max_rounds):
    """PG(1, tilt) draws for tilt (k, m), row c from gens[c]."""
    k, m = tilt.shape
    draws = _rand_tilted_jacobi(gens, [m] * k, 0.5 * tilt.abs().reshape(-1),
                                max_rounds)
    return 0.25 * draws.reshape(tilt.shape)


def sample_unit_shape_polya_gamma(gen, tilt,
                                  max_rounds=_MAX_REJECTION_ROUNDS):
    """PG(1, tilt) draws, one per element of `tilt`
    (polya_gamma.pyx:97-101)."""
    return _unit_shape_chains([gen], tilt.reshape(1, -1),
                              max_rounds).reshape(tilt.shape)


def sample_polya_gamma_plain(gens, shape, tilt,
                             max_rounds=_MAX_REJECTION_ROUNDS):
    """The plain version of :func:`sample_polya_gamma_chains`: the rounds
    on each chain's generator, on a tensor on any device. `shape` is
    host data (the (n,) integer shapes) or None (all ones)."""
    if shape is None:
        return _unit_shape_chains(gens, tilt, max_rounds)
    shape = np.asarray(shape)
    if np.all(shape == 1):
        return _unit_shape_chains(gens, tilt, max_rounds)
    seg = torch.as_tensor(np.repeat(np.arange(shape.size), shape),
                          device=tilt.device)
    draws = _unit_shape_chains(gens, tilt[:, seg], max_rounds)
    # Segment sums by differences of a float64 prefix sum along each
    # chain's row: deterministic (no scatter-add atomics on the GPU).
    csum = torch.cat((torch.zeros((tilt.shape[0], 1), dtype=torch.float64,
                                  device=tilt.device),
                      torch.cumsum(draws.double(), 1)), 1)
    ends = torch.as_tensor(np.cumsum(shape), device=tilt.device)
    return (csum[:, ends] - csum[:, ends - torch.as_tensor(
        shape, device=tilt.device)]).to(tilt.dtype)


def sample_polya_gamma_chains(gens, shape, tilt,
                              max_rounds=_MAX_REJECTION_ROUNDS):
    """PG(shape, tilt) draws for k Markov chains: tilt (k, n), `shape`
    the (n,) integer shapes shared by the chains, row c drawn from gens[c]
    as :func:`sample_polya_gamma` would draw it alone.

    `shape` is host data, None (all ones) or an integer tensor on tilt's
    device (the model's ``pg_shape``, moved to the card once). The one
    dispatch point: a CUDA tensor launches the kernel
    (:func:`..kernels.draws.polya_gamma_draw`, one thread a lane, no host
    sync), a CPU tensor runs :func:`sample_polya_gamma_plain`."""
    on_device = torch.is_tensor(shape)
    if shape is not None:
        if not on_device:
            shape = np.asarray(shape)
        if (shape.is_floating_point() if on_device
                else not np.issubdtype(shape.dtype, np.integer)):
            raise ValueError('Shape parameter must be integers.')
        n = shape.numel() if on_device else shape.size
    if tilt.dim() != 2 or len(gens) != tilt.shape[0] or (
            shape is not None and n != tilt.shape[1]):
        raise ValueError('Input arrays must be of the same length.')
    if tilt.device.type == 'cpu':
        return sample_polya_gamma_plain(
            gens, shape.cpu().numpy() if on_device else shape, tilt,
            max_rounds)
    if on_device:
        shape = shape.to(device=tilt.device, dtype=torch.int32).contiguous()
    elif shape is not None:
        shape = None if np.all(shape == 1) else torch.as_tensor(
            shape, dtype=torch.int32, device=tilt.device)
    return polya_gamma_draw(gens, tilt, shape, max_rounds)


def sample_polya_gamma(gen, shape, tilt, max_rounds=_MAX_REJECTION_ROUNDS):
    """PG(shape, tilt) draws for integer `shape` (as
    :func:`sample_polya_gamma_chains` takes it), as the sum of `shape[i]`
    unit-shape draws per lane (polya_gamma.pyx:61-74)."""
    return sample_polya_gamma_chains(
        [gen], shape, tilt.reshape(1, -1), max_rounds).reshape(tilt.shape)
