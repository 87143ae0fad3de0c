"""Vectorized exponentially-tilted stable sampler.

Port of ``bayesbridge_tpu/random/tilted_stable.py`` (reference:
bayesbridge/random/tilted_stable/tilted_stable.pyx:44-332). Samples X with
density proportional to ``exp(-tilt * x) * p_stable(x)``, ``p_stable``
the positive stable density of characteristic exponent ``char_exp < 1``.

Two algorithms, chosen lane-wise like the reference by the
``tilt**char_exp < 2`` crossover (tilted_stable.pyx:103-112):
divide-and-conquer (Hofert 2011), cheap while ``tilt**char_exp`` is
small, and double rejection (Devroye 2009), O(1) expected cost in the
tilt. On the card the hand-written kernel ``csrc/tilted_stable.cu``
runs each lane's chain in a thread (:mod:`..kernels.draws`); on the CPU
the plain version (:func:`sample_tilted_stable_plain`) runs each as a
lane-parallel rejection loop on a ``torch.Generator``
(:func:`.rejection.run_rejection`).
"""

import math

import numpy as np
import torch

from ..kernels.draws import TS_MAX_ROUNDS as _MAX_REJECTION_ROUNDS
from ..kernels.draws import (
    TILT_POWER_THRESHOLD, TS_MAX_PARTITION, tilted_stable_draw,
    ts_dc_rounds,
)
from ..utils.chains import pow_pos
from .rejection import normal, run_rejection, uniform_open

# Memoryless chains (double rejection; divide-and-conquer with one
# partition) run several iid attempts per lane per round once fewer lanes
# than this remain (see run_rejection).
_WIDEN_TO = 4096


def _safe_exp(x):
    max_arg = 0.9 * math.log(torch.finfo(x.dtype).max)
    return torch.exp(torch.clamp(x, -max_arg, max_arg))


def _sinc(x):
    """sin(x)/x with a Taylor guard near zero (tilted_stable.pyx:29-37)."""
    x_sq = x * x
    taylor = 1.0 - x_sq / 6.0 * (1.0 - x_sq / 20.0)
    small = x.abs() < 0.01
    safe_x = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, taylor, torch.sin(safe_x) / safe_x)


def _zolotarev_function(x, alpha):
    """Zolotarev's A(x, alpha) (tilted_stable.pyx:326-332)."""
    val = pow_pos((1.0 - alpha) * _sinc((1.0 - alpha) * x), 1.0 - alpha) \
        * pow_pos(alpha * _sinc(alpha * x), alpha) / _sinc(x)
    return pow_pos(val, 1.0 / (1.0 - alpha))


def _zolotarev_pdf_exponentiated(x, alpha):
    """Function proportional to a power of the Zolotarev density
    (tilted_stable.pyx:316-324)."""
    denom = pow_pos(_sinc(alpha * x), alpha) \
        * pow_pos(_sinc((1.0 - alpha) * x), 1.0 - alpha)
    return _sinc(x) / denom


def _sample_non_tilted(gen, alpha):
    """One positive-stable draw per lane via Kanter's method
    (tilted_stable.pyx:157-164)."""
    u = uniform_open(gen, alpha.shape, alpha)
    v = uniform_open(gen, alpha.shape, alpha)
    ratio = -_zolotarev_function(math.pi * u, alpha) / torch.log(v)
    return pow_pos(ratio, (1.0 - alpha) / alpha)


def _partitions(tilt, alpha, max_partition):
    """Divide-and-conquer's m = max(1, floor(tilt^alpha)), capped at
    `max_partition`, per lane (int32)."""
    # Clamp in float before the integer cast.
    return torch.clamp_min(torch.floor(torch.clamp_max(
        pow_pos(tilt, alpha), float(max_partition))).to(torch.int32), 1)


def _use_divide_conquer(tilt, alpha, method):
    """Lanes on divide-and-conquer: by the ``tilt**alpha < 2`` crossover,
    or all or none for a forced method."""
    if method is None:
        return pow_pos(tilt, alpha) < TILT_POWER_THRESHOLD
    return torch.full_like(tilt, method == 'divide-conquer',
                           dtype=torch.bool)


def _clamp_tilt(tilt):
    return torch.clamp_min(tilt, float(np.finfo(np.float32).tiny))


def lane_plan(char_exponent, tilt, method=None,
              max_partition=TS_MAX_PARTITION):
    """Each lane's method as the plain version picks it, and as the
    kernel reports it (its ``plan`` output): (k, m) int32, the partitions
    of a divide-and-conquer lane, 0 for a double-rejection lane."""
    tilt = _clamp_tilt(tilt)
    alpha = torch.full_like(tilt, char_exponent)
    m = _partitions(tilt, alpha, max_partition)
    return torch.where(_use_divide_conquer(tilt, alpha, method), m,
                       torch.zeros_like(m))


def _sample_divide_conquer(gens, counts, alpha, tilt, max_partition,
                           max_rounds):
    """X = sum over `m = max(1, floor(tilt^alpha))` partitions of scaled
    stable draws, each accepted with probability exp(-tilt * S)
    (tilted_stable.pyx:137-155); a lane finishes once it has `m`
    accepted partition draws."""
    m = _partitions(tilt, alpha, max_partition)
    c = pow_pos(1.0 / m.to(tilt.dtype), 1.0 / alpha)

    if bool((m == 1).all()):
        # The auto-selected regime (tilt^alpha < 2): one accepted draw
        # ends a lane, so its attempts are iid and the straggler tail
        # may run several per round.
        def attempt_one(g, p, s):
            draw = _sample_non_tilted(g, p['alpha'])
            u = uniform_open(g, p['tilt'].shape, p['tilt'])
            return s, draw, u < _safe_exp(-p['tilt'] * draw)

        return run_rejection(
            gens, params=dict(alpha=alpha, tilt=tilt), state={},
            attempt=attempt_one, value_init=torch.zeros_like(tilt),
            max_rounds=max_rounds, widen_to=_WIDEN_TO, counts=counts)

    def attempt(g, p, s):
        draw = p['c'] * _sample_non_tilted(g, p['alpha'])
        accept_prob = _safe_exp(-p['tilt'] * draw)
        u = uniform_open(g, p['tilt'].shape, p['tilt'])
        take = (s['n_done'] < p['m']) & (u < accept_prob)
        total = torch.where(take, s['total'] + draw, s['total'])
        n_done = torch.where(take, s['n_done'] + 1, s['n_done'])
        return dict(n_done=n_done, total=total), total, n_done >= p['m']

    return run_rejection(
        gens, params=dict(alpha=alpha, tilt=tilt, m=m, c=c),
        state=dict(n_done=torch.zeros_like(m), total=torch.zeros_like(tilt)),
        attempt=attempt, value_init=torch.zeros_like(tilt),
        max_rounds=max_rounds,
        # Partial sums accumulate: a capped lane keeps its progress.
        latch='every_round', counts=counts)


def _aux2_candidate(gen, alpha, gamma, xi, psi):
    """One candidate for the auxiliary variable U
    (tilted_stable.pyx:210-236)."""
    shape = gamma.shape
    v = uniform_open(gen, shape, gamma)
    n = normal(gen, shape, gamma)
    w = uniform_open(gen, shape, gamma)
    w1 = torch.sqrt(0.5 * math.pi / gamma) * xi
    w2 = 2.0 * math.sqrt(math.pi) * psi
    w3 = xi * math.pi
    u_high = torch.where(v < w1 / (w1 + w2), n.abs() / torch.sqrt(gamma),
                         math.pi * (1.0 - w * w))
    u_low = torch.where(v < w3 / (w2 + w3), math.pi * w,
                        math.pi * (1.0 - w * w))
    return torch.where(gamma >= 1.0, u_high, u_low)


def _aux2_accept_prob(u, alpha, xi, psi, zeta, z, tilt_power, gamma):
    """Acceptance probability for the auxiliary draw
    (tilted_stable.pyx:238-256)."""
    inv_prob = math.pi * _safe_exp(-tilt_power * (1.0 - 1.0 / (zeta * zeta))) \
        / ((1.0 + math.sqrt(0.5 * math.pi)) * torch.sqrt(gamma) / zeta + z)
    zero = torch.zeros_like(u)
    tiny = torch.finfo(u.dtype).tiny
    d = torch.where((u >= 0.0) & (gamma >= 1.0),
                    xi * _safe_exp(-gamma * u * u / 2.0), zero)
    d = d + torch.where((u > 0.0) & (u < math.pi),
                        psi / torch.sqrt(torch.clamp_min(math.pi - u, tiny)),
                        zero)
    d = d + torch.where((u >= 0.0) & (u <= math.pi) & (gamma < 1.0), xi,
                        zero)
    return 1.0 / (inv_prob * d)


def _reference_rv(gen, u, alpha, tilt_power, z):
    """Draw X from the 3-piece reference density given U, plus its log
    acceptance probability (tilted_stable.pyx:258-314)."""
    shape = u.shape
    a = _zolotarev_function(u, alpha)
    odds = (1.0 - alpha) / alpha
    left = pow_pos((1.0 - alpha) / alpha / a, alpha) * tilt_power
    right = left + torch.sqrt(left * alpha / a)
    expo_scale = z / a
    width = right - left
    mass_left = width * math.sqrt(0.5 * math.pi)
    mass_mid = width
    mass_total = mass_left + mass_mid + expo_scale

    v = uniform_open(gen, shape, u)
    n = normal(gen, shape, u)
    mid_u = uniform_open(gen, shape, u)
    e = -torch.log(uniform_open(gen, shape, u))
    in_left = v < mass_left / mass_total
    in_mid = ~in_left & (v < (mass_left + mass_mid) / mass_total)
    x = torch.where(in_left, left - width * n.abs(),
                    torch.where(in_mid, left + width * mid_u,
                                right + e * expo_scale))
    x_pos = torch.clamp_min(x, torch.finfo(u.dtype).tiny)
    log_prob = -(a * (x_pos - left)
                 + _safe_exp(torch.log(tilt_power) / alpha
                             - odds * torch.log(left))
                 * (pow_pos(left / x_pos, odds) - 1.0))
    log_prob = log_prob + torch.where(in_left & (x < left), n * n / 2.0,
                                      torch.zeros_like(x))
    log_prob = log_prob + torch.where(x > right, e, torch.zeros_like(x))
    log_prob = torch.where(x < 0, torch.full_like(x, -math.inf), log_prob)
    return x, log_prob


def _sample_double_rejection(gens, counts, alpha, tilt, max_rounds):
    """Devroye's double-rejection sampler: each round makes one auxiliary
    proposal and, given it, one final proposal; a lane accepts iff both
    accept (tilted_stable.pyx:166-208). Memoryless iid attempts, so the
    straggler tail may run several per round."""
    tilt_power = pow_pos(tilt, alpha)
    gamma = tilt_power * alpha * (1.0 - alpha)
    sqrt_half_pi = math.sqrt(0.5 * math.pi)
    xi = (1.0 + torch.sqrt(2.0 * gamma) * (2.0 + sqrt_half_pi)) / math.pi
    psi = torch.sqrt(gamma / math.pi) * (2.0 + sqrt_half_pi) \
        * _safe_exp(-gamma * math.pi * math.pi / 8.0)

    def attempt(g, p, s):
        alpha, gamma, xi, psi, tp = (p['alpha'], p['gamma'], p['xi'],
                                     p['psi'], p['tilt_power'])
        u_cand = _aux2_candidate(g, alpha, gamma, xi, psi)
        u_ok = u_cand < math.pi
        u_safe = torch.clamp(u_cand, 1e-10, math.pi * (1 - 1e-7))
        zeta = torch.sqrt(_zolotarev_pdf_exponentiated(u_safe, alpha))
        z_cand = 1.0 / (1.0 - pow_pos(1.0 + alpha * zeta / torch.sqrt(gamma),
                                   -1.0 / alpha))
        accept_prob = _aux2_accept_prob(u_safe, alpha, xi, psi, zeta,
                                        z_cand, tp, gamma)
        v_cand = uniform_open(g, gamma.shape, gamma) / accept_prob
        aux_ok = u_ok & (accept_prob > 0.0) & (v_cand <= 1.0)
        x, log_prob = _reference_rv(g, u_safe, alpha, tp, z_cand)
        ok = aux_ok & (log_prob > torch.log(v_cand))
        return s, pow_pos(x, -(1.0 - alpha) / alpha), ok

    return run_rejection(
        gens, params=dict(alpha=alpha, gamma=gamma, xi=xi, psi=psi,
                          tilt_power=tilt_power),
        state={}, attempt=attempt, value_init=torch.zeros_like(tilt),
        max_rounds=max_rounds, widen_to=_WIDEN_TO, counts=counts)


def sample_tilted_stable(gen, char_exponent, tilt, method=None,
                         max_rounds=_MAX_REJECTION_ROUNDS,
                         max_partition=TS_MAX_PARTITION):
    """Draw one exponentially tilted stable variate per element of `tilt`.

    Parameters
    ----------
    gen : torch.Generator on tilt's device
    char_exponent : float in (0, 1)
    tilt : tensor of positive tilting parameters
    method : None, 'divide-conquer' or 'double-rejection'
        None picks the cheaper algorithm lane-wise via the
        ``tilt**char_exp < 2`` crossover.

    Exact zeros in `tilt` are clamped to a tiny positive value (the
    reference raises).
    """
    return sample_tilted_stable_chains(
        [gen], char_exponent, tilt.reshape(1, -1), method, max_rounds,
        max_partition).reshape(tilt.shape)


def sample_tilted_stable_chains(gens, char_exponent, tilt, method=None,
                                max_rounds=_MAX_REJECTION_ROUNDS,
                                max_partition=TS_MAX_PARTITION):
    """:func:`sample_tilted_stable` for k Markov chains: tilt (k, m), row
    c drawn from gens[c] as it would be drawn alone.

    The one dispatch point: a CUDA tensor launches the kernel
    (:func:`..kernels.draws.tilted_stable_draw`, one thread a lane, no
    host sync), a CPU tensor runs :func:`sample_tilted_stable_plain`."""
    if not 0.0 < char_exponent < 1.0:
        raise ValueError(
            "char_exponent must lie in (0, 1); got "
            f"{char_exponent}. (The alpha = 1 stable is degenerate and "
            "alpha > 1 is not a positive stable.)")
    if not tilt.is_floating_point():
        tilt = tilt.to(torch.float32)
    if tilt.dim() != 2 or tilt.shape[0] != len(gens):
        raise ValueError("tilt must be (n_chains, m), one row per "
                         "generator")
    if method not in (None, 'divide-conquer', 'double-rejection'):
        raise ValueError("Unrecognized method name.")
    if tilt.device.type == 'cpu':
        return sample_tilted_stable_plain(gens, char_exponent, tilt, method,
                                          max_rounds, max_partition)
    return tilted_stable_draw(gens, char_exponent, tilt, method, max_rounds,
                              max_partition)


def sample_tilted_stable_plain(gens, char_exponent, tilt, method=None,
                               max_rounds=_MAX_REJECTION_ROUNDS,
                               max_partition=TS_MAX_PARTITION):
    """The plain version of :func:`sample_tilted_stable_chains`: the
    rounds on each chain's generator, on a float tensor (k, m) on any
    device. (The forced divide-and-conquer method takes its one-partition
    shortcut only when every chain's lanes allow it; the automatic choice
    always does.)"""
    tilt = _clamp_tilt(tilt)
    alpha = torch.full_like(tilt, char_exponent)
    use_dc = _use_divide_conquer(tilt, alpha, method)
    dc_rounds = ts_dc_rounds(method, max_rounds, max_partition)
    n_dc = use_dc.sum(1).tolist()
    n_dr = [tilt.shape[1] - c for c in n_dc]
    out = torch.empty_like(tilt)
    out[use_dc] = _sample_divide_conquer(gens, n_dc, alpha[use_dc],
                                         tilt[use_dc], max_partition,
                                         dc_rounds)
    dr = ~use_dc
    out[dr] = _sample_double_rejection(gens, n_dr, alpha[dr], tilt[dr],
                                       max_rounds)
    return out
