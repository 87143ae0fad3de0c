"""Polya-Gamma and tilted-stable draws on the card: wrappers, key
derivation and launch preparation.

Counterparts of the device loops that the JAX package runs on the TPU
(``bayesbridge_tpu/random/rejection.py`` ``run_rejection`` carrying
``polya_gamma.py`` ``sample_polya_gamma`` and ``tilted_stable.py``
``sample_tilted_stable``): :func:`polya_gamma_draw` launches
``csrc/polya_gamma.cu`` (one thread a lane) and :func:`tilted_stable_draw`
``csrc/tilted_stable.cu``'s regrouping design (each round of a lane on
its own Philox blocks; a warp's threads shared among its lanes still
running before every sweep, from :func:`ts_threads_per_lane` threads a
lane), each lane's rejection chain run to acceptance or its cap on the
card, with no host sync; :func:`tilted_stable_draw_first` runs the first
design (one thread a lane on one sequential stream), kept for timing in
turns. Their
plain versions in law are the round samplers of :mod:`..random.polya_gamma`
and :mod:`..random.tilted_stable`, which the CPU runs; those modules'
``sample_*_chains`` are the one dispatch point (a CUDA tensor comes here,
a CPU tensor to the rounds). :func:`tilted_stable_indexed_plain` is the
sweep design's plain version draw for draw: the same rounds on the same
Philox words (:func:`round_words`) in torch.

Random bits: Philox4x32-10 written into the kernels
(``csrc/philox.cuh``). Each call draws one 64-bit key per chain from the
chain's own ``torch.Generator`` on the card (:func:`chain_keys`: k tiny
launches on the current stream, nothing read back). Lane j of chain c
takes the stream (key_c, j) in ``pg_draw`` and the first tilted-stable
design; in ``ts_draw`` round r of lane j takes the blocks (key_c, j,
r B + b), b < B (B = 2 in float32, 4 in float64). So chain c of a batch
equals chain c drawn alone bit for bit, a rerun from the same generator
states gives the same bits, a saved generator state covers the key draw
(exact resume), and ``ts_draw``'s values do not depend on T.

``launches['pg']``, ``launches['ts']`` and ``launches['ts_first']`` count
the kernel launches. Lanes that reach their round cap are counted on the
card by an integer atomic into a per-device counter (:func:`capped_lanes`
reads it).
"""

import math
import threading

import torch

from .build import count_launch, load_library
from ..utils.chains import pow_pos

launches = {'pg': 0, 'ts': 0, 'ts_first': 0}

# The JAX package's caps (polya_gamma.py:44, tilted_stable.py:41, :313),
# shared with the plain rounds.
PG_MAX_ROUNDS = 512
TS_MAX_ROUNDS = 256
TS_MAX_PARTITION = 4096
TILT_POWER_THRESHOLD = 2.0  # the crossover of tilted_stable.pyx:52
# bb_ts_draw's modes.
TS_MODES = {None: 0, 'divide-conquer': 1, 'double-rejection': 2}
_DTYPES = (torch.float32, torch.float64)
# Philox blocks a round of ts_draw's sweep design takes (csrc/tilted_stable.cu
# RoundBlocks: eight uniforms at most, one word each in float32, two in
# float64).
TS_ROUND_BLOCKS = {torch.float32: 2, torch.float64: 4}

_capped = {}
_capped_lock = threading.Lock()


def chain_keys(gens, device):
    """(k,) int64 tensor on `device`: one key per chain, drawn from each
    chain's generator (on `device`) in chain order, with no sync."""
    keys = torch.empty(len(gens), dtype=torch.int64, device=device)
    for c, gen in enumerate(gens):
        keys[c:c + 1].random_(generator=gen)
    return keys


def ts_dc_rounds(method, max_rounds=TS_MAX_ROUNDS,
                 max_partition=TS_MAX_PARTITION):
    """Divide-and-conquer's round cap: `max_rounds` when each lane picks
    its method, max(max_rounds, 3 max_partition + 64) when the caller
    forces divide-and-conquer (tilted_stable.py:381-382 of the JAX
    package)."""
    return max_rounds if method is None \
        else max(max_rounds, 3 * max_partition + 64)


def capped_counter(device):
    """The device's (2,) int64 counter of capped lanes, [Polya-Gamma,
    tilted stable], made on first use; the kernels add to it."""
    device = torch.device(device)
    key = (device.type, device.index)
    with _capped_lock:
        if key not in _capped:
            _capped[key] = torch.zeros(2, dtype=torch.int64, device=device)
        return _capped[key]


def capped_lanes(device):
    """(Polya-Gamma, tilted stable) lanes capped on `device` since the
    last reset, read to the host (a sync)."""
    pg, ts = capped_counter(device).tolist()
    return pg, ts


def reset_capped(device):
    capped_counter(device).zero_()


def _check_lanes(name, x, gens):
    if x.device.type != 'cuda':
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: takes float32 or float64, not {x.dtype}")
    if x.dim() != 2 or x.shape[0] != len(gens) or x.shape[1] == 0:
        raise ValueError(f"{name}: needs a (k, n) tensor with n > 0, one "
                         f"row per generator")
    return x.contiguous()


def _check_out(name, t, like, dtype=torch.int32):
    if t is not None and (t.dtype != dtype or t.shape != like.shape
                          or t.device != like.device
                          or not t.is_contiguous()):
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor of "
                         f"shape {tuple(like.shape)} on {like.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def polya_gamma_draw(gens, tilt, shape=None, max_rounds=PG_MAX_ROUNDS,
                     attempts=None):
    """PG(shape, tilt) draws on the card: tilt (k, n) float32 or float64
    (the linear predictor), `shape` the (n,) int32 trial counts on the
    same device or None (all ones), row c drawn from gens[c]. `attempts`,
    where given, a (k, n) int32 tensor that gets the rounds each lane took
    (summed over its units)."""
    z = _check_lanes('polya_gamma_draw', tilt, gens)
    if shape is not None and (shape.dtype != torch.int32
                              or shape.shape != (z.shape[1],)
                              or shape.device != z.device
                              or not shape.is_contiguous()):
        raise ValueError("polya_gamma_draw: shape must be a contiguous "
                         f"int32 ({z.shape[1]},) tensor on {z.device}")
    _check_out('polya_gamma_draw', attempts, z)
    kl = load_library()
    keys = chain_keys(gens, z.device)
    out = torch.empty_like(z)
    counter = capped_counter(z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = kl.lib.bb_pg_draw(int(z.dtype == torch.float64), z.data_ptr(),
                               _ptr(shape), keys.data_ptr(), z.shape[0],
                               z.shape[1], int(max_rounds), out.data_ptr(),
                               counter.data_ptr(), _ptr(attempts), stream)
    kl.check(rc, 'polya_gamma_draw')
    count_launch(launches, 'pg')
    return out


_RESIDENT = {}


# ts_draw runs the regrouping design (a warp's threads shared among its
# lanes still running before every sweep; csrc/tilted_stable.cu). In turns
# on the H100 (PERF.md) it ran best from T = 1-4 threads a lane, with
# lanes x T at most a quarter of the card's resident threads.
TS_FILL = 0.25


def ts_threads_per_lane(lanes, device):
    """ts_draw's threads a lane at the start for `lanes` lanes on
    `device`: the largest power of two T <= 32 with lanes x T at most
    TS_FILL of the card's resident threads (SMs x threads an SM), at
    least 1. The slowest lanes of a warp set its time; regrouping gives
    them the threads of the lanes that finish, so fewer threads a lane at
    the start waste fewer rounds."""
    device = torch.device(device)
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _RESIDENT:
        props = torch.cuda.get_device_properties(key)
        _RESIDENT[key] = props.multi_processor_count * getattr(
            props, 'max_threads_per_multi_processor', 2048)
    t = 1
    while t < 32 and lanes * 2 * t <= TS_FILL * _RESIDENT[key]:
        t *= 2
    return t


def _ts_prepare(name, gens, tilt, method, attempts, plan):
    x = _check_lanes(name, tilt, gens)
    if method not in TS_MODES:
        raise ValueError("Unrecognized method name.")
    for t in (attempts, plan):
        _check_out(name, t, x)
    return x, load_library(), chain_keys(gens, x.device)


def tilted_stable_draw(gens, char_exponent, tilt, method=None,
                       max_rounds=TS_MAX_ROUNDS,
                       max_partition=TS_MAX_PARTITION, attempts=None,
                       plan=None, threads_per_lane=None):
    """Tilted-stable draws on the card: tilt (k, n) float32 or float64,
    row c drawn from gens[c]; `method` None picks each lane's method by
    ``tilt**alpha < 2``. `attempts` and `plan`, where given, (k, n) int32
    tensors that get each lane's rounds (its accepting round + 1, or the
    cap) and its partitions (0 for double rejection;
    ``random.tilted_stable.lane_plan`` in plain PyTorch).
    `threads_per_lane` (1, 2, 4, ..., 32; None: :func:`ts_threads_per_lane`)
    changes the launch, never the values."""
    x, kl, keys = _ts_prepare('tilted_stable_draw', gens, tilt, method,
                              attempts, plan)
    t = threads_per_lane or ts_threads_per_lane(x.numel(), x.device)
    if t not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"tilted_stable_draw: threads_per_lane must be a "
                         f"power of two up to 32, not {t}")
    out = torch.empty_like(x)
    counter = capped_counter(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = kl.lib.bb_ts_draw(
            int(x.dtype == torch.float64), x.data_ptr(), keys.data_ptr(),
            x.shape[0], x.shape[1], float(char_exponent), TS_MODES[method],
            int(max_rounds), ts_dc_rounds(method, max_rounds, max_partition),
            int(max_partition), t.bit_length() - 1, out.data_ptr(),
            counter.data_ptr() + 8, _ptr(attempts), _ptr(plan), stream)
    kl.check(rc, 'tilted_stable_draw')
    count_launch(launches, 'ts')
    return out


def tilted_stable_draw_first(gens, char_exponent, tilt, method=None,
                             max_rounds=TS_MAX_ROUNDS,
                             max_partition=TS_MAX_PARTITION, attempts=None,
                             plan=None):
    """:func:`tilted_stable_draw` on the first design (one thread a lane,
    lane j of chain c on the sequential stream (key_c, j)): the same law,
    other bits; off the path, kept for timing in turns."""
    x, kl, keys = _ts_prepare('tilted_stable_draw_first', gens, tilt,
                              method, attempts, plan)
    out = torch.empty_like(x)
    counter = capped_counter(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = kl.lib.bb_ts_draw_first(
            int(x.dtype == torch.float64), x.data_ptr(), keys.data_ptr(),
            x.shape[0], x.shape[1], float(char_exponent), TS_MODES[method],
            int(max_rounds), ts_dc_rounds(method, max_rounds, max_partition),
            int(max_partition), out.data_ptr(), counter.data_ptr() + 8,
            _ptr(attempts), _ptr(plan), stream)
    kl.check(rc, 'tilted_stable_draw_first')
    count_launch(launches, 'ts_first')
    return out


def philox_plain(ctr, key):
    """Philox4x32-10 in plain PyTorch: ctr (..., 4) and key (..., 2) words
    as int64 tensors holding uint32 values; returns the (..., 4) output
    words, as ``csrc/philox.cuh`` and curand's ``curand_Philox4x32_10``
    give them."""
    mask = 0xFFFFFFFF
    c = [ctr[..., i].to(torch.int64) & mask for i in range(4)]
    k0, k1 = (key[..., i].to(torch.int64) & mask for i in range(2))

    def mulhilo(m, x):
        # m * x < 2^64 overflows int64: split x into 16-bit halves.
        lo16, hi16 = x & 0xFFFF, x >> 16
        a, b = m * lo16, m * hi16
        low = (a + ((b & 0xFFFF) << 16)) & mask
        high = ((b >> 16) + (((a >> 16) + (b & 0xFFFF)) >> 16)) & mask
        return high, low

    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & mask, (k1 + 0xBB67AE85) & mask
        hi0, lo0 = mulhilo(0xD2511F53, c[0])
        hi1, lo1 = mulhilo(0xCD9E8D57, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, -1)


_MASK = 0xFFFFFFFF


def round_words(keys, lanes, rounds, blocks):
    """The Philox words of round `rounds` of lanes `lanes` under `keys`
    (int64 tensors of one shape, a key as the wrapper draws it): the
    blocks (lane low, lane high, rounds * blocks + b, 0) for b < `blocks`
    under (key low, key high), (..., 4 * blocks) int64 holding uint32
    values in the order ``csrc/philox.cuh``'s RoundStream takes them."""
    lanes, keys = lanes.to(torch.int64), keys.to(torch.int64)
    first = rounds.to(torch.int64) * blocks
    ctr = torch.stack([torch.stack([lanes & _MASK, (lanes >> 32) & _MASK,
                                    (first + b) & _MASK,
                                    torch.zeros_like(lanes)], -1)
                       for b in range(blocks)], -2)
    key = torch.stack([keys & _MASK, (keys >> 32) & _MASK], -1)
    return philox_plain(ctr, key[..., None, :].expand(
        *ctr.shape[:-1], 2)).reshape(*lanes.shape, 4 * blocks)


def _round_uniforms(words, dtype):
    """The eight uniforms a round may take, (..., 8), from its words: the
    top 23 bits of one word at the midpoints (float32), or 53 bits of two
    words clamped at the smallest normal (float64)."""
    if dtype == torch.float32:
        return (((words >> 9).to(torch.float32) + 0.5) * 2.0 ** -23)
    pair = words.view(*words.shape[:-1], 8, 2)
    u = ((pair[..., 0] << 21) | (pair[..., 1] >> 11)).to(torch.float64) \
        * 2.0 ** -53
    return u.clamp_min(torch.finfo(torch.float64).tiny)


def _box_muller(u1, u2):
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def _dc_rounds_plain(u, alpha, tilt, scale):
    """Divide-and-conquer rounds (``dc_round``) on their uniforms u
    (..., 8): (accepted, draw)."""
    from ..random.tilted_stable import _safe_exp, _zolotarev_function
    ratio = -_zolotarev_function(math.pi * u[..., 0], alpha) \
        / torch.log(u[..., 1])
    draw = scale * pow_pos(ratio, (1.0 - alpha) / alpha)
    return u[..., 2] < _safe_exp(-tilt * draw), draw


def _dr_rounds_plain(u, alpha, tp, gamma, xi, psi):
    """Double-rejection rounds (``dr_round``) on their uniforms u (...,
    8): (accepted, value)."""
    from ..random.tilted_stable import (
        _aux2_accept_prob, _safe_exp, _zolotarev_function,
        _zolotarev_pdf_exponentiated)
    pi = math.pi
    v, n, w = u[..., 0], _box_muller(u[..., 1], u[..., 2]), u[..., 3]
    w1 = torch.sqrt(0.5 * pi / gamma) * xi
    w2 = 2.0 * math.sqrt(pi) * psi
    w3 = xi * pi
    u_cand = torch.where(
        gamma >= 1.0,
        torch.where(v < w1 / (w1 + w2), n.abs() / torch.sqrt(gamma),
                    pi * (1.0 - w * w)),
        torch.where(v < w3 / (w2 + w3), pi * w, pi * (1.0 - w * w)))
    u_ok = u_cand < pi
    us = torch.clamp(u_cand, 1e-10, pi * (1 - 1e-7))
    zeta = torch.sqrt(_zolotarev_pdf_exponentiated(us, alpha))
    z = 1.0 / (1.0 - pow_pos(1.0 + alpha * zeta / torch.sqrt(gamma),
                             -1.0 / alpha))
    accept = _aux2_accept_prob(us, alpha, xi, psi, zeta, z, tp, gamma)
    v_cand = u[..., 4] / accept
    aux_ok = u_ok & (accept > 0.0) & (v_cand <= 1.0)
    # The final proposal: the piece by u[5], its variable from u[6] (and
    # u[7] for the normal).
    za = _zolotarev_function(us, alpha)
    odds = (1.0 - alpha) / alpha
    left = pow_pos((1.0 - alpha) / alpha / za, alpha) * tp
    right = left + torch.sqrt(left * alpha / za)
    expo_scale = z / za
    width = right - left
    mass_left = width * math.sqrt(0.5 * pi)
    mass_total = mass_left + width + expo_scale
    vr = u[..., 5]
    nr = _box_muller(u[..., 6], u[..., 7])
    e = -torch.log(u[..., 6])
    in_left = vr < mass_left / mass_total
    in_mid = ~in_left & (vr < (mass_left + width) / mass_total)
    x = torch.where(in_left, left - width * nr.abs(),
                    torch.where(in_mid, left + width * u[..., 6],
                                right + e * expo_scale))
    x_pos = torch.clamp_min(x, torch.finfo(u.dtype).tiny)
    lp = -(za * (x_pos - left) + _safe_exp(torch.log(tp) / alpha
                                            - odds * torch.log(left))
           * (pow_pos(left / x_pos, odds) - 1.0))
    zero = torch.zeros_like(lp)
    lp = lp + torch.where(in_left & (x < left), nr * nr / 2.0, zero)
    lp = lp + torch.where(~in_left & ~in_mid & (x > right), e, zero)
    lp = torch.where(x < 0, torch.full_like(x, -math.inf), lp)
    ok = aux_ok & (lp > torch.log(v_cand))
    return ok, pow_pos(x, -(1.0 - alpha) / alpha)


def tilted_stable_indexed_plain(keys, char_exponent, tilt, method=None,
                                max_rounds=TS_MAX_ROUNDS,
                                max_partition=TS_MAX_PARTITION,
                                threads_per_lane=1, lanes=None):
    """``ts_draw``'s sweep design in plain PyTorch, on any device: tilt
    (k, n) float32 or float64, keys (k,) int64 (the kernel's, one a
    chain); lane j of chain c runs round r on :func:`round_words`'s (key_c,
    j, r) words, rounds in sweeps of `threads_per_lane`, the same
    decisions in round order (double rejection's first accepting round;
    divide-and-conquer's first m accepted rounds, their draws added in
    round order; a capped lane keeps its partial sum, or 0). `lanes`, where
    given, (n,) int64: the lane index of each column of `tilt` (a sample
    of a launch's lanes; default 0 .. n - 1). Returns
    (values, attempts, plan, capped), attempts int32 (accepting round + 1,
    or the cap), plan as ``lane_plan``, capped bool. The values do not
    depend on `threads_per_lane`; against the kernel they differ by its
    libm's rounding, and a lane whose acceptance sits within that
    rounding of its threshold may take another round."""
    from ..random.tilted_stable import (
        _clamp_tilt, _partitions, _safe_exp, _use_divide_conquer)
    if method not in TS_MODES:
        raise ValueError("Unrecognized method name.")
    dtype = tilt.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"tilted_stable_indexed_plain: takes float32 or "
                         f"float64, not {dtype}")
    k, n = tilt.shape
    tl = int(threads_per_lane)
    x = _clamp_tilt(tilt).reshape(-1)
    alpha = torch.full_like(x, char_exponent)
    dc = _use_divide_conquer(x, alpha, method)
    m = _partitions(x, alpha, max_partition)
    plan = torch.where(dc, m, torch.zeros_like(m))
    limit = torch.where(dc & (method is not None),
                        ts_dc_rounds(method, max_rounds, max_partition),
                        max_rounds)
    scale = pow_pos(1.0 / m.to(dtype), 1.0 / alpha)
    tp = pow_pos(x, alpha)
    gamma = tp * alpha * (1.0 - alpha)
    sqrt_half_pi = math.sqrt(0.5 * math.pi)
    xi = (1.0 + torch.sqrt(2.0 * gamma) * (2.0 + sqrt_half_pi)) / math.pi
    psi = torch.sqrt(gamma / math.pi) * (2.0 + sqrt_half_pi) \
        * _safe_exp(-gamma * math.pi * math.pi / 8.0)
    lane = (torch.arange(n, device=x.device) if lanes is None
            else lanes.to(x.device, torch.int64)).repeat(k)
    key = keys.to(x.device, torch.int64).repeat_interleave(n)
    blocks = TS_ROUND_BLOCKS[dtype]
    value = torch.zeros_like(x)
    total = torch.zeros_like(x)
    done = torch.zeros_like(m)
    attempts = torch.zeros_like(m)
    capped = torch.zeros_like(dc)
    live = torch.arange(x.numel(), device=x.device)
    base = 0
    while live.numel():
        r = base + torch.arange(tl, device=x.device)
        rr = r.expand(live.numel(), tl)
        ok_r = rr < limit[live, None]
        u = _round_uniforms(round_words(key[live, None].expand(-1, tl),
                                        lane[live, None].expand(-1, tl),
                                        rr, blocks), dtype)
        col = lambda v: v[live, None]  # noqa: E731
        acc_dc, draw = _dc_rounds_plain(u, col(alpha), col(x), col(scale))
        acc_dr, val = _dr_rounds_plain(u, col(alpha), col(tp), col(gamma),
                                       col(xi), col(psi))
        is_dc = dc[live]
        acc = torch.where(is_dc[:, None], acc_dc, acc_dr) & ok_r
        fin = torch.zeros_like(is_dc)
        # Double rejection: the first accepting round of the sweep.
        any_dr = ~is_dc & acc.any(1)
        first = acc.to(torch.int8).argmax(1)
        pick = val.gather(1, first[:, None])[:, 0]
        value[live] = torch.where(any_dr, pick, value[live])
        attempts[live] = torch.where(any_dr, (base + first + 1).to(
            torch.int32), attempts[live])
        fin |= any_dr
        # Divide-and-conquer: accepted draws in round order up to the m-th.
        tot, dn, mm = total[live], done[live], m[live]
        att = attempts[live]
        for t in range(tl):
            take = is_dc & ~fin & acc[:, t]
            tot = torch.where(take, tot + draw[:, t], tot)
            dn = dn + take.to(dn.dtype)
            hit = take & (dn >= mm)
            att = torch.where(hit, torch.full_like(att, base + t + 1), att)
            fin |= hit
        total[live], done[live] = tot, dn
        attempts[live] = att
        value[live] = torch.where(is_dc & fin, tot, value[live])
        # The cap.
        cap = ~fin & (base + tl >= limit[live])
        value[live] = torch.where(cap, torch.where(is_dc, tot,
                                                   torch.zeros_like(tot)),
                                  value[live])
        attempts[live] = torch.where(cap, limit[live].to(torch.int32),
                                     attempts[live])
        capped[live] = cap
        live = live[~(fin | cap)]
        base += tl
    shape = tilt.shape
    return (value.view(shape), attempts.view(shape).to(torch.int32),
            plan.view(shape), capped.view(shape))
