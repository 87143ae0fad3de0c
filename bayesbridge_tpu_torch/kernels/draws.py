"""Polya-Gamma and tilted-stable draws on the card: wrappers, key
derivation and launch preparation.

Counterparts of the device loops that the JAX package runs on the TPU
(``bayesbridge_tpu/random/rejection.py`` ``run_rejection`` carrying
``polya_gamma.py`` ``sample_polya_gamma`` and ``tilted_stable.py``
``sample_tilted_stable``): :func:`polya_gamma_draw` launches
``csrc/polya_gamma.cu`` and :func:`tilted_stable_draw`
``csrc/tilted_stable.cu``, one thread a lane, each lane's rejection
chain run to acceptance or its cap inside the thread, with no host sync.
Their plain versions are the round samplers of
:mod:`..random.polya_gamma` and :mod:`..random.tilted_stable`, which the
CPU runs; those modules' ``sample_*_chains`` are the one dispatch point
(a CUDA tensor comes here, a CPU tensor to the rounds).

Random bits: Philox4x32-10 written into the kernels
(``csrc/philox.cuh``). Each call draws one 64-bit key per chain from the
chain's own ``torch.Generator`` on the card (:func:`chain_keys`: k tiny
launches on the current stream, nothing read back), and lane j of chain c
takes the stream (key_c, j). So chain c of a batch equals chain c drawn
alone bit for bit, a rerun from the same generator states gives the same
bits, and a saved generator state covers the key draw (exact resume).

``launches['pg']`` and ``launches['ts']`` count the kernel launches.
Lanes that reach their round cap are counted on the card by an integer
atomic into a per-device counter (:func:`capped_lanes` reads it).
"""

import threading

import torch

from .build import count_launch, load_library

launches = {'pg': 0, 'ts': 0}

# The JAX package's caps (polya_gamma.py:44, tilted_stable.py:41, :313),
# shared with the plain rounds.
PG_MAX_ROUNDS = 512
TS_MAX_ROUNDS = 256
TS_MAX_PARTITION = 4096
TILT_POWER_THRESHOLD = 2.0  # the crossover of tilted_stable.pyx:52
# bb_ts_draw's modes.
TS_MODES = {None: 0, 'divide-conquer': 1, 'double-rejection': 2}
_DTYPES = (torch.float32, torch.float64)

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


def tilted_stable_draw(gens, char_exponent, tilt, method=None,
                       max_rounds=TS_MAX_ROUNDS,
                       max_partition=TS_MAX_PARTITION, attempts=None,
                       plan=None):
    """Tilted-stable draws on the card: tilt (k, n) float32 or float64,
    row c drawn from gens[c]; `method` None picks each lane's method by
    ``tilt**alpha < 2``. `attempts` and `plan`, where given, (k, n) int32
    tensors that get each lane's rounds and its partitions (0 for double
    rejection; ``random.tilted_stable.lane_plan`` in plain PyTorch)."""
    x = _check_lanes('tilted_stable_draw', tilt, gens)
    if method not in TS_MODES:
        raise ValueError("Unrecognized method name.")
    for t in (attempts, plan):
        _check_out('tilted_stable_draw', t, x)
    kl = load_library()
    keys = chain_keys(gens, x.device)
    out = torch.empty_like(x)
    counter = capped_counter(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = kl.lib.bb_ts_draw(
            int(x.dtype == torch.float64), x.data_ptr(), keys.data_ptr(),
            x.shape[0], x.shape[1], float(char_exponent), TS_MODES[method],
            int(max_rounds), ts_dc_rounds(method, max_rounds, max_partition),
            int(max_partition), out.data_ptr(), counter.data_ptr() + 8,
            _ptr(attempts), _ptr(plan), stream)
    kl.check(rc, 'tilted_stable_draw')
    count_launch(launches, 'ts')
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
