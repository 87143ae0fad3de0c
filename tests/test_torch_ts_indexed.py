"""The tilted-stable kernel's sweep design in plain PyTorch, on the CPU.

On the card ``ts_draw`` (``csrc/tilted_stable.cu`` ``ts_regroup_kernel``)
runs several threads a lane, round r of lane j on its own Philox blocks
(key, j, r B + b), and decides after each sweep in round order.
``kernels.draws.tilted_stable_indexed_plain`` is that design draw for
draw in torch, on ``round_words``' words. Here: the words' counter layout
against a pure-Python Philox4x32-10; the plain version's values,
attempts and caps independent of a simulated T and of the other chains
of a batch, bit for bit; its plan equal to ``lane_plan``; its capped
lanes as the kernel keeps them (double rejection 0, divide-and-conquer
its partial sum); and its law against the JAX package's
``sample_tilted_stable`` by KS (p > 1e-4) at the tilts of
``tests/test_torch_draws.py``, and against the closed-form mean. The card
holds the kernel's attempts and values to this version
(``chip_smoke.py``'s draws phase).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import ks_2samp

from bayesbridge_tpu.random import tilted_stable as jax_ts
from bayesbridge_tpu_torch.kernels import draws
from bayesbridge_tpu_torch.random.tilted_stable import lane_plan

torch.set_num_threads(1)

_M = 0xFFFFFFFF


def _philox_py(c, k):
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & _M, (k[1] + 0xBB67AE85) & _M]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & _M, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & _M]
    return c


def _keys(seeds):
    return draws.chain_keys([torch.Generator().manual_seed(s)
                             for s in seeds], 'cpu')


@pytest.mark.parametrize('blocks', [2, 4])
def test_round_words_follow_the_round_counter_layout(blocks):
    """Round r of lane j under key K takes the Philox blocks (j low, j
    high, r B + b, 0), b < B, under (K low, K high), four words a block in
    order: a pure-Python Philox on those counters gives the same words,
    for keys above 2^32 and lanes above 2^32."""
    rng = np.random.default_rng(blocks)
    n = 60
    keys = rng.integers(0, 2 ** 63, n, dtype=np.int64)
    lanes = rng.integers(0, 2 ** 34, n, dtype=np.int64)
    rounds = rng.integers(0, 13_000, n, dtype=np.int64)
    lanes[:3] = [0, 2 ** 32 - 1, 2 ** 32 + 5]
    rounds[:3] = [0, 1, 12_351]
    got = draws.round_words(torch.from_numpy(keys), torch.from_numpy(lanes),
                            torch.from_numpy(rounds), blocks)
    assert got.shape == (n, 4 * blocks)
    for i in range(n):
        key = [int(keys[i]) & _M, int(keys[i]) >> 32]
        want = []
        for b in range(blocks):
            ctr = [int(lanes[i]) & _M, int(lanes[i]) >> 32,
                   (int(rounds[i]) * blocks + b) & _M, 0]
            want += _philox_py(ctr, key)
        assert got[i].tolist() == want, i


def _tilts(rng, k, n):
    """Tilts over both methods and the crossover: exp(N(0, 6^2)) with a
    share near tilt**alpha = 2."""
    t = np.exp(rng.standard_normal((k, n)) * 6)
    t[:, ::7] = rng.uniform(8, 24, t[:, ::7].shape)
    return t


@pytest.mark.parametrize('method', [None, 'divide-conquer',
                                    'double-rejection'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_values_do_not_depend_on_threads_per_lane_or_chains(dtype, method):
    """Values, attempts, plan and caps equal bit for bit for T = 1, 2,
    4, 8, 16, 32 (the sweep's width), and chain c of a batch of 3 equals
    chain c drawn alone."""
    rng = np.random.default_rng(5)
    tilt = torch.tensor(_tilts(rng, 3, 400), dtype=dtype)
    keys = _keys([11, 12, 13])
    kw = {} if method != 'divide-conquer' else {'max_partition': 40}
    ref = draws.tilted_stable_indexed_plain(keys, 0.3, tilt, method, **kw)
    assert ref[0].dtype == dtype and ref[0].shape == tilt.shape
    assert bool((ref[1] >= 1).all())
    for t in (2, 4, 8, 16, 32):
        got = draws.tilted_stable_indexed_plain(keys, 0.3, tilt, method,
                                                threads_per_lane=t, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), t
    for c in range(3):
        alone = draws.tilted_stable_indexed_plain(
            keys[c:c + 1], 0.3, tilt[c:c + 1], method, threads_per_lane=4,
            **kw)
        for a, r in zip(alone, ref):
            assert torch.equal(a[0], r[c]), c


def test_plan_and_caps_as_the_kernel_keeps_them():
    """The plan equals lane_plan for each method; at one round a lane a
    double-rejection lane that does not accept is capped at 0, a
    divide-and-conquer lane with more partitions than rounds keeps its
    partial sum (the 'every_round' latch) with attempts at the cap."""
    rng = np.random.default_rng(7)
    tilt = torch.tensor(_tilts(rng, 1, 3000))
    keys = _keys([21])
    for method in (None, 'divide-conquer', 'double-rejection'):
        _, _, plan, _ = draws.tilted_stable_indexed_plain(
            keys, 0.5, tilt, method, max_partition=64)
        assert torch.equal(plan, lane_plan(0.5, tilt, method, 64)), method
    dr = torch.full((1, 4000), 1e4, dtype=torch.float64)
    value, att, _, capped = draws.tilted_stable_indexed_plain(
        keys, 0.5, dr, 'double-rejection', max_rounds=1)
    assert bool((att == 1).all()) and 0 < int(capped.sum()) < dr.numel()
    assert bool((value[capped] == 0).all())
    assert bool((value[~capped] > 0).all())
    # Forced divide-and-conquer, alpha 0.5, 64 partitions at tilt**alpha
    # = 256: each partition accepted with probability exp(-4), so about
    # 4.7 of the 64 in the cap's 3 * 64 + 64 rounds: every lane capped,
    # almost all with a positive partial sum.
    dc = torch.full((1, 2000), 256.0 ** 2, dtype=torch.float64)
    value, att, plan, capped = draws.tilted_stable_indexed_plain(
        keys, 0.5, dc, 'divide-conquer', max_partition=64,
        threads_per_lane=2)
    assert bool((plan == 64).all()) and bool(capped.all())
    assert bool((att == 3 * 64 + 64).all())
    assert bool((value >= 0).all()) and float((value > 0).double().mean()) \
        > 0.9
    value, att, _, capped = draws.tilted_stable_indexed_plain(
        keys, 0.5, torch.full((1, 500), 3.9, dtype=torch.float64), None,
        max_rounds=1)
    # tilt**alpha = 1.97: divide-and-conquer with one partition; a lane
    # that does not accept its one round keeps 0 (no partial sum yet).
    assert bool(capped.any()) and bool((value[capped] == 0).all())


TILTS = {0.25: [16.0, 1e-30, 1e-6, 0.1, 1.0, 100.0, 1e4],
         0.5: [1e-30, 1e-6, 0.1, 1.0, 100.0, 1e4]}


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('alpha', [0.25, 0.5])
def test_law_matches_the_jax_sampler(alpha, dtype):
    """The sweep design's plain version against the JAX package's
    sample_tilted_stable (KS, p > 1e-4) at tests/test_torch_draws.py's
    tilts, 20,000 lanes each; no capped lane."""
    tilts = TILTS[alpha]
    n = 20_000
    x = np.repeat(tilts, n)
    ours, _, _, capped = draws.tilted_stable_indexed_plain(
        _keys([int(alpha * 100) + 1]), alpha,
        torch.tensor(x, dtype=dtype)[None], threads_per_lane=4)
    assert not bool(capped.any())
    ours = ours.double().numpy()[0]
    theirs = np.asarray(jax_ts.sample_tilted_stable(
        jax.random.key(int(alpha * 100) + 1), alpha, jnp.asarray(x)),
        np.float64)
    for i, t in enumerate(tilts):
        sel = slice(i * n, (i + 1) * n)
        assert ks_2samp(ours[sel], theirs[sel]).pvalue > 1e-4, t


@pytest.mark.parametrize('method', ['divide-conquer', 'double-rejection'])
def test_forced_methods_match_the_closed_form_mean(method):
    """Each forced method at alpha 0.4, tilt 2.5 (and divide-and-conquer
    with 50 partitions at alpha 0.5, tilt 2550): the mean within 6
    standard errors of alpha tilt^(alpha - 1)."""
    n = 30_000
    for alpha, tilt in ((0.4, 2.5), (0.5, 2550.0)):
        if method == 'double-rejection' and tilt > 100:
            continue
        x = torch.full((1, n), tilt, dtype=torch.float64)
        value, _, plan, capped = draws.tilted_stable_indexed_plain(
            _keys([31]), alpha, x, method, threads_per_lane=8)
        assert not bool(capped.any())
        if tilt > 100:
            assert bool((plan == 50).all())
        mean = alpha * tilt ** (alpha - 1)
        sd = np.sqrt(alpha * (1 - alpha) * tilt ** (alpha - 2))
        v = value.numpy()[0]
        assert np.all(v > 0)
        assert abs(v.mean() - mean) < 6 * sd / np.sqrt(n), (alpha, tilt)
