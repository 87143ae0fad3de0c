"""The rejection draws' dispatch and launch preparation on the CPU.

On the card the Polya-Gamma and tilted-stable draws run as hand-written
kernels (``csrc/polya_gamma.cu``, ``csrc/tilted_stable.cu``, wrappers in
``bayesbridge_tpu_torch/kernels/draws.py``), held to the plain rounds in
law by ``tests/test_torch_cuda.py``. Here: a CPU tensor reaches the plain
rounds with the bits of a direct call; a wrapper given a tensor off the
card raises; what the wrappers prepare for a launch (one key per chain,
each lane's method and partitions, the forced methods' caps, integer
shapes held on the model's device) agrees with the plain path and the
JAX package (the kernels split a thread into chain i // n and lane
i % n, the rounds' layout; the card test holds each chain of a batch
to the chain alone); the plain Philox4x32-10 equals
a pure-Python one and Random123's known answers; and the plain rounds
agree with the JAX package's samplers in distribution (KS, p > 1e-4) at
the card tests' tilts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import ks_2samp

from bayesbridge_tpu.random import polya_gamma as jax_pg
from bayesbridge_tpu.random import tilted_stable as jax_ts
from bayesbridge_tpu_torch import RegressionModel
from bayesbridge_tpu_torch.kernels import (
    draws, launch_counts, reset_launch_counts,
)
from bayesbridge_tpu_torch.random.polya_gamma import (
    sample_polya_gamma_chains, sample_polya_gamma_plain,
)
from bayesbridge_tpu_torch.random.tilted_stable import (
    lane_plan, sample_tilted_stable_chains, sample_tilted_stable_plain,
)
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

torch.set_num_threads(1)


def _gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


@pytest.mark.parametrize('shape', ['none', 'ones', 'host', 'tensor'])
def test_polya_gamma_cpu_reaches_the_plain_rounds(shape):
    """Every form of the shapes gives the plain entry's bits on the CPU
    (host ones and None both the unit-shape rounds), with no launch."""
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((3, 400)) * 3).float()
    b = rng.integers(1, 4, 400)
    given = {'none': None, 'ones': np.ones(400, np.int64), 'host': b,
             'tensor': torch.as_tensor(b, dtype=torch.int32)}[shape]
    plain_shape = b if shape in ('host', 'tensor') else None
    reset_launch_counts()
    got = sample_polya_gamma_chains(_gens([1, 2, 3]), given, z)
    ref = sample_polya_gamma_plain(_gens([1, 2, 3]), plain_shape, z)
    assert torch.equal(got, ref)
    assert launch_counts()['pg_draw'] == 0


@pytest.mark.parametrize('method', [None, 'divide-conquer',
                                    'double-rejection'])
def test_tilted_stable_cpu_reaches_the_plain_rounds(method):
    rng = np.random.default_rng(1)
    tilt = torch.from_numpy(np.exp(rng.standard_normal((2, 300)) * 4))
    reset_launch_counts()
    got = sample_tilted_stable_chains(_gens([4, 5]), 0.3, tilt, method)
    ref = sample_tilted_stable_plain(_gens([4, 5]), 0.3, tilt, method)
    assert torch.equal(got, ref)
    assert launch_counts()['ts_draw'] == 0


def test_wrappers_raise_off_the_card():
    """No fallback: the kernels' wrappers raise for a CPU tensor, and the
    dispatch points for a device with neither kernel nor plain route."""
    z = torch.ones((1, 8))
    with pytest.raises(ValueError, match='no kernel'):
        draws.polya_gamma_draw(_gens([0]), z)
    with pytest.raises(ValueError, match='no kernel'):
        draws.tilted_stable_draw(_gens([0]), 0.5, z)
    meta = torch.ones((1, 8), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        sample_polya_gamma_chains(_gens([0]), None, meta)
    with pytest.raises(ValueError, match='no kernel'):
        sample_tilted_stable_chains(_gens([0]), 0.5, meta)
    with pytest.raises(ValueError, match='Unrecognized'):
        sample_tilted_stable_chains(_gens([0]), 0.5, z, 'other')
    with pytest.raises(ValueError, match='integers'):
        sample_polya_gamma_chains(_gens([0]), torch.ones(8), z)
    with pytest.raises(ValueError, match='same length'):
        sample_polya_gamma_chains(_gens([0]), np.ones(7, np.int64), z)


def test_chain_keys_one_per_chain_from_its_generator():
    """The key of chain c depends on gens[c] alone (a batch's key c
    equals the chain's key drawn alone), a rerun from the same states
    gives the same keys, and each key draw moves its generator on."""
    keys = draws.chain_keys(_gens([7, 8, 9]), 'cpu')
    assert keys.dtype == torch.int64 and keys.shape == (3,)
    assert torch.equal(keys, draws.chain_keys(_gens([7, 8, 9]), 'cpu'))
    for c, seed in enumerate((7, 8, 9)):
        assert keys[c] == draws.chain_keys(_gens([seed]), 'cpu')[0]
    assert len(set(keys.tolist())) == 3 and bool((keys >= 0).all())
    g = torch.Generator().manual_seed(7)
    first = draws.chain_keys([g], 'cpu')
    assert not torch.equal(first, draws.chain_keys([g], 'cpu'))


@pytest.mark.parametrize('alpha', [0.25, 0.5, 0.8])
def test_lane_plan_matches_the_jax_rule(alpha):
    """Each lane's method by tilt**alpha < 2 and its partitions
    max(1, floor(min(tilt**alpha, max_partition))) (the JAX package's
    rule, tilted_stable.py:105-107 and :361-366, in numpy), for the
    automatic choice and both forced methods, tilts from the float32
    clamp to 1e12."""
    rng = np.random.default_rng(2)
    tilt = np.concatenate([[0.0, 1e-40, 1e-30, 1e12],
                           np.exp(rng.uniform(-30, 27, 2000))])
    tilt = tilt[None].astype(np.float64)
    x = torch.from_numpy(tilt)
    clamped = np.maximum(tilt, np.finfo(np.float32).tiny)
    tp = clamped ** alpha
    m = np.maximum(1, np.floor(np.minimum(tp, 4096.0))).astype(np.int32)
    near = np.abs(tp - np.round(tp)) < 1e-9 * np.maximum(tp, 1)
    for method, dc in ((None, tp < 2.0), ('divide-conquer', True),
                       ('double-rejection', False)):
        want = np.where(dc, m, 0)
        got = lane_plan(alpha, x, method).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got[~near], want[~near])
    assert lane_plan(alpha, x, None, max_partition=8).max() <= 1


def test_forced_divide_conquer_caps():
    """The round caps the tilted-stable wrapper passes (the JAX package's
    tilted_stable.py:381-382): max_rounds when each lane picks, and
    max(max_rounds, 3 max_partition + 64) for forced
    divide-and-conquer."""
    assert draws.ts_dc_rounds(None) == draws.TS_MAX_ROUNDS == 256
    assert draws.ts_dc_rounds('divide-conquer') == 3 * 4096 + 64
    assert draws.ts_dc_rounds('divide-conquer', 256, 10) == 256
    assert draws.ts_dc_rounds('divide-conquer', 300, 100) == 364
    assert draws.PG_MAX_ROUNDS == jax_pg._MAX_REJECTION_ROUNDS
    assert draws.TS_MAX_ROUNDS == jax_ts._MAX_REJECTION_ROUNDS
    assert draws.TILT_POWER_THRESHOLD == jax_ts.TILT_POWER_THRESHOLD
    assert draws.TS_MODES == {None: 0, 'divide-conquer': 1,
                              'double-rejection': 2}


@pytest.mark.parametrize('trials', ['ones', 'counts'])
def test_model_holds_integer_shapes_on_its_device(trials):
    """The logit model's pg_shape: None where every trial count is 1 (the
    kernel then takes no shapes), else the counts as int32 on the model's
    device; the chain step's draw from it equals the host counts' bits."""
    X = simulate_design(60, 8, binary_frac=.5, seed=1)
    beta = np.zeros(8)
    n_trial = np.ones(60) if trials == 'ones' \
        else 1 + np.random.default_rng(3).binomial(3, .5, 60)
    outcome = simulate_outcome(X, beta, 'logit', n_trial=n_trial, seed=2)
    model = RegressionModel(outcome, X, family='logit', device='cpu')
    if trials == 'ones':
        assert model.pg_shape is None
    else:
        assert model.pg_shape.dtype == torch.int32
        assert model.pg_shape.device == model.design.device
        np.testing.assert_array_equal(model.pg_shape.numpy(), n_trial)
    z = torch.linspace(-3, 3, 120).reshape(2, 60)
    got = sample_polya_gamma_chains(_gens([5, 6]), model.pg_shape, z)
    ref = sample_polya_gamma_chains(_gens([5, 6]), model.n_trial_np, z)
    assert torch.equal(got, ref)


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


def test_plain_philox_matches_python_and_known_answers():
    """draws.philox_plain (the card test's reference for the kernels'
    Philox4x32-10) against a pure-Python Philox and Random123's
    known-answer vectors."""
    rng = np.random.default_rng(4)
    ctr = rng.integers(0, 2 ** 32, (500, 4)).tolist() + [[0] * 4, [_M] * 4]
    key = rng.integers(0, 2 ** 32, (500, 2)).tolist() + [[0] * 2, [_M] * 2]
    got = draws.philox_plain(torch.tensor(ctr), torch.tensor(key)).tolist()
    assert got == [_philox_py(c, k) for c, k in zip(ctr, key)]
    kat = draws.philox_plain(
        torch.tensor([[0] * 4, [_M] * 4,
                      [0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344]]),
        torch.tensor([[0, 0], [_M, _M], [0xa4093822, 0x299f31d0]]))
    assert kat.tolist() == [
        [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8],
        [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd],
        [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]]


@pytest.mark.parametrize('alpha', [0.25, 0.5])
def test_tilted_stable_plain_matches_jax_in_distribution(alpha):
    """The plain rounds against the JAX package's sample_tilted_stable
    (KS, p > 1e-4) at the card tests' tilts, 20,000 lanes each."""
    tilts = ([16.0] if alpha == 0.25 else []) \
        + [1e-30, 1e-6, 0.1, 1.0, 100.0, 1e4]
    n = 20_000
    x = np.repeat(tilts, n)
    ours = sample_tilted_stable_plain(
        _gens([int(alpha * 100)]), alpha,
        torch.from_numpy(x)[None]).double().numpy()[0]
    theirs = np.asarray(jax_ts.sample_tilted_stable(
        jax.random.key(int(alpha * 100)), alpha, jnp.asarray(x)),
        np.float64)
    for i, t in enumerate(tilts):
        sel = slice(i * n, (i + 1) * n)
        assert ks_2samp(ours[sel], theirs[sel]).pvalue > 1e-4, t


def test_polya_gamma_plain_matches_jax_with_integer_shapes():
    """PG(b, z) of the plain rounds against the JAX package's
    sample_polya_gamma (KS, p > 1e-4) for b in 1, 2, 5 at the card
    tests' z."""
    zs = [0.0, 0.1, 1.0, 4.0, 20.0, 40.0]
    n = 6_000
    b = np.tile([1, 2, 5], len(zs) * n // 3).astype(np.int64)
    z = np.repeat(zs, n)
    ours = sample_polya_gamma_plain(_gens([9]), b,
                                    torch.from_numpy(z)[None])
    ours = ours.double().numpy()[0]
    theirs = np.asarray(jax_pg.sample_polya_gamma(jax.random.key(9), b,
                                                  jnp.asarray(z)),
                        np.float64)
    for zi in zs:
        for bi in (1, 2, 5):
            sel = (z == zi) & (b == bi)
            assert ks_2samp(ours[sel], theirs[sel]).pvalue > 1e-4, (zi, bi)
