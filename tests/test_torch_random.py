"""Distributional tests of the port's rejection samplers.

torch.Generator streams cannot reproduce JAX's threefry bits, so the
port's Polya-Gamma and tilted-stable draws are held, as in
tests/test_random_kernels.py, to closed-form moments (mean within 6
standard errors, variance within 10% + 6 var / sqrt(n)) and to
Kolmogorov-Smirnov tests (p > 1e-4): between the two tilted-stable
algorithms, and between the port's and the JAX package's draws.

* tilted stable with Laplace transform exp(-s^alpha):
  E[X] = alpha t^(alpha-1), Var[X] = alpha (1-alpha) t^(alpha-2);
* Polya-Gamma PG(b, z): E = b tanh(z/2) / (2z),
  Var = b (tanh(z/2) - (z/2) / cosh(z/2)^2) / (2 z^3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import ks_2samp

from bayesbridge_tpu.random import sample_unit_shape_polya_gamma as jax_pg
from bayesbridge_tpu_torch.random import (
    BasicRandom, sample_polya_gamma, sample_tilted_stable,
    sample_unit_shape_polya_gamma,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def tilted_stable_moments(alpha, tilt):
    return alpha * tilt ** (alpha - 1.0), \
        alpha * (1.0 - alpha) * tilt ** (alpha - 2.0)


def polya_gamma_moments(b, z):
    mean = b * np.tanh(z / 2.0) / (2.0 * z)
    var = b * (np.tanh(z / 2.0) - (z / 2.0) / np.cosh(z / 2.0) ** 2) \
        / (2.0 * z ** 3)
    return mean, var


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _check_moments(draws, mean, var):
    n = draws.size
    assert np.all(np.isfinite(draws)) and np.all(draws > 0)
    assert abs(draws.mean() - mean) < 6 * np.sqrt(var / n), \
        f"mean {draws.mean():.5g} vs expected {mean:.5g}"
    assert abs(draws.var() - var) < 0.1 * var + 6 * var / np.sqrt(n)


@pytest.mark.parametrize('alpha,tilt', [
    (0.7, 1.0), (0.7, 8.0), (0.5, 3.9), (0.5, 4.1), (0.25, 1.0),
    (0.25, 40.0)])
def test_tilted_stable_moments(alpha, tilt):
    n = 200_000
    draws = sample_tilted_stable(_gen(int(alpha * 100 + tilt)), alpha,
                                 torch.full((n,), tilt)).double().numpy()
    _check_moments(draws, *tilted_stable_moments(alpha, tilt))


def test_tilted_stable_forced_methods_agree():
    """Both algorithms target the same distribution (KS between them)."""
    n = 100_000
    alpha, tilt = 0.4, 2.5
    g = _gen(0)
    dc = sample_tilted_stable(g, alpha, torch.full((n,), tilt),
                              method='divide-conquer').double().numpy()
    dr = sample_tilted_stable(g, alpha, torch.full((n,), tilt),
                              method='double-rejection').double().numpy()
    mean, var = tilted_stable_moments(alpha, tilt)
    for draws in (dc, dr):
        assert abs(draws.mean() - mean) < 6 * np.sqrt(var / n)
    assert ks_2samp(dc, dr).pvalue > 1e-4


def test_tilted_stable_heterogeneous_tilts_and_large_partition():
    """Lane-wise method selection in one call, and forced
    divide-and-conquer with 50 partitions returning the full sum."""
    tilts = np.concatenate([np.full(30_000, 0.5), np.full(30_000, 100.0)])
    draws = sample_tilted_stable(_gen(3), 0.25,
                                 torch.from_numpy(tilts)).double().numpy()
    for tilt in (0.5, 100.0):
        sel = draws[tilts == tilt]
        mean, var = tilted_stable_moments(0.25, tilt)
        assert abs(sel.mean() - mean) < 6 * np.sqrt(var / len(sel))
    n, alpha, tilt = 30_000, 0.5, 2500.0
    draws = sample_tilted_stable(_gen(7), alpha, torch.full((n,), tilt),
                                 method='divide-conquer').double().numpy()
    mean, var = tilted_stable_moments(alpha, tilt)
    assert np.all(draws > 0)
    assert abs(draws.mean() - mean) < 6 * np.sqrt(var / n) + 0.02 * mean


@pytest.mark.parametrize('alpha,tilt', [(0.25, 1.0), (0.4, 20.0)])
def test_tilted_stable_narrow_width_unbiased(alpha, tilt):
    """Narrow inputs run almost entirely in the straggler tail, where the
    memoryless chains (one-partition divide-and-conquer, double
    rejection) make several attempts per round and keep each lane's
    first success: the mean must still match the closed form."""
    g = _gen(6)
    draws = np.concatenate([
        sample_tilted_stable(g, alpha, torch.full((100,), tilt))
        .double().numpy() for _ in range(800)])
    mean, var = tilted_stable_moments(alpha, tilt)
    assert abs(draws.mean() - mean) < 5 * np.sqrt(var / draws.size)


@pytest.mark.parametrize('z', [0.5, 1.0, 4.0, 12.0])
def test_unit_polya_gamma_moments(z):
    n = 200_000
    draws = sample_unit_shape_polya_gamma(
        _gen(int(z * 100)), torch.full((n,), z)).double().numpy()
    _check_moments(draws, *polya_gamma_moments(1.0, z))


def test_polya_gamma_integer_shapes_and_symmetry():
    """PG(b, z) as the sum of b unit draws; PG depends on |tilt| only."""
    n = 30_000
    shapes = np.tile(np.array([1, 2, 5], dtype=np.int64), n)
    z = 1.3
    draws = sample_polya_gamma(_gen(7), shapes,
                               torch.full((shapes.size,), z)).double().numpy()
    for b in (1, 2, 5):
        sel = draws[shapes == b]
        mean, var = polya_gamma_moments(b, z)
        assert abs(sel.mean() - mean) < 6 * np.sqrt(var / len(sel))
    pos = sample_unit_shape_polya_gamma(_gen(11), torch.full((1000,), 2.0))
    neg = sample_unit_shape_polya_gamma(_gen(11), torch.full((1000,), -2.0))
    assert torch.equal(pos, neg)
    with pytest.raises(ValueError, match='integers'):
        sample_polya_gamma(_gen(0), np.ones(3), torch.ones(3))


def test_polya_gamma_matches_jax_in_distribution():
    """KS between the port's and the JAX package's PG(1, z) draws on a
    mix of tilts (the Gibbs step's regime: one draw per observation)."""
    n = 40_000
    z = np.repeat([0.3, 1.7, 6.0], n // 3)
    ours = sample_unit_shape_polya_gamma(
        _gen(5), torch.from_numpy(z)).double().numpy()
    theirs = np.asarray(jax_pg(jax.random.key(5), jnp.asarray(z)),
                        np.float64)
    for tilt in (0.3, 1.7, 6.0):
        sel = z == tilt
        assert ks_2samp(ours[sel], theirs[sel]).pvalue > 1e-4


def test_basic_random_state_roundtrip_and_validation():
    rg = BasicRandom('cpu', seed=0)
    state = rg.get_state()
    shape, tilt = np.array([1, 3, 2]), np.array([0.5, -1.0, 4.0])
    pg1 = rg.polya_gamma(shape, tilt)
    ts1 = rg.tilted_stable(0.25, tilt ** 2)
    rg.set_state(state)
    np.testing.assert_array_equal(pg1, rg.polya_gamma(shape, tilt))
    np.testing.assert_array_equal(ts1, rg.tilted_stable(0.25, tilt ** 2))
    with pytest.raises(ValueError, match='char_exponent'):
        sample_tilted_stable(_gen(0), 1.5, torch.ones(4))
    draws = sample_tilted_stable(_gen(1), 0.5, torch.tensor([1, 2, 3]))
    assert torch.all(torch.isfinite(draws)) and torch.all(draws > 0)
