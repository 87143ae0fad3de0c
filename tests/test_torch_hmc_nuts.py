"""The port's HMC and NUTS kernels, stepsize adapters, power iteration
and stability-estimate clamp on the CPU.

Mirrors tests/test_hmc_nuts.py on the port (the moments of an
analytically known Gaussian under HMC and NUTS, here within 4.5
ESS-aware Monte-Carlo standard errors, sane tree statistics,
divergence detection, the standalone drivers, the stepsize search, the
clamp after a long history), and holds the deterministic parts against
the JAX package on the same inputs, float64 within rtol 1e-10:

* ``velocity_verlet`` and ``simulate_dynamics`` trajectories given q0,
  p0, dt and the step count (with an early stop on divergence);
* the in-step adapter's sequence given the same Hamiltonian errors;
* ``power_iteration_top_eigenvalue`` given the same operator and v0:
  eigenvalue, vector and the number of matvecs;
* ``_stabilize_estimate`` on buffers with an even number of filled
  slots (``jnp.nanmedian`` averages the two middle values, where
  ``torch.nanmedian`` would take the lower one).

The chains' side-by-side driver (``utils.chains.run_lockstep``): k HMC
transitions with their own step counts and k NUTS transitions equal each
chain's transition run alone, bit for bit.
"""

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch.ops import hmc, nuts
from bayesbridge_tpu_torch.ops import hmc_update, stepsize
from bayesbridge_tpu_torch.ops.stepsize import initialize_stepsize
from bayesbridge_tpu_torch.utils.chains import run_lockstep

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

SD = torch.tensor([0.5, 1.0, 2.0, 4.0], dtype=torch.float64)


def gaussian_logp_grad(q):
    logp = -0.5 * torch.sum((q / SD) ** 2)
    return logp, -q / SD ** 2


def gaussian_rows(Q, rows):
    """The Gaussian target on chains' rows (the lockstep driver's form)."""
    return -0.5 * ((Q / SD) ** 2).sum(-1), -Q / SD ** 2


def _run_kernel(step, gen, n_samples, q0):
    q = q0
    out = np.zeros((len(q0), n_samples))
    for i in range(n_samples):
        q, _ = step(gen, q)
        out[:, i] = q.numpy()
    return out


def _assert_gaussian_moments(samples):
    """Mean zero and sd SD within 4.5 Monte-Carlo standard errors, from
    the draws' effective sample size (an sd estimate's relative standard
    error is 1 / sqrt(2 ESS))."""
    from bayesbridge_tpu_torch.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.asarray(compute_effective_sample_size(samples))
    sd = SD.numpy()
    z_mean = np.abs(samples.mean(axis=1)) / (sd / np.sqrt(ess))
    z_sd = np.abs(samples.std(axis=1) / sd - 1) * np.sqrt(2 * ess)
    assert z_mean.max() < 4.5 and z_sd.max() < 4.5, (z_mean, z_sd, ess)


def test_hmc_samples_gaussian_moments():
    """dt 0.25 and 8-16 steps (the JAX suite's 12 steps, jittered: a fixed
    length near half the unit coordinate's period makes its draws
    antithetic, and their sd estimate's error is then not 1 / sqrt(2
    ESS))."""
    n_steps = np.random.default_rng(0).integers(8, 17, size=2500)
    it = iter(n_steps)
    samples = _run_kernel(
        lambda g, q: hmc.generate_next_state(g, gaussian_logp_grad, 0.25,
                                             next(it), q),
        torch.Generator().manual_seed(0), 2500,
        torch.zeros(4, dtype=torch.float64))
    _assert_gaussian_moments(samples[:, 300:])


def test_nuts_samples_gaussian_moments():
    samples = _run_kernel(
        lambda g, q: nuts.generate_next_state(g, gaussian_logp_grad, 0.3,
                                              q, max_height=8),
        torch.Generator().manual_seed(1), 1500,
        torch.zeros(4, dtype=torch.float64))
    _assert_gaussian_moments(samples[:, 300:])


def test_nuts_tree_stats_sane():
    _, info = nuts.generate_next_state(
        torch.Generator().manual_seed(2), gaussian_logp_grad, 0.3,
        torch.zeros(4, dtype=torch.float64), max_height=8)
    assert 1 <= info['tree_height'] <= 8
    assert 0.0 <= float(info['ave_accept_prob']) <= 1.0
    assert info['n_grad_evals'] >= 1
    assert np.isfinite(float(info['ave_hamiltonian_error']))


def test_hmc_divergence_detection():
    """A wildly unstable stepsize is flagged and rejected, and the
    trajectory stops early."""
    def sharp_logp(q):
        return -0.5 * torch.sum((q * 100.0) ** 2), -q * 10000.0

    q0 = torch.full((4,), 0.05, dtype=torch.float64)
    q, info = hmc.generate_next_state(torch.Generator().manual_seed(3),
                                      sharp_logp, 5.0, 20, q0)
    assert bool(info['instability_detected'])
    assert not bool(info['accepted'])
    assert info['n_grad_evals'] < 21
    assert torch.equal(q, q0)


def test_standalone_drivers_run():
    gen = torch.Generator().manual_seed(4)
    samples, logp, accept, elapsed = hmc.generate_samples(
        gen, gaussian_logp_grad, np.zeros(4), n_burnin=50, n_sample=100,
        nstep_range=(5, 10), dt_range=(0.2, 0.3), adapt_stepsize=True)
    assert samples.shape == (4, 150) and np.isfinite(logp).all()
    samples, info = nuts.generate_samples(
        gen, gaussian_logp_grad, np.zeros(4), n_burnin=50, n_sample=100,
        dt_range=(0.2, 0.3), adapt_stepsize=True)
    assert samples.shape == (4, 150)
    assert np.isfinite(info['logp_samples']).all()


def test_initialize_stepsize_search():
    def accept_prob(dt):
        _, info = hmc.generate_next_state(
            torch.Generator().manual_seed(0), gaussian_logp_grad, dt, 1,
            torch.ones(4, dtype=torch.float64))
        return float(info['accept_prob'])

    dt = initialize_stepsize(accept_prob)
    assert 0 < dt < 100


def test_trajectories_match_jax():
    import jax.numpy as jnp
    from bayesbridge_tpu.ops import hmc as jax_hmc
    sd = jnp.asarray(SD.numpy())

    def jax_target(q):
        return -0.5 * jnp.sum((q / sd) ** 2), -q / sd ** 2

    rng = np.random.default_rng(5)
    q0, p0 = rng.standard_normal(4), rng.standard_normal(4)
    lp0, g0 = gaussian_logp_grad(torch.from_numpy(q0))
    out = hmc.velocity_verlet(gaussian_logp_grad, 0.3, torch.from_numpy(q0),
                              torch.from_numpy(p0), g0)
    jout = jax_hmc.velocity_verlet(jax_target, 0.3, jnp.asarray(q0),
                                   jnp.asarray(p0), jnp.asarray(g0.numpy()))
    for a, b in zip(out, jout):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-14)
    # 17 steps, and a stepsize past the stability limit that stops early.
    for dt, n_step in ((0.3, 17), (2.5, 40)):
        out = hmc.simulate_dynamics(
            gaussian_logp_grad, dt, n_step, torch.from_numpy(q0),
            torch.from_numpy(p0), lp0, g0)
        jout = jax_hmc.simulate_dynamics(
            jax_target, dt, n_step, jnp.asarray(q0), jnp.asarray(p0),
            jnp.asarray(lp0.numpy()), jnp.asarray(g0.numpy()))
        assert out[4] == int(jout[4]) and bool(out[5]) == bool(jout[5])
        for a, b in zip(out[:4], jout[:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-10, atol=1e-14)
    assert out[4] < 40 and bool(out[5])


def test_adapter_sequence_matches_jax():
    import jax.numpy as jnp
    from bayesbridge_tpu.ops import stepsize as jax_stepsize
    errors = np.random.default_rng(6).standard_normal(60) * 0.4
    errors[[5, 17]] = 0.0  # log10 of zero
    errors[9] = -np.inf  # an unstable trajectory
    state, params = stepsize.hamiltonian_adapter_init(torch.float64, 'cpu')
    jstate, jparams = jax_stepsize.hamiltonian_adapter_init(jnp.float64)
    assert params == jparams
    for e in errors:
        state = stepsize.hamiltonian_adapter_update(
            state, params, torch.tensor(e, dtype=torch.float64))
        jstate = jax_stepsize.hamiltonian_adapter_update(
            jstate, jparams, jnp.asarray(e))
        for key in state:
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(jstate[key]), rtol=1e-10)
    np.testing.assert_allclose(
        float(stepsize.adapter_stepsize(state, averaged=True)),
        float(jax_stepsize.adapter_stepsize(jstate, averaged=True)),
        rtol=1e-10)
    host = stepsize.HamiltonianBasedStepsizeAdapter(0.3)
    jhost = jax_stepsize.HamiltonianBasedStepsizeAdapter(0.3)
    for e in errors[:20]:
        np.testing.assert_allclose(host.adapt_stepsize(e),
                                   jhost.adapt_stepsize(e), rtol=1e-12)


def test_power_iteration_matches_jax():
    import jax.numpy as jnp
    from bayesbridge_tpu.ops.hmc_update import (
        power_iteration_top_eigenvalue as jax_power,
    )
    rng = np.random.default_rng(7)
    A = rng.standard_normal((30, 30))
    A = A @ A.T / 30 + np.diag(np.linspace(0.1, 2.0, 30))
    v0 = rng.standard_normal(30)
    A_t = torch.from_numpy(A)
    for tol, max_iter in ((0.1, 50), (1e-9, 50), (1e-12, 7)):
        eig, vec, n = hmc_update.power_iteration_top_eigenvalue(
            lambda v: A_t @ v, torch.from_numpy(v0), tol, max_iter)
        jeig, jvec, jn = jax_power(lambda v: jnp.asarray(A) @ v,
                                   jnp.asarray(v0), tol, max_iter)
        assert n == int(jn)
        np.testing.assert_allclose(float(eig), float(jeig), rtol=1e-10)
        np.testing.assert_allclose(vec.numpy(), np.asarray(jvec),
                                   rtol=1e-10, atol=1e-12)
    assert n == 7
    # k chains' power iterations side by side: each chain's own stop.
    V0 = torch.from_numpy(rng.standard_normal((3, 30)))
    scales = torch.tensor([1.0, 3.0, 0.2], dtype=torch.float64)
    eigs, vecs, ns = hmc_update.power_iteration_top_eigenvalue(
        lambda V, rows: scales[rows, None] * (V @ A_t.T), V0, 1e-6)
    for c in range(3):
        eig, vec, n = hmc_update.power_iteration_top_eigenvalue(
            lambda v: scales[c] * (A_t @ v), V0[c], 1e-6)
        assert ns[c] == n
        np.testing.assert_allclose(float(eigs[c]), float(eig), rtol=1e-12)


@pytest.mark.parametrize('n_filled', [4, 10, 99, 100, 250])
def test_stabilizer_matches_jax(n_filled):
    """Even counts of filled slots: the median is the mean of the two
    middle values (jnp.nanmedian), as the port's midpoint quantile
    computes it."""
    import jax.numpy as jnp
    from bayesbridge_tpu.ops.hmc_update import (
        _STAB_BUFFER, _stabilize_estimate as jax_stab,
    )
    assert hmc_update._STAB_BUFFER == _STAB_BUFFER
    rng = np.random.default_rng(n_filled)
    history = rng.lognormal(0.0, 0.3, n_filled)
    buffer = np.zeros(_STAB_BUFFER)
    for i, h in enumerate(history):
        buffer[i % _STAB_BUFFER] = h
    for estimate in (0.9, 1.4, 5.0, 50.0):
        carry = {'stab_buffer': torch.from_numpy(buffer),
                 'stab_n': torch.tensor(n_filled, dtype=torch.int32)}
        jcarry = {'stab_buffer': jnp.asarray(buffer),
                  'stab_n': jnp.asarray(n_filled, jnp.int32)}
        out, res = hmc_update._stabilize_estimate(
            carry, torch.tensor(estimate, dtype=torch.float64))
        jout, jres = jax_stab(jcarry, jnp.asarray(estimate))
        np.testing.assert_allclose(float(res), float(jres), rtol=1e-10)
        np.testing.assert_array_equal(out['stab_buffer'].numpy(),
                                      np.asarray(jout['stab_buffer']))
        assert int(out['stab_n']) == int(jout['stab_n'])
    median = hmc_update._nanquantile(
        torch.tensor([4., 1., np.nan, 3.]), 0.5, 'midpoint')
    assert float(median) == 3.0  # torch.nanmedian gives 3's lower, 3


def test_stability_estimate_stabilizer_clamps_after_long_history():
    """The clamp keeps working after more updates than the ring buffer
    holds (the empirical CDF's denominator is the window's occupancy)."""
    rng = np.random.default_rng(0)
    carry = {'stab_buffer': torch.zeros(hmc_update._STAB_BUFFER,
                                        dtype=torch.float64),
             'stab_n': torch.tensor(0, dtype=torch.int32)}
    for val in rng.normal(1.0, 0.05, size=3 * hmc_update._STAB_BUFFER):
        carry, _ = hmc_update._stabilize_estimate(
            carry, torch.tensor(val, dtype=torch.float64))
    assert int(carry['stab_n']) == 3 * hmc_update._STAB_BUFFER
    _, clamped = hmc_update._stabilize_estimate(
        carry, torch.tensor(10.0, dtype=torch.float64))
    assert float(clamped) < 2.0, float(clamped)
    _, passed = hmc_update._stabilize_estimate(
        carry, torch.tensor(0.98, dtype=torch.float64))
    np.testing.assert_allclose(float(passed), 0.98)


@pytest.mark.parametrize('kernel', ['hmc', 'nuts'])
def test_lockstep_chains_equal_chains_alone(kernel):
    """Three chains' transitions side by side (their own stepsizes, step
    counts and trees; one target call per step for the chains still
    running) equal each chain's transition alone, bit for bit."""
    q0 = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 4)))
    dts = [0.2, 0.45, 0.3]
    n_steps = [3, 11, 7]

    def coro(c, gen):
        if kernel == 'hmc':
            return hmc.transition(gen, dts[c], n_steps[c], q0[c].clone())
        return nuts.transition(gen, dts[c], q0[c].clone(), max_height=6)

    calls = []

    def target(Q, rows):
        calls.append(len(rows))
        return gaussian_rows(Q, rows)

    together = run_lockstep([coro(c, torch.Generator().manual_seed(c))
                             for c in range(3)], target)
    for c in range(3):
        alone = run_lockstep([coro(c, torch.Generator().manual_seed(c))],
                             gaussian_rows)
        assert torch.equal(together[c][0], alone[0][0])
        assert together[c][1]['n_grad_evals'] == alone[0][1]['n_grad_evals']
    if kernel == 'hmc':
        # One call per step while any chain runs, the batch shrinking.
        assert calls[0] == 3 and calls[-1] == 1
        assert len(calls) == 1 + max(n_steps)
