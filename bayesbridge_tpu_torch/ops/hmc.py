"""Hamiltonian Monte Carlo kernel.

Port of ``bayesbridge_tpu/ops/hmc.py`` (reference:
bayesbridge/reg_coef_sampler/hamiltonian_monte_carlo/hmc.py:90-175 and
dynamics.py:11-83): velocity-Verlet leapfrog steps up to a step count,
stopped early when the Hamiltonian's running range passes
`hamiltonian_tol` (or the log density is not finite), then a Metropolis
correction.

The JAX package runs the trajectory as a ``lax.while_loop`` on the
device. Here each transition is a generator of one chain
(``utils.chains``: it yields ``('eval', q)`` for the target's log density
and gradient at q, and ``('host', flag)`` for the "still running?" check
after each step, one host sync per leapfrog step), so that k chains can
run their own trajectories side by side through
``utils.chains.run_lockstep``, each chain leaving the batch when its
trajectory ends, or one chain through ``utils.chains.drive`` with a
target `f(q) -> (logp, grad)` of one vector (:func:`velocity_verlet`,
:func:`simulate_dynamics`, :func:`generate_next_state`).
"""

import math
import time

import numpy as np
import torch

from ..utils.chains import drive, rdot


def compute_hamiltonian(logp, p, inv_mass_diag=None):
    kinetic = 0.5 * (rdot(p, p) if inv_mass_diag is None
                     else rdot(p, inv_mass_diag * p))
    return -logp + kinetic


def draw_momentum(gen, q, sqrt_mass_diag=None):
    """A standard normal momentum shaped like q, from `gen`."""
    p = torch.randn(q.shape, generator=gen, dtype=q.dtype, device=q.device)
    return p if sqrt_mass_diag is None else sqrt_mass_diag * p


def leapfrog(dt, q, p, grad, inv_mass_diag=None):
    """One leapfrog step as a chain's generator (dynamics.py:59-67), with
    the reference's guard: the final half-kick is skipped where the log
    density is not finite. Returns (q, p, logp, grad)."""
    p_half = p + 0.5 * dt * grad
    velocity = p_half if inv_mass_diag is None else inv_mass_diag * p_half
    q_new = q + dt * velocity
    logp, grad_new = yield 'eval', q_new
    finite = torch.isfinite(logp)
    p_new = torch.where(finite, p_half + 0.5 * dt * grad_new, p_half)
    grad_new = torch.where(finite, grad_new, torch.zeros_like(grad_new))
    return q_new, p_new, logp, grad_new


def dynamics(dt, n_step, q0, p0, logp0, grad0, hamiltonian_tol=100.0,
             inv_mass_diag=None):
    """Up to `n_step` (a host int) leapfrog steps as a chain's generator,
    stopping early on divergence (hmc.py:138-175). Returns (q, p, logp,
    grad, n_steps_taken, instability_detected)."""
    h0 = compute_hamiltonian(logp0, p0, inv_mass_diag)
    q, p, logp, grad = q0, p0, logp0, grad0
    min_h = max_h = h0
    unstable = torch.zeros((), dtype=torch.bool, device=q0.device)
    i = 0
    while i < n_step:
        q, p, logp, grad = yield from leapfrog(dt, q, p, grad,
                                               inv_mass_diag)
        h = compute_hamiltonian(logp, p, inv_mass_diag)
        min_h = torch.minimum(min_h, h)
        max_h = torch.maximum(max_h, h)
        unstable = ~torch.isfinite(logp) | ((max_h - min_h)
                                            > hamiltonian_tol)
        i += 1
        if i < n_step and (yield 'host', unstable):
            break
    return q, p, logp, grad, i, unstable


def transition(gen, dt, n_step, q0, logp0=None, grad0=None,
               hamiltonian_tol=100.0, sqrt_mass_diag=None,
               inv_mass_diag=None):
    """One MH-corrected HMC transition as a chain's generator
    (hmc.py:90-135): the momentum, then the accept uniform, from `gen`.
    Returns (q, info)."""
    n_grad_evals = 0
    if logp0 is None or grad0 is None:
        logp0, grad0 = yield 'eval', q0
        n_grad_evals += 1
    p0 = draw_momentum(gen, q0, sqrt_mass_diag)
    log_joint0 = -compute_hamiltonian(logp0, p0, inv_mass_diag)
    q, p, logp, grad, n_taken, unstable = yield from dynamics(
        dt, n_step, q0, p0, logp0, grad0, hamiltonian_tol, inv_mass_diag)
    n_grad_evals += n_taken
    log_joint = -compute_hamiltonian(logp, p, inv_mass_diag)
    hamiltonian_error = torch.where(
        unstable, torch.full_like(log_joint, -math.inf),
        log_joint - log_joint0)
    accept_prob = torch.clamp_max(torch.exp(hamiltonian_error), 1.0)
    accepted = accept_prob > torch.rand((), generator=gen, dtype=q0.dtype,
                                        device=q0.device)
    info = {
        'logp': torch.where(accepted, logp, logp0),
        'grad': torch.where(accepted, grad, grad0),
        'accepted': accepted,
        'accept_prob': accept_prob,
        'hamiltonian_error': hamiltonian_error,
        'instability_detected': unstable,
        'n_grad_evals': n_grad_evals,
    }
    return torch.where(accepted, q, q0), info


def velocity_verlet(f, dt, q, p, grad, inv_mass_diag=None):
    """One leapfrog step with the target f(q) -> (logp, grad)."""
    return drive(leapfrog(dt, q, p, grad, inv_mass_diag), f)


def simulate_dynamics(f, dt, n_step, q0, p0, logp0, grad0,
                      hamiltonian_tol=100.0, inv_mass_diag=None):
    """Up to `n_step` leapfrog steps with the target f, stopping early on
    divergence. Returns (q, p, logp, grad, n_grad_evals,
    instability_detected)."""
    return drive(dynamics(dt, int(n_step), q0, p0, logp0, grad0,
                          hamiltonian_tol, inv_mass_diag), f)


def generate_next_state(gen, f, dt, n_step, q0, logp0=None, grad0=None,
                        hamiltonian_tol=100.0, sqrt_mass_diag=None,
                        inv_mass_diag=None):
    """One MH-corrected HMC transition with the target f and the
    generator `gen`. Returns (q, info)."""
    return drive(transition(gen, dt, int(n_step), q0, logp0, grad0,
                            hamiltonian_tol, sqrt_mass_diag,
                            inv_mass_diag), f)


# -- standalone sampling driver (API parity with hmc.py:15-80) ------------ #

def generate_samples(gen, f, q0, n_burnin, n_sample, nstep_range,
                     dt_range, adapt_stepsize=False,
                     target_accept_prob=.9, final_adaptsize=.05):
    """Host-driven HMC loop: returns (samples [p, n], logp_samples,
    accept_prob, time_elapsed). `gen` is the transitions' generator; the
    stepsize and step-count jitter come from a NumPy generator seeded 0,
    as in the JAX package. Pass an explicit dt_range
    (``stepsize.initialize_stepsize`` searches for one)."""
    from .stepsize import HamiltonianBasedStepsizeAdapter

    if np.isscalar(dt_range):
        dt_range = np.array([dt_range, dt_range])
    if np.isscalar(nstep_range):
        nstep_range = np.array([nstep_range, nstep_range])
    adapter = HamiltonianBasedStepsizeAdapter(
        init_stepsize=1., target_accept_prob=target_accept_prob,
        reference_iteration=n_burnin, adaptsize_at_reference=final_adaptsize)
    q = torch.as_tensor(q0)
    n_total = n_burnin + n_sample
    samples = np.zeros((len(q0), n_total))
    logp_samples = np.zeros(n_total)
    accept_prob = np.zeros(n_total)
    tic = time.time()
    use_averaged = False
    rng = np.random.default_rng(0)
    for i in range(n_total):
        dt = rng.uniform(dt_range[0], dt_range[1]) \
            * adapter.get_current_stepsize(use_averaged)
        n_step = rng.integers(nstep_range[0], nstep_range[1] + 1)
        q, info = generate_next_state(gen, f, dt, n_step, q)
        if i < n_burnin and adapt_stepsize:
            adapter.adapt_stepsize(float(info['hamiltonian_error']))
        elif i == n_burnin - 1:
            use_averaged = True
        samples[:, i] = q.cpu().numpy()
        logp_samples[i] = float(info['logp'])
        accept_prob[i] = float(info['accept_prob'])
    return samples, logp_samples, accept_prob, time.time() - tic
