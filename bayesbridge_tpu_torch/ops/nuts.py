"""No-U-Turn Sampler, iterative.

Port of ``bayesbridge_tpu/ops/nuts.py`` (reference:
bayesbridge/reg_coef_sampler/hamiltonian_monte_carlo/nuts.py:9-337). The
reference builds its doubling trajectory by recursion; the JAX package
re-derives it iteratively, and this port keeps that derivation:

* each doubling builds a subtree of up to 2^h leapfrog states in turn;
  the recursive version's U-turn checks at every complete dyadic
  sub-interval are reproduced by a checkpoint stack indexed by the bit
  pattern of the leaf counter (store at popcount(i >> 1) for even i,
  check slots [idx_max - trailing_ones(i) + 1, idx_max] for odd i);
* within a subtree the sample is kept by reservoir substitution, across
  doublings by the reference's 'swap' rule (probability n_new / n_old);
* the slice variable, the divergence criterion (Hamiltonian range >
  100), the node-weighted average acceptance and Hamiltonian error, and
  the momentum U-turn test follow nuts.py:108-337.

The leaf counter, the tree height and the directions live on the host
(the directions are read once per transition), so the checkpoint stack
is a dict of the stored states and a U-turn check computes only its
active slots. A transition is a generator of one chain (``utils.chains``):
one ``('eval', q)`` and one ``('host', flags)`` request per leapfrog
step, one more ``'host'`` request per doubling; k chains grow their own
trees side by side through ``utils.chains.run_lockstep``.
"""

import math
import time

import numpy as np
import torch

from ..utils.chains import drive, rdot
from .hmc import compute_hamiltonian, leapfrog


def _popcount(x):
    return bin(x).count('1')


def _trailing_ones(x):
    """The number of contiguous low-order 1-bits."""
    n = 0
    while x & 1:
        x >>= 1
        n += 1
    return n


def _u_turned(d, q_start, p_start, q_end, p_end):
    """Momentum-based U-turn between the two ends of an interval built in
    direction d (nuts.py:310-320)."""
    dq = d * (q_end - q_start)
    return (rdot(dq, p_end) < 0) | (rdot(dq, p_start) < 0)


def _build_subtree(gen, dt, d, h, start, threshold, init_joint,
                   hamiltonian_tol):
    """Up to 2^h new states from `start` = (q, p, grad) in direction d,
    as a chain's generator; one reservoir uniform per state from `gen`.
    Returns the subtree summary (a dict; 'turning' and 'unstable' host
    bools)."""
    q, p, grad = start
    dtype, dev = q.dtype, q.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    ckpt = {}
    s = dict(n_acc=torch.zeros((), dtype=torch.int32, device=dev),
             sample_q=q, sample_logp=zero, sample_grad=grad,
             min_h=torch.full((), math.inf, dtype=dtype, device=dev),
             max_h=torch.full((), -math.inf, dtype=dtype, device=dev),
             sum_err=zero, sum_acc=zero)
    turning = unstable = False
    i = 0
    while i < 1 << h and not (turning or unstable):
        q, p, logp, grad = yield from leapfrog(d * dt, q, p, grad)
        joint = torch.where(torch.isfinite(logp),
                            -compute_hamiltonian(logp, p),
                            torch.full_like(logp, -math.inf))
        acceptable = joint > threshold
        n_acc = s['n_acc'] + acceptable.to(torch.int32)
        take = torch.rand((), generator=gen, dtype=dtype, device=dev) \
            < acceptable.to(dtype) / torch.clamp_min(n_acc, 1).to(dtype)
        idx_max = _popcount(i >> 1)
        turned = torch.zeros((), dtype=torch.bool, device=dev)
        if i % 2 == 0:  # an even leaf stores a checkpoint
            ckpt[idx_max] = (q, p)
        else:  # an odd leaf checks the checkpoints idx_min..idx_max
            for j in range(idx_max - _trailing_ones(i) + 1, idx_max + 1):
                q_j, p_j = ckpt.get(j, (torch.zeros_like(q),
                                        torch.zeros_like(p)))
                turned = turned | _u_turned(d, q_j, p_j, q, p)
        s = dict(
            n_acc=n_acc,
            sample_q=torch.where(take, q, s['sample_q']),
            sample_logp=torch.where(take, logp, s['sample_logp']),
            sample_grad=torch.where(take, grad, s['sample_grad']),
            min_h=torch.minimum(s['min_h'], -joint),
            max_h=torch.maximum(s['max_h'], -joint),
            sum_err=s['sum_err'] + (init_joint - joint).abs(),
            sum_acc=s['sum_acc'] + torch.clamp_max(
                torch.exp(joint - init_joint), 1.0))
        i += 1
        turning, unstable = yield 'host', torch.stack((
            turned, (s['max_h'] - s['min_h']) > hamiltonian_tol))
    return dict(s, q=q, p=p, grad=grad, turning=turning, unstable=unstable,
                n_integrated=i)


def transition(gen, dt, q0, logp0=None, grad0=None, max_height=10,
               hamiltonian_error_tol=100.0):
    """One NUTS transition as a chain's generator (nuts.py:108-151): from
    `gen`, the momentum, the slice's exponential, the directions, then
    the subtrees' draws and one swap uniform per doubling. Returns
    (q, info)."""
    dtype, dev = q0.dtype, q0.device
    n_init_grad = 0
    if logp0 is None or grad0 is None:
        logp0, grad0 = yield 'eval', q0
        n_init_grad = 1  # counted, as in the reference (nuts.py:111-114)
    p0 = torch.randn(q0.shape, generator=gen, dtype=dtype, device=dev)
    joint0 = -compute_hamiltonian(logp0, p0)
    threshold = joint0 - torch.empty((), dtype=dtype, device=dev) \
        .exponential_(generator=gen)
    backward = yield 'host', torch.rand(max_height, generator=gen,
                                        dtype=dtype, device=dev) < 0.5
    fwd = bwd = (q0, p0, grad0)
    sample = (q0, logp0, grad0)
    n_acc = (joint0 > threshold).to(torch.int32)
    min_h = max_h = -joint0
    sum_err = torch.zeros((), dtype=dtype, device=dev)
    sum_acc = torch.ones((), dtype=dtype, device=dev)
    n_nodes = 1
    n_grad = 0
    attempts = 0
    u_turn = unstable = last_rejected = False
    while attempts < max_height and not (u_turn or unstable):
        d = -1.0 if backward[attempts] else 1.0
        sub = yield from _build_subtree(
            gen, dt, d, attempts, fwd if d > 0 else bwd, threshold, joint0,
            hamiltonian_error_tol)
        terminated_within = sub['turning'] or sub['unstable']
        # 'swap' (nuts.py:287-295): probability n_new / n_old.
        swap_prob = sub['n_acc'].to(dtype) \
            / torch.clamp_min(n_acc, 1).to(dtype)
        u = torch.rand((), generator=gen, dtype=dtype, device=dev)
        if not terminated_within:
            do_swap = u < swap_prob
            sample = tuple(torch.where(do_swap, new, old) for new, old in
                           zip((sub['sample_q'], sub['sample_logp'],
                                sub['sample_grad']), sample))
            end = (sub['q'], sub['p'], sub['grad'])
            if d > 0:
                fwd = end
            else:
                bwd = end
            n_acc = n_acc + sub['n_acc']
            sum_err = sum_err + sub['sum_err']
            sum_acc = sum_acc + sub['sum_acc']
            n_nodes += sub['n_integrated']
        min_h = torch.minimum(min_h, sub['min_h'])
        max_h = torch.maximum(max_h, sub['max_h'])
        n_grad += sub['n_integrated']
        attempts += 1
        last_rejected = terminated_within
        # The whole trajectory's U-turn after a merge (nuts.py:296-299).
        whole_turn, unstable = yield 'host', torch.stack((
            _u_turned(1.0, bwd[0], bwd[1], fwd[0], fwd[1]),
            (max_h - min_h) > hamiltonian_error_tol))
        u_turn = u_turn or sub['turning'] \
            or (not terminated_within and whole_turn)
    info = {
        'logp': sample[1],
        'grad': sample[2],
        'ave_accept_prob': sum_acc / n_nodes,
        'ave_hamiltonian_error': sum_err / n_nodes,
        'n_grad_evals': n_grad + n_init_grad,
        'tree_height': attempts,
        'u_turn_detected': u_turn,
        'instability_detected': unstable,
        'last_doubling_rejected': last_rejected,
    }
    return sample[0], info


def generate_next_state(gen, f, dt, q0, logp0=None, grad0=None,
                        max_height=10, hamiltonian_error_tol=100.0):
    """One NUTS transition with the target f(q) -> (logp, grad) and the
    generator `gen`. Returns (q, info)."""
    return drive(transition(gen, dt, q0, logp0, grad0, max_height,
                            hamiltonian_error_tol), f)


# -- standalone sampling driver (API parity with nuts.py:23-105) ---------- #

def generate_samples(gen, f, q0, n_burnin, n_sample, dt_range,
                     adapt_stepsize=False, target_accept_prob=.9,
                     final_adaptsize=.05, max_height=10):
    """Host-driven NUTS loop: returns (samples [p, n], info dict). Pass an
    explicit dt_range (``stepsize.initialize_stepsize`` searches for
    one)."""
    from .stepsize import HamiltonianBasedStepsizeAdapter

    if np.isscalar(dt_range):
        dt_range = np.array([dt_range, dt_range])
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
        q, info = generate_next_state(gen, f, dt, q, max_height=max_height)
        if i < n_burnin and adapt_stepsize:
            adapter.adapt_stepsize(float(info['ave_hamiltonian_error']))
        elif i == n_burnin - 1:
            use_averaged = True
        samples[:, i] = q.cpu().numpy()
        logp_samples[i] = float(info['logp'])
        accept_prob[i] = float(info['ave_accept_prob'])
    return samples, {
        'logp_samples': logp_samples,
        'accept_prob_samples': accept_prob,
        'sampling_time': time.time() - tic,
    }
