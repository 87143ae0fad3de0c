"""Stepsize adaptation for HMC and NUTS.

Port of ``bayesbridge_tpu/ops/stepsize.py`` (reference:
bayesbridge/reg_coef_sampler/hamiltonian_monte_carlo/stepsize_adapter.py:
6-326):

* :func:`hamiltonian_adapter_init` / :func:`hamiltonian_adapter_update`
  — the Gibbs step's adapter, a dict of tensors in the chain carry (one
  entry per chain with a leading chain axis): Robbins-Monro adaptation
  of the log stepsize multiplier toward a Hamiltonian-error magnitude
  matched to the target acceptance rate (under the high-dimensional
  limit the error is N(-delta/2, delta) with acceptance
  2 Phi(-sqrt(delta)/2); stepsize_adapter.py:39-56);
* :class:`HamiltonianBasedStepsizeAdapter`,
  :class:`RobbinsMonroStepsizeAdapter`, :class:`DualAverageStepsizeAdapter`
  and :func:`initialize_stepsize` — host-side adapters for the
  standalone HMC and NUTS drivers (API parity with the reference).
"""

import math

import torch
from scipy.stats import norm


def target_log10_hamiltonian_error(target_accept_prob):
    """stepsize_adapter.py:39-56."""
    if not 0 < target_accept_prob < 1:
        raise ValueError("Target probability must be within (0, 1).")
    delta = 4 * norm.ppf(target_accept_prob / 2) ** 2
    return 0.5 * math.log10(delta + delta ** 2 / 4)


def robbins_monro_stepsize(n_iter, init=1.0, decay_exponent=1.0,
                           reference_iteration=500,
                           adaptsize_at_reference=.05):
    """Decaying adaptation-size sequence that reaches
    `adaptsize_at_reference` after `reference_iteration` steps
    (stepsize_adapter.py:148-183); `n_iter` a number or a tensor."""
    decay_scale = reference_iteration / (
        (init / adaptsize_at_reference) ** (1 / decay_exponent) - 1)
    return init / (1 + n_iter / decay_scale) ** decay_exponent


def hamiltonian_adapter_init(dtype, device, init_stepsize=.3,
                             target_accept_prob=.95, n_chains=None):
    """(state, params) of the Gibbs step's adapter
    (reg_coef_sampler.py:38-39 uses init_stepsize=.3, target=.95); the
    state's entries have a leading axis of `n_chains` unless None."""
    shape = () if n_chains is None else (n_chains,)
    log_init = math.log(init_stepsize)
    state = {
        'log_stepsize': torch.full(shape, log_init, dtype=dtype,
                                   device=device),
        'log_stepsize_averaged': torch.full(shape, log_init, dtype=dtype,
                                            device=device),
        'n_averaged': torch.zeros(shape, dtype=torch.int32, device=device),
    }
    params = {'target_log10_error': target_log10_hamiltonian_error(
        target_accept_prob)}
    return state, params


def _piecewise_adaptsize(log10_error, target, upper_bound=1.0):
    """The 'piecewise' transform (stepsize_adapter.py:104-119): shrink
    fast (log2 scale) when the error exceeds the target, grow slowly
    (log1000 scale) otherwise."""
    diff = target - log10_error
    adapt = torch.where(diff < 0, diff / .301, diff / 3.0)
    return torch.clamp(adapt, -upper_bound, upper_bound)


def hamiltonian_adapter_update(state, params, hamiltonian_error):
    """One Robbins-Monro update from the observed Hamiltonian error
    (stepsize_adapter.py:70-83), per chain."""
    dtype = state['log_stepsize'].dtype
    n = state['n_averaged']
    rm_stepsize = robbins_monro_stepsize(n.to(dtype))
    error = hamiltonian_error.to(dtype)
    log10_error = torch.where(error == 0.0,
                              torch.full_like(error, -math.inf),
                              torch.log10(error.abs()))
    adaptsize = _piecewise_adaptsize(log10_error,
                                     params['target_log10_error'])
    log_stepsize = state['log_stepsize'] + rm_stepsize * adaptsize
    n_new = n + 1
    weight = 1.0 / n_new.to(dtype)
    log_avg = weight * log_stepsize \
        + (1 - weight) * state['log_stepsize_averaged']
    return {'log_stepsize': log_stepsize, 'log_stepsize_averaged': log_avg,
            'n_averaged': n_new}


def adapter_stepsize(state, averaged=False):
    return torch.exp(state['log_stepsize_averaged'] if averaged
                     else state['log_stepsize'])


# -- host-side adapters for the standalone drivers ------------------------ #

class HamiltonianBasedStepsizeAdapter:
    """Host-side object over the functional adapter (API parity with
    stepsize_adapter.py:6-120)."""

    def __init__(self, init_stepsize, target_accept_prob=.9,
                 init_adaptsize=1., adapt_decay_exponent=1.,
                 reference_iteration=500, adaptsize_at_reference=.05):
        if init_stepsize <= 0:
            raise ValueError("The initial stepsize must be positive.")
        self._rm_kwargs = dict(
            init=init_adaptsize, decay_exponent=adapt_decay_exponent,
            reference_iteration=reference_iteration,
            adaptsize_at_reference=adaptsize_at_reference)
        self.target_log10_error = target_log10_hamiltonian_error(
            target_accept_prob)
        self.log_stepsize = math.log(init_stepsize)
        self.log_stepsize_averaged = self.log_stepsize
        self.n_averaged = 0

    def get_current_stepsize(self, averaged=False):
        return math.exp(self.log_stepsize_averaged if averaged
                        else self.log_stepsize)

    def reinitialize(self, init_stepsize):
        self.log_stepsize = math.log(init_stepsize)
        self.log_stepsize_averaged = self.log_stepsize
        self.n_averaged = 0

    def adapt_stepsize(self, hamiltonian_error):
        rm = robbins_monro_stepsize(self.n_averaged, **self._rm_kwargs)
        self.n_averaged += 1
        log10_error = -math.inf if hamiltonian_error == 0 \
            else math.log10(abs(hamiltonian_error))
        adapt = float(_piecewise_adaptsize(
            torch.tensor(log10_error, dtype=torch.float64),
            self.target_log10_error))
        self.log_stepsize += rm * adapt
        weight = 1 / self.n_averaged
        self.log_stepsize_averaged = (
            weight * self.log_stepsize
            + (1 - weight) * self.log_stepsize_averaged)
        return math.exp(self.log_stepsize)

    def get_state(self):
        return {
            'log_stepsize': self.log_stepsize,
            'log_stepsize_averaged': self.log_stepsize_averaged,
            'n_averaged': self.n_averaged,
        }

    def set_state(self, state):
        self.log_stepsize = float(state['log_stepsize'])
        self.log_stepsize_averaged = float(state['log_stepsize_averaged'])
        self.n_averaged = int(state['n_averaged'])


class RobbinsMonroStepsizeAdapter:
    """Accept-rate targeting Robbins-Monro adapter
    (stepsize_adapter.py:186-272)."""

    def __init__(self, init_stepsize, target_accept_prob=.9,
                 init_adaptsize=1., adapt_decay_exponent=1.,
                 reference_iteration=100, adaptsize_at_reference=.05):
        if init_stepsize <= 0:
            raise ValueError("The initial stepsize must be positive.")
        self._rm_kwargs = dict(
            init=init_adaptsize, decay_exponent=adapt_decay_exponent,
            reference_iteration=reference_iteration,
            adaptsize_at_reference=adaptsize_at_reference)
        self.target_accept_prob = target_accept_prob
        self.log_stepsize = math.log(init_stepsize)
        self.log_stepsize_averaged = self.log_stepsize
        self.n_averaged = 0

    def get_current_stepsize(self, averaged=False):
        return math.exp(self.log_stepsize_averaged if averaged
                        else self.log_stepsize)

    def adapt_stepsize(self, accept_prob, trans_type='linear'):
        rm = robbins_monro_stepsize(self.n_averaged, **self._rm_kwargs)
        self.n_averaged += 1
        adapt = self.transform_to_adaptsize(
            accept_prob, self.target_accept_prob, trans_type)
        self.log_stepsize += rm * adapt
        weight = 1 / self.n_averaged
        self.log_stepsize_averaged = (
            weight * self.log_stepsize
            + (1 - weight) * self.log_stepsize_averaged)
        return math.exp(self.log_stepsize)

    @staticmethod
    def transform_to_adaptsize(accept_prob, target, trans_type='linear'):
        if trans_type == 'linear':
            return accept_prob - target
        if trans_type == 'sign':
            return math.copysign(1., accept_prob - target)
        if trans_type == 'penalize-high-prob':
            # Roughly interpolates (0,-1), (target,0), (1,1): linear near
            # the target, saturating quickly as 1 - accept_prob becomes an
            # order of magnitude smaller than 1 - target
            # (stepsize_adapter.py:240-266).
            if accept_prob <= target:
                return (accept_prob - target) / target
            eps = 2.0 ** -52
            magnitude_diff = math.log10(
                (1. - (accept_prob - eps)) / (1 - target))
            w = 0. if magnitude_diff == 0 else math.exp(1 / magnitude_diff)
            adapt = ((1 - w) * (accept_prob - target) / target
                     - w * magnitude_diff)
            return min(1., adapt)
        raise NotImplementedError(trans_type)


class DualAverageStepsizeAdapter:
    """Nesterov dual averaging (stepsize_adapter.py:275-326)."""

    def __init__(self, init_stepsize, target_accept_prob=.9):
        if init_stepsize <= 0:
            raise ValueError("The initial stepsize must be positive.")
        self.log_stepsize = math.log(init_stepsize)
        self.log_stepsize_averaged = self.log_stepsize
        self.n_averaged = 0
        self.target_accept_prob = target_accept_prob
        self.latent_stat = 0.
        self.stepsize_averaging_log_decay_rate = 0.75
        self.latent_prior_samplesize = 10
        self.log_stepsize_shrinkage_mean = math.log(2.) + self.log_stepsize
        self.log_stepsize_shrinkage_strength = 0.05

    def get_current_stepsize(self, averaged=False):
        return math.exp(self.log_stepsize_averaged if averaged
                        else self.log_stepsize)

    def adapt_stepsize(self, accept_prob):
        self.n_averaged += 1
        weight = 1 / (self.n_averaged + self.latent_prior_samplesize)
        self.latent_stat = (1 - weight) * self.latent_stat \
            + weight * (self.target_accept_prob - accept_prob)
        self.log_stepsize = (
            self.log_stepsize_shrinkage_mean
            - math.sqrt(self.n_averaged)
            / self.log_stepsize_shrinkage_strength * self.latent_stat)
        avg_weight = self.n_averaged \
            ** -self.stepsize_averaging_log_decay_rate
        self.log_stepsize_averaged = (
            (1 - avg_weight) * self.log_stepsize_averaged
            + avg_weight * self.log_stepsize)
        return math.exp(self.log_stepsize)


def initialize_stepsize(compute_acceptprob, dt=1.0):
    """Doubling/halving search for a stepsize with about 50% one-step
    acceptance (stepsize_adapter.py:123-145). Host-side."""
    accept_prob = compute_acceptprob(dt)
    direction = 1 if accept_prob > 0.5 else -1
    while accept_prob == 0 or (2 * accept_prob) ** direction > 1:
        dt = dt * 2 ** direction
        accept_prob = compute_acceptprob(dt)
        if accept_prob == 0 and direction == 1:
            dt /= 2  # the last doubling overshot
            break
    return dt
