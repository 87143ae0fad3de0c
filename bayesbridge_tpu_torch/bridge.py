"""BayesBridge: the Gibbs sampler orchestrator.

Port of ``bayesbridge_tpu/bridge.py``: the linear, logit and Cox models,
the Cholesky, CG, HMC and NUTS samplers, float32 or float64,
API-compatible with the reference sampler (reference:
bayesbridge/bayesbridge.py:13-511): ``gibbs()`` returns (samples,
mcmc_info) with samples' last axis indexing iterations, and
``gibbs_resume()`` restores the full sampler state (chain state,
generator state, summarizer, and the HMC stepsize adapter and stabilizer
ring) to continue, so that a resumed and merged run equals an
uninterrupted one exactly.
"""

import copy
import time
from warnings import warn

import numpy as np
import torch

from .gibbs_util import MarkovChainManager, SamplerOptions
from .models.logistic import LogisticModel
from .prior import RegressionCoefPrior
from .random.basic import BasicRandom
from .ops import reg_coef as reg_coef_ops
from .utils.dtypes import working_dtype
from . import step as step_mod

_SAVABLE_PARAMS = step_mod.SAMPLE_KEYS


def resolve_params_to_save(model_name, params_to_save):
    """Expand 'all' (no obs_prec for Cox) and validate parameter names."""
    if params_to_save == 'all':
        params_to_save = ('coef', 'local_scale', 'global_scale', 'logp')
        if model_name != 'cox':
            params_to_save += ('obs_prec',)
    unknown = [key for key in params_to_save
               if key not in _SAVABLE_PARAMS]
    if unknown:
        raise ValueError(
            "Unknown parameter name(s) {} in params_to_save.".format(
                unknown))
    return tuple(params_to_save)


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


class BayesBridge:
    """Gibbs sampler for Bayesian bridge sparse regression."""

    def __init__(self, model, prior=None, dtype=None):
        """
        Parameters
        ----------
        model : a RegressionModel (LinearModel / LogisticModel / CoxModel)
        prior : RegressionCoefPrior
        dtype : the chain state's float dtype, float32 or float64;
            defaults to the model's working dtype (the JAX package
            defaults to its session's float)
        """
        if prior is None:
            prior = RegressionCoefPrior()
        self.model = model
        self.prior = prior
        self.device = model.design.device
        self.n_obs = model.n_obs
        self.n_pred = model.n_pred
        self.n_unshrunk = prior.n_fixed
        self.prior_sd_for_unshrunk = np.array(prior.sd_for_fixed,
                                              dtype=np.float64)
        if model.intercept_added:
            self.n_unshrunk += 1
            self.prior_sd_for_unshrunk = np.concatenate((
                [prior.sd_for_intercept], self.prior_sd_for_unshrunk))
        self.dtype = model.design.dtype if dtype is None \
            else working_dtype(dtype)
        self.rg = BasicRandom(self.device, dtype=self.dtype)
        self.manager = MarkovChainManager(
            self.n_obs, self.n_pred, self.n_unshrunk, model.name)
        self._sampler_state = None  # summarizer (+ HMC adapter) state

    # ------------------------------------------------------------------ #
    # Public API                                                         #
    # ------------------------------------------------------------------ #

    def gibbs(self, n_iter, n_burnin=0, thin=1, seed=None,
              init=None, params_to_save=('coef', 'global_scale', 'logp'),
              coef_sampler_type=None, n_status_update=0,
              options=None, _add_iter_mode=False, _init_is_raw=False):
        """Generate posterior samples (bayesbridge.py:109-277): `n_iter`
        iterations, the first `n_burnin` discarded and every `thin`-th of
        the rest kept; `samples[...][:, k]` is the k-th kept draw."""
        options = self._resolve_options(coef_sampler_type, options)
        if init is None:
            init = {'global_scale': 0.1}
        if not _add_iter_mode:
            self.rg.set_seed(seed)
            self._sampler_state = None
        params_to_save = resolve_params_to_save(self.model.name,
                                                params_to_save)
        start_time = time.time()
        self.manager.stamp_time(start_time)
        cfg = self._step_config(options)

        coef, obs_prec, lscale, gscale, init, initial_optim_info = \
            self.initialize_chain(init, self.prior.bridge_exp,
                                  _init_is_raw=_init_is_raw)
        carry = step_mod.init_carry(self.device, coef, obs_prec, gscale,
                                    lscale, dtype=self.dtype, cfg=cfg)
        if _add_iter_mode and self._sampler_state is not None:
            carry = self._restore_sampler_state(carry, self._sampler_state)

        n_sample = (n_iter - n_burnin) // thin
        n_remainder = (n_iter - n_burnin) - n_sample * thin
        status = None
        if n_status_update > 0:
            status = (self.manager.print_status,
                      max(1, n_iter // min(n_iter, n_status_update)))
        carry, outputs = step_mod.run_chain(
            cfg, self.model, self.rg.gen, carry, n_burnin, n_sample, thin,
            n_remainder, save_keys=params_to_save, status=status)
        outputs = {k: np.stack([v.cpu().numpy() if torch.is_tensor(v)
                                else np.asarray(v) for v in vals])
                   for k, vals in outputs.items()}
        carry_host = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                      for k, v in carry.items()
                      if k not in ('summ', 'hmc_adapter')}
        runtime = time.time() - start_time

        self._sampler_state = self._extract_sampler_state(carry)
        self._warn_guard_rails(carry_host)
        samples = self.manager.assemble_samples(outputs, params_to_save)
        sampling_info = self.manager.assemble_sampling_info(
            outputs, options.coef_sampler_type)

        gscale_final = float(carry_host['gscale'])
        lscale_final = np.array(carry_host['lscale'], dtype=np.float64)
        if self.prior._gscale_paramet == 'coef_magnitude':
            gscale_final, lscale_final = self.prior.adjust_scale(
                gscale_final, lscale_final, to='coef_magnitude')
            self.prior.adjust_scale(
                samples.get('global_scale', np.zeros(0)),
                samples.get('local_scale', np.zeros(0)),
                to='coef_magnitude')
        _markov_chain_state = self.manager.pack_parameters(
            carry_host['coef'], carry_host['obs_prec'], lscale_final,
            gscale_final)
        # Raw-parametrization copy: resume skips the lossy
        # coef_magnitude <-> raw round trip (bridge.py:200-207).
        _markov_chain_state_raw = self.manager.pack_parameters(
            carry_host['coef'], carry_host['obs_prec'],
            np.array(carry_host['lscale'], dtype=np.float64),
            float(carry_host['gscale']))
        mcmc_info = {
            'init': init,
            'n_iter': n_iter,
            'n_burnin': n_burnin,
            'thin': thin,
            'seed': seed,
            'n_coef_wo_shrinkage': self.n_unshrunk,
            'prior_sd_for_unshrunk': self.prior_sd_for_unshrunk,
            'bridge_exponent': self.prior.bridge_exp,
            'coef_sampler_type': options.coef_sampler_type,
            'saved_params': params_to_save,
            'runtime': runtime,
            'options': options.get_info(),
            '_init_optim_info': initial_optim_info,
            '_reg_coef_sampling_info': sampling_info,
            '_markov_chain_state': _markov_chain_state,
            '_markov_chain_state_raw': _markov_chain_state_raw,
            '_random_gen_state': self.rg.get_state(),
            '_reg_coef_sampler_state': _to_numpy(self._sampler_state),
        }
        return samples, mcmc_info

    def gibbs_resume(self, prev_mcmc_info, n_add_iter, n_status_update=0,
                     merge=False, prev_samples=None):
        """Continue a previous run from its exact final state
        (bayesbridge.py:43-107)."""
        if merge and prev_samples is None:
            raise ValueError(
                "To merge the outputs from previous and new MCMC runs, "
                "supply the optional argument `prev_samples`.")
        self.rg.set_state(prev_mcmc_info['_random_gen_state'])
        self._sampler_state = self._to_device(
            prev_mcmc_info['_reg_coef_sampler_state'])
        raw_state = prev_mcmc_info.get('_markov_chain_state_raw')
        init = dict(raw_state if raw_state is not None
                    else prev_mcmc_info['_markov_chain_state'])
        # Unknown option keys (another version's) are dropped with a
        # warning rather than raising (bridge.py:250 raises).
        options = SamplerOptions.from_info(prev_mcmc_info['options'])
        new_samples, new_mcmc_info = self.gibbs(
            n_add_iter, 0, prev_mcmc_info['thin'], init=init,
            params_to_save=prev_mcmc_info['saved_params'],
            n_status_update=n_status_update, options=options,
            _add_iter_mode=True, _init_is_raw=raw_state is not None)
        if merge:
            new_samples, new_mcmc_info = self.manager.merge_outputs(
                prev_samples, prev_mcmc_info, new_samples, new_mcmc_info)
        return new_samples, new_mcmc_info

    def _resolve_options(self, coef_sampler_type, options):
        """SamplerOptions from a sampler name and an options dict (or
        passed through)."""
        if not isinstance(options, SamplerOptions):
            options = SamplerOptions.pick_default_and_create(
                coef_sampler_type, options, self.model.name,
                self.model.design)
        return options

    # The sampler state carried across gibbs_resume besides the chain's
    # parameters (bridge.py:541-553): the summarizer, and for HMC and
    # NUTS the stepsize adapter and the stabilizer's ring buffer.
    _SAMPLER_STATE_KEYS = ('hmc_adapter', 'stab_buffer', 'stab_n')

    def _extract_sampler_state(self, carry):
        state = {'summ': carry['summ']}
        for key in self._SAMPLER_STATE_KEYS:
            if key in carry:
                state[key] = carry[key]
        return state

    def _restore_sampler_state(self, carry, state):
        carry = {**carry, 'summ': state['summ']}
        for key in self._SAMPLER_STATE_KEYS:
            if key in state and key in carry:
                carry[key] = state[key]
        return carry

    def _to_device(self, tree):
        return {k: self._to_device(v) if isinstance(v, dict)
                else torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in tree.items()}

    def _step_config(self, options):
        return step_mod.GibbsStepConfig(
            self.model, self.prior, options, self.n_unshrunk,
            self.prior_sd_for_unshrunk, dtype=self.dtype)

    # ------------------------------------------------------------------ #
    # Initialization (host-side, one-time; bayesbridge.py:279-370)       #
    # ------------------------------------------------------------------ #

    def initialize_chain(self, init, bridge_exp, _init_is_raw=False):
        """Resolve an init dict into a full starting state
        (bayesbridge.py:279-353), running the conditional MAP search
        when no coefficients are given."""
        valid_names = ('coef', 'local_scale', 'global_scale', 'obs_prec',
                       'logp')
        for key in init:
            if key not in valid_names:
                warn("'{:s}' is not a valid parameter name and will be "
                     "ignored.".format(key))
        coef_only_specified = 'coef' in init \
            and ('global_scale' not in init)
        if 'coef' in init:
            coef = np.array(init['coef'], dtype=np.float64)
            if len(coef) != self.n_pred:
                raise ValueError(
                    'Invalid initial length of regression coefficient.')
        else:
            coef = np.zeros(self.n_pred)
            if self.model.name in ('linear', 'logit'):
                coef[0] = self.model.calc_intercept_mle()
        obs_prec = self._initialize_obs_precision(init, coef)

        if coef_only_specified:
            gscale = self.update_global_scale(
                None, coef[self.n_unshrunk:], bridge_exp, method='optimize')
            lscale = self._draw_local_scale(
                gscale, coef[self.n_unshrunk:], bridge_exp)
        else:
            if 'global_scale' not in init:
                raise ValueError(
                    "Initial global scale must be specified when "
                    "coefficients aren't specified.")
            if self.prior._gscale_paramet == 'raw' and not _init_is_raw:
                warn("Using the raw global scale parametrization; make "
                     "sure the specified initial value is scaled "
                     "accordingly.")
            gscale = float(init['global_scale'])
            if 'local_scale' in init:
                lscale = np.array(init['local_scale'], dtype=np.float64)
                if len(lscale) != self.n_pred - self.n_unshrunk:
                    raise ValueError(
                        'Invalid initial length of local scale parameter')
            else:
                lscale = np.ones(self.n_pred - self.n_unshrunk)

        if self.prior._gscale_paramet == 'coef_magnitude' \
                and not _init_is_raw:
            gscale, lscale = self.prior.adjust_scale(
                gscale, lscale, to='raw')

        if 'coef' not in init:
            coef, info = reg_coef_ops.search_mode(
                coef, lscale, gscale, obs_prec, self.model,
                self.prior_sd_for_unshrunk, self.prior.slab_size)
            obs_prec = self._draw_obs_precision(coef)
            lscale = self._draw_local_scale(
                gscale, coef[self.n_unshrunk:], bridge_exp)
            optim_info = {key: info[key] for key in
                          ['is_success', 'n_design_matvec', 'n_iter']}
        else:
            optim_info = None
        init = {
            'coef': np.asarray(coef),
            'obs_prec': None if obs_prec is None else np.asarray(obs_prec),
            'local_scale': np.asarray(lscale),
            'global_scale': gscale,
        }
        return coef, obs_prec, lscale, gscale, init, optim_info

    def _initialize_obs_precision(self, init, coef):
        """bayesbridge.py:355-370: the linear model's inverse mean squared
        residual, the logit model's Polya-Gamma means, none for Cox."""
        if self.model.name == 'cox':
            return None
        if 'obs_prec' in init and init['obs_prec'] is not None:
            obs_prec = np.asarray(init['obs_prec'], dtype=np.float64)
            if self.model.name == 'logit' and len(obs_prec) != self.n_obs:
                raise ValueError('An invalid initial state.')
            return obs_prec
        lin_pred = self.model.design.dot(coef)
        if self.model.name == 'linear':
            resid = (self.model.y - lin_pred).double().cpu().numpy()
            return np.mean(resid ** 2) ** -1
        return LogisticModel.compute_polya_gamma_mean(
            self.model.n_trial, lin_pred).double().cpu().numpy()

    def _draw_obs_precision(self, coef):
        """Eager one-time draw at initialization (bayesbridge.py:397-410),
        from the chain's generator; none for Cox."""
        if self.model.name == 'cox':
            return None
        lin_pred = self.model.design.dot(coef)
        if self.model.name == 'linear':
            resid = (self.model.y - lin_pred).double().cpu().numpy()
            return float(self.rg.gamma(self.n_obs / 2)) \
                / (np.sum(resid ** 2) / 2)
        return self.rg.polya_gamma(self.model.pg_shape, lin_pred)

    def _draw_local_scale(self, gscale, coef_shrunk, bridge_exp):
        """Eager one-time local-scale draw (bayesbridge.py:458-478)."""
        if bridge_exp == 2:
            return 0.5 * np.ones(coef_shrunk.size)
        ts = self.rg.tilted_stable(bridge_exp / 2,
                                   (coef_shrunk / gscale) ** 2)
        lscale = np.sqrt(0.5 / ts.astype(np.float64))
        lscale[lscale == 0] = 1e-15
        lscale[np.isinf(lscale)] = 2.0 / gscale
        return lscale

    # ------------------------------------------------------------------ #
    # Public component updates (bridge.py:400-524; reference:            #
    # bayesbridge.py:355-511): the building blocks of custom samplers.   #
    # Each draws from the bridge's generator and takes and returns host  #
    # values; the Gibbs step runs the same updates on the device.        #
    # ------------------------------------------------------------------ #

    def initialize_obs_precision(self, init, coef):
        """Observation precision from an init dict, or its model-specific
        moment-matched default (bayesbridge.py:355-370)."""
        return self._initialize_obs_precision(
            dict(init), np.asarray(coef, dtype=np.float64))

    def update_regress_coef(self, coef, obs_prec, gscale, lscale,
                            sampling_method):
        """One conditional draw of coef | obs_prec, gscale, lscale
        (bayesbridge.py:372-395) by 'cholesky', 'cg', 'hmc' or 'nuts',
        from a fresh one-chain carry (its summarizer and, for HMC, its
        stepsize adapter at their starts). Returns ``(coef, info)``."""
        cfg = self._step_config(SamplerOptions(sampling_method))
        carry = step_mod.init_carry(self.device, coef, obs_prec, gscale,
                                    lscale, dtype=self.dtype, cfg=cfg)
        new_coef, _, info = step_mod.update_regress_coef_chains(
            cfg, self.model, [self.rg.gen], step_mod.stack_carries([carry]))
        return new_coef[0].cpu().numpy(), {
            key: val[0].cpu().numpy() if torch.is_tensor(val)
            else np.asarray(val)[0] for key, val in info.items()}

    def update_obs_precision(self, coef):
        """One conditional draw of the observation precision | coef
        (bayesbridge.py:397-410): the linear model's Gamma draw of the
        precision, the logit model's Polya-Gamma latent precisions, None
        for Cox."""
        if self.model.name not in ('linear', 'logit'):
            return None
        return self._draw_obs_precision(np.asarray(coef, np.float64))

    def update_global_scale(self, gscale, coef_under_shrinkage, bridge_exp,
                            coef_expected_magnitude_lower_bd=.001,
                            method='sample'):
        """Global-scale update | coef (bayesbridge.py:412-448): the
        conjugate Gamma draw on phi = gscale^(-bridge_exp) ('sample'),
        the MC-EM maximizer ('optimize') or none (None), with the
        lower-bound guard."""
        coef_under_shrinkage = np.asarray(coef_under_shrinkage, np.float64)
        if coef_under_shrinkage.size == 0:
            return 1.0  # placeholder, as in the reference
        lower_bd = coef_expected_magnitude_lower_bd \
            / self.prior.compute_power_exp_ave_magnitude(bridge_exp)
        if method == 'optimize':
            gscale = self.monte_carlo_em_global_scale(
                coef_under_shrinkage, bridge_exp)
        elif method == 'sample':
            if np.count_nonzero(coef_under_shrinkage) == 0:
                gscale = 0.0
            else:
                prior_param = self.prior.param['gscale_neg_power']
                shape = prior_param['shape'] \
                    + coef_under_shrinkage.size / bridge_exp
                rate = prior_param['rate'] \
                    + np.sum(np.abs(coef_under_shrinkage) ** bridge_exp)
                phi = float(self.rg.gamma(shape)) / rate
                gscale = phi ** -(1 / bridge_exp)
        elif method is not None:
            raise ValueError(method)
        if method is not None and gscale < lower_bd:
            warn("The global shrinkage parameter update returned an "
                 "unreasonably small value. Returning a specified lower "
                 "bound value instead.")
            gscale = lower_bd
        return gscale

    def monte_carlo_em_global_scale(self, coef_under_shrinkage,
                                    bridge_exp):
        """The maximizer of the likelihood of coef | gscale
        (bayesbridge.py:450-456)."""
        coef_under_shrinkage = np.asarray(coef_under_shrinkage)
        phi = len(coef_under_shrinkage) / bridge_exp \
            / np.sum(np.abs(coef_under_shrinkage) ** bridge_exp)
        return phi ** -(1 / bridge_exp)

    def update_local_scale(self, gscale, coef_under_shrinkage, bridge_exp):
        """Local-scale draw | gscale, coef by exponentially tilted stable
        variables (bayesbridge.py:458-478), warning where it replaces an
        under- or overflow (the first of the two that occurs, as the
        JAX package does)."""
        coef_under_shrinkage = np.asarray(coef_under_shrinkage, np.float64)
        if bridge_exp == 2:
            return .5 * np.ones(coef_under_shrinkage.size)
        ts = self.rg.tilted_stable(bridge_exp / 2,
                                   (coef_under_shrinkage / gscale) ** 2)
        lscale = np.sqrt(0.5 / ts.astype(np.float64))
        if np.any(lscale == 0):
            warn("Local scale parameter under-flowed. Replacing with a "
                 "small number.")
            lscale[lscale == 0] = 1e-15
        elif np.any(np.isinf(lscale)):
            warn("Local scale parameter over-flowed. Replacing with a "
                 "large number.")
            lscale[np.isinf(lscale)] = 2.0 / gscale
        return lscale

    def compute_posterior_logprob(self, coef, gscale, obs_prec, bridge_exp):
        """Joint log density of (coef, gscale | rest)
        (bayesbridge.py:480-511), in the chain's dtype."""
        cfg = self._step_config(SamplerOptions(
            'cg' if self.model.name != 'cox' else 'hmc'))
        if bridge_exp != cfg.bridge_exp:
            cfg = copy.copy(cfg)
            cfg.bridge_exp = float(bridge_exp)

        def one(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   dtype=self.dtype, device=self.device)[None]

        coef = one(coef)
        lin_pred = None if self.model.name == 'cox' \
            else self.model.design.dot(coef)
        obs_prec = None if obs_prec is None else one(obs_prec)
        return float(step_mod.compute_posterior_logprob(
            cfg, self.model, coef, one(gscale), obs_prec, lin_pred)[0])

    def _warn_guard_rails(self, carry):
        """Surface the step's numerical guard-rail counters as warnings
        (the reference warns inline: bayesbridge.py:441-446, 469-477)."""
        n_clamped = int(carry['n_gscale_clamped'])
        if n_clamped:
            warn("The global shrinkage parameter update returned an "
                 "unreasonably small value in {:d} iteration(s); the "
                 "specified lower bound was used instead.".format(n_clamped))
        n_under = int(carry['n_lscale_underflow'])
        if n_under:
            warn("Local scale parameter under-flowed {:d} time(s). "
                 "Replaced with a small number.".format(n_under))
        n_over = int(carry['n_lscale_overflow'])
        if n_over:
            warn("Local scale parameter over-flowed {:d} time(s). "
                 "Replaced with a large number.".format(n_over))
        if int(carry['n_cg_unconverged']):
            warn("The conjugate gradient algorithm did not achieve the "
                 "requested tolerance in {:d} iteration(s). You may "
                 "increase the maxiter or use the dense linear algebra "
                 "instead.".format(int(carry['n_cg_unconverged'])))
        n_invalid = int(carry.get('n_curvature_invalid', 0))
        if n_invalid:
            warn("The preconditioned-Hessian curvature estimate was "
                 "non-positive in {:d} iteration(s) (the reference "
                 "raises here); it was clamped, but the chain may have "
                 "diverged — check the posterior for separability or "
                 "a too-flat prior.".format(n_invalid))
