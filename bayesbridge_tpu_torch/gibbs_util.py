"""Sampler options and Markov-chain output management.

Host-side configuration and bookkeeping around the Gibbs loop
(reference: bayesbridge/gibbs_util.py:7-238). The reference pre-allocates
NumPy buffers and writes into them per iteration; here the loop collects
the thinned samples on the device, so the manager's job is
assembling/merging the output dicts, choosing which keys exist, and
printing progress.
"""

import time
from warnings import warn

import numpy as np


class SamplerOptions:

    def __init__(self, coef_sampler_type,
                 global_scale_update='sample',
                 hmc_curvature_est_stabilized=False,
                 cg_preconditioner='diag',
                 cg_atol_multiplier=1.0):
        """
        Parameters
        ----------
        coef_sampler_type : {'cholesky', 'cg', 'hmc', 'nuts'}
        global_scale_update : {'sample', 'optimize', None}
        hmc_curvature_est_stabilized : bool
        cg_preconditioner : {'diag', 'prior'}
            'prior' is the reference's choice (cg_sampler.py:123-138);
            'diag' (Jacobi on the full conditional-precision diagonal,
            cg_sampler.py:140-143) costs one weighted column-moment pass
            per draw but typically needs ~3x fewer CG iterations. Both
            target the identical distribution.
        cg_atol_multiplier : float
            Scales the CG stopping tolerance relative to the
            reference's rule atol = 1e-5 * sqrt(n_pred)
            (reg_coef_sampler.py:95-96). 1.0 (default) reproduces the
            reference budget; >1 trades per-draw solve accuracy for
            iterations (the draw remains a valid MCMC proposal — the
            solve error acts like extra preconditioner noise).
        """
        if coef_sampler_type not in ('cholesky', 'cg', 'hmc', 'nuts'):
            raise ValueError("Unsupported regression coefficient sampler.")
        if cg_preconditioner not in ('diag', 'prior'):
            raise ValueError("Unsupported CG preconditioner.")
        cg_atol_multiplier = float(cg_atol_multiplier)
        if not cg_atol_multiplier > 0:
            raise ValueError("cg_atol_multiplier must be > 0.")
        self.coef_sampler_type = coef_sampler_type
        self.gscale_update = global_scale_update
        self.curvature_est_stabilized = hmc_curvature_est_stabilized
        self.cg_preconditioner = cg_preconditioner
        self.cg_atol_multiplier = cg_atol_multiplier

    @classmethod
    def from_info(cls, info):
        """Rebuild options from a saved ``get_info()`` dict. Keys this
        version does not know (written by another version of the
        package) are dropped with a warning instead of raising."""
        known = {'coef_sampler_type', 'global_scale_update',
                 'hmc_curvature_est_stabilized', 'cg_preconditioner',
                 'cg_atol_multiplier'}
        unknown = sorted(set(info) - known)
        if unknown:
            warn("Ignoring unknown sampler option(s) {} from a saved "
                 "run.".format(unknown))
        return cls(**{k: v for k, v in info.items() if k in known})

    def get_info(self):
        return {
            'coef_sampler_type': self.coef_sampler_type,
            'global_scale_update': self.gscale_update,
            'hmc_curvature_est_stabilized': self.curvature_est_stabilized,
            'cg_preconditioner': self.cg_preconditioner,
            'cg_atol_multiplier': self.cg_atol_multiplier,
        }

    @staticmethod
    def pick_default_and_create(coef_sampler_type, options, model_name,
                                design):
        """Choose a sampler by model type and design size/sparsity
        (gibbs_util.py:32-84): dense -> Cholesky; sparse -> compare the
        O(frac^2 n p^2) Fisher-info build against ~100 CG matvecs of cost
        O(nnz); non-Gaussian-reducible families -> HMC."""
        if options is None:
            options = {}
        options = dict(options)

        if 'coef_sampler_type' in options:
            if coef_sampler_type is not None:
                warn("Duplicate specification of the coefficient sampler; "
                     "using the options dictionary entry.")
            coef_sampler_type = options['coef_sampler_type']

        if coef_sampler_type not in (None, 'cholesky', 'cg', 'hmc', 'nuts'):
            raise ValueError("Unsupported sampler type.")

        if model_name in ('linear', 'logit'):
            n_obs, n_pred = design.shape
            if not design.is_sparse:
                preferred = 'cholesky'
            else:
                frac = design.nnz / (n_obs * n_pred)
                fisher_info_cost = frac ** 2 * n_obs * n_pred ** 2
                cg_cost = design.nnz * 100.0
                preferred = 'cg' if cg_cost < fisher_info_cost \
                    else 'cholesky'
            if n_pred > n_obs:
                warn("Sampler has not been optimized for the 'small n' "
                     "problem.")
            if coef_sampler_type is None:
                coef_sampler_type = preferred
            elif coef_sampler_type not in ('hmc', 'nuts', preferred):
                warn("Specified sampler may not be optimal; consider the "
                     "'{:s}' option.".format(preferred))
        else:
            if coef_sampler_type not in ('hmc', 'nuts'):
                warn("Specified sampler type is not supported for the "
                     "{:s} model; using HMC instead.".format(model_name))
                coef_sampler_type = 'hmc'

        options['coef_sampler_type'] = coef_sampler_type
        return SamplerOptions(**options)


class MarkovChainManager:

    def __init__(self, n_obs, n_pred, n_unshrunk, model_name):
        self.n_obs = n_obs
        self.n_pred = n_pred
        self.n_unshrunk = n_unshrunk
        self.model_name = model_name
        self._prev_timestamp = None
        self._curr_timestamp = None

    # -- output keys ---------------------------------------------------- #

    def get_sampling_info_keys(self, sampling_method):
        """Per-iteration sampler diagnostics (gibbs_util.py:147-162)."""
        if sampling_method == 'cg':
            return ['n_cg_iter']
        if sampling_method in ('hmc', 'nuts'):
            keys = [
                'stepsize', 'n_hessian_matvec', 'n_grad_evals',
                'stability_limit_est', 'stability_adjustment_factor',
                'instability_detected',
            ]
            if sampling_method == 'hmc':
                keys += ['n_integrator_step', 'accepted', 'accept_prob']
            else:
                keys += ['tree_height', 'ave_accept_prob']
            return keys
        return []

    # -- assembling scan outputs ---------------------------------------- #

    def assemble_samples(self, scan_outputs, params_to_save):
        """Convert the scan's (n_sample, ...) stacked outputs into the
        reference layout: last axis indexes the MCMC iteration
        (gibbs_util.py:122-145)."""
        samples = {}
        for key in params_to_save:
            if key not in scan_outputs:
                continue
            arr = np.array(scan_outputs[key])  # writable host copy
            if arr.ndim > 1:
                arr = np.moveaxis(arr, 0, -1)
            samples[key] = arr
        return samples

    def assemble_sampling_info(self, scan_outputs, sampling_method):
        """The sampler diagnostics as float64 arrays: (n_kept,) for one
        chain, (n_chains, n_kept) for chains (multichain.py:107-112)."""
        info = {}
        for key in self.get_sampling_info_keys(sampling_method):
            if key in scan_outputs:
                info[key] = np.asarray(scan_outputs[key]).astype(np.float64)
        return info

    # -- merge / pack --------------------------------------------------- #

    def merge_outputs(self, prev_samples, prev_mcmc_info, new_samples,
                      new_mcmc_info):
        """Concatenate a resumed run onto its parent so the result looks
        like one uninterrupted run (gibbs_util.py:97-120)."""
        new_samples = {
            key: np.concatenate(
                (prev_samples[key], new_samples[key]), axis=-1)
            for key in new_samples
        }
        prev_info = prev_mcmc_info['_reg_coef_sampling_info']
        next_info = new_mcmc_info['_reg_coef_sampling_info']
        new_mcmc_info['_reg_coef_sampling_info'] = {
            key: np.concatenate((prev_info[key], next_info[key]), axis=-1)
            for key in prev_info
        }
        new_mcmc_info['n_iter'] += prev_mcmc_info['n_iter']
        new_mcmc_info['runtime'] += prev_mcmc_info['runtime']
        for key in ('_init_optim_info', 'seed'):
            new_mcmc_info[key] = prev_mcmc_info[key]
        return new_samples, new_mcmc_info

    def pack_parameters(self, coef, obs_prec, lscale, gscale):
        state = {
            'coef': np.asarray(coef),
            'local_scale': np.asarray(lscale),
            'global_scale': float(gscale),
        }
        if self.model_name in ('linear', 'logit'):
            state['obs_prec'] = np.asarray(obs_prec)
        return state

    # -- progress ------------------------------------------------------- #

    def stamp_time(self, curr_time):
        self._prev_timestamp = curr_time

    def print_status(self, mcmc_iter, n_iter, time_format='minute'):
        self._curr_timestamp = time.time()
        elapsed = self._curr_timestamp - self._prev_timestamp
        if time_format == 'second':
            time_str = "{:.3g} seconds".format(elapsed)
        elif time_format == 'minute':
            time_str = "{:.3g} minutes".format(elapsed / 60)
        else:
            raise ValueError()
        print("{:d} Gibbs iterations complete: {:s} elapsed since the "
              "last update.".format(mcmc_iter, time_str))
        self._prev_timestamp = self._curr_timestamp
