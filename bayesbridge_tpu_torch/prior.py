"""Prior specification for the bridge-regression coefficients.

Re-implements the behavior of the reference ``RegressionCoefPrior``
(reference: bayesbridge/prior.py:7-217): the bridge prior
``pi(beta_j | tau) \\propto tau^{-1} exp(-|beta_j / tau|^alpha)`` with
optional Gaussian "slab" regularization, flat/Gaussian priors on the
intercept and fixed effects, and a Gamma prior on
``phi = gscale^{-alpha}`` whose hyper-parameters can be solved from a
log10-mean/sd specification of the global scale.

This module is pure host-side configuration math (no torch): it runs once per
sampler setup, so NumPy/SciPy are the right tools. All hot-path work
consumes the plain floats/arrays produced here.
"""

import math
from warnings import warn

import numpy as np
from scipy.optimize import brentq
from scipy.special import polygamma as _scipy_polygamma


def _polygamma(n, x):
    return float(_scipy_polygamma([n], x)[0])


class RegressionCoefPrior:

    def __init__(
            self,
            bridge_exponent=.5,
            n_fixed_effect=0,
            sd_for_intercept=float('inf'),
            sd_for_fixed_effect=float('inf'),
            regularizing_slab_size=float('inf'),
            global_scale_prior_hyper_param=None,
            _global_scale_parametrization='coef_magnitude',
    ):
        """Encapsulate prior information for BayesBridge.

        Parameters
        ----------
        bridge_exponent : float < 2
            Exponent ``alpha`` of the bridge prior. 1 gives the Bayesian
            Lasso; values below 1 give heavier shrinkage toward zero.
        n_fixed_effect : int
            Number of predictors (placed right after the intercept column)
            whose coefficients get Gaussian priors of fixed sd instead of
            the bridge shrinkage.
        sd_for_intercept : float
            Gaussian prior sd on the intercept; ``inf`` = flat prior.
        sd_for_fixed_effect : float or 1-d array of length n_fixed_effect
            Gaussian prior sd(s) on the fixed effects; ``inf`` = flat.
        regularizing_slab_size : float
            Sd of the Gaussian tail regularizer applied on top of the
            bridge prior (guards against e.g. complete separation).
        global_scale_prior_hyper_param : dict or None
            ``{'log10_mean': m, 'log10_sd': s}`` for log10(global scale);
            None uses the reference prior for a scale family.
        _global_scale_parametrization : {'raw', 'coef_magnitude'}
            Under 'coef_magnitude' the reported global scale equals the
            prior expected magnitude of the coefficients.
        """
        if not (np.isscalar(sd_for_fixed_effect)
                or n_fixed_effect == len(sd_for_fixed_effect)):
            raise ValueError(
                "Prior sd for fixed effects must be a scalar or an array of "
                "length n_fixed_effect."
            )
        if bridge_exponent > 2:
            raise ValueError("Exponent larger than 2 is unsupported.")
        if _global_scale_parametrization not in ('raw', 'coef_magnitude'):
            raise ValueError("Unrecognized global scale parametrization.")

        if np.isscalar(sd_for_fixed_effect):
            sd_for_fixed_effect = sd_for_fixed_effect * np.ones(n_fixed_effect)
        self.sd_for_intercept = sd_for_intercept
        self.sd_for_fixed = np.asarray(sd_for_fixed_effect, dtype=np.float64)
        self.slab_size = regularizing_slab_size
        self.n_fixed = n_fixed_effect
        self.bridge_exp = bridge_exponent
        self._gscale_paramet = _global_scale_parametrization

        if global_scale_prior_hyper_param is None:
            # Reference (improper) prior for a scale family:
            # p(gscale) ~ 1 / gscale, i.e. Gamma(0, 0) on phi.
            self.param = {
                'gscale_neg_power': {'shape': 0., 'rate': 0.},
                'gscale': None,
            }
        else:
            if not ({'log10_mean', 'log10_sd'}
                    <= set(global_scale_prior_hyper_param.keys())):
                raise ValueError(
                    "Hyper-parameter dict must contain keys "
                    "'log10_mean' and 'log10_sd'."
                )
            log10_mean = global_scale_prior_hyper_param['log10_mean']
            log10_sd = global_scale_prior_hyper_param['log10_sd']
            shape, rate = self.solve_for_gscale_prior_hyperparam(
                log10_mean, log10_sd, bridge_exponent, self._gscale_paramet
            )
            self.param = {
                'gscale_neg_power': {'shape': shape, 'rate': rate},
                'gscale': {'log10_mean': log10_mean, 'log10_sd': log10_sd},
            }  # Gamma hyper-params are always in the 'raw' parametrization.

    # ------------------------------------------------------------------ #
    # Introspection / cloning                                            #
    # ------------------------------------------------------------------ #

    def get_info(self):
        sd_for_fixed = self.sd_for_fixed
        if len(sd_for_fixed) > 0 and np.all(sd_for_fixed == sd_for_fixed[0]):
            sd_for_fixed = sd_for_fixed[0]
        return {
            'bridge_exponent': self.bridge_exp,
            'n_fixed_effect': self.n_fixed,
            'sd_for_intercept': self.sd_for_intercept,
            'sd_for_fixed_effect': sd_for_fixed,
            'regularizing_slab_size': self.slab_size,
            'global_scale_prior_hyper_param': self.param['gscale'],
            '_global_scale_parametrization': self._gscale_paramet,
        }

    def clone(self, **kwargs):
        """Make a clone with only the specified attributes modified."""
        info = self.get_info()
        if '_global_scale_parametrization' in kwargs:
            raise ValueError("Change of parametrization is not supported.")
        for key, val in kwargs.items():
            if key in info:
                info[key] = val
            else:
                warn("'{:s}' is not a valid keyword argument.".format(key))
        return RegressionCoefPrior(**info)

    # ------------------------------------------------------------------ #
    # Scale parametrization                                              #
    # ------------------------------------------------------------------ #

    def adjust_scale(self, gscale, lscale, to):
        """Convert (gscale, lscale) between 'raw' and 'coef_magnitude'.

        Operates in place on array inputs, mirroring the reference
        (bayesbridge/prior.py:128-139) which mutates the sample arrays.
        """
        unit_magnitude = self.compute_power_exp_ave_magnitude(
            self.bridge_exp, 1.
        )
        if to == 'raw':
            gscale = gscale / unit_magnitude if np.isscalar(gscale) \
                else np.divide(gscale, unit_magnitude, out=gscale)
            lscale = lscale * unit_magnitude if np.isscalar(lscale) \
                else np.multiply(lscale, unit_magnitude, out=lscale)
        elif to == 'coef_magnitude':
            gscale = gscale * unit_magnitude if np.isscalar(gscale) \
                else np.multiply(gscale, unit_magnitude, out=gscale)
            lscale = lscale / unit_magnitude if np.isscalar(lscale) \
                else np.divide(lscale, unit_magnitude, out=lscale)
        else:
            raise ValueError()
        return gscale, lscale

    @staticmethod
    def compute_power_exp_ave_magnitude(exponent, scale=1.):
        """E|X| for X with density proportional to exp(-|x/scale|^exponent)."""
        return scale * math.gamma(2 / exponent) / math.gamma(1 / exponent)

    @staticmethod
    def change_log_base(val, from_=math.e, to=10.):
        """Convert a log-scale quantity between bases (prior.py:162-163)."""
        return val * math.log(from_) / math.log(to)

    # ------------------------------------------------------------------ #
    # Global-scale Gamma hyper-parameter solver                          #
    # ------------------------------------------------------------------ #

    def solve_for_gscale_prior_hyperparam(
            self, log10_mean, log10_sd, bridge_exp, gscale_paramet):
        log_mean = log10_mean * math.log(10.)
        log_sd = log10_sd * math.log(10.)
        if gscale_paramet == 'coef_magnitude':
            log_mean -= math.log(
                self.compute_power_exp_ave_magnitude(bridge_exp, 1.)
            )
        return self.solve_for_gamma_param(log_mean, log_sd, bridge_exp)

    @staticmethod
    def solve_for_gamma_param(log_mean, log_sd, bridge_exp):
        """Gamma(shape, rate) on phi = gscale^(-bridge_exp) matching the
        requested mean and sd of log(phi) = -bridge_exp * log(gscale).

        Uses the identities E[log phi] = digamma(shape) - log(rate) and
        Var[log phi] = trigamma(shape); solves trigamma(shape) =
        (bridge_exp * log_sd)^2 by Brent root-finding in log(shape)
        (reference: bayesbridge/prior.py:165-217).
        """
        if log_sd <= 0:
            raise ValueError("Standard deviation must be positive.")
        if log_sd > 10 ** 8:
            raise ValueError("Specified prior sd is too large.")

        def objective(log_shape):
            return math.sqrt(_polygamma(1, math.exp(log_shape))) / bridge_exp \
                - log_sd

        # trigamma is decreasing, so the objective decreases in log_shape;
        # bracket the root by stepping right from a small lower limit.
        lower = -10.
        if objective(lower) < 0:
            raise ValueError(
                "Objective must be positive at the lower bracket limit."
            )
        increment, max_lim = 5., lower + 10 ** 4
        while objective(lower + increment) > 0 and lower < max_lim:
            lower += increment
        if lower >= max_lim:
            raise RuntimeError("Failed to bracket the root.")
        log_shape = brentq(objective, lower, lower + increment)
        shape = math.exp(log_shape)
        rate = math.exp(_polygamma(0, shape) + bridge_exp * log_mean)
        return shape, rate
