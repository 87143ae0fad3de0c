"""Binomial logistic regression model.

Port of ``bayesbridge_tpu/models/logistic.py`` (reference behavior:
bayesbridge/model/logistic_model.py:6-121). The log-likelihood uses the
numerically stable softplus form; loglik and gradient together come from
one fused sweep of the design (``design.fused_link_grad``) where the
design has one, else from `dot` and `Tdot`.
"""

from warnings import warn

import numpy as np
import torch

from .abstract import AbstractModel
from ..utils.chains import rsum, softplus


class LogisticModel(AbstractModel):

    name = 'logit'

    def __init__(self, n_success, n_trial, design):
        self._validate(n_success, n_trial, design)
        if n_trial is None:
            n_trial = np.ones(len(n_success))
            warn("The numbers of trials were not specified. The binary "
                 "outcome is assumed.")
        # Host copy of the trial counts: the Polya-Gamma draw expands
        # each row into n_trial unit-shape draws.
        self.n_trial_np = np.asarray(n_trial, dtype=np.int64)
        dev = design.device
        self.n_trial = torch.as_tensor(np.asarray(n_trial, np.float64),
                                       dtype=design.dtype, device=dev)
        self.n_success = torch.as_tensor(
            np.asarray(n_success, np.float64), dtype=design.dtype,
            device=dev)
        self.design = design

    @staticmethod
    def _validate(n_success, n_trial, design):
        if n_trial is None:
            if np.max(n_success) > 1:
                raise ValueError(
                    "If not binary, the number of trials must be specified.")
            if len(n_success) != design.shape[0]:
                raise ValueError(
                    "Incompatible sizes of the outcome and design matrix.")
            return
        if not (len(n_trial) == len(n_success) == design.shape[0]):
            raise ValueError(
                "Incompatible sizes of the outcome vectors and design "
                "matrix.")
        if np.any(np.asarray(n_trial) <= 0):
            raise ValueError("Number of trials must be strictly positive.")
        if np.any(np.asarray(n_success) > np.asarray(n_trial)):
            raise ValueError(
                "Number of successes cannot be larger than that of trials.")

    def compute_loglik_and_gradient(self, beta):
        """(loglik, gradient) at beta: one fused design sweep where the
        design has one, else dot then Tdot (logistic.py:72-91)."""
        fused = self.design.fused_link_grad(
            beta, self.n_success, self.n_trial, 'logit')
        if fused is not None:
            return fused
        logit_prob = self.design.dot(beta)
        loglik = self.loglik_from_lin_pred(logit_prob)
        grad = self.design.Tdot(
            self.n_success - self.n_trial * torch.sigmoid(logit_prob))
        return loglik, grad

    def loglik_from_lin_pred(self, lin_pred):
        """Log-likelihood from a precomputed linear predictor X beta; per
        chain for lin_pred (k, n)."""
        return rsum(self.n_success * lin_pred
                    - self.n_trial * softplus(lin_pred))

    def calc_intercept_mle(self):
        p_mle = float(self.n_success.double().mean()
                      / self.n_trial.double().mean())
        return float(np.log(p_mle / (1 - p_mle)))

    @staticmethod
    def compute_polya_gamma_mean(shape, tilt):
        """E[PG(shape, tilt)] = shape * tanh(tilt/2) / (2 tilt), with the
        small-tilt limit shape/4 (logistic_model.py:79-87)."""
        min_magnitude = 1e-5
        big = tilt.abs() > min_magnitude
        safe_tilt = torch.where(big, tilt, torch.ones_like(tilt))
        mean = 0.5 * shape * torch.tanh(safe_tilt / 2.0) / safe_tilt
        return torch.where(big, mean, shape / 4.0)
