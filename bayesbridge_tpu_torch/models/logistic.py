"""Binomial logistic regression model.

Port of ``bayesbridge_tpu/models/logistic.py`` (reference behavior:
bayesbridge/model/logistic_model.py:6-121). The log-likelihood uses the
numerically stable softplus form; loglik and gradient together come from
one fused sweep of the design (``design.fused_link_grad``) where the
design has one, else from `dot` and `Tdot`. The Hessian's matvec is the
design's ``quad_matvec`` (the CG operator's call site: fused on the
one-read kernel where the policy fuses 'quad', else the row and column
passes). Every method takes one coefficient vector or k chains' rows.
"""

from warnings import warn

import numpy as np
import torch

from .abstract import AbstractModel
from ..utils.chains import per_chain, rsum, sigmoid, softplus, take


class LogisticModel(AbstractModel):

    name = 'logit'

    def __init__(self, n_success, n_trial, design):
        self._validate(n_success, n_trial, design)
        if n_trial is None:
            n_trial = np.ones(len(n_success))
            warn("The numbers of trials were not specified. The binary "
                 "outcome is assumed.")
        # The trial counts as the Polya-Gamma draw's shapes: on the host
        # (the CPU's rounds expand each row into n_trial unit-shape
        # draws), and on the model's device once as int32, or None where
        # every count is 1 (the kernel then takes no shapes).
        self.n_trial_np = np.asarray(n_trial, dtype=np.int64)
        dev = design.device
        self.pg_shape = None if np.all(self.n_trial_np == 1) \
            else torch.as_tensor(self.n_trial_np, dtype=torch.int32,
                                 device=dev)
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

    def compute_loglik_and_gradient(self, beta, loglik_only=False):
        """(loglik, gradient) at beta: one fused design sweep where the
        design has one (per chain for beta (k, p)), else dot then Tdot
        (logistic.py:72-91); the gradient is None with `loglik_only`."""
        beta = self.design._as_tensor(beta)
        if not loglik_only and self.design.fused_ne_mode('link'):
            return per_chain(self._fused_grad, beta) if beta.dim() == 2 \
                else self._fused_grad(beta)
        logit_prob = self.design.dot(beta)
        loglik = self.loglik_from_lin_pred(logit_prob)
        if loglik_only:
            return loglik, None
        grad = self.design.Tdot(
            self.n_success - self.n_trial * sigmoid(logit_prob))
        return loglik, grad

    def _fused_grad(self, beta):
        return self.design.fused_link_grad(beta, self.n_success,
                                           self.n_trial, 'logit')

    def loglik_from_lin_pred(self, lin_pred):
        """Log-likelihood from a precomputed linear predictor X beta; per
        chain for lin_pred (k, n)."""
        return rsum(self.n_success * lin_pred
                    - self.n_trial * softplus(lin_pred))

    def _hessian_weight(self, beta):
        prob = sigmoid(self.design.dot(beta))
        return self.n_trial * prob * (1 - prob)

    def compute_hessian(self, beta):
        """The Hessian -X' diag(w) X at beta (logistic.py:103-106)."""
        return -self.design.compute_fisher_info(self._hessian_weight(beta))

    def get_hessian_matvec_operator(self, beta):
        """v -> Hessian(beta) v = -X'(w * (X v)) (logistic.py:108-113).
        For beta (k, p) the operator takes (m, p) vectors of the chains
        `rows` (a LongTensor; None: every chain)."""
        weight = self._hessian_weight(beta)
        return lambda v, rows=None: -self.design.quad_matvec(
            v, take(weight, rows))

    def calc_intercept_mle(self):
        p_mle = float(self.n_success.double().mean()
                      / self.n_trial.double().mean())
        return float(np.log(p_mle / (1 - p_mle)))

    @staticmethod
    def convert_to_probability_scale(logit_prob, truncate=False):
        """1 / (1 + e^-x) of a tensor or array (logistic.py:131-137); with
        `truncate` x is clipped to [-709, 36.7], which keeps 0 < prob < 1
        in float64 (logistic_model.py:95-103)."""
        logit_prob = torch.as_tensor(logit_prob)
        if truncate:
            logit_prob = torch.clamp(logit_prob, -709.0, 36.7)
        return 1.0 / (1.0 + torch.exp(-logit_prob))

    @staticmethod
    def compute_predicted_prob(X, beta, truncate=False):
        """The success probabilities of X beta (logistic.py:139-142); X
        only needs `.dot`."""
        return LogisticModel.convert_to_probability_scale(
            X.dot(beta), truncate)

    @staticmethod
    def simulate_outcome(n_trial, X, beta, seed=None):
        """Binomial successes of `n_trial` trials at X beta's
        probabilities, drawn on the host from numpy's global generator
        seeded with `seed` (logistic.py:144-149)."""
        prob = LogisticModel.compute_predicted_prob(X, beta).cpu().numpy()
        if seed is not None:
            np.random.seed(seed)
        return np.random.binomial(np.asarray(n_trial).astype(np.int64), prob)

    @staticmethod
    def compute_polya_gamma_mean(shape, tilt):
        """E[PG(shape, tilt)] = shape * tanh(tilt/2) / (2 tilt), with the
        small-tilt limit shape/4 (logistic_model.py:79-87)."""
        min_magnitude = 1e-5
        big = tilt.abs() > min_magnitude
        safe_tilt = torch.where(big, tilt, torch.ones_like(tilt))
        mean = 0.5 * shape * torch.tanh(safe_tilt / 2.0) / safe_tilt
        return torch.where(big, mean, shape / 4.0)
