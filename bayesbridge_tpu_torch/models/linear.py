"""Gaussian linear regression model.

Port of ``bayesbridge_tpu/models/linear.py`` (reference behavior:
bayesbridge/model/linear_model.py:6-48). The outcome lives on the
design's device in its working dtype; the observation precision is one
scalar. Loglik and gradient together come from one fused sweep of the
design (``design.fused_link_grad``, the 'linear' mode) where the design
has one, else from `dot` and `Tdot`. The Hessian operators wait for the
Newton-CG search.
"""

import numpy as np
import torch

from .abstract import AbstractModel
from ..utils.chains import rsum


class LinearModel(AbstractModel):

    name = 'linear'

    def __init__(self, y, design):
        if len(y) != design.shape[0]:
            raise ValueError(
                "Incompatible sizes of the outcome and design matrix.")
        if not torch.is_tensor(y):
            y = torch.from_numpy(np.asarray(y, np.float64))
        self.y = y.to(device=design.device, dtype=design.dtype)
        self.design = design

    def _prec(self, obs_prec):
        return torch.as_tensor(obs_prec, dtype=self.y.dtype,
                               device=self.y.device)

    def compute_loglik_and_gradient(self, beta, obs_prec, loglik_only=False):
        """(loglik, gradient) at beta given the observation precision;
        the gradient is None with `loglik_only` (linear.py:33-47)."""
        obs_prec = self._prec(obs_prec)
        n = self.y.shape[0]
        if not loglik_only:
            fused = self.design.fused_link_grad(
                beta, self.y, obs_prec.expand(n).contiguous(), 'linear')
            if fused is not None:
                lp, grad = fused
                return lp + 0.5 * n * torch.log(obs_prec), grad
        resid = self.y - self.design.dot(beta)
        loglik = 0.5 * n * torch.log(obs_prec) \
            - 0.5 * obs_prec * torch.sum(resid ** 2)
        grad = None if loglik_only else obs_prec * self.design.Tdot(resid)
        return loglik, grad

    def loglik_from_lin_pred(self, lin_pred, obs_prec):
        """The log-likelihood from a precomputed linear predictor X beta:
        ``compute_loglik_and_gradient(..., loglik_only=True)[0]`` without
        its design pass; per chain for lin_pred (k, n) and obs_prec
        (k,)."""
        obs_prec = self._prec(obs_prec)
        resid = self.y - lin_pred
        return 0.5 * self.y.shape[0] * torch.log(obs_prec) \
            - 0.5 * obs_prec * rsum(resid * resid)

    def calc_intercept_mle(self):
        return float(self.y.double().mean())

    @staticmethod
    def simulate_outcome(X, beta, noise_sd, seed=None):
        """Host-side data simulation; X only needs `.dot`."""
        if seed is not None:
            np.random.seed(seed)
        return np.asarray(X.dot(beta)) \
            + noise_sd * np.random.randn(X.shape[0])
