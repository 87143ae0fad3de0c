"""Likelihood-model interface (bayesbridge_tpu/models/abstract.py; the
reference's abstract_model.py:4-42)."""

import abc


class AbstractModel(abc.ABC):

    @property
    def n_obs(self):
        return self.design.shape[0]

    @property
    def n_pred(self):
        return self.design.shape[1]

    @property
    def intercept_added(self):
        return self.design.intercept_added

    @abc.abstractmethod
    def compute_loglik_and_gradient(self, beta):
        """Return (loglik, grad)."""

    @abc.abstractmethod
    def calc_intercept_mle(self):
        """Intercept MLE assuming all other coefficients are zero."""
