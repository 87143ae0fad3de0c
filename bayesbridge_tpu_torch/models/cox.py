"""Cox proportional-hazards model (Breslow partial likelihood).

Port of ``bayesbridge_tpu/models/cox.py`` (reference behavior:
bayesbridge/model/cox_model.py:7-355). The observations are sorted once
on the host (NumPy) so that the events come first in ascending event
time, then the censored observations in descending censoring time; each
event's risk set is then a contiguous index range [start_k, end_k], and
every risk-set reduction is one prefix sum and two gathers:

    sum(arr[s_k : e_k + 1]) = csum[e_k + 1] - csum[s_k],

with csum = [0, cumsum(arr)], as the JAX package computes it (in float32
the difference of two prefix sums cancels at large n; the port keeps the
formula, and so the JAX package's numbers).

Every method takes one coefficient vector, or k Markov chains' as the
rows of a (k, p) tensor, and the prefix sums run per chain
(``utils.chains.rcumsum``). The design's products carry the chain axis
(on the hybrid backend's composed path the row pass and the column pass
read X once for the chains), so a gradient costs two reads of X: the
risk-set sums need all of X beta before X' u can start.
"""

from warnings import warn

import numpy as np
import scipy.sparse as sps
import torch

from .abstract import AbstractModel
from ..utils.chains import rcumsum, rsum, take


def _sum_over_start_end(arr, start_index, end_index):
    """k-th output = sum(arr[..., start_index[k] : end_index[k] + 1]),
    per chain row."""
    csum = rcumsum(arr)
    csum = torch.cat((torch.zeros(arr.shape[:-1] + (1,), dtype=arr.dtype,
                                  device=arr.device), csum), -1)
    return csum[..., end_index + 1] - csum[..., start_index]


class CoxModel(AbstractModel):

    name = 'cox'

    def __init__(self, event_time, censoring_time, design):
        event_time = np.asarray(event_time, dtype=np.float64)
        censoring_time = np.asarray(censoring_time, dtype=np.float64)
        if len(event_time) != design.shape[0]:
            raise ValueError(
                "Incompatible sizes of the outcome and design matrix.")
        if np.any(event_time[:-1] > event_time[1:]):
            raise ValueError(
                "The observations need to be sorted in increasing order of "
                "event time (use CoxModel.preprocess_data).")
        if np.any(censoring_time[:-1] < censoring_time[1:]):
            raise ValueError(
                "The observations need to be sorted in decreasing order of "
                "censoring time (use CoxModel.preprocess_data).")
        n_event = int(len(event_time) - np.sum(np.isinf(event_time)))
        start_index, end_index = self._find_risk_set_index(
            event_time[:n_event], np.flip(censoring_time[n_event:]))
        n_appearance = self.count_risk_set_appearance(
            len(event_time), start_index, end_index)
        if not np.all(n_appearance >= 1):
            raise ValueError(
                "Some individuals never appear in the risk set; remove them "
                "before constructing the CoxModel.")
        dev = design.device
        self.n_event = n_event
        self.event_time = event_time
        self.censoring_time = censoring_time
        self.risk_set_start_index = torch.as_tensor(start_index,
                                                    device=dev)
        self.risk_set_end_index = torch.as_tensor(end_index, device=dev)
        self.n_appearance_in_risk_set = torch.as_tensor(n_appearance,
                                                        device=dev)
        self._event_indicator = torch.zeros(
            len(event_time), dtype=design.dtype, device=dev)
        self._event_indicator[:n_event] = 1.0
        self.design = design

    # -- one-time host-side preprocessing (cox_model.py:57-178) ----------- #

    @staticmethod
    def preprocess_data(event_time, censoring_time, X):
        event_time, censoring_time, X = \
            CoxModel._permute_observations_by_event_and_censoring_time(
                event_time, censoring_time, X)
        return CoxModel._drop_uninformative_observations(
            event_time, censoring_time, X)

    @staticmethod
    def _permute_observations_by_event_and_censoring_time(
            event_time, censoring_time, X):
        event_time = np.asarray(event_time, dtype=np.float64)
        censoring_time = np.asarray(censoring_time, dtype=np.float64)
        if not np.all(np.equal(np.isinf(event_time),
                               np.isfinite(censoring_time))):
            raise ValueError(
                "Exactly one of event or censoring time must be infinity "
                "for each observation.")
        is_sorted = (np.all(event_time[:-1] <= event_time[1:])
                     and np.all(censoring_time[:-1] >= censoring_time[1:]))
        if is_sorted:
            return event_time, censoring_time, X
        warn("The observations and design matrix will be sorted so that "
             "event times are ascending and censoring times descending.")
        # Stable sorts keep the reference's order of ties
        # (cox_model.py:104-112): the events ascending first, then the
        # censored observations in descending censoring time.
        event_order = np.argsort(event_time, kind='stable')
        censoring_order = np.argsort(-censoring_time, kind='stable')
        sort_ind = np.concatenate((
            event_order[np.isfinite(event_time[event_order])],
            censoring_order[np.isfinite(censoring_time[censoring_order])],
        ))
        assert len(np.unique(sort_ind)) == len(sort_ind)
        event_time = event_time[sort_ind]
        censoring_time = censoring_time[sort_ind]
        X = X.tocsr()[sort_ind, :] if sps.issparse(X) else X[sort_ind, :]
        return event_time, censoring_time, X

    @staticmethod
    def _drop_uninformative_observations(event_time, censoring_time, X):
        # Observations censored before the first event never enter a risk
        # set (cox_model.py:124-146).
        is_uninformative = censoring_time < np.min(event_time)
        if np.any(is_uninformative):
            warn("Some observations do not contribute to the likelihood, "
                 "so they are being removed.")
            keep = np.logical_not(is_uninformative)
            event_time = event_time[keep]
            censoring_time = censoring_time[keep]
            X = X[keep, :]
        return event_time, censoring_time, X

    @staticmethod
    def _find_risk_set_index(event_time, censoring_time_ascending):
        """Start and end index of each event's risk set, from the finite
        event times (ascending) and finite censoring times (ascending)
        (cox_model.py:162-178): tied events share the first tie's risk
        set, and censoring at the event time still counts as at risk."""
        n_event = len(event_time)
        start_index = np.searchsorted(event_time, event_time, side='left')
        n_censored_before = np.searchsorted(
            censoring_time_ascending, event_time, side='left')
        end_index = n_event + len(censoring_time_ascending) - 1 \
            - n_censored_before
        return start_index.astype(np.int64), end_index.astype(np.int64)

    @staticmethod
    def count_risk_set_appearance(n_obs, start_index, end_index):
        """The number of risk sets holding each observation, by a
        difference array (cox_model.py:148-160)."""
        delta = np.zeros(n_obs + 1, dtype=np.int64)
        valid = start_index <= end_index
        np.add.at(delta, start_index[valid], 1)
        np.add.at(delta, end_index[valid] + 1, -1)
        return np.cumsum(delta[:-1])

    @staticmethod
    def np_rank_by_value(arr):
        order = np.argsort(arr)
        rank = np.empty(len(arr))
        rank[order] = np.arange(len(arr))
        return rank

    # -- likelihood, gradient, Hessian ------------------------------------ #

    def _matrix(self, rel_hazard, hazard_sum):
        return _HazardMultinomialProbMatrix(
            rel_hazard, hazard_sum, self.risk_set_start_index,
            self.risk_set_end_index, self.n_appearance_in_risk_set)

    def _compute_relative_hazard(self, beta):
        log_hazard = self.design.dot(beta)
        # Overflow guard: the hazards relative to each chain's largest.
        log_hazard = log_hazard - log_hazard.max(-1, keepdim=True).values
        rel_hazard = torch.exp(log_hazard)
        hazard_sum = _sum_over_start_end(
            rel_hazard, self.risk_set_start_index, self.risk_set_end_index)
        return log_hazard, rel_hazard, hazard_sum

    def compute_loglik_and_gradient(self, beta, loglik_only=False):
        """(loglik, gradient) at beta, per chain for beta (k, p); the
        gradient is None with `loglik_only`. A zero hazard sum (the
        coefficients have diverged) gives loglik -inf and a NaN gradient,
        as the reference's -inf (cox_model.py:186-189; cox.py:190-220)."""
        log_hazard, rel_hazard, hazard_sum = \
            self._compute_relative_hazard(beta)
        zero = hazard_sum == 0.
        any_zero = zero.any(-1)
        safe_sum = torch.where(zero, torch.ones_like(hazard_sum), hazard_sum)
        loglik = rsum(log_hazard[..., :self.n_event] - torch.log(safe_sum))
        loglik = torch.where(any_zero, torch.full_like(loglik, -np.inf),
                             loglik)
        if loglik_only:
            return loglik, None
        W = self._matrix(rel_hazard, safe_sum)
        grad = self.design.Tdot(self._event_indicator - W.sum_over_events())
        grad = torch.where(any_zero[..., None] if grad.dim() == 2
                           else any_zero, torch.full_like(grad, np.nan),
                           grad)
        return loglik, grad

    def compute_hessian(self, beta):
        raise NotImplementedError()

    def get_hessian_matvec_operator(self, beta):
        """v -> Hessian(beta) v (cox.py:225-242), the division guarded
        like the gradient's. For beta (k, p) the operator takes (m, p)
        vectors of the chains `rows` (a LongTensor; None: every chain)."""
        _, rel_hazard, hazard_sum = self._compute_relative_hazard(beta)
        safe_sum = torch.where(hazard_sum == 0.,
                               torch.ones_like(hazard_sum), hazard_sum)
        row_sum = self._matrix(rel_hazard, safe_sum).sum_over_events()

        def hessian_op(v, rows=None):
            W = self._matrix(take(rel_hazard, rows), take(safe_sum, rows))
            Xv = self.design.dot(v)
            return -self.design.Tdot(take(row_sum, rows) * Xv
                                     - W.Tdot(W.dot(Xv)))

        return hessian_op

    def calc_intercept_mle(self):
        raise NotImplementedError(
            "Intercept is not identifiable in the Cox model.")

    # -- simulation (cox_model.py:273-306) -------------------------------- #

    @staticmethod
    def simulate_outcome(X, beta, censoring_frac=.9, seed=None):
        """Exponential survival under a constant baseline hazard, with
        exponential censoring calibrated to the requested censored
        fraction (host NumPy; the JAX package's draws for a seed)."""
        if seed is not None:
            np.random.seed(seed)
        log_hazard = np.asarray(X.dot(beta))
        log_hazard = log_hazard - np.max(log_hazard)
        hazard = np.exp(log_hazard)
        event_time = np.random.exponential(scale=1.0 / hazard)
        # Solve P(Z < t) = 1 - censoring_frac for the censoring scale.
        t = np.quantile(event_time, 1 - censoring_frac)
        scale = -t / np.log(censoring_frac)
        censoring_time = np.random.exponential(
            scale=scale * np.ones(len(hazard)))
        censored = event_time >= censoring_time
        censoring_time[~censored] = np.inf
        event_time[censored] = np.inf
        return event_time, censoring_time


class _HazardMultinomialProbMatrix:
    """Operator view of the n_event x n matrix whose k-th row holds the
    conditional event probabilities over risk set k:
    W[k, j] = rel_hazard[j] / hazard_sum[k] for j in risk set k
    (cox_model.py:308-355); every product is one prefix sum per chain and
    gathers. rel_hazard (n,) and hazard_sum (n_event,), or (k, ...) for
    k chains."""

    def __init__(self, rel_hazard, hazard_sum, start_index, end_index,
                 n_appearance):
        self.rel_hazard = rel_hazard
        self.hazard_sum = hazard_sum
        self.start_index = start_index
        self.end_index = end_index
        self.n_appearance = n_appearance

    def sum_over_events(self):
        """Column sums: observation j lies in the risk sets of the first
        n_appearance[j] events."""
        normalizer_csum = rcumsum(1.0 / self.hazard_sum)
        return normalizer_csum[..., self.n_appearance - 1] * self.rel_hazard

    def dot(self, v):
        return _sum_over_start_end(
            self.rel_hazard * v, self.start_index, self.end_index
        ) / self.hazard_sum

    def Tdot(self, v):
        partial = rcumsum(v / self.hazard_sum)
        return self.rel_hazard * partial[..., self.n_appearance - 1]

    def compute_matrix(self):
        """Dense materialization of one chain's matrix (a test oracle)."""
        n = self.rel_hazard.shape[-1]
        cols = torch.arange(n, device=self.rel_hazard.device)[None, :]
        in_risk_set = (cols >= self.start_index[:, None]) \
            & (cols <= self.end_index[:, None])
        return torch.where(
            in_risk_set,
            self.rel_hazard[None, :] / self.hazard_sum[:, None],
            torch.zeros((), dtype=self.rel_hazard.dtype,
                        device=self.rel_hazard.device))
