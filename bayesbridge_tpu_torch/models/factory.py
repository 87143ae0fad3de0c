"""User-facing constructor that turns raw data into a likelihood model.

Port of ``bayesbridge_tpu/models/factory.py``: dense X (a numpy array or
a torch tensor) is stored as one block (:class:`..design.DenseDesignMatrix`),
sparse X on the hybrid, bitpack or winell backend, on an explicit device.
The Cox family never gets an intercept, and its observations are sorted
by risk set up front (reference: bayesbridge/model/factory.py:10-68).
"""

from warnings import warn

import scipy.sparse as sps

from .cox import CoxModel
from .linear import LinearModel
from .logistic import LogisticModel
from ..design import DenseDesignMatrix, SparseDesignMatrix


def _build_logit(outcome, design):
    # A tuple is (success count, trial count); anything else is a binary
    # response vector, for which the trial count is implicit.
    if isinstance(outcome, tuple):
        counts, trials = outcome
    else:
        counts, trials = outcome, None
    return LogisticModel(counts, trials, design)


_BUILDERS = {'linear': LinearModel, 'logit': _build_logit}


def RegressionModel(outcome, X, family='linear', add_intercept=None,
                    center_predictor=True, dtype=None, fused=None,
                    backend=None, device='cuda'):
    """Package raw (outcome, X) data as a likelihood model for BayesBridge.

    Parameters
    ----------
    outcome : 'linear': the response vector; 'logit': (success count,
        trial count) pair, or a binary vector; 'cox': (event time,
        censoring time) pair, infinity where the other happened
    X : numpy array or torch tensor (dense, stored as one block), or a
        scipy sparse matrix
    family : 'linear' | 'logit' | 'cox'
    add_intercept : bool, default True (never for 'cox', which warns
        when asked: the partial likelihood cannot identify it)
    center_predictor : bool
        Column-center X (implicitly, never materialized, for sparse X).
    dtype : float32 (None) or float64, the design's working dtype; the
        hand-written kernels run float32 designs, float64 runs on
        torch.matmul and cuSOLVER, and sparse float64 X on the hybrid
        backend only
    fused : None | 'auto' | '0' | '1' | 'full' — the fused-sweep policy
        of the hybrid and dense designs (``design.fusedne``): '0'
        composes every call site, '1' / 'full' run the fused sweeps,
        'auto' picks per call site; None reads ``BB_FUSED_NE``, default
        'auto'. The bitpack and winell backends always compose.
    backend : None | 'auto' | 'hybrid' | 'bitpack' | 'winell' for sparse
        X; 'auto' (the default) picks as the JAX package does, 'ell'
        raises. Ignored for dense X.
    device : 'cuda' (default) or 'cpu'; 'cuda' without a GPU raises.
    """
    if family == 'cox':
        if add_intercept:
            warn("Intercept is not identifiable in the Cox model and "
                 "won't be added.")
        event_time, censoring_time, X = CoxModel.preprocess_data(
            outcome[0], outcome[1], X)
        design = _make_design(X, False, center_predictor, dtype, fused,
                              backend, device)
        return CoxModel(event_time, censoring_time, design)
    builder = _BUILDERS.get(family)
    if builder is None:
        raise NotImplementedError(family)
    add_intercept = True if add_intercept is None else add_intercept
    return builder(outcome, _make_design(X, add_intercept, center_predictor,
                                         dtype, fused, backend, device))


def _make_design(X, add_intercept, center_predictor, dtype, fused, backend,
                 device):
    if sps.issparse(X):
        return SparseDesignMatrix(
            X, add_intercept=add_intercept,
            center_predictor=center_predictor, dtype=dtype, fused=fused,
            backend=backend if backend is not None else 'auto',
            device=device)
    if backend not in (None, 'auto'):
        warn("backend='{}' is a sparse-storage option; dense X is stored "
             "as one block.".format(backend))
    return DenseDesignMatrix(
        X, add_intercept=add_intercept, center_predictor=center_predictor,
        dtype=dtype, fused=fused, device=device)
