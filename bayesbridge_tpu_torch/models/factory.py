"""User-facing constructor that turns raw data into a likelihood model.

Port of ``bayesbridge_tpu/models/factory.py`` for the slice the torch
package serves: the logit family on a sparse X, stored on the hybrid,
bitpack or winell backend on an explicit device.
"""

from .logistic import LogisticModel
from ..design import SparseDesignMatrix


def RegressionModel(outcome, X, family='logit', add_intercept=None,
                    center_predictor=True, dtype=None, fused=None,
                    backend=None, device='cuda'):
    """Package raw (outcome, X) data as a likelihood model for BayesBridge.

    Parameters
    ----------
    outcome : (success count, trial count) pair, or a binary vector
    X : scipy sparse matrix (dense X is not ported)
    family : 'logit' (the other families are not ported)
    add_intercept : bool, default True
    center_predictor : bool
        Column-center X implicitly (never materialized).
    dtype : float32 (the only working dtype of the port); None = float32
    fused : None | 'full' | '1' — the hybrid backend's fused sweeps (the
        hand-written kernels on CUDA, their plain versions on the CPU);
        'auto' / '0' (its composed path) raise NotImplementedError. The
        bitpack and winell backends always compose and accept any value.
    backend : None | 'auto' | 'hybrid' | 'bitpack' | 'winell'; 'auto'
        (the default) picks as the JAX package does, 'ell' raises
    device : 'cuda' (default) or 'cpu'; 'cuda' without a GPU raises.
    """
    if family != 'logit':
        raise NotImplementedError(
            f"family={family!r}: only 'logit' is ported (ROADMAP.md "
            "Queue 1 items 5 and 13)")
    design = SparseDesignMatrix(
        X, add_intercept=True if add_intercept is None else add_intercept,
        center_predictor=center_predictor, dtype=dtype, fused=fused,
        backend=backend if backend is not None else 'auto', device=device)
    if isinstance(outcome, tuple):
        counts, trials = outcome
    else:
        counts, trials = outcome, None
    return LogisticModel(counts, trials, design)
