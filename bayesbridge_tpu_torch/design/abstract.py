"""Design-matrix abstraction.

Mirrors ``bayesbridge_tpu/design/abstract.py`` (itself after the
reference's abstract_matrix.py:14-107): `dot`, `Tdot`, the composed CG
operator, the Fisher diagonal, matvec counters and
constant-column scrubbing. The concrete designs live in :mod:`.sparse`;
their tensors stay on the design's device and every product is a plain
function of them.
"""

import abc
import warnings

import numpy as np


class AbstractDesignMatrix(abc.ABC):

    def __init__(self):
        self.dot_count = 0
        self.Tdot_count = 0

    @property
    @abc.abstractmethod
    def shape(self):
        ...

    @abc.abstractmethod
    def dot(self, v):
        """X @ v."""

    @abc.abstractmethod
    def Tdot(self, v):
        """X.T @ v."""

    @property
    @abc.abstractmethod
    def is_sparse(self):
        ...

    @abc.abstractmethod
    def compute_fisher_diag(self, weight):
        """diag(X' diag(weight) X)."""

    def compute_fisher_info(self, weight, diag_only=False):
        """X' diag(weight) X, or its diagonal. Only the diagonal (the
        Jacobi preconditioner's) is ported; the dense matrix belongs to
        the Cholesky path."""
        if not diag_only:
            raise NotImplementedError(
                "the dense Fisher information (Cholesky path) is not "
                "ported; see ROADMAP.md Queue 1 item 10")
        return self.compute_fisher_diag(weight)

    def quad_matvec(self, v, weight, return_t=False):
        """X' (weight * (X v)), the design part of the CG operator,
        composed from `dot` and `Tdot` (abstract.py:65-81). With
        `return_t` it also returns ``t = X v`` (intercept and centering
        included), from which the CG loop accumulates the draw's linear
        predictor."""
        t = self.dot(v)
        out = self.Tdot(weight * t)
        return (out, t) if return_t else out

    def fused_ne_mode(self, kind='quad'):
        """True where a fused sweep serves the `kind` call site ('quad' |
        'presolve' | 'link'), else None (the composed path)."""
        return None

    def fused_link_grad(self, v, a, b, mid):
        """GLM loglik + gradient in one sweep where a fused kernel serves
        this design; None = the caller composes dot and Tdot."""
        return None

    def cg_blockorder_ctx(self):
        """(perm, unperm, offset_bo) where the CG solve runs in block
        order (hybrid composed path), else None."""
        return None

    def has_presolve_reductions(self):
        """True where one read of the design serves
        `presolve_reductions`; else the caller composes the pre-solve
        from `Tdot` and the Fisher diagonal."""
        return self.fused_ne_mode('presolve') is not None

    # -- bookkeeping ---------------------------------------------------- #

    @property
    def n_matvec(self):
        return self.dot_count + self.Tdot_count

    def get_dot_count(self):
        return self.dot_count, self.Tdot_count

    # -- preprocessing -------------------------------------------------- #

    @staticmethod
    def remove_intercept_indicator(X):
        """Drop (numerically) constant columns of a scipy CSR matrix; the
        intercept is handled implicitly (reference:
        abstract_matrix.py:92-107). Column moments come from one pass
        over the stored entries."""
        n, p = X.shape
        data = X.data.astype(np.float64)
        first = np.bincount(X.indices, weights=data, minlength=p) / n
        second = np.bincount(X.indices, weights=data * data,
                             minlength=p) / n
        is_constant = second - first ** 2 < n * 2 ** -52
        if np.any(is_constant):
            warnings.warn(
                "Intercept column (or one numerically indistinguishable "
                "from constant) detected. Do not add the intercept "
                "manually; removing the column(s)."
            )
            X = X[:, np.logical_not(is_constant)]
        return X
