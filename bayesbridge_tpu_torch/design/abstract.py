"""Design-matrix abstraction.

Mirrors ``bayesbridge_tpu/design/abstract.py`` (itself after the
reference's abstract_matrix.py:14-107): `dot`, `Tdot`, matvec counters
and constant-column scrubbing. The concrete hybrid design lives in
:mod:`.sparse`; its tensors stay on the design's device and every
product is a plain function of them.
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

    def fused_ne_mode(self, kind='quad'):
        """True where a fused sweep serves the `kind` call site ('quad' |
        'presolve' | 'link'), else None (the composed path)."""
        return None

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
