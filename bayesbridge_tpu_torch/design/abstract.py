"""Design-matrix abstraction.

Mirrors ``bayesbridge_tpu/design/abstract.py`` (itself after the
reference's abstract_matrix.py:14-107): `dot`, `Tdot`, the composed CG
operator, the Fisher information, matvec counters and constant-column
scrubbing. The concrete designs live in :mod:`.sparse` and
:mod:`.dense`; their tensors stay on the design's device and every
product is a plain function of them.

The products take one vector, or k Markov chains' vectors as the rows of
a (k, m) tensor (``multichain``), and return the same layout: chain c's
row is the product of its vector alone.
"""

import abc
import functools
import warnings

import numpy as np
import torch


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def memoized_dot(dot):
    """Decorate a design's `dot` with the memo of :meth:`memoize_dot`:
    while it is on, a call with the caller's value equal to the last
    call's returns that call's result, without a product or a count."""
    @functools.wraps(dot)
    def wrapper(self, v):
        if not self.memoized:
            return dot(self, v)
        if self._memo_v is not None and np.array_equal(self._memo_v,
                                                       _host(v)):
            return self._memo_result
        result = dot(self, v)
        self._memo_v = np.array(_host(v), copy=True)
        self._memo_result = result
        return result
    return wrapper


class AbstractDesignMatrix(abc.ABC):

    def __init__(self):
        self.dot_count = 0
        self.Tdot_count = 0
        self.memoized = False
        self._memo_v = None
        self._memo_result = None

    @property
    @abc.abstractmethod
    def shape(self):
        ...

    @abc.abstractmethod
    def dot(self, v):
        """X @ v; (k, n) for v (k, p)."""

    @abc.abstractmethod
    def Tdot(self, v):
        """X.T @ v; (k, p) for v (k, n)."""

    @property
    @abc.abstractmethod
    def is_sparse(self):
        ...

    @abc.abstractmethod
    def compute_fisher_diag(self, weight):
        """diag(X' diag(weight) X); (k, p) for weight (k, n)."""

    @abc.abstractmethod
    def compute_fisher_info(self, weight, diag_only=False):
        """X' diag(weight) X (the Cholesky path's p x p matrix), or its
        diagonal (the Jacobi preconditioner's); per chain for weight (k,
        n)."""

    @abc.abstractmethod
    def compute_transposed_fisher_info(self, weight, include_intrcpt=False):
        """X diag(weight) X' over predictors."""

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

    def counters(self):
        """[(object, attribute)] of the counters its products advance."""
        return [(self, 'dot_count'), (self, 'Tdot_count')]

    def devices(self):
        """The devices its products run on, all in this process; None
        where other processes take part."""
        return {self.device}

    def get_dot_count(self):
        return self.dot_count, self.Tdot_count

    def reset_matvec_count(self, count=0):
        """Set the (dot, Tdot) counters to `count` (one number for both,
        or a pair)."""
        if not hasattr(count, "__len__"):
            count = (count, count)
        self.dot_count, self.Tdot_count = count[0], count[1]

    def memoize_dot(self, flag=True):
        """Cache X v for a repeated identical v (abstract.py:142-149,
        after the reference's abstract_matrix.py:42-48): the memo keys on
        the caller's value, copied to the host; turning it off drops
        it."""
        self.memoized = flag
        if not flag:
            self._memo_v = None
            self._memo_result = None

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
