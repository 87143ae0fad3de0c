"""Dense design matrix.

Port of ``bayesbridge_tpu/design/dense.py`` (reference:
bayesbridge/design_matrix/dense_matrix.py:7-72): constant columns are
dropped, the centering applied and the intercept column materialized up
front, after which `dot`, `Tdot` and the Fisher products are
``torch.matmul`` (the JAX package's XLA dots outside Pallas; cuBLAS on
the card), float32 or float64.

The fused call sites run on one float32 block with a zero row offset,
through the kernels of the hybrid design (:mod:`..kernels.ne_sweep`,
:mod:`..kernels.tdots_sweep`), where the ``fused`` policy asks for them
(:func:`.fusedne.dispatch_mode`, per call site) and the design is
float32 (``dense.py:103-112``):

- `quad_matvec`, the CG operator X'(w * (X v)): ``ne_sweep`` in its
  'ne' mode, on the card the one-read kernel wherever its plan fits the
  block (about 16,384 float32 columns), else the two-pass route, each
  with its own launch counter;
- `fused_link_grad`, the MAP search's loglik and gradient: ``ne_sweep``
  in its 'logit' / 'linear' mode with the log-likelihood sum;
- `presolve_reductions`: one ``tdots_sweep`` read, the warm start's
  column composed as a separate `Tdot`. Composed, one multi-RHS product
  ``X' [u1 u2 u3 (u4)]`` and the squared-column moment.

Storage: X is kept row-major as (n, ld), its p columns followed by zero
columns up to a whole number of 16-byte vectors per row (the kernels
stream 16-byte units); every product reads the ``[:, :p]`` view.

Products take one vector or k Markov chains' vectors along a leading
axis: a float64 design multiplies the k columns at once; a float32 one
runs its single-vector product per chain (cuBLAS's k-column product does
not give each column the bits of its one-column product, and a chain
must equal itself run alone), except the fused pre-solve, whose
``tdots_sweep_k`` reads the block once for up to 8 chains.
"""

import copy
import warnings

import numpy as np
import torch

from .abstract import AbstractDesignMatrix, memoized_dot
from .fusedne import POLICIES, dispatch_mode
from .gram import chunked_gram, squared_col_moment
from .pieces import WHOLE, ColumnPiece, split_units
from ..kernels.ne_sweep import ne_sweep
from ..kernels.tdots_sweep import tdots_sweep, tdots_sweep_k
from ..utils.chains import per_chain
from ..utils.dtypes import full_float32, resolve_device, working_dtype

_ROW_ALIGN_BYTES = 16


def stored_width(p, itemsize):
    """Stored row length for `p` columns: whole 16-byte vectors."""
    per = _ROW_ALIGN_BYTES // itemsize
    return max(per, -(-p // per) * per)


class DenseDesignMatrix(AbstractDesignMatrix):

    def __init__(self, X, center_predictor=False, add_intercept=True,
                 dtype=None, fused=None, device='cuda', _stored=None):
        """X : (n, p) numpy array or torch tensor (any device; moved to
        `device` before the preprocessing runs there). `_stored` = (X
        stored as (n, ld) in the working dtype, p): an already processed
        design (``convert.dense_design_from_numpy``)."""
        super().__init__()
        self.intercept_added = add_intercept
        self.centered = center_predictor
        self.device = resolve_device(device)
        if fused not in POLICIES:
            raise ValueError(f"unknown fused policy {fused!r}")
        self.fused_policy = fused
        if _stored is not None:
            X_stored, self._p = _stored
            self.X = X_stored.to(self.device)
            return
        dtype = working_dtype(dtype)
        if not torch.is_tensor(X):
            X = torch.from_numpy(np.asarray(X))
        X = X.to(device=self.device, dtype=dtype)
        X = self.remove_constant_columns(X)
        if center_predictor:
            X = X - X.mean(dim=0, keepdim=True)
        n, p_main = X.shape
        self._p = p_main + int(add_intercept)
        self.X = torch.zeros((n, stored_width(self._p, X.element_size())),
                             dtype=dtype, device=self.device)
        self.X[:, int(add_intercept):self._p] = X
        if add_intercept:
            self.X[:, 0] = 1.0

    @staticmethod
    def remove_constant_columns(X):
        """Drop (numerically) constant columns of a dense tensor; the
        intercept is the design's own (abstract_matrix.py:92-107)."""
        n = X.shape[0]
        is_constant = torch.var(X, dim=0, correction=0) < n * 2 ** -52
        if bool(is_constant.any()):
            warnings.warn(
                "Intercept column (or one numerically indistinguishable "
                "from constant) detected. Do not add the intercept "
                "manually; removing the column(s).")
            X = X[:, ~is_constant]
        return X

    def with_policy(self, fused):
        """This design's stored X (shared, not copied) under another fused
        policy, with its matvec counters at zero."""
        if fused not in POLICIES:
            raise ValueError(f"unknown fused policy {fused!r}")
        other = copy.copy(self)
        other.fused_policy = fused
        other.dot_count = other.Tdot_count = 0
        return other

    def row_block(self, r0, r1, device=None):
        """Rows r0:r1 of this design as a design of their own on `device`
        (default this design's): its stored rows carry the intercept
        column and the whole design's centering, so the block keeps the
        column layout. On this design's device a row view, not a copy;
        rows 0:n on another device are the design moved there."""
        n = self.X.shape[0]
        if not 0 <= r0 < r1 <= n:
            raise ValueError(f"rows {r0}:{r1} of a {n}-row design")
        device = self.device if device is None else resolve_device(device)
        blk = copy.copy(self)
        AbstractDesignMatrix.__init__(blk)  # fresh counters, no memo
        blk.device = device
        blk.X = self.X[r0:r1].to(device)
        return blk

    def column_pieces(self, c, device=None):
        """The stored columns (the intercept column and the centering
        in them) cut into at most `c` near-equal ranges at 16-byte units
        (4 float32 or 2 float64 columns) for the predictor axis of a 2-d
        mesh (:mod:`.pieces`); ``[WHOLE]`` where one range remains.
        `device` is not used: the pieces are slices."""
        unit = _ROW_ALIGN_BYTES // self.X.element_size()
        spans = [s for s in split_units(self._p, c, unit) if s[1] > s[0]]
        if len(spans) < 2:
            return [WHOLE]
        return [ColumnPiece(s, j == 0, slice(*s))
                for j, s in enumerate(spans)]

    def block(self, r0, r1, piece, device=None):
        """Rows r0:r1 of the stored columns of `piece` (of
        :meth:`column_pieces`) as a design of those columns on `device`:
        a copy, its rows whole 16-byte vectors; ``WHOLE`` gives
        :meth:`row_block`. A piece never fuses (a sharded dense design
        composes, the JAX dense design's ``_sharded``)."""
        if piece.spans is None:
            return self.row_block(r0, r1, device)
        c0, c1 = piece.spans
        blk = copy.copy(self)
        AbstractDesignMatrix.__init__(blk)  # fresh counters, no memo
        blk.device = self.device if device is None \
            else resolve_device(device)
        blk.fused_policy = '0'
        blk._p = c1 - c0
        blk.intercept_added = self.intercept_added and piece.first
        blk.X = torch.zeros((r1 - r0, stored_width(c1 - c0,
                                                   self.X.element_size())),
                            dtype=self.X.dtype, device=blk.device)
        blk.X[:, :c1 - c0] = self.X[r0:r1, c0:c1]
        return blk

    def to_dtype(self, dtype):
        """This design's stored X copied into another working dtype (a
        float64 design from a float32 one without preprocessing again)."""
        dtype = working_dtype(dtype)
        X = torch.zeros((self.X.shape[0], stored_width(
            self._p, torch.empty((), dtype=dtype).element_size())),
            dtype=dtype, device=self.device)
        X[:, :self._p] = self.X_main
        return DenseDesignMatrix(
            None, center_predictor=self.centered,
            add_intercept=self.intercept_added, fused=self.fused_policy,
            device=self.device, _stored=(X, self._p))

    # -- shape / metadata ------------------------------------------------ #

    @property
    def shape(self):
        return (self.X.shape[0], self._p)

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def is_sparse(self):
        return False

    @property
    def X_main(self):
        """The (n, p) view of the stored X that every product reads."""
        return self.X[:, :self._p]

    def storage_bytes(self):
        return self.X.numel() * self.X.element_size()

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- products -------------------------------------------------------- #

    def _chains_at_once(self, x):
        """True for k chains' rows (k, m) of a float64 design: one k-column
        product; a float32 design's chains run one at a time."""
        return x.dim() == 2 and self.dtype == torch.float64

    @memoized_dot
    def dot(self, v):
        """X v, or X v_c for each row of v (k, p): (k, n)."""
        v = self._as_tensor(v)
        if self._chains_at_once(v):
            self.dot_count += v.shape[0]
            return v @ self.X_main.T
        if v.dim() == 2:
            return per_chain(self.dot, v)
        self.dot_count += 1
        return self.X_main @ v

    def Tdot(self, u):
        """X' u, or X' u_c for each row of u (k, n): (k, p)."""
        u = self._as_tensor(u)
        if self._chains_at_once(u):
            self.Tdot_count += u.shape[0]
            return u @ self.X_main
        if u.dim() == 2:
            return per_chain(self.Tdot, u)
        self.Tdot_count += 1
        return self.X_main.T @ u

    def fused_ne_mode(self, kind='quad'):
        """True where the policy fuses the `kind` call site and the design
        is float32 (the kernels' type), else None: the composed path."""
        if dispatch_mode(kind, self.fused_policy) is None \
                or self.dtype != torch.float32:
            return None
        return True

    def _zero(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def quad_matvec(self, v, weight, return_t=False):
        """X' (weight * (X v)). Fused: one ``ne_sweep`` of the stored
        block with a zero row offset (the intercept and centering are in
        X), once per chain for k chains' rows. With `return_t`, or
        composed: `dot` then `Tdot`."""
        if return_t or self.fused_ne_mode('quad') is None:
            return super().quad_matvec(v, weight, return_t)
        v = self._as_tensor(v)
        if v.dim() == 2:
            return per_chain(self.quad_matvec, v, self._as_tensor(weight))
        outs, _, _ = ne_sweep([(self.X, v)], self._zero(),
                              None, self._as_tensor(weight), 'ne')
        self.dot_count += 1
        self.Tdot_count += 1
        return outs[0]

    def fused_link_grad(self, v, a, b, mid):
        """(loglik, gradient) of the GLM in one ``ne_sweep`` of the stored
        block (dense.py:134-151); None where the policy composes 'link'."""
        if self.fused_ne_mode('link') is None:
            return None
        outs, _, logp = ne_sweep(
            [(self.X, self._as_tensor(v))], self._zero(),
            self._as_tensor(a), self._as_tensor(b), mid, with_logp=True)
        self.dot_count += 1
        self.Tdot_count += 1
        return logp, outs[0]

    def has_presolve_reductions(self):
        return True

    def presolve_reductions(self, u1, u2, u3, u4=None):
        """(Tdot(u1), Tdot(u2), fisher_diag(u3)[, Tdot(u4)])
        (dense.py:153-192). Fused: one ``tdots_sweep`` read, `u4` as a
        separate `Tdot`. Composed: one multi-RHS product
        ``X' [u1 u2 u3 (u4)]`` in full float32 and the squared-column
        moment. For k chains' rows: fused, one ``tdots_sweep_k`` read;
        composed, per chain."""
        us = [self._as_tensor(u) for u in (u1, u2, u3)
              + ((u4,) if u4 is not None else ())]
        if us[0].dim() == 2:
            if self.fused_ne_mode('presolve') is None:
                return per_chain(self.presolve_reductions, *us)
            self.Tdot_count += 2 * us[0].shape[0]
            (o1, o2, _, sq), = tdots_sweep_k([self.X], [self._p], *us[:3])
            return (o1, o2, sq) if u4 is None \
                else (o1, o2, sq, self.Tdot(us[3]))
        self.Tdot_count += 2
        if self.fused_ne_mode('presolve') is not None:
            (o1, o2, _, sq), = tdots_sweep([self.X], [self._p], *us[:3])
            if u4 is None:
                return o1, o2, sq
            return o1, o2, sq, self.Tdot(us[3])
        with full_float32():
            R = self.X_main.T @ torch.stack(us, dim=1)
        sq = squared_col_moment(self.X_main, us[2])
        if u4 is None:
            return R[:, 0], R[:, 1], sq
        self.Tdot_count += 1
        return R[:, 0], R[:, 1], sq, R[:, 3]

    def compute_fisher_diag(self, weight):
        weight = self._as_tensor(weight)
        if weight.dim() == 2:
            return per_chain(self.compute_fisher_diag, weight)
        return squared_col_moment(self.X_main, weight)

    def compute_fisher_info(self, weight, diag_only=False):
        """X' W X (dense.py:194-202), or its diagonal: the Gram over row
        chunks (:func:`.gram.chunked_gram`), full float32 or float64."""
        weight = self._as_tensor(weight)
        if diag_only:
            return self.compute_fisher_diag(weight)
        if weight.dim() == 2:
            return per_chain(self.compute_fisher_info, weight)
        X = self.X_main
        return chunked_gram(lambda start, size: X[start:start + size],
                            X.shape[0], self._p, weight, self.dtype)[0]

    def compute_transposed_fisher_info(self, weight, include_intrcpt=False):
        """X diag(weight) X' where `weight` runs over predictors, the
        intercept's weight first with `include_intrcpt` (dense.py
        :204-218)."""
        weight = self._as_tensor(weight)
        X_main = self.X_main[:, 1:] if self.intercept_added else self.X_main
        weight_main = weight[1:] if include_intrcpt else weight
        with full_float32():
            result = (X_main * weight_main[None, :]) @ X_main.T
        if include_intrcpt:
            result = result + weight[0]
        return result

    def toarray(self):
        return self.X_main.cpu().numpy()

    def extract_matrix(self, order=None):
        """The stored (n, p) design on its device (dense.py:222-223)."""
        return self.X_main
