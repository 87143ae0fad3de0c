"""Sparse design matrix, hybrid backend (int8/bf16 exact block + f32
float block), for the fused-sweep data path.

Port of the hybrid part of ``bayesbridge_tpu/design/sparse.py``. At
typical OHDSI-style densities the bandwidth-optimal layout is dense,
split by column representability: the exactly representable columns
form one narrow block (int8 when every value is an integer in
[-127, 127], else bf16 over the bf16-exact set, whichever moves fewer
bytes), and the rest stay float32. The CG operator, the pre-solve
reductions and the GLM score each read the stored blocks through one
hand-written sweep (:mod:`bayesbridge_tpu_torch.kernels`); `dot` and
`Tdot` are plain PyTorch over row chunks.

Shared semantics with the JAX package (and the reference): centering is
a rank-1 ``column_offset`` correction, never materialized; the
intercept column is implicit.

What is not ported (each raises NotImplementedError): the bitpack,
winell and ell backends, the int4 tier (no int4 MMA on Hopper), a
float64 working dtype, and the composed 'auto' / '0' policies.
Blocks are stored with their column count padded to a multiple of 16
zero columns (``kernels.layout``), so every row is whole 16-byte vectors.
"""

import os

import numpy as np
import scipy.sparse as sps
import torch

from .abstract import AbstractDesignMatrix
from ..kernels import layout
from ..kernels.ne_sweep import ne_sweep
from ..kernels.tdots_sweep import tdots_sweep
from ..utils.dtypes import check_float32, resolve_device

# Hybrid blocks must fit comfortably in device memory next to everything
# else (sized for a 16 GB-HBM chip; re-deriving it for 80 GB is ROADMAP
# work).
_HYBRID_MAX_BYTES = float(os.environ.get('BB_HYBRID_MAX_BYTES', 8e9))
# Stored entries handled per vectorized densify step.
_DENSIFY_CHUNK = 2 ** 25

_COMPOSED = ("the composed path (fused='auto' or '0': multi-RHS "
             "pre-solve, block-ordered CG, in-loop linear predictor) is "
             "not ported yet; see ROADMAP.md Queue 1 item 11")


def resolve_fused_policy(fused):
    """The port's fused policy: None, 'full' and '1' all mean the fused
    sweeps (kernels on CUDA tensors, plain versions on CPU tensors)."""
    if fused is None or fused in ('full', '1'):
        return 'full'
    if fused in ('auto', '0'):
        raise NotImplementedError(f"fused={fused!r}: {_COMPOSED}")
    raise ValueError(f"unknown fused policy {fused!r}")


def _exact_column_mask(X_csr, bad_entry):
    """Columns of a CSR matrix none of whose stored entries is flagged
    `bad_entry` (empty columns qualify)."""
    p = X_csr.shape[1]
    return np.bincount(X_csr.indices[bad_entry], minlength=p) == 0


def _bf16_exact(data):
    """Entries that round-trip through bfloat16 exactly: representable
    in float32 with the low 16 mantissa bits zero."""
    f32 = data.astype(np.float32)
    return (f32.astype(np.float64) == data) \
        & ((f32.view(np.uint32) & 0xFFFF) == 0)


def _int8_exact(data):
    return (data == np.round(data)) & (np.abs(data) <= 127)


def _densify(X_csr, cols, np_dtype, width):
    """(n, width) row-major host block holding columns `cols` of X (in
    that order) and zeros elsewhere, written straight from the CSR
    entries in row order (no CSC copy, no float64 dense transient)."""
    n, p = X_csr.shape
    out = np.zeros((n, width), dtype=np_dtype)
    if len(cols) == 0 or X_csr.nnz == 0:
        return out
    pos = np.full(p, -1, dtype=np.int64)
    pos[cols] = np.arange(len(cols))
    indptr = X_csr.indptr
    row_nnz = np.diff(indptr)
    flat = out.reshape(-1)
    for s in range(0, X_csr.nnz, _DENSIFY_CHUNK):
        e = min(s + _DENSIFY_CHUNK, X_csr.nnz)
        # Rows r0..r1-1 hold entries [indptr[r0], indptr[r1]) which
        # cover [s, e); expand their row ids and cut to [s, e).
        r0 = np.searchsorted(indptr, s, side='right') - 1
        r1 = np.searchsorted(indptr, e, side='left')
        rows = np.repeat(np.arange(r0, r1), row_nnz[r0:r1])
        rows = rows[s - indptr[r0]:e - indptr[r0]]
        k = pos[X_csr.indices[s:e]]
        keep = k >= 0
        flat[rows[keep] * width + k[keep]] = \
            X_csr.data[s:e][keep].astype(np_dtype)
    return out


class SparseDesignMatrix(AbstractDesignMatrix):

    def __init__(self, X, center_predictor=False, add_intercept=True,
                 dtype=None, backend='auto', fused=None, device='cuda',
                 _parts=None):
        super().__init__()
        self.intercept_added = add_intercept
        self.centered = center_predictor
        self.fused_policy = resolve_fused_policy(fused)
        self.device = resolve_device(device)
        check_float32(dtype)
        self.backend = 'hybrid'
        if _parts is not None:  # convert.design_from_numpy
            self._set_parts(**_parts)
            return
        if backend not in ('auto', 'hybrid'):
            raise NotImplementedError(
                f"backend={backend!r}: only the hybrid backend is ported "
                "(ROADMAP.md Queue 1 item 12)")
        if not sps.issparse(X):
            raise NotImplementedError(
                "dense X: the dense design is not ported; pass a scipy "
                "sparse matrix")
        X = self.remove_intercept_indicator(X.tocsr()).tocsr()
        n, p = X.shape
        self._shape_main = (n, p)
        self._nnz = X.nnz
        data = X.data.astype(np.float64)
        if center_predictor:
            offsets = np.bincount(X.indices, weights=data, minlength=p) / n
        else:
            offsets = np.zeros(p)

        # Narrow-tier pick by stored bytes (sparse.py _build_hybrid,
        # without the int4 tier): ties go to int8.
        int8_mask = _exact_column_mask(X, ~_int8_exact(data))
        bf16_mask = _exact_column_mask(X, ~_bf16_exact(data))
        n_int8, n_bf16 = int(int8_mask.sum()), int(bf16_mask.sum())
        costs = {'int8': 1 * n_int8 + 4 * (p - n_int8),
                 'bf16': 2 * n_bf16 + 4 * (p - n_bf16)}
        pick = min(costs, key=costs.get)
        if backend == 'auto' and n * costs[pick] > _HYBRID_MAX_BYTES:
            raise NotImplementedError(
                "the hybrid blocks ({:.3g} GB) exceed the {:.3g} GB budget, "
                "where the JAX package picks a beyond-HBM backend "
                "(bitpack / winell / ell); those are not ported (ROADMAP.md "
                "Queue 1 item 12)".format(n * costs[pick] / 1e9,
                                          _HYBRID_MAX_BYTES / 1e9))
        exact_mask = int8_mask if pick == 'int8' else bf16_mask
        exact_cols = np.where(exact_mask)[0]
        float_cols = np.where(~exact_mask)[0]
        binary = bool(np.all((data == 0.0) | (data == 1.0)))
        if pick == 'int8':
            Xe = torch.from_numpy(_densify(
                X, exact_cols, np.int8, layout.padded_width(len(exact_cols))))
        else:
            # bf16 bits of bf16-exact values: the top half of their f32.
            bits = _densify(X, exact_cols, np.float32,
                            layout.padded_width(len(exact_cols)))
            Xe = torch.from_numpy(
                (bits.view(np.uint32) >> 16).astype(np.uint16)
                .view(np.int16)).view(torch.bfloat16)
            del bits
        Xf = torch.from_numpy(_densify(
            X, float_cols, np.float32, layout.padded_width(len(float_cols))))
        self._set_parts(Xe, Xf, exact_cols, float_cols, offsets,
                        (n, p), X.nnz, binary)

    def _set_parts(self, X_exact, X_float, exact_cols, float_cols,
                   column_offset, shape_main, nnz, exact_is_binary):
        dev = self.device
        self._shape_main = tuple(shape_main)
        self._nnz = nnz
        self.exact_is_binary = bool(exact_is_binary)
        self.X_exact = X_exact.to(dev)
        self.X_float = X_float.to(dev)
        self.exact_cols = torch.as_tensor(
            np.array(exact_cols, dtype=np.int64), device=dev)
        self.float_cols = torch.as_tensor(
            np.array(float_cols, dtype=np.int64), device=dev)
        self.n_exact = int(self.exact_cols.numel())
        self.n_float = int(self.float_cols.numel())
        self.column_offset = torch.as_tensor(
            np.array(column_offset, dtype=np.float64), dtype=torch.float32,
            device=dev)
        if self.fused_ne_mode() is None:
            raise NotImplementedError(
                "this design has no int8/bf16 exact column, so the JAX "
                "package runs it on " + _COMPOSED)

    # -- shape / metadata ------------------------------------------------ #

    @property
    def shape(self):
        n, p = self._shape_main
        return n, p + int(self.intercept_added)

    @property
    def is_sparse(self):
        return True

    @property
    def nnz(self):
        return self._nnz

    @property
    def dtype(self):
        return torch.float32

    def storage_bytes(self):
        """Device bytes of the stored blocks (one full sweep reads them
        all once)."""
        return sum(X.numel() * X.element_size()
                   for X in (self.X_exact, self.X_float))

    def fused_ne_mode(self, kind='quad'):
        """True where the fused sweeps serve this design (unsharded f32
        hybrid with an int8/bf16/f32 exact block; sparse.py:1039-1070
        without the sharding cases), else None."""
        if (self.backend != 'hybrid' or self.dtype != torch.float32
                or self.X_exact.dtype not in layout.DTYPE_CODE
                or self.n_exact == 0):
            return None
        return True

    # -- helpers --------------------------------------------------------- #

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _split(self, v):
        """(v0, v_main) with v0 the intercept coefficient (0 without)."""
        if self.intercept_added:
            return v[0], v[1:]
        return torch.zeros((), dtype=v.dtype, device=v.device), v

    def _blocks(self, v_main):
        """[(X_b, v_b)] of the non-empty stored blocks, exact first."""
        blocks = [(self.X_exact, v_main[self.exact_cols])]
        if self.n_float:
            blocks.append((self.X_float, v_main[self.float_cols]))
        return blocks

    def _stored(self):
        """[(X_b, p_b)] of the non-empty stored blocks, exact first."""
        out = [(self.X_exact, self.n_exact)]
        if self.n_float:
            out.append((self.X_float, self.n_float))
        return out

    def _assemble(self, parts):
        """Scatter per-block column results back to original order."""
        res = torch.zeros(self._shape_main[1], dtype=torch.float32,
                          device=self.device)
        res[self.exact_cols] = parts[0]
        if self.n_float:
            res[self.float_cols] = parts[1]
        return res

    def _with_intercept(self, s, main):
        if self.intercept_added:
            return torch.cat((s.reshape(1), main))
        return main

    # -- core products --------------------------------------------------- #

    def main_dot(self, v_main):
        """(X_main - 1 column_offset') @ v_main."""
        result = None
        for X, vb in self._blocks(v_main):
            part = layout.matvec(X, vb.shape[0], vb)
            result = part if result is None else result + part
        return result - self.column_offset @ v_main

    def main_Tdot(self, u):
        """(X_main - 1 column_offset')' @ u."""
        parts = [layout.rmatvec(X, p, u) for X, p in self._stored()]
        return self._assemble(parts) - u.sum() * self.column_offset

    def dot(self, v):
        v0, v_main = self._split(self._as_tensor(v))
        self.dot_count += 1
        return self.main_dot(v_main) + v0

    def Tdot(self, u):
        u = self._as_tensor(u)
        result = self._with_intercept(u.sum(), self.main_Tdot(u))
        self.Tdot_count += 1
        return result

    def quad_matvec(self, v, weight):
        """X' (weight * (X v)): the CG operator's design part in one
        fused sweep of the stored blocks (sparse.py:1108-1174); the
        intercept and centering fold into the sweep's row offset
        c = v0 - offset . v_main and into u = weight * (X v)."""
        v, weight = self._as_tensor(v), self._as_tensor(weight)
        v0, v_main = self._split(v)
        c = v0 - self.column_offset @ v_main
        outs, u, _ = ne_sweep(self._blocks(v_main), c, None, weight, 'ne')
        sum_u = u.sum()
        result = self._assemble(outs) - sum_u * self.column_offset
        self.dot_count += 1
        self.Tdot_count += 1
        return self._with_intercept(sum_u, result)

    def fused_link_grad(self, v, a, b, mid):
        """(loglik, gradient) of the GLM in one sweep: the `mid` link
        score u of t = X v, its loglik rows summed, and X' u
        (sparse.py:1258-1317)."""
        v = self._as_tensor(v)
        a, b = self._as_tensor(a), self._as_tensor(b)
        v0, v_main = self._split(v)
        c = v0 - self.column_offset @ v_main
        outs, u, logp = ne_sweep(self._blocks(v_main), c, a, b, mid,
                                 with_logp=True)
        sum_u = u.sum()
        grad = self._assemble(outs) - sum_u * self.column_offset
        self.dot_count += 1
        self.Tdot_count += 1
        return logp, self._with_intercept(sum_u, grad)

    def presolve_reductions(self, u1, u2, u3, u4=None):
        """(Tdot(u1), Tdot(u2), fisher_diag(u3)[, Tdot(u4)]): one fused
        sweep of the blocks for the first three (sparse.py:1390-1464);
        `u4` composes as a separate Tdot, the sweep's reduction set
        being fixed at four."""
        u1, u2, u3 = (self._as_tensor(u) for u in (u1, u2, u3))
        stored = self._stored()
        outs = tdots_sweep([X for X, _ in stored], [p for _, p in stored],
                           u1, u2, u3)
        sums = [u.sum() for u in (u1, u2, u3)]

        def assemble(idx):
            return self._assemble([blk[idx] for blk in outs])

        v = assemble(0) - sums[0] * self.column_offset
        pert = assemble(1) - sums[1] * self.column_offset
        diag = assemble(3)
        if self.centered:
            wcol = assemble(2)  # raw X' u3 per main column (no offset)
            diag = diag - 2.0 * self.column_offset * wcol
            diag = diag + sums[2] * self.column_offset ** 2
        v = self._with_intercept(sums[0], v)
        pert = self._with_intercept(sums[1], pert)
        diag = self._with_intercept(sums[2], diag)
        self.Tdot_count += 2
        if u4 is None:
            return v, pert, diag
        return v, pert, diag, self.Tdot(u4)

    # -- densification (small designs: tests, diagnostics) ---------------- #

    def toarray(self):
        """Dense numpy copy of the full design (intercept and centering
        included)."""
        n, p = self._shape_main
        X = np.zeros((n, p), np.float32)
        for (blk, k), cols in zip(self._stored(),
                                  (self.exact_cols, self.float_cols)):
            X[:, cols.cpu().numpy()] = blk[:, :k].float().cpu().numpy()
        if self.centered:
            X = X - self.column_offset.cpu().numpy()[None, :]
        if self.intercept_added:
            X = np.hstack((np.ones((n, 1), np.float32), X))
        return X
