"""Sparse design matrix: the hybrid, bitpack and winell backends.

Port of ``bayesbridge_tpu/design/sparse.py`` (unsharded, float32).

``hybrid``
    Dense blocks split by column representability: the exactly
    representable columns form one narrow block (int8 when every value
    is an integer in [-127, 127], else bf16 over the bf16-exact set,
    whichever moves fewer bytes), the rest stay float32. `dot` is the row
    pass of :mod:`..kernels.ne_sweep` (``ne_rows``), `Tdot` its column
    pass (``colpass``), the pre-solve reductions and the Fisher diagonal
    one :mod:`..kernels.tdots_sweep` read. The `fused` policy
    (:mod:`.fusedne`, default 'auto') decides per call site whether the
    CG operator, the pre-solve and the GLM score run composed
    (block-ordered CG, the warm start folded into the pre-solve, the
    linear predictor from the CG loop) or as one fused sweep each; the
    fused CG operator reads X once on the card
    (:mod:`..kernels.ne_oneread`, through ``ne_sweep``'s 'ne' mode).
    Blocks are stored with their column count padded to a multiple of
    16 zero columns (``kernels.layout``).
``bitpack``
    Beyond the hybrid budget, for mostly 0/1 designs: the binary columns
    as a dual bitmap, one bit per element in each orientation
    (:mod:`.bitlut`), multiplied by the byte-LUT kernel
    (:mod:`..kernels.bitlut`); the other columns ride in a dense float32
    side block.
``winell``
    Beyond the hybrid budget, for general-valued designs. The device
    holds a dual windowed CSR (:mod:`.wincsr`, every nonzero in its
    place, no spill) multiplied by the wincsr kernel
    (:mod:`..kernels.wincsr`). The JAX package's dual windowed-ELL
    packing with its plain-ELL spill (:mod:`.winell`) is planned
    alongside and packed only on demand (``winell_packing``); a JAX
    design's packing carries across into the windowed CSR.

The fused sweeps serve the hybrid backend only; the other two run the
composed path (`quad_matvec` = `dot` then `Tdot`, the pre-solve as
separate `Tdot`s and the Fisher diagonal), whatever `fused` says, as in
the JAX package; so does a hybrid design without an exact column.
``backend='auto'`` applies the JAX package's float32 rule and budgets, so
the same design picks the same backend in both.

Shared semantics with the JAX package (and the reference): centering is
a rank-1 ``column_offset`` correction, never materialized; the
intercept column is implicit.

Not ported (each raises NotImplementedError): the ell backend, the int4
tier (no int4 MMA on Hopper), a float64 working dtype and the dense
Fisher information (Cholesky path).
"""

import copy
import os
import time

import numpy as np
import scipy.sparse as sps
import torch

from . import bitlut as bitlut_mod
from . import wincsr as wincsr_mod
from . import winell as winell_mod
from .abstract import AbstractDesignMatrix
from .fusedne import POLICIES, dispatch_mode
from ..kernels import layout
from ..kernels.bitlut import bitlut
from ..kernels.ne_sweep import colpass, ne_rows, ne_sweep
from ..kernels.tdots_sweep import tdots_sweep
from ..kernels.wincsr import wincsr
from ..utils.dtypes import check_float32, resolve_device

# Budgets of the JAX package's auto rule (sized for a 16 GB-HBM chip;
# re-deriving them for 80 GB is ROADMAP work). Hybrid blocks, and then
# the dual bitmaps or windowed-ELL packings, must fit in these.
_HYBRID_MAX_BYTES = float(os.environ.get('BB_HYBRID_MAX_BYTES', 8e9))
_BITPACK_MAX_BYTES = float(os.environ.get('BB_BITPACK_MAX_BYTES', 8e9))
# Minimum share of binary columns for the bitpack backend to pay off.
_BITPACK_MIN_BINARY_FRAC = 0.5
# Stored entries handled per vectorized densify step.
_DENSIFY_CHUNK = 2 ** 25

# The arrays each packed backend stores, by the JAX design's names
# (``convert.packed_design_from_numpy`` takes them so).
PACKED_ARRAYS = {
    'bitpack': ('bits_col', 'bits_row', 'X_float', 'bin_cols',
                'float_cols'),
    'winell': ('widx_dot', 'wval_dot', 'widx_tdot', 'wval_tdot', 'sd_idx',
               'sd_val', 'st_idx', 'st_val'),
}


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


def choose_backend(X_csr, int8_mask, bf16_mask, binary_mask):
    """The JAX package's ``backend='auto'`` rule for float32
    (sparse.py:327-386, without the int4 tier): hybrid while its blocks
    fit the budget, then bitpack for mostly-binary designs, then winell
    while its slots fill sanely, then the least bad of hybrid and ell."""
    n, p = X_csr.shape
    nnz = X_csr.nnz

    def frac(mask):
        return float(np.mean(mask)) if p else 1.0

    int8_frac, exact_frac = frac(int8_mask), frac(bf16_mask)
    binary_frac = frac(binary_mask)
    per_elem = min(int8_frac * 1 + (1 - int8_frac) * 4,
                   exact_frac * 2 + (1 - exact_frac) * 4)
    hybrid_bytes = n * p * per_elem
    ell_bytes = 2 * nnz * (4 + 4)
    bitpack_bytes = n * p * binary_frac / 4.0 \
        + n * p * (1 - binary_frac) * 4
    winell_bytes = winell_mod.estimate_bytes(X_csr.shape, nnz)
    w_est, k_est = winell_mod.plan_windows(p, n, nnz)
    winell_ok = w_est * nnz <= 0.75 * k_est * max(1, n * p)
    if hybrid_bytes <= _HYBRID_MAX_BYTES:
        return 'hybrid'
    if binary_frac >= _BITPACK_MIN_BINARY_FRAC \
            and bitpack_bytes <= _BITPACK_MAX_BYTES:
        return 'bitpack'
    if winell_bytes <= _BITPACK_MAX_BYTES and winell_ok:
        return 'winell'
    return 'hybrid' if hybrid_bytes <= ell_bytes else 'ell'


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
        self.device = resolve_device(device)
        # Host seconds of the build's main steps, for the record.
        self.build_seconds = {}
        check_float32(dtype)
        if fused not in POLICIES:
            raise ValueError(f"unknown fused policy {fused!r}")
        # The hybrid backend's fused-sweep policy (.fusedne); the packed
        # backends always compose (sparse.py:1049).
        self.fused_policy = fused
        if _parts is not None:  # convert.*_from_numpy
            parts = dict(_parts)
            self._set_backend(parts.pop('backend'))
            getattr(self, '_set_' + self.backend)(**parts)
            return
        if not sps.issparse(X):
            raise NotImplementedError(
                "dense X: the dense design is not ported; pass a scipy "
                "sparse matrix")
        X = self.remove_intercept_indicator(X.tocsr()).tocsr()
        n, p = X.shape
        data = np.asarray(X.data, dtype=np.float64)
        if center_predictor:
            offsets = np.bincount(X.indices, weights=data, minlength=p) / n
        else:
            offsets = np.zeros(p)
        masks = {}
        if backend in ('auto', 'hybrid'):
            masks['int8'] = _exact_column_mask(X, ~_int8_exact(data))
            masks['bf16'] = _exact_column_mask(X, ~_bf16_exact(data))
        if backend in ('auto', 'bitpack'):
            masks['binary'] = _exact_column_mask(X, data != 1.0)
        if backend == 'auto':
            backend = choose_backend(X, masks['int8'], masks['bf16'],
                                     masks['binary'])
        self._set_backend(backend)
        if backend == 'hybrid':
            self._build_hybrid(X, data, offsets, masks['int8'],
                               masks['bf16'])
        elif backend == 'bitpack':
            self._build_bitpack(X, offsets, masks['binary'])
        else:
            self._build_winell(X, offsets)

    def with_policy(self, fused):
        """This design's stored arrays (shared, not copied) under another
        fused policy, with its matvec counters at zero: one densified
        design serves both the fused and the composed path."""
        if fused not in POLICIES:
            raise ValueError(f"unknown fused policy {fused!r}")
        other = copy.copy(self)
        other.fused_policy = fused
        other.dot_count = other.Tdot_count = 0
        return other

    def _set_backend(self, backend):
        if backend == 'ell':
            raise NotImplementedError(
                "backend='ell': the dual-ELL backend is not ported "
                "(ROADMAP.md Queue 1 item 12)")
        if backend not in ('hybrid', 'bitpack', 'winell'):
            raise ValueError(f"Unknown backend '{backend}'")
        self.backend = backend

    # -- construction ---------------------------------------------------- #

    def _build_hybrid(self, X, data, offsets, int8_mask, bf16_mask):
        """Narrow-tier pick by stored bytes (sparse.py _build_hybrid,
        without the int4 tier): ties go to int8."""
        n, p = X.shape
        n_int8, n_bf16 = int(int8_mask.sum()), int(bf16_mask.sum())
        costs = {'int8': 1 * n_int8 + 4 * (p - n_int8),
                 'bf16': 2 * n_bf16 + 4 * (p - n_bf16)}
        pick = min(costs, key=costs.get)
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
        self._set_hybrid(Xe, Xf, exact_cols, float_cols, offsets,
                         (n, p), X.nnz, binary)

    def _build_bitpack(self, X, offsets, binary_mask):
        """Dual bitmap over the 0/1 columns, packed vectorized from the
        CSR (sparse.py:499-549), plus a dense float32 block for the
        rest."""
        n, p = X.shape
        bin_cols = np.where(binary_mask)[0]
        float_cols = np.where(~binary_mask)[0]
        p_bin = len(bin_cols)
        if p_bin == 0 and p > 0:
            raise ValueError(
                "backend='bitpack' requires at least one exactly-0/1 "
                "column (the bitmap kernel stores one bit per element); "
                "this design has none. Use backend='hybrid' or 'winell' "
                "instead.")
        gcol_pad, n_pad, k_dot = bitlut_mod.plan_blocks(p_bin, n)
        grow_pad, pbin_pad, k_tdot = bitlut_mod.plan_blocks(n, p_bin)
        t0 = time.perf_counter()
        bits_col, bits_row = bitlut_mod.pack_csr_bitmaps(
            X, bin_cols, (gcol_pad, n_pad), (grow_pad, pbin_pad))
        t1 = time.perf_counter()
        X_float = _densify(X, float_cols, np.float32, len(float_cols))
        self.build_seconds.update(pack=t1 - t0,
                                  float_block=time.perf_counter() - t1)
        self._set_bitpack(
            bits_col, bits_row, X_float, bin_cols, float_cols, offsets,
            (n, p), X.nnz,
            (p_bin, gcol_pad, n_pad, k_dot, grow_pad, pbin_pad, k_tdot))

    def _build_winell(self, X, offsets):
        """The windowed CSR of both orientations, and the JAX design's
        windowed-ELL plan (window width, slot depth, whether it spills)
        for each (sparse.py:551-593), whose packing
        :meth:`winell_packing` builds on demand."""
        n, p = X.shape
        nnz = X.nnz
        t0 = time.perf_counter()
        X = X.copy()
        X.eliminate_zeros()  # occupancy == (value != 0)
        X.sort_indices()
        w_dot, k_dot = winell_mod.plan_windows(p, n, X.nnz)
        w_tdot, k_tdot = winell_mod.plan_windows(n, p, X.nnz)
        has_st = winell_mod.spills(X.T.tocsr(), w_tdot, k_tdot)
        meta = (w_dot, k_dot, w_tdot, k_tdot,
                winell_mod.spills(X, w_dot, k_dot), has_st)
        self._set_wincsr(offsets, (n, p), nnz, meta, X)
        self.build_seconds['wincsr'] = time.perf_counter() - t0

    def _set_common(self, column_offset, shape_main, nnz):
        self._shape_main = tuple(shape_main)
        self._nnz = nnz
        self.column_offset = torch.as_tensor(
            np.array(column_offset, dtype=np.float64), dtype=torch.float32,
            device=self.device)

    def _dev(self, a, dtype=None):
        """A host array as a contiguous tensor on the design's device
        (read-only arrays, such as views of jax arrays, are copied)."""
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        t = torch.as_tensor(a)
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def _set_hybrid(self, X_exact, X_float, exact_cols, float_cols,
                    column_offset, shape_main, nnz, exact_is_binary):
        self._set_common(column_offset, shape_main, nnz)
        self.exact_is_binary = bool(exact_is_binary)
        self.X_exact = X_exact.to(self.device)
        self.X_float = X_float.to(self.device)
        self.exact_cols = self._dev(exact_cols, torch.int64)
        self.float_cols = self._dev(float_cols, torch.int64)
        self.n_exact = int(self.exact_cols.numel())
        self.n_float = int(self.float_cols.numel())

    def _set_bitpack(self, bits_col, bits_row, X_float, bin_cols,
                     float_cols, column_offset, shape_main, nnz, meta):
        """`meta` = (p_bin, gcol_pad, n_pad, k_dot, grow_pad, pbin_pad,
        k_tdot), the JAX design's ``_bitpack_meta`` (a trailing interpret
        flag is ignored)."""
        self._set_common(column_offset, shape_main, nnz)
        self.exact_is_binary = True
        self._bitpack_meta = tuple(int(m) for m in meta[:7])
        self.bits_col = self._dev(bits_col, torch.uint8)
        self.bits_row = self._dev(bits_row, torch.uint8)
        self.bin_cols = self._dev(bin_cols, torch.int64)
        self.float_cols = self._dev(float_cols, torch.int64)
        self.n_float = int(self.float_cols.numel())
        self.X_float = self._dev(
            np.asarray(X_float, np.float32)[:shape_main[0], :self.n_float])

    def _set_winell(self, widx_dot, wval_dot, widx_tdot, wval_tdot, sd_idx,
                    sd_val, st_idx, st_val, column_offset, shape_main, nnz,
                    meta):
        """A design from the JAX design's windowed-ELL arrays: the row
        packing and its spill encode X exactly, and give the windowed
        CSR. `meta` = (w_dot, k_dot, w_tdot, k_tdot, has_sd, has_st), the
        JAX design's ``_winell_meta`` (a trailing interpret flag is
        ignored)."""
        X_csr = wincsr_mod.csr_from_winell(widx_dot, wval_dot, sd_idx,
                                           sd_val, shape_main, *meta[:2])
        self._set_wincsr(column_offset, shape_main, nnz, meta, X_csr)

    def _set_wincsr(self, column_offset, shape_main, nnz, meta, X_csr):
        """The device's windowed CSR of both orientations from `X_csr`
        (the main design, explicit zeros eliminated)."""
        self._set_common(column_offset, shape_main, nnz)
        self.exact_is_binary = False
        w_dot, k_dot, w_tdot, k_tdot, has_sd, has_st = meta[:6]
        self._winell_meta = (int(w_dot), int(k_dot), int(w_tdot),
                             int(k_tdot), bool(has_sd), bool(has_st))
        X_csr = sps.csr_matrix(X_csr)
        self.wc_dot = wincsr_mod.build_wincsr(X_csr).to(self.device)
        self.wc_tdot = wincsr_mod.build_wincsr(
            X_csr.T.tocsr()).to(self.device)

    def winell_packing(self):
        """The JAX package's windowed-ELL arrays of this winell design (by
        the names of ``PACKED_ARRAYS['winell']``, numpy, element for
        element the JAX design's), packed on the host from the stored
        layout: the design keeps only the windowed CSR."""
        X = self.wc_dot.to_scipy()
        X.sort_indices()
        return winell_mod.pack_dual(X, *self._winell_meta[:4])

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
        """The working dtype: float32 on every backend (the port's only
        one; sparse.py:829-844 reads it off the stored arrays)."""
        return torch.float32

    def _stored_tensors(self):
        if self.backend == 'hybrid':
            return (self.X_exact, self.X_float)
        if self.backend == 'bitpack':
            return (self.bits_col, self.bits_row, self.X_float)
        return self.wc_dot.tensors() + self.wc_tdot.tensors()

    def storage_bytes(self):
        """Device bytes of the stored design arrays."""
        return sum(X.numel() * X.element_size()
                   for X in self._stored_tensors())

    def fused_ne_mode(self, kind='quad'):
        """True where the fused sweep serves the `kind` call site ('quad'
        | 'presolve' | 'link') of this design: the policy fuses the kind
        (.fusedne.dispatch_mode) and the design is an f32 hybrid with an
        int8/bf16/f32 exact block (sparse.py:1039-1070 without the
        sharding cases); else None, the composed path."""
        if (dispatch_mode(kind, self.fused_policy) is None
                or self.backend != 'hybrid' or self.dtype != torch.float32
                or self.X_exact.dtype not in layout.DTYPE_CODE
                or self.n_exact == 0):
            return None
        return True

    def has_presolve_reductions(self):
        """The hybrid backend serves the batched pre-solve (one
        `tdots_sweep` read, with the warm-start column on the composed
        path) wherever it has an exact column (sparse.py:1319-1323); the
        other backends compose per reduction."""
        return self.backend == 'hybrid' and self.n_exact > 0

    # -- helpers --------------------------------------------------------- #

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _split(self, v):
        """(v0, v_main) with v0 the intercept coefficient (0 without)."""
        if self.intercept_added:
            return v[0], v[1:]
        return torch.zeros((), dtype=v.dtype, device=v.device), v

    def _block_cols(self):
        """Original column indices of each non-empty block, in block
        order: exact (or binary) columns, then float columns."""
        if self.backend == 'hybrid':
            first = [self.exact_cols] if self.n_exact else []
        else:
            first = [self.bin_cols]
        return first + ([self.float_cols] if self.n_float else [])

    def _blocks(self, v_main):
        """[(X_b, v_b)] of the non-empty hybrid blocks, exact first."""
        return [(X, v_main[cols]) for (X, _), cols
                in zip(self._stored(), self._block_cols())]

    def _stored(self):
        """[(X_b, p_b)] of the non-empty hybrid blocks, exact first."""
        out = [(self.X_exact, self.n_exact)] if self.n_exact else []
        if self.n_float:
            out.append((self.X_float, self.n_float))
        return out

    def _assemble(self, parts):
        """Scatter per-block column results back to original order."""
        res = torch.zeros(self._shape_main[1], dtype=torch.float32,
                          device=self.device)
        for cols, part in zip(self._block_cols(), parts):
            res[cols] = part
        return res

    def _with_intercept(self, s, main):
        if self.intercept_added:
            return torch.cat((s.reshape(1), main))
        return main

    # -- the packed backends' products ------------------------------------ #

    def _bitpack_dot_bin(self, v_bin):
        """Binary-column part of X v: the bitlut kernel on bits_col."""
        p_bin, gcol_pad = self._bitpack_meta[:2]
        v_pad = torch.zeros(8 * gcol_pad, dtype=torch.float32,
                            device=self.device)
        v_pad[:p_bin] = v_bin
        return bitlut(self.bits_col, v_pad, self._shape_main[0], 'dot')

    def _bitpack_tdot_bin(self, u):
        """Binary-column part of X' u: the bitlut kernel on bits_row."""
        p_bin, grow_pad = self._bitpack_meta[0], self._bitpack_meta[4]
        u_pad = torch.zeros(8 * grow_pad, dtype=torch.float32,
                            device=self.device)
        u_pad[:u.shape[0]] = u
        return bitlut(self.bits_row, u_pad, p_bin, 'tdot')

    def _winell_dot_main(self, v_main):
        return wincsr(self.wc_dot, v_main, tag='dot')

    def _winell_tdot_main(self, u, power=1):
        return wincsr(self.wc_tdot, u, square=power == 2, tag='tdot')

    # -- core products --------------------------------------------------- #

    def _hybrid_Xs(self):
        stored = self._stored()
        return [X for X, _ in stored], [p for _, p in stored]

    def main_dot(self, v_main):
        """(X_main - 1 column_offset') @ v_main. Hybrid: the row pass
        (``ne_rows``), the centering folded into its row offset."""
        if self.backend == 'hybrid':
            return ne_rows(self._blocks(v_main),
                           -(self.column_offset @ v_main))
        if self.backend == 'bitpack':
            result = self._bitpack_dot_bin(v_main[self.bin_cols])
            if self.n_float:
                result = result + layout.matvec(
                    self.X_float, self.n_float, v_main[self.float_cols])
        else:
            result = self._winell_dot_main(v_main)
        return result - self.column_offset @ v_main

    def main_Tdot(self, u):
        """(X_main - 1 column_offset')' @ u. Hybrid: the column pass
        (``colpass``)."""
        if self.backend == 'hybrid':
            raw = self._assemble(colpass(*self._hybrid_Xs(), u))
        else:
            raw = self._weighted_col_moments(u, 1)
        return raw - u.sum() * self.column_offset

    def dot(self, v):
        v0, v_main = self._split(self._as_tensor(v))
        self.dot_count += 1
        return self.main_dot(v_main) + v0

    def Tdot(self, u):
        u = self._as_tensor(u)
        result = self._with_intercept(u.sum(), self.main_Tdot(u))
        self.Tdot_count += 1
        return result

    def quad_matvec(self, v, weight, return_t=False):
        """X' (weight * (X v)): the CG operator's design part. Where the
        policy fuses 'quad', one ``ne_sweep`` of the hybrid blocks
        (sparse.py:1108-1174; the intercept and centering fold into the
        sweep's row offset c = v0 - offset . v_main and into u = weight *
        (X v)); elsewhere, or with `return_t`, `dot` then `Tdot`."""
        weight = self._as_tensor(weight)
        if return_t or self.fused_ne_mode('quad') is None:
            return super().quad_matvec(v, weight, return_t)
        v = self._as_tensor(v)
        v0, v_main = self._split(v)
        c = v0 - self.column_offset @ v_main
        outs, u, _ = ne_sweep(self._blocks(v_main), c, None, weight, 'ne')
        sum_u = u.sum()
        result = self._assemble(outs) - sum_u * self.column_offset
        self.dot_count += 1
        self.Tdot_count += 1
        return self._with_intercept(sum_u, result)

    # -- block-ordered CG data path (sparse.py:1176-1256) ----------------- #

    def cg_blockorder_ctx(self):
        """(perm, unperm, offset_bo) for a block-ordered CG solve, or None
        where inapplicable (not hybrid, or a fused CG operator).

        The hybrid backend stores its columns split by dtype, so every
        composed operator application would gather its operand into block
        order and scatter the result back. CG is permutation-equivariant,
        so the solver instead conjugates the whole solve by the block
        permutation: operands reorder once at entry, and
        `quad_matvec_blockorder` splits them by slices. `perm` maps block
        order to original positions, `unperm` inverts it, `offset_bo` is
        the centering offset in block order."""
        if self.backend != 'hybrid' \
                or self.fused_ne_mode('quad') is not None:
            return None
        return self._blockorder_perm()

    def _blockorder_perm(self):
        perm_main = torch.cat((self.exact_cols, self.float_cols))
        offset_bo = self.column_offset[perm_main]
        if self.intercept_added:
            perm = torch.cat((torch.zeros(1, dtype=perm_main.dtype,
                                          device=self.device),
                              perm_main + 1))
        else:
            perm = perm_main
        unperm = torch.empty_like(perm)
        unperm[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=self.device)
        return perm, unperm, offset_bo

    def quad_matvec_blockorder(self, v_bo, weight, offset_bo,
                               return_t=False):
        """`quad_matvec` on a block-ordered operand: out_bo with
        out_bo[unperm] == quad_matvec(v_bo[unperm], weight), as the row
        pass and then the column pass over slices of the operand. With
        `return_t` also the row pass's ``t = X v`` (observation order),
        from which the CG loop accumulates the draw's linear
        predictor."""
        v_bo = self._as_tensor(v_bo)
        weight = self._as_tensor(weight)
        v0, v_main_bo = self._split(v_bo)
        pe = self.n_exact
        parts = (v_main_bo[:pe], v_main_bo[pe:])
        blocks = [(X, vb) for (X, _), vb
                  in zip(self._stored(), parts[0 if pe else 1:])]
        t = ne_rows(blocks, v0 - offset_bo @ v_main_bo)
        u = weight * t
        sum_u = u.sum()
        main = torch.cat(colpass([X for X, _ in blocks],
                                 [vb.shape[0] for _, vb in blocks], u))
        main = main - sum_u * offset_bo
        self.dot_count += 1
        self.Tdot_count += 1
        out = self._with_intercept(sum_u, main)
        return (out, t) if return_t else out

    def fused_link_grad(self, v, a, b, mid):
        """(loglik, gradient) of the GLM in one sweep of the hybrid
        blocks: the `mid` link score u of t = X v, its loglik rows summed,
        and X' u (sparse.py:1258-1317). None where the policy composes
        'link' and on the packed backends: the model composes dot and
        Tdot."""
        if self.fused_ne_mode('link') is None:
            return None
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
        """(Tdot(u1), Tdot(u2), fisher_diag(u3)[, Tdot(u4)]) from one
        ``tdots_sweep`` read of the hybrid blocks (sparse.py:1390-1464).
        Composed 'presolve' (the JAX package's multi-RHS pre-solve,
        sparse.py:1325-1388): `u4` rides the same read as a fifth
        reduction. Fused: `u4` composes as a separate Tdot, the fused
        sweep's reduction set being fixed at four. The squared moment is
        computed from the loaded values, for 0/1 blocks too (where it
        equals X'u3)."""
        u1, u2, u3 = (self._as_tensor(u) for u in (u1, u2, u3))
        fused = self.fused_ne_mode('presolve') is not None
        fold = u4 is not None and not fused
        if u4 is not None:
            u4 = self._as_tensor(u4)
        outs = tdots_sweep(*self._hybrid_Xs(), u1, u2, u3,
                           u4 if fold else None)
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
        if not fold:
            return v, pert, diag, self.Tdot(u4)
        sum4 = u4.sum()
        tdot4 = self._with_intercept(
            sum4, assemble(4) - sum4 * self.column_offset)
        self.Tdot_count += 1
        return v, pert, diag, tdot4

    # -- Fisher information ---------------------------------------------- #

    def _weighted_col_moments(self, weight, power):
        """sum_i weight_i * X_ij^power per main column j, uncentered, on
        the packed backends (sparse.py:1490-1508). 0/1 bits are
        idempotent under powers, so the bitmaps serve both moments as
        X' w; the float side block squares in row chunks, never as a
        whole-block transient."""
        if self.backend == 'winell':
            return self._winell_tdot_main(weight, power=power)
        parts = [self._bitpack_tdot_bin(weight)]
        if self.n_float:
            parts.append(layout.rmatvec(self.X_float, self.n_float, weight,
                                        square=power == 2))
        return self._assemble(parts)

    def compute_fisher_diag(self, weight):
        """diag(X' W X) with centering/intercept corrections
        (sparse.py:1539-1550). Hybrid: both column moments from one
        ``tdots_sweep`` read."""
        weight = self._as_tensor(weight)
        if self.backend == 'hybrid':
            outs = tdots_sweep(*self._hybrid_Xs(), weight, weight, weight)
            diag = self._assemble([blk[3] for blk in outs])
            col_sum = self._assemble([blk[2] for blk in outs])
        else:
            diag = self._weighted_col_moments(weight, 2)
            col_sum = self._weighted_col_moments(weight, 1) \
                if self.centered else None
        if self.centered:
            diag = diag - 2.0 * self.column_offset * col_sum
            diag = diag + weight.sum() * self.column_offset ** 2
        return self._with_intercept(weight.sum(), diag)

    # -- densification (small designs: tests, diagnostics) ---------------- #

    def _densify_main(self):
        """(n, p) float32 CPU tensor of the stored main design, uncentered
        (sparse.py:1691-1752)."""
        n, p = self._shape_main
        X = torch.zeros((n, p), dtype=torch.float32)
        if self.backend == 'hybrid':
            for (blk, k), cols in zip(self._stored(), self._block_cols()):
                X[:, cols.cpu()] = blk[:, :k].float().cpu()
            return X
        if self.backend == 'bitpack':
            p_bin = self._bitpack_meta[0]
            if p_bin:
                groups = -(-p_bin // 8)
                bytes_gn = self.bits_col[:groups, :n].cpu().to(torch.int32)
                bits = (bytes_gn[:, :, None] >> torch.arange(8)) & 1
                X_bin = bits.permute(1, 0, 2).reshape(n, 8 * groups)
                X[:, self.bin_cols.cpu()] = X_bin[:, :p_bin].float()
            if self.n_float:
                X[:, self.float_cols.cpu()] = self.X_float.cpu()
            return X
        X[:] = torch.from_numpy(self.wc_dot.to_scipy().toarray())
        return X

    def toarray(self):
        """Dense numpy copy of the full design (intercept and centering
        included)."""
        X = self._densify_main().numpy()
        if self.centered:
            X = X - self.column_offset.cpu().numpy()[None, :]
        if self.intercept_added:
            X = np.hstack((np.ones((X.shape[0], 1), np.float32), X))
        return X
