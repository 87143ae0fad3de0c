"""Sparse design matrix: the hybrid, bitpack and winell backends.

Port of ``bayesbridge_tpu/design/sparse.py`` (unsharded, float32).

``hybrid``
    Dense blocks split by column representability: the exactly
    representable columns form one narrow block (int8 when every value
    is an integer in [-127, 127], else bf16 over the bf16-exact set,
    whichever moves fewer bytes), the rest stay float32. The CG operator,
    the pre-solve reductions and the GLM score each read the stored
    blocks through one hand-written sweep (:mod:`..kernels.ne_sweep`,
    :mod:`..kernels.tdots_sweep`); `dot` and `Tdot` are plain PyTorch
    over row chunks. Blocks are stored with their column count padded to
    a multiple of 16 zero columns (``kernels.layout``).
``bitpack``
    Beyond the hybrid budget, for mostly 0/1 designs: the binary columns
    as a dual bitmap, one bit per element in each orientation
    (:mod:`.bitlut`), multiplied by the byte-LUT kernel
    (:mod:`..kernels.bitlut`); the other columns ride in a dense float32
    side block.
``winell``
    Beyond the hybrid budget, for general-valued designs: a dual
    windowed-ELL packing (:mod:`.winell`) multiplied by the winell kernel
    (:mod:`..kernels.winell`), with small plain-ELL spill matrices for
    overfull cells (a torch gather).

The fused sweeps serve the hybrid backend only; the other two run the
composed path (`quad_matvec` = `dot` then `Tdot`, the pre-solve as
separate `Tdot`s and the Fisher diagonal), whatever `fused` says, as in
the JAX package. ``backend='auto'`` applies the JAX package's float32
rule and budgets, so the same design picks the same backend in both.

Shared semantics with the JAX package (and the reference): centering is
a rank-1 ``column_offset`` correction, never materialized; the
intercept column is implicit.

Not ported (each raises NotImplementedError): the ell backend, the int4
tier (no int4 MMA on Hopper), a float64 working dtype, the composed
'auto' / '0' policies on the hybrid backend, and the dense Fisher
information (Cholesky path).
"""

import os
import time

import numpy as np
import scipy.sparse as sps
import torch

from . import bitlut as bitlut_mod
from . import winell as winell_mod
from .abstract import AbstractDesignMatrix
from .ell import csr_to_ell
from ..kernels import layout
from ..kernels.bitlut import bitlut
from ..kernels.ne_sweep import ne_sweep
from ..kernels.tdots_sweep import tdots_sweep
from ..kernels.winell import winell
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

_COMPOSED = ("the composed path of the hybrid backend (fused='auto' or "
             "'0': multi-RHS pre-solve, block-ordered CG) is not ported "
             "yet; see ROADMAP.md Queue 1 item 11")
_POLICIES = (None, 'auto', 'full', '1', '0')
# The arrays each packed backend stores, by the JAX design's names
# (``convert.packed_design_from_numpy`` takes them so).
PACKED_ARRAYS = {
    'bitpack': ('bits_col', 'bits_row', 'X_float', 'bin_cols',
                'float_cols'),
    'winell': ('widx_dot', 'wval_dot', 'widx_tdot', 'wval_tdot', 'sd_idx',
               'sd_val', 'st_idx', 'st_val'),
}


def check_fused_policy(fused):
    """The hybrid backend's fused policy: None, 'full' and '1' all mean
    the fused sweeps (kernels on CUDA tensors, plain versions on CPU
    tensors); 'auto' and '0' raise."""
    if fused in ('auto', '0'):
        raise NotImplementedError(f"fused={fused!r}: {_COMPOSED}")


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
        if fused not in _POLICIES:
            raise ValueError(f"unknown fused policy {fused!r}")
        if _parts is not None:  # convert.*_from_numpy
            parts = dict(_parts)
            self._set_backend(parts.pop('backend'), fused)
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
        self._set_backend(backend, fused)
        if backend == 'hybrid':
            self._build_hybrid(X, data, offsets, masks['int8'],
                               masks['bf16'])
        elif backend == 'bitpack':
            self._build_bitpack(X, offsets, masks['binary'])
        else:
            self._build_winell(X, offsets)

    def _set_backend(self, backend, fused):
        if backend == 'ell':
            raise NotImplementedError(
                "backend='ell': the dual-ELL backend is not ported "
                "(ROADMAP.md Queue 1 item 12)")
        if backend not in ('hybrid', 'bitpack', 'winell'):
            raise ValueError(f"Unknown backend '{backend}'")
        self.backend = backend
        # The policy governs the hybrid sweeps only; the packed backends
        # always compose (sparse.py:1049).
        if backend == 'hybrid':
            check_fused_policy(fused)

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
        """Dual windowed-ELL packing (row-major for X v, column-major for
        X' u) plus plain-ELL spill matrices for cells deeper than the
        slot budget (sparse.py:551-593)."""
        n, p = X.shape
        nnz = X.nnz
        t0 = time.perf_counter()
        X = X.copy()
        X.eliminate_zeros()  # occupancy == (value != 0)
        X.sort_indices()
        w_dot, k_dot = winell_mod.plan_windows(p, n, X.nnz)
        idx_d, val_d, spill_d = winell_mod.pack_winell(X, w_dot, k_dot)
        Xt = X.T.tocsr()
        Xt.sort_indices()
        w_tdot, k_tdot = winell_mod.plan_windows(n, p, X.nnz)
        idx_t, val_t, spill_t = winell_mod.pack_winell(Xt, w_tdot, k_tdot)

        def ell_or_empty(spill):
            if spill is None:
                return (np.zeros((0, 1), np.int32),
                        np.zeros((0, 1), np.float32))
            return csr_to_ell(spill.indptr, spill.indices,
                              spill.data.astype(np.float32), spill.shape[1])

        sd_idx, sd_val = ell_or_empty(spill_d)
        st_idx, st_val = ell_or_empty(spill_t)
        self.build_seconds['pack'] = time.perf_counter() - t0
        self._set_winell(
            idx_d, val_d, idx_t, val_t, sd_idx, sd_val, st_idx, st_val,
            offsets, (n, p), nnz,
            (w_dot, k_dot, w_tdot, k_tdot, spill_d is not None,
             spill_t is not None))

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
        if self.fused_ne_mode() is None:
            raise NotImplementedError(
                "this design has no int8/bf16 exact column, so the JAX "
                "package runs it on " + _COMPOSED)

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
        """`meta` = (w_dot, k_dot, w_tdot, k_tdot, has_sd, has_st), the
        JAX design's ``_winell_meta`` (a trailing interpret flag is
        ignored)."""
        self._set_common(column_offset, shape_main, nnz)
        self.exact_is_binary = False
        w_dot, k_dot, w_tdot, k_tdot, has_sd, has_st = meta[:6]
        self._winell_meta = (int(w_dot), int(k_dot), int(w_tdot),
                             int(k_tdot), bool(has_sd), bool(has_st))
        self.widx_dot = self._dev(widx_dot, torch.int16)
        self.wval_dot = self._dev(wval_dot, torch.float32)
        self.widx_tdot = self._dev(widx_tdot, torch.int16)
        self.wval_tdot = self._dev(wval_tdot, torch.float32)
        self.sd_idx = self._dev(sd_idx, torch.int64)
        self.sd_val = self._dev(sd_val, torch.float32)
        self.st_idx = self._dev(st_idx, torch.int64)
        self.st_val = self._dev(st_val, torch.float32)

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
        return (self.widx_dot, self.wval_dot, self.widx_tdot,
                self.wval_tdot, self.sd_idx, self.sd_val, self.st_idx,
                self.st_val)

    def storage_bytes(self):
        """Device bytes of the stored design arrays."""
        return sum(X.numel() * X.element_size()
                   for X in self._stored_tensors())

    def fused_ne_mode(self, kind='quad'):
        """True where the fused sweeps serve this design (unsharded f32
        hybrid with an int8/bf16/f32 exact block; sparse.py:1039-1070
        without the sharding cases), else None: the composed path."""
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
        """[(X_b, v_b)] of the non-empty hybrid blocks, exact first."""
        blocks = [(self.X_exact, v_main[self.exact_cols])]
        if self.n_float:
            blocks.append((self.X_float, v_main[self.float_cols]))
        return blocks

    def _stored(self):
        """[(X_b, p_b)] of the non-empty hybrid blocks, exact first."""
        out = [(self.X_exact, self.n_exact)]
        if self.n_float:
            out.append((self.X_float, self.n_float))
        return out

    def _assemble(self, parts):
        """Scatter per-block column results back to original order
        (blocks: exact or binary columns, then float columns)."""
        res = torch.zeros(self._shape_main[1], dtype=torch.float32,
                          device=self.device)
        first = self.exact_cols if self.backend == 'hybrid' \
            else self.bin_cols
        res[first] = parts[0]
        if self.n_float:
            res[self.float_cols] = parts[1]
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
        w_dot, k_dot, _, _, has_sd, _ = self._winell_meta
        r = winell(self.widx_dot, self.wval_dot, v_main, self._shape_main[0],
                   w_dot, k_dot, tag='dot')
        if has_sd:
            r = r + (self.sd_val * v_main[self.sd_idx]).sum(1)
        return r

    def _winell_tdot_main(self, u, power=1):
        _, _, w_tdot, k_tdot, _, has_st = self._winell_meta
        r = winell(self.widx_tdot, self.wval_tdot, u, self._shape_main[1],
                   w_tdot, k_tdot, square=power == 2, tag='tdot')
        if has_st:
            val = self.st_val * self.st_val if power == 2 else self.st_val
            r = r + (val * u[self.st_idx]).sum(1)
        return r

    # -- core products --------------------------------------------------- #

    def main_dot(self, v_main):
        """(X_main - 1 column_offset') @ v_main."""
        if self.backend == 'hybrid':
            result = None
            for X, vb in self._blocks(v_main):
                part = layout.matvec(X, vb.shape[0], vb)
                result = part if result is None else result + part
        elif self.backend == 'bitpack':
            result = self._bitpack_dot_bin(v_main[self.bin_cols])
            if self.n_float:
                result = result + layout.matvec(
                    self.X_float, self.n_float, v_main[self.float_cols])
        else:
            result = self._winell_dot_main(v_main)
        return result - self.column_offset @ v_main

    def main_Tdot(self, u):
        """(X_main - 1 column_offset')' @ u."""
        return self._weighted_col_moments(u, 1) - u.sum() * self.column_offset

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
        """X' (weight * (X v)): the CG operator's design part. On the
        hybrid backend one fused sweep of the stored blocks
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

    def fused_link_grad(self, v, a, b, mid):
        """(loglik, gradient) of the GLM in one sweep of the hybrid
        blocks: the `mid` link score u of t = X v, its loglik rows summed,
        and X' u (sparse.py:1258-1317). None on the packed backends: the
        model composes dot and Tdot."""
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
        """(Tdot(u1), Tdot(u2), fisher_diag(u3)[, Tdot(u4)]): one fused
        sweep of the hybrid blocks for the first three
        (sparse.py:1390-1464); `u4` composes as a separate Tdot, the
        sweep's reduction set being fixed at four. Hybrid only: the
        packed backends' callers compose the pre-solve
        (`has_presolve_reductions` is False)."""
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

    # -- Fisher information ---------------------------------------------- #

    def _weighted_col_moments(self, weight, power):
        """sum_i weight_i * X_ij^power per main column j, uncentered
        (sparse.py:1490-1508). 0/1 bits are idempotent under powers, so
        the bitmaps serve both moments as X' w; dense blocks square in
        row chunks, never as a whole-block transient."""
        if self.backend == 'winell':
            return self._winell_tdot_main(weight, power=power)
        square = power == 2
        if self.backend == 'bitpack':
            parts = [self._bitpack_tdot_bin(weight)]
        else:
            parts = [layout.rmatvec(self.X_exact, self.n_exact, weight,
                                    square=square)]
        if self.n_float:
            parts.append(layout.rmatvec(self.X_float, self.n_float, weight,
                                        square=square))
        return self._assemble(parts)

    def compute_fisher_diag(self, weight):
        """diag(X' W X) with centering/intercept corrections
        (sparse.py:1539-1550)."""
        weight = self._as_tensor(weight)
        diag = self._weighted_col_moments(weight, 2)
        if self.centered:
            weighted_col_sum = self._weighted_col_moments(weight, 1)
            diag = diag - 2.0 * self.column_offset * weighted_col_sum
            diag = diag + weight.sum() * self.column_offset ** 2
        return self._with_intercept(weight.sum(), diag)

    # -- densification (small designs: tests, diagnostics) ---------------- #

    def _densify_main(self):
        """(n, p) float32 CPU tensor of the stored main design, uncentered
        (sparse.py:1691-1752)."""
        n, p = self._shape_main
        X = torch.zeros((n, p), dtype=torch.float32)
        if self.backend == 'hybrid':
            for (blk, k), cols in zip(self._stored(),
                                      (self.exact_cols, self.float_cols)):
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
        w_dot, k_dot, *_ = self._winell_meta
        T, _ = winell_mod.tile_block(n)
        idx = self.widx_dot.cpu().long()
        wn = idx.shape[0] // (T * k_dot)
        cell = torch.arange(idx.shape[0]) // k_dot
        rows = ((cell % T) * 128)[:, None] + torch.arange(128)[None, :]
        cols = ((cell // T) * w_dot)[:, None] + idx
        # Empty slots add value 0 at (row, window start): inert.
        full = torch.zeros((T * 128, wn * w_dot), dtype=torch.float32)
        full.index_put_((rows, cols), self.wval_dot.cpu(), accumulate=True)
        X = full[:n, :p].clone()
        if self._winell_meta[4]:
            rows = torch.arange(n)[:, None].expand_as(self.sd_idx.cpu())
            X.index_put_((rows, self.sd_idx.cpu()), self.sd_val.cpu(),
                         accumulate=True)
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
