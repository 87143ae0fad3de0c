"""Sparse design matrix: the hybrid, bitpack, winell and ell backends.

Port of ``bayesbridge_tpu/design/sparse.py`` (unsharded; float32, and
float64 on the hybrid and ell backends).

``hybrid``
    Dense blocks split by column representability: the exactly
    representable columns form one narrow block (int8 when every value
    is an integer in [-127, 127], else bf16 over the bf16-exact set, or,
    opted into with ``BB_HYBRID_INT4=1``, packed int4 over the integers
    in [-8, 7], whichever moves fewer bytes), the rest stay float32.
    `dot` is the row pass of :mod:`..kernels.ne_sweep` (``ne_rows``),
    `Tdot` its column pass (``colpass``), the pre-solve reductions and
    the Fisher diagonal one :mod:`..kernels.tdots_sweep` read; over an
    int4 block each runs its kernel's nibble mode. The int4 tier follows
    the JAX package's rules (sparse.py:83-137, 435-493): the opt-in, a
    capability probe cached per device type (:func:`_int4_supported`),
    the pick by stored bytes, the demotion to int8 where the CG operator
    runs fused (unless int8 would not fit the budget) or the device
    cannot run it, no fused sweep over an int4 block. The `fused` policy
    (:mod:`.fusedne`, default 'auto') decides per call site whether the
    CG operator, the pre-solve and the GLM score run composed
    (block-ordered CG, the warm start folded into the pre-solve, the
    linear predictor from the CG loop) or as one fused sweep each; the
    fused CG operator reads X once on the card
    (:mod:`..kernels.ne_oneread`, through ``ne_sweep``'s 'ne' mode).
    Blocks are stored with their column count padded to a multiple of
    16 zero columns (``kernels.layout``). Under float64 every column stays
    in one float64 block (no narrow tier; ``sparse.py:424-440``), whose
    products are ``torch.matmul``: the kernels are float32 only.
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
``ell``
    Where neither packed form fits and dense blocks would be larger: the
    row-ELL of X and the row-ELL of X' (:func:`.ell.dual_ell_from_scipy`,
    every row padded to the longest with index 0, value 0), in float32
    or float64. `dot` runs the gather kernel (:mod:`..kernels.ell`) on
    the row-ELL, `Tdot` and the Fisher diagonal's moments on the
    col-ELL, through its layout on a CUDA device (``col_layout``, built
    once: the windowed traversal's slot pointers where they pay). Every
    large float64 sparse design lands here under
    ``'auto'`` (bitpack and winell are float32 only).

The fused sweeps serve the hybrid backend only; the other three run the
composed path (`quad_matvec` = `dot` then `Tdot`, the pre-solve as
separate `Tdot`s and the Fisher diagonal), whatever `fused` says, as in
the JAX package; so does a hybrid design without an exact column.
``backend='auto'`` applies the JAX package's float32 rule and budgets, so
the same design picks the same backend in both.

Shared semantics with the JAX package (and the reference): centering is
a rank-1 ``column_offset`` correction, never materialized; the
intercept column is implicit.

The dense Fisher information of the Cholesky path (``compute_fisher_info``
with ``diag_only=False``) streams the hybrid blocks through row-chunked
float32 (or float64) Gram products (:func:`.gram.chunked_gram`), and
densifies the packed backends' small designs.

Products take one vector or k Markov chains' vectors along a leading
axis (what the JAX package's ``vmap`` over chains makes of its products,
``multichain.py``): on the hybrid backend's composed path and on ell up
to 8 chains share one read of the design per launch (``ne_rows_k``,
``colpass_k``, ``tdots_sweep_k``; ``ell_matvec_k``); the fused CG
operator, bitlut and wincsr run once per chain; a float64 hybrid design
multiplies k columns at once. Each chain's result is its single-vector
product, bit for bit on the kernels.

bitpack and winell refuse float64 on every build path
(NotImplementedError).
"""

import copy
import os
import time
import warnings

import numpy as np
import scipy.sparse as sps
import torch

from . import bitlut as bitlut_mod
from . import wincsr as wincsr_mod
from . import winell as winell_mod
from .abstract import AbstractDesignMatrix, memoized_dot
from .ell import dual_ell_from_scipy
from .fusedne import POLICIES, dispatch_mode
from .pieces import (WHOLE, ColumnPiece, indexed_piece, renumber,
                     split_units)
from ..kernels import layout
from ..kernels.bitlut import bitlut
from ..kernels import ell as ell_kernel
from ..kernels.ell import ell_matvec_k
from ..kernels.ne_sweep import colpass_k, ne_rows_k, ne_sweep
from ..kernels.tdots_sweep import tdots_sweep_k
from ..kernels.wincsr import wincsr
from ..utils.chains import per_chain, rdot, rsum
from ..utils.dtypes import full_float32, resolve_device, working_dtype
from .gram import chunked_gram, squared_col_moment

# Budgets of the JAX package's auto rule (sized for a 16 GB-HBM chip;
# re-deriving them for 80 GB is ROADMAP work). Hybrid blocks, and then
# the dual bitmaps or windowed-ELL packings, must fit in these.
_HYBRID_MAX_BYTES = float(os.environ.get('BB_HYBRID_MAX_BYTES', 8e9))
_BITPACK_MAX_BYTES = float(os.environ.get('BB_BITPACK_MAX_BYTES', 8e9))
# Minimum share of binary columns for the bitpack backend to pay off.
_BITPACK_MIN_BINARY_FRAC = 0.5
# Stored entries handled per vectorized densify step.
_DENSIFY_CHUNK = 2 ** 25
# Largest dense Fisher information (p x p) or densified design (n x p)
# the Cholesky path builds (sparse.py:74).
_DENSE_FISHER_MAX_ELEMS = 5e7
# A float block's column pieces on a 2-d mesh start at multiples of this
# (one 16-byte unit of float32).
_FLOAT_PIECE_UNIT = 4

# Whether a device type runs the int4 tier, probed once per type (the
# JAX package's _INT4_SUPPORTED, sparse.py:83-96): keyed by the device a
# design EXECUTES on, never by where its host blocks were built.
_INT4_SUPPORTED = {}


def _int4_opted_in():
    return os.environ.get('BB_HYBRID_INT4', '0') == '1'


def _int4_supported(device):
    """True iff the packed int4 tier runs on `device` (the JAX package's
    ``_int4_matmul_supported``, sparse.py:98-137). Opt-in: without
    ``BB_HYBRID_INT4=1`` False, touching no device. Probed once per device
    type: the CPU runs the nibble modes' plain versions; a CUDA device
    asks the built kernel library for them (``bb_has_int4``), a failed
    build raising as every build does."""
    if not _int4_opted_in():
        return False
    key = torch.device(device).type
    if key not in _INT4_SUPPORTED:
        if key == 'cuda':
            from ..kernels import load_library
            _INT4_SUPPORTED[key] = bool(load_library().lib.bb_has_int4())
        else:
            _INT4_SUPPORTED[key] = key == 'cpu'
    return _INT4_SUPPORTED[key]


# The arrays each packed backend stores, by the JAX design's names
# (``convert.packed_design_from_numpy`` takes them so).
PACKED_ARRAYS = {
    'bitpack': ('bits_col', 'bits_row', 'X_float', 'bin_cols',
                'float_cols'),
    'winell': ('widx_dot', 'wval_dot', 'widx_tdot', 'wval_tdot', 'sd_idx',
               'sd_val', 'st_idx', 'st_val'),
    'ell': ('row_idx', 'row_val', 'col_idx', 'col_val'),
}


def _exact_column_mask(X_csr, bad_entry):
    """Columns of a CSR matrix none of whose stored entries is flagged
    `bad_entry` (empty columns qualify)."""
    p = X_csr.shape[1]
    return np.bincount(X_csr.indices[bad_entry], minlength=p) == 0


def _column_masks(X_csr, data, kinds, device):
    """{kind: _exact_column_mask} for each of `kinds` ('int8', 'bf16',
    'int4', 'binary': the columns whose every entry fits that tier), on
    the card where :func:`_on_card` says so, else in numpy."""
    if kinds and _on_card(X_csr, device):
        return _column_masks_on(X_csr, kinds, device)
    bad = {'int8': lambda: ~_int8_exact(data),
           'bf16': lambda: ~_bf16_exact(data),
           'int4': lambda: ~_int4_exact(data),
           'binary': lambda: data != 1.0}
    return {kind: _exact_column_mask(X_csr, bad[kind]()) for kind in kinds}


def _column_masks_on(X_csr, kinds, device):
    """:func:`_column_masks` on CUDA `device`: the entries go up in chunks
    of _DENSIFY_CHUNK, each flagged as the numpy tests flag it (round half
    to even, float32 casts to nearest) and counted per column. Returns
    numpy masks."""
    p = X_csr.shape[1]
    bad = {kind: torch.zeros(p, dtype=torch.int64, device=device)
           for kind in kinds}
    for s in range(0, X_csr.nnz, _DENSIFY_CHUNK):
        e = min(s + _DENSIFY_CHUNK, X_csr.nnz)
        cols = torch.as_tensor(X_csr.indices[s:e]).to(device).long()
        d = torch.as_tensor(np.asarray(X_csr.data[s:e], np.float64)) \
            .to(device)
        whole = d == torch.round(d)
        for kind in kinds:
            if kind == 'int8':
                ok = whole & (d.abs() <= 127)
            elif kind == 'int4':
                ok = whole & (d >= -8) & (d <= 7)
            elif kind == 'bf16':
                f32 = d.to(torch.float32)
                ok = (f32.to(torch.float64) == d) \
                    & ((f32.view(torch.int32) & 0xFFFF) == 0)
            else:  # 'binary'
                ok = d == 1.0
            bad[kind] += torch.bincount(cols[~ok], minlength=p)
    return {kind: (n == 0).cpu().numpy() for kind, n in bad.items()}


def _bf16_exact(data):
    """Entries that round-trip through bfloat16 exactly: representable
    in float32 with the low 16 mantissa bits zero."""
    f32 = data.astype(np.float32)
    return (f32.astype(np.float64) == data) \
        & ((f32.view(np.uint32) & 0xFFFF) == 0)


def _int8_exact(data):
    return (data == np.round(data)) & (np.abs(data) <= 127)


def _int4_exact(data):
    """Integers in [-8, 7] (sparse.py:230-238): 0/1 columns qualify."""
    return (data == np.round(data)) & (data >= -8) & (data <= 7)


def choose_backend(X_csr, int8_mask, bf16_mask, binary_mask,
                   dtype=torch.float32, int4_mask=None, device='cpu'):
    """The JAX package's ``backend='auto'`` rule (sparse.py:327-403):
    hybrid while its blocks fit the budget, then (float32 only) bitpack
    for mostly-binary designs, then winell while its slots fill sanely,
    then the least bad of hybrid and ell. The hybrid estimate takes the
    int4 tier's 0.5 bytes an element where `int4_mask` is given, it is
    cheaper, and `device` runs it (:func:`_int4_supported`). Under
    float64 every hybrid column is 8 bytes, and where a float32 design
    would have taken bitpack or winell it warns as the JAX package
    does."""
    n, p = X_csr.shape
    nnz = X_csr.nnz
    f32 = dtype == torch.float32
    itemsize = 4 if f32 else 8

    def frac(mask):
        return float(np.mean(mask)) if p else 1.0

    int8_frac, exact_frac = frac(int8_mask), frac(bf16_mask)
    binary_frac = frac(binary_mask)
    per_elem = min(int8_frac * 1 + (1 - int8_frac) * 4,
                   exact_frac * 2 + (1 - exact_frac) * 4) if f32 else 8
    if f32 and int4_mask is not None:
        int4_frac = frac(int4_mask)
        cost_int4 = int4_frac * 0.5 + (1 - int4_frac) * 4
        # The probe only where int4 would change the estimate.
        if cost_int4 < per_elem and _int4_supported(device):
            per_elem = cost_int4
    hybrid_bytes = n * p * per_elem
    ell_bytes = 2 * nnz * (4 + itemsize)
    # the col-ELL's window pointers, where the design would keep them
    pointers = ell_kernel.pointer_bytes(p, n)
    if pointers <= ell_kernel.POINTER_SHARE * nnz * (4 + itemsize):
        ell_bytes += pointers
    bitpack_bytes = n * p * binary_frac / 4.0 \
        + n * p * (1 - binary_frac) * itemsize
    winell_bytes = winell_mod.estimate_bytes(X_csr.shape, nnz)
    w_est, k_est = winell_mod.plan_windows(p, n, nnz)
    winell_ok = w_est * nnz <= 0.75 * k_est * max(1, n * p)
    if hybrid_bytes <= _HYBRID_MAX_BYTES:
        return 'hybrid'
    if binary_frac >= _BITPACK_MIN_BINARY_FRAC \
            and bitpack_bytes <= _BITPACK_MAX_BYTES and f32:
        return 'bitpack'
    if winell_bytes <= _BITPACK_MAX_BYTES and winell_ok and f32:
        return 'winell'
    backend = 'hybrid' if hybrid_bytes <= ell_bytes else 'ell'
    packed_bytes = min(
        bitpack_bytes if binary_frac >= _BITPACK_MIN_BINARY_FRAC
        else np.inf, winell_bytes if winell_ok else np.inf)
    if not f32 and packed_bytes <= _BITPACK_MAX_BYTES:
        warnings.warn(
            "backend='auto' selected '{}' only because the compiled "
            "bitpack/winell kernels are 32-bit; at this scale ({:,} x "
            "{:,}) that costs memory or throughput. Build the design with "
            "dtype=np.float32 (works inside x64 sessions) to use the fast "
            "beyond-HBM path.".format(backend, n, p))
    return backend


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


def _densify_on(X_csr, blocks, device):
    """The blocks of :func:`_densify` built on CUDA `device` in one pass
    over the CSR: `blocks` is a list of (cols, torch dtype, width); the
    entries go up in chunks of _DENSIFY_CHUNK (indices and float64
    values), are cast on the card (round to nearest, as numpy's astype)
    and scattered into zeroed (n, width) blocks. Returns the tensors. For
    a CSR in canonical format (no duplicate entries: each element is
    written once, so the blocks are numpy's bit for bit)."""
    n, p = X_csr.shape
    outs = [torch.zeros((n, width), dtype=dtype, device=device)
            for _, dtype, width in blocks]
    pos = []
    for cols, _, _ in blocks:
        at = torch.full((p,), -1, dtype=torch.int64)
        at[torch.from_numpy(np.ascontiguousarray(cols, np.int64))] = \
            torch.arange(len(cols))
        pos.append(at.to(device))
    if X_csr.nnz == 0 or not any(len(c) for c, _, _ in blocks):
        return outs
    indptr = torch.as_tensor(X_csr.indptr.astype(np.int64)).to(device)
    for s in range(0, X_csr.nnz, _DENSIFY_CHUNK):
        e = min(s + _DENSIFY_CHUNK, X_csr.nnz)
        cols = torch.as_tensor(X_csr.indices[s:e]).to(device).long()
        data = torch.as_tensor(np.asarray(X_csr.data[s:e], np.float64)) \
            .to(device)
        rows = torch.searchsorted(
            indptr, torch.arange(s, e, device=device), right=True) - 1
        for out, at, (_, dtype, width) in zip(outs, pos, blocks):
            k = at[cols]
            keep = k >= 0
            out.view(-1)[rows[keep] * width + k[keep]] = \
                data[keep].to(dtype)
    return outs


def _column_copy(X, r0, r1, c0, c1, width, device):
    """Rows r0:r1 of stored columns c0:c1 of block X as a zero-padded
    (r1 - r0, width) block of its own on `device` (a column piece)."""
    out = torch.zeros((r1 - r0, width), dtype=X.dtype, device=device)
    out[:, :c1 - c0] = X[r0:r1, c0:c1]
    return out


def fisher_from_moments(G, s1, s0, offset, centered, intercept):
    """X' W X over the full design from the uncentered main columns'
    (X' W X, X' w) and sum(w) (sparse.py:1571-1596): the centering as
    rank-one corrections, then the intercept's row and column."""
    if centered:
        G = G - torch.outer(offset, s1) - torch.outer(s1, offset) \
            + s0 * torch.outer(offset, offset)
        s1 = s1 - s0 * offset
    if intercept:
        top = torch.cat((s0.reshape(1), s1))
        G = torch.cat((top[None, :], torch.cat((s1[:, None], G), 1)), 0)
    return G


def _on_card(X_csr, device):
    """Whether the hybrid blocks of `X_csr` are built on `device`: a CUDA
    device and a CSR without duplicate entries."""
    return torch.device(device).type == 'cuda' and X_csr.has_canonical_format


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
        self._dtype = working_dtype(dtype)
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
            raise ValueError(
                "dense X: store it in a DenseDesignMatrix (RegressionModel "
                "does); SparseDesignMatrix takes a scipy sparse matrix")
        X = self.remove_intercept_indicator(X.tocsr()).tocsr()
        n, p = X.shape
        data = np.asarray(X.data, dtype=np.float64)
        if center_predictor:
            offsets = np.bincount(X.indices, weights=data, minlength=p) / n
        else:
            offsets = np.zeros(p)
        kinds = []
        if backend in ('auto', 'hybrid'):
            kinds += ['int8', 'bf16']
            if _int4_opted_in():  # unset, no probe would say yes
                kinds.append('int4')
        if backend in ('auto', 'bitpack'):
            kinds.append('binary')
        t0 = time.perf_counter()
        masks = {'int4': None}
        masks.update(_column_masks(X, data, kinds, self.device))
        self.build_seconds['masks'] = time.perf_counter() - t0
        if backend == 'auto':
            backend = choose_backend(X, masks['int8'], masks['bf16'],
                                     masks['binary'], self._dtype,
                                     masks['int4'], self.device)
        self._set_backend(backend)
        if backend == 'hybrid':
            self._build_hybrid(X, data, offsets, masks['int8'],
                               masks['bf16'], masks['int4'])
        elif backend == 'bitpack':
            self._build_bitpack(X, offsets, masks['binary'])
        elif backend == 'winell':
            self._build_winell(X, offsets)
        else:
            self._build_ell(X, offsets)

    def with_exact_tier(self, tier):
        """This hybrid design with its exact block stored as `tier`:
        'int4' packs an int8 block (its values in [-8, 7]), 'int8' widens
        a packed int4 one (the same values at twice the bytes). The float
        block is shared, the matvec counters start at zero; on the
        design's device, from its stored block (no host densify)."""
        if self.backend != 'hybrid' or tier not in ('int4', 'int8'):
            raise ValueError("with_exact_tier: a hybrid design, tier "
                             "'int4' or 'int8'")
        Xe, binary = self.X_exact, self.int4_binary
        if tier == 'int4' and not layout.is_int4(Xe):
            Xe = layout.pack_int4(Xe, self.n_exact)
            binary = self._int4_binary_of(Xe)
        elif tier == 'int8' and layout.is_int4(Xe):
            Xe, binary = layout.unpack_int4(Xe), False
        other = self.with_policy(self.fused_policy)
        other.X_exact, other.int4_binary = Xe, binary
        return other

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
        if backend not in ('hybrid', 'bitpack', 'winell', 'ell'):
            raise ValueError(f"Unknown backend '{backend}'")
        if backend in ('bitpack', 'winell') \
                and self._dtype != torch.float32:
            # Both build paths (sparse.py:266-292 gates only the fresh
            # one): the bitmap and windowed-CSR kernels are float32.
            raise NotImplementedError(
                f"backend={backend!r} runs float32 only (its kernels are "
                f"32-bit); got {self._dtype}. float64 runs on the hybrid "
                "and ell backends.")
        self.backend = backend

    # -- construction ---------------------------------------------------- #

    def _build_hybrid(self, X, data, offsets, int8_mask, bf16_mask,
                      int4_mask=None):
        """Narrow-tier pick by stored bytes (sparse.py:422-498): ties go
        to int4, then int8. int4 (where `int4_mask` is given, under the
        opt-in) yields to the next tier where the design's device cannot
        run it, and where the policy fuses the CG operator, which takes
        no int4 block, unless that tier would not fit the hybrid budget
        (int4 as a storage rescue). Under float64, one float64 block of
        every column."""
        n, p = X.shape
        binary = bool(np.all((data == 0.0) | (data == 1.0)))
        on_card = _on_card(X, self.device)
        t0 = time.perf_counter()
        if self._dtype == torch.float64:
            cols = np.arange(p)
            if on_card:
                Xf, = _densify_on(X, [(cols, torch.float64,
                                       layout.padded_width(p))], self.device)
            else:
                Xf = torch.from_numpy(_densify(X, cols, np.float64,
                                               layout.padded_width(p)))
            self.build_seconds['densify'] = time.perf_counter() - t0
            self._set_hybrid(torch.zeros((n, 0), dtype=torch.float64), Xf,
                             cols[:0], cols, offsets, (n, p), X.nnz, binary)
            return
        n_int8, n_bf16 = int(int8_mask.sum()), int(bf16_mask.sum())
        costs = {}
        if int4_mask is not None:
            n_int4 = int(int4_mask.sum())
            costs['int4'] = 0.5 * n_int4 + 4 * (p - n_int4)
        costs.update(int8=1 * n_int8 + 4 * (p - n_int8),
                     bf16=2 * n_bf16 + 4 * (p - n_bf16))
        pick = min(costs, key=costs.get)
        if pick == 'int4' and not _int4_supported(self.device):
            del costs['int4']
            pick = min(costs, key=costs.get)
        if pick == 'int4' and dispatch_mode('quad', self.fused_policy) \
                is not None:
            # One fused sweep reads E + F bytes where the composed pair
            # over int4 reads 2 (E / 2 + F): keep int4 only as a storage
            # rescue (sparse.py:457-473).
            alt = min((k for k in costs if k != 'int4'), key=costs.get)
            if n * costs[alt] <= _HYBRID_MAX_BYTES:
                pick = alt
        exact_mask = {'int4': int4_mask, 'int8': int8_mask,
                      'bf16': bf16_mask}[pick]
        exact_cols = np.where(exact_mask)[0]
        float_cols = np.where(~exact_mask)[0]
        # int4 densifies through int8 (numpy has no 4-bit layout) and is
        # packed where the block was built; bf16 through float32.
        ew = layout.padded_width(len(exact_cols))
        fw = layout.padded_width(len(float_cols))
        e_dtype = torch.int8 if pick in ('int4', 'int8') else torch.float32
        if on_card:
            Xe, Xf = _densify_on(X, [(exact_cols, e_dtype, ew),
                                     (float_cols, torch.float32, fw)],
                                 self.device)
        else:
            Xe = torch.from_numpy(_densify(
                X, exact_cols, np.int8 if e_dtype == torch.int8
                else np.float32, ew))
            Xf = torch.from_numpy(_densify(X, float_cols, np.float32, fw))
        self.build_seconds['densify'] = time.perf_counter() - t0
        if pick == 'int4':
            Xe = layout.pack_int4(Xe, len(exact_cols))
        elif pick == 'bf16':
            # bf16 bits of bf16-exact values: the top half of their f32.
            Xe = (Xe.view(torch.int32) >> 16).to(torch.int16) \
                .view(torch.bfloat16)
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
        if _on_card(X, self.device):
            X_float, = _densify_on(X, [(float_cols, torch.float32,
                                        len(float_cols))], self.device)
        else:
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

    def _build_ell(self, X, offsets):
        """The row-ELL of X and of X' in the working dtype (sparse.py
        :757-764)."""
        t0 = time.perf_counter()
        np_dtype = np.float64 if self._dtype == torch.float64 \
            else np.float32
        (row_idx, row_val), (col_idx, col_val) = \
            dual_ell_from_scipy(X, np_dtype)
        self.build_seconds['ell'] = time.perf_counter() - t0
        self._set_ell(row_idx, row_val, col_idx, col_val, offsets, X.shape,
                      X.nnz)

    def _set_common(self, column_offset, shape_main, nnz):
        # Whether the exact block is packed int4 and holds only 0/1 (the
        # pre-solve's binary mode): set with a hybrid design's block.
        self.int4_binary = False
        self._shape_main = tuple(shape_main)
        self._nnz = nnz
        self.column_offset = torch.as_tensor(
            np.array(column_offset, dtype=np.float64), dtype=self._dtype,
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
        self.int4_binary = self._int4_binary_of(self.X_exact)

    def _int4_binary_of(self, Xe):
        """Whether exact block `Xe` of this design takes the pre-solve's
        binary mode: packed int4 with only 0/1 values, read from the block
        on its device. (`exact_is_binary`, the JAX package's flag, is the
        whole design's, so it is False wherever float columns sit beside
        the 0/1 ones, as at the flagship.)"""
        return bool(self.n_exact) and layout.is_int4(Xe) and (
            self.exact_is_binary or layout.int4_is_binary(Xe, self.n_exact))

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
        if isinstance(X_float, torch.Tensor):  # built on the card
            self.X_float = X_float[:shape_main[0], :self.n_float] \
                .contiguous().to(self.device)
        else:
            self.X_float = self._dev(np.asarray(
                X_float, np.float32)[:shape_main[0], :self.n_float])

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

    def _set_ell(self, row_idx, row_val, col_idx, col_val, column_offset,
                 shape_main, nnz):
        """The dual ELL arrays (the JAX design's, or built here; rows past
        the design's are cut), and on a CUDA device the col-ELL's layout
        for the windowed traversal (valid slots, window pointers where
        they pay; ``kernels.ell.col_layout``)."""
        self._set_common(column_offset, shape_main, nnz)
        self.exact_is_binary = False
        n, p = shape_main
        col_idx, col_val = np.asarray(col_idx)[:p], np.asarray(col_val)[:p]
        self.row_idx = self._dev(np.asarray(row_idx)[:n], torch.int32)
        self.row_val = self._dev(np.asarray(row_val)[:n], self._dtype)
        self.col_idx = self._dev(col_idx, torch.int32)
        self.col_val = self._dev(col_val, self._dtype)
        np_dtype = np.float64 if self._dtype == torch.float64 \
            else np.float32
        self.col_layout = ell_kernel.col_layout(
            col_idx, col_val.astype(np_dtype, copy=False), n, self._dtype,
            self.device)

    def row_block(self, r0, r1, device=None):
        """Rows r0:r1 of this design as a design of their own on `device`
        (default this design's), with this design's column layout: the
        same exact / float (bitpack: binary / float) column split, the
        same centering offsets, an intercept column over the block's
        rows; the ell, bitpack and winell blocks re-pack their stored
        transpose from the block's rows. On this design's device the
        hybrid blocks, the row-ELL and the bitpack side block are row
        views of the stored arrays, not copies (a stored row is a whole
        number of 16-byte vectors, so a view starts aligned). Rows 0:n
        on another device are the design moved there. The shards of
        :mod:`.sharded` are such blocks."""
        n, p = self._shape_main
        if not 0 <= r0 < r1 <= n:
            raise ValueError(f"rows {r0}:{r1} of a {n}-row design")
        blk = self._copy_to(device)
        whole = (r0, r1) == (0, n)
        getattr(blk, '_rows_' + self.backend)(self, r0, r1, whole)
        blk._shape_main = (r1 - r0, p)
        blk._nnz = self._nnz if whole else blk._nnz
        blk.column_offset = self.column_offset.to(device)
        return blk

    def _rows_hybrid(self, src, r0, r1, whole):
        self.X_exact = src.X_exact[r0:r1].to(self.device)
        self.int4_binary = src.int4_binary  # rows of a 0/1 block
        self.X_float = src.X_float[r0:r1].to(self.device)
        self.exact_cols = src.exact_cols.to(self.device)
        self.float_cols = src.float_cols.to(self.device)
        self._nnz = None

    def _rows_bitpack(self, src, r0, r1, whole):
        p_bin = src._bitpack_meta[0]
        plan_col = bitlut_mod.plan_blocks(p_bin, r1 - r0)
        plan_row = bitlut_mod.plan_blocks(r1 - r0, p_bin)
        if whole:
            self.bits_col = src.bits_col.to(self.device)
            self.bits_row = src.bits_row.to(self.device)
        else:
            self.bits_col, self.bits_row = bitlut_mod.row_block_bits(
                src.bits_col, src.bits_row, r0, r1, plan_col[:2],
                plan_row[:2])
            self.bits_col = self.bits_col.to(self.device)
            self.bits_row = self.bits_row.to(self.device)
        self._bitpack_meta = (p_bin,) + plan_col + plan_row
        self.X_float = src.X_float[r0:r1].to(self.device)
        self.bin_cols = src.bin_cols.to(self.device)
        self.float_cols = src.float_cols.to(self.device)
        self._nnz = None

    def _rows_winell(self, src, r0, r1, whole):
        if whole:
            self.wc_dot = src.wc_dot.to(self.device)
            self.wc_tdot = src.wc_tdot.to(self.device)
            return
        self._build_winell(src.wc_dot.to_scipy()[r0:r1],
                           src.column_offset.cpu().numpy())

    def _rows_ell(self, src, r0, r1, whole):
        """The block's row-ELL rows as they are; its col-ELL (the
        transpose of the block's rows) built again, and its layout for
        the windowed traversal on a CUDA device, whose dispatch
        (``kernels.ell.takes_window``) then decides on the block's
        shape."""
        self.row_idx = src.row_idx[r0:r1].to(self.device)
        self.row_val = src.row_val[r0:r1].to(self.device)
        np_dtype = np.float64 if self._dtype == torch.float64 \
            else np.float32
        if whole:
            col_idx = src.col_idx.cpu().numpy()
            col_val = src.col_val.cpu().numpy()
            self.col_idx = src.col_idx.to(self.device)
            self.col_val = src.col_val.to(self.device)
        else:
            idx = src.row_idx[r0:r1].cpu().numpy()
            val = src.row_val[r0:r1].cpu().numpy()
            live = val != 0  # padded slots hold value 0
            X = sps.csr_matrix(
                (val[live], idx[live], np.concatenate(
                    ([0], np.cumsum(live.sum(1))))),
                shape=(r1 - r0, src._shape_main[1]))
            self._nnz = X.nnz
            (_, _), (col_idx, col_val) = dual_ell_from_scipy(X, np_dtype)
            self.col_idx = self._dev(col_idx, torch.int32)
            self.col_val = self._dev(col_val, self._dtype)
        if whole and self.device == src.device:
            self.col_layout = src.col_layout
        else:
            self.col_layout = ell_kernel.col_layout(
                col_idx, col_val.astype(np_dtype, copy=False), r1 - r0,
                self._dtype, self.device)

    # -- column pieces of a 2-d mesh (.sharded, .pieces) ------------------ #

    def column_pieces(self, c, device=None):
        """This design's columns cut into at most `c` pieces for the
        predictor axis of a 2-d mesh (:class:`.pieces.ColumnPiece`s, the
        empty ones left out; ``[WHOLE]`` where one piece remains).

        hybrid: each stored block's columns in c near-equal ranges, the
        exact block's at multiples of 32 columns (whole bytes of a packed
        int4 block and whole 16-byte units of its rows; an int8 or bf16
        block is cut where its int4 packing would be, so the two tiers
        give the same pieces), the float block's at multiples of 4, so
        that each piece holds about 1/c of either block. bitpack: the
        binary columns at multiples of 8 (whole byte-groups of
        bits_col), the float side block split like the hybrid's over the
        pieces that hold binary columns; the intercept in piece 0
        (`device`: where the pieces' index tensors live, default the
        design's). ell: the predictors in c near-equal ranges, for the
        col-ELL (:meth:`ell_col_piece`). winell is not split."""
        device = self.device if device is None else device
        if self.backend == 'ell':
            d = int(self.intercept_added)
            spans = [s for s in split_units(self._shape_main[1], c, 1)
                     if s[1] > s[0]]
            if len(spans) < 2:
                return [WHOLE]
            return [ColumnPiece(s, j == 0, slice(0 if j == 0 else s[0] + d,
                                                 s[1] + d))
                    for j, s in enumerate(spans)]
        if self.backend == 'hybrid':
            ranges = [
                (e, f) for e, f in zip(
                    split_units(self.n_exact, c, layout.INT4_ALIGN),
                    split_units(self.n_float, c, _FLOAT_PIECE_UNIT))
                if e[1] > e[0] or f[1] > f[0]]
        elif self.backend == 'bitpack':
            bins = [s for s in split_units(self._bitpack_meta[0], c, 8)
                    if s[1] > s[0]]
            ranges = list(zip(bins, split_units(self.n_float, len(bins),
                                                _FLOAT_PIECE_UNIT)))
        else:
            return [WHOLE]
        if len(ranges) < 2:
            return [WHOLE]
        return [indexed_piece(r, j == 0, self._piece_cols(r)[0],
                              self.intercept_added, device)
                for j, r in enumerate(ranges)]

    def _piece_cols(self, spans):
        """(main, [local]) of the stored blocks' column ranges `spans`
        (hybrid: exact, float; bitpack: binary, float): the whole
        design's main columns they hold, sorted, and each block's
        columns' positions among them (:func:`.pieces.renumber`)."""
        first = self.exact_cols if self.backend == 'hybrid' \
            else self.bin_cols
        return renumber(*[c[a:b] for c, (a, b)
                          in zip((first, self.float_cols), spans)])

    def _copy_to(self, device):
        """A shallow copy on `device` with fresh counters, for a piece."""
        blk = copy.copy(self)
        AbstractDesignMatrix.__init__(blk)  # fresh counters, no memo
        blk.device = self.device if device is None else resolve_device(
            device)
        blk.build_seconds = {}
        return blk

    def block(self, r0, r1, piece, device=None):
        """Rows r0:r1 of column piece `piece` (of :meth:`column_pieces`)
        as a design of its own on `device`, of the piece's columns alone
        in the whole design's order (:mod:`.pieces`); ``WHOLE`` gives
        :meth:`row_block`. A piece of a hybrid or bitpack design keeps the
        whole design's column layout restricted to its columns (the
        exact / float or binary / float split, the centering offsets, the
        int4 flags); only piece 0 holds the intercept. Its stored blocks
        are copies, each row whole 16-byte units
        (``layout.padded_width``); its bitmaps are cut from the design's
        at whole byte-groups and re-padded to its own plans. A piece
        composes every product (policy '0')."""
        if piece.spans is None:
            return self.row_block(r0, r1, device)
        if self.backend not in ('hybrid', 'bitpack'):
            raise ValueError(f"a {self.backend} design has no grid pieces")
        n = self._shape_main[0]
        if not 0 <= r0 < r1 <= n:
            raise ValueError(f"rows {r0}:{r1} of a {n}-row design")
        blk = self._copy_to(device)
        blk.fused_policy = '0'
        main, (first, flt) = self._piece_cols(piece.spans)
        getattr(blk, '_piece_' + self.backend)(self, r0, r1, piece.spans)
        if self.backend == 'hybrid':
            blk.exact_cols = first.to(blk.device)
        else:
            blk.bin_cols = first.to(blk.device)
        blk.float_cols = flt.to(blk.device)
        blk._shape_main = (r1 - r0, main.numel())
        blk._nnz = None
        blk.intercept_added = self.intercept_added and piece.first
        blk.column_offset = self.column_offset[main].to(blk.device)
        return blk

    def _piece_hybrid(self, src, r0, r1, spans):
        (e0, e1), (f0, f1) = spans
        Xe = src.X_exact
        if layout.is_int4(Xe):  # e0 is a multiple of 32: whole bytes
            self.X_exact = _column_copy(
                Xe, r0, r1, e0 // 2, -(-e1 // 2),
                layout.padded_width(e1 - e0, int4=True) // 2, self.device)
        else:
            self.X_exact = _column_copy(Xe, r0, r1, e0, e1,
                                        layout.padded_width(e1 - e0),
                                        self.device)
        self.X_float = _column_copy(src.X_float, r0, r1, f0, f1,
                                    layout.padded_width(f1 - f0),
                                    self.device)
        self.n_exact, self.n_float = e1 - e0, f1 - f0
        self.int4_binary = src.int4_binary and self.n_exact > 0

    def _piece_bitpack(self, src, r0, r1, spans):
        (b0, b1), (f0, f1) = spans
        m, p_bin = r1 - r0, b1 - b0
        plan_col = bitlut_mod.plan_blocks(p_bin, m)
        plan_row = bitlut_mod.plan_blocks(m, p_bin)
        bits_col, bits_row = bitlut_mod.row_block_bits(
            src.bits_col[b0 // 8:-(-b1 // 8)], src.bits_row[:, b0:b1], r0,
            r1, plan_col[:2], plan_row[:2])
        self.bits_col = bits_col.to(self.device)
        self.bits_row = bits_row.to(self.device)
        self._bitpack_meta = (p_bin,) + plan_col + plan_row
        self.X_float = src.X_float[r0:r1, f0:f1].contiguous().to(self.device)
        self.n_float = f1 - f0

    def ell_row_piece(self, r0, r1, device=None):
        """Rows r0:r1 of an ell design's row-ELL alone, every column, as
        a design on `device` that serves X v and the Gram (the 2-d mesh's
        row pieces; its col-ELL is not built)."""
        blk = self._copy_to(device)
        blk.row_idx = self.row_idx[r0:r1].to(blk.device)
        blk.row_val = self.row_val[r0:r1].to(blk.device)
        blk.col_idx = blk.col_val = blk.col_layout = None
        blk._shape_main = (r1 - r0, self._shape_main[1])
        blk._nnz = None
        blk.column_offset = self.column_offset.to(blk.device)
        return blk

    def ell_col_piece(self, piece, device=None):
        """The col-ELL rows of an ell design's predictors of `piece` (of
        :meth:`column_pieces`), over every row, as a design on `device`
        of those predictors that serves X' u and the Fisher diagonal (the
        2-d mesh's column pieces), with its own layout for the windowed
        traversal, so the dispatch decides on the piece's shape. Only
        piece 0 holds the intercept."""
        j0, j1 = piece.spans
        blk = self._copy_to(device)
        blk.col_idx = self.col_idx[j0:j1].to(blk.device)
        blk.col_val = self.col_val[j0:j1].to(blk.device)
        np_dtype = np.float64 if self._dtype == torch.float64 \
            else np.float32
        blk.col_layout = ell_kernel.col_layout(
            self.col_idx[j0:j1].cpu().numpy(),
            self.col_val[j0:j1].cpu().numpy().astype(np_dtype, copy=False),
            self._shape_main[0], self._dtype, blk.device)
        blk.row_idx = blk.row_val = None
        blk._shape_main = (self._shape_main[0], j1 - j0)
        blk._nnz = None
        blk.intercept_added = self.intercept_added and piece.first
        blk.column_offset = self.column_offset[j0:j1].to(blk.device)
        return blk

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
        """Stored entries; a hybrid or bitpack design built from another's
        arrays (``convert``, ``row_block``) counts its nonzeros once."""
        if self._nnz is None and self.backend in ('hybrid', 'bitpack'):
            self._nnz = self._count_nnz()
        return self._nnz

    def _count_nnz(self):
        """Nonzeros of the stored blocks (bitpack: set bits), counted in
        row chunks of at most _DENSIFY_CHUNK elements."""
        def count(X, width, fn):
            step = max(1, _DENSIFY_CHUNK // max(1, X.shape[1]))
            return sum(int(fn(X[i:i + step, :width]).sum())
                       for i in range(0, X.shape[0], step))

        def nonzero(X):
            return X != 0

        if self.backend == 'bitpack':
            ones = torch.tensor([bin(b).count('1') for b in range(256)],
                                device=self.device)
            return count(self.bits_col.T, self.bits_col.shape[0],
                         lambda B: ones[B.long()]) \
                + count(self.X_float, self.n_float, nonzero)
        def stored(X, k):
            if layout.is_int4(X):
                return count(X, X.shape[1],
                             lambda B: layout.unpack_int4(B, k) != 0)
            return count(X, k, nonzero)
        return sum(stored(X, k) for X, k in self._stored())

    @property
    def dtype(self):
        """The working dtype: float32, or float64 on the hybrid and ell
        backends (sparse.py:829-844 reads it off the stored arrays)."""
        return self._dtype

    def _stored_tensors(self):
        if self.backend == 'hybrid':
            return (self.X_exact, self.X_float)
        if self.backend == 'bitpack':
            return (self.bits_col, self.bits_row, self.X_float)
        if self.backend == 'ell':  # a 2-d mesh's piece lacks one side
            return tuple(t for t in (self.row_idx, self.row_val,
                                     self.col_idx, self.col_val)
                         if t is not None) \
                + (self.col_layout.tensors() if self.col_layout is not None
                   else ())
        return self.wc_dot.tensors() + self.wc_tdot.tensors()

    def storage_bytes(self):
        """Device bytes of the stored design arrays."""
        return sum(X.numel() * X.element_size()
                   for X in self._stored_tensors())

    def fused_ne_mode(self, kind='quad'):
        """True where the fused sweep serves the `kind` call site ('quad'
        | 'presolve' | 'link') of this design: the policy fuses the kind
        (.fusedne.dispatch_mode) and the design is an f32 hybrid with an
        int8/bf16/f32 exact block, not a packed int4 one (sparse.py
        :1039-1070 without the sharding cases); else None, the composed
        path."""
        if (dispatch_mode(kind, self.fused_policy) is None
                or self.backend != 'hybrid' or not self._kernels()
                or self.X_exact.dtype not in layout.DTYPE_CODE
                or layout.is_int4(self.X_exact) or self.n_exact == 0):
            return None
        return True

    def has_presolve_reductions(self):
        """The hybrid backend serves the batched pre-solve (one
        `tdots_sweep` read, with the warm-start column on the composed
        path) wherever it has an exact column (sparse.py:1319-1323); the
        other backends, and the float64 hybrid, compose per reduction."""
        return self.backend == 'hybrid' and self.n_exact > 0

    def _kernels(self):
        """Whether a hybrid design's products run on the hand-written
        kernels: the float32 ones. A float64 hybrid design, which has one
        block, runs them as torch.matmul, the one place that decides
        it."""
        return self._dtype == torch.float32

    # -- helpers --------------------------------------------------------- #

    def _as_tensor(self, x):
        return torch.as_tensor(x, dtype=self._dtype, device=self.device)

    def _split(self, v):
        """(v0, v_main) with v0 the intercept coefficient (0 without), over
        the last axis."""
        if self.intercept_added:
            return v[..., 0], v[..., 1:]
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device), v

    def _block_cols(self):
        """Original column indices of each non-empty block, in block
        order: exact (or binary) columns, then float columns."""
        if self.backend == 'hybrid':
            first = [self.exact_cols] if self.n_exact else []
        else:
            first = [self.bin_cols]
        return first + ([self.float_cols] if self.n_float else [])

    def _blocks(self, v_main):
        """[(X_b, v_b)] of the non-empty hybrid blocks, exact first (v_b
        over the last axis of v_main)."""
        return [(X, v_main[..., cols]) for (X, _), cols
                in zip(self._stored(), self._block_cols())]

    def _stored(self):
        """[(X_b, p_b)] of the non-empty hybrid blocks, exact first."""
        out = [(self.X_exact, self.n_exact)] if self.n_exact else []
        if self.n_float:
            out.append((self.X_float, self.n_float))
        return out

    def _assemble(self, parts):
        """Scatter per-block column results (over the last axis) back to
        original order."""
        res = torch.zeros(parts[0].shape[:-1] + (self._shape_main[1],),
                          dtype=self._dtype, device=self.device)
        for cols, part in zip(self._block_cols(), parts):
            res[..., cols] = part
        return res

    def _with_intercept(self, s, main):
        if self.intercept_added:
            return torch.cat((s[..., None], main), -1)
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

    def main_dot(self, V):
        """(X_main - 1 column_offset') V' for k chains' V (k, p_main): (k,
        n), or of one vector. Hybrid: the row pass (``ne_rows_k``), the
        centering folded into its row offset."""
        if V.dim() == 1:
            return self.main_dot(V[None])[0]
        offset = rdot(V, self.column_offset)
        if self.backend == 'hybrid' and not self._kernels():
            return V @ self.X_float[:, :self.n_float].T - offset[:, None]
        if self.backend == 'hybrid':
            return ne_rows_k(self._blocks(V), -offset)
        if self.backend == 'bitpack':
            result = torch.stack([self._bitpack_dot_bin(v[self.bin_cols])
                                  for v in V])
            if self.n_float:
                result = result + torch.stack([layout.matvec(
                    self.X_float, self.n_float, v[self.float_cols])
                    for v in V])
        elif self.backend == 'winell':
            result = torch.stack([self._winell_dot_main(v) for v in V])
        else:  # one launch for up to 8 chains
            result = ell_matvec_k(self.row_idx, self.row_val, V.contiguous())
        return result - offset[:, None]

    def main_Tdot(self, U):
        """(X_main - 1 column_offset')' u for k chains' U (k, n): (k,
        p_main), or of one vector. Hybrid: the column pass
        (``colpass_k``)."""
        if U.dim() == 1:
            return self.main_Tdot(U[None])[0]
        if self.backend == 'hybrid' and not self._kernels():
            raw = U @ self.X_float[:, :self.n_float]
        elif self.backend == 'hybrid':
            raw = self._assemble(colpass_k(*self._hybrid_Xs(), U))
        else:
            raw = self._weighted_col_moments(U, 1)
        return raw - rsum(U)[:, None] * self.column_offset

    @memoized_dot
    def dot(self, v):
        """X v, or X v_c for each row of v (k, p): (k, n)."""
        v = self._as_tensor(v)
        if v.dim() == 1:
            return self.dot(v[None])[0]
        v0, v_main = self._split(v)
        self.dot_count += v.shape[0]
        return self.main_dot(v_main) + v0[:, None]

    def Tdot(self, u):
        """X' u, or X' u_c for each row of u (k, n): (k, p)."""
        u = self._as_tensor(u)
        if u.dim() == 1:
            return self.Tdot(u[None])[0]
        self.Tdot_count += u.shape[0]
        return self._with_intercept(rsum(u), self.main_Tdot(u))

    def quad_matvec(self, v, weight, return_t=False):
        """X' (weight * (X v)): the CG operator's design part, for one
        vector or k chains' rows. Where the policy fuses 'quad', one
        ``ne_sweep`` of the hybrid blocks per chain (sparse.py:1108-1174;
        the intercept and centering fold into the sweep's row offset c =
        v0 - offset . v_main and into u = weight * (X v)); elsewhere, or
        with `return_t`, `dot` then `Tdot`."""
        weight = self._as_tensor(weight)
        v = self._as_tensor(v)
        if return_t or self.fused_ne_mode('quad') is None:
            return super().quad_matvec(v, weight, return_t)
        if v.dim() == 2:
            return per_chain(self.quad_matvec, v, weight)
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
        if self.backend != 'hybrid' or not self._kernels() \
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
        pass and then the column pass over slices of the operand, for one
        vector or k chains' rows (one read of the blocks per pass for up
        to 8 chains, ``kernels.layout.batched_plan``). With `return_t` also the row pass's
        ``t = X v`` (observation order), from which the CG loop
        accumulates the draw's linear predictor."""
        v_bo = self._as_tensor(v_bo)
        weight = self._as_tensor(weight)
        if v_bo.dim() == 1:
            res = self.quad_matvec_blockorder(v_bo[None], weight[None],
                                              offset_bo, return_t)
            return (res[0][0], res[1][0]) if return_t else res[0]
        v0, v_main_bo = self._split(v_bo)
        pe = self.n_exact
        parts = (v_main_bo[:, :pe].contiguous(),
                 v_main_bo[:, pe:].contiguous())
        blocks = [(X, vb) for (X, _), vb
                  in zip(self._stored(), parts[0 if pe else 1:])]
        t = ne_rows_k(blocks, v0 - rdot(v_main_bo, offset_bo))
        u = weight * t
        sum_u = rsum(u)
        main = torch.cat(colpass_k([X for X, _ in blocks],
                                   [vb.shape[1] for _, vb in blocks], u),
                         -1)
        main = main - sum_u[:, None] * offset_bo
        self.dot_count += v_bo.shape[0]
        self.Tdot_count += v_bo.shape[0]
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
        equals X'u3), except over a packed int4 block of 0/1 values, whose
        binary mode takes X'u3 for it (sparse.py:1359-1360, there for a
        binary design). One vector each, or k chains' rows (one read for
        up to 8 chains, ``kernels.layout.batched_plan``)."""
        us = [self._as_tensor(u) for u in (u1, u2, u3)]
        if u4 is not None:
            us.append(self._as_tensor(u4))
        if us[0].dim() == 1:
            return tuple(r[0] for r in self.presolve_reductions(
                *(u[None] for u in us)))
        k = us[0].shape[0]
        fused = self.fused_ne_mode('presolve') is not None
        fold = u4 is not None and not fused
        outs = tdots_sweep_k(*self._hybrid_Xs(), *us[:3],
                             us[3] if fold else None,
                             binary=self.int4_binary)
        sums = [rsum(u)[:, None] for u in us]
        offset = self.column_offset

        def assemble(idx):
            return self._assemble([blk[idx] for blk in outs])

        v = assemble(0) - sums[0] * offset
        pert = assemble(1) - sums[1] * offset
        diag = assemble(3)
        if self.centered:
            wcol = assemble(2)  # raw X' u3 per main column (no offset)
            diag = diag - 2.0 * offset * wcol
            diag = diag + sums[2] * offset ** 2
        v = self._with_intercept(sums[0][:, 0], v)
        pert = self._with_intercept(sums[1][:, 0], pert)
        diag = self._with_intercept(sums[2][:, 0], diag)
        self.Tdot_count += 2 * k
        if u4 is None:
            return v, pert, diag
        if not fold:
            return v, pert, diag, self.Tdot(us[3])
        tdot4 = self._with_intercept(
            sums[3][:, 0], assemble(4) - sums[3] * offset)
        self.Tdot_count += k
        return v, pert, diag, tdot4

    # -- Fisher information ---------------------------------------------- #

    def _weighted_col_moments(self, W, power):
        """sum_i w_i * X_ij^power per main column j, uncentered, on the
        packed and ell backends (sparse.py:1490-1537), for each chain's
        row of W (k, n): the ell kernel on the col-ELL for up to 8 chains
        a launch, the other kernels once per chain. 0/1 bits are
        idempotent under powers, so the bitmaps serve both moments as X'
        w; the float side block squares in row chunks, never as a
        whole-block transient."""
        if self.backend == 'ell':
            return ell_matvec_k(self.col_idx, self.col_val, W.contiguous(),
                                power=power, tag='tdot',
                                layout=self.col_layout)
        if self.backend == 'winell':
            return torch.stack([self._winell_tdot_main(w, power=power)
                                for w in W])

        def one(w):
            parts = [self._bitpack_tdot_bin(w)]
            if self.n_float:
                parts.append(layout.rmatvec(self.X_float, self.n_float, w,
                                            square=power == 2))
            return self._assemble(parts)
        return torch.stack([one(w) for w in W])

    def compute_fisher_diag(self, weight):
        """diag(X' W X) with centering/intercept corrections
        (sparse.py:1539-1550), for one weight vector or k chains' rows.
        Hybrid: both column moments from one ``tdots_sweep_k`` read."""
        weight = self._as_tensor(weight)
        if weight.dim() == 1:
            return self.compute_fisher_diag(weight[None])[0]
        if self.backend == 'hybrid' and not self._kernels():
            X = self.X_float[:, :self.n_float]
            diag = per_chain(lambda w: squared_col_moment(X, w), weight)
            col_sum = weight @ X
        elif self.backend == 'hybrid':
            outs = tdots_sweep_k(*self._hybrid_Xs(), weight, weight, weight,
                                 binary=self.int4_binary)
            diag = self._assemble([blk[3] for blk in outs])
            col_sum = self._assemble([blk[2] for blk in outs])
        else:
            diag = self._weighted_col_moments(weight, 2)
            col_sum = self._weighted_col_moments(weight, 1) \
                if self.centered else None
        w_sum = rsum(weight)
        if self.centered:
            diag = diag - 2.0 * self.column_offset * col_sum
            diag = diag + w_sum[:, None] * self.column_offset ** 2
        return self._with_intercept(w_sum, diag)

    def compute_fisher_info(self, weight, diag_only=False):
        """X' W X over the full (intercept + centered) design, or its
        diagonal (sparse.py:1552-1596): a p x p Gram built without
        densifying the n x p design on the hybrid backend, the centering
        and intercept as rank-one corrections. The guard sits on the
        p x p output."""
        if diag_only:
            return self.compute_fisher_diag(weight)
        weight = self._as_tensor(weight)
        if weight.dim() == 2:
            return per_chain(self.compute_fisher_info, weight)
        n, p_main = self._shape_main
        p_total = p_main + int(self.intercept_added)
        if p_total * p_total > _DENSE_FISHER_MAX_ELEMS:
            raise MemoryError(
                "Refusing to build a {:d} x {:d} dense Fisher information "
                "matrix; use the CG sampler.".format(p_total, p_total))
        weight = self._as_tensor(weight)
        if self.backend == 'hybrid':
            G, s1 = self._gram_main(weight)
        elif self.backend == 'ell':
            G, s1 = self._ell_gram_main(weight)
        else:
            # The packed backends serve designs far past the Cholesky
            # size, so the guarded densify only meets small ones.
            X = self._materialize_main()
            with full_float32():
                G = X.T @ (weight[:, None] * X)
            s1 = X.T @ weight
        return fisher_from_moments(G, s1, weight.sum(), self.column_offset,
                                   self.centered, self.intercept_added)

    def _own_cols(self):
        """Main column indices of the stored blocks' columns, in block
        order (hybrid and bitpack)."""
        return torch.cat(self._block_cols())

    def _main_panel(self, start, size):
        """Rows start:start+size of the stored blocks' columns (hybrid
        and bitpack, in the order of :meth:`_own_cols`), uncentered, in
        the working dtype: a packed int4 block unpacked, bits expanded."""
        if self.backend == 'bitpack':
            p_bin = self._bitpack_meta[0]
            groups = -(-p_bin // 8)
            B = self.bits_col[:groups, start:start + size].to(torch.int32)
            bits = (B[:, :, None] >> torch.arange(8, device=B.device)) & 1
            parts = [bits.permute(1, 0, 2).reshape(size, 8 * groups)
                     [:, :p_bin].to(self._dtype)]
            if self.n_float:
                parts.append(self.X_float[start:start + size]
                             .to(self._dtype))
            return torch.cat(parts, 1)
        return torch.cat([layout.widen(X[start:start + size], k,
                                       self._dtype)
                          for X, k in self._stored()], 1)

    def _gram_main(self, weight):
        """(X' W X, X' w) over the uncentered main columns (sparse.py
        :1598-1648): row chunks of the stored blocks, up-converted to the
        working dtype side by side, through :func:`.gram.chunked_gram`,
        then put in column order."""
        n, p_main = self._shape_main
        if not self._stored():
            return (torch.zeros((p_main, p_main), dtype=self._dtype,
                                device=self.device),
                    torch.zeros(p_main, dtype=self._dtype,
                                device=self.device))
        G, s1 = chunked_gram(self._main_panel, n, p_main, weight,
                             self._dtype)
        inv = torch.argsort(self._own_cols())
        return G[inv][:, inv], s1[inv]

    def _ell_gram_main(self, weight):
        """(X' W X, X' w) over the uncentered main columns (sparse.py
        :1633-1648): each row chunk's (slot -> column) pairs scattered
        into a bounded dense panel, through :func:`.gram.chunked_gram`.
        A padded slot adds value 0 at column 0."""
        p_main = self._shape_main[1]
        width = self.row_idx.shape[1]

        def chunk(start, size):
            idx = self.row_idx[start:start + size].long()
            rows = torch.arange(size, device=self.device)[:, None] \
                .expand(-1, width)
            Z = torch.zeros((size, p_main), dtype=self._dtype,
                            device=self.device)
            return Z.index_put_((rows, idx), self.row_val[start:start + size],
                                accumulate=True)

        return chunked_gram(chunk, self._shape_main[0], p_main, weight,
                            self._dtype)

    def compute_transposed_fisher_info(self, weight, include_intrcpt=False):
        """X diag(weight) X' over predictors, the intercept's weight first
        with `include_intrcpt` (sparse.py:1650-1661): n x n, small designs
        only."""
        weight = self._as_tensor(weight)
        weight_main = weight[1:] if include_intrcpt else weight
        X = self._materialize_main()
        if self.centered:
            X = X - self.column_offset[None, :]
        with full_float32():
            result = (X * weight_main[None, :]) @ X.T
        if include_intrcpt:
            result = result + weight[0]
        return result

    # -- densification (small designs: tests, diagnostics) ---------------- #

    def _materialize_main(self):
        """The uncentered main design on the device, for the packed
        backends' and the transposed Fisher products; guarded."""
        n, p_main = self._shape_main
        if n * p_main > _DENSE_FISHER_MAX_ELEMS:
            raise MemoryError(
                "Refusing to densify a {:d} x {:d} sparse design for the "
                "dense Fisher-information path; use the CG sampler."
                .format(n, p_main))
        return self._densify_main().to(self.device)

    def _densify_main(self):
        """(n, p) CPU tensor of the stored main design in the working
        dtype, uncentered (sparse.py:1691-1752)."""
        n, p = self._shape_main
        X = torch.zeros((n, p), dtype=self._dtype)
        if self.backend == 'bitpack' or (self.backend == 'hybrid'
                                         and self._stored()):
            X[:, self._own_cols().cpu()] = self._main_panel(0, n).cpu()
        if self.backend in ('hybrid', 'bitpack'):
            return X
        if self.backend == 'ell':
            rows = torch.arange(n)[:, None].expand(-1, self.row_idx.shape[1])
            # A padded slot adds value 0 at column 0.
            return X.index_put_((rows, self.row_idx.cpu().long()),
                                self.row_val.cpu(), accumulate=True)
        X[:] = torch.from_numpy(self.wc_dot.to_scipy().toarray())
        return X

    def extract_matrix(self, order=None):
        """The full design (intercept and centering included) as a dense
        tensor on the design's device (sparse.py:1762-1763); guarded, for
        small designs. `order` is kept for the JAX signature."""
        X = self._materialize_main()
        if self.centered:
            X = X - self.column_offset[None, :]
        if self.intercept_added:
            X = torch.cat((torch.ones((X.shape[0], 1), dtype=X.dtype,
                                      device=X.device), X), 1)
        return X

    def toarray(self):
        """Dense numpy copy of the full design (intercept and centering
        included)."""
        X = self._densify_main().numpy()
        if self.centered:
            X = X - self.column_offset.cpu().numpy()[None, :]
        if self.intercept_added:
            X = np.hstack((np.ones((X.shape[0], 1), X.dtype), X))
        return X
