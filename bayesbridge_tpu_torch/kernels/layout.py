"""The design blocks' storage contract, shared by both sweeps.

A block is a row-major ``(n, ld)`` tensor of int8, bfloat16 or float32
whose first ``p <= ld`` columns are logical, or a packed int4 block: a
``torch.uint8`` tensor ``(n, ld / 2)`` holding two columns a byte, the
even column in the low nibble, each a two's-complement value in [-8, 7]
(the JAX package's packed-s4 device array, ``sparse.py:492-493``). For
the CUDA kernels the row stride must be a whole number of 16-byte
vectors and the base 16-byte aligned; the design pads its blocks with
zero columns to a multiple of ``COL_ALIGN`` elements (``INT4_ALIGN``
columns, 16 bytes, for a packed block), which satisfies every storage
type. The plain versions read the first ``p`` columns (unpacked) and
take any layout.

Also here: the plain chunked products that up-convert a narrow block in
row chunks, so that no full float32 copy of a block ever exists (the
flagship's 4.5 GB int8 block would be 18 GB in f32), and
:func:`pack_int4` / :func:`unpack_int4`, exact on either device.
"""

import collections
import math

import torch

COL_ALIGN = 16
INT4_ALIGN = 32  # columns of a packed block's 16-byte unit
# Storage codes of the kernels (csrc/sweep_common.cuh DType); a uint8
# tensor is a packed int4 block.
INT4 = torch.uint8
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, INT4: 3}
# Bound on the float32 transient of one up-converted row chunk.
CHUNK_BYTES = 2 ** 28


def padded_width(p, int4=False):
    """Stored column count for `p` logical columns (of a packed int4
    block with `int4`: a multiple of 32, 16 bytes a row unit)."""
    align = INT4_ALIGN if int4 else COL_ALIGN
    return max(align, -(-p // align) * align)


def is_int4(X):
    return X.dtype == INT4


def stored_columns(X):
    """Columns a stored block holds: two a byte for a packed int4 one."""
    return X.shape[1] * (2 if is_int4(X) else 1)


def pack_int4(X, p=None):
    """The packed int4 block of the first `p` columns (default all) of
    an int8 block X: uint8, (n, padded_width(p, int4=True) / 2), column
    2j in the low nibble of byte j, column 2j + 1 in the high one, zero
    past column p. Packs in row chunks, on X's device; raises unless
    every packed value lies in [-8, 7]."""
    if X.dtype != torch.int8 or X.dim() != 2:
        raise ValueError(f"pack_int4 takes an int8 (n, ld) block; got "
                         f"{X.dtype} {tuple(X.shape)}")
    n = X.shape[0]
    p = X.shape[1] if p is None else p
    out = torch.zeros((n, padded_width(p, int4=True) // 2), dtype=INT4,
                      device=X.device)
    step = max(1, CHUNK_BYTES // max(1, p))
    for i in range(0, n, step):
        x = X[i:i + step, :p]
        if bool(((x < -8) | (x > 7)).any()):
            raise ValueError("pack_int4: a value lies outside [-8, 7]")
        b = x.view(torch.uint8) & 0x0F
        even, odd = b[:, 0::2], b[:, 1::2]
        rows = out[i:i + step]
        rows[:, :even.shape[1]] = even
        rows[:, :odd.shape[1]] |= odd << 4
    return out


def unpack_int4(X, p=None):
    """The int8 block (n, 2 ld_bytes) of a packed int4 block, or its first
    `p` columns: exact (each nibble sign-extended)."""
    n = X.shape[0]
    lo = ((X & 0x0F).view(torch.int8) ^ 8) - 8
    hi = ((X >> 4).view(torch.int8) ^ 8) - 8
    out = torch.stack((lo, hi), -1).reshape(n, 2 * X.shape[1])
    return out if p is None else out[:, :p]


def int4_is_binary(X, p):
    """Whether the first `p` columns of packed int4 block X hold only 0
    and 1 (each byte's nibbles 0000 or 0001); one pass in row chunks, on
    X's device."""
    full = p // 2
    step = max(1, CHUNK_BYTES // max(1, X.shape[1]))
    for i in range(0, X.shape[0], step):
        rows = X[i:i + step]
        if full and bool((rows[:, :full] & 0xEE).any()):
            return False
        if p % 2 and bool((rows[:, full] & 0x0E).any()):
            return False
    return True


def widen(X, p, dtype=torch.float32):
    """The first `p` logical columns of stored block X in `dtype` (a
    packed int4 block unpacked on the way)."""
    if is_int4(X):
        return unpack_int4(X, p).to(dtype)
    return X[:, :p].to(dtype)


def check_block(X, p, name='X'):
    """Validate a stored block for the kernels; returns (n, ld), ld the
    stored columns."""
    if X.dim() != 2:
        raise ValueError(f"{name} must be 2-d, got shape {tuple(X.shape)}")
    if X.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: storage dtype {X.dtype} not in "
                        "int8 / bfloat16 / float32 / packed int4 (uint8)")
    if not X.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")
    n, ld = X.shape[0], stored_columns(X)
    if not 0 < p <= ld:
        raise ValueError(f"{name}: logical width {p} outside (0, {ld}]")
    return n, ld


def check_cuda_layout(X, name='X'):
    """The kernels read whole 16-byte vectors of every row (of a packed
    int4 block, 32 columns)."""
    vec = 16 // X.element_size()
    if X.shape[1] % vec or X.data_ptr() % 16:
        raise ValueError(
            f"{name}: the CUDA kernels need a 16-byte row stride and base "
            f"(row width {X.shape[1]} must be a multiple of {vec}); store "
            f"blocks with `padded_width` columns")


def check_vector(x, n, name, device):
    if x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] != n \
            or x.device != device or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 vector of "
                         f"length {n} on {device}; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def check_chains(name, device, k, *mats):
    """Raise unless each of `mats` is a contiguous float32 (k, m) tensor
    on `device` (k chains' vectors)."""
    for m in mats:
        if m.dtype != torch.float32 or m.dim() != 2 or m.shape[0] != k \
                or m.device != device or not m.is_contiguous():
            raise ValueError(f"{name}: chain-batched operands must be "
                             f"contiguous float32 (k, m) on {device}, k = "
                             f"{k}; got {m.dtype} {tuple(m.shape)} on "
                             f"{m.device}")


def check_second_block(Xs):
    """The chain-batched kernels take an f32 second block (or none)."""
    if len(Xs) == 2 and Xs[1].dtype != torch.float32:
        raise TypeError("chain-batched kernels: the second block must be "
                        "float32 (the hybrid design's float block)")


def chain_groups(k, cmax):
    """(first chain, count) of each launch for k chains, cmax a launch."""
    return [(c0, min(cmax, k - c0)) for c0 in range(0, k, cmax)]


# The chain-batched kernels' launch geometry, as csrc/sweep_common.cuh
# sets it (bb_batched_smem reports the C side's shared memory; the tests
# on the card compare).
MAX_CHAINS = 8
SMEM_PER_CTA = 232_448        # bytes of shared memory a CTA may use
ROWS_K = dict(warps={2: 16, 4: 12, 8: 12}, rows_per_warp=8, chunk=512,
              stages=3, x_stages=3)
TDOTS_K = dict(threads=256, panel_bytes=16_384, stages=4)  # 5-8 chains
COLS_K_UROWS = 128            # rows of u the column pass stages at a time
BATCHED_KINDS = {'rows': 0, 'cols': 1, 'tdots4': 4, 'tdots5': 5}


# One batched launch: the `chains` it serves, the `compiled` chains (k
# rounded up), `rows_per_panel` and `column_chunk` per block (the rows and
# columns a CTA stages or owns at a time), `smem_bytes` per CTA.
BatchedPlan = collections.namedtuple(
    'BatchedPlan', 'chains compiled rows_per_panel column_chunk smem_bytes')


def _compiled_chains(kind, nc):
    c = 1 if nc <= 1 else 2 if nc == 2 else 4 if nc <= 4 else 8
    return max(c, 2) if kind == 'rows' else c


def batched_plan(kind, dtypes, k):
    """The launch geometry of a batched kernel for `k` chains over blocks
    of storage `dtypes` (the second float32): `kind` 'rows' (ne_rows_k),
    'cols' (colpass_k) or 'tdots4' / 'tdots5' (tdots_sweep_k)."""
    if kind not in BATCHED_KINDS:
        raise ValueError(f"kind must be one of {sorted(BATCHED_KINDS)}")
    sizes = [torch.empty((), dtype=d).element_size() for d in dtypes]
    nc = min(k, MAX_CHAINS)
    C = _compiled_chains(kind, nc)
    if kind == 'rows':
        return BatchedPlan(
            MAX_CHAINS, C,
            (ROWS_K['warps'][C] * ROWS_K['rows_per_warp'],) * len(sizes),
            (ROWS_K['chunk'],) * len(sizes),
            ROWS_K['stages'] * C * ROWS_K['chunk'] * 4
            + ROWS_K['warps'][C] * ROWS_K['x_stages']
            * ROWS_K['rows_per_warp'] * 512)
    if kind == 'cols' or nc <= 4:
        # The register-tiled column pass (ColPlan): a thread owns the
        # widest unit of a row (16, 8 or 4 bytes) whose 8 chains' R
        # accumulators fit 80 registers; u staged 128 rows at a time.
        R = 1 if kind == 'cols' else BATCHED_KINDS[kind]
        units = [next((u for u in (16, 8) if R * 8 * u // s <= 80), 4)
                 for s in sizes]
        return BatchedPlan(
            MAX_CHAINS, C, (COLS_K_UROWS,) * len(sizes),
            tuple(256 * u // s for u, s in zip(units, sizes)),
            COLS_K_UROWS * max(R - 1, 1) * C * 4)
    # 5-8 chains of the pre-solve: two groups of 4 chains, 4 columns a
    # thread, panels of the tile staged with the chains' u's.
    R = BATCHED_KINDS[kind]
    tile_cols = TDOTS_K['threads'] // 2 * 4
    rows = tuple(TDOTS_K['panel_bytes'] // (tile_cols * s) for s in sizes)
    u_bytes = 4 * (R - 1) * rows[0] * C
    return BatchedPlan(MAX_CHAINS, C, rows, (tile_cols,) * len(sizes),
                       TDOTS_K['stages'] * (TDOTS_K['panel_bytes']
                                            + u_bytes))


def elem_ptr(t, offset_elems):
    """The address of element `offset_elems` of a contiguous tensor."""
    return t.data_ptr() + offset_elems * t.element_size()


def segments(n, tiles, device):
    """(n_seg, rows_per_seg) for the column pass: enough row segments that
    `tiles` column tiles times the segments fill the card about four
    blocks deep, none shorter than 256 rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return segments_for(n, tiles, sms)


def segments_for(n, tiles, sms):
    """:func:`segments` on a card of `sms` SMs."""
    n_seg = max(1, min(math.ceil(4 * sms / max(tiles, 1)),
                       math.ceil(n / 256)))
    rows = math.ceil(n / n_seg)
    return math.ceil(n / rows), rows


# The nibble pre-solve's geometry, as csrc/tdots_sweep.cu sets it (kI4*;
# bb_tdots_i4_plan reports the C side, and the tests on the card
# compare): u staged `urows` rows at a time as one float4 a row, tiles of
# 256 lanes x 8 nibble columns and 256 x 2 f32 columns.
PRESOLVE_I4 = dict(urows=1024, tile_cols=(2048, 512), min_blocks=2)

# `n_seg` segments of `rows_per_seg` rows, `tiles` (nibble, f32) of
# `tile_columns` columns each, `smem_bytes` a CTA, `min_blocks` CTAs an
# SM is compiled for.
PresolveI4Plan = collections.namedtuple(
    'PresolveI4Plan',
    'n_seg rows_per_seg tiles tile_columns smem_bytes min_blocks')


def presolve_i4_plan(n, p_int4, p_f32, sms):
    """The launch geometry of the nibble pre-solve over `n` rows of a
    packed int4 block of `p_int4` logical columns beside an f32 block of
    `p_f32` (0: none) on a card of `sms` SMs. The row segments are the
    int8 mode's, from its 16-column tiling of the same blocks: each column
    then sums the same rows in the same order, so the two give the same
    bits; the tiles are the kernel's own."""
    int8_tiles = math.ceil(p_int4 / (256 * 16)) + math.ceil(p_f32 / (256 * 4))
    n_seg, rows = segments_for(n, int8_tiles, sms)
    tc0, tc1 = PRESOLVE_I4['tile_cols']
    return PresolveI4Plan(
        n_seg, rows, (math.ceil(p_int4 / tc0), math.ceil(p_f32 / tc1)),
        (tc0, tc1), 16 * PRESOLVE_I4['urows'], PRESOLVE_I4['min_blocks'])


def splits(n_units, tiles, device):
    """(n_split, units_per_split): contiguous splits of `n_units` work
    units (byte-group chunks, input windows) such that `tiles` blocks
    times the splits fill the card at most four blocks deep. Rounding
    down: a few blocks over 4 x SMs leave some SMs a fifth block while
    the rest hold four, and the kernel waits for them (rounding up gave
    bitlut's X v at the flagship 25 x 22 = 550 blocks on 132 SMs)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_split = max(1, min(4 * sms // max(tiles, 1), n_units))
    per = math.ceil(n_units / n_split)
    return math.ceil(n_units / per), per


def col_tiles(p, X):
    """Column tiles of the column pass over a block (256 threads x one
    16-byte vector each; of a packed int4 block, 8 bytes or 16 columns
    each, the int8 tile's columns)."""
    return math.ceil(p / (256 * (16 // X.element_size())))


def _row_chunk(X, p):
    return max(1, CHUNK_BYTES // (4 * max(p, 1)))


def matvec(X, p, v):
    """X[:, :p] @ v in float32, up-converting (unpacking) X in row
    chunks."""
    n = X.shape[0]
    step = _row_chunk(X, p)
    if step >= n:
        return widen(X, p) @ v
    return torch.cat([widen(X[i:i + step], p) @ v
                      for i in range(0, n, step)])


def rmatvec(X, p, U, square=False):
    """X[:, :p]' @ U in float32 (U: (n,) or (n, k)), or (X.X)' @ U with
    `square`, up-converting (unpacking) X in row chunks and summing the
    chunks' partial products in order."""
    n = X.shape[0]
    step = _row_chunk(X, p)
    out = None
    for i in range(0, n, step):
        Xc = widen(X[i:i + step], p)
        if square:
            Xc = Xc * Xc
        part = Xc.T @ U[i:i + step]
        out = part if out is None else out + part
    return out
