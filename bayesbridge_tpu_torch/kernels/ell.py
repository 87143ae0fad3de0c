"""Row-ELL matvec for up to 8 vectors: wrapper and plain version.

The ell design backend's product (:mod:`..design.ell`). For row-ELL
arrays ``idx`` (m, width) int32 and ``val`` (m, width) of an (m, n_in)
matrix A (every row padded with index 0, value 0) and k vectors X (k,
n_in) it computes

    out[c, r] = sum_s val[r, s] ** power * X[c, idx[r, s]]

with power 1 (A x) or 2 (the Fisher diagonal's second moment). It
replaces the XLA gathers of the JAX package's ell backend
(``bayesbridge_tpu/design/sparse.py:1006-1008, :1033-1036, :1535-1537``;
no Pallas kernel).

On a CUDA tensor :func:`ell_matvec_k` launches a hand-written kernel of
``csrc/ell.cu`` (or raises), on a CPU tensor it runs
:func:`ell_matvec_k_plain`. One launch serves up to 8 vectors, handed to
the kernel interleaved (X' contiguous, one index's values side by side);
more take ceil(k / 8) launches. Each vector's result is the bits of its
single-vector launch.

Three traversals give the same bits. The first (``bb_ell``) gathers each
slot's values through L2; the windowed one (``bb_ell_win``) stages windows
of the vectors in shared memory and needs an :class:`EllLayout` of the
arrays with window pointers (ascending indices within each row), which
the ell design builds once for its col-ELL on a CUDA device
(:func:`col_layout`); the staged one (``bb_ell_st``) holds a prefix of
the k vectors in each CTA's shared memory for the whole launch
(:func:`stage_plan`) and gathers the rest through L2. :func:`ell_matvec_k`
takes the windowed traversal where such a layout is given and
:func:`takes_window` says so for the launch, else the staged one where
:func:`takes_stage` says so, both by the launch's bytes; the first one
otherwise. ``launches[tag]`` counts the first traversal's launches per
orientation ('dot' on the row-ELL, 'tdot' on the col-ELL),
``launches['tdot_win']`` the windowed traversal's, ``launches[tag +
'_st']`` the staged traversal's.
"""

import math

import numpy as np
import torch

from .build import count_launch, load_library

launches = {'dot': 0, 'tdot': 0, 'tdot_win': 0, 'dot_st': 0,
            'tdot_st': 0}
MAX_VECTORS = 8  # vectors per launch (csrc/ell.cu kMaxVectors)

GRAIN = 1024  # inputs per step of a layout's window pointers
STAGES = 2    # windows a CTA of the windowed traversal stages (kStages)
MAX_SMEM = 232448  # dynamic shared memory the kernel takes at most
# Bytes of the k vectors a window holds at most, by k = 1..8: above
# k = 1 a 64 KB window holds too few of a row's slots, and fewer, larger
# windows ran faster
WIN_BYTES = (65536, 98304, 98304, 98304, 114688, 98304, 114688, 98304)

# The dispatch by bytes (:func:`takes_window`), from the timings in turns
# on the H100 (baselines/ell_variants.py at 16, 40 and 164 entries a row;
# PERF.md). The first traversal moves one or two 32-byte L2 sectors a
# slot, at about SECTOR_BYTES_PER_S (float64, one vector); the windowed
# one copies each CTA's windows of the vectors from L2 whole, at about
# twice that rate, and walks every (row, window) pair of its rows, one
# memory round trip each, about ROW_WINDOW_S of an SM's time where the
# windows hold few slots of a row. The first traversal won wherever the
# vectors fit an SM's 256 KB of L1.
STAGED_PER_SECTOR = 2.0
SECTOR_BYTES_PER_S = 3.5e12
ROW_WINDOW_S = 31e-9
L1_BYTES = 256 * 1024
# The staged traversal (:func:`takes_stage`), from the timings in turns on
# the H100 (baselines/ell_variants.py, the row-ELL of 16,384 and 50,000
# inputs, k = 1..8; PERF.md): it took a launch faster than the first
# traversal wherever the vectors took more than STAGE_MIN_BYTES (the
# first traversal's gathers hit L1 below that) and the stage held at
# least STAGE_SHARE of them. A stage takes at most STAGE_BYTES of a CTA's
# shared memory (kStMaxSmem: room for the kernel's static shared memory).
STAGE_MIN_BYTES = 128 * 1024
STAGE_SHARE = 0.25
STAGE_BYTES = MAX_SMEM - 1024
# The share of the col-ELL arrays' bytes the window pointers may take
# (they grow with m * n_in, not with the nonzeros; a quarter of the col-ELL
# is an eighth of the design's two orientations): above it the design
# keeps no pointers and its col-ELL stays on the first traversal.
POINTER_SHARE = 1 / 4


def valid_counts(idx, val):
    """(m,) int32: each ELL row's valid slots, one plus the last slot whose
    index or value is non-zero (0 for a row of padding alone)."""
    nz = (np.asarray(idx) != 0) | (np.asarray(val) != 0)
    width = nz.shape[1]
    last = width - 1 - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), last + 1, 0).astype(np.int32)


def rows_sorted(idx, valid, chunk=4096):
    """Whether every row's indices ascend (non-decreasing) over its valid
    slots; rows taken `chunk` at a time to bound the temporaries."""
    idx = np.asarray(idx)
    for r in range(0, idx.shape[0], chunk):
        d = np.diff(idx[r:r + chunk], axis=1) < 0
        inside = np.arange(d.shape[1])[None, :] < valid[r:r + chunk, None] - 1
        if np.any(d & inside):
            return False
    return True


def pointer_bytes(m, n_in):
    """Bytes of the window pointers of m ELL rows over n_in inputs."""
    return 4 * m * (-(-n_in // GRAIN) + 1)


def window_pointers(idx, valid, n_in, chunk=4096):
    """(m, ceil(n_in / GRAIN) + 1) int32 for rows with ascending indices:
    entry [r, g] is the first valid slot of row r whose index is >= g *
    GRAIN, the last column the row's valid slots."""
    idx = np.asarray(idx)
    m, width = idx.shape
    n_grains = -(-n_in // GRAIN)
    ptr = np.zeros((m, n_grains + 1), np.int32)
    for r in range(0, m, chunk):
        rows = idx[r:r + chunk]
        inside = np.arange(width)[None, :] < valid[r:r + chunk, None]
        owner = np.nonzero(inside)[0]
        counts = np.bincount(owner * n_grains + rows[inside] // GRAIN,
                             minlength=rows.shape[0] * n_grains)
        ptr[r:r + chunk, 1:] = np.cumsum(
            counts.reshape(rows.shape[0], n_grains), axis=1)
    return ptr


def card_of(device):
    """fn(dtype, k) -> (SMs, the kernel's most ELL rows a CTA) for the
    windowed traversal on CUDA `device` (``bb_ell_win_rows``)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    lib = load_library().lib
    return lambda dtype, k: (n_sm, lib.bb_ell_win_rows(
        k, int(dtype == torch.float64)))


class EllLayout:
    """What the windowed traversal needs of one ELL array pair, built once
    on the host (:meth:`from_numpy`).

    Attributes
    ----------
    valid : (m,) int32 tensor, each row's valid slots (one plus the last
        slot whose index or value is non-zero)
    n_valid : their sum
    ascending : whether each row's indices ascend over its valid slots
    win_ptr : (m, ceil(n_in / GRAIN) + 1) int32 tensor on the arrays'
        device, entry [r, g] the first valid slot of row r with index >= g
        * GRAIN (the last column: `valid`); None where the layout keeps no
        pointers (rows that do not ascend, or none asked for)
    n_in : the input length (the vectors' length)
    """

    def __init__(self, valid, ascending, win_ptr, n_in, card=None):
        self.valid = valid
        self.n_valid = int(valid.sum())
        self.ascending = bool(ascending)
        self.win_ptr = win_ptr
        self.n_in = int(n_in)
        self._card = card

    @classmethod
    def from_numpy(cls, idx, val, n_in, device='cpu', pointers=True,
                   card=None):
        """The layout of host arrays (idx, val), its tensors on `device`;
        window pointers where the rows ascend and `pointers` is true;
        `card` as :func:`card_of` gives it (by default the pointers'
        device's)."""
        idx, val = np.asarray(idx), np.asarray(val)
        valid = valid_counts(idx, val)
        live = np.arange(idx.shape[1])[None, :] < valid[:, None]
        if np.any(live & ((idx < 0) | (idx >= n_in))):
            raise ValueError(f"ELL indices outside [0, {n_in})")
        ascending = rows_sorted(idx, valid)
        ptr = window_pointers(idx, valid, n_in) if ascending and pointers \
            else None
        as_dev = (lambda a: None if a is None
                  else torch.from_numpy(a).to(device))
        return cls(as_dev(valid), ascending, as_dev(ptr), n_in, card)

    def tensors(self):
        """The layout's device tensors."""
        return tuple(t for t in (self.valid, self.win_ptr) if t is not None)

    def card(self, dtype, k):
        """(SMs, rows a CTA at most) of the card the pointers lie on."""
        if self._card is None:
            self._card = card_of(self.win_ptr.device)
        return self._card(dtype, k)

    def windowed(self, dtype, k):
        """Whether a launch of k vectors in `dtype` takes the windowed
        traversal: the layout has window pointers and
        :func:`takes_window` says so on its card."""
        if self.win_ptr is None or not 1 <= k <= MAX_VECTORS:
            return False
        return takes_window(dtype, k, self.valid.shape[0], self.n_in,
                            self.n_valid, *self.card(dtype, k))


def col_layout(idx, val, n_in, dtype, device, card=None):
    """The layout the ell design keeps for its col-ELL (idx, val), host
    arrays of m rows over n_in inputs whose products run in `dtype` on
    `device`: None on the CPU, where every product is the plain version;
    else valid slots, and window pointers where the rows ascend, the
    pointers take at most POINTER_SHARE of the arrays' bytes and
    :func:`takes_window` gives some k the windowed traversal on `card`
    (fn(dtype, k) -> (SMs, rows a CTA); by default the device's)."""
    if card is None:
        if torch.device(device).type != 'cuda':
            return None
        card = card_of(device)
    idx, val = np.asarray(idx), np.asarray(val)
    lay = EllLayout.from_numpy(idx, val, n_in, device, pointers=False,
                               card=card)
    m, width = idx.shape
    item = torch.empty((), dtype=dtype).element_size()
    if lay.ascending and pointer_bytes(m, n_in) \
            <= POINTER_SHARE * m * width * (4 + item) \
            and any(takes_window(dtype, k, m, n_in, lay.n_valid,
                                 *card(dtype, k))
                    for k in range(1, MAX_VECTORS + 1)):
        lay.win_ptr = torch.from_numpy(window_pointers(
            idx, lay.valid.cpu().numpy(), n_in)).to(device)
    return lay


def win_plan(dtype, k, m, n_in, n_sm, rows_max, win_bytes=None):
    """The windowed traversal's launch for m ELL rows, k vectors of n_in
    inputs on a card of n_sm SMs whose kernel takes at most `rows_max`
    rows a CTA (``bb_ell_win_rows``): the window (`window` inputs, the
    largest multiple of GRAIN, at least GRAIN, whose k vectors fit
    `win_bytes`, by default ``WIN_BYTES[k - 1]``; cut to the inputs
    rounded up to GRAIN), `stride` = window / GRAIN, `n_win` windows,
    `n_pad` = n_win * window rows of the padded interleaved vectors,
    `copy_bytes` a bulk copy, `smem_bytes` a CTA's dynamic shared memory,
    `rows_cta` ELL rows a CTA (ceil(m / n_sm), at most `rows_max`) and
    `n_cta` CTAs."""
    item = 8 if dtype == torch.float64 else 4
    win_bytes = WIN_BYTES[k - 1] if win_bytes is None else win_bytes
    window = max(1, win_bytes // (k * item) // GRAIN) * GRAIN
    window = min(window, -(-max(n_in, 1) // GRAIN) * GRAIN)
    n_win = -(-max(n_in, 1) // window)
    rows_cta = max(1, min(rows_max, -(-m // n_sm)))
    return dict(window=window, stride=window // GRAIN, n_win=n_win,
                n_pad=n_win * window, copy_bytes=window * k * item,
                smem_bytes=STAGES * window * k * item, rows_cta=rows_cta,
                n_cta=-(-m // rows_cta))


def sectors_per_gather(k, item):
    """The 32-byte sectors a gather of one index's k values spans, on
    average over the indices (index j's values at byte j * k * item of
    the interleaved vectors)."""
    span = k * item
    period = 32 // math.gcd(span, 32)
    return sum((j * span % 32 + span + 31) // 32
               for j in range(period)) / period


def takes_window(dtype, k, m, n_in, n_valid, n_sm, rows_max):
    """Whether a launch of k vectors over m ELL rows with n_valid valid
    slots and n_in inputs takes the windowed traversal: the vectors
    outgrow L1_BYTES, the bytes its CTAs stage (n_cta * n_pad * k *
    itemsize) are at most STAGED_PER_SECTOR times the L2 sectors the
    first traversal's gathers move, and its walk over the (row, window)
    pairs (m * n_win / n_sm * ROW_WINDOW_S) takes no longer than those
    sectors at SECTOR_BYTES_PER_S."""
    item = 8 if dtype == torch.float64 else 4
    if k * n_in * item <= L1_BYTES:
        return False
    plan = win_plan(dtype, k, m, n_in, n_sm, rows_max)
    staged = plan['n_cta'] * plan['n_pad'] * k * item
    sectors = n_valid * sectors_per_gather(k, item) * 32
    walk_s = m * plan['n_win'] / n_sm * ROW_WINDOW_S
    return staged <= STAGED_PER_SECTOR * sectors \
        and walk_s <= sectors / SECTOR_BYTES_PER_S


def stage_plan(dtype, k, n_in, stage_bytes=STAGE_BYTES):
    """The staged traversal's stage for k vectors of n_in inputs: the
    first `n_staged` inputs' k values, a multiple of 4 inputs (whole
    16-byte units) within `stage_bytes` of a CTA's shared memory (at most
    STAGE_BYTES), or all of them (n_in rounded up to 4). Returns
    dict(n_staged, smem_bytes, n_pad (rows of the padded interleaved
    vectors), staged (the share of the inputs staged))."""
    item = 8 if dtype == torch.float64 else 4
    cap = min(stage_bytes, STAGE_BYTES) // (k * item) // 4 * 4
    if cap < 4:
        raise ValueError(f"no stage of {k} vectors in {stage_bytes} bytes")
    whole = -(-max(n_in, 1) // 4) * 4
    n_staged = min(whole, cap)
    return dict(n_staged=n_staged, smem_bytes=n_staged * k * item,
                n_pad=max(n_in, n_staged),
                staged=min(1.0, n_staged / max(n_in, 1)))


def takes_stage(dtype, k, n_in):
    """Whether a launch of k vectors of n_in inputs takes the staged
    traversal: the vectors take more than STAGE_MIN_BYTES and its stage
    holds at least STAGE_SHARE of them (:func:`stage_plan`)."""
    item = 8 if dtype == torch.float64 else 4
    if k * n_in * item <= STAGE_MIN_BYTES:
        return False
    return stage_plan(dtype, k, n_in)['staged'] >= STAGE_SHARE


def ell_matvec_k_plain(idx, val, X, power=1):
    """The product in plain PyTorch: gather, multiply, sum over the
    slots. Same arguments as :func:`ell_matvec_k`."""
    a = val * val if power == 2 else val
    return (a * X[..., idx.long()]).sum(-1)


def ell_matvec_k(idx, val, X, power=1, tag='dot', layout=None):
    """out (m,) for X (n_in,), or (k, m) for X (k, n_in); see the module
    docstring.

    Parameters
    ----------
    idx : (m, width) int32, contiguous
    val : (m, width) float32 or float64, contiguous
    X : (n_in,) or (k, n_in) of val's dtype, contiguous, on val's device
    power : 1 or 2
    tag : 'dot' | 'tdot', the launch counter to advance
    layout : an :class:`EllLayout` of (idx, val), or None (the first
        traversal)
    """
    if tag not in ('dot', 'tdot'):
        raise ValueError("tag must be 'dot' or 'tdot'")
    if power not in (1, 2):
        raise ValueError(f"power must be 1 or 2, got {power}")
    if idx.dtype != torch.int32 or val.dtype not in (torch.float32,
                                                     torch.float64) \
            or idx.dim() != 2 or idx.shape != val.shape \
            or not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("the ELL arrays need contiguous int32 idx and "
                         "float32 or float64 val of one (m, width) shape")
    if X.dtype != val.dtype or X.dim() not in (1, 2) \
            or not X.is_contiguous() \
            or len({idx.device, val.device, X.device}) != 1:
        raise ValueError(f"X must be a contiguous {val.dtype} vector or "
                         f"(k, n_in) matrix on {val.device}")
    if layout is not None and (layout.n_in != X.shape[-1]
                               or layout.valid.shape[0] != idx.shape[0]):
        raise ValueError("the layout is of other arrays")
    if layout is not None and tag != 'tdot':
        raise ValueError("a layout serves the col-ELL (tag 'tdot')")
    if layout is not None and layout.win_ptr is not None \
            and layout.win_ptr.device != idx.device:
        raise ValueError(f"the layout is on {layout.win_ptr.device}, the "
                         f"arrays on {idx.device}")
    if X.device.type == 'cpu':
        return ell_matvec_k_plain(idx, val, X, power)
    if X.device.type != 'cuda':
        raise ValueError(f"no ell_matvec_k for device {X.device}")
    if X.dim() == 1:
        return _ell_cuda(idx, val, X[None], power, tag, layout)[0]
    return torch.cat([_ell_cuda(idx, val, X[c:c + MAX_VECTORS], power, tag,
                                layout)
                      for c in range(0, X.shape[0], MAX_VECTORS)])


def _ell_cuda(idx, val, X, power, tag, layout):
    m, width = idx.shape
    k, n_in = X.shape
    out = torch.empty((k, m), dtype=val.dtype, device=X.device)
    if m == 0 or k == 0:
        return out
    if n_in == 0 or width == 0:  # no entry to gather
        return out.zero_()
    kl = load_library()
    if layout is not None and layout.windowed(val.dtype, k):
        win_launch(kl, idx, val, layout, X, power, out)
        count_launch(launches, tag + '_win')
        return out
    if takes_stage(val.dtype, k, n_in):
        stage_launch(kl, idx, val, X, power, out,
                     stage_plan(val.dtype, k, n_in))
        count_launch(launches, tag + '_st')
        return out
    Xt = X.t().contiguous()  # (n_in, k): one index's values side by side
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = kl.lib.bb_ell(idx.data_ptr(), val.data_ptr(), m, width,
                           Xt.data_ptr(), k, power,
                           int(val.dtype == torch.float64), out.data_ptr(),
                           stream)
    kl.check(rc, 'ell_matvec_k')
    count_launch(launches, tag)
    return out


def win_launch(kl, idx, val, layout, X, power, out, win_bytes=None,
               rows_max=None):
    """One launch of the windowed traversal from library `kl` (uncounted)
    for X (k <= 8, n_in) into out (k, m); `win_bytes` and `rows_max` as in
    :func:`win_plan`."""
    m, width = idx.shape
    k, n_in = X.shape
    dev = X.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if rows_max is None:
        rows_max = kl.lib.bb_ell_win_rows(k, int(val.dtype == torch.float64))
    plan = win_plan(val.dtype, k, m, n_in, n_sm, rows_max, win_bytes)
    # The interleaved vectors padded to whole windows (the tail rows are
    # copied but never gathered).
    Xt = torch.empty((plan['n_pad'], k), dtype=X.dtype, device=dev)
    Xt[:n_in] = X.t()
    ptr = layout.win_ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = kl.lib.bb_ell_win(
            idx.data_ptr(), val.data_ptr(), m, width, ptr.data_ptr(),
            ptr.shape[1], plan['stride'], Xt.data_ptr(), k, power,
            int(val.dtype == torch.float64), plan['window'], plan['n_win'],
            plan['rows_cta'], out.data_ptr(), stream)
    kl.check(rc, 'ell_matvec_k (windowed)')
    return out


def stage_launch(kl, idx, val, X, power, out, plan):
    """One launch of the staged traversal from library `kl` (uncounted)
    for X (k <= 8, n_in) into out (k, m) with `plan` (:func:`stage_plan`):
    as many CTAs as the card's SMs hold at once with that stage, rows
    split evenly among them."""
    m, width = idx.shape
    k, n_in = X.shape
    dev = X.device
    f64 = int(val.dtype == torch.float64)
    key = (kl.lib._name, str(dev), k, f64, plan['n_staged'])
    if key not in _CTAS:
        with torch.cuda.device(dev):
            per_sm = kl.lib.bb_ell_st_fit(k, f64, plan['n_staged'])
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        if per_sm < 1:
            raise RuntimeError(f"ell_matvec_k (staged): a stage of "
                               f"{plan['smem_bytes']} bytes fits no SM")
        _CTAS[key] = per_sm * n_sm
    # The interleaved vectors padded to the whole stage (the tail rows
    # are copied but never gathered).
    Xt = torch.empty((plan['n_pad'], k), dtype=X.dtype, device=dev)
    Xt[:n_in] = X.t()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = kl.lib.bb_ell_st(
            idx.data_ptr(), val.data_ptr(), m, width, Xt.data_ptr(), k,
            power, f64, plan['n_staged'], min(_CTAS[key], m), out.data_ptr(),
            stream)
    kl.check(rc, 'ell_matvec_k (staged)')
    return out


_CTAS = {}  # (library, device, k, f64, n_staged): CTAs a launch
