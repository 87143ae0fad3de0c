"""The port's bitpack backend against the JAX package's.

Both packages build a bitpack design from the same scipy CSR matrix
(n=300, p=70 at 12% density, so neither the byte-groups nor the outputs
fill their blocks); the JAX byte-LUT kernel runs in interpret mode, the
port's ``bitlut`` as its plain version on the CPU. Checked:

* the host layout is identical: ``plan_blocks``, ``pack_bits``,
  ``pad_packed`` and the design's two bitmaps, column sets and float
  block, byte for byte;
* the plain ``bitlut`` (the kernel's order: two nibble tables per
  byte-group, a byte's entry lo + hi) equals ``bitpacked_matvec`` on the
  same packed arrays, both orientations of the design's bitmaps and raw
  ragged bitmaps: rtol 1e-5 (float32 sums in another order);
* the nibble tables give the byte-table kernel's tables exactly on
  small-integer inputs (every partial sum exact);
* dot, Tdot, ``quad_matvec(return_t=True)`` and the Fisher diagonal
  match the JAX design, with centering and intercept on and off, for a
  fresh build and for the JAX arrays carried over by
  ``convert.packed_design_from_numpy``: rtol 2e-5, atol 2e-5 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.design import bitlut as jax_bitlut
from bayesbridge_tpu_torch import convert
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.design import bitlut as port_bitlut
from bayesbridge_tpu_torch.design.sparse import PACKED_ARRAYS
from bayesbridge_tpu_torch.kernels import launch_counts
from bayesbridge_tpu_torch.kernels.bitlut import (
    bitlut, bitlut_plain, byte_lut_plain, lut_plain, nibble_plain,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _design_data(seed=0, n=300, p=70, binary_only=False):
    rng = np.random.default_rng(seed)
    X = (rng.random((n, p)) < 0.12).astype(np.float64)
    if not binary_only:  # every 9th column general-valued
        cols = np.arange(0, p, 9)
        X[:, cols] *= rng.standard_normal((n, len(cols)))
    return sps.csr_matrix(X)


def _pair(X, centered=False, intercept=True):
    jd = JaxDesign(X, center_predictor=centered, add_intercept=intercept,
                   backend='bitpack', dtype=np.float32)
    td = SparseDesignMatrix(X, center_predictor=centered,
                            add_intercept=intercept, backend='bitpack',
                            device='cpu')
    return jd, td


def _converted(jd, centered, intercept):
    return convert.packed_design_from_numpy(
        'bitpack', {k: np.asarray(getattr(jd, k))
                    for k in PACKED_ARRAYS['bitpack']},
        jd._bitpack_meta, np.asarray(jd.column_offset), jd._shape_main,
        add_intercept=intercept, center_predictor=centered, device='cpu')


def _close(got, ref, rtol=2e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize('n_in,n_out', [(1, 1), (7, 129), (70, 300),
                                        (255, 8191), (300, 70),
                                        (50_000, 100_000)])
def test_plan_blocks_identical(n_in, n_out):
    assert port_bitlut.plan_blocks(n_in, n_out) \
        == jax_bitlut.plan_blocks(n_in, n_out)


def test_pack_bits_and_pad_identical():
    rng = np.random.default_rng(2)
    dense = (rng.random((37, 29)) < .3).astype(np.uint8)
    for axis in (0, 1):
        got = port_bitlut.pack_bits(dense, axis)
        np.testing.assert_array_equal(got, jax_bitlut.pack_bits(dense, axis))
        np.testing.assert_array_equal(
            port_bitlut.pad_packed(got, 40, 128),
            jax_bitlut.pad_packed(got, 40, 128))


@pytest.mark.parametrize('binary_only', [True, False])
def test_design_bitmaps_identical(binary_only):
    """The vectorized packer gives the JAX package's per-row/per-column
    loops' bytes, and the same column split and float block."""
    X = _design_data(seed=1, binary_only=binary_only)
    jd, td = _pair(X)
    for name in ('bits_col', 'bits_row', 'bin_cols', 'float_cols'):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    np.testing.assert_array_equal(
        td.X_float.numpy(), np.asarray(jd.X_float)[:, :td.n_float])
    assert td._bitpack_meta == tuple(jd._bitpack_meta[:7])
    assert td.bits_col.shape[0] % 8 == 0 and td.bits_col.shape[1] % 128 == 0
    np.testing.assert_array_equal(td.toarray(), jd.toarray())
    # The dense form is the CSR's: the bitmaps hold exactly its 0/1 part.
    np.testing.assert_allclose(td.toarray()[:, 1:], X.toarray(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('orient', ['dot', 'tdot'])
def test_plain_bitlut_matches_jax_kernel(orient):
    X = _design_data(seed=3)
    jd, td = _pair(X)
    p_bin, gcol_pad, n_pad, k_dot, grow_pad, pbin_pad, k_tdot, _ = \
        jd._bitpack_meta
    if orient == 'dot':
        bits, n_out, k, g_pad = jd.bits_col, X.shape[0], k_dot, gcol_pad
        n_in = p_bin
    else:
        bits, n_out, k, g_pad = jd.bits_row, p_bin, k_tdot, grow_pad
        n_in = X.shape[0]
    rng = np.random.default_rng(4)
    v = np.zeros(8 * g_pad, np.float32)
    v[:n_in] = rng.standard_normal(n_in)
    ref = jax_bitlut.bitpacked_matvec(bits, jnp.asarray(v), n_out, k,
                                      interpret=True)
    before = launch_counts()
    got = bitlut(torch.from_numpy(np.asarray(bits).copy()),
                 torch.from_numpy(v), n_out, orient)
    assert launch_counts() == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float64),
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(
        got.numpy(), bitlut_plain(torch.from_numpy(np.asarray(bits).copy()),
                                  torch.from_numpy(v), n_out).numpy())


@pytest.mark.parametrize('n_in,n_out', [(1, 1), (37, 300), (300, 1000),
                                        (2000, 130)])
def test_plain_bitlut_matches_jax_kernel_ragged(n_in, n_out):
    """Raw bitmaps whose byte-groups and outputs fill no block: random
    bytes over the live groups and outputs, zeros in the padding."""
    g_pad, m_pad, n_chunk = jax_bitlut.plan_blocks(n_in, n_out)
    rng = np.random.default_rng(n_in + n_out)
    bits = np.zeros((g_pad, m_pad), np.uint8)
    g_live = -(-n_in // 8)
    bits[:g_live, :n_out] = rng.integers(0, 256, size=(g_live, n_out))
    v = np.zeros(8 * g_pad, np.float32)
    v[:n_in] = rng.standard_normal(n_in)
    ref = np.asarray(jax_bitlut.bitpacked_matvec(
        jnp.asarray(bits), jnp.asarray(v), n_out, n_chunk, interpret=True),
        np.float64)
    got = bitlut(torch.from_numpy(bits), torch.from_numpy(v), n_out)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * max(np.abs(ref).max(), 1.0))


def test_nibble_tables_are_the_byte_tables():
    """On small integers every partial sum is exact, so a byte's entry
    lo[B & 15] + hi[B >> 4] equals the byte-table kernel's 8-bit entry;
    the nibble tables hold the sums of their half's set bits."""
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.integers(-9, 10, size=8 * 13).astype(
        np.float32))
    assert torch.equal(lut_plain(v), byte_lut_plain(v))
    nib = nibble_plain(v).numpy()
    vg = v.numpy().reshape(13, 2, 4)
    for i in range(16):
        bitset = [(i >> b) & 1 for b in range(4)]
        np.testing.assert_array_equal(nib[:, i], vg[:, 0] @ bitset)
        np.testing.assert_array_equal(nib[:, 16 + i], vg[:, 1] @ bitset)
    # Random floats: the two orders agree to rounding.
    v = torch.from_numpy(rng.standard_normal(8 * 13).astype(np.float32))
    np.testing.assert_allclose(lut_plain(v).numpy(),
                               byte_lut_plain(v).numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('source', ['build', 'convert'])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('intercept', [False, True])
def test_products_match_jax(source, centered, intercept):
    X = _design_data(seed=5 + 2 * centered + intercept)
    jd, td = _pair(X, centered, intercept)
    if source == 'convert':
        td = _converted(jd, centered, intercept)
    assert td.backend == 'bitpack' and td.fused_ne_mode() is None
    assert not td.has_presolve_reductions()
    n, p = td.shape
    assert (n, p) == jd.shape
    rng = np.random.default_rng(11)
    v = rng.standard_normal(p).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)

    _close(td.dot(v).numpy(), jd.dot(v))
    _close(td.Tdot(u).numpy(), jd.Tdot(u))
    out, t = td.quad_matvec(v, w, return_t=True)
    out_j, t_j = jd.quad_matvec(v, w, return_t=True)
    _close(out.numpy(), out_j)
    _close(t.numpy(), t_j)
    _close(td.compute_fisher_info(w, diag_only=True).numpy(),
           jd.compute_fisher_info(w, diag_only=True))
    assert td.fused_link_grad(v, w, w, 'logit') is None
