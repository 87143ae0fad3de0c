"""The hybrid backend's int4 tier: the port against the JAX package's.

With ``BB_HYBRID_INT4=1`` both packages store the small-integer columns
(integers in [-8, 7], 0/1 among them) as packed int4: the JAX package as
a packed-s4 array that XLA widens inside its dots (XLA:CPU executes S4,
so its int4 design is the reference here), the port as a uint8 block of
two nibbles a byte (``kernels.layout.pack_int4``) that the nibble modes'
plain versions unpack in row chunks. Inputs are made from a seed with
numpy and go through both packages.

Checked: ``pack_int4`` / ``unpack_int4`` round trips; the tier pick, the
column masks and ``backend='auto'``'s estimate (int4 for 0/1 and [-8, 7]
columns, int8 beyond, int8 under ``fused='1'``, int4 as the storage
rescue); the products within 2e-6 of max|ref| (float32 sums in another
order): dot, Tdot, quad_matvec_blockorder, presolve_reductions, the
Fisher diagonal with non-binary small integers and the full Fisher
information, toarray, the 1-d mesh's sharded products; the plain nibble
modes against the int8 plain modes, bit for bit; the CG draw with equal
``n_cg_iter`` (within 1e-4 of max|ref|, as tests/test_torch_composed_
hybrid.py); a short logit chain's posterior means within |z| < 4.5 of
the JAX int4 chain's; and the gating of tests/test_tier_gating.py:35-125
and tests/test_design_matrix.py:141-215 on the port's own seams
(``design.sparse._int4_supported`` and its cache).
"""

import gc
import types
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.design import sparse as jax_sparse
from bayesbridge_tpu.ops.cg import sample_gaussian_cg as jax_cg
from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel, convert,
)
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.design import sparse as sparse_mod
from bayesbridge_tpu_torch.kernels import layout
from bayesbridge_tpu_torch.kernels.ne_sweep import (
    colpass, colpass_k_plain, colpass_plain, ne_rows_k_plain, ne_rows_plain,
    ne_sweep,
)
from bayesbridge_tpu_torch.kernels.tdots_sweep import (
    tdots_sweep_k_plain, tdots_sweep_plain,
)
from bayesbridge_tpu_torch.ops.cg import sample_gaussian_cg
from bayesbridge_tpu_torch.parallel import make_mesh, place_model, \
    shard_design

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

RTOL = 2e-6
Z_MAX = 4.5


@pytest.fixture
def int4_on(monkeypatch):
    """The opt-in set, both packages' capability caches fresh."""
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    monkeypatch.setattr(jax_sparse, '_INT4_SUPPORTED', {})


def _data(kind, seed, n=90, p_exact=40, p_float=6):
    """A design whose exact columns are 0/1 ('binary'), integers in
    [-8, 7] ('small'), or counts up to 99 ('counts'), beside float
    columns, the columns shuffled."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, p_exact)) < .35
    if kind == 'binary':
        exact = mask.astype(np.float64)
    elif kind == 'small':
        exact = rng.integers(-8, 8, size=(n, p_exact)) * mask
    else:
        exact = rng.integers(0, 100, size=(n, p_exact)) * mask
    dense = np.hstack((exact, rng.standard_normal((n, p_float))
                       * (rng.random((n, p_float)) < .7)))
    return rng, sps.csr_matrix(dense[:, rng.permutation(dense.shape[1])]
                               .astype(np.float64))


def _pair(X, centered=False, intercept=True, fused='0'):
    kw = dict(center_predictor=centered, add_intercept=intercept,
              backend='hybrid', fused=fused)
    return (JaxDesign(X, dtype=np.float32, **kw),
            SparseDesignMatrix(X, device='cpu', **kw))


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


def _tier(design):
    """'int4' / 'int8' / 'bfloat16' of either package's exact block."""
    dt = design.X_exact.dtype
    if isinstance(dt, torch.dtype):
        return 'int4' if dt == torch.uint8 else str(dt).split('.')[-1]
    return str(dt)


# -- storage ------------------------------------------------------------ #

@pytest.mark.parametrize('p', [1, 31, 32, 33, 77])
def test_pack_unpack_round_trip(p):
    """Exact both ways, padding columns included: the first p columns of
    an int8 block pack into padded_width(p, int4=True) / 2 bytes a row,
    zero past p; a whole block with random padding comes back as it
    went in."""
    rng = np.random.default_rng(p)
    X8 = torch.from_numpy(rng.integers(-8, 8, size=(9, p + 3))
                          .astype(np.int8))
    X4 = layout.pack_int4(X8, p)
    assert X4.dtype == torch.uint8
    assert 2 * X4.shape[1] == layout.padded_width(p, int4=True)
    assert 2 * X4.shape[1] % 32 == 0
    back = layout.unpack_int4(X4)
    assert torch.equal(back[:, :p], X8[:, :p]) and not back[:, p:].any()
    assert torch.equal(layout.unpack_int4(X4, p), X8[:, :p])
    whole = torch.from_numpy(rng.integers(-8, 8, size=(9, 64))
                             .astype(np.int8))
    assert torch.equal(layout.unpack_int4(layout.pack_int4(whole)), whole)
    # Two's complement nibbles, the even column low.
    two = layout.pack_int4(torch.tensor([[-8, 7] + [0] * 30],
                                        dtype=torch.int8))
    assert two[0, 0].item() == 0x78
    with pytest.raises(ValueError, match=r'\[-8, 7\]'):
        layout.pack_int4(torch.full((2, 4), 8, dtype=torch.int8))


@pytest.mark.parametrize('p', [1, 31, 32, 33, 77])
def test_int4_is_binary(p):
    """layout.int4_is_binary reads the logical columns only: 0/1 values
    pass whatever the padding nibbles hold; any other value fails."""
    rng = np.random.default_rng(p)
    X8 = torch.from_numpy((rng.uniform(size=(9, p)) < .4).astype(np.int8))
    X4 = layout.pack_int4(X8)
    X4[:, -(-p // 2):] = 0xFF
    if p % 2:
        X4[:, p // 2] |= 0xF0
    assert layout.int4_is_binary(X4, p)
    for value in (-1, 2, 7, -8):
        Y = X8.clone()
        Y[4, p - 1] = value
        assert not layout.int4_is_binary(layout.pack_int4(Y), p)


def test_plain_nibble_modes_give_the_int8_bits():
    """The nibble modes' plain versions (and the chain-batched ones) on a
    packed block give the int8 plain modes' bits on the same values."""
    rng = np.random.default_rng(4)
    n, pe, pf = 300, 45, 11
    X8 = torch.from_numpy(rng.integers(-8, 8, size=(n, 64))
                          .astype(np.int8))
    X4 = layout.pack_int4(X8, pe)
    Xf = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    vs = [torch.from_numpy(rng.standard_normal(p).astype(np.float32))
          for p in (pe, pf)]
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    us = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          for _ in range(4)]
    for X in (X4, X8):
        layout.check_block(X, pe)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ne_rows_plain([(X4, vs[0]), (Xf, vs[1])], c),
                       ne_rows_plain([(X8, vs[0]), (Xf, vs[1])], c))
    assert same(colpass_plain([X4, Xf], [pe, pf], us[0]),
                colpass_plain([X8, Xf], [pe, pf], us[0]))
    for k in (3, 4):
        a = tdots_sweep_plain([X4, Xf], [pe, pf], *us[:k])
        b = tdots_sweep_plain([X8, Xf], [pe, pf], *us[:k])
        assert all(same(x, y) for x, y in zip(a, b))
    V = [torch.stack([v, 2 * v]) for v in vs]
    C = torch.stack([c, -c])
    assert torch.equal(ne_rows_k_plain([(X4, V[0]), (Xf, V[1])], C),
                       ne_rows_k_plain([(X8, V[0]), (Xf, V[1])], C))
    U = torch.stack(us[:2])
    assert same(colpass_k_plain([X4, Xf], [pe, pf], U),
                colpass_k_plain([X8, Xf], [pe, pf], U))
    a = tdots_sweep_k_plain([X4, Xf], [pe, pf], U, U, U, U)
    b = tdots_sweep_k_plain([X8, Xf], [pe, pf], U, U, U, U)
    assert all(same(x, y) for x, y in zip(a, b))


def test_fused_sweeps_refuse_an_int4_block():
    """As the JAX package's fused kernels (sparse.py:1052): the sweep and
    the one-read kernel take no packed block, and a packed block is only
    ever the first."""
    X4 = layout.pack_int4(torch.ones((8, 32), dtype=torch.int8))
    v, w = torch.ones(32), torch.ones(8)
    with pytest.raises(TypeError, match='int4'):
        ne_sweep([(X4, v)], torch.zeros(()), None, w, 'ne')
    with pytest.raises(TypeError, match='first'):
        colpass([torch.ones((8, 16)), X4], [16, 32], w)


# -- the tier pick -------------------------------------------------------- #

@pytest.mark.parametrize('case,want', [
    ('binary', 'int4'), ('small', 'int4'), ('counts', 'int8'),
    ('binary/fused', 'int8'), ('binary/rescue', 'int4')])
def test_tier_pick_matches_jax(int4_on, monkeypatch, case, want):
    """The same tier, column split and masks as the JAX package's:
    int4 for 0/1 and [-8, 7] columns, int8 beyond, int8 where the policy
    fuses the CG operator, int4 there as the storage rescue (int8 would
    not fit the budget)."""
    kind, _, mode = case.partition('/')
    _, X = _data(kind, 5)
    fused = '1' if mode else '0'
    if mode == 'rescue':  # int4 fits, int8 does not
        n, p = X.shape
        budget = 0.75 * n * p
        monkeypatch.setattr(sparse_mod, '_HYBRID_MAX_BYTES', budget)
        monkeypatch.setattr(jax_sparse, '_HYBRID_MAX_BYTES', budget)
    jd, td = _pair(X, fused=fused)
    assert _tier(jd) == _tier(td) == want
    np.testing.assert_array_equal(td.exact_cols.numpy(),
                                  np.asarray(jd.exact_cols))
    np.testing.assert_array_equal(td.float_cols.numpy(),
                                  np.asarray(jd.float_cols))
    data = X.tocsr().data
    np.testing.assert_array_equal(
        sparse_mod._exact_column_mask(X.tocsr(),
                                      ~sparse_mod._int4_exact(data)),
        jax_sparse._int4_exact_columns(X.tocsc()))
    assert (td.fused_ne_mode('quad') is None) == (fused == '0'
                                                  or want == 'int4')


@pytest.mark.parametrize('opt_in', [False, True])
def test_auto_backend_estimate_matches_jax(monkeypatch, opt_in):
    """``backend='auto'``: with a hybrid budget between the int4 and the
    int8 estimate, the opt-in keeps the design on the hybrid backend
    (0.5 bytes an int4 element), in both packages alike."""
    if opt_in:
        monkeypatch.setenv('BB_HYBRID_INT4', '1')
    else:
        monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    monkeypatch.setattr(jax_sparse, '_INT4_SUPPORTED', {})
    _, X = _data('binary', 6, n=120, p_exact=60, p_float=4)
    n, p = X.shape
    budget = n * p * (0.5 * 60 + 4 * 4) / p * 1.05
    for mod in (sparse_mod, jax_sparse):
        monkeypatch.setattr(mod, '_HYBRID_MAX_BYTES', budget)
    jd = JaxDesign(X, dtype=np.float32, backend='auto', fused='0')
    td = SparseDesignMatrix(X, backend='auto', fused='0', device='cpu')
    assert td.backend == jd.backend == ('hybrid' if opt_in else 'bitpack')
    if opt_in:
        assert _tier(td) == _tier(jd) == 'int4'


# -- products ------------------------------------------------------------- #

@pytest.mark.parametrize('intercept', [False, True])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('kind', ['binary', 'small'])
def test_products_match_jax(int4_on, kind, centered, intercept):
    rng, X = _data(kind, 11 + 2 * centered + intercept)
    jd, td = _pair(X, centered, intercept)
    assert _tier(jd) == _tier(td) == 'int4'
    assert td.storage_bytes() == td.X_exact.numel() \
        + 4 * td.X_float.numel()
    assert td.nnz == X.nnz
    n, p = td.shape
    f32 = np.float32
    v = rng.standard_normal(p).astype(f32)
    w = rng.exponential(size=n).astype(f32)
    us = [rng.standard_normal(n).astype(f32) for _ in range(4)]
    np.testing.assert_array_equal(td.toarray().astype(np.float32),
                                  np.asarray(jd.toarray(), np.float32))
    _close(td.dot(v).numpy(), jd.dot(jnp.asarray(v)))
    _close(td.Tdot(us[0]).numpy(), jd.Tdot(jnp.asarray(us[0])))
    perm, unperm, off_bo = td.cg_blockorder_ctx()
    _, _, off_j = jd.cg_blockorder_ctx()
    v_bo = v[perm.numpy()]
    got = td.quad_matvec_blockorder(v_bo, w, off_bo, return_t=True)
    ref = jd.quad_matvec_blockorder(jnp.asarray(v_bo), jnp.asarray(w),
                                    off_j, return_t=True)
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    got = td.presolve_reductions(*us[:2], w, us[3])
    ref = jd.presolve_reductions(*(jnp.asarray(u) for u in us[:2]),
                                 jnp.asarray(w), jnp.asarray(us[3]))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    _close(td.compute_fisher_diag(w).numpy(),
           jd.compute_fisher_info(jnp.asarray(w), diag_only=True))
    _close(td.compute_fisher_info(w).numpy(),
           jd.compute_fisher_info(jnp.asarray(w)))


@pytest.mark.parametrize('kind,int4,p_float,want', [
    ('binary', True, 6, True), ('binary', True, 0, True),
    ('small', True, 6, False), ('binary', False, 6, False)])
def test_presolve_passes_binary_for_int4(monkeypatch, kind, int4, p_float,
                                         want):
    """presolve_reductions and the Fisher diagonal ask the pre-solve for
    its binary mode over a packed int4 block of 0/1 values only (beside
    float columns too, where the design's `exact_is_binary` is False):
    not over values in [-8, 7], not over an int8 block of 0/1 values."""
    if int4:
        monkeypatch.setenv('BB_HYBRID_INT4', '1')
    else:
        monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    rng, X = _data(kind, 5, p_float=p_float)
    td = SparseDesignMatrix(X, device='cpu', backend='hybrid', fused='0')
    assert _tier(td) == ('int4' if int4 else 'int8')
    assert td.exact_is_binary == (kind == 'binary' and p_float == 0)
    seen = []
    real = sparse_mod.tdots_sweep_k

    def recording(*args, binary=False, **kw):
        seen.append(binary)
        return real(*args, binary=binary, **kw)
    monkeypatch.setattr(sparse_mod, 'tdots_sweep_k', recording)
    n = td.shape[0]
    us = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    td.presolve_reductions(*us)
    td.compute_fisher_diag(np.abs(us[0]))
    assert seen == [want, want]


def test_int8_tier_holds_no_packed_block(int4_on):
    """with_exact_tier('int8') of a packed 0/1 design whose pre-solve has
    run keeps no reference to the packed block (its binary flag is a
    plain bool, set with the block): the block goes with the design that
    held it. Packing again finds the binary mode again."""
    rng, X = _data('binary', 29)
    d4 = SparseDesignMatrix(X, device='cpu', backend='hybrid', fused='0')
    assert _tier(d4) == 'int4' and d4.int4_binary
    us = [rng.standard_normal(d4.shape[0]).astype(np.float32)
          for _ in range(4)]
    want = d4.presolve_reductions(*us)
    packed = weakref.ref(d4.X_exact)
    d8 = d4.with_exact_tier('int8')
    assert _tier(d8) == 'int8' and d8.int4_binary is False
    del d4
    gc.collect()
    assert packed() is None
    for g, w in zip(d8.presolve_reductions(*us), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    again = d8.with_exact_tier('int4')
    assert again.int4_binary and again.row_block(0, 10).int4_binary


@pytest.mark.parametrize('p_float', [0, 6])
def test_plain_presolve_matches_jax_multirhs(int4_on, p_float):
    """The plain pre-solve over the packed 0/1 block (binary, as the
    design asks for it) against the JAX package's _presolve_multirhs over
    its packed-s4 block, block by block within 2e-6 of max|ref|. On a
    binary design (no float columns) the JAX square row is its X'u3 (the
    binary reuse); the port's square row is within the same tolerance of
    X'u3 either way."""
    rng, X = _data('binary', 17, p_float=p_float)
    jd, td = _pair(X)
    assert _tier(jd) == _tier(td) == 'int4'
    assert td.int4_binary
    assert jd.exact_is_binary == td.exact_is_binary == (p_float == 0)
    np.testing.assert_array_equal(np.asarray(jd.exact_cols),
                                  td.exact_cols.numpy())
    n = td.shape[0]
    us = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    ref, _ = jd._presolve_multirhs(*(jnp.asarray(u) for u in us))
    got = tdots_sweep_plain(*td._hybrid_Xs(),
                            *(torch.from_numpy(u) for u in us), binary=True)
    assert len(got) == len(ref) == (2 if p_float else 1)
    for g_blk, r_blk in zip(got, ref):
        for g, r in zip(g_blk, r_blk):
            _close(g.numpy(), r)
    if not p_float:
        np.testing.assert_array_equal(np.asarray(ref[0][3]),
                                      np.asarray(ref[0][2]))
    _close(got[0][3].numpy(), ref[0][2])


def test_int4_nonbinary_fisher_exact(int4_on):
    """tests/test_design_matrix.py:190-209: non-binary int4 columns
    square exactly in the Fisher second moment (the nibble modes square
    the loaded value in float32; at most 64)."""
    rng = np.random.default_rng(23)
    small = rng.integers(-8, 8, size=(30, 5)).astype(np.float64) \
        * (rng.uniform(size=(30, 5)) < .6)
    X = sps.csr_matrix(small)
    td = SparseDesignMatrix(X, add_intercept=False, backend='hybrid',
                            device='cpu')
    jd = JaxDesign(X, add_intercept=False, backend='hybrid',
                   dtype=np.float32)
    assert _tier(td) == _tier(jd) == 'int4'
    w = rng.uniform(.5, 2., size=30).astype(np.float32)
    expect = np.einsum('i,ij->j', w, small ** 2)
    got = td.compute_fisher_diag(w).numpy().astype(np.float64)
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    _close(got, jd.compute_fisher_diag(jnp.asarray(w)))


def test_sharded_products_match_jax(int4_on):
    """A 1-d mesh of 4: each shard a row view of the packed block, the
    sharded products against the JAX int4 design's."""
    rng, X = _data('small', 17, n=101)
    jd, td = _pair(X, centered=True)
    sd = shard_design(td, make_mesh(devices=[torch.device('cpu')] * 4))
    for _, s in sd.local_shards():
        assert layout.is_int4(s.X_exact)
        assert s.X_exact.untyped_storage().data_ptr() \
            == td.X_exact.untyped_storage().data_ptr()
    n, p = td.shape
    v = rng.standard_normal(p).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    _close(sd.dot(v).numpy(), jd.dot(jnp.asarray(v)))
    _close(sd.Tdot(u).numpy(), jd.Tdot(jnp.asarray(u)))
    _close(sd.quad_matvec(v, w).numpy(),
           jd.quad_matvec(jnp.asarray(v), jnp.asarray(w)))
    _close(sd.compute_fisher_diag(w).numpy(),
           jd.compute_fisher_info(jnp.asarray(w), diag_only=True))


def test_converter_packs_the_jax_int4_block(int4_on):
    """design_from_numpy on the JAX int4 design's arrays (its packed-s4
    block widened to numpy int8) gives the port's own packed block."""
    _, X = _data('small', 21)
    jd, td = _pair(X, centered=True)
    cd = convert.design_from_numpy(
        np.asarray(jd.X_exact).astype(np.int8), np.asarray(jd.X_float),
        np.asarray(jd.exact_cols), np.asarray(jd.float_cols),
        np.asarray(jd.column_offset), jd._shape_main, center_predictor=True,
        device='cpu', exact_tier='int4')
    assert torch.equal(cd.X_exact, td.X_exact)
    np.testing.assert_array_equal(cd.toarray(), td.toarray())


# -- the draw and the chain ----------------------------------------------- #

@pytest.mark.parametrize('warm', [False, True])
def test_cg_matches_jax(int4_on, warm):
    rng, X = _data('small', 40 + warm, n=150, p_exact=30, p_float=7)
    jd, td = _pair(X, centered=True)
    assert _tier(td) == 'int4'
    n, p = td.shape
    f32 = np.float32
    dense = td.toarray().astype(np.float64)
    obs_prec = (rng.exponential(size=n) * .25 + .05).astype(f32)
    prior = np.concatenate(([1e-3], 1.0 / rng.uniform(.05, 3.0,
                                                      size=p - 1)))
    fisher = (dense * dense).T @ obs_prec
    coef_init = (rng.standard_normal(p) * .1).astype(f32)
    lin0 = dense @ coef_init
    a = dict(obs_prec=obs_prec, prior_prec_sqrt=prior.astype(f32),
             z=(dense.T @ (rng.standard_normal(n) * obs_prec)).astype(f32),
             coef_cg_init=coef_init,
             precond_scale=(1 / np.sqrt(prior ** 2 + fisher)).astype(f32),
             perturbation=(rng.standard_normal(p) * 2.0).astype(f32))
    if warm:
        a.update(warm_tdot=(dense.T @ (obs_prec * lin0)).astype(f32),
                 lin_pred0=lin0.astype(f32))
    atol = 1e-4 * np.sqrt(p)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    coef_j, lin_j, info_j = jax_cg(
        jax.random.key(0), jd, j.pop('obs_prec'), j.pop('prior_prec_sqrt'),
        j.pop('z'), maxiter=500, atol=atol, return_lin_pred=True, **j)
    coef_t, lin_t, info_t = sample_gaussian_cg(
        None, td, t.pop('obs_prec'), t.pop('prior_prec_sqrt'), t.pop('z'),
        maxiter=500, atol=atol, return_lin_pred=True, **t)
    assert info_t['n_cg_iter'] == int(info_j['n_cg_iter']) > 2
    _close(coef_t.numpy(), coef_j, rtol=1e-4)
    _close(lin_t.numpy(), lin_j, rtol=1e-4)


N_ITER, N_BURNIN = 300, 100
PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


def _chain_problem():
    rng, X = _data('small', 12, n=400, p_exact=16, p_float=4)
    beta = np.zeros(X.shape[1])
    beta[:3] = .4
    lin = X @ beta - .5
    y = (rng.random(X.shape[0]) < 1 / (1 + np.exp(-lin))).astype(np.float64)
    return X, y


def _moments(draws):
    from bayesbridge_tpu.utils.mcmc_summarizer import (
        compute_effective_sample_size,
    )
    ess = np.maximum(np.asarray(compute_effective_sample_size(draws)), 8.0)
    return draws.mean(axis=-1), draws.std(axis=-1) / np.sqrt(ess)


def test_chain_matches_jax_posterior(int4_on):
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionCoefPrior as JaxPrior,
        RegressionModel as JaxModel,
    )
    X, y = _chain_problem()
    jmodel = JaxModel(y, X, family='logit', dtype=np.float32)
    assert _tier(jmodel.design) == 'int4'
    theirs, _ = JaxBridge(jmodel, JaxPrior(**PRIOR_KW),
                          dtype=np.float32).gibbs(
        N_ITER, N_BURNIN, seed=1, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    model = RegressionModel(y, X, family='logit', device='cpu')
    assert _tier(model.design) == 'int4'
    assert model.design.fused_ne_mode('link') is None
    ours, _ = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW)).gibbs(
        N_ITER, N_BURNIN, seed=0, coef_sampler_type='cg',
        init={'global_scale': .1}, params_to_save=('coef',))
    m1, se1 = _moments(np.asarray(ours['coef'], np.float64))
    m2, se2 = _moments(np.asarray(theirs['coef'], np.float64))
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))


def test_int4_auto_chain_equals_int8_composed(int4_on):
    """The nibble modes give the int8 modes' bits, and an int4 design
    composes every call site: its chain under 'auto' equals the int8
    design's under '0' draw for draw, and resumes exactly."""
    X, y = _chain_problem()
    m4 = RegressionModel(y, X, family='logit', fused='auto', device='cpu')
    d8 = m4.design.with_exact_tier('int8').with_policy('0')
    assert _tier(m4.design) == 'int4' and _tier(d8) == 'int8'
    m8 = RegressionModel(y, X, family='logit', fused='0', device='cpu')
    m8.design = d8
    kw = dict(seed=3, coef_sampler_type='cg', params_to_save='all')
    b4 = BayesBridge(m4, RegressionCoefPrior(**PRIOR_KW))
    s4, i4 = b4.gibbs(8, **kw)
    s8, _ = BayesBridge(m8, RegressionCoefPrior(**PRIOR_KW)).gibbs(8, **kw)
    for key in s4:
        np.testing.assert_array_equal(s4[key], s8[key])
    part, info = b4.gibbs(5, **kw)
    merged, _ = b4.gibbs_resume(info, 3, merge=True, prev_samples=part)
    for key in s4:
        np.testing.assert_array_equal(merged[key], s4[key])


# -- gating (tests/test_tier_gating.py:35-125, test_design_matrix.py
#    :141-215, on the port's seams) ----------------------------------------- #

def _int4_eligible_csr(n=40, p=30, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(1, 8, size=(n, p)) * (rng.uniform(size=(n, p)) < 0.4)
    return sps.csr_matrix(X.astype(np.float64))


def test_int4_tier_is_opt_in(monkeypatch):
    """Without BB_HYBRID_INT4=1 the probe says False without touching a
    device (no cache entry, no kernel library), and no design stores a
    packed block."""
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    assert sparse_mod._int4_supported('cpu') is False
    assert sparse_mod._int4_supported('cuda') is False
    design = SparseDesignMatrix(_int4_eligible_csr(), backend='hybrid',
                                device='cpu')
    assert _tier(design) == 'int8'
    assert sparse_mod._INT4_SUPPORTED == {}


def test_probe_binds_to_execution_device(monkeypatch):
    """The tier pick asks the probe for the device the design executes
    on (its `device`), never for where the host blocks are built: a
    'cpu' cache entry of False keeps a CPU design off int4, whatever the
    CUDA entry says; the probe sees exactly that device."""
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED',
                        {'cpu': False, 'cuda': True})
    asked = []
    probe = sparse_mod._int4_supported

    def spy(device):
        asked.append(torch.device(device))
        return probe(device)
    monkeypatch.setattr(sparse_mod, '_int4_supported', spy)
    design = SparseDesignMatrix(_int4_eligible_csr(), backend='hybrid',
                                device='cpu')
    assert _tier(design) == 'int8'
    assert asked and set(asked) == {torch.device('cpu')}
    v = np.random.default_rng(1).standard_normal(design.shape[1])
    assert np.all(np.isfinite(design.dot(v).numpy()))


def test_probe_cache_is_keyed_by_device_type(monkeypatch):
    """One process serves designs for device types with different int4
    support: the cache is per type, and a cached answer is read without
    building or touching anything."""
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED',
                        {'cpu': True, 'cuda': False})
    assert sparse_mod._int4_supported(torch.device('cpu')) is True
    assert sparse_mod._int4_supported(torch.device('cuda', 1)) is False
    assert sparse_mod._int4_supported('meta') is False
    assert sparse_mod._INT4_SUPPORTED['meta'] is False
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    assert sparse_mod._int4_supported('cpu') is True  # the plain versions


def test_place_model_demotes_unsupported_int4(monkeypatch):
    """place_model re-validates a packed block against the device it
    moves to and widens it to int8 (the same values) with the JAX
    package's warning, where that device cannot run the int4 tier."""
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {'cpu': True})
    design = SparseDesignMatrix(_int4_eligible_csr(), backend='hybrid',
                                device='cpu')
    assert _tier(design) == 'int4'
    v = np.random.default_rng(2).standard_normal(design.shape[1])
    before = design.dot(v).numpy()
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {'cpu': False})
    with pytest.warns(UserWarning, match='widening a packed-s4'):
        placed = place_model(types.SimpleNamespace(design=design), 'cpu')
    assert _tier(placed.design) == 'int8' and _tier(design) == 'int4'
    np.testing.assert_allclose(placed.design.dot(v).numpy(), before,
                               rtol=1e-5, atol=1e-5)
    with pytest.warns(UserWarning, match='widening a packed-s4'):
        sd = shard_design(design, make_mesh(devices=['cpu'] * 2))
    assert all(_tier(s) == 'int8' for _, s in sd.local_shards())
    np.testing.assert_allclose(sd.dot(v).numpy(), before, rtol=1e-5,
                               atol=1e-5)


def test_place_model_keeps_supported_int4(monkeypatch):
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {'cpu': True})
    design = SparseDesignMatrix(_int4_eligible_csr(), backend='hybrid',
                                device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        placed = place_model(types.SimpleNamespace(design=design), 'cpu')
    assert _tier(placed.design) == 'int4'
    assert placed.design.X_exact.data_ptr() == design.X_exact.data_ptr()


def test_fused_policy_is_per_design_with_int4(monkeypatch):
    """Under the opt-in the construction-time policy decides the tier:
    '1' fuses the CG operator and so stores int8 (and fuses), '0' stores
    int4 and composes; a design that stores int4 composes whatever the
    env later says. Both give the same operator."""
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    monkeypatch.setenv('BB_FUSED_NE', '0')
    X = _int4_eligible_csr(50, 40, seed=3)
    d_on = SparseDesignMatrix(X, backend='hybrid', fused='1', device='cpu')
    d_off = SparseDesignMatrix(X, backend='hybrid', fused='0', device='cpu')
    d_env = SparseDesignMatrix(X, backend='hybrid', device='cpu')
    assert (_tier(d_on), _tier(d_off), _tier(d_env)) == ('int8', 'int4',
                                                         'int4')
    assert d_on.fused_ne_mode() is not None
    assert d_off.fused_ne_mode() is None and d_env.fused_ne_mode() is None
    monkeypatch.setenv('BB_FUSED_NE', '1')
    assert d_env.fused_ne_mode() is None  # int4 composes
    rng = np.random.default_rng(3)
    v = rng.standard_normal(d_on.shape[1]).astype(np.float32)
    w = rng.exponential(size=50).astype(np.float32)
    _close(d_on.quad_matvec(v, w).numpy(), d_off.quad_matvec(v, w).numpy(),
           rtol=1e-5)


@pytest.mark.parametrize('opt_in', [False, True])
def test_hybrid_splits_int4_exact_columns(monkeypatch, opt_in):
    """tests/test_design_matrix.py:141-162 and :212-215: binary columns
    land in the packed int4 block where the probe says so (else int8),
    continuous columns stay float32, and dot is exact."""
    if opt_in:
        monkeypatch.setenv('BB_HYBRID_INT4', '1')
    else:
        monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    rng = np.random.default_rng(15)
    binary = (rng.uniform(size=(40, 6)) < .3).astype(np.float64)
    dense = rng.standard_normal((40, 2)) * 1.7
    X = sps.csr_matrix(np.hstack([binary, dense]))
    design = SparseDesignMatrix(X, add_intercept=False, backend='hybrid',
                                device='cpu')
    want = 'int4' if sparse_mod._int4_supported('cpu') else 'int8'
    assert _tier(design) == want == ('int4' if opt_in else 'int8')
    assert design.n_exact == 6 and design.n_float == 2
    assert layout.stored_columns(design.X_exact) % 32 == 0 or not opt_in
    v = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(design.dot(v).numpy(),
                               X.toarray().astype(np.float32) @ v,
                               rtol=2e-6, atol=2e-6)


def test_hybrid_splits_int8_exact_columns(int4_on):
    """tests/test_design_matrix.py:165-182: integers beyond [-8, 7] take
    the int8 tier, still exact, under the opt-in too."""
    rng = np.random.default_rng(15)
    counts = rng.integers(0, 100, size=(40, 6)).astype(np.float64) \
        * (rng.uniform(size=(40, 6)) < .5)
    dense = rng.standard_normal((40, 2)) * 1.7
    X = sps.csr_matrix(np.hstack([counts, dense]))
    design = SparseDesignMatrix(X, add_intercept=False, backend='hybrid',
                                device='cpu')
    assert _tier(design) == 'int8'
    assert design.n_exact == 6 and design.n_float == 2
    v = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(design.dot(v).numpy(),
                               X.toarray().astype(np.float32) @ v,
                               rtol=2e-6, atol=2e-6)


def test_with_exact_tier_round_trip(int4_on):
    """Packing an int8 design's block on its device and widening it back
    give the same design: the same products, the float block shared."""
    _, X = _data('binary', 8)
    d8 = SparseDesignMatrix(X, backend='hybrid', fused='0', device='cpu') \
        .with_exact_tier('int8')
    d4 = d8.with_exact_tier('int4')
    assert _tier(d8) == 'int8' and _tier(d4) == 'int4'
    assert d4.X_float is d8.X_float
    assert torch.equal(d4.with_exact_tier('int8').X_exact[:, :d8.n_exact],
                       d8.X_exact[:, :d8.n_exact])
    np.testing.assert_array_equal(d4.toarray(), d8.toarray())
    with pytest.raises(ValueError, match=r'\[-8, 7\]'):
        _, Xc = _data('counts', 8)
        SparseDesignMatrix(Xc, backend='hybrid', device='cpu') \
            .with_exact_tier('int4')
