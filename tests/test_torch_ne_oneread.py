"""The one-read CG operator (``kernels/ne_oneread.py``) against the JAX
package.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds
it against its plain version there). Here:

* the wrapper's host-side plan (column units per CTA of a cluster of 8,
  consumer threads, staged panels) for the flagship's and ragged block
  pairs: it fits the 227 KB of shared memory a block may use, has room
  for at least three staged panels, and its CTAs cover every live
  column unit of each block exactly once;
* the operator's plain version (``ne_sweep_plain``, which the wrapper
  runs on CPU tensors) against the JAX ``fused_ne_matvec2`` /
  ``fused_ne_matvec`` in interpret mode, for every block pair the
  hybrid design builds: int8 or bf16 exact block beside f32, either
  alone, and an f32 block alone;
* the link modes on the one-read route (``ne_oneread_link`` and
  ``ne_sweep(..., 'logit' | 'linear', route='oneread')``, plain on the
  CPU) against the JAX ``fused_link_matvec`` in interpret mode, on one
  and two blocks, with and without the log-likelihood;
* the design's fused ``quad_matvec`` against the JAX design's, on int8,
  bf16-exact and no-exact-column designs.

Tolerances as in tests/test_torch_kernels.py: u and logp rtol 2e-5 /
atol 2e-4, the column reductions rtol 2e-4 / atol 2e-4 * max|out| (sums
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.design import fusedne
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.kernels import layout
from bayesbridge_tpu_torch.kernels import ne_oneread as oneread
from bayesbridge_tpu_torch.kernels.ne_sweep import ne_sweep

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

U_TOL = dict(rtol=2e-5, atol=2e-4)
ITEMSIZE = {'int8': 1, 'bf16': 2, 'f32': 4}


def _close_reduction(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=2e-4,
                               atol=2e-4 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize('widths,kinds', [
    ((45_000, 5_000), ('int8', 'f32')),   # the flagship
    ((22_000, 5_000), ('bf16', 'f32')),
    ((4097, 513), ('int8', 'f32')),       # the smoke's ragged shape
    ((4097, 513), ('bf16', 'f32')),
    ((4097,), ('int8',)),
    ((5000,), ('f32',)),
    ((1,), ('int8',)),
    ((70, 9), ('f32', 'f32')),
])
def test_plan_fits_and_covers_each_unit_once(widths, kinds):
    p = oneread.plan(widths, [ITEMSIZE[k] for k in kinds])
    assert p is not None
    assert p.smem <= oneread.SMEM_CAP
    assert oneread.MIN_STAGES <= p.stages <= oneread.MAX_STAGES
    assert p.smem == oneread.FIXED_SMEM + p.stages * oneread.ROWS * (
        p.ue + p.uf) * oneread.UNIT_BYTES
    assert p.n_cons % 32 == 0 and p.n_cons <= oneread.MAX_CONSUMERS
    assert -(-p.ue // 32) * 32 + p.uf <= p.n_cons
    for b, (width, kind) in enumerate(zip(widths, kinds)):
        units = -(-width // (16 // ITEMSIZE[kind]))
        assert p.units[b] == units
        owned = np.zeros(units, dtype=int)
        for rank in range(oneread.CLUSTER):
            lo, hi = p.slices(rank)[b]
            owned[lo:hi] += 1
        assert (owned == 1).all()


def test_flagship_plan():
    """Clusters of 8: 352 int8 + 157 f32 units per CTA, 7 staged
    panels."""
    p = oneread.plan((45_000, 5_000), (1, 4))
    assert (oneread.CLUSTER, p.units, p.ue, p.uf, p.n_cons, p.stages) == \
        (8, (2813, 1250), 352, 157, 512, 7)


@pytest.mark.parametrize('widths,kinds', [
    ((200_000,), ('int8',)),
    # A bf16 exact block at the flagship's width: 704 units per CTA.
    ((45_000, 5_000), ('bf16', 'f32')),
    # 124 f32 columns past the flagship: 161 units per CTA pad to 192
    # consumer threads, 544 in all.
    ((45_000, 5_124), ('int8', 'f32')),
])
def test_too_wide_has_no_plan_and_routes_two_pass(widths, kinds):
    assert oneread.plan(widths, [ITEMSIZE[k] for k in kinds]) is None
    dtypes = {'int8': torch.int8, 'bf16': torch.bfloat16,
              'f32': torch.float32}
    blocks = [(torch.zeros((2, p), dtype=dtypes[k]), torch.zeros(p))
              for p, k in zip(widths, kinds)]
    assert oneread.block_plan(blocks) is None


def _block(rng, tag, n, p):
    """(numpy block for JAX, stored torch block for the port: padded, NaN
    or random bytes in the padding)."""
    if tag == 'int8':
        X = rng.integers(-3, 4, size=(n, p)).astype(np.int8)
        stored = torch.from_numpy(rng.integers(
            -128, 128, size=(n, layout.padded_width(p))).astype(np.int8))
        stored[:, :p] = torch.from_numpy(X)
        return X, stored
    X = (rng.standard_normal((n, p))
         * (rng.uniform(size=(n, p)) < 0.3)).astype(np.float32)
    stored = torch.full((n, layout.padded_width(p)), float('nan'))
    stored[:, :p] = torch.from_numpy(X)
    if tag == 'bf16':
        import ml_dtypes
        X = X.astype(ml_dtypes.bfloat16)
        stored = stored.to(torch.bfloat16)
    return X, stored


PAIRS = ['int8+f32', 'bf16+f32', 'int8', 'bf16', 'f32']


@pytest.mark.parametrize('pair', PAIRS)
def test_plain_matches_pallas(pair):
    rng = np.random.default_rng(200 + PAIRS.index(pair))
    n, widths = 53, (70, 9)
    kinds = pair.split('+')
    Xs = [_block(rng, k, n, p) for k, p in zip(kinds, widths)]
    vs = [rng.standard_normal(p).astype(np.float32) for p in widths]
    c = rng.standard_normal(n).astype(np.float32)
    w = (rng.exponential(size=n) + 1.0).astype(np.float32)
    if len(kinds) == 2:
        oe, of, u = fusedne.fused_ne_matvec2(
            jnp.asarray(Xs[0][0]), jnp.asarray(Xs[1][0]), vs[0], vs[1], c,
            w, interpret=True)
        ref_outs = [oe, of]
    else:
        oe, u = fusedne.fused_ne_matvec(jnp.asarray(Xs[0][0]), vs[0], c, w,
                                        interpret=True)
        ref_outs = [oe]
    blocks = [(S, torch.from_numpy(v)) for (_, S), v in zip(Xs, vs)]
    assert oneread.block_plan(blocks) is not None
    outs, u_t = oneread.ne_oneread(blocks, torch.from_numpy(c),
                                   torch.from_numpy(w))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u), **U_TOL)
    assert len(outs) == len(ref_outs)
    for got, ref in zip(outs, ref_outs):
        _close_reduction(got.numpy(), ref)
    # ne_sweep's 'ne' mode gives the same on the CPU, on either route.
    for route in (None, 'oneread', 'twopass'):
        outs2, u2, lp = ne_sweep(blocks, torch.from_numpy(c), None,
                                 torch.from_numpy(w), 'ne', route=route)
        assert lp is None and torch.equal(u2, u_t)


@pytest.mark.parametrize('mid', ['logit', 'linear'])
@pytest.mark.parametrize('pair', ['int8+f32', 'bf16'])
def test_link_route_matches_pallas(pair, mid):
    rng = np.random.default_rng(300 + 2 * PAIRS.index(pair) + (mid == 'logit'))
    n, widths = 53, (40, 17)
    kinds = pair.split('+')
    Xs = [_block(rng, k, n, p) for k, p in zip(kinds, widths)]
    vs = [0.3 * rng.standard_normal(p).astype(np.float32) for p in widths]
    c = rng.standard_normal(n).astype(np.float32)
    a = rng.integers(0, 3, size=n).astype(np.float32)
    b = (rng.exponential(size=n) + 1.0).astype(np.float32)
    ref_outs, u, lp = fusedne.fused_link_matvec(
        tuple(jnp.asarray(X) for X, _ in Xs), vs[:len(kinds)], c, a, b, mid,
        with_logp=True, interpret=True)
    blocks = [(S, torch.from_numpy(v)) for (_, S), v in zip(Xs, vs)]
    args = (torch.from_numpy(c), torch.from_numpy(a), torch.from_numpy(b))
    outs, u_t, lp_t = oneread.ne_oneread_link(blocks, *args, mid,
                                              with_logp=True)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u), **U_TOL)
    np.testing.assert_allclose(float(lp_t), float(lp), **U_TOL)
    assert len(outs) == len(ref_outs)
    for got, ref in zip(outs, ref_outs):
        _close_reduction(got.numpy(), ref)
    # ne_sweep's link mode gives the same on the CPU, on either route,
    # and without the log-likelihood.
    for route in (None, 'oneread', 'twopass'):
        outs2, u2, lp2 = ne_sweep(blocks, *args, mid, with_logp=True,
                                  route=route)
        assert torch.equal(u2, u_t) and torch.equal(lp2, lp_t)
    outs3, u3, lp3 = oneread.ne_oneread_link(blocks, *args, mid)
    assert lp3 is None and torch.equal(u3, u_t)
    assert all(torch.equal(x, y) for x, y in zip(outs3, outs))


def test_routes_are_checked():
    blocks = [(torch.zeros((3, 16), dtype=torch.int8), torch.zeros(5))]
    c, w = torch.zeros(3), torch.ones(3)
    # Every mode takes the one-read route.
    outs, u, lp = ne_sweep(blocks, c, w, w, 'logit', route='oneread')
    assert lp is None and torch.allclose(u, 1 - 0.5 * w)
    with pytest.raises(ValueError):
        oneread.ne_oneread_link(blocks, c, w, w, 'ne')
    with pytest.raises(ValueError):
        ne_sweep(blocks, c, None, w, 'ne', route='fast')
    with pytest.raises(ValueError):
        oneread.ne_oneread(blocks, c, torch.ones(4))


def _design_data(kind, seed, n=61):
    rng = np.random.default_rng(seed)
    binary = (rng.uniform(size=(n, 11)) < .3).astype(np.float64)
    floats = rng.standard_normal((n, 5)) * 1.3
    if kind == 'bf16':
        binary = binary * rng.choice([0.5, 1.25, -2.0], size=binary.shape)
    if kind == 'none':  # no exactly representable column
        binary = binary * rng.standard_normal(binary.shape)
    return sps.csr_matrix(np.hstack([binary, floats]))


@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('kind', ['int8', 'bf16', 'none'])
def test_design_quad_matvec_matches_jax(monkeypatch, kind, centered):
    """The fused CG operator of the port's hybrid design (``fused='1'``,
    the one-read route on the card) against the JAX design's."""
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    X = _design_data(kind, seed=7 + centered)
    jd = JaxDesign(X, center_predictor=centered, add_intercept=True,
                   backend='hybrid', dtype=np.float32, fused='1')
    td = SparseDesignMatrix(X, center_predictor=centered,
                            add_intercept=True, dtype=np.float32, fused='1',
                            device='cpu')
    if kind == 'none':
        assert td.n_exact == 0 and td.fused_ne_mode('quad') is None
    else:
        assert td.fused_ne_mode('quad') is not None
        assert str(td.X_exact.dtype).endswith(
            'int8' if kind == 'int8' else 'bfloat16')
    rng = np.random.default_rng(13)
    n, p = td.shape
    v = rng.standard_normal(p).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    _close_reduction(td.quad_matvec(v, w).numpy(), jd.quad_matvec(v, w))


def test_ablation_copies_cut_their_part():
    from bayesbridge_tpu_torch.baselines import oneread_ablation as ab
    v = ab.variants()
    assert set(v) == {'base', 'noA', 'noB', 'noAB', 'noexch', 'nostream',
                      'onewarp'}
    assert ab._A not in v['noA'] and ab._B in v['noA']
    assert ab._B not in v['noB'] and ab._A in v['noB']
    assert ab._A not in v['noAB'] and ab._B not in v['noAB']
    assert ab._PUSH not in v['noexch'] and ab._WAIT not in v['noexch']
    assert ab._EXPECT not in v['nostream'] and ab._COPY not in v['nostream']
    assert all(ab._EXPECT in v[k] for k in v if k != 'nostream')
    assert ab._SPLIT not in v['onewarp'] and ab._ONEWARP in v['onewarp']
