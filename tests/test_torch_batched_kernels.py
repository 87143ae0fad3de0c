"""The chain-batched sweeps' plain versions on the CPU (``ne_rows_k``,
``colpass_k``, ``tdots_sweep_k``; their CUDA kernels run only on the
card, tests/test_torch_cuda.py):

* each equals k single-vector plain calls, bit for bit (they run them
  chain by chain: the kernels' own promise on the card);
* each equals the JAX package's Pallas kernels under ``jax.vmap`` over
  the chains in interpret mode, as the JAX package's ``gibbs_chains``
  runs them: the row pass against ``fused_ne_matvec`` with unit row
  weights (u = X v + c), the column pass and the pre-solve reductions
  against ``fused_tdots``, on every block pair the hybrid design builds.

Tolerances as in tests/test_torch_ne_oneread.py: rows rtol 2e-5 / atol
2e-4, column reductions rtol 2e-4 / atol 2e-4 * max|out| (sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesbridge_tpu.design import fusedne
from bayesbridge_tpu_torch.kernels import layout
from bayesbridge_tpu_torch.kernels.ne_sweep import (
    colpass_k, colpass_plain, ne_rows_k, ne_rows_plain,
)
from bayesbridge_tpu_torch.kernels.tdots_sweep import (
    tdots_sweep_k, tdots_sweep_plain,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

U_TOL = dict(rtol=2e-5, atol=2e-4)
PAIRS = ['int8+f32', 'bf16+f32', 'int8', 'f32']


def _close_reduction(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=2e-4,
                               atol=2e-4 * max(np.abs(ref).max(), 1.0))


def _block(rng, tag, n, p):
    """(numpy X, its stored tensor with NaN padding for float kinds)."""
    if tag == 'int8':
        X = rng.integers(-3, 4, size=(n, p)).astype(np.int8)
        stored = torch.zeros((n, layout.padded_width(p)), dtype=torch.int8)
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


def _setup(pair, k=3, n=53, widths=(70, 9)):
    rng = np.random.default_rng(300 + PAIRS.index(pair))
    kinds = pair.split('+')
    Xs = [_block(rng, kind, n, p) for kind, p in zip(kinds, widths)]
    ps = list(widths[:len(kinds)])
    Vs = [rng.standard_normal((k, p)).astype(np.float32) for p in ps]
    Us = [rng.standard_normal((k, n)).astype(np.float32) for _ in range(4)]
    c = rng.standard_normal(k).astype(np.float32)
    return Xs, ps, Vs, Us, c


@pytest.mark.parametrize('pair', PAIRS)
def test_row_pass_k(pair):
    Xs, ps, Vs, _, c = _setup(pair)
    k, n = c.shape[0], Xs[0][0].shape[0]
    blocks = [(S, torch.from_numpy(V)) for (_, S), V in zip(Xs, Vs)]
    T = ne_rows_k(blocks, torch.from_numpy(c))
    assert T.shape == (k, n)
    for i in range(k):
        one = ne_rows_plain([(S, V[i]) for S, V in blocks],
                            torch.tensor(c[i]))
        assert torch.equal(T[i], one)
    # A per-row offset (k, n) too.
    C = torch.from_numpy(np.outer(c, np.linspace(0, 1, n)).astype(
        np.float32))
    T2 = ne_rows_k(blocks, C)
    assert torch.equal(T2[1], ne_rows_plain([(S, V[1]) for S, V in blocks],
                                            C[1]))

    ones = jnp.ones(n, jnp.float32)
    cs = jnp.broadcast_to(jnp.asarray(c)[:, None], (k, n))
    if len(Xs) == 2:
        def ref(v0, v1, cc):
            return fusedne.fused_ne_matvec2(
                jnp.asarray(Xs[0][0]), jnp.asarray(Xs[1][0]), v0, v1, cc,
                ones, interpret=True)[2]
        u = jax.vmap(ref)(jnp.asarray(Vs[0]), jnp.asarray(Vs[1]), cs)
    else:
        def ref(v0, cc):
            return fusedne.fused_ne_matvec(jnp.asarray(Xs[0][0]), v0, cc,
                                           ones, interpret=True)[1]
        u = jax.vmap(ref)(jnp.asarray(Vs[0]), cs)
    np.testing.assert_allclose(T.numpy(), np.asarray(u), **U_TOL)


@pytest.mark.parametrize('pair', PAIRS)
def test_column_pass_and_presolve_k(pair):
    Xs, ps, _, Us, c = _setup(pair)
    k = c.shape[0]
    S = [s for _, s in Xs]
    U = [torch.from_numpy(u) for u in Us]
    cols = colpass_k(S, ps, U[0])
    assert [o.shape for o in cols] == [(k, p) for p in ps]
    five = tdots_sweep_k(S, ps, *U)
    four = tdots_sweep_k(S, ps, *U[:3])
    for i in range(k):
        for got, one in zip(cols, colpass_plain(S, ps, U[0][i])):
            assert torch.equal(got[i], one)
        for blk5, blk4, one in zip(five, four, tdots_sweep_plain(
                S, ps, *(u[i] for u in U))):
            assert len(blk5) == 5 and len(blk4) == 4
            for r in range(5):
                assert torch.equal(blk5[r][i], one[r])
            for r in range(4):
                assert torch.equal(blk4[r][i], one[r])

    def ref(u1, u2, u3):
        return fusedne.fused_tdots(tuple(jnp.asarray(x) for x, _ in Xs),
                                   u1, u2, u3, interpret=True)

    outs = jax.vmap(ref)(*(jnp.asarray(u) for u in Us[:3]))
    # X'u4 as the first reduction of a second vmapped sweep.
    outs4 = jax.vmap(ref)(*(jnp.asarray(Us[3]) for _ in range(3)))
    for b in range(len(Xs)):
        for r in range(4):
            _close_reduction(five[b][r].numpy(), outs[b][r])
        _close_reduction(five[b][4].numpy(), outs4[b][0])
        _close_reduction(cols[b].numpy(), outs[b][0])


def test_batched_wrappers_check_their_operands():
    Xs, ps, Vs, Us, c = _setup('int8+f32')
    S = [s for _, s in Xs]
    with pytest.raises(ValueError, match='chain-batched'):
        colpass_k(S, ps, torch.from_numpy(Us[0]).double())
    with pytest.raises(TypeError, match='second block'):
        colpass_k([S[0], S[0]], [ps[0], ps[0]], torch.from_numpy(Us[0]))
    blocks = [(s, torch.from_numpy(V)) for s, V in zip(S, Vs)]
    with pytest.raises(ValueError, match=r'\(k,\)'):
        ne_rows_k(blocks, torch.zeros((3, 5)))


PLAN_BLOCKS = {'int8+f32': [torch.int8, torch.float32],
               'bf16+f32': [torch.bfloat16, torch.float32],
               'f32+f32': [torch.float32, torch.float32],
               'int8': [torch.int8], 'bf16': [torch.bfloat16],
               'f32': [torch.float32]}


@pytest.mark.parametrize('kind', sorted(layout.BATCHED_KINDS))
@pytest.mark.parametrize('blocks', list(PLAN_BLOCKS))
def test_batched_plan_one_launch_up_to_8_chains(kind, blocks):
    """The launch plan serves k <= 8 chains in one launch on every block
    pair (chain_groups agrees), within a CTA's 227 KB of shared memory,
    and rounds k up to the compiled chain count."""
    dtypes = PLAN_BLOCKS[blocks]
    for k in range(1, 9):
        plan = layout.batched_plan(kind, dtypes, k)
        assert plan.chains >= 8
        assert layout.chain_groups(k, plan.chains) == [(0, k)]
        assert 0 < plan.smem_bytes <= layout.SMEM_PER_CTA
        assert plan.compiled >= k and plan.compiled in (1, 2, 4, 8)
        assert len(plan.rows_per_panel) == len(plan.column_chunk) \
            == len(dtypes)
        assert min(plan.rows_per_panel) >= 1
    # Past 8 chains: launches of 8.
    assert layout.chain_groups(11, layout.batched_plan(
        kind, dtypes, 11).chains) == [(0, 8), (8, 3)]


def test_batched_plan_geometry():
    """The geometry the CUDA sources compile: the row pass's 96-row
    panels (128 at 2 chains), 512-column chunks of v and three steps of
    each warp's rows (192 KB of shared memory at 4 and 8 chains); the
    pre-solve's staged kernel for 5-8
    chains (tiles of 512 columns, 32-row int8 and 8-row f32 panels) and
    the register-tiled pass below (4-byte units of a row, 128 rows of u
    staged), which the column pass runs at every k."""
    i8f = [torch.int8, torch.float32]
    rows = layout.batched_plan('rows', i8f, 8)
    assert rows == (8, 8, (96, 96), (512, 512), 196_608)
    assert layout.batched_plan('rows', i8f, 3)[:3] == (8, 4, (96, 96))
    assert layout.batched_plan('rows', i8f, 1)[:3] == (8, 2, (128, 128))
    t8 = layout.batched_plan('tdots5', i8f, 6)
    assert t8 == (8, 8, (32, 8), (512, 512), 4 * (16_384 + 4 * 4 * 32 * 8))
    t4 = layout.batched_plan('tdots5', i8f, 4)
    assert t4 == (8, 4, (128, 128), (1024, 512), 128 * 4 * 4 * 4)
    assert layout.batched_plan('tdots4', i8f, 3).smem_bytes \
        == 128 * 3 * 4 * 4
    assert layout.batched_plan('tdots5', i8f, 1).compiled == 1
    cols = layout.batched_plan('cols', i8f, 8)
    assert cols == (8, 8, (128, 128), (2048, 1024), 128 * 8 * 4)
    with pytest.raises(ValueError, match='kind'):
        layout.batched_plan('gram', i8f, 2)
