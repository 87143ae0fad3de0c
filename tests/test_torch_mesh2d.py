"""The port's 2-d obs x pred mesh (``make_mesh((r, c))``,
``shard_design(..., pred_axis='pred')``) on the CPU, on grids of
repeated CPU entries (up to 8).

* The products (dot, Tdot, quad_matvec, the pre-solve reductions, the
  Fisher diagonal and information, and their 3-chain forms) of every
  backend (hybrid float32, float64 and int4, dense, bitpack, ell; winell
  with its warning), centred and not, with and without intercept, on
  (4, 2) and (2, 4), against the JAX package's design after its own
  ``shard_design(..., pred_axis='pred')`` on the suite's virtual CPU
  devices (tests/conftest.py), carried across by
  ``convert.design_from_sharded_numpy``: float64 within 1e-12 of
  max|ref|, float32 within 1e-5 (products only: a sharded JAX step
  compiles for minutes). The uneven 100 x 23 design on (4, 2).
* Layout and order: every piece keeps the whole design's column split;
  (r, 1) gives the 1-d mesh's bits; the int4 pieces give the int8
  pieces' bits. (The same grid held by two processes gives the one
  process's bits: tests/test_torch_distributed.py.)
* The 2-d CG solve against the JAX package's 2-d sharded solve (equal
  ``n_cg_iter``, float64 within 1e-10); float64 chains on (2, 2) within
  1e-9 of the unsharded chains over 5 iterations (hybrid CG, ell CG, Cox
  HMC on the hybrid) and an exact resume; ``gibbs_chains(mesh=)`` on a
  2-d mesh, each chain equal to the chain alone.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import sparse as jax_sparse
from bayesbridge_tpu.parallel import make_mesh as jax_make_mesh
from bayesbridge_tpu.parallel import shard_design as jax_shard_design
from bayesbridge_tpu_torch import convert
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.design import sparse as sparse_mod
from bayesbridge_tpu_torch.design.pieces import main_columns
from bayesbridge_tpu_torch.design.sharded import ShardedDesignMatrix
from bayesbridge_tpu_torch.kernels import layout
from bayesbridge_tpu_torch.parallel import make_mesh, shard_design
from bayesbridge_tpu_torch.utils.simulate_data import simulate_design
from tests.test_torch_parallel import (
    _check_products, _inputs, _pair, check_cg_against_jax,
    check_chains_on_mesh, check_sharded_chain, cpu_mesh,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = torch.device('cpu')
N_ROWS = 102  # padded to 104 by the JAX (4, 2) mesh


def grid_mesh(grid):
    return make_mesh(grid, devices=[CPU] * 8)


def _data(n, seed, binary=40, normal=9):
    """0/1 columns at 30% density beside half-filled normal ones: 40
    binary columns make two exact pieces (cut at 32) and several bitmap
    pieces (cut at 8)."""
    rng = np.random.default_rng(seed)
    bits = (rng.uniform(size=(n, binary)) < .3).astype(np.float64)
    vals = rng.standard_normal((n, normal)) * (rng.uniform(size=(n, normal))
                                               < .5)
    return sps.csr_matrix(np.hstack([bits, vals]))


@pytest.fixture
def int4_on(monkeypatch):
    """The int4 opt-in set, both packages' capability caches fresh."""
    monkeypatch.setenv('BB_HYBRID_INT4', '1')
    monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
    monkeypatch.setattr(jax_sparse, '_INT4_SUPPORTED', {})


# The JAX design's arrays each backend carries across.
NAMES = {'hybrid': ('X_exact', 'X_float', 'exact_cols', 'float_cols'),
         'dense': ('X',),
         'bitpack': ('bits_col', 'bits_row', 'X_float', 'bin_cols',
                     'float_cols'),
         'winell': ('widx_dot', 'wval_dot', 'widx_tdot', 'wval_tdot',
                    'sd_idx', 'sd_val', 'st_idx', 'st_val'),
         'ell': ('row_idx', 'row_val', 'col_idx', 'col_val')}


def _carried(jd, backend, n, centered, intercept, int4=False):
    """The port's unsharded design from the JAX design `jd` sharded on a
    2-d mesh, its mesh padding (rows and columns) cut off."""
    arrays = {name: np.asarray(getattr(jd, name)) for name in NAMES[backend]}
    if int4:
        arrays['X_exact'] = arrays['X_exact'].astype(np.int8)
        arrays['exact_tier'] = 'int4'
    meta = {'bitpack': getattr(jd, '_bitpack_meta', None),
            'winell': (getattr(jd, '_winell_shard', None) or (0,) * 7)[2:7]
            }.get(backend)
    offset = np.zeros(0) if backend == 'dense' \
        else np.asarray(jd.column_offset)
    return convert.design_from_sharded_numpy(
        backend, arrays, meta, offset, (n, jd.shape[1] - int(intercept)),
        add_intercept=intercept, center_predictor=centered, device='cpu')


LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]
GRIDS = [(4, 2), (2, 4)]


def cases(kinds):
    """(backend, dtype, int4, centered, intercept, grid) of each kind in
    every layout, the grids in turns."""
    return [kind + layout_ + (GRIDS[(k + j) % 2],)
            for k, kind in enumerate(kinds)
            for j, layout_ in enumerate(LAYOUTS)]


# (backend, dtype, int4): float64 where the backend takes it. The packed
# backends' cases, whose JAX designs take longest to shard, are
# tests/test_torch_mesh2d_packed.py's.
KINDS = [('hybrid', np.float32, False), ('hybrid', np.float64, False),
         ('hybrid', np.float32, True), ('dense', np.float32, False),
         ('dense', np.float64, False), ('ell', np.float32, False),
         ('ell', np.float64, False)]


@pytest.mark.parametrize('backend,dtype,int4,centered,intercept,grid',
                         cases(KINDS))
def test_2d_products_match_jax_2d_design(monkeypatch, backend, dtype, int4,
                                         centered, intercept, grid):
    check_2d_case(monkeypatch, backend, dtype, int4, centered, intercept,
                  grid)


def check_2d_case(monkeypatch, backend, dtype, int4, centered, intercept,
                  grid):
    """The port's 2-d design against the JAX design sharded on the same
    grid: the products, the warning (winell), the layout flags and the
    counters."""
    if int4:
        monkeypatch.setenv('BB_HYBRID_INT4', '1')
        monkeypatch.setattr(sparse_mod, '_INT4_SUPPORTED', {})
        monkeypatch.setattr(jax_sparse, '_INT4_SUPPORTED', {})
    else:
        monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    X = _data(N_ROWS, seed=sum(grid) + 2 * centered + intercept)
    f64 = dtype == np.float64
    jd, _ = _pair(backend, dtype, X, centered, intercept, '0')
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter('always')
        jax_shard_design(jd, jax_make_mesh(grid), pred_axis='pred')
    td = _carried(jd, backend, N_ROWS, centered, intercept, int4)
    assert layout.is_int4(td.X_exact) if int4 else True
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter('always')
        sd = shard_design(td, grid_mesh(grid), pred_axis='pred')
    said = [str(w.message) for w in warned]
    if backend == 'winell':
        assert any('observation axis only' in str(w.message)
                   for w in jax_warned)
        assert any('observation axis only' in s for s in said)
        assert len(sd.col_pieces) == 1 and sd.n_shards == grid[0]
    else:
        assert not said
        assert len(sd.col_pieces) > 1
        assert sd.fused_ne_mode('quad') is None
        assert sd.cg_blockorder_ctx() is None
    assert isinstance(sd, ShardedDesignMatrix)
    assert sd.shape == td.shape == tuple(jd.shape)
    _check_products(sd, jd, _inputs(td, N_ROWS, dtype), f64)
    # One product per call on the counters, as the unsharded design.
    td.reset_matvec_count()
    sd.reset_matvec_count()
    x = _inputs(td, 1, dtype)
    for d in (td, sd):
        d.dot(torch.from_numpy(x['v']))
        d.Tdot(torch.from_numpy(x['U']))
        d.quad_matvec(torch.from_numpy(x['v']), torch.from_numpy(x['w']))
    assert sd.get_dot_count() == td.get_dot_count()


def test_uneven_2d_mesh_100_by_23():
    """100 rows and 23 columns on (4, 2) (tests/test_parallel.py
    :156-176): uneven on both axes, no padding, the JAX 2-d design's
    products."""
    X = sps.csr_matrix(simulate_design(100, 23, binary_frac=.8, seed=0))
    jd, td = _pair('hybrid', np.float64, X, True, True)
    jax_shard_design(jd, jax_make_mesh((4, 2)), pred_axis='pred')
    sd = shard_design(td, grid_mesh((4, 2)), pred_axis='pred')
    assert [b - a for a, b in sd.bounds] == [25, 25, 25, 25]
    assert len(sd.col_pieces) == 2
    _check_products(sd, jd, _inputs(td, 4, np.float64), True)


def test_pieces_keep_the_global_column_split():
    """Column 0 is 0/1 in the first rows only: a design over a row block
    would store it int8, the whole design float32. Every piece keeps the
    whole design's split and offsets restricted to its columns, and the
    pieces' columns cover the design once; only piece 0 holds the
    intercept."""
    rng = np.random.default_rng(5)
    X = _data(120, seed=5).toarray()
    X[60:, 0] = rng.standard_normal(60) * (rng.uniform(size=60) < .5)
    X = sps.csr_matrix(X)
    jd, td = _pair('hybrid', np.float32, X, True, True, fused='0')
    assert 0 in td.float_cols.tolist()
    sd = shard_design(td, grid_mesh((2, 4)), pred_axis='pred')
    c = len(sd.col_pieces)
    assert c == 3  # 39 exact columns (cut at 32), 10 float (cut at 4)
    exact, flt = set(td.exact_cols.tolist()), set(td.float_cols.tolist())
    mains = [main_columns(cp, td.intercept_added) for cp in sd.col_pieces]
    for i, piece in sd.local_shards():
        main = mains[i % c]
        assert torch.equal(main, torch.sort(main)[0])
        assert set(main[piece.exact_cols].tolist()) <= exact
        assert set(main[piece.float_cols].tolist()) <= flt
        assert sorted(piece._own_cols().tolist()) == list(range(len(main)))
        assert torch.equal(piece.column_offset, td.column_offset[main])
        assert piece.shape[1] == len(main) + (i % c == 0)
        assert piece.intercept_added == (i % c == 0)
        assert piece.X_exact.shape[1] % 16 == 0 \
            and piece.X_float.shape[1] % 16 == 0
    assert sorted(torch.cat(mains).tolist()) == list(range(td.shape[1] - 1))
    row0 = [s for i, s in sd.local_shards() if i < c]
    assert [s.n_exact for s in row0] == [32, 7, 0]
    _check_products(sd, jd, _inputs(td, 2, np.float32), False)


def _bits(sd, x):
    t = {key: torch.from_numpy(val) for key, val in x.items()}
    out = [sd.dot(t['v']), sd.Tdot(t['u']), sd.quad_matvec(t['v'], t['w']),
           sd.compute_fisher_diag(t['w']), sd.compute_fisher_info(t['w']),
           sd.dot(t['V']), sd.Tdot(t['U']), sd.compute_fisher_diag(t['W'])]
    if sd.has_presolve_reductions():
        out += list(sd.presolve_reductions(t['u'], t['w'] * t['u'], t['w'],
                                           t['w'] * t['v'][0]))
    return out


@pytest.mark.parametrize('backend,fused', [('hybrid', '1'), ('hybrid', '0'),
                                           ('dense', None), ('bitpack', None),
                                           ('ell', None)])
def test_r_by_1_mesh_gives_the_1d_bits(backend, fused):
    X = _data(90, seed=11)
    _, td = _pair(backend, np.float32, X, True, True, fused)
    one = shard_design(td, cpu_mesh(3))
    two = shard_design(td, grid_mesh((3, 1)), pred_axis='pred')
    assert two.fused_ne_mode('quad') == one.fused_ne_mode('quad')
    x = _inputs(td, 3, np.float32)
    for a, b in zip(_bits(one, x), _bits(two, x)):
        assert torch.equal(a, b)
    if backend == 'hybrid' and fused == '0':
        (p1, u1, o1), (p2, u2, o2) = one.cg_blockorder_ctx(), \
            two.cg_blockorder_ctx()
        assert torch.equal(p1, p2) and torch.equal(o1, o2)


@pytest.mark.parametrize('grid', [(2, 4), (4, 2), (2, 2)])
def test_int4_pieces_equal_int8_pieces(int4_on, grid):
    """Values in [-8, 7] on 70 exact columns (pieces cut at 32, the last
    ragged) beside float ones: the packed int4 design's pieces give the
    int8 design's bits, product for product."""
    rng = np.random.default_rng(sum(grid))
    small = rng.integers(-8, 8, size=(101, 70)) * (rng.uniform(
        size=(101, 70)) < .4)
    vals = rng.standard_normal((101, 5))
    X = sps.csr_matrix(np.hstack([small, vals]))
    d4 = SparseDesignMatrix(X, center_predictor=True, fused='0',
                            device='cpu')
    assert layout.is_int4(d4.X_exact) and d4.n_exact == 70
    d8 = d4.with_exact_tier('int8')
    s4 = shard_design(d4, grid_mesh(grid), pred_axis='pred')
    s8 = shard_design(d8, grid_mesh(grid), pred_axis='pred')
    assert [s.n_exact for i, s in s4.local_shards() if i < grid[1]] \
        == [s.n_exact for i, s in s8.local_shards() if i < grid[1]]
    assert all(layout.is_int4(s.X_exact) for _, s in s4.local_shards()
               if s.n_exact)
    x = _inputs(d4, 7, np.float32)
    for a, b in zip(_bits(s4, x), _bits(s8, x)):
        assert torch.equal(a, b)


def test_2d_cg_matches_jax_2d_cg():
    """Same b, preconditioner, warm start and perturbation: the port's
    (2, 2) float64 CG solve and the JAX package's solve on its 2-d
    sharded design take as many iterations and agree within 1e-10."""
    check_cg_against_jax((2, 2), grid_mesh((2, 2)), 'pred')


@pytest.mark.parametrize('case', ['hybrid', 'ell', 'cox'])
def test_2d_chain_matches_unsharded(case):
    sharded = check_sharded_chain(case, grid_mesh((2, 2)), 'pred')
    assert len(sharded.design.col_pieces) == 2


def test_chains_on_2d_mesh_equal_chains_alone():
    """Three chains over a (2, 2) mesh: two groups, one a mesh row, each
    on its row's first device; chain c equals the chain alone."""
    mesh = grid_mesh((2, 2))
    assert len(mesh.row_devices) == 2
    check_chains_on_mesh(mesh)


def test_2d_mesh_layout():
    mesh = grid_mesh((2, 3))
    assert mesh.shape == {'shard': 2, 'pred': 3} and mesh.size == 6
    assert mesh.grid == (2, 3) and mesh.home == CPU
    assert mesh.local_indices() == list(range(6))
    assert mesh.column(1).devices == (CPU, CPU)
    assert mesh.column(0).shape == {'shard': 2}
    X = _data(40, seed=3)
    _, td = _pair('hybrid', np.float32, X, False, True)
    # Without pred_axis a 2-d mesh splits rows over its first column.
    sd = shard_design(td, mesh)
    assert sd.n_shards == 2 and len(sd.col_pieces) == 1
    v = torch.ones(td.shape[1])
    assert torch.equal(sd.dot(v), shard_design(td, cpu_mesh(2)).dot(v))
