"""The port's 1-d observation mesh (``bayesbridge_tpu_torch.parallel``)
on the CPU, on meshes of 1-4 repeated CPU devices.

* The sharded products (dot, Tdot, quad_matvec and its block-ordered
  form, the pre-solve reductions, fused_link_grad, the Fisher diagonal
  and information, and their 3-chain forms) of every backend (hybrid,
  dense, bitpack, winell, ell), centred and not, with and without
  intercept, float32 and, where the backend takes it, float64, against
  the JAX package's products of the same design: float64 within 1e-12 of
  max|ref|, float32 within 1e-5; one case has 100 rows over 3 shards.
* The same against the JAX design sharded by its own ``shard_design`` on
  the suite's virtual CPU devices (tests/conftest.py), carried across by
  ``convert.design_from_sharded_numpy`` (products only: a sharded JAX
  step compiles for minutes).
* Block order: a column int8-exact in some row blocks only stays a float
  column in every shard.
* The sharded CG solve against the JAX package's sharded solve on the
  same b, preconditioner and warm start: equal ``n_cg_iter``, float64
  within 1e-10.
* The sharded float64 chain against the unsharded chain over 5
  iterations within 1e-9 (hybrid CG, ell CG, Cox HMC on the hybrid), and
  an exact resume on a sharded model.
* ``gibbs_chains(mesh=)`` on a 2-device mesh: each chain equals the chain
  alone bit for bit, and resume is exact.
* Row views, ``place_model``, the launch counters from several threads,
  and the errors (a mesh larger than its devices, a ``pred_axis`` the
  mesh lacks, winell's warning on a 2-d mesh, ``mesh=`` on a sharded
  model). The 2-d mesh: tests/test_torch_mesh2d.py.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import DenseDesignMatrix as JaxDense
from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.ops.cg import sample_gaussian_cg as jax_cg
from bayesbridge_tpu.parallel import make_mesh as jax_make_mesh
from bayesbridge_tpu.parallel import shard_design as jax_shard_design
from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel, convert,
    gibbs_chains,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.design import DenseDesignMatrix, SparseDesignMatrix
from bayesbridge_tpu_torch.design.sharded import ShardedDesignMatrix
from bayesbridge_tpu_torch.kernels import build
from bayesbridge_tpu_torch.multichain import (
    _stack_chain_inits, gibbs_chains_resume,
)
from bayesbridge_tpu_torch.ops.cg import sample_gaussian_cg
from bayesbridge_tpu_torch.parallel import (
    Mesh, make_mesh, place_model, shard_design, shard_model,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

CPU = torch.device('cpu')
PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


def cpu_mesh(n):
    return make_mesh(devices=[CPU] * n)


def _data(n, seed, binary=16, normal=8):
    """16 0/1 columns at 30% density beside 8 half-filled normal ones."""
    rng = np.random.default_rng(seed)
    bits = (rng.uniform(size=(n, binary)) < .3).astype(np.float64)
    vals = rng.standard_normal((n, normal)) * (rng.uniform(size=(n, normal))
                                               < .5)
    return sps.csr_matrix(np.hstack([bits, vals]))


def _pair(backend, dtype, X, centered, intercept, fused=None):
    """(JAX design, port design) of the same X."""
    kw = dict(center_predictor=centered, add_intercept=intercept,
              dtype=dtype)
    if backend == 'dense':
        return (JaxDense(X.toarray(), **kw),
                DenseDesignMatrix(X.toarray(), fused=fused, device='cpu',
                                  **kw))
    return (JaxDesign(X, backend=backend, fused=fused, **kw),
            SparseDesignMatrix(X, backend=backend, fused=fused, device='cpu',
                               **kw))


def _close(got, ref, f64):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == ref.shape
    tol = (1e-12 if f64 else 1e-5) * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _inputs(design, seed, dtype, k=3):
    rng = np.random.default_rng(seed)
    n, p = design.shape
    return dict(v=rng.standard_normal(p).astype(dtype),
                u=rng.standard_normal(n).astype(dtype),
                w=(rng.exponential(size=n) + .2).astype(dtype),
                V=rng.standard_normal((k, p)).astype(dtype),
                U=rng.standard_normal((k, n)).astype(dtype),
                W=(rng.exponential(size=(k, n)) + .2).astype(dtype))


def _check_products(sd, jd, x, f64):
    """Every sharded product against the JAX design's single-vector
    ones; the 3-chain forms row by row."""
    t = {key: torch.from_numpy(val) for key, val in x.items()}
    v, u, w = x['v'], x['u'], x['w']
    _close(sd.dot(t['v']), jd.dot(v), f64)
    _close(sd.Tdot(t['u']), jd.Tdot(u), f64)
    _close(sd.quad_matvec(t['v'], t['w']), jd.quad_matvec(v, w), f64)
    out, lin = sd.quad_matvec(t['v'], t['w'], return_t=True)
    _close(out, jd.quad_matvec(v, w), f64)
    _close(lin, jd.dot(v), f64)
    fd = jd.compute_fisher_info(w, diag_only=True)
    _close(sd.compute_fisher_diag(t['w']), fd, f64)
    _close(sd.compute_fisher_info(t['w'], diag_only=True), fd, f64)
    _close(sd.compute_fisher_info(t['w']), jd.compute_fisher_info(w), f64)
    ctx = sd.cg_blockorder_ctx()
    if ctx is not None:
        perm, unperm, off = ctx
        got, lin = sd.quad_matvec_blockorder(t['v'][perm], t['w'], off,
                                             return_t=True)
        _close(got[unperm], jd.quad_matvec(v, w), f64)
        _close(lin, jd.dot(v), f64)
    if sd.has_presolve_reductions():
        ref = (jd.Tdot(u), jd.Tdot(w * u),
               jd.compute_fisher_info(w, diag_only=True), jd.Tdot(w * v[0]))
        got = sd.presolve_reductions(t['u'], t['w'] * t['u'], t['w'],
                                     t['w'] * t['v'][0])
        for g, r in zip(got, ref):
            _close(g, r, f64)
        got3 = sd.presolve_reductions(t['u'], t['w'] * t['u'], t['w'])
        for g, r in zip(got3, ref[:3]):
            _close(g, r, f64)
    if sd.fused_ne_mode('link') is not None:
        a = (x['u'] > 0).astype(x['u'].dtype)
        lp, grad = sd.fused_link_grad(t['v'] * .3, torch.from_numpy(a),
                                      torch.ones_like(t['w']), 'logit')
        lp_j, grad_j = jd.fused_link_grad(v * .3, a, np.ones_like(w),
                                          'logit')
        _close(lp, lp_j, f64)
        _close(grad, grad_j, f64)
    # 3 chains at once: each row is the chain's own product.
    V, U, W = x['V'], x['U'], x['W']
    dots, tdots = sd.dot(t['V']), sd.Tdot(t['U'])
    quads = sd.quad_matvec(t['V'], t['W'])
    diags = sd.compute_fisher_diag(t['W'])
    for c in range(V.shape[0]):
        _close(dots[c], jd.dot(V[c]), f64)
        _close(tdots[c], jd.Tdot(U[c]), f64)
        _close(quads[c], jd.quad_matvec(V[c], W[c]), f64)
        _close(diags[c], jd.compute_fisher_info(W[c], diag_only=True), f64)
    if sd.has_presolve_reductions():
        got = sd.presolve_reductions(t['U'], t['W'], t['W'])
        for c in range(V.shape[0]):
            _close(got[0][c], jd.Tdot(U[c]), f64)
            _close(got[2][c], jd.compute_fisher_info(W[c], diag_only=True),
                   f64)


# (backend, dtype): float64 where the backend takes it.
KINDS = [('hybrid', np.float32), ('hybrid', np.float64),
         ('dense', np.float32), ('dense', np.float64),
         ('bitpack', np.float32), ('winell', np.float32),
         ('ell', np.float32), ('ell', np.float64)]
LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]
# (rows, shards), in turns; 100 rows over 3 shards is the uneven case.
MESHES = [(60, 1), (150, 2), (100, 3), (200, 4)]
CASES = [(b, d, c, i) + MESHES[(k + j) % 4]
         for k, (b, d) in enumerate(KINDS)
         for j, (c, i) in enumerate(LAYOUTS)]


@pytest.mark.parametrize('backend,dtype,centered,intercept,n_rows,n_shards',
                         CASES)
def test_sharded_products_match_jax(monkeypatch, backend, dtype, centered,
                                    intercept, n_rows, n_shards):
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    X = _data(n_rows, seed=n_rows + n_shards)
    f64 = dtype == np.float64
    # The float32 hybrid in turns fused (each shard runs the fused sweeps
    # on its rows) and composed (the block-ordered CG operator).
    fused = ('1' if intercept else '0') if backend == 'hybrid' else None
    jd, td = _pair(backend, dtype, X, centered, intercept, fused)
    sd = shard_design(td, cpu_mesh(n_shards))
    assert isinstance(sd, ShardedDesignMatrix)
    assert sd.shape == td.shape == tuple(jd.shape)
    assert [b - a for a, b in sd.bounds] == [
        min(n_rows, (i + 1) * -(-n_rows // n_shards)) - i * -(-n_rows
                                                              // n_shards)
        for i in range(n_shards)]
    if backend == 'hybrid' and not f64:
        assert (sd.fused_ne_mode('quad') is None) == (fused == '0')
    _check_products(sd, jd, _inputs(td, n_rows, dtype), f64)
    # One product per call on the counters, as the unsharded design.
    td.reset_matvec_count()
    sd.reset_matvec_count()
    x = _inputs(td, 1, dtype)
    for d in (td, sd):
        d.dot(torch.from_numpy(x['v']))
        d.Tdot(torch.from_numpy(x['U']))
    assert sd.get_dot_count() == td.get_dot_count()


@pytest.mark.parametrize('backend', ['hybrid', 'dense', 'bitpack', 'winell',
                                     'ell'])
def test_products_match_jax_sharded_design(monkeypatch, backend):
    """The port's 4-shard design against the JAX design after its own
    ``shard_design`` on 4 virtual devices, the JAX arrays carried across
    (``np.asarray`` gathers them; the mesh padding is cut off)."""
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    n = 102  # padded to 104 by the JAX mesh
    X = _data(n, seed=7)
    jd, _ = _pair(backend, np.float32, X, True, True)
    jax_shard_design(jd, jax_make_mesh(4))
    names = {'hybrid': ('X_exact', 'X_float', 'exact_cols', 'float_cols'),
             'dense': ('X',),
             'bitpack': ('bits_col', 'bits_row', 'X_float', 'bin_cols',
                         'float_cols'),
             'winell': ('widx_dot', 'wval_dot', 'widx_tdot', 'wval_tdot',
                        'sd_idx', 'sd_val', 'st_idx', 'st_val'),
             'ell': ('row_idx', 'row_val', 'col_idx', 'col_val')}[backend]
    arrays = {name: np.asarray(getattr(jd, name)) for name in names}
    meta = {'bitpack': getattr(jd, '_bitpack_meta', None),
            'winell': (getattr(jd, '_winell_shard', None) or (0,) * 7)[2:7]
            }.get(backend)
    offset = np.zeros(0) if backend == 'dense' \
        else np.asarray(jd.column_offset)
    shape = (n, jd.shape[1] - 1)
    td = convert.design_from_sharded_numpy(
        backend, arrays, meta, offset, shape, center_predictor=True,
        device='cpu')
    assert td.shape == tuple(jd.shape)
    sd = shard_design(td, cpu_mesh(4))
    x = _inputs(td, 3, np.float32)
    t = {key: torch.from_numpy(val) for key, val in x.items()}
    _close(sd.dot(t['v']), jd.dot(x['v']), False)
    _close(sd.Tdot(t['u']), jd.Tdot(x['u']), False)
    _close(sd.compute_fisher_diag(t['w']),
           jd.compute_fisher_info(x['w'], diag_only=True), False)
    _close(sd.quad_matvec(t['v'], t['w']), jd.quad_matvec(x['v'], x['w']),
           False)


def test_block_order_uses_the_global_column_split():
    """Column 0 is 0/1 in the first half of the rows and general-valued
    in the second: a design over the first block alone would store it
    int8, the whole design float32. Every shard keeps the whole design's
    split, so the block-ordered CG operator sums in one order."""
    rng = np.random.default_rng(5)
    X = _data(120, seed=5).toarray()
    X[60:, 0] = rng.standard_normal(60) * (rng.uniform(size=60) < .5)
    X = sps.csr_matrix(X)
    jd, td = _pair('hybrid', np.float32, X, True, True, fused='0')
    own = SparseDesignMatrix(X[:60], center_predictor=True, fused='0',
                             device='cpu')
    assert 0 in own.exact_cols.tolist() and 0 in td.float_cols.tolist()
    sd = shard_design(td, cpu_mesh(2))
    for _, shard in sd.local_shards():
        assert torch.equal(shard.exact_cols, td.exact_cols)
        assert torch.equal(shard.float_cols, td.float_cols)
        assert torch.equal(shard.column_offset, td.column_offset)
    assert torch.equal(sd.cg_blockorder_ctx()[0], td.cg_blockorder_ctx()[0])
    _check_products(sd, jd, _inputs(td, 2, np.float32), False)


def test_sharded_cg_matches_jax_sharded_cg():
    """Same b, preconditioner, warm start and perturbation: the port's
    4-shard float64 CG solve and the JAX package's solve on its sharded
    design take as many iterations and agree within 1e-10."""
    check_cg_against_jax(4, cpu_mesh(4))


def check_cg_against_jax(grid, mesh, pred_axis=None):
    """The float64 CG solve of a 120-row hybrid design sharded on `mesh`
    against the JAX package's on its design sharded on the JAX mesh of
    `grid` (both with `pred_axis`)."""
    X = _data(120, seed=9)
    jd, td = _pair('hybrid', np.float64, X, True, True)
    jax_shard_design(jd, jax_make_mesh(grid), pred_axis=pred_axis)
    sd = shard_design(td, mesh, pred_axis=pred_axis)
    rng = np.random.default_rng(9)
    n, p = td.shape
    dense = td.toarray()
    obs_prec = rng.exponential(size=n) * .25 + .05
    pps = np.concatenate(([1e-3], 1 / rng.uniform(.05, 3., size=p - 1)))
    z = dense.T @ (rng.standard_normal(n) * obs_prec)
    a = dict(obs_prec=obs_prec, prior_prec_sqrt=pps, z=z,
             coef_cg_init=rng.standard_normal(p) * .1,
             precond_scale=1 / np.sqrt(pps ** 2 + (dense * dense).T
                                       @ obs_prec),
             perturbation=rng.standard_normal(p) * 2.)
    atol = 1e-9 * np.sqrt(p)
    coef_j, info_j = jax_cg(
        jax.random.key(0), jd, *(jnp.asarray(a[k]) for k in
                                 ('obs_prec', 'prior_prec_sqrt', 'z')),
        coef_cg_init=jnp.asarray(a['coef_cg_init']),
        precond_scale=jnp.asarray(a['precond_scale']), maxiter=500,
        atol=atol, perturbation=jnp.asarray(a['perturbation']))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    coef_t, info_t = sample_gaussian_cg(
        None, sd, t['obs_prec'], t['prior_prec_sqrt'], t['z'],
        coef_cg_init=t['coef_cg_init'], precond_scale=t['precond_scale'],
        maxiter=500, atol=atol, perturbation=t['perturbation'])
    assert info_t['n_cg_iter'] == int(info_j['n_cg_iter']) > 2
    _close(coef_t, coef_j, True)
    ref = np.asarray(coef_j)
    assert np.abs(coef_t.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


def _chain_model(case):
    """(model, sampler) in float64 over a 90-row design."""
    X = _data(90, seed=13)
    beta = np.zeros(X.shape[1])
    beta[:3] = 1.
    eta = X @ beta
    if case == 'cox':
        rng = np.random.default_rng(14)
        event = rng.exponential(np.exp(-eta))
        censor = rng.exponential(np.full(90, np.median(event)))
        event_time = np.where(event < censor, event, np.inf)
        censoring_time = np.where(event < censor, np.inf, censor)
        with pytest.warns(UserWarning, match='sorted'):
            model = RegressionModel((event_time, censoring_time), X,
                                    family='cox', dtype=np.float64,
                                    device='cpu')
        return model, 'hmc'
    y = (np.random.default_rng(15).uniform(size=90)
         < 1 / (1 + np.exp(-eta))).astype(float)
    return RegressionModel(y, X, family='logit', dtype=np.float64,
                           backend=case, device='cpu'), 'cg'


@pytest.mark.parametrize('case', ['hybrid', 'ell', 'cox'])
def test_sharded_chain_matches_unsharded(case):
    check_sharded_chain(case, cpu_mesh(3))


def check_sharded_chain(case, mesh, pred_axis=None):
    """The float64 chain of `case` sharded on `mesh` within 1e-9 of the
    unsharded chain over 5 iterations, and its exact resume."""
    model, sampler = _chain_model(case)
    sharded, _ = _chain_model(case)
    shard_model(sharded, mesh, pred_axis=pred_axis)
    kw = dict(seed=4, coef_sampler_type=sampler, params_to_save='all')
    ref, _ = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW)).gibbs(5,
                                                                       **kw)
    bridge = BayesBridge(sharded, RegressionCoefPrior(**PRIOR_KW))
    got, info = bridge.gibbs(5, **kw)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                   atol=1e-9 * np.abs(ref[key]).max())
    # Resume on the sharded model is exact.
    first, i_first = bridge.gibbs(3, **kw)
    more, _ = bridge.gibbs_resume(i_first, 2, merge=True,
                                  prev_samples=first)
    for key in got:
        np.testing.assert_array_equal(more[key], got[key])
    return sharded


def test_chains_on_mesh_equal_chains_alone():
    """Three chains over a 2-device mesh (groups of 2 and 1, each on its
    own thread): chain c equals the chain run alone from its start and
    generator, bit for bit; the resumed run equals the longer one."""
    check_chains_on_mesh(cpu_mesh(2))


def check_chains_on_mesh(mesh):
    """Three chains over `mesh`, a group a mesh row: each chain equal to
    the chain alone, the resumed run to the longer one, and the chains
    without a mesh to the same."""
    X = _data(120, seed=21)
    beta = np.zeros(X.shape[1])
    beta[:3] = 1.
    y = (np.random.default_rng(22).uniform(size=120)
         < 1 / (1 + np.exp(-(X @ beta)))).astype(float)
    bridge = BayesBridge(RegressionModel(y, X, family='logit', device='cpu'),
                         RegressionCoefPrior(**PRIOR_KW))
    inits = [{'coef': np.full(bridge.n_pred, .2 * c), 'global_scale': .1,
              'local_scale': np.ones(bridge.n_pred - 1)} for c in range(3)]
    kw = dict(seed=8, init=inits, coef_sampler_type='cg',
              params_to_save='all')
    samples, info = gibbs_chains(bridge, 4, 3, mesh=mesh, **kw)
    opts = bridge._resolve_options('cg', None)
    cfg = bridge._step_config(opts)
    bridge.rg.set_seed(8)
    starts = _stack_chain_inits(bridge, inits, 3)
    gens = bridge.rg.spawn(3)
    for c in range(3):
        coef, obs_prec, lscale, gscale = (s[c] for s in starts)
        carry = step_mod.init_carry('cpu', coef, obs_prec, gscale, lscale,
                                    dtype=bridge.dtype)
        _, out = step_mod.run_chain(cfg, bridge.model, gens[c], carry, 0, 4,
                                    1, 0, save_keys=('coef',))
        np.testing.assert_array_equal(
            samples['coef'][c], np.stack([v.numpy() for v in out['coef']],
                                         -1))
        np.testing.assert_array_equal(
            info['_reg_coef_sampling_info']['n_cg_iter'][c],
            out['n_cg_iter'])
    first, i_first = gibbs_chains(bridge, 2, 3, mesh=mesh, **kw)
    merged, _ = gibbs_chains_resume(bridge, i_first, 2, merge=True,
                                    prev_samples=first, mesh=mesh)
    for key in samples:
        np.testing.assert_array_equal(merged[key], samples[key])
    # Without a mesh, the same chains.
    plain, _ = gibbs_chains(bridge, 4, 3, **kw)
    for key in samples:
        np.testing.assert_array_equal(plain[key], samples[key])


@pytest.mark.parametrize('backend', ['hybrid', 'dense', 'ell'])
def test_shards_on_the_designs_device_are_row_views(backend):
    X = _data(64, seed=2)
    _, td = _pair(backend, np.float32, X, True, True)
    sd = shard_design(td, cpu_mesh(4))
    name = {'hybrid': 'X_exact', 'dense': 'X', 'ell': 'row_val'}[backend]
    whole = getattr(td, name)
    for i, shard in sd.local_shards():
        view = getattr(shard, name)
        assert view.untyped_storage().data_ptr() \
            == whole.untyped_storage().data_ptr()
        assert view.data_ptr() % 16 == 0
        assert torch.equal(view, whole[slice(*sd.bounds[i])])


def test_place_model_copies_to_the_device():
    model, _ = _chain_model('cox')
    placed = place_model(model, CPU)
    assert placed is not model and placed.design is not model.design
    assert torch.equal(placed.risk_set_start_index,
                       model.risk_set_start_index)
    v = torch.linspace(-1, 1, model.design.shape[1], dtype=torch.float64)
    assert torch.equal(placed.design.dot(v), model.design.dot(v))
    assert placed.design.dot_count == 1 and model.design.dot_count == 1
    shard_model(model, cpu_mesh(2))
    with pytest.raises(ValueError, match='un-shard'):
        place_model(model, CPU)


def test_launch_counts_from_threads_add_up():
    """The launch counters under contention: more threads than cores,
    switching often; a lost update would leave the count short."""
    counter = {'k': 0}

    def bump():
        for _ in range(5_000):
            build.count_launch(counter, 'k')

    n_threads = 2 * (os.cpu_count() or 1) + 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert counter['k'] == 5_000 * n_threads


def test_mesh_errors():
    with pytest.raises(ValueError, match='needs 6 devices, 4 given'):
        make_mesh((2, 3), devices=[CPU] * 4)
    model, _ = _chain_model('hybrid')
    with pytest.raises(ValueError, match="no predictor axis 'pred'"):
        shard_design(model.design, cpu_mesh(2), pred_axis='pred')
    winell = SparseDesignMatrix(_data(40, seed=1), backend='winell',
                                device='cpu')
    with pytest.warns(UserWarning, match='observation axis only'):
        shard_design(winell, make_mesh((2, 2), devices=[CPU] * 4),
                     pred_axis='pred')
    mesh = cpu_mesh(2)
    assert mesh.shape['shard'] == 2 and mesh.home == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            make_mesh()
    with pytest.raises(ValueError, match='do not fill'):
        shard_design(model.design, Mesh([CPU] * 89))
    shard_model(model, mesh)
    with pytest.raises(ValueError, match='sharded already'):
        shard_design(model.design, mesh)
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    with pytest.raises(ValueError, match='un-shard'):
        gibbs_chains(bridge, 2, 2, seed=0, mesh=mesh)
