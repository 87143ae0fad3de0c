"""The CG loop's one body, driven on the CPU, against the JAX package's
``lax.while_loop`` on the same inputs.

The port runs one CG iteration as one function of a static-shaped state
(the design's operator for all k chains, then ``cg_update``), driven on
the CPU by ``while running.any()`` (``ops.cg.host_solve``); the card runs
the same body inside a CUDA graph (tests/test_torch_cuda.py). Here, for
every backend the device loop serves (the hybrid design composed and
block-ordered, the hybrid fused policy, the dense design, bitpack,
winell, ell in float32 and float64), k chains from numpy seeds go
through ``sample_gaussian_cg_chains`` and through the JAX package's
``sample_gaussian_cg`` under ``jax.vmap``, with and without the warm start
(``warm_tdot`` / ``lin_pred0``) and the linear predictor:

* equal ``n_cg_iter`` (the chains take different counts; the last chain's
  residual starts at 0 and takes none) and equal ``cg_converged``; coef
  and the linear predictor within rtol 1e-4 of max|JAX| in float32 (the
  two operators round differently in each of a few dozen iterations, as
  tests/test_torch_cg.py states), 1e-9 in float64;
* ``maxiter`` stops both alike, unconverged;
* a float64 chain over a float32 design keeps the float32 floor of z's
  type, as the JAX loop does;
* each chain of the batch equals the chain alone bit for bit;
* ``cg_update_plain`` equals the JAX body's formulas (ops/cg.py:177-189)
  on random states (1e-12, float64) and leaves the rows whose flag is
  clear unchanged bit for bit; ``cg_start_plain`` the JAX loop's set-up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import DenseDesignMatrix as JaxDense
from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.ops.cg import sample_gaussian_cg as jax_cg
from bayesbridge_tpu_torch.design import DenseDesignMatrix, SparseDesignMatrix
from bayesbridge_tpu_torch.kernels.cg_loop import (
    CgState, cg_start_plain, cg_update, cg_update_plain,
)
from bayesbridge_tpu_torch.ops import cg as cg_mod
from bayesbridge_tpu_torch.ops.cg import sample_gaussian_cg_chains

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

CASES = ('hybrid', 'hybrid_fused', 'dense', 'bitpack', 'winell', 'ell32',
         'ell64')
K = 3


def _data(seed, n=90):
    """0/1 columns at 30% beside standard-normal ones at 70% density."""
    rng = np.random.default_rng(seed)
    binary = (rng.random((n, 14)) < .3).astype(np.float64)
    normal = rng.standard_normal((n, 6)) * (rng.random((n, 6)) < .7)
    return sps.csr_matrix(np.hstack((binary, normal)))


def _pair(case, monkeypatch):
    """(JAX design, port design on the CPU) of one X."""
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    X = _data(1 + CASES.index(case))
    dtype = np.float64 if case == 'ell64' else np.float32
    if case == 'dense':
        kw = dict(center_predictor=True, dtype=dtype)
        return (JaxDense(X.toarray(), **kw),
                DenseDesignMatrix(X.toarray(), device='cpu', **kw))
    backend = {'ell32': 'ell', 'ell64': 'ell'}.get(case, case)
    fused = None
    if case.startswith('hybrid'):
        backend, fused = 'hybrid', '1' if case == 'hybrid_fused' else '0'
    kw = dict(center_predictor=True, backend=backend, dtype=dtype,
              fused=fused)
    if fused is None:
        kw.pop('fused')
    return JaxDesign(X, **kw), SparseDesignMatrix(X, device='cpu', **kw)


def _inputs(td, seed, warm, lin):
    """The chains' numpy inputs: weights, prior scales, right-hand sides,
    starts and the Jacobi preconditioner, in the design's dtype; chain 1's
    prior precision is larger (fewer iterations), the last chain's
    right-hand side and start are 0 (its residual starts at 0)."""
    n, p = td.shape
    dtype = np.float64 if td.dtype == torch.float64 else np.float32
    rng = np.random.default_rng(seed)
    A = td.toarray().astype(np.float64)
    w = rng.exponential(size=(K, n)) * .25 + .05
    pps = rng.uniform(.05, 3., size=(K, p))
    pps[1] *= 6.
    pps[:, 0] = 1e-3
    z = (rng.standard_normal((K, n)) * w) @ A
    pert = rng.standard_normal((K, p)) * 2.
    coef = rng.standard_normal((K, p)) * .1
    for v in (z, pert, coef):
        v[-1] = 0.
    s = 1. / np.sqrt(pps ** 2 + (w @ (A * A)))
    out = dict(obs_prec=w, prior_prec_sqrt=pps, z=z, coef_cg_init=coef,
               precond_scale=s, perturbation=pert)
    if warm:
        lin0 = coef @ A.T
        out['warm_tdot'] = (w * lin0) @ A
        if lin:
            out['lin_pred0'] = lin0
    return {key: v.astype(dtype) for key, v in out.items()}


def _jax_chains(jd, a, maxiter, atol, lin):
    """sample_gaussian_cg of the JAX package under jax.vmap over the
    chains."""
    names = sorted(a)

    def one(*vals):
        kw = dict(zip(names, vals))
        return jax_cg(jax.random.key(0), jd, kw.pop('obs_prec'),
                      kw.pop('prior_prec_sqrt'), kw.pop('z'),
                      maxiter=maxiter, atol=atol, return_lin_pred=lin, **kw)

    res = jax.vmap(one)(*(jnp.asarray(a[key]) for key in names))
    return tuple(np.asarray(r) if not isinstance(r, dict) else
                 {key: np.asarray(v) for key, v in r.items()} for r in res)


def _port_chains(td, a, maxiter, atol, lin):
    t = {key: torch.from_numpy(v) for key, v in a.items()}
    res = sample_gaussian_cg_chains(
        None, td, t.pop('obs_prec'), t.pop('prior_prec_sqrt'), t.pop('z'),
        maxiter=maxiter, atol=atol, return_lin_pred=lin, **t)
    return tuple(r.numpy() if torch.is_tensor(r) else r for r in res)


def _close(got, ref, dtype):
    tol = 1e-9 if dtype == np.float64 else 1e-4
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize('warm,lin', [(False, False), (False, True),
                                      (True, False), (True, True)])
@pytest.mark.parametrize('case', CASES)
def test_chains_match_jax_while_loop(monkeypatch, case, warm, lin):
    jd, td = _pair(case, monkeypatch)
    a = _inputs(td, 7 + CASES.index(case), warm, lin)
    dtype = a['z'].dtype
    atol = 1e-5 * np.sqrt(td.shape[1])
    ref = _jax_chains(jd, a, 500, atol, lin)
    got = _port_chains(td, a, 500, atol, lin)
    n_iter = got[-1]['n_cg_iter']
    np.testing.assert_array_equal(n_iter, ref[-1]['n_cg_iter'])
    np.testing.assert_array_equal(got[-1]['cg_converged'],
                                  ref[-1]['cg_converged'])
    assert n_iter[-1] == 0 and (n_iter[:-1] > 2).all(), n_iter
    assert n_iter[0] != n_iter[1], n_iter
    assert got[-1]['cg_converged'].all()
    assert len(got) == 3 if lin else len(got) == 2
    for g, r in zip(got[:-1], ref[:-1]):
        _close(g, r, dtype)
    # Each chain of the batch equals the chain alone, bit for bit.
    for c in range(K):
        one = {key: v[c:c + 1] for key, v in a.items()}
        alone = _port_chains(td, one, 500, atol, lin)
        assert alone[-1]['n_cg_iter'][0] == n_iter[c]
        for g, s in zip(got[:-1], alone[:-1]):
            np.testing.assert_array_equal(s[0], g[c])


@pytest.mark.parametrize('case', ['hybrid', 'ell64'])
def test_maxiter_stops_both_loops(monkeypatch, case):
    jd, td = _pair(case, monkeypatch)
    a = _inputs(td, 3, True, True)
    atol = 1e-5 * np.sqrt(td.shape[1])
    ref = _jax_chains(jd, a, 3, atol, True)
    got = _port_chains(td, a, 3, atol, True)
    np.testing.assert_array_equal(got[-1]['n_cg_iter'], [3, 3, 0])
    np.testing.assert_array_equal(ref[-1]['n_cg_iter'], [3, 3, 0])
    np.testing.assert_array_equal(got[-1]['cg_converged'],
                                  [False, False, True])
    np.testing.assert_array_equal(ref[-1]['cg_converged'],
                                  got[-1]['cg_converged'])
    for g, r in zip(got[:-1], ref[:-1]):
        _close(g, r, a['z'].dtype)


def _random_state(seed, k=4, m=37, n=23, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=dtype)

    st = CgState(k, m, n, dtype, 'cpu', maxiter=50)
    for name in ('x', 'r', 'p', 'b', 'y'):
        getattr(st, name).copy_(rnd(*getattr(st, name).shape))
    st.s.copy_(rnd(k, m).abs() + .1)
    st.d.copy_(rnd(k, m).abs() + .1)
    st.sp.copy_(st.s * st.p)
    st.rs.copy_((st.r * st.r).sum(1))
    st.thresh.fill_(1e-6)
    st.n_iter.copy_(torch.arange(k, dtype=torch.int32))
    st.running.fill_(1)
    return st, rnd(k, m), rnd(k, n)


def test_update_plain_equals_jax_body():
    """One step of cg_update_plain against the JAX body (ops/cg.py:
    177-189) on the same float64 states, chain by chain, and the chains
    whose flag is clear left as they were, bit for bit."""
    st, out, t = _random_state(5)
    st.running[2] = 0
    before = {name: getattr(st, name).clone() for name in
              ('x', 'r', 'p', 'sp', 'y', 'rs', 'n_iter', 'running')}
    cg_update_plain(st, out, t)
    for c in range(st.k):
        if c == 2:
            for name, v in before.items():
                assert torch.equal(getattr(st, name)[c], v[c]), name
            continue
        s, d, p = (jnp.asarray(v[c].numpy()) for v in (st.s, st.d,
                                                        before['p']))
        x, r, y = (jnp.asarray(before[name][c].numpy())
                   for name in ('x', 'r', 'y'))
        rs = jnp.asarray(before['rs'][c].numpy())
        Ap = d * p + s * jnp.asarray(out[c].numpy())
        alpha = rs / jnp.vdot(p, Ap)
        x = x + alpha * p
        y = y + alpha * jnp.asarray(t[c].numpy())
        r = r - alpha * Ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        for name, ref in (('x', x), ('r', r), ('p', p), ('y', y),
                          ('sp', s * p)):
            np.testing.assert_allclose(getattr(st, name)[c].numpy(),
                                       np.asarray(ref), rtol=1e-12,
                                       atol=1e-12 * float(jnp.abs(ref).max()))
        np.testing.assert_allclose(float(st.rs[c]), float(rs_new),
                                   rtol=1e-12)
        assert int(st.n_iter[c]) == int(before['n_iter'][c]) + 1
        assert bool(st.running[c]) == (float(rs_new) > 1e-6)


def test_update_dispatches_on_the_tensors_device():
    """cg_update on CPU tensors runs the plain version (same bits), and
    takes only the state's type and shape."""
    st, out, t = _random_state(6)
    twin, _, _ = _random_state(6)
    cg_update(st, out, t)
    cg_update_plain(twin, out, t)
    for name in ('x', 'r', 'p', 'sp', 'y', 'rs', 'n_iter', 'running'):
        assert torch.equal(getattr(st, name), getattr(twin, name)), name
    with pytest.raises(ValueError):
        cg_update(st, out[:, :-1], t)
    with pytest.raises(ValueError):
        cg_update(st, out, None)


def test_start_plain_equals_jax_setup():
    """cg_start_plain: p = r, sp = s r, rs = r . r, the threshold
    max(atol, 50 eps |b|)^2 (ops/cg.py:166-174) in float32, n_iter 0, and
    running where rs > thresh and maxiter > 0 (not chain 1, whose
    residual is 0, nor chain 3, whose floor lies above its residual)."""
    st, _, _ = _random_state(7, dtype=torch.float32)
    st.r[1] = 0
    st.atol.fill_(1e-3)
    st.b[3] *= 1e6  # the float32 floor lifts this chain's threshold
    cg_start_plain(st)
    for c in range(st.k):
        b = jnp.asarray(st.b[c].numpy())
        r = jnp.asarray(st.r[c].numpy())
        tol = jnp.maximum(jnp.asarray(1e-3, jnp.float32),
                          50.0 * jnp.finfo(jnp.float32).eps
                          * jnp.linalg.norm(b))
        np.testing.assert_allclose(float(st.thresh[c]), float(tol ** 2),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(st.rs[c]), float(jnp.vdot(r, r)),
                                   rtol=1e-5)
    assert float(st.thresh[3]) > float(st.rs[3]) > 1.0
    assert torch.equal(st.p, st.r) and torch.equal(st.sp, st.s * st.r)
    assert st.n_iter.tolist() == [0] * 4
    assert st.running.tolist() == [1, 0, 1, 0]
    st.maxiter = 0
    cg_start_plain(st)
    assert st.running.tolist() == [0] * 4


@pytest.mark.parametrize('case', ['hybrid', 'dense'])
def test_float32_floor_in_a_float64_chain(monkeypatch, case):
    """A float64 chain over a float32-stored design (z comes from the
    design's products in float32, the rest is float64): the loop computes
    in float64, and the tolerance's floor takes float32's eps from z, as
    the JAX loop does (ops/cg.py:98, 169-171), so n_cg_iter equals it.
    With z in float64 the floor drops and the chains run on."""
    jd, td = _pair(case, monkeypatch)
    a = {key: v.astype(np.float64)
         for key, v in _inputs(td, 17, False, False).items()}
    a['z'] = a['z'].astype(np.float32)
    atol = 1e-12
    ref = _jax_chains(jd, a, 500, atol, False)
    got = _port_chains(td, a, 500, atol, False)
    assert got[0].dtype == np.float64
    np.testing.assert_array_equal(got[-1]['n_cg_iter'],
                                  ref[-1]['n_cg_iter'])
    np.testing.assert_array_equal(got[-1]['cg_converged'],
                                  ref[-1]['cg_converged'])
    _close(got[0], ref[0], np.float32)
    wide = _port_chains(td, dict(a, z=a['z'].astype(np.float64)), 500,
                        atol, False)
    assert (wide[-1]['n_cg_iter'][:-1] > got[-1]['n_cg_iter'][:-1]).all()


def test_iteration_counter_counts_runs_of_the_body():
    """st.iters: cg_start_plain zeroes it, each cg_update_plain adds one
    (frozen chains or not), and a solve whose count disagrees with
    max(n_iter) raises at its end."""
    st, out, t = _random_state(8)
    st.iters.fill_(5)
    cg_start_plain(st)
    assert int(st.iters) == 0
    st.running[1] = 0
    for _ in range(3):
        cg_update_plain(st, out, t)
    assert int(st.iters) == 3
    st.n_iter.fill_(2)
    with pytest.raises(RuntimeError, match='ran 3 times'):
        cg_mod._finish(st, None)
    st.n_iter[0] = 3
    assert cg_mod._finish(st, None)[3] == 3


def test_a_copy_of_the_design_keeps_its_own_graphs():
    """The device loop's graphs are kept on the design that owns them: a
    shallow copy (with_policy, copy.copy) shares the design's attributes
    but starts with no graph, and the original keeps its own."""
    import copy
    td = SparseDesignMatrix(_data(4), device='cpu', backend='hybrid',
                            fused='0')
    mine = cg_mod._loops_of(td)
    mine['key'] = 'graph'
    assert cg_mod._loops_of(td) is mine
    for other in (copy.copy(td), td.with_policy('1')):
        theirs = cg_mod._loops_of(other)
        assert theirs == {} and theirs is not mine
        assert cg_mod._loops_of(other) is theirs
    assert cg_mod._loops_of(td) == {'key': 'graph'}


def test_cpu_takes_the_host_loop():
    """The device loop serves CUDA devices only; the CPU and a mesh over
    several devices keep the host loop."""
    from bayesbridge_tpu_torch.parallel import make_mesh, shard_design
    td = SparseDesignMatrix(_data(3), device='cpu')
    assert not cg_mod.takes_device_loop(td, 'cpu')
    sd = shard_design(td, make_mesh(devices=[torch.device('cpu')] * 2))
    assert not cg_mod.takes_device_loop(sd, 'cpu')


def test_recording_keeps_launch_counts_aside():
    """Inside `recording` (a graph's warm-up and captures) a wrapper's
    launch count goes to the record, not to its counter; a solve replays
    the record times the iterations the card ran."""
    from bayesbridge_tpu_torch.kernels.build import count_launch, recording
    counter = {'a': 0}
    with recording() as rec:
        count_launch(counter, 'a')
        with recording() as inner:
            count_launch(counter, 'a', 3)
        count_launch(counter, 'a', 2)
    assert counter == {'a': 0}
    assert rec == [(counter, 'a', 1), (counter, 'a', 2)]
    assert inner == [(counter, 'a', 3)]
    count_launch(counter, 'a')
    assert counter == {'a': 1}
