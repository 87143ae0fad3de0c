"""The port's Cholesky sampler and prior preconditioner against the JAX
package's.

* The Cholesky draw is a deterministic function of the design's Fisher
  information, the prior precision, z and the standard-normal noise: fed
  the JAX draw's own noise (``jax.random.normal`` of its key), the port's
  draw equals the JAX draw, float64, rtol 1e-10, on a dense and a sparse
  design. Its mean part solves Sigma z and its linear map of the noise
  has covariance Sigma (closed form, as tests/test_gaussian_samplers.py
  checks the JAX sampler), rtol 1e-8. A precision that is not positive
  definite gives NaNs, as ``jnp.linalg.cholesky`` does, and no error.
* The prior preconditioner and the summarizer's sd estimate it runs on
  equal the JAX functions' (rtol 1e-12 in float64); a CG solve with it
  from the same b, perturbation and warm start takes the same number of
  iterations and agrees to the solve's tolerance (float32, rtol 1e-4 and
  atol 1e-4 * max|coef|, as tests/test_torch_cg.py; float64, 1e-6: the
  iterations carry each operator's rounding forward, so two float64
  solves of this problem differ by up to 3e-8 where each stops 1.2e-6
  from the exact solution).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import DenseDesignMatrix as JaxDense
from bayesbridge_tpu.design import SparseDesignMatrix as JaxSparse
from bayesbridge_tpu.ops import cg as jax_cg_mod
from bayesbridge_tpu.ops import summarizer as jax_summ
from bayesbridge_tpu.ops.cholesky import (
    sample_gaussian_cholesky as jax_cholesky,
)
from bayesbridge_tpu_torch.design import DenseDesignMatrix, SparseDesignMatrix
from bayesbridge_tpu_torch.ops import summarizer as summ_mod
from bayesbridge_tpu_torch.ops.cg import (
    choose_preconditioner, sample_gaussian_cg,
)
from bayesbridge_tpu_torch.ops.cholesky import (
    cholesky_draw, sample_gaussian_cholesky,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _designs(sparse, seed=0, n=40, p=15):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    if sparse:
        X[:, :8] = rng.uniform(size=(n, 8)) < .3
        X = sps.csr_matrix(X)
        return rng, JaxSparse(X, center_predictor=True, backend='hybrid'), \
            SparseDesignMatrix(X, center_predictor=True, dtype=np.float64,
                               device='cpu')
    return rng, JaxDense(X, center_predictor=True), \
        DenseDesignMatrix(X, center_predictor=True, dtype=np.float64,
                          device='cpu')


def _inputs(rng, design):
    n, p = design.shape
    return (rng.exponential(size=n) + .1, rng.exponential(size=p) + .5,
            rng.standard_normal(p))


@pytest.mark.parametrize('sparse', [False, True])
def test_cholesky_draw_matches_jax_given_its_noise(sparse):
    rng, jd, td = _designs(sparse)
    w, pps, z = _inputs(rng, td)
    key = jax.random.key(42)
    ref = np.asarray(jax_cholesky(key, jd, jnp.asarray(w), jnp.asarray(pps),
                                  jnp.asarray(z)))
    noise = np.array(jax.random.normal(key, z.shape, jnp.float64))
    t = {k: torch.from_numpy(v) for k, v in
         dict(w=w, pps=pps, z=z, noise=noise).items()}
    got = cholesky_draw(td.compute_fisher_info(t['w']),
                        td.compute_fisher_info(t['w'], diag_only=True),
                        t['pps'], t['z'], t['noise'])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())
    # The sampler itself draws its noise from the generator.
    draw = sample_gaussian_cholesky(torch.Generator().manual_seed(0), td,
                                    t['w'], t['pps'], t['z'])
    assert draw.dtype == torch.float64 and torch.isfinite(draw).all()


def test_cholesky_draw_closed_form():
    """Mean Sigma z and covariance Sigma, Sigma^-1 = X'WX + diag(pps^2)."""
    rng, _, td = _designs(False, seed=3)
    w, pps, z = _inputs(rng, td)
    X = td.toarray()
    Sigma = np.linalg.inv(X.T @ (w[:, None] * X) + np.diag(pps ** 2))
    t = {k: torch.from_numpy(v) for k, v in dict(w=w, pps=pps, z=z).items()}
    fisher = td.compute_fisher_info(t['w'])
    diag = td.compute_fisher_info(t['w'], diag_only=True)
    p = len(z)
    mean = cholesky_draw(fisher, diag, t['pps'], t['z'],
                         torch.zeros(p, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(mean, Sigma @ z, rtol=1e-8)
    M = np.stack([cholesky_draw(fisher, diag, t['pps'], torch.zeros_like(
        t['z']), torch.eye(p, dtype=torch.float64)[j]).numpy()
        for j in range(p)], axis=1)
    np.testing.assert_allclose(M @ M.T, Sigma, rtol=1e-8,
                               atol=1e-12 * np.abs(Sigma).max())


def test_cholesky_failure_gives_nan():
    """An indefinite precision: a NaN draw, no error (no host sync)."""
    p = 4
    fisher = -5.0 * torch.eye(p, dtype=torch.float64)
    draw = cholesky_draw(fisher, torch.diagonal(fisher).abs(),
                         torch.ones(p, dtype=torch.float64),
                         torch.ones(p, dtype=torch.float64),
                         torch.ones(p, dtype=torch.float64))
    assert torch.isnan(draw).all()


def _summarizer_state(rng, p, n_avg):
    state = jax_summ.summarizer_init(p, jnp.float64)
    gscale, lscale = 0.7, rng.exponential(size=p - 2) + .2
    for _ in range(n_avg):
        state = jax_summ.summarizer_update(
            state, jnp.asarray(rng.standard_normal(p)), gscale,
            jnp.asarray(lscale), 2, 1.5)
    return {k: np.array(v) for k, v in state.items()}


@pytest.mark.parametrize('n_avg', [0, 1, 7])
@pytest.mark.parametrize('n_unshrunk', [0, 2])
def test_prior_preconditioner_matches_jax(n_avg, n_unshrunk):
    rng = np.random.default_rng(n_avg + 10 * n_unshrunk)
    p = 9
    state = _summarizer_state(rng, p, n_avg)
    sd_ref = np.asarray(jax_summ.estimate_coef_precond_scale_sd(
        {k: jnp.asarray(v) for k, v in state.items()}))
    sd = summ_mod.estimate_coef_precond_scale_sd(
        {k: torch.from_numpy(v) for k, v in state.items()})
    np.testing.assert_allclose(sd.numpy(), sd_ref, rtol=1e-12)
    pps = rng.exponential(size=p) + .5
    ref = np.asarray(jax_cg_mod.choose_preconditioner(
        jnp.asarray(pps), n_unshrunk, jnp.asarray(sd_ref)))
    got = choose_preconditioner(torch.from_numpy(pps), n_unshrunk, sd)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_cg_with_prior_preconditioner_matches_jax(monkeypatch, dtype):
    """Same b, perturbation and warm start, the prior preconditioner
    from one summarizer state: equal n_cg_iter, draws within the
    solve's tolerance."""
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    # Shrunk coordinates' prior sd in (0.02, 0.5): the solve stops by
    # its tolerance in 18 of 51 dimensions, the last two residuals 36
    # and 0.11 times the threshold (a solve that ran to the Krylov
    # space's end would count rounding).
    rng = np.random.default_rng(6)
    n = 200
    binary = (rng.uniform(size=(n, 40)) < .3).astype(np.float64)
    X = sps.csr_matrix(np.hstack([binary, rng.standard_normal((n, 10))]))
    jd = JaxSparse(X, center_predictor=True, backend='hybrid', dtype=dtype,
                   fused='0')
    td = SparseDesignMatrix(X, center_predictor=True, dtype=dtype,
                            device='cpu')
    n, p = td.shape
    state = _summarizer_state(rng, p, 6)
    sd = np.asarray(jax_summ.estimate_coef_precond_scale_sd(
        {k: jnp.asarray(v) for k, v in state.items()}))
    a = dict(obs_prec=rng.exponential(size=n) * 0.25 + 0.05,
             prior_prec_sqrt=np.concatenate(
                 ([1e-3], 1.0 / rng.uniform(0.02, 0.5, size=p - 1))),
             z=td.toarray().T @ rng.standard_normal(n),
             perturbation=rng.standard_normal(p) * 2.0,
             coef_cg_init=rng.standard_normal(p) * 0.1)
    a = {k: v.astype(dtype) for k, v in a.items()}
    precond_j = jax_cg_mod.choose_preconditioner(
        jnp.asarray(a['prior_prec_sqrt']), 1, jnp.asarray(sd, dtype))
    coef_j, info_j = jax_cg_mod.sample_gaussian_cg(
        jax.random.key(0), jd, *(jnp.asarray(a[k]) for k in (
            'obs_prec', 'prior_prec_sqrt', 'z')),
        coef_cg_init=jnp.asarray(a['coef_cg_init']),
        precond_scale=precond_j, maxiter=500, atol=1e-5 * np.sqrt(p),
        perturbation=jnp.asarray(a['perturbation']))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    precond_t = choose_preconditioner(t['prior_prec_sqrt'], 1,
                                      torch.from_numpy(sd.astype(dtype)))
    coef_t, info_t = sample_gaussian_cg(
        None, td, t['obs_prec'], t['prior_prec_sqrt'], t['z'],
        coef_cg_init=t['coef_cg_init'], precond_scale=precond_t,
        maxiter=500, atol=1e-5 * np.sqrt(p), perturbation=t['perturbation'])
    assert info_t['n_cg_iter'] == int(info_j['n_cg_iter']) > 2
    assert info_t['cg_converged'] and bool(info_j['cg_converged'])
    ref = np.asarray(coef_j, np.float64)
    tol = 1e-4 if dtype == np.float32 else 1e-6
    np.testing.assert_allclose(coef_t.numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())
