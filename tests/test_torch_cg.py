"""The port's CG draw against the JAX package's on identical inputs.

``sample_gaussian_cg`` is deterministic given b, the preconditioner, the
warm start and the perturbation, so both packages get the same numpy
inputs: the JAX design with ``fused='1'`` (the Pallas CG operator in
interpret mode), the port's design on the CPU (the plain version of its
sweep). Both solve in float32 with the reference's stopping rule, so the
iteration counts must be equal and the draws agree to the solve's
tolerance: rtol 1e-4, atol 1e-4 * max|coef| (the two operators round
differently in each of a few dozen iterations).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
from bayesbridge_tpu.ops.cg import sample_gaussian_cg as jax_cg
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.ops.cg import sample_gaussian_cg

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


def _problem(seed, n=80, centered=True):
    rng = np.random.default_rng(seed)
    binary = (rng.uniform(size=(n, 12)) < .3).astype(np.float64)
    X = sps.csr_matrix(np.hstack([binary, rng.standard_normal((n, 5))]))
    jd = JaxDesign(X, center_predictor=centered, backend='hybrid',
                   dtype=np.float32, fused='1')
    td = SparseDesignMatrix(X, center_predictor=centered, device='cpu')
    n, p = td.shape
    f32 = np.float32
    obs_prec = (rng.exponential(size=n) * 0.25 + 0.05).astype(f32)
    prior_prec_sqrt = np.concatenate(
        ([1e-3], 1.0 / rng.uniform(0.05, 3.0, size=p - 1))).astype(f32)
    z = (td.toarray().T @ (rng.standard_normal(n) * obs_prec)).astype(f32)
    pert = rng.standard_normal(p).astype(f32) * 2.0
    coef_init = rng.standard_normal(p).astype(f32) * 0.1
    dense = td.toarray().astype(np.float64)
    fisher = (dense * dense).T @ obs_prec
    precond = (1.0 / np.sqrt(prior_prec_sqrt.astype(np.float64) ** 2
                             + fisher)).astype(f32)
    return jd, td, dict(obs_prec=obs_prec, prior_prec_sqrt=prior_prec_sqrt,
                        z=z, coef_cg_init=coef_init, precond_scale=precond,
                        perturbation=pert, atol=1e-5 * np.sqrt(p))


@pytest.mark.parametrize('seed,centered', [(1, True), (2, False)])
def test_cg_draw_matches_jax(monkeypatch, seed, centered):
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    jd, td, a = _problem(seed, centered=centered)
    coef_j, info_j = jax_cg(
        jax.random.key(0), jd, jnp.asarray(a['obs_prec']),
        jnp.asarray(a['prior_prec_sqrt']), jnp.asarray(a['z']),
        coef_cg_init=jnp.asarray(a['coef_cg_init']),
        precond_scale=jnp.asarray(a['precond_scale']), maxiter=500,
        atol=a['atol'], perturbation=jnp.asarray(a['perturbation']))
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != 'atol'}
    coef_t, info_t = sample_gaussian_cg(
        None, td, t['obs_prec'], t['prior_prec_sqrt'], t['z'],
        coef_cg_init=t['coef_cg_init'], precond_scale=t['precond_scale'],
        maxiter=500, atol=a['atol'], perturbation=t['perturbation'])
    assert info_t['n_cg_iter'] == int(info_j['n_cg_iter']) > 2
    assert info_t['cg_converged'] and bool(info_j['cg_converged'])
    ref = np.asarray(coef_j, np.float64)
    np.testing.assert_allclose(coef_t.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_cg_maxiter_caps_iterations(monkeypatch):
    """With maxiter below convergence both stop at maxiter unconverged."""
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    _, td, a = _problem(3)
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != 'atol'}
    _, info = sample_gaussian_cg(
        None, td, t['obs_prec'], t['prior_prec_sqrt'], t['z'],
        coef_cg_init=t['coef_cg_init'], precond_scale=t['precond_scale'],
        maxiter=2, atol=a['atol'], perturbation=t['perturbation'])
    assert info == {'n_cg_iter': 2, 'cg_converged': False}
