"""The port's chain-batched sampler (``bayesbridge_tpu_torch.multichain``)
on the CPU.

* chain c of ``gibbs_chains(k=3)`` is the one-chain run (``step.
  run_chain``) from the same start with chain c's generator: coef within
  rtol 1e-6 / atol 1e-7 (the JAX package's tolerance,
  tests/test_multichain.py) and the same CG iteration counts, on every
  design and policy the port serves (float32 chains match bit for bit
  here; the float64 dense design's k-column products round differently
  from one column's);
* a resumed and merged run equals the uninterrupted one exactly;
* a shared (partial) init resolves once and starts every chain there,
  per-chain inits give different chains, a wrong count raises, and so
  do ``mesh`` and the unported samplers;
* the batched CG solve against ``jax.vmap`` of the JAX
  ``sample_gaussian_cg`` on the same inputs: per-chain iteration counts
  equal, coef within tests/test_torch_cg.py's tolerance;
* the pooled posterior means of the port's chains against the JAX
  package's ``gibbs_chains`` on the same data (different generators, so
  statistically: |z| < Z_MAX with ESS-aware standard errors, as in
  tests/test_torch_gibbs.py);
* ``convert.chain_carry_from_numpy`` of a JAX ``_chain_carry``: every
  chain's warm start equals the JAX package's, and a batched step runs
  from it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sps
import torch

from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel, convert,
    gibbs_chains,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.design import SparseDesignMatrix
from bayesbridge_tpu_torch.multichain import (
    _stack_chain_inits, gibbs_chains_resume,
)
from bayesbridge_tpu_torch.ops.cg import sample_gaussian_cg_chains
from bayesbridge_tpu_torch.ops.summarizer import extrapolate_coef_condmean
from bayesbridge_tpu_torch.utils.mcmc_summarizer import (
    compute_effective_sample_size, compute_multichain_ess,
    compute_split_rhat,
)
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

Z_MAX = 4.5
PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


def _sparse_data(family, n=240, p=24, seed=1):
    X = simulate_design(n, p, binary_frac=.75, seed=seed)
    beta = np.zeros(p)
    beta[:3] = 1.0
    if family == 'linear':
        y = X @ beta + np.random.default_rng(seed + 1).standard_normal(n)
    else:
        y = simulate_outcome(X, beta, 'logit', seed=seed + 1)
    return X, y


def _dense_data(family, n=200, p=12, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    eta = X[:, :3].sum(1)
    y = eta + rng.standard_normal(n) if family == 'linear' \
        else (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(float)
    return X, y


# name: (family, data, model kwargs, sampler, options)
CASES = {
    'hybrid_auto': ('logit', 'sparse', dict(fused='auto'), 'cg', None),
    'hybrid_fused': ('logit', 'sparse', dict(fused='1'), 'cg', None),
    'dense_cholesky': ('logit', 'dense', {}, 'cholesky', None),
    'linear_cg_prior': ('linear', 'sparse', {}, 'cg',
                        {'cg_preconditioner': 'prior'}),
    'bitpack': ('logit', 'sparse', dict(backend='bitpack'), 'cg', None),
    'winell': ('logit', 'sparse', dict(backend='winell'), 'cg', None),
    'dense_float64_linear': ('linear', 'dense', dict(dtype=np.float64),
                             'cholesky', None),
}


def _bridge(case):
    family, data, kw, _, _ = CASES[case]
    X, y = (_sparse_data if data == 'sparse' else _dense_data)(family)
    model = RegressionModel(y, X, family=family, device='cpu', **kw)
    return BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))


def _zero_init(bridge):
    return {'coef': np.zeros(bridge.n_pred), 'global_scale': 0.1,
            'local_scale': np.ones(bridge.n_pred - bridge.n_unshrunk)}


@pytest.mark.parametrize('case', list(CASES))
def test_chain_equals_single_chain(case):
    _, _, _, sampler, options = CASES[case]
    bridge = _bridge(case)
    k, n_iter, seed = 3, 4, 11
    init = _zero_init(bridge)
    samples, info = gibbs_chains(
        bridge, n_iter, k, seed=seed, init=dict(init),
        coef_sampler_type=sampler, options=options,
        params_to_save=('coef', 'logp'))
    assert samples['coef'].shape == (k, bridge.n_pred, n_iter)
    assert samples['logp'].shape == (k, n_iter)
    # Each chain again through the one-chain runner: the same start and
    # the generator gibbs_chains gave that chain.
    opts = bridge._resolve_options(sampler, options)
    cfg = bridge._step_config(opts)
    bridge.rg.set_seed(seed)
    starts = _stack_chain_inits(bridge, dict(init), k)
    gens = bridge.rg.spawn(k)
    for c in range(k):
        coef, obs_prec, lscale, gscale = (s[c] for s in starts)
        carry = step_mod.init_carry('cpu', coef, obs_prec, gscale, lscale,
                                    dtype=bridge.dtype)
        _, out = step_mod.run_chain(cfg, bridge.model, gens[c], carry, 0,
                                    n_iter, 1, 0, save_keys=('coef',))
        alone = np.stack([v.numpy() for v in out['coef']], -1)
        np.testing.assert_allclose(samples['coef'][c], alone, rtol=1e-6,
                                   atol=1e-7)
        if sampler == 'cg':
            np.testing.assert_array_equal(
                info['_reg_coef_sampling_info']['n_cg_iter'][c],
                out['n_cg_iter'])
    # The chains differ (their generators do).
    assert not np.allclose(samples['coef'][0], samples['coef'][1])


@pytest.mark.parametrize('thin', [1, 2])
def test_resume_equals_uninterrupted(thin):
    bridge = _bridge('hybrid_auto')
    init = _zero_init(bridge)
    kw = dict(seed=7, init=dict(init), coef_sampler_type='cg', thin=thin,
              params_to_save='all')
    full, f_info = gibbs_chains(bridge, 8, 2, **kw)
    first, info = gibbs_chains(bridge, 4, 2, **kw)
    merged, m_info = gibbs_chains_resume(bridge, info, 4, merge=True,
                                         prev_samples=first)
    assert set(merged) == set(full)
    for key in full:
        np.testing.assert_array_equal(merged[key], full[key])
    np.testing.assert_array_equal(
        m_info['_reg_coef_sampling_info']['n_cg_iter'],
        f_info['_reg_coef_sampling_info']['n_cg_iter'])
    assert m_info['n_iter'] == 8


def test_inits_shared_per_chain_and_counted():
    bridge = _bridge('hybrid_auto')
    bridge.rg.set_seed(42)
    # A partial dict: one MAP search and one set of draws, every chain
    # starting there.
    stacked = _stack_chain_inits(bridge, {'global_scale': 0.1}, 3)
    for arr in stacked:
        for c in (1, 2):
            np.testing.assert_array_equal(arr[c], arr[0])
    inits = [{'coef': np.full(bridge.n_pred, c * 0.5), 'global_scale': 0.1,
              'local_scale': np.ones(bridge.n_pred - 1)} for c in range(3)]
    samples, _ = gibbs_chains(bridge, 2, 3, seed=3, init=inits,
                              coef_sampler_type='cg',
                              params_to_save=('coef',))
    assert not np.allclose(samples['coef'][0, :, 0],
                           samples['coef'][1, :, 0])
    with pytest.raises(ValueError, match='init dicts'):
        gibbs_chains(bridge, 2, 2, seed=0, init=inits,
                     coef_sampler_type='cg')


def test_unported_options_raise():
    """mesh= still raises (ROADMAP item 15); 'hmc', refused before, runs
    (tests/test_torch_cox_gibbs.py holds its chains to the chain
    alone)."""
    bridge = _bridge('hybrid_auto')
    with pytest.raises(NotImplementedError, match='item 15'):
        gibbs_chains(bridge, 2, 2, seed=0, mesh=object())
    samples, info = gibbs_chains(bridge, 2, 2, seed=0,
                                 coef_sampler_type='hmc')
    assert samples['coef'].shape == (2, bridge.n_pred, 2)
    assert info['_reg_coef_sampling_info']['n_grad_evals'].shape == (2, 2)


def _cg_problem(seed, n=80):
    """tests/test_torch_cg.py's problem: a centered 12 binary + 5 normal
    column design, per-chain inputs from `seed`."""
    rng = np.random.default_rng(seed)
    binary = (rng.uniform(size=(n, 12)) < .3).astype(np.float64)
    return sps.csr_matrix(np.hstack([binary,
                                     rng.standard_normal((n, 5))]))


def _cg_inputs(rng, dense, n, p):
    f32 = np.float32
    obs_prec = (rng.exponential(size=n) * 0.25 + 0.05).astype(f32)
    prior_prec_sqrt = np.concatenate(
        ([1e-3], 1.0 / rng.uniform(0.05, 3.0, size=p - 1))).astype(f32)
    z = (dense.T @ (rng.standard_normal(n) * obs_prec)).astype(f32)
    fisher = (dense * dense).T @ obs_prec
    precond = (1.0 / np.sqrt(prior_prec_sqrt.astype(np.float64) ** 2
                             + fisher)).astype(f32)
    return dict(obs_prec=obs_prec, prior_prec_sqrt=prior_prec_sqrt, z=z,
                coef_cg_init=rng.standard_normal(p).astype(f32) * 0.1,
                precond_scale=precond,
                perturbation=rng.standard_normal(p).astype(f32) * 2.0)


def test_batched_cg_matches_vmapped_jax(monkeypatch):
    from bayesbridge_tpu.design import SparseDesignMatrix as JaxDesign
    from bayesbridge_tpu.ops.cg import sample_gaussian_cg as jax_cg
    monkeypatch.delenv('BB_HYBRID_INT4', raising=False)
    X = _cg_problem(1)
    jd = JaxDesign(X, center_predictor=True, backend='hybrid',
                   dtype=np.float32, fused='1')
    td = SparseDesignMatrix(X, center_predictor=True, device='cpu')
    n, p = td.shape
    dense = td.toarray().astype(np.float64)
    per = [_cg_inputs(np.random.default_rng(10 + c), dense, n, p)
           for c in range(3)]
    a = {key: np.stack([d[key] for d in per]) for key in per[0]}
    atol = 1e-5 * np.sqrt(p)

    def one(o, pps, z, c0, s, pert):
        return jax_cg(jax.random.key(0), jd, o, pps, z, coef_cg_init=c0,
                      precond_scale=s, maxiter=500, atol=atol,
                      perturbation=pert)

    keys = ('obs_prec', 'prior_prec_sqrt', 'z', 'coef_cg_init',
            'precond_scale', 'perturbation')
    coef_j, info_j = jax.vmap(one)(*(jnp.asarray(a[k]) for k in keys))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    coef_t, info_t = sample_gaussian_cg_chains(
        [None] * 3, td, *(t[k] for k in keys[:3]),
        coef_cg_init=t['coef_cg_init'], precond_scale=t['precond_scale'],
        maxiter=500, atol=atol, perturbation=t['perturbation'])
    np.testing.assert_array_equal(info_t['n_cg_iter'],
                                  np.asarray(info_j['n_cg_iter']))
    assert info_t['n_cg_iter'].min() > 2 and info_t['cg_converged'].all()
    ref = np.asarray(coef_j, np.float64)
    for c in range(3):
        np.testing.assert_allclose(coef_t[c].numpy(), ref[c], rtol=1e-4,
                                   atol=1e-4 * np.abs(ref[c]).max())


N_CHAINS, N_ITER, N_BURNIN = 4, 150, 30


def _parity_problem():
    X = simulate_design(400, 20, binary_frac=.7, seed=11)
    beta = np.zeros(20)
    beta[:3] = 1.0
    return X, simulate_outcome(X, beta, 'logit', seed=12)


@pytest.fixture(scope='module')
def jax_chains():
    """The JAX package's gibbs_chains (fused='0', its composed default)
    on the parity problem: (samples, info)."""
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionModel as JaxModel,
        RegressionCoefPrior as JaxPrior,
    )
    from bayesbridge_tpu.multichain import gibbs_chains as jax_gibbs_chains
    X, outcome = _parity_problem()
    jmodel = JaxModel(outcome, X, family='logit', dtype=np.float32,
                      fused='0')
    jbridge = JaxBridge(jmodel, JaxPrior(**PRIOR_KW), dtype=np.float32)
    return jax_gibbs_chains(jbridge, N_ITER, N_CHAINS, n_burnin=N_BURNIN,
                            seed=1, coef_sampler_type='cg',
                            init={'global_scale': .1},
                            params_to_save=('coef',))


def _pooled_moments(draws):
    """Pooled mean and its ESS-aware standard error per coefficient of
    (n_chains, p, n_kept) draws."""
    ess = np.maximum(compute_multichain_ess(draws), 8.0)
    flat = np.moveaxis(draws, 0, -2).reshape(draws.shape[1], -1)
    return flat.mean(-1), flat.std(-1) / np.sqrt(ess)


def test_pooled_posterior_matches_jax_chains(jax_chains):
    X, outcome = _parity_problem()
    model = RegressionModel(outcome, X, family='logit', device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    ours, info = gibbs_chains(bridge, N_ITER, N_CHAINS, n_burnin=N_BURNIN,
                              seed=0, coef_sampler_type='cg',
                              init={'global_scale': .1},
                              params_to_save=('coef',))
    theirs = np.asarray(jax_chains[0]['coef'], np.float64)
    ours = np.asarray(ours['coef'], np.float64)
    assert ours.shape == theirs.shape == (N_CHAINS, 21, N_ITER - N_BURNIN)
    m1, se1 = _pooled_moments(ours)
    m2, se2 = _pooled_moments(theirs)
    z = np.abs(m1 - m2) / np.hypot(se1, se2)
    assert z.max() < Z_MAX, (z.round(2), m1.round(3), m2.round(3))
    assert np.all(m1[1:4] > 0.4) and np.all(m2[1:4] > 0.4)
    # The chains explore one posterior, each with more than one
    # effective draw.
    assert np.median(compute_split_rhat(ours)) < 1.3
    assert np.all(compute_effective_sample_size(ours[0]) > 1)
    assert info['n_chains'] == N_CHAINS


def test_chain_carry_from_jax(jax_chains):
    from bayesbridge_tpu.ops.summarizer import (
        extrapolate_coef_condmean as jax_extrapolate,
    )
    X, outcome = _parity_problem()
    chain_carry = jax_chains[1]['_chain_carry']
    carry = convert.chain_carry_from_numpy(chain_carry, device='cpu')
    slab = PRIOR_KW['regularizing_slab_size']
    warm_t = extrapolate_coef_condmean(carry['summ'], carry['gscale'],
                                       carry['lscale'], 1, slab)
    for c in range(N_CHAINS):
        summ = jax.tree_util.tree_map(lambda v: np.asarray(v)[c],
                                      dict(chain_carry['summ']))
        warm_j = np.asarray(jax_extrapolate(
            summ, np.float32(chain_carry['gscale'][c]),
            np.asarray(chain_carry['lscale'][c], np.float32), 1, slab))
        np.testing.assert_allclose(warm_t[c].numpy(), warm_j, rtol=1e-6,
                                   atol=1e-7)
    model = RegressionModel(outcome, X, family='logit', device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    cfg = bridge._step_config(bridge._resolve_options('cg', None))
    gens = [torch.Generator().manual_seed(c) for c in range(N_CHAINS)]
    carry, out = step_mod.gibbs_step_chains(cfg, model, gens, carry)
    assert out['coef'].shape == (N_CHAINS, 21)
    assert torch.isfinite(out['logp']).all()
    np.testing.assert_array_equal(
        carry['summ']['n_averaged'].numpy(),
        np.asarray(chain_carry['summ']['n_averaged']) + 1)
