"""The static-state Gibbs step and its runner on the CPU.

* ``step.run_chains`` (the eager ``step_into`` over fixed state buffers,
  the function the card captures as one CUDA graph per iteration) gives
  the same bits as the step before it: a reference copy of that step and
  its runner below (``_reference_run``, the chain-batched step with its
  CG counter on the host, the outputs appended per saved iteration).
  Logit and linear, CG, hybrid, dense and ell designs, k = 1 and 3, six
  iterations with one of burn-in, thin 2 and a remainder of one: every
  saved output, the carry (summarizer and counters included) and the
  generators' states after, equal bit for bit; Cholesky too;
* the emission plan equals the JAX package's ``run_chain``: its scan run
  with a step that emits its iteration number gives the saved
  iterations, for several (burn-in, thin, remainder) triples, and the
  port's runner saves those iterations of its chain (the same count,
  order and ``n_cg_iter`` entries as a thin-1 run from the same state);
* ``n_cg_unconverged`` counts as the JAX carry does (an int32 per chain,
  one a solve that stops at ``maxiter``): both steps with the CG
  solve's ``maxiter`` cut to 2;
* ``takes_step_graph`` is False on the CPU, for HMC and NUTS, Cholesky,
  the Cox model and a design over several devices, True for CG over
  one card's design with 1-8 chains (the card simulated by patching
  ``step._on_card``);
* the runner's outputs fill and read in chunks under a small output
  budget to the same values as one chunk.
"""

import numpy as np
import pytest
import torch

from bayesbridge_tpu_torch import (
    BayesBridge, RegressionCoefPrior, RegressionModel,
)
from bayesbridge_tpu_torch import step as step_mod
from bayesbridge_tpu_torch.gibbs_util import SamplerOptions
from bayesbridge_tpu_torch.ops.reg_coef import sample_gaussian_posterior
from bayesbridge_tpu_torch.random.basic import (
    generator_from_state, generator_state,
)
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

PRIOR_KW = dict(bridge_exponent=.5, regularizing_slab_size=2.)


def _data(family, dense, n=90, p=14, seed=5):
    rng = np.random.default_rng(seed)
    if dense:
        X = rng.standard_normal((n, p))
    else:
        X = simulate_design(n, p, binary_frac=.7, seed=seed)
    beta = np.zeros(p)
    beta[:3] = 1.0
    if family == 'linear':
        y = X @ beta + rng.standard_normal(n)
    else:
        y = simulate_outcome(X, beta, 'logit', seed=seed + 1)
    return X, y


# name: (family, dense data, model kwargs, sampler)
CASES = {
    'logit_hybrid': ('logit', False, {}, 'cg'),
    'logit_hybrid_fused': ('logit', False, dict(fused='1'), 'cg'),
    'logit_dense': ('logit', True, {}, 'cg'),
    'logit_ell': ('logit', False, dict(backend='ell', dtype=np.float64),
                  'cg'),
    'linear_hybrid': ('linear', False, {}, 'cg'),
    'linear_dense': ('linear', True, {}, 'cg'),
    'logit_dense_cholesky': ('logit', True, {}, 'cholesky'),
}


def _setup(case, k, seed=3):
    """(cfg, model, generators, chain-batched carry) from numpy starts."""
    family, dense, kw, sampler = CASES[case]
    X, y = _data(family, dense)
    model = RegressionModel(y, X, family=family, device='cpu', **kw)
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    cfg = bridge._step_config(SamplerOptions(sampler))
    rng = np.random.default_rng(seed)
    carries = []
    for _ in range(k):
        coef = rng.standard_normal(bridge.n_pred) * .3
        obs_prec = rng.uniform(.1, .3, model.n_obs) if family == 'logit' \
            else rng.uniform(.5, 2.)
        lscale = rng.uniform(.5, 2., bridge.n_pred - bridge.n_unshrunk)
        carries.append(step_mod.init_carry(
            'cpu', coef, obs_prec, rng.uniform(.05, .2), lscale,
            dtype=bridge.dtype, cfg=cfg))
    gens = [torch.Generator().manual_seed(seed * 100 + c) for c in range(k)]
    return cfg, model, gens, step_mod.stack_carries(carries)


def _copy_gens(gens):
    return [generator_from_state(generator_state(g), 'cpu') for g in gens]


# ---- the step and runner before the static-state step (reference) ---- #

def _reference_collapsed_draw(cfg, model, gens, carry):
    k = carry['coef'].shape[0]
    if model.name == 'linear':
        y_gauss = model.y.to(cfg.dtype).expand(k, -1)
        obs_prec = carry['obs_prec'][:, None] * torch.ones(
            cfg.n_obs, dtype=cfg.dtype, device=y_gauss.device)
    else:
        obs_prec = carry['obs_prec']
        y_gauss = (model.n_success - model.n_trial / 2.0).to(
            cfg.dtype) / obs_prec
    coef, summ, info = sample_gaussian_posterior(
        gens, model.design, y_gauss, obs_prec, carry['gscale'],
        carry['lscale'], cfg.prior_sd_for_unshrunk, cfg.slab_size,
        carry['summ'], method=cfg.coef_sampler_type,
        cg_precond_by=cfg.cg_preconditioner,
        cg_atol_multiplier=cfg.cg_atol_multiplier)
    converged = np.asarray(info.pop('cg_converged', np.ones(k, bool)))
    n_unconverged = np.asarray(carry['n_cg_unconverged'], np.int64) \
        + (~converged).astype(np.int64)
    info = {key: np.asarray(val) if key == 'n_cg_iter' else val
            for key, val in info.items()}
    return coef, {**carry, 'summ': summ,
                  'n_cg_unconverged': n_unconverged}, info


def _reference_step(cfg, model, gens, carry):
    coef, carry, info = _reference_collapsed_draw(cfg, model, gens, carry)
    coef = coef.to(cfg.dtype)
    lin_pred = info.pop('lin_pred', None)
    if lin_pred is None:
        lin_pred = model.design.dot(coef)
    obs_prec = step_mod.update_obs_precision_chains(cfg, model, gens,
                                                    lin_pred)
    gscale, clamped = step_mod.update_global_scale(
        cfg, gens, carry['gscale'], coef[:, cfg.n_unshrunk:])
    lscale, n_under, n_over = step_mod.update_local_scale(
        cfg, gens, gscale, coef[:, cfg.n_unshrunk:])
    logp = step_mod.compute_posterior_logprob(cfg, model, coef, gscale,
                                              obs_prec, lin_pred)
    carry = {
        **carry,
        'coef': coef, 'obs_prec': obs_prec,
        'gscale': gscale, 'lscale': lscale,
        'n_gscale_clamped': carry['n_gscale_clamped'] + clamped.to(
            torch.int32),
        'n_lscale_underflow': carry['n_lscale_underflow'] + n_under,
        'n_lscale_overflow': carry['n_lscale_overflow'] + n_over,
    }
    outputs = {'coef': coef, 'local_scale': lscale, 'global_scale': gscale,
               'obs_prec': obs_prec, 'logp': logp, **info}
    return carry, outputs


def _reference_run(cfg, model, gens, carry, n_burnin, n_sample, thin,
                   n_remainder, save_keys):
    n_iter = n_burnin + n_sample * thin + n_remainder
    outputs, n_saved = {}, 0
    for it in range(n_iter):
        carry, out = _reference_step(cfg, model, gens, carry)
        if it >= n_burnin and (it - n_burnin) % thin == thin - 1 \
                and n_saved < n_sample:
            for key, val in out.items():
                if key in save_keys or key not in step_mod.SAMPLE_KEYS:
                    outputs.setdefault(key, []).append(val)
            n_saved += 1
    return carry, outputs


def _equal(a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return a.shape == b.shape and torch.equal(a.to(b.dtype), b)


def _assert_same_carry(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_same_carry(got[key], ref[key])
        else:
            assert _equal(got[key], ref[key]), key


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('case', list(CASES))
def test_run_chains_equals_the_step_before(case, k):
    cfg, model, gens, carry = _setup(case, k)
    ref_gens = _copy_gens(gens)
    save = step_mod.SAMPLE_KEYS
    # 1 + 2 * 2 + 1 = 6 iterations: burn-in 1, thin 2, a remainder of 1.
    got_carry, got = step_mod.run_chains(cfg, model, gens, carry, 1, 2, 2,
                                         1, save_keys=save)
    ref_carry, ref = _reference_run(cfg, model, ref_gens, carry, 1, 2, 2,
                                    1, save)
    assert list(got) == list(ref)
    for key in ref:
        assert len(got[key]) == len(ref[key]) == 2, key
        for g, r in zip(got[key], ref[key]):
            assert _equal(g, r), key
            if key == 'n_cg_iter':
                assert isinstance(g, np.ndarray) and g.dtype == np.int64
    _assert_same_carry(got_carry, ref_carry)
    assert got_carry['n_cg_unconverged'].dtype == torch.int32
    for g, r in zip(gens, ref_gens):
        assert torch.equal(g.get_state(), r.get_state())


def test_step_into_writes_the_state_in_place():
    cfg, model, gens, carry = _setup('logit_hybrid', 2)
    ref_gens = _copy_gens(gens)
    state = step_mod.StepState(carry)
    buffers = {key: state.carry[key].data_ptr() for key in ('coef', 'lscale')}
    for _ in range(3):
        step_mod.step_into(cfg, model, gens, state)
    ref = carry
    for _ in range(3):
        ref, out = _reference_step(cfg, model, ref_gens, ref)
    for key, ptr in buffers.items():
        assert state.carry[key].data_ptr() == ptr
    _assert_same_carry(state.carry, ref)
    for key in ('coef', 'local_scale', 'global_scale', 'obs_prec', 'logp',
                'n_cg_iter'):
        assert _equal(state.out[key], out[key]), key


def test_single_chain_runner_keeps_its_types():
    cfg, model, gens, carry = _setup('logit_hybrid', 1)
    one = step_mod.chain_of(carry, 0)
    _, out = step_mod.run_chain(cfg, model, gens[0], one, 0, 3, 1, 0,
                                save_keys=('coef',))
    assert set(out) == {'coef', 'n_cg_iter'}
    assert all(isinstance(v, int) for v in out['n_cg_iter'])
    assert all(torch.is_tensor(v) and v.shape == (model.n_pred,)
               for v in out['coef'])


def test_outputs_read_in_chunks(monkeypatch):
    cfg, model, gens, carry = _setup('logit_hybrid', 2)
    ref_gens = _copy_gens(gens)
    save = ('coef', 'obs_prec', 'logp')
    _, whole = step_mod.run_chains(cfg, model, ref_gens, carry, 0, 5, 1, 0,
                                   save_keys=save)
    per_sample = 2 * (model.n_pred + model.n_obs + 1) * 4 + 2 * 4
    monkeypatch.setattr(step_mod, 'OUTPUT_BUDGET_BYTES', 2 * per_sample)
    _, chunked = step_mod.run_chains(cfg, model, gens, carry, 0, 5, 1, 0,
                                     save_keys=save)
    assert list(chunked) == list(whole)
    for key in whole:
        assert len(chunked[key]) == 5
        for a, b in zip(chunked[key], whole[key]):
            assert _equal(a, b), key


def test_outputs_read_in_one_packed_transfer():
    """The card's one read at a run's end packs tensors of every type the
    runner reads (each at a multiple of 8 bytes) and cuts them back."""
    rng = np.random.default_rng(4)
    tensors = [torch.as_tensor(rng.standard_normal((3, 5))),
               torch.as_tensor(rng.integers(0, 9, (2, 3), dtype=np.int32)),
               torch.as_tensor(rng.uniform(size=7) < .5),
               torch.as_tensor(rng.standard_normal(3).astype(np.float32)),
               torch.tensor(5, dtype=torch.int64), torch.zeros((2, 0))]
    got = step_mod._packed_copy(tensors)
    for a, b in zip(got, tensors):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ---- the emission plan against the JAX package's run_chain ---------- #

TRIPLES = [(0, 1, 0), (1, 2, 1), (3, 2, 0), (2, 3, 2), (5, 1, 3), (0, 4, 3),
           (4, 2, 5)]


def _jax_saved_iterations(n_burnin, n_sample, thin, n_remainder,
                          monkeypatch):
    """The iterations the JAX package's run_chain emits: its scan run
    with a step that counts its calls and emits the count."""
    import jax.numpy as jnp
    from bayesbridge_tpu import step as jax_step

    def counting_step(cfg, model, carry):
        it = carry['it']
        return {'it': it + 1}, {'coef': it, 'n_cg_iter': it}

    monkeypatch.setattr(jax_step, 'gibbs_step', counting_step)
    carry, out = jax_step.run_chain.__wrapped__(
        None, None, {'it': jnp.int32(0)}, n_burnin, n_sample, thin,
        n_remainder, ('coef',))
    n_iter = n_burnin + n_sample * thin + n_remainder
    assert int(carry['it']) == n_iter
    if not n_sample:
        return [], []
    return (np.asarray(out['coef']).tolist(),
            np.asarray(out['n_cg_iter']).tolist())


@pytest.mark.parametrize('triple', TRIPLES)
def test_emission_plan_equals_jax_run_chain(triple, monkeypatch):
    n_burnin, thin, n_remainder = triple
    n_sample = 3
    saved, cg_saved = _jax_saved_iterations(n_burnin, n_sample, thin,
                                            n_remainder, monkeypatch)
    assert step_mod.emission_plan(n_burnin, n_sample, thin,
                                  n_remainder) == saved == cg_saved
    # The port's runner saves those iterations of its chain.
    cfg, model, gens, carry = _setup('logit_hybrid', 2)
    n_iter = n_burnin + n_sample * thin + n_remainder
    every_gens = _copy_gens(gens)
    _, every = step_mod.run_chains(cfg, model, every_gens, carry, 0, n_iter,
                                   1, 0, save_keys=('coef',))
    _, got = step_mod.run_chains(cfg, model, gens, carry, n_burnin,
                                 n_sample, thin, n_remainder,
                                 save_keys=('coef',))
    assert len(got['coef']) == len(got['n_cg_iter']) == len(saved)
    for j, it in enumerate(saved):
        assert torch.equal(got['coef'][j], every['coef'][it])
        assert np.array_equal(got['n_cg_iter'][j], every['n_cg_iter'][it])
    for a, b in zip(gens, every_gens):
        assert torch.equal(a.get_state(), b.get_state())


def test_emission_plan_without_samples(monkeypatch):
    saved, _ = _jax_saved_iterations(4, 0, 2, 1, monkeypatch)
    assert step_mod.emission_plan(4, 0, 2, 1) == saved == []


# ---- n_cg_unconverged on the device, as the JAX carry counts it ------ #

def test_unconverged_counter_matches_jax_carry(monkeypatch):
    import jax
    import jax.numpy as jnp
    from functools import partial
    from bayesbridge_tpu import (
        BayesBridge as JaxBridge, RegressionCoefPrior as JaxPrior,
        RegressionModel as JaxModel,
    )
    from bayesbridge_tpu import step as jax_step
    X, y = _data('logit', False)
    n_iter = 3
    monkeypatch.setattr(jax_step, 'sample_gaussian_posterior', partial(
        jax_step.sample_gaussian_posterior, cg_maxiter=2))
    jbridge = JaxBridge(JaxModel(y, X, family='logit', dtype=np.float32),
                        JaxPrior(**PRIOR_KW), dtype=np.float32)
    jcfg = jbridge._get_step_config(SamplerOptions('cg'))
    rng = np.random.default_rng(0)
    coef = rng.standard_normal(jbridge.n_pred) * .3
    obs_prec = rng.uniform(.1, .3, X.shape[0])
    lscale = np.ones(jbridge.n_pred - jbridge.n_unshrunk)
    jcarry = jax_step.init_carry(jcfg, jax.random.PRNGKey(0), coef,
                                 obs_prec, .1, lscale)
    for _ in range(n_iter):
        jcarry, jout = jax_step.gibbs_step(jcfg, jbridge.model, jcarry)
    assert jcarry['n_cg_unconverged'].dtype == jnp.int32
    assert int(jcarry['n_cg_unconverged']) == n_iter
    assert int(jout['n_cg_iter']) == 2

    cfg, model, gens, carry = _setup('logit_hybrid', 3)
    monkeypatch.setattr(step_mod, 'sample_gaussian_posterior', partial(
        step_mod.sample_gaussian_posterior, cg_maxiter=2))
    state = step_mod.StepState(carry)
    for _ in range(n_iter):
        step_mod.step_into(cfg, model, gens, state)
    got = state.carry['n_cg_unconverged']
    assert got.dtype == torch.int32 and got.shape == (3,)
    assert got.tolist() == [int(jcarry['n_cg_unconverged'])] * 3
    assert state.out['n_cg_iter'].tolist() == [2, 2, 2]


# ---- where the step graph runs ---------------------------------------- #

def test_takes_step_graph(monkeypatch):
    cfg, model, gens, carry = _setup('logit_hybrid', 3)
    assert not step_mod.takes_step_graph(cfg, model, 3)  # the CPU
    monkeypatch.setattr(step_mod, '_on_card', lambda device: True)
    assert step_mod.takes_step_graph(cfg, model, 3)
    assert step_mod.takes_step_graph(cfg, model, 8)
    assert not step_mod.takes_step_graph(cfg, model, 9)
    for sampler in ('hmc', 'nuts', 'cholesky'):
        other = step_mod.GibbsStepConfig(
            model, RegressionCoefPrior(**PRIOR_KW), SamplerOptions(sampler),
            cfg.n_unshrunk, cfg.prior_sd_for_unshrunk)
        assert not step_mod.takes_step_graph(other, model, 3), sampler
    lin_cfg, lin_model, _, _ = _setup('linear_dense', 1)
    assert step_mod.takes_step_graph(lin_cfg, lin_model, 1)
    # A design over several devices, or with other processes.
    monkeypatch.setattr(model.design, 'devices', lambda: {
        torch.device('cpu', 0), torch.device('cpu', 1)})
    assert not step_mod.takes_step_graph(cfg, model, 3)
    monkeypatch.setattr(model.design, 'devices', lambda: None)
    assert not step_mod.takes_step_graph(cfg, model, 3)


def test_takes_step_graph_refuses_cox(monkeypatch):
    monkeypatch.setattr(step_mod, '_on_card', lambda device: True)
    X = simulate_design(40, 6, binary_frac=.6, seed=1)
    event = np.where(np.arange(40) % 2 == 0, np.arange(40.) + 1, np.inf)
    censor = np.where(np.isinf(event), np.arange(40.) + 1, np.inf)
    with pytest.warns(UserWarning, match='sorted'):
        model = RegressionModel((event, censor), X, family='cox',
                                device='cpu')
    bridge = BayesBridge(model, RegressionCoefPrior(**PRIOR_KW))
    cfg = bridge._step_config(SamplerOptions('hmc'))
    assert not step_mod.takes_step_graph(cfg, model, 1)


def test_cpu_run_takes_the_eager_step(monkeypatch):
    """On the CPU no step graph is built: the runner steps eagerly."""
    cfg, model, gens, carry = _setup('logit_hybrid', 2)
    built = []
    monkeypatch.setattr(step_mod, '_step_graph',
                        lambda *args, **kw: built.append(1))
    step_mod.run_chains(cfg, model, gens, carry, 0, 2, 1, 0,
                        save_keys=('coef',))
    assert not built
