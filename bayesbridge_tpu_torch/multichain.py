"""Independent Gibbs chains run as one chain-batched step.

Port of ``bayesbridge_tpu/multichain.py``. The JAX package vectorizes
its jitted step with ``jax.vmap``; here the step itself carries a
leading chain axis (:func:`.step.gibbs_step_chains`): every carry entry
holds k chains, each chain draws from its own ``torch.Generator``, and
the design's products take the k chains' vectors together. On the hybrid
backend's composed path (the default policy) a launch of the row pass,
the column pass or the pre-solve reductions serves up to 8 chains from
one read of X, and the k chains share the CG loop's and the rejection
samplers' host syncs. Under HMC and NUTS each chain runs its own
trajectory or tree; the chains still running evaluate the target
together (``utils.chains.run_lockstep``). Chain c of a batch is the
chain run alone from its generator, draw for draw.

Chains can share one deterministic initialization (the reference's
semantics for a fixed ``init``) or take per-chain inits: pass a sequence
of init dicts for the overdispersed starting points that make split
R-hat meaningful. ``gibbs_chains_resume`` continues all chains from
their exact final states. Cross-chain diagnostics (split R-hat, pooled
ESS) live in :mod:`.utils.mcmc_summarizer`.

With ``mesh=`` (a :class:`.parallel.Mesh`) the chains are split into
contiguous groups over the mesh's rows, each on the first device of its
row (every device of a 1-d mesh; multichain.py:146-155, 178-256, where
the JAX package shards the vmapped chain axis, ``P(chain_axis)``): each
group runs the chain-batched step on its device, over a copy of the
model placed there (``parallel.place_model``: replicated, as the JAX
``P()``), in its own host thread, so that several cards work at once;
the results are gathered in chain order on the bridge's device. A
chain's generator state restores on its group's device, and chain c
still equals the chain run alone, draw for draw.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .bridge import resolve_params_to_save
from .gibbs_util import SamplerOptions
from .parallel.sharding import place_model
from .design.sharded import ShardedDesignMatrix, on_device
from .random.basic import generator_from_state, generator_state
from .utils.dtypes import full_float32
from . import step as step_mod

_COUNTERS = ('n_gscale_clamped', 'n_lscale_underflow', 'n_lscale_overflow',
             'n_cg_unconverged', 'n_curvature_invalid')


def _stack_chain_inits(bridge, init, n_chains):
    """Resolve shared-or-per-chain inits into stacked start arrays
    (coef, obs_prec, lscale, gscale), each with a leading chain axis.

    A single (possibly partial) init dict resolves ONCE and the result
    is broadcast, so every chain starts from the same state even when
    `initialize_chain` has to draw unspecified parameters or run the MAP
    search (once, on the single-vector kernels). Per-chain
    (overdispersed) starts require an explicit sequence of dicts.
    """
    if isinstance(init, dict) or init is None:
        shared = bridge.initialize_chain(
            dict(init) if init else {'global_scale': 0.1},
            bridge.prior.bridge_exp)[:4]
        starts = [shared] * n_chains
    elif len(init) != n_chains:
        raise ValueError(
            f"Got {len(init)} init dicts for {n_chains} chains.")
    else:
        starts = [bridge.initialize_chain(
            dict(one), bridge.prior.bridge_exp)[:4] for one in init]

    def stack(i):
        return np.stack([np.asarray(
            s[i] if s[i] is not None else np.zeros(0), dtype=np.float64)
            for s in starts])

    return stack(0), stack(1), stack(2), stack(3)


def _to_host(carry):
    out = {}
    for key, val in carry.items():
        if isinstance(val, dict):
            out[key] = _to_host(val)
        elif torch.is_tensor(val):
            out[key] = val.cpu().numpy()
        else:
            out[key] = np.array(val)
    return out


def _to_device(carry, device):
    """A `_chain_carry` back on the device: the tensors as they were (so
    the continuation is exact), the CG counter an int32 per chain (a
    carry saved as int64 host counts converts)."""
    out = {}
    for key, val in carry.items():
        if isinstance(val, dict):
            out[key] = _to_device(val, device)
        else:
            out[key] = torch.as_tensor(np.array(val), device=device)
            if key == 'n_cg_unconverged':
                out[key] = out[key].to(torch.int32)
    return out


def _assemble(bridge, options, params_to_save, carry, outputs, gens,
              base_info):
    carry_host = _to_host(carry)
    # outputs: per kept draw (n_chains, ...) -> (n_chains, ..., n_kept)
    outputs = {key: np.stack([v.cpu().numpy() if torch.is_tensor(v)
                              else np.asarray(v) for v in vals], axis=1)
               for key, vals in outputs.items()}
    samples = {}
    for key in params_to_save:
        if key in outputs:
            samples[key] = np.moveaxis(outputs[key], 1, -1)

    # Report scales in the user-facing parametrization, exactly like
    # BayesBridge.gibbs (reference bayesbridge.py:244-254).
    gscale_final = np.array(carry_host['gscale'], dtype=np.float64)
    lscale_final = np.array(carry_host['lscale'], dtype=np.float64)
    if bridge.prior._gscale_paramet == 'coef_magnitude':
        gscale_final, lscale_final = bridge.prior.adjust_scale(
            gscale_final, lscale_final, to='coef_magnitude')
        bridge.prior.adjust_scale(
            samples.get('global_scale', np.zeros(0)),
            samples.get('local_scale', np.zeros(0)),
            to='coef_magnitude')

    # Per chain: (n_chains, n_kept) arrays.
    sampling_info = bridge.manager.assemble_sampling_info(
        outputs, options.coef_sampler_type)
    info = {
        **base_info,
        'coef_sampler_type': options.coef_sampler_type,
        'saved_params': tuple(params_to_save),
        'options': options.get_info(),
        '_reg_coef_sampling_info': sampling_info,
        '_final_state': {
            'coef': carry_host['coef'],
            'global_scale': gscale_final,
            'local_scale': lscale_final,
            'obs_prec': carry_host['obs_prec'],
        },
        # Exact resume state: the chain-batched carry (raw scales, the
        # summarizer) and each chain's generator state (the JAX package
        # keeps its chains' keys in '_chain_keys').
        '_chain_carry': carry_host,
        '_chain_generator_states': np.stack([generator_state(g)
                                             for g in gens]),
    }
    for counter in _COUNTERS:
        if counter in carry_host:
            info[counter] = int(np.sum(carry_host[counter]))
    # The single-chain path's guard-rail warnings, summed over chains.
    bridge._warn_guard_rails({c: info[c] for c in _COUNTERS if c in info})
    return samples, info


def _check_mesh(bridge, mesh):
    if mesh is not None and isinstance(bridge.model.design,
                                       ShardedDesignMatrix):
        raise ValueError(
            "mesh= puts a copy of the model on each device; the model's "
            "design is sharded already, and copying it would un-shard it")


def _execute(bridge, cfg, gens, carry, n_iter, n_burnin, thin,
             params_to_save, mesh=None):
    """Run the chains: one chain-batched step, or with `mesh` one per
    group of chains on its device, each in a thread. Returns (carry,
    outputs, generators), all in chain order on the bridge's device (the
    generators on their groups')."""
    n_sample = (n_iter - n_burnin) // thin
    n_remainder = (n_iter - n_burnin) - n_sample * thin
    args = (n_burnin, n_sample, thin, n_remainder)
    save_keys = tuple(params_to_save)
    if mesh is None:
        carry, outputs = step_mod.run_chains(cfg, bridge.model, gens, carry,
                                             *args, save_keys=save_keys)
        return carry, outputs, gens
    k = len(gens)
    heads = mesh.row_devices  # one group a mesh row
    size = -(-k // len(heads))
    groups = []
    for dev, r0 in zip(heads, range(0, k, size)):
        idx = list(range(r0, min(k, r0 + size)))
        groups.append((dev, idx, [generator_from_state(
            generator_state(gens[c]), dev) for c in idx]))

    def run(device, idx, group_gens):
        with on_device(device):
            return step_mod.run_chains(
                cfg, place_model(bridge.model, device), group_gens,
                _chains_on(carry, idx, device), *args, save_keys=save_keys)

    # One precision setting around every thread: full_float32 inside
    # run_chains saves and restores a process-wide setting.
    with full_float32(), ThreadPoolExecutor(len(groups)) as pool:
        futures = [pool.submit(run, *group) for group in groups]
        results = [f.result() for f in futures]
    home = bridge.device
    carry = _cat_chains([c for c, _ in results], home)
    outputs = {key: [_cat_chains(list(vals), home) for vals in
                     zip(*(out[key] for _, out in results))]
               for key in results[0][1]}
    return carry, outputs, [g for _, _, gg in groups for g in gg]


def _chains_on(tree, idx, device):
    """Chains `idx` of a chain-batched carry, on `device`."""
    if isinstance(tree, dict):
        return {key: _chains_on(val, idx, device) for key, val in
                tree.items()}
    if torch.is_tensor(tree):
        return tree[idx].to(device)
    return np.asarray(tree)[idx]


def _cat_chains(trees, device):
    """Chain-batched carries (or per-draw outputs) of consecutive chain
    groups as one, on `device`."""
    if isinstance(trees[0], dict):
        return {key: _cat_chains([t[key] for t in trees], device)
                for key in trees[0]}
    if torch.is_tensor(trees[0]):
        return torch.cat([t.to(device) for t in trees])
    return np.concatenate([np.asarray(t) for t in trees])


def gibbs_chains(bridge, n_iter, n_chains, n_burnin=0, thin=1, seed=None,
                 init=None, params_to_save=('coef', 'global_scale', 'logp'),
                 coef_sampler_type=None, options=None, mesh=None):
    """Run `n_chains` independent Gibbs chains as one batched step.

    Parameters mirror ``BayesBridge.gibbs``; additionally:

    init : dict, or sequence of n_chains dicts
        One dict starts every chain from the same state (they diverge
        only through their generators); a sequence gives each chain its
        own (overdispersed) start. For convergence diagnostics (split
        R-hat, pooled ESS) prefer a sequence of overdispersed starts:
        identical starts can leave a shared basin of a multimodal
        posterior undetected.
    mesh : a :class:`.parallel.Mesh`, or None: the chains split into
        contiguous groups over its rows' first devices (every device of
        a 1-d mesh; a device may repeat), each
        group on a copy of the model placed there, in its own thread
        (module docstring); the model's design must not be sharded

    The chains' generators derive from `seed` through the bridge's
    generator, which then moves past them (:meth:`BasicRandom.spawn`).

    Returns
    -------
    (samples, info) : samples[key] has shape (n_chains, ..., n_kept);
        info carries per-chain sampling statistics, the guard-rail
        counters summed over chains, and the exact per-chain resume
        state consumed by ``gibbs_chains_resume``.
    """
    _check_mesh(bridge, mesh)
    options = bridge._resolve_options(coef_sampler_type, options)
    params_to_save = resolve_params_to_save(bridge.model.name,
                                            params_to_save)

    bridge.rg.set_seed(seed)
    cfg = bridge._step_config(options)
    coef, obs_prec, lscale, gscale = _stack_chain_inits(bridge, init,
                                                        n_chains)
    gens = bridge.rg.spawn(n_chains)
    carry = step_mod.stack_carries([
        step_mod.init_carry(bridge.device, *start, dtype=bridge.dtype,
                            cfg=cfg)
        for start in zip(coef, obs_prec, gscale, lscale)])
    carry, outputs, gens = _execute(bridge, cfg, gens, carry, n_iter,
                                    n_burnin, thin, params_to_save, mesh)
    base_info = {'n_iter': n_iter, 'n_burnin': n_burnin, 'thin': thin,
                 'n_chains': n_chains, 'seed': seed}
    return _assemble(bridge, options, params_to_save, carry, outputs, gens,
                     base_info)


def gibbs_chains_resume(bridge, prev_info, n_add_iter, merge=False,
                        prev_samples=None, mesh=None):
    """Continue every chain from its exact final state.

    With ``merge=True`` (requires `prev_samples`) the returned samples
    are the previous and new draws concatenated along the iteration
    axis; the continuation equals having run the longer chains
    uninterrupted, bit for bit. `mesh` as for :func:`gibbs_chains` (it
    may differ from the first run's: a chain's state restores on any
    device).
    """
    if merge and prev_samples is None:
        raise ValueError(
            "To merge the outputs from previous and new MCMC runs, "
            "supply the optional argument `prev_samples`.")
    _check_mesh(bridge, mesh)
    options = SamplerOptions.from_info(prev_info['options'])
    params_to_save = prev_info['saved_params']
    cfg = bridge._step_config(options)
    carry = _to_device(prev_info['_chain_carry'], bridge.device)
    gens = [generator_from_state(state, bridge.device)
            for state in prev_info['_chain_generator_states']]
    thin = prev_info['thin']
    carry, outputs, gens = _execute(bridge, cfg, gens, carry, n_add_iter,
                                    0, thin, params_to_save, mesh)
    base_info = {'n_iter': n_add_iter, 'n_burnin': 0, 'thin': thin,
                 'n_chains': prev_info['n_chains'],
                 'seed': prev_info.get('seed')}
    samples, info = _assemble(bridge, options, params_to_save, carry,
                              outputs, gens, base_info)
    if merge:
        for key in samples:
            samples[key] = np.concatenate(
                (prev_samples[key], samples[key]), axis=-1)
        info['n_iter'] += prev_info['n_iter']
        info['_reg_coef_sampling_info'] = {
            key: val if key not in prev_info['_reg_coef_sampling_info']
            else np.concatenate(
                (prev_info['_reg_coef_sampling_info'][key], val), axis=1)
            for key, val in info['_reg_coef_sampling_info'].items()}
    return samples, info
