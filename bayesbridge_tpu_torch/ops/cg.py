"""Prior-preconditioned conjugate-gradient Gaussian sampler.

Port of ``bayesbridge_tpu/ops/cg.py`` (Nishimura & Suchard 2022;
reference: bayesbridge/reg_coef_sampler/cg_sampler.py:20-150): one draw
from N(Sigma z, Sigma), Sigma^{-1} = Phi = X' diag(obs_prec) X +
diag(prior_prec_sqrt)^2, by CG-solving Phi beta = b with

    b = z + X'(sqrt(obs_prec) eps_1) + prior_prec_sqrt * eps_2,

preconditioned by `precond_scale`. Each iteration applies the operator
through ``design.quad_matvec``: one fused sweep of the stored blocks
where the hybrid design's policy fuses the CG operator, `dot` then
`Tdot` on the composed path, where the loop can also accumulate the
draw's linear predictor from the forward intermediates
(`return_lin_pred`). On the hybrid composed path the whole solve is
block-ordered (``design.cg_blockorder_ctx``), and a caller-supplied warm
start (`warm_tdot` / `lin_pred0`) saves the initial residual's operator
application.

The JAX loop is a ``lax.while_loop`` with no host round-trips.
:func:`sample_gaussian_cg_chains` solves for k Markov chains at once (the
JAX loop under ``vmap``): each chain has its own step sizes, residual,
threshold and iteration count, and a chain whose residual has met its
threshold (or whose count has reached `maxiter`) keeps its state while the
others run on, as ``vmap`` of a while loop masks it. One iteration is one
function of a static-shaped state (:class:`..kernels.cg_loop.CgState`):
the design's operator at s p for all k chains, then
:func:`..kernels.cg_loop.cg_update`. Two loops run it:

* the device loop, on a CUDA device wherever the design's products all
  run on that device in this process (:func:`takes_device_loop`): the
  prologue and the iteration are captured once per design and shape
  into one CUDA graph whose conditional WHILE node loops the iteration
  while any chain runs (:class:`..kernels.cg_loop.SolveGraph`); a solve
  copies its inputs into the graph's buffers, launches it once and
  reads the iteration counts and convergence flags once at the end;
* the host loop, elsewhere (the CPU, and a mesh over several devices
  or processes): a Python loop while any chain runs, one host read an
  iteration.

The stopping rule, the float32 floor on the tolerance included, is the
reference's, so ``n_cg_iter`` matches it on the same inputs. The sums
over a chain's vector run per chain (:mod:`..utils.chains` on the CPU,
in an order fixed by the vector's length in ``csrc/cg_loop.cu``), so
chain c takes the iterations and the values it takes alone. A chain that
has stopped rides along in the operator's products until the last one
stops; the design reads X once for up to 8 chains where its kernels take
chain batches, else once per chain.
"""

import functools
import threading
import weakref

import numpy as np
import torch

from ..kernels.cg_loop import (
    CgState, SolveGraph, cg_start, cg_update, indexed,
)


def choose_preconditioner(prior_prec_sqrt, n_unshrunk, coef_scaled_sd,
                          target_sd_scale=2.0):
    """The prior preconditioner (cg_sampler.py:123-138): shrunk
    coordinates scaled by their prior sd, unshrunk ones by an inflated
    estimate of their posterior sd (erring toward larger precision)."""
    shrunk_scale = 1.0 / prior_prec_sqrt
    if n_unshrunk == 0:
        return shrunk_scale
    return torch.cat((target_sd_scale * coef_scaled_sd[..., :n_unshrunk],
                      shrunk_scale[..., n_unshrunk:]), -1)


def choose_diag_preconditioner(design, obs_prec, prior_prec_sqrt):
    """Jacobi preconditioner from the full conditional-precision
    diagonal (cg_sampler.py:140-143): 1/sqrt(prior_prec^2 + diag(X'WX))."""
    diag = prior_prec_sqrt ** 2 \
        + design.compute_fisher_info(obs_prec, diag_only=True)
    return 1.0 / torch.sqrt(diag)


def sample_gaussian_cg(gen, design, obs_prec, prior_prec_sqrt, z,
                       coef_cg_init, precond_scale, maxiter=500, atol=1e-6,
                       perturbation=None, warm_tdot=None, lin_pred0=None,
                       return_lin_pred=False):
    """One CG-sampled draw. Returns (coef, info), or (coef, lin_pred,
    info) with `return_lin_pred`; info = {'n_cg_iter': int,
    'cg_converged': bool}.

    `perturbation` (optional): the precomputed b-vector noise
    X'(sqrt(obs_prec) eps_1) + prior_prec_sqrt * eps_2; when omitted it
    is drawn here from `gen` (eps_1 first, then eps_2).

    `warm_tdot` (optional): ``X'(obs_prec * (X coef_cg_init))`` in the
    original column order. The design part of the operator at the warm
    start x0 = coef_cg_init / precond_scale depends on coef_cg_init alone,
    so the caller can ride it on the pre-solve read
    (``presolve_reductions`` u4); the initial residual then needs no
    operator application. With `return_lin_pred` supply `lin_pred0` =
    X coef_cg_init beside it (ops/cg.py:63-71, 149-163).

    `return_lin_pred`: also return the draw's linear predictor X coef,
    accumulated from the operator's forward intermediates
    (lin_pred = X x0 + sum_k alpha_k X(s p_k)), exact in exact
    arithmetic, so the Gibbs step needs no separate design pass.
    """
    def row(x):
        return None if x is None else x[None]

    res = sample_gaussian_cg_chains(
        [gen], design, obs_prec[None], prior_prec_sqrt[None], z[None],
        coef_cg_init[None], precond_scale[None], maxiter, atol,
        row(perturbation), row(warm_tdot), row(lin_pred0), return_lin_pred)
    info = {'n_cg_iter': int(res[-1]['n_cg_iter'][0]),
            'cg_converged': bool(res[-1]['cg_converged'][0])}
    return tuple(r[0] for r in res[:-1]) + (info,)


def takes_device_loop(design, device):
    """Whether the solve runs as the device loop: on a CUDA device, for a
    design whose products all run on that device in this process
    (``design.devices()``: any backend, and a 1-d or 2-d mesh whose pieces
    all sit on it). A mesh over several devices, or one with other
    processes (a process group), keeps the host loop (ROADMAP, Queue
    2)."""
    device = indexed(device)
    if device.type != 'cuda':
        return False
    devices = design.devices()
    return devices is not None and {indexed(d) for d in devices} == {device}


def sample_gaussian_cg_chains(gens, design, obs_prec, prior_prec_sqrt, z,
                              coef_cg_init, precond_scale, maxiter=500,
                              atol=1e-6, perturbation=None, warm_tdot=None,
                              lin_pred0=None, return_lin_pred=False):
    """:func:`sample_gaussian_cg` for k chains: every vector argument
    carries a leading chain axis ((k, n) or (k, p)), `gens` is one
    generator per chain (read only without `perturbation`). Returns
    (coef (k, p)[, lin_pred (k, n)], info) with info['n_cg_iter'] (k,)
    ints and info['cg_converged'] (k,) bools, numpy arrays."""
    n_obs, n_pred = design.shape
    if perturbation is None:
        eps_obs, eps_prior = [], []
        for g in gens:
            eps_obs.append(torch.randn(n_obs, generator=g, dtype=z.dtype,
                                       device=z.device))
            eps_prior.append(torch.randn(n_pred, generator=g, dtype=z.dtype,
                                         device=z.device))
        perturbation = design.Tdot(torch.sqrt(obs_prec)
                                   * torch.stack(eps_obs)) \
            + prior_prec_sqrt * torch.stack(eps_prior)
    if warm_tdot is not None and return_lin_pred and lin_pred0 is None:
        raise ValueError("return_lin_pred with warm_tdot requires "
                         "lin_pred0 (= X coef_cg_init)")
    inp = {'z': z, 'pert': perturbation, 'pps': prior_prec_sqrt,
           's': precond_scale, 'w': obs_prec, 'coef': coef_cg_init}
    if warm_tdot is not None:
        inp['warm'] = warm_tdot
        if return_lin_pred:
            inp['lin0'] = lin_pred0
    solve = device_solve if takes_device_loop(design, z.device) \
        else host_solve
    coef, yhat, info = solve(design, inp, maxiter, atol, return_lin_pred)
    if return_lin_pred:
        return coef, yhat, info
    return coef, info


def _state_shape(design, inp, return_lin_pred):
    """(k, n, dtype) of the loop's state: the chains, the linear
    predictor's length (0 without it) and the type the inputs promote
    to, in which the loop computes (ops/cg.py:190-192: the
    preconditioner's can be wider than the design's)."""
    dtype = functools.reduce(torch.promote_types, [
        v.dtype for key, v in inp.items() if key != 'w'] + [design.dtype])
    return inp['z'].shape[0], design.shape[0] if return_lin_pred else 0, \
        dtype


def host_solve(design, inp, maxiter, atol, return_lin_pred):
    """The solve driven from the host: the prologue, then one iteration
    at a time while any chain runs (one host read an iteration). `inp`
    holds the (k, .) inputs 'z', 'pert' (the b-vector noise), 'pps'
    (prior_prec_sqrt), 's' (precond_scale), 'w' (obs_prec), 'coef'
    (coef_cg_init) and, with a warm start, 'warm' (warm_tdot) and
    'lin0' (lin_pred0). Returns (coef, linear predictor or None,
    info)."""
    k, n, dtype = _state_shape(design, inp, return_lin_pred)
    st = CgState(k, design.shape[1], n, dtype, inp['z'].device, maxiter,
                 _floor_eps(inp))
    st.atol.fill_(_atol(atol, inp))
    bo_ctx = design.cg_blockorder_ctx()
    quad = _operator(design, bo_ctx)
    _setup(st, inp, quad, bo_ctx)
    cg_start(st)
    while bool(st.running.any()):
        _iterate(st, inp['w'], quad)
    return _finish(st, bo_ctx)[:3]


def _floor_eps(inp):
    """The eps of the float32 floor on the tolerance: z's type's, as the
    atol's type (ops/cg.py:98, 169-171), also where the loop computes
    wider (a float64 chain over a float32-stored design)."""
    return torch.finfo(inp['z'].dtype).eps


def _atol(atol, inp):
    """`atol` rounded to z's type, as the reference takes it."""
    return torch.tensor(float(atol), dtype=inp['z'].dtype).item()


def _operator(design, bo_ctx):
    """The operator's design part, X' (w (X v)) (with X v where
    `return_t`), in block order on the hybrid composed path: conjugating
    the whole solve by the block permutation turns the operator's
    per-iteration gather and scatter into slices (ops/cg.py:110-147)."""
    if bo_ctx is None:
        return design.quad_matvec
    offset_bo = bo_ctx[2]

    def quad(v, w, return_t=False):
        return design.quad_matvec_blockorder(v, w, offset_bo,
                                             return_t=return_t)
    return quad


def _setup(st, inp, quad, bo_ctx):
    """The solve's prologue into the state: b = s (z + perturbation), the
    operator's diagonal d = (s prior_prec_sqrt)^2, both in block order
    where `bo_ctx`, the warm start x0 = coef_cg_init / s and the initial
    residual r0 = b - Phi-tilde x0, whose design part is `warm` where the
    caller gave it (its linear predictor then `lin0`), else one operator
    application (ops/cg.py:149-163)."""
    s = inp['s']
    b = s * (inp['z'] + inp['pert'])
    d = (s * inp['pps']) ** 2
    coef, warm = inp['coef'], inp.get('warm')
    if bo_ctx is not None:
        perm = bo_ctx[0]
        b, s, d, coef = b[:, perm], s[:, perm], d[:, perm], coef[:, perm]
        if warm is not None:
            warm = warm[:, perm]
    x = coef / s
    if warm is not None:
        # s * x0 = coef_cg_init up to one rounding, so the design part of
        # the operator at x0 is the caller-supplied reduction.
        r = b - (d * x + s * warm)
        y = inp.get('lin0')
    else:
        if st.y is not None:
            out, y = quad(s * x, inp['w'], return_t=True)
        else:
            out = quad(s * x, inp['w'])
        r = b - (d * x + s * out)
    for dst, src in ((st.b, b), (st.s, s), (st.d, d), (st.x, x),
                     (st.r, r)):
        dst.copy_(src)
    if st.y is not None:
        st.y.copy_(y)


def _iterate(st, w, quad):
    """One iteration for every chain: the operator's design part at
    s p = st.sp (with the forward intermediate X (s p) where the loop
    keeps the linear predictor), then the update (Phi-tilde p = d p +
    s out; cg_sampler.py:104-113)."""
    if st.y is not None:
        out, t = quad(st.sp, w, return_t=True)
    else:
        out, t = quad(st.sp, w), None
    cg_update(st, out, t)


def _finish(st, bo_ctx):
    """(coef, linear predictor or None, info, the iterations the loop
    ran) of a finished solve; info and the iteration count read to the
    host in one transfer. The loop runs while any chain runs, so it ran
    the iteration max(n_iter) times."""
    coef = st.s * st.x
    if bo_ctx is not None:
        coef = coef[:, bo_ctx[1]]
    host = torch.cat((st.n_iter, st.converged().to(torch.int32),
                      st.iters)).cpu().numpy()
    k, iters = st.k, int(host[-1])
    info = {'n_cg_iter': host[:k].astype(np.int64),
            'cg_converged': host[k:2 * k].astype(bool)}
    if iters != int(info['n_cg_iter'].max()):
        raise RuntimeError(f"CG loop: the iteration ran {iters} times, "
                           f"the chains' counts are {info['n_cg_iter']}")
    return coef, st.y, info, iters


class _DeviceLoop:
    """The device loop of one design at one key (chains, types, the
    options, `maxiter`, the device): static input buffers, the state and
    its :class:`SolveGraph`."""

    def __init__(self, design, inp, k, n, dtype, maxiter):
        device = indexed(inp['z'].device)
        m = design.shape[1]
        self.bo_ctx = design.cg_blockorder_ctx()
        quad = _operator(design, self.bo_ctx)
        self.inp = {key: torch.zeros(
            v.shape, dtype=v.dtype if key == 'w' else dtype, device=device)
            for key, v in inp.items()}
        feps = _floor_eps(inp)
        self.st = st = CgState(k, m, n, dtype, device, maxiter, feps)
        # Warm-up before the captures: the same work once on scratch
        # copies, never on the chain's state.
        scratch_inp = {key: torch.ones_like(v) for key, v in
                       self.inp.items()}
        scratch = CgState(k, m, n, dtype, device, maxiter, feps)

        def warm():
            _setup(scratch, scratch_inp, quad, self.bo_ctx)
            cg_start(scratch)
            _iterate(scratch, scratch_inp['w'], quad)

        memo, design.memoized = design.memoized, False
        try:
            self.graph = SolveGraph(
                st, lambda: _setup(st, self.inp, quad, self.bo_ctx),
                lambda: _iterate(st, self.inp['w'], quad), warm,
                design.counters())
        finally:
            design.memoized = memo

    def solve(self, inp, atol):
        """Copy the inputs in, launch the graph once, read the info once:
        (coef, linear predictor or None, info)."""
        st = self.st
        with self.graph.lock:
            for key, v in inp.items():
                self.inp[key].copy_(v)
            st.atol.fill_(_atol(atol, inp))
            self.graph.launch()
            coef, yhat, info, iters = _finish(st, self.bo_ctx)
            if yhat is not None:
                yhat = yhat.clone()
        self.graph.count(iters)
        return coef, yhat, info


_LOOPS_ATTR = '_cg_device_loops'
_BUILD_LOCK = threading.Lock()


def _loops_of(design):
    """The design's graphs by key. They are kept on the design with a
    weak reference to it: a shallow copy of the design (``with_policy``,
    ``with_exact_tier``, ``row_block``) shares its attributes, and its
    first solve replaces the entry with its own, since a graph reads the
    buffers of the design it was captured on."""
    owner, loops = design.__dict__.get(_LOOPS_ATTR, (None, None))
    if owner is None or owner() is not design:
        loops = {}
        design.__dict__[_LOOPS_ATTR] = (weakref.ref(design), loops)
    return loops


def device_solve(design, inp, maxiter, atol, return_lin_pred):
    """:func:`host_solve` as the device loop: one launch of the solve's
    graph, captured on the first call of its key (the design, the
    chains, the types, the options, `maxiter`, the device) and kept on
    the design (:func:`_loops_of`), and one host read at the end."""
    k, n, dtype = _state_shape(design, inp, return_lin_pred)
    device = indexed(inp['z'].device)
    key = (k, n, dtype, inp['z'].dtype, inp['w'].dtype, 'warm' in inp,
           int(maxiter), device)
    with _BUILD_LOCK:
        loops = _loops_of(design)
        loop = loops.get(key)
        if loop is None:
            loop = loops[key] = _DeviceLoop(design, inp, k, n, dtype,
                                            maxiter)
    return loop.solve(inp, atol)
