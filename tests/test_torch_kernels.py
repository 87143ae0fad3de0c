"""The torch port's sweeps against the JAX package's Pallas kernels.

The same inputs, made with numpy from a seed, go through
``bayesbridge_tpu.design.fusedne`` (the Pallas kernels in interpret mode,
as tests/test_fusedne.py runs them off-TPU) and through the port's
``ne_sweep`` / ``tdots_sweep`` on CPU tensors, which run their plain
PyTorch versions. The port's blocks are stored as the design stores them:
padded to whole 16-byte rows, here with NaN / random bytes in the padding
to show that only the logical columns are read.

Tolerances follow tests/test_fusedne.py: u (and logp) rtol 2e-5 /
atol 2e-4 — the per-row dot products sum in another order; the column
reductions rtol 2e-4 with atol 2e-4 * max|out| — sums over all rows in
another order and chunking.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesbridge_tpu.design import fusedne
from bayesbridge_tpu_torch.kernels import layout
from bayesbridge_tpu_torch.kernels.ne_sweep import ne_sweep
from bayesbridge_tpu_torch.kernels.tdots_sweep import tdots_sweep

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

U_TOL = dict(rtol=2e-5, atol=2e-4)


def _close_reduction(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=2e-4,
                               atol=2e-4 * max(np.abs(ref).max(), 1.0))


def _block(rng, tag, n, p):
    """(numpy block for JAX, stored torch block for the port)."""
    if tag == 'int8':
        X = rng.integers(-3, 4, size=(n, p)).astype(np.int8)
    else:
        X = (rng.standard_normal((n, p))
             * (rng.uniform(size=(n, p)) < 0.3)).astype(np.float32)
    ld = layout.padded_width(p)
    if tag == 'int8':
        stored = torch.from_numpy(
            rng.integers(-128, 128, size=(n, ld)).astype(np.int8))
        stored[:, :p] = torch.from_numpy(X)
        return X, stored
    stored = torch.full((n, ld), float('nan'))
    stored[:, :p] = torch.from_numpy(X)
    if tag == 'bf16':
        import ml_dtypes
        X = X.astype(ml_dtypes.bfloat16)
        stored = stored.to(torch.bfloat16)
    return X, stored


def _vecs(rng, n, *widths):
    vs = [rng.standard_normal(p).astype(np.float32) for p in widths]
    c = rng.standard_normal(n).astype(np.float32)
    a = rng.integers(0, 3, size=n).astype(np.float32)
    b = (rng.exponential(size=n) + 1.0).astype(np.float32)
    return vs, c, a, b


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('tag', ['int8', 'bf16', 'f32'])
@pytest.mark.parametrize('two', [False, True])
def test_ne_sweep_matches_pallas(tag, two):
    """mid='ne', one block (fused_ne_matvec) and two blocks
    (fused_ne_matvec2 with an f32 float block); ragged n and p."""
    rng = np.random.default_rng(100 + 2 * ['int8', 'bf16', 'f32'].index(tag)
                                + two)
    n, pe, pf = 45, 70, 9
    Xe, Se = _block(rng, tag, n, pe)
    Xf, Sf = _block(rng, 'f32', n, pf)
    (ve, vf), c, _, w = _vecs(rng, n, pe, pf)
    if two:
        oe, of, u = fusedne.fused_ne_matvec2(
            jnp.asarray(Xe), jnp.asarray(Xf), ve, vf, c, w, interpret=True)
        ref_outs = [oe, of]
        blocks = [(Se, _t(ve)), (Sf, _t(vf))]
    else:
        oe, u = fusedne.fused_ne_matvec(jnp.asarray(Xe), ve, c, w,
                                        interpret=True)
        ref_outs = [oe]
        blocks = [(Se, _t(ve))]
    outs, u_t, lp = ne_sweep(blocks, _t(c), None, _t(w), 'ne')
    assert lp is None
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u), **U_TOL)
    for got, ref in zip(outs, ref_outs):
        _close_reduction(got.numpy(), ref)


@pytest.mark.parametrize('mid,tag,two', [
    ('logit', 'int8', True), ('logit', 'bf16', False),
    ('linear', 'f32', True), ('linear', 'int8', False)])
def test_link_sweep_matches_pallas(mid, tag, two):
    """mid='logit' / 'linear' with logp (fused_link_matvec), with a
    scalar row offset on the port's side (the design passes c as a 0-d
    tensor)."""
    rng = np.random.default_rng(hash((mid, tag, two)) % 2 ** 31)
    n, pe, pf = 51, 40, 17
    Xe, Se = _block(rng, tag, n, pe)
    Xf, Sf = _block(rng, 'f32', n, pf)
    (ve, vf), _, a, b = _vecs(rng, n, pe, pf)
    ve, vf = ve * 0.3, vf * 0.3
    c0 = np.float32(0.7)
    c = np.full(n, c0, np.float32)
    Xs, vs = ((Xe, Xf), (ve, vf)) if two else ((Xe,), (ve,))
    ref_outs, u, lp = fusedne.fused_link_matvec(
        tuple(jnp.asarray(X) for X in Xs), vs, c, a, b, mid,
        with_logp=True, interpret=True)
    blocks = [(Se, _t(ve)), (Sf, _t(vf))] if two else [(Se, _t(ve))]
    outs, u_t, lp_t = ne_sweep(blocks, torch.tensor(c0), _t(a), _t(b), mid,
                               with_logp=True)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u), **U_TOL)
    np.testing.assert_allclose(float(lp_t), float(lp), **U_TOL)
    for got, ref in zip(outs, ref_outs):
        _close_reduction(got.numpy(), ref)


def test_ne_sweep_multi_segment(monkeypatch):
    """Many row chunks on the port's side (the plain version up-converts
    a narrow block chunk by chunk) against a multi-step Pallas grid with
    a ragged last row panel."""
    monkeypatch.setattr(fusedne, '_X_BUDGET', 32 * 1024)
    monkeypatch.setattr(layout, 'CHUNK_BYTES', 4 * 200 * 7)
    rng = np.random.default_rng(7)
    n, pe, pf = 133, 200, 33
    Xe, Se = _block(rng, 'int8', n, pe)
    Xf, Sf = _block(rng, 'f32', n, pf)
    r, grid, _ = fusedne.plan(n, [(pe, jnp.int8), (pf, jnp.float32)])
    assert grid >= 2 and n % r
    assert layout._row_chunk(Se, pe) < n
    (ve, vf), c, _, w = _vecs(rng, n, pe, pf)
    oe, of, u = fusedne.fused_ne_matvec2(
        jnp.asarray(Xe), jnp.asarray(Xf), ve, vf, c, w, interpret=True)
    outs, u_t, _ = ne_sweep([(Se, _t(ve)), (Sf, _t(vf))], _t(c), None,
                            _t(w), 'ne')
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u), **U_TOL)
    _close_reduction(outs[0].numpy(), oe)
    _close_reduction(outs[1].numpy(), of)


@pytest.mark.parametrize('tag', ['int8', 'bf16', 'f32'])
@pytest.mark.parametrize('two', [False, True])
def test_tdots_sweep_matches_pallas(tag, two):
    """Per block X'u1, X'u2, X'u3 and (X.X)'u3 against fused_tdots; the
    squared moment is computed from the values also for 0/1 blocks."""
    rng = np.random.default_rng(300 + 2 * ['int8', 'bf16', 'f32'].index(tag)
                                + two)
    n, pe, pf = 57, 90, 11
    Xe, Se = _block(rng, tag, n, pe)
    Xf, Sf = _block(rng, 'f32', n, pf)
    us = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    Xs = (jnp.asarray(Xe), jnp.asarray(Xf)) if two else (jnp.asarray(Xe),)
    ref = fusedne.fused_tdots(Xs, *us, interpret=True)
    got = tdots_sweep([Se, Sf] if two else [Se], [pe, pf] if two else [pe],
                      *(_t(u) for u in us))
    assert len(got) == len(ref)
    for gb, rb in zip(got, ref):
        for g, r in zip(gb, rb):
            _close_reduction(g.numpy(), r)


def test_wrappers_validate_inputs():
    """Mismatched shapes, dtypes and modes raise before any compute."""
    X = torch.zeros((5, 16), dtype=torch.int8)
    v, w = torch.zeros(16), torch.ones(5)
    with pytest.raises(ValueError, match='mid'):
        ne_sweep([(X, v)], torch.tensor(0.), None, w, 'probit')
    with pytest.raises(ValueError, match='with_logp'):
        ne_sweep([(X, v)], torch.tensor(0.), None, w, 'ne', with_logp=True)
    with pytest.raises(ValueError, match='logical width'):
        ne_sweep([(X, torch.zeros(17))], torch.tensor(0.), None, w, 'ne')
    with pytest.raises(TypeError, match='storage dtype'):
        tdots_sweep([X.to(torch.int16)], [16], w, w, w)
    with pytest.raises(ValueError, match='length 5'):
        tdots_sweep([X], [16], w, w, torch.ones(4))
