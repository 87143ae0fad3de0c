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
from bayesbridge_tpu_torch.kernels.tdots_sweep import (
    tdots_sweep, tdots_sweep_k, tdots_sweep_plain,
)

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


@pytest.mark.parametrize('n,pe,pf', [
    (1045, 45, 0), (1045, 4097, 513), (2999, 8191, 100), (7, 45, 1),
    (200_003, 4097, 513), (100_000, 45_000, 5_000), (1_000_000, 45, 0)])
@pytest.mark.parametrize('sms', [132, 114])
def test_presolve_i4_plan_keeps_int8_segments(n, pe, pf, sms):
    """The nibble pre-solve's plan: the int8 mode's row segments (from
    the 16-column tiling of the same blocks, as the int8 wrapper computes
    them), its own tiles of 2,048 nibble and 512 f32 columns, and a
    CTA's shared memory that fits a CTA's 227 KB, min_blocks times in an
    SM's 228 KB."""
    plan = layout.presolve_i4_plan(n, pe, pf, sms)
    X8 = torch.zeros((1, layout.padded_width(pe)), dtype=torch.int8)
    X4 = layout.pack_int4(X8, pe)
    Xf = torch.zeros((1, layout.padded_width(max(pf, 1))))
    int8_tiles = layout.col_tiles(pe, X8) + (layout.col_tiles(pf, Xf)
                                             if pf else 0)
    assert layout.col_tiles(pe, X4) == layout.col_tiles(pe, X8)
    assert (plan.n_seg, plan.rows_per_seg) == layout.segments_for(
        n, int8_tiles, sms)
    assert (plan.n_seg - 1) * plan.rows_per_seg < n \
        <= plan.n_seg * plan.rows_per_seg
    assert plan.tiles == (-(-pe // 2048), -(-pf // 512))
    assert plan.tile_columns == (2048, 512)
    assert plan.smem_bytes <= layout.SMEM_PER_CTA
    assert plan.min_blocks * plan.smem_bytes <= 228 * 1024


def test_presolve_binary_flag():
    """The plain pre-solve gives the same result with and without
    `binary` (which it ignores: its square of a 0/1 block is X'u3, within
    float32 rounding of the other product); the CPU wrappers dispatch to
    it either way; `binary` on a block that is not packed int4 raises."""
    rng = np.random.default_rng(3)
    n, pe, pf = 301, 77, 9
    X8 = torch.from_numpy((rng.uniform(size=(n, layout.padded_width(pe)))
                           < .3).astype(np.int8))
    X4 = layout.pack_int4(X8, pe)
    Xf = torch.from_numpy(rng.standard_normal(
        (n, layout.padded_width(pf))).astype(np.float32))
    us = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          for _ in range(4)]
    U = torch.stack(us)[:, None]
    for k in (3, 4):
        a = tdots_sweep_plain([X4, Xf], [pe, pf], *us[:k], binary=True)
        b = tdots_sweep_plain([X4, Xf], [pe, pf], *us[:k])
        c = tdots_sweep([X4, Xf], [pe, pf], *us[:k], binary=True)
        d = tdots_sweep_k([X4, Xf], [pe, pf], *U[:k], binary=True)
        for blk_a, blk_b, blk_c, blk_d in zip(a, b, c, d):
            for x, y, z, w in zip(blk_a, blk_b, blk_c, blk_d):
                assert torch.equal(x, y) and torch.equal(x, z) \
                    and torch.equal(x, w[0])
        np.testing.assert_allclose(a[0][3].numpy(), a[0][2].numpy(),
                                   rtol=1e-6, atol=1e-6 * float(
                                       a[0][2].abs().max()))
    with pytest.raises(ValueError, match='binary'):
        tdots_sweep([X8, Xf], [pe, pf], *us[:3], binary=True)
    with pytest.raises(ValueError, match='binary'):
        tdots_sweep_k([X8, Xf], [pe, pf], *U[:3], binary=True)


def test_presolve_i4_variants_edit_the_sources(tmp_path):
    """The nibble pre-solve's turns harness: each copy differs from the
    sources by its edits (every edited text is found once), a baseline
    directory gives its copy as it is and with one column-pass CTA an SM,
    and its ptxas log parser labels the pre-solve's kernels with their
    registers and spills."""
    from bayesbridge_tpu_torch.baselines import presolve_i4_variants as pv
    from bayesbridge_tpu_torch.kernels import build
    copies = pv.variants()
    assert {'base', 'bytes128', 'minblocks3', 'cut-u', 'cut-x', 'cut-sync',
            'cut-square'} <= set(copies)
    for name, files in copies.items():
        if name != 'base':
            assert files != copies['base'], name
    old = tmp_path / 'old'
    old.mkdir()
    for f in pv._FILES:
        (old / f).write_text((build.CSRC / f).read_text())
    copies = pv.variants(['base'], baseline=str(old))
    assert set(copies) == {'base', 'baseline:old', 'baseline:old+1cta'}
    assert copies['baseline:old'] == copies['base']
    one = copies['baseline:old+1cta']
    assert one['tdots_sweep.cu'] == copies['base']['tdots_sweep.cu']
    assert 'cudaFuncSetAttribute(colpass_kernel<T0, T1, K>' \
        in one['sweep_common.cuh']
    both = pv.variants(['bytes128+cut-x'])['bytes128+cut-x']['tdots_sweep.cu']
    assert 'kI4Bytes = 128;' in both and 'load_words<L::unit>(xb, qn[j]);' \
        in both
    name = ("_ZN7bbsweep12_GLOBAL__N_115tdots_i4_kernelILi5ELb1EEEvPKhli"
            "iPKflilS5_S5_S5_S5_Pf")
    first = ("_ZN7bbsweep12_GLOBAL__N_114colpass_kernelINS0_4Nib4EfLi4EEE"
             "vPKT_liiPKT0_lil")
    log = '\n'.join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{first}' for 'sm_90a'",
        "ptxas info    : Used 96 registers"])
    assert pv.ptxas_kernels(log) == [('nibble K=5 binary', 128, 12),
                                     ('first K=4', 96, 0)]
