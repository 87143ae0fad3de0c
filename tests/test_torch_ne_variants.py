"""The sweep A/B harness of the port against the JAX package's.

The JAX harness ``baselines/dev_ne_variants.py`` holds two Pallas
kernels, ``make_fused`` (the one-read normal-equations sweep, in several
reduction variants) and ``make_probe`` (streaming probes). They run here
under ``pltpu.force_tpu_interpret_mode()``; the port's counterparts
(``kernels.ne_onepass``, ``kernels.stream_probe``) run their plain
versions on the CPU, on the same numpy inputs.

* ``ne_onepass_plain`` against ``make_fused`` for every default spec and
  ``mxu2a:mxu3``, ``mxu1a:v1``, ``v1s:v1``, with a VMEM budget that cuts
  the rows into several grid panels and n not a multiple of the panel
  rows: (out_e, out_f, u) within 1e-5 of max|ref| (float32 sums in
  another order; the bf16 splits of v and u are the same);
* ``stream_probe_plain`` against ``make_probe`` on aligned shapes (p a
  multiple of 1024, n of the panel rows), where the TPU probe is defined,
  with x64 off as on the TPU, within 1e-6 (of n * 2**31 for i32, whose
  row sums wrap in int32);
* the harness's pre-solve kinds against ``make_presolve``, 1e-5 of
  max|ref| per output;
* the harness's command line end to end with ``--device cpu``;
* the ablation's copies of the one-read kernel each lack their part.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from baselines import dev_ne_variants as jax_harness
from bayesbridge_tpu_torch.baselines import dev_ne_variants as harness
from bayesbridge_tpu_torch.kernels import layout
from bayesbridge_tpu_torch.kernels.ne_onepass import (
    map_spec, ne_onepass, ne_onepass_plain,
)
from bayesbridge_tpu_torch.kernels.stream_probe import (
    stream_probe, stream_probe_plain,
)

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)

N, PE, PF = 100, 1500, 300
# Rows of a JAX panel: 32 at this budget (one int8 + f32 row is 2048 +
# 4096 bytes padded), so N = 100 spans four panels, the last ragged.
BUDGET = 32 * (2048 + 4 * 1024)
SPECS = harness.DEFAULT_VARIANTS.split(',') + ['mxu2a:mxu3', 'mxu1a:v1',
                                               'v1s:v1']


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


@pytest.fixture(scope='module')
def blocks():
    rng = np.random.default_rng(0)
    Xe = (rng.random((N, PE)) < .5).astype(np.int8)
    Xe[:, ::7] *= rng.integers(-3, 4, size=(N, len(range(0, PE, 7)))) \
        .astype(np.int8)
    Xf = rng.standard_normal((N, PF)).astype(np.float32)
    ve = rng.standard_normal(PE).astype(np.float32) / PE ** .5
    vf = rng.standard_normal(PF).astype(np.float32) / PF ** .5
    c = (rng.standard_normal(N) * .1).astype(np.float32)
    w = (rng.random(N) + .1).astype(np.float32)
    return Xe, Xf, ve, vf, c, w


def _stored(X):
    """The port's storage: zero columns up to the padded width."""
    out = torch.zeros((X.shape[0], layout.padded_width(X.shape[1])),
                      dtype=torch.from_numpy(X).dtype)
    out[:, :X.shape[1]] = torch.from_numpy(X)
    return out


@pytest.mark.parametrize('spec', SPECS)
def test_onepass_plain_matches_make_fused(blocks, spec):
    Xe, Xf, ve, vf, c, w = blocks
    a_mode, b_mode = spec.split(':')
    with pltpu.force_tpu_interpret_mode():
        ref = jax_harness.make_fused(a_mode, b_mode, BUDGET)(
            *map(jnp.asarray, blocks))
    assert jax_harness.plan(N, [(PE, jnp.int8), (PF, jnp.float32)],
                            BUDGET)[:2] == (32, 4)
    t = [torch.from_numpy(x) for x in (ve, vf, c, w)]
    got = ne_onepass(_stored(Xe), _stored(Xf), t[0], t[1], t[2], t[3],
                     *map_spec(spec))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_map_spec():
    assert map_spec('wide:mxu2') == ('fma', 'mma2', False)
    assert map_spec('mxu2as:mxuf') == ('mma2', 'mma3', True)
    assert map_spec('mxu1a:fold8') == ('mma1', 'fma', False)
    with pytest.raises(ValueError, match='spec'):
        map_spec('mxu9:v1')


def test_onepass_split_models_bf16_terms(blocks):
    """The tensor-core modes carry v and u through bf16 terms: mma1's
    lossy v moves t by about bf16 rounding, mma2 / mma3 keep float32."""
    Xe, Xf, ve, vf, c, w = (torch.from_numpy(x) for x in blocks)
    Xe, Xf = _stored(blocks[0]), _stored(blocks[1])
    exact = ne_onepass_plain(Xe, Xf, ve, vf, c, w)
    lossy = ne_onepass_plain(Xe, Xf, ve, vf, c, w, 'mma1', 'fma')
    split = ne_onepass_plain(Xe, Xf, ve, vf, c, w, 'mma2', 'mma3')
    err = (lossy[2] - exact[2]).abs().max() / exact[2].abs().max()
    assert 1e-5 < err < 1e-2
    _close(split[2].numpy(), exact[2].numpy())
    _close(split[0].numpy(), exact[0].numpy())


@pytest.mark.parametrize('kind', ['i32', 'cvt', 'mul'])
def test_stream_probe_plain_matches_make_probe(kind):
    rng = np.random.default_rng(1)
    X8 = rng.integers(-128, 128, size=(96, 4096)).astype(np.int8)
    seed = 3.0
    if kind == 'i32':
        Xj = jax.lax.bitcast_convert_type(
            jnp.asarray(X8).reshape(96, 1024, 4), jnp.int32)
        Xt = torch.from_numpy(X8).view(torch.int32)
    else:
        Xj, Xt = jnp.asarray(X8), torch.from_numpy(X8)
    # x64 off, as on the TPU: the i32 probe's row sums then wrap in int32.
    with pltpu.force_tpu_interpret_mode(), jax.enable_x64(False):
        ref = float(jax_harness.make_probe(kind, 4 << 20)(Xj, seed))
    got = float(stream_probe(Xt, seed, kind))
    # i32: the wrapped row sums agree exactly; their float32 total is
    # summed in another order (rows up to 2**31 each).
    scale = 96 * 2.0 ** 31 if kind == 'i32' else abs(ref)
    assert abs(got - ref) <= 1e-6 * scale
    if kind != 'i32':  # v is zeros, as in the TPU probe
        assert got == pytest.approx(
            (X8.astype(np.float64).sum() if kind == 'cvt' else 0.0)
            + 128 * 96 * seed, rel=1e-6)


def test_stream_probe_plain_wraps_like_int32():
    X = torch.full((3, 4), 2 ** 30, dtype=torch.int32)
    got = stream_probe_plain(X, torch.tensor(-1.7), 'i32')
    # Each row: 4 * 2**30 wraps to 0, then 128 * trunc(-1.7) = -128.
    assert float(got) == 3 * -128.0


@pytest.mark.parametrize('kind', ['fused', 'mrhs', 'mrhs_sq', 'seq4',
                                  'mrhs_hi'])
def test_presolve_kinds_match_make_presolve(kind):
    rng = np.random.default_rng(2)
    n, pe, pf = 120, 700, 90
    Xe = (rng.random((n, pe)) < .5).astype(np.int8)
    Xf = rng.standard_normal((n, pf)).astype(np.float32)
    u1, u2, u4 = rng.standard_normal((3, n)).astype(np.float32)
    u3 = (rng.random(n) + .1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_harness.make_presolve(kind)(
            jnp.asarray(Xe), jnp.asarray(Xf), jnp.asarray(Xf * Xf),
            jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(u3))
    Xf_t = _stored(Xf)
    got = harness.presolve_fn(kind)(
        _stored(Xe), Xf_t, Xf_t * Xf_t, pe, pf,
        *(torch.from_numpy(u) for u in (u1, u2, u3, u4)))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_harness_cli_on_cpu(capsys):
    """The three modes end to end at a tiny size: every one-read variant
    agrees with the composed pair."""
    args = ['--device', 'cpu', '--n', '70', '--pe', '200', '--pf', '37',
            '--reps', '1', '--chain', '2', '--budget', '2']
    assert harness.main(args) == 0
    out = capsys.readouterr().out
    rows = [ln.split() for ln in out.splitlines()
            if ln.split() and ln.split()[0] in
            ['composed', 'ne_sweep', 'ne_oneread']
            + harness.DEFAULT_VARIANTS.split(',')]
    assert len(rows) == 9
    assert all(float(r[-1]) < 1e-5 for r in rows), out
    assert harness.main(args + ['--probe', '--probe-gb', '1e-4']) == 0
    assert harness.main(args + ['--presolve']) == 0
    out = capsys.readouterr().out
    assert all(kind in out for kind in ('i32', 'cvt', 'mul', 'mrhs_sq',
                                        'seq4'))


def test_run_main_records(blocks):
    recs = harness.run_main(64, 100, 20, ['wide:mxu2'], chain=1, reps=1,
                            budget_kib=1, device=torch.device('cpu'),
                            log=lambda *a: None)
    assert [r['name'] for r in recs] == ['composed', 'ne_sweep',
                                         'ne_oneread', 'wide:mxu2']
    assert [r['reads'] for r in recs] == [2, 2, 1, 1]
    assert recs[3]['modes'] == ('fma', 'mma2', False)


def test_ablation_copies_cut_their_part():
    from bayesbridge_tpu_torch.baselines import onepass_ablation as ab
    v = ab.variants()
    assert set(v) == {'base', 'noA', 'noB', 'noAB', 'nosync', 'nostage'}
    assert ab._A not in v['noA'] and ab._B in v['noA']
    assert ab._B not in v['noB'] and ab._A in v['noB']
    assert ab._A not in v['noAB'] and ab._B not in v['noAB']
    assert ab._SYNC not in v['nosync'] and ab._REMOTE not in v['nosync']
    assert ab._STAGE not in v['nostage'] and ab._WAIT not in v['nostage']
    assert all(ab._FIT in src for src in v.values())
