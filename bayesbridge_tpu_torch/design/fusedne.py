"""The hybrid backend's fused-sweep policy.

Port of ``bayesbridge_tpu/design/fusedne.py`` ``dispatch_mode`` (the
policy only; the sweeps themselves are :mod:`..kernels.ne_sweep` and
:mod:`..kernels.tdots_sweep`). A call site of the hybrid design is one
of three kinds:

``'quad'``
    the CG operator X'(w * (X v)): fused = one ``ne_sweep``; composed =
    the row pass ``X v`` and the column pass ``X' u`` (block-ordered CG,
    the linear predictor accumulated in the CG loop).
``'presolve'``
    the pre-solve reductions: fused = one ``tdots_sweep`` of
    ``X'[u1 u2 u3]`` plus the squared moment, the warm start's residual
    by a separate operator application; composed = one ``tdots_sweep``
    that also carries the warm-start column ``X' u4``.
``'link'``
    the GLM loglik and gradient of the MAP search: fused = one
    ``ne_sweep`` in its link mode; composed = ``dot`` then ``Tdot``.

Policies: ``'0'`` composes every kind; ``'1'`` and ``'full'`` fuse every
kind (on CPU tensors the sweeps run their plain versions; the port has no
interpret mode to distinguish); ``'auto'`` takes the per-kind choice of
``AUTO``. ``None`` reads ``BB_FUSED_NE``, default ``'auto'``.

``AUTO`` composes every kind, as the JAX package does, from H100 80GB
HBM3 measurements at the flagship (``PERF.md`` §6, ``chip_smoke.py`` and
the sweep A/B harness):

- 'quad': the composed pair takes what the fused sweep takes (4.568 vs
  4.604 ms; ``ne_sweep`` is the same row and column kernels), and per
  Gibbs step the composed path reads X 2k + 2 times against 2k + 4 (233
  vs 247 ms of device time per 3 iterations);
- 'presolve': five reductions in one read plus the warm start's row pass
  (3.098 + 2.375 ms) against four plus a fused operator application
  (3.344 + 4.965 ms);
- 'link': 4.842-5.189 vs 4.857-5.153 ms, a tie.

The one-read sweep (``kernels.ne_onepass``, 4.87-5.33 ms) does not beat
the composed pair yet; revisit when it does.
"""

import os

KINDS = ('quad', 'presolve', 'link')
POLICIES = (None, 'auto', 'full', '1', '0')
# Fused (True) or composed (False) per kind under 'auto'.
AUTO = {'quad': False, 'presolve': False, 'link': False}


def dispatch_mode(kind='quad', policy=None):
    """True where the fused sweep serves the `kind` call site under
    `policy`, else None (the composed path)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    mode = policy if policy is not None \
        else os.environ.get('BB_FUSED_NE', 'auto')
    if mode not in POLICIES:
        raise ValueError(f"unknown fused policy {mode!r}")
    if mode == '0':
        return None
    if mode in ('1', 'full'):
        return True
    return True if AUTO[kind] else None
