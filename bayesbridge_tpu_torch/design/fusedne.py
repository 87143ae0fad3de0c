"""The hybrid backend's fused-sweep policy.

Port of ``bayesbridge_tpu/design/fusedne.py`` ``dispatch_mode`` (the
policy only; the sweeps themselves are :mod:`..kernels.ne_sweep` and
:mod:`..kernels.tdots_sweep`). A call site of the hybrid design is one
of three kinds:

``'quad'``
    the CG operator X'(w * (X v)): fused = one ``ne_sweep`` (on the card
    the one-read kernel); composed = the row pass ``X v`` and the column
    pass ``X' u`` (block-ordered CG, the linear predictor accumulated in
    the CG loop).
``'presolve'``
    the pre-solve reductions: fused = one ``tdots_sweep`` of
    ``X'[u1 u2 u3]`` plus the squared moment, the warm start's residual
    by a separate operator application; composed = one ``tdots_sweep``
    that also carries the warm-start column ``X' u4``.
``'link'``
    the GLM loglik and gradient of the MAP search: fused = one
    ``ne_sweep`` in its link mode (on the card the one-read kernel);
    composed = ``dot`` then ``Tdot``.

Policies: ``'0'`` composes every kind; ``'1'`` and ``'full'`` fuse every
kind (on CPU tensors the sweeps run their plain versions; the port has no
interpret mode to distinguish); ``'auto'`` takes the per-kind choice of
``AUTO``. ``None`` reads ``BB_FUSED_NE``, default ``'auto'``.

``AUTO`` composes the CG operator and the pre-solve, as the JAX package
does, and fuses the MAP search's objective, from H100 80GB HBM3
measurements at 700 W at the flagship (``PERF.md`` §6,
``chip_smoke.py``):

- 'quad': the one-read kernel (``kernels.ne_oneread``) takes 2.85-3.14
  ms against the composed pair's 4.39-4.94, and the fused slice took
  58.76-59.61 device ms per iteration against 75.06-78.14; but it runs
  one operator application more per step and a row pass for the linear
  predictor, and the alternating A/B segments did not favour it in
  every call (median iter/s fused minus composed +2.3%, +6.9%, -3.6%,
  then +9.2% over 8 rounds). Fusing needs both, lower device time and a
  higher A/B median; with one call of four against, it waits for a
  second 8-round call to repeat the last one;
- 'presolve': five reductions in one read plus the warm start's row pass
  (3.004 + 2.259 ms) against four plus a one-read operator application
  (3.245 + 2.940 ms);
- 'link': fused on the one-read kernel, which computes the logit score,
  its log-likelihood sum and X' u from one read of X: 2.968 ms against
  the two-pass link sweep's 4.696 and 3.079 against the composed
  objective's 4.832 (row pass, loglik rows, column pass), each timed in
  turns at the flagship blocks; at the hybrid design the whole objective
  took 3.586 ms fused against 5.192 composed, and the MAP searches with
  either objective ended within 7.6e-5 of each other (relative), their
  log-likelihoods within 3e-7 (relative). Fusing needs the one-read call
  faster in every full smoke run and that witness; the two-pass link
  sweep (4.846 ms) had tied the composed objective (4.861).
"""

import os

KINDS = ('quad', 'presolve', 'link')
POLICIES = (None, 'auto', 'full', '1', '0')
# Fused (True) or composed (False) per kind under 'auto'.
AUTO = {'quad': False, 'presolve': False, 'link': True}


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
