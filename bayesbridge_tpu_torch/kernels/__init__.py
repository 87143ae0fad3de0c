"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterparts of the Pallas kernels of ``bayesbridge_tpu/design/``
(``fusedne.py``, ``bitlut.py``, ``winell.py``) and of the sweep A/B
harness ``baselines/dev_ne_variants.py``, the ell backend's gather
product, which the JAX package left to XLA, and the device loops that
it runs on the TPU: the Polya-Gamma and tilted-stable rejection loops
(:mod:`.draws`) and the CG solve's (:mod:`.cg_loop`); and the Gibbs
chain's runner, one captured step an iteration (:mod:`.step_graph`,
no kernel of its own). One dispatch point
per kernel: each wrapper launches its CUDA kernel for CUDA tensors and
runs its plain version (beside it in the same module) for CPU tensors;
no call site branches on the device. ``REGISTRY`` names each kernel's
source and the TPU kernel it replaces, for the chip smoke's report.
"""

from . import bitlut as _bl
from . import cg_loop as _cg
from . import draws as _dr
from . import ell as _el
from . import ne_onepass as _op
from . import ne_oneread as _or
from . import ne_sweep as _ne
from . import stream_probe as _sp
from . import tdots_sweep as _td
from . import wincsr as _wc
from . import winell as _we
from .build import load_library

REGISTRY = {
    'ne_sweep': dict(source='bayesbridge_tpu_torch/csrc/ne_sweep.cu',
                     replaces='bayesbridge_tpu/design/fusedne.py:136'),
    'tdots_sweep': dict(source='bayesbridge_tpu_torch/csrc/tdots_sweep.cu',
                        replaces='bayesbridge_tpu/design/fusedne.py:312'),
    # The chain-batched forms (jax.vmap of the same Pallas kernels over
    # the chains of bayesbridge_tpu/multichain.py).
    'ne_rows_k': dict(source='bayesbridge_tpu_torch/csrc/ne_sweep.cu',
                      replaces='bayesbridge_tpu/design/fusedne.py:136'),
    'colpass_k': dict(source='bayesbridge_tpu_torch/csrc/sweep_common.cuh',
                      replaces='bayesbridge_tpu/design/fusedne.py:136'),
    'tdots_sweep_k': dict(source='bayesbridge_tpu_torch/csrc/tdots_sweep.cu',
                          replaces='bayesbridge_tpu/design/fusedne.py:312'),
    'bitlut': dict(source='bayesbridge_tpu_torch/csrc/bitlut.cu',
                   replaces='bayesbridge_tpu/design/bitlut.py:83'),
    'winell': dict(source='bayesbridge_tpu_torch/csrc/winell.cu',
                   replaces='bayesbridge_tpu/design/winell.py:149'),
    'wincsr': dict(source='bayesbridge_tpu_torch/csrc/wincsr.cu',
                   replaces='bayesbridge_tpu/design/winell.py:149'),
    'ne_oneread': dict(source='bayesbridge_tpu_torch/csrc/ne_oneread.cu',
                       replaces='bayesbridge_tpu/design/fusedne.py:136'),
    'ne_onepass': dict(source='bayesbridge_tpu_torch/csrc/ne_onepass.cu',
                       replaces='baselines/dev_ne_variants.py:302'),
    'stream_probe': dict(source='bayesbridge_tpu_torch/csrc/stream_probe.cu',
                         replaces='baselines/dev_ne_variants.py:393'),
    # No Pallas kernel: the nibble modes of the row pass, the column pass
    # and the pre-solve over the hybrid design's packed int4 block, which
    # replace the XLA dots over the JAX design's packed-s4 block.
    'ne_rows_i4': dict(source='bayesbridge_tpu_torch/csrc/ne_sweep.cu',
                       replaces='bayesbridge_tpu/design/sparse.py:991'),
    'colpass_i4': dict(source='bayesbridge_tpu_torch/csrc/sweep_common.cuh',
                       replaces='bayesbridge_tpu/design/sparse.py:1020'),
    'tdots_i4': dict(source='bayesbridge_tpu_torch/csrc/tdots_sweep.cu',
                     replaces='bayesbridge_tpu/design/sparse.py:1356'),
    # No Pallas kernel: the XLA gathers of the ell backend. Every
    # traversal of csrc/ell.cu: ell[dot] and ell[tdot] the first,
    # ell[tdot_win] the col-ELL's windowed one, ell[dot_st] and
    # ell[tdot_st] the staged one.
    'ell': dict(source='bayesbridge_tpu_torch/csrc/ell.cu',
                replaces='bayesbridge_tpu/design/sparse.py:1006'),
    # No Pallas kernel: the device loops of the two rejection samplers
    # (lax.while_loops under jit, run_rejection at rejection.py:76).
    'pg_draw': dict(source='bayesbridge_tpu_torch/csrc/polya_gamma.cu',
                    replaces='bayesbridge_tpu/random/polya_gamma.py:225'),
    # ts_draw: the sweep design (T threads a lane); ts_draw[first]: the
    # first design (one thread a lane), off the path.
    'ts_draw': dict(source='bayesbridge_tpu_torch/csrc/tilted_stable.cu',
                    replaces='bayesbridge_tpu/random/tilted_stable.py:311'),
    # No Pallas kernel: the CG solve's lax.while_loop (ops/cg.py:196 and
    # :209), its vector updates as cg_start and cg_update, looped on the
    # card as one CUDA graph. cg_update: one cluster kernel an iteration
    # (cg_iter); cg_update[three]: the first design's three kernels, the
    # route for vectors longer than cg_iter takes.
    'cg_start': dict(source='bayesbridge_tpu_torch/csrc/cg_loop.cu',
                     replaces='bayesbridge_tpu/ops/cg.py:196'),
    'cg_update': dict(source='bayesbridge_tpu_torch/csrc/cg_loop.cu',
                      replaces='bayesbridge_tpu/ops/cg.py:196'),
}


def launch_counts():
    """{'ne_sweep[ne]': k, ..., 'ne_sweep[rows]': ..., 'ne_sweep[cols]':
    ..., 'tdots_sweep': ..., 'tdots_sweep[u4]': ..., the chain-batched
    'ne_rows_k', 'colpass_k', 'tdots_sweep_k' and 'tdots_sweep_k[u4]'
    (launches of k >= 2 chains; k = 1 counts as the single-vector
    kernel), 'bitlut[dot]': ...,
    'winell[tdot]': ..., 'wincsr[dot]': ..., 'ell[dot]': ...,
    'ell[tdot]': ..., 'ell[tdot_win]': ..., 'ell[dot_st]': ...,
    'ell[tdot_st]': ..., 'ne_onepass': ...,
    'ne_oneread': ... (the CG operator), 'ne_oneread[logit]': ...,
    'ne_oneread[linear]': ..., 'stream_probe[i32]': ..., and the
    nibble modes over a packed int4 block: 'ne_rows_i4', 'colpass_i4',
    'tdots_i4', 'tdots_i4[u4]', their binary modes 'tdots_i4[bin]' and
    'tdots_i4[u4,bin]' (single-vector launches), and their '...[chains]'
    counts ('tdots_i4[u4,bin,chains]': one single launch per chain of a
    chain batch, which has no nibble mode), the draws 'pg_draw' and
    'ts_draw' (the sweep design) and 'ts_draw[first]' (the first
    design), and the CG loop's 'cg_start', 'cg_update' (one launch of
    the one-kernel update, an iteration) and 'cg_update[three]' (one
    call of the three-kernel route, an iteration)}."""
    counts = {f'ne_sweep[{key}]': k for key, k in _ne.launches.items()
              if not key.endswith('_k') and 'i4' not in key}
    for name, key in (('ne_rows_i4', 'rows_i4'), ('colpass_i4', 'cols_i4')):
        counts[name] = _ne.launches[key]
        counts[f'{name}[chains]'] = _ne.launches[key + '_k']
    for name, key in (('tdots_i4', 'i4'), ('tdots_i4[u4]', 'u4_i4'),
                      ('tdots_i4[bin]', 'i4_bin'),
                      ('tdots_i4[u4,bin]', 'u4_i4_bin'),
                      ('tdots_i4[chains]', 'i4_k'),
                      ('tdots_i4[u4,chains]', 'u4_i4_k'),
                      ('tdots_i4[bin,chains]', 'i4_bin_k'),
                      ('tdots_i4[u4,bin,chains]', 'u4_i4_bin_k')):
        counts[name] = _td.launches[key]
    counts['ne_rows_k'] = _ne.launches['rows_k']
    counts['colpass_k'] = _ne.launches['cols_k']
    counts['tdots_sweep'] = _td.launches['tdots']
    counts['tdots_sweep[u4]'] = _td.launches['u4']
    counts['tdots_sweep_k'] = _td.launches['tdots_k']
    counts['tdots_sweep_k[u4]'] = _td.launches['u4_k']
    for name, mod in (('bitlut', _bl), ('winell', _we), ('wincsr', _wc),
                      ('ell', _el), ('stream_probe', _sp)):
        counts.update({f'{name}[{tag}]': k
                       for tag, k in mod.launches.items()})
    counts['pg_draw'] = _dr.launches['pg']
    counts['ts_draw'] = _dr.launches['ts']
    counts['ts_draw[first]'] = _dr.launches['ts_first']
    counts['cg_start'] = _cg.launches['start']
    counts['cg_update'] = _cg.launches['update']
    counts['cg_update[three]'] = _cg.launches['update_three']
    counts['ne_onepass'] = _op.launches['onepass']
    counts['ne_oneread'] = _or.launches['ne']
    counts.update({f'ne_oneread[{mid}]': _or.launches[mid]
                   for mid in ('logit', 'linear')})
    return counts


def reset_launch_counts():
    for counter in (_ne.launches, _td.launches, _bl.launches, _we.launches,
                    _wc.launches, _el.launches, _op.launches, _or.launches,
                    _sp.launches, _dr.launches, _cg.launches):
        for key in counter:
            counter[key] = 0


__all__ = ['load_library', 'launch_counts', 'reset_launch_counts',
           'REGISTRY']
