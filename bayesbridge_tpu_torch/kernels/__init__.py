"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterparts of the Pallas kernels of ``bayesbridge_tpu/design/``
(``fusedne.py``, ``bitlut.py``, ``winell.py``) and of the sweep A/B
harness ``baselines/dev_ne_variants.py``. One dispatch point
per kernel: each wrapper launches its CUDA kernel for CUDA tensors and
runs its plain version (beside it in the same module) for CPU tensors;
no call site branches on the device. ``REGISTRY`` names each kernel's
source and the TPU kernel it replaces, for the chip smoke's report.
"""

from . import bitlut as _bl
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
}


def launch_counts():
    """{'ne_sweep[ne]': k, ..., 'ne_sweep[rows]': ..., 'ne_sweep[cols]':
    ..., 'tdots_sweep': ..., 'tdots_sweep[u4]': ..., 'bitlut[dot]': ...,
    'winell[tdot]': ..., 'wincsr[dot]': ..., 'ne_onepass': ...,
    'ne_oneread': ... (the CG operator), 'ne_oneread[logit]': ...,
    'ne_oneread[linear]': ..., 'stream_probe[i32]': ...}."""
    counts = {f'ne_sweep[{key}]': k for key, k in _ne.launches.items()}
    counts['tdots_sweep'] = _td.launches['tdots']
    counts['tdots_sweep[u4]'] = _td.launches['u4']
    for name, mod in (('bitlut', _bl), ('winell', _we), ('wincsr', _wc),
                      ('stream_probe', _sp)):
        counts.update({f'{name}[{tag}]': k
                       for tag, k in mod.launches.items()})
    counts['ne_onepass'] = _op.launches['onepass']
    counts['ne_oneread'] = _or.launches['ne']
    counts.update({f'ne_oneread[{mid}]': _or.launches[mid]
                   for mid in ('logit', 'linear')})
    return counts


def reset_launch_counts():
    for counter in (_ne.launches, _td.launches, _bl.launches, _we.launches,
                    _wc.launches, _op.launches, _or.launches, _sp.launches):
        for key in counter:
            counter[key] = 0


__all__ = ['load_library', 'launch_counts', 'reset_launch_counts',
           'REGISTRY']
