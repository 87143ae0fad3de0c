"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterparts of the Pallas kernels of ``bayesbridge_tpu/design/``
(``fusedne.py``, ``bitlut.py``, ``winell.py``). One dispatch point
per kernel: each wrapper launches its CUDA kernel for CUDA tensors and
runs its plain version (beside it in the same module) for CPU tensors;
no call site branches on the device. ``REGISTRY`` names each kernel's
source and the TPU kernel it replaces, for the chip smoke's report.
"""

from . import bitlut as _bl
from . import ne_sweep as _ne
from . import tdots_sweep as _td
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
}


def launch_counts():
    """{'ne_sweep[ne]': k, 'ne_sweep[logit]': ..., 'tdots_sweep': ...,
    'bitlut[dot]': ..., 'bitlut[tdot]': ..., 'winell[dot]': ...,
    'winell[tdot]': ...}."""
    counts = {f'ne_sweep[{mid}]': k for mid, k in _ne.launches.items()}
    counts['tdots_sweep'] = _td.launches['tdots']
    for name, mod in (('bitlut', _bl), ('winell', _we)):
        counts.update({f'{name}[{tag}]': k
                       for tag, k in mod.launches.items()})
    return counts


def reset_launch_counts():
    for counter in (_ne.launches, _td.launches, _bl.launches, _we.launches):
        for key in counter:
            counter[key] = 0


__all__ = ['load_library', 'launch_counts', 'reset_launch_counts',
           'REGISTRY']
