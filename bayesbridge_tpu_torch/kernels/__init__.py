"""Hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of ``bayesbridge_tpu/design/fusedne.py``. One dispatch point
per kernel: each wrapper launches its CUDA kernel for CUDA tensors and
runs its plain version (beside it in the same module) for CPU tensors;
no call site branches on the device. ``REGISTRY`` names each kernel's
source and the TPU kernel it replaces, for the chip smoke's report.
"""

from . import ne_sweep as _ne
from . import tdots_sweep as _td
from .build import load_library

REGISTRY = {
    'ne_sweep': dict(source='bayesbridge_tpu_torch/csrc/ne_sweep.cu',
                     replaces='bayesbridge_tpu/design/fusedne.py:136'),
    'tdots_sweep': dict(source='bayesbridge_tpu_torch/csrc/tdots_sweep.cu',
                        replaces='bayesbridge_tpu/design/fusedne.py:312'),
}


def launch_counts():
    """{'ne_sweep[ne]': k, 'ne_sweep[logit]': ..., 'tdots_sweep': ...}."""
    counts = {f'ne_sweep[{mid}]': k for mid, k in _ne.launches.items()}
    counts['tdots_sweep'] = _td.launches['tdots']
    return counts


def reset_launch_counts():
    for counter in (_ne.launches, _td.launches):
        for key in counter:
            counter[key] = 0


__all__ = ['load_library', 'launch_counts', 'reset_launch_counts',
           'REGISTRY']
