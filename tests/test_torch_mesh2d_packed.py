"""The 2-d obs x pred mesh's products on the packed backends (bitpack,
whose bitmaps split over ``pred`` at whole byte-groups, and winell,
which shards over ``obs`` only and warns), centred and not, with and
without intercept, on (4, 2) and (2, 4), against the JAX package's 2-d
sharded design: the cases of tests/test_torch_mesh2d.py's product test,
in a file of their own because the JAX package shards these designs
slowest.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh2d import cases, check_2d_case

# One intra-op thread: the suite runs in several worker processes, and a
# torch thread pool in each would oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize(
    'backend,dtype,int4,centered,intercept,grid',
    cases([('bitpack', np.float32, False), ('winell', np.float32, False)]))
def test_2d_packed_products_match_jax_2d_design(monkeypatch, backend, dtype,
                                                int4, centered, intercept,
                                                grid):
    check_2d_case(monkeypatch, backend, dtype, int4, centered, intercept,
                  grid)
