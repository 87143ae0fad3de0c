"""The torch port stands alone: importing it (the sweep A/B harness
included) pulls in no JAX, its sources name neither jax nor the JAX
package nor its ``baselines``, and an explicit CUDA
request without a usable GPU raises instead of moving to the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bayesbridge_tpu_torch
from bayesbridge_tpu_torch import RegressionModel
from bayesbridge_tpu_torch.kernels import build
from bayesbridge_tpu_torch.kernels.ne_sweep import ne_sweep
from bayesbridge_tpu_torch.utils.dtypes import resolve_device
from bayesbridge_tpu_torch.utils.simulate_data import (
    simulate_design, simulate_outcome,
)

PKG = pathlib.Path(bayesbridge_tpu_torch.__file__).parent
REPO = PKG.parent


def test_import_pulls_in_no_jax():
    code = ("import sys, bayesbridge_tpu_torch, bayesbridge_tpu_torch.convert;"
            "import bayesbridge_tpu_torch.kernels;"
            "import bayesbridge_tpu_torch.design.fusedne;"
            "import bayesbridge_tpu_torch.design.sharded;"
            "import bayesbridge_tpu_torch.parallel;"
            "import bayesbridge_tpu_torch.parallel.distributed;"
            "import bayesbridge_tpu_torch.kernels.ne_onepass;"
            "import bayesbridge_tpu_torch.kernels.stream_probe;"
            "import bayesbridge_tpu_torch.baselines.dev_ne_variants;"
            "import bayesbridge_tpu_torch.baselines.onepass_ablation;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'bayesbridge_tpu.', 'baselines'))"
            " or m == 'bayesbridge_tpu'];"
            "assert not bad, bad")
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO,
                   timeout=120)


def test_sources_do_not_import_jax():
    pattern = re.compile(r'^\s*(import jax|from jax|import bayesbridge_tpu\b'
                         r'|from bayesbridge_tpu\b(?!_torch)'
                         r'|import baselines|from baselines)', re.M)
    files = list(PKG.rglob('*.py')) + [REPO / 'chip_smoke.py']
    hits = [str(f) for f in files if pattern.search(f.read_text())]
    assert not hits, hits


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device('cuda')
    X = simulate_design(30, 6, binary_frac=.5, seed=0)
    outcome = simulate_outcome(X, np.ones(6), 'logit', seed=1)
    with pytest.raises(RuntimeError, match='is_available'):
        RegressionModel(outcome, X, family='logit')  # device='cuda'
    with pytest.raises(RuntimeError, match='is_available'):
        RegressionModel(outcome, X, family='logit', device='cuda')


def test_cpu_tensors_never_build_kernels(monkeypatch):
    """The plain version serves CPU tensors without touching nvcc."""
    def refuse():
        raise AssertionError("kernel build attempted for CPU tensors")
    monkeypatch.setattr(build, 'load_library', refuse)
    X = torch.ones((4, 16), dtype=torch.int8)
    outs, u, _ = ne_sweep([(X, torch.ones(16))], torch.tensor(0.), None,
                          torch.ones(4), 'ne')
    assert torch.equal(u, torch.full((4,), 16.0))


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises (no silent fallback)."""
    monkeypatch.setattr(build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(build.os.path, 'exists', lambda path: False)
    with pytest.raises(RuntimeError, match='nvcc'):
        build._nvcc()
