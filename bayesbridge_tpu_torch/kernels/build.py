"""Build and load the hand-written CUDA kernels.

The sources under ``bayesbridge_tpu_torch/csrc/`` have a plain C
interface. Each is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library loaded with
ctypes (no PyTorch headers, so the build takes seconds). The build
runs on first use, on the machine with the card, into
``bayesbridge_tpu_torch/_build/<hash>/`` where the hash covers the
sources and the compiler flags; a later call with the same sources
reuses the library. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG / '_build'
SOURCES = ('ne_oneread.cu', 'ne_sweep.cu', 'tdots_sweep.cu', 'bitlut.cu',
           'winell.cu', 'wincsr.cu', 'ne_onepass.cu', 'stream_probe.cu')
HEADERS = ('sweep_common.cuh', 'mbarrier.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    'bb_ne_sweep': [_I, _P, _L, _I, _P, _I, _P, _L, _I, _P, _L, _P, _I,
                    _P, _P, _I, _I, _P, _I, _L, _P, _P, _P, _P, _P],
    'bb_ne_rows': [_I, _P, _L, _I, _P, _I, _P, _L, _I, _P, _L, _P, _I, _P,
                   _P],
    'bb_colpass': [_I, _P, _L, _I, _I, _P, _L, _I, _L, _P, _I, _L, _P, _P,
                   _P],
    'bb_tdots_sweep': [_I, _P, _L, _I, _I, _P, _L, _I, _L, _P, _P, _P, _P,
                       _I, _L, _P, _P, _P],
    'bb_bitlut': [_P, _L, _L, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    'bb_winell': [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                  _P],
    'bb_wincsr': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    'bb_ne_oneread': [_I, _P, _L, _I, _P, _I, _P, _L, _I, _P, _L, _P, _I,
                      _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P],
    'bb_ne_oneread_fit': [_I, _I, _I, _I, _I, _I],
    'bb_ne_onepass': [_P, _L, _I, _P, _L, _I, _P, _P, _P, _P, _L, _I, _I,
                      _I, _I, _I, _I, _I, _P, _P, _P, _P],
    'bb_stream_probe': [_P, _L, _L, _I, _P, _P, _P, _P, _I, _P],
    'bb_rows_per_block': [],
}


class KernelLibrary:
    """The loaded shared library and how it was obtained."""

    def __init__(self, lib, path, build_seconds, ptxas_log):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self.rows_per_block = lib.bb_rows_per_block()

    def check(self, rc, name):
        """Raise if a C entry returned a CUDA error."""
        if rc != 0:
            msg = self.lib.bb_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_LOADED = None  # the process's one KernelLibrary, built on first use


def _nvcc():
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return nvcc


def _source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; (stdout+stderr of each, failed)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    return logs, any(p.returncode != 0 for p in procs)


def _compile_and_link(out_dir, so_path):
    """One nvcc per source, all at once, then one link. Builds into
    private names and renames at the end, so a concurrent build never
    loads a half-written library. Returns the compiler log."""
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [tmp / (Path(src).stem + '.o') for src in SOURCES]
        logs, failed = _run_all(
            [[_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-c', '-o', str(o),
              str(CSRC / src)] for src, o in zip(SOURCES, objs)])
        log = ''.join(logs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + log)
        so_tmp = tmp / so_path.name
        link = subprocess.run(
            [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-shared',
             '-o', str(so_tmp), *map(str, objs)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + log)
        os.replace(so_tmp, so_path)
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library():
    """Build (once per source hash) and load the kernel library."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    out_dir = BUILD_ROOT / _source_hash()
    so_path = out_dir / 'libbb_sweeps.so'
    log = ''
    t0 = time.perf_counter()
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        log = _compile_and_link(out_dir, so_path)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bb_error_string.argtypes = [ctypes.c_int]
    lib.bb_error_string.restype = ctypes.c_char_p
    lib.bb_ne_onepass_smem.argtypes = [_I, _I, _I, _I]
    lib.bb_ne_onepass_smem.restype = ctypes.c_longlong
    _LOADED = KernelLibrary(lib, so_path, build_seconds, log)
    return _LOADED
