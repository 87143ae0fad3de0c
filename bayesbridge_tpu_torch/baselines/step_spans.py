"""Run a tree's chip smoke with the Gibbs step's phases in profiler spans,
and print each profiler window's split of host and device time between
the CG solve and the rest of the step.

    python bayesbridge_tpu_torch/baselines/step_spans.py [--tree DIR]
        [--slices bitpack,winell,ell]

runs ``DIR/chip_smoke.py`` (default: this checkout) on the card with
``DIR``'s ``bayesbridge_tpu_torch`` (run it as a file, not with ``-m``,
so that the package is imported from ``DIR``, for example an earlier
commit unpacked with ``git archive`` into an ignored directory). Where
that package's step has no spans of its own (before
``utils.profiling.span_stats`` existed), ``step.gibbs_step_chains`` is
wrapped in a ``gibbs:step`` span and ``ops.reg_coef``'s call of
``sample_gaussian_cg_chains`` in a ``gibbs:cg_solve`` span. After every
profiler window the smoke reads (``utils.profiling.op_stats_from_trace``)
a line ``[spans] {...}`` gives each span's count, host wall ms and device
ms (the device work launched inside it; :func:`span_stats` of this
file's tree), just before the smoke's own line for that window.
``--slices`` runs only those slices of the smoke, each as the smoke
runs it (``run_packed`` for bitpack and winell, ``run_ell`` for ell:
its float64 chain and 4 chains, then float32), on their data.
"""

import argparse
import importlib.util
import json
import os
import runpy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _this_trees_profiling():
    """This checkout's utils/profiling.py, loaded on its own."""
    path = HERE / 'bayesbridge_tpu_torch' / 'utils' / 'profiling.py'
    spec = importlib.util.spec_from_file_location('_bb_spans_profiling',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wrap(mod, name, label):
    from torch.profiler import record_function
    fn = getattr(mod, name)

    def spanned(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    setattr(mod, name, spanned)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=str(HERE),
                    help='the checkout whose chip_smoke.py and package run')
    ap.add_argument('--slices', default=None,
                    help='comma-separated: run only these of bitpack, '
                         'winell and ell')
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    spans = _this_trees_profiling()
    import bayesbridge_tpu_torch.step as step_mod
    import bayesbridge_tpu_torch.ops.reg_coef as reg_coef
    import bayesbridge_tpu_torch.utils.profiling as prof
    assert Path(step_mod.__file__).resolve().is_relative_to(tree)
    if not hasattr(prof, 'span_stats'):
        _wrap(step_mod, 'gibbs_step_chains', 'gibbs:step')
        _wrap(reg_coef, 'sample_gaussian_cg_chains', 'gibbs:cg_solve')
    read = prof.op_stats_from_trace

    def read_and_split(log_dir, device_only=True):
        rows = read(log_dir, device_only)
        print('[spans] ' + json.dumps(spans.span_stats(log_dir, 'gibbs:')),
              flush=True)
        return rows
    prof.op_stats_from_trace = read_and_split
    sys.argv = [str(tree / 'chip_smoke.py')]
    if args.slices is None:
        runpy.run_path(str(tree / 'chip_smoke.py'), run_name='__main__')
    else:
        _slices(tree, args.slices.split(','))


def _slices(tree, names):
    """The smoke's bitpack, winell and ell slices alone, in its order."""
    import torch
    from bayesbridge_tpu_torch.kernels import load_library
    unknown = set(names) - {'bitpack', 'winell', 'ell'}
    if unknown:
        raise ValueError(f"no slice {sorted(unknown)}")
    spec = importlib.util.spec_from_file_location('tree_chip_smoke',
                                                  tree / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        raise SystemExit("step_spans: no CUDA device")
    print(smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    m2d = {'counts': {}, 'results': {}, 'summary': {}}
    if 'bitpack' in names:
        smoke.run_packed(*smoke.build_data(), 'bitpack', m2d)
    if 'winell' in names:
        smoke.run_packed(*smoke.build_normal_data(smoke.WINELL_N), 'winell',
                         m2d)
    if 'ell' in names:
        smoke.run_ell(*smoke.build_normal_data(smoke.ELL_N), m2d)


if __name__ == '__main__':
    main()
