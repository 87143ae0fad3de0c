"""Whether ``ne_oneread`` gives the same bits run after run, by the number
of clusters launched.

At one shape (by default 20,000 rows of 9,001 int8 columns at 10%
density beside 999 float32 columns: a plan of four consumer warps, small
enough that two CTAs would share an SM but for the shared-memory floor of
a pair of blocks, ``csrc/ne_oneread.cu`` kPairMinSmem), runs the CG
operator ``--reps`` times on the same inputs with the clusters the card
holds at once, half as many and one, and prints for each count whether
the reruns gave the same bits and the largest and smallest max |error|
against a float64 reference, relative to max |X'u|. On the card:

    python -m bayesbridge_tpu_torch.baselines.oneread_reruns \\
        [--n N] [--pe PE] [--pf PF] [--reps R]
"""

import argparse

import torch

from ..kernels import layout, load_library
from ..kernels import ne_oneread as oneread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--n', type=int, default=20_000)
    ap.add_argument('--pe', type=int, default=9_001)
    ap.add_argument('--pf', type=int, default=999)
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("oneread_reruns: needs a CUDA device")
    dev = torch.device('cuda')
    kl = load_library()
    g = torch.Generator(device=dev).manual_seed(9)
    n, pe, pf = args.n, args.pe, args.pf
    Xe = (torch.rand((n, layout.padded_width(pe)), generator=g, device=dev)
          < 0.1).to(torch.int8)
    Xf = torch.randn((n, layout.padded_width(pf)), generator=g, device=dev)
    blocks = [(Xe, torch.randn(pe, generator=g, device=dev) * 0.01),
              (Xf, torch.randn(pf, generator=g, device=dev) * 0.01)]
    c = torch.zeros((), device=dev)
    w = torch.ones(n, device=dev)
    t = sum(X[:, :v.shape[0]].double() @ v.double() for X, v in blocks)
    ref = torch.cat([X[:, :v.shape[0]].double().T @ t for X, v in blocks])
    plan = oneread.block_plan(blocks)
    codes = (layout.DTYPE_CODE[Xe.dtype], layout.DTYPE_CODE[Xf.dtype])
    fit = oneread.fit_clusters(kl, codes, plan)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{torch.cuda.get_device_name(0)}; {n} x {pe} int8 + {pf} f32; "
          f"plan {plan}; {sms} SMs; {fit} clusters fit at once")
    for clusters in sorted({fit, max(1, fit // 2), 1}, reverse=True):
        runs = []
        for _ in range(args.reps):
            outs, _, _ = oneread._ne_oneread_cuda(blocks, c, None, w, 'ne',
                                                  False, plan, clusters)
            runs.append(torch.cat(outs))
        same = all(torch.equal(r, runs[0]) for r in runs[1:])
        errs = [float((r.double() - ref).abs().max() / ref.abs().max())
                for r in runs]
        print(f"  {clusters} clusters ({clusters * oneread.CLUSTER} CTAs), "
              f"{args.reps} runs: the same bits: {same}; max |error| / "
              f"max|X'u| {max(errs):.2e} worst, {min(errs):.2e} best")


if __name__ == '__main__':
    main()
