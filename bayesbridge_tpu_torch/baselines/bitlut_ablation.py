"""Where bitlut's time goes: the LUT product with parts cut out.

Times the modes of ``csrc/bitlut.cu`` on one bitmap, on the card, in
turns (each mode once in order, then once in reverse order; the mean of
the two medians):

``nibble``     the design's kernel: two 16-entry nibble tables per
               byte-group, built once per call by a pre-pass and staged
               into shared memory by bulk asynchronous copies;
``byte``       the first design's kernel: a 256-entry table per
               byte-group, rebuilt by every block for every output
               tile, lookups on random banks;
``nibble_l2``  the nibble tables read through L1/L2 by ``__ldg`` instead
               of staged (no producer work, no stage barriers);
``nolookup``   no lookups: the bytes loaded and summed, the staging kept
               (its results mean nothing, only its time).

``nibble`` minus ``nolookup`` is what the lookups cost; ``byte`` minus
``nibble`` what the bank conflicts and the per-tile table builds cost;
``nibble_l2`` against ``nibble`` whether the staging pays. Each mode's
time is the median of ``reps`` CUDA-event timings of 20 calls each.

Run with the design's bitmaps from ``chip_smoke.py``, or alone on random
bitmaps of the flagship's shapes (each bit set with probability
``--density``):

    python -m bayesbridge_tpu_torch.baselines.bitlut_ablation \\
        [--density D] [--reps R]
"""

import argparse
import statistics

import torch

from ..kernels.bitlut import MODES, bitlut, bitlut_variant

# The flagship bitpack design's two bitmaps (chip_smoke.py): (live
# byte-groups, padded groups, padded outputs, outputs).
FLAGSHIP = {'dot': (5626, 5632, 106_496, 100_000),
            'tdot': (12_500, 12_512, 49_152, 45_001)}
INNER = 20


def _median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def run(bits, v, n_out, reps=10, label='', log=print):
    """{mode: ms} of every mode on one bitmap, timed in turns (order,
    then reverse order); logged with each mode's two medians."""
    calls = {mode: (lambda m=mode: bitlut_variant(bits, v, n_out, m))
             for mode in MODES}
    order = list(calls) + list(calls)[::-1]
    times = {mode: [] for mode in calls}
    for mode in order:
        times[mode].append(_median_ms(calls[mode], reps))
    ms = {mode: sum(t) / len(t) for mode, t in times.items()}
    log(f"  bitlut ablation{' ' + label if label else ''}, "
        f"{tuple(bits.shape)} bitmap, n_out {n_out}, in turns: "
        + ', '.join(f"{m} {ms[m]:.4f} ms {[round(t, 4) for t in times[m]]}"
                    for m in calls))
    return ms


def random_bitmap(g_live, g_pad, m_pad, n_out, density, gen):
    """(g_pad, m_pad) uint8 bitmap: each bit of the live groups' live
    outputs set with probability `density`, the padding zero."""
    bits = torch.zeros((g_pad, m_pad), dtype=torch.uint8, device='cuda')
    for b in range(8):
        plane = torch.rand((g_live, n_out), generator=gen, device='cuda')
        bits[:g_live, :n_out] |= (plane < density).to(torch.uint8) << b
        del plane
    return bits


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--density', type=float, default=0.1)
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bitlut_ablation: needs a CUDA device")
    gen = torch.Generator(device='cuda').manual_seed(0)
    print(f"bitlut ablation on {torch.cuda.get_device_name(0)}, random "
          f"bitmaps of the flagship's shapes at bit density {args.density}")
    for tag, (g_live, g_pad, m_pad, n_out) in FLAGSHIP.items():
        bits = random_bitmap(g_live, g_pad, m_pad, n_out, args.density, gen)
        v = torch.zeros(8 * g_pad, device='cuda')
        v[:8 * g_live] = torch.randn(8 * g_live, generator=gen,
                                     device='cuda')
        ref = bitlut(bits, v, n_out, tag)
        got = bitlut_variant(bits, v, n_out, 'byte')
        err = float((got - ref).abs().max() / ref.abs().max())
        print(f"  [{tag}] byte-table mode against the design's kernel: "
              f"rel {err:.2e}")
        run(bits, v, n_out, args.reps, tag)
        del bits
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
