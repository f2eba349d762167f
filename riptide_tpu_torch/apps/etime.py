"""
Time the whole engine, ``run_periodogram_batch``, on the card.

    python -m riptide_tpu_torch.apps.etime [log2_nsamp] [D] [reps] [--device cuda|cpu]

A (D, 2^log2_nsamp) batch of seeded noise (defaults 2^20 samples, D = 2,
3 repetitions) at 64 us, periods 0.5-3.0 s, bins 240-260: the plan's
stages, trials and FFA depths, one warm-up search (the cold plan and the
first search of the shape), then the best of ``reps`` searches as
seconds a batch and DM-trials/s, with ``vs_baseline`` (DM-trials/s x
0.2511, the reference C++ engine's seconds a trial at 2^23 samples). The
device's name and power limit are printed first. The last line gives
the largest S/N and the cube's shape.
"""
import argparse
import sys
import time

import numpy as np

from .. import bench
from ..search.engine import run_periodogram_batch
from ..utils.device import resolve_device

TSAMP = 64e-6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log2_nsamp", nargs="?", type=int, default=20)
    ap.add_argument("D", nargs="?", type=int, default=2)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    LOG2N, D = args.log2_nsamp, args.D
    N = 1 << LOG2N
    print(f"device: {bench.device_line(dev)}", flush=True)

    t0 = time.perf_counter()
    plan = bench._plan(N, TSAMP, bench.PERIOD_MIN, bench.PERIOD_MAX,
                       bench.BINS_MIN, bench.BINS_MAX)
    print(f"plan: {len(plan.stages)} stages, {plan.length} trials, "
          f"depths {sorted(set(st.kernel_depth for st in plan.stages))} "
          f"[{time.perf_counter() - t0:.1f}s]", flush=True)

    rng = np.random.default_rng(0)
    batch = rng.standard_normal((D, N)).astype(np.float32)

    t0 = time.perf_counter()
    run_periodogram_batch(plan, batch, device=dev)
    print(f"warmup (incl. table build and the first search): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    best = 1e9
    for _ in range(args.reps):
        t0 = time.perf_counter()
        _, _, snrs = run_periodogram_batch(plan, batch, device=dev)
        best = min(best, time.perf_counter() - t0)
    print(f"N=2^{LOG2N} D={D}: {best:.3f} s/batch = {D / best:.3f} "
          f"DM-trials/s (vs_baseline x{bench.REF_SECONDS_PER_TRIAL} = "
          f"{D / best * bench.REF_SECONDS_PER_TRIAL:.2f})", flush=True)
    print("snr stats:", float(snrs.max()), snrs.shape, flush=True)


if __name__ == "__main__":
    sys.exit(main())
