"""
Warm the headline bench's launch shapes through ``warm_stage_kernels``.

    python -m riptide_tpu_torch.apps.warmtest [D] [seq] [--device cuda|cpu]

Builds or loads the stage kernels and the native wire prep through the
build cache (together, or one after the other with ``seq``), then queues
each distinct launch shape of a D-trial headline search (default 32)
once on a zero wire. The device's name and power limit are printed
first; the last line gives the shapes warmed and the seconds it took.
"""
import argparse
import sys
import time

from .. import bench
from ..search.engine import warm_stage_kernels
from ..utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("D", nargs="?", type=int, default=32)
    ap.add_argument("seq", nargs="?", choices=("seq",),
                    help="build the libraries one after the other")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    par = args.seq is None
    print(f"device: {bench.device_line(dev)}", flush=True)
    plan = bench._plan(bench.N, bench.TSAMP, bench.PERIOD_MIN,
                       bench.PERIOD_MAX, bench.BINS_MIN, bench.BINS_MAX)
    t0 = time.perf_counter()
    n = warm_stage_kernels(plan, args.D, parallel=par, device=dev)
    print(f"warmed {n} launch shapes (parallel={par}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
