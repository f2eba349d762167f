"""
Survey phase timing: where does a pipelined chunk's wall time go?

    python -m riptide_tpu_torch.apps.stime [D] [CHUNKS] [--device cuda|cpu]

Runs the bench's timed pipeline (``riptide_tpu_torch.bench``'s
``_pipeline_pass``, the headline's queue-ahead posture) at the headline
shape, D trials a chunk (default 32) over CHUNKS chunks (default 4),
and prints, per chunk i:

  queue    the main thread's seconds in ``queue_search_batch`` (queues
           every stage launch, the assembly and the peak program)
  wait     the main thread's wait for chunk i + 1's prep and ship
  prep     chunk i + 1's host wire prep: the prep thread's wall
  ship     chunk i + 1's ``ship_stage_data`` (queues the copy of the
           pinned staging buffers on the copy stream): the ship
           thread's wall
  collect  the main thread's seconds in ``collect_search_batch`` of
           chunk i - 1 (waits for the card, pulls the peak buffers,
           runs the host tail)

Two microbenchmarks run first:

  wire  three host-to-card copies of a wire-sized pinned buffer: the
        copy call's seconds, the seconds to completion, and MB/s
  rtt   five tiny copies to the card, each pulled back

The LAST stdout line is a JSON block with the decomposition the bench
prints (``obs/schema.py::decomposition``: ``prep_s``, ``wire_s``,
``device_s``, ``cluster_s``, ``postsearch_s``, ``chunk_s``,
``wire_MBps``) plus ``trials_per_sec`` and the registry's ``dispatch_*``
entries. With ``RIPTIDE_LEDGER`` set, one ledger row of kind ``stime``
is appended. The device's name and power limit go first to stdout.
"""
import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import bench
from ..obs.schema import decomposition
from ..search.engine import (StagingPool, _wire_mode, collect_search_batch,
                             queue_search_batch, warm_stage_kernels,
                             wire_transfer_contract)
from ..survey.metrics import get_metrics
from ..utils.device import resolve_device

N = 1 << 23
TSAMP = 64e-6
PERIOD_MIN, PERIOD_MAX = 0.5, 3.0
PKW = bench.PKW


def microbench(plan, D, dev):
    """The wire and round-trip microbenchmarks: three copies of a pinned
    buffer of one D-trial chunk's wire bytes, then five tiny copies each
    pulled back."""
    mode = _wire_mode()
    nbytes = wire_transfer_contract(plan, mode)["h2d_bytes_per_dm"]
    print(f"wire mode {mode}: {nbytes * D / 1e6:.1f} MB per {D}-trial chunk",
          flush=True)
    rng = np.random.default_rng(0)
    buf = torch.from_numpy(rng.integers(0, 255, (D, nbytes), dtype=np.uint8))
    if dev.type == "cuda":
        buf = buf.pin_memory()
    for _ in range(3):
        t0 = time.perf_counter()
        out = buf.to(dev, non_blocking=True)
        t1 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        print(f"  copy {buf.nbytes / 1e6:.0f} MB: call {t1 - t0:.4f}s, "
              f"complete {t2 - t0:.4f}s -> "
              f"{buf.nbytes / 1e6 / (t2 - t0):.1f} MB/s", flush=True)
        del out
    tiny = torch.zeros(8, dtype=torch.float32)
    for _ in range(5):
        t0 = time.perf_counter()
        tiny.to(dev)[:1].cpu()
        print(f"  rtt: {time.perf_counter() - t0:.6f}s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("D", nargs="?", type=int, default=32,
                    help="DM trials a chunk (default 32)")
    ap.add_argument("CHUNKS", nargs="?", type=int, default=4,
                    help="timed chunks (default 4)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    D, CHUNKS = args.D, args.CHUNKS
    print(f"device: {bench.device_line(dev)}", flush=True)
    plan = bench._plan(N, TSAMP, PERIOD_MIN, PERIOD_MAX, bench.BINS_MIN,
                       bench.BINS_MAX)
    tobs = N * TSAMP
    microbench(plan, D, dev)

    t0 = time.perf_counter()
    nw = warm_stage_kernels(plan, D, device=dev)
    print(f"kernel warm ({nw}): {time.perf_counter() - t0:.1f}s", flush=True)

    batches = [bench._make_batch(D, N, TSAMP, seed=k) for k in range(2)]
    dms = np.zeros(D)
    pool = StagingPool(dev)

    # Warm-up pass: the first search of this shape.
    t0 = time.perf_counter()
    h = queue_search_batch(plan, batches[0], tobs, device=dev, pool=pool,
                           **PKW)
    collect_search_batch(h, dms)
    print(f"warmup pass: {time.perf_counter() - t0:.1f}s", flush=True)

    timing = {}
    with ThreadPoolExecutor(max_workers=1) as prepper, \
            ThreadPoolExecutor(max_workers=1) as shipper:
        dt = bench._pipeline_pass(plan, tobs, CHUNKS, dms,
                                  lambda i: batches[i % 2], prepper, shipper,
                                  device=dev, pool=pool, timing=timing)
    print("fill: prep {:.2f}s ship {:.4f}s".format(*timing["fill"]),
          flush=True)
    for i, t in enumerate(timing["chunks"]):
        print(f"iter {i}: queue {t['queue']:.4f}s  wait {t['wait']:.4f}s "
              f"(prep {t['prep']:.2f}s, ship {t['ship']:.4f}s)  collect "
              f"{t['collect']:.4f}s  total {t['total']:.2f}s", flush=True)
    print(f"final collect: {timing['final_collect']:.4f}s", flush=True)
    print(f"steady: {CHUNKS} chunks in {dt:.2f}s = "
          f"{D * CHUNKS / dt:.2f} trials/s", flush=True)
    s = get_metrics().summary()
    block = {"metric": "stime_decomposition",
             "trials_per_sec": round(D * CHUNKS / dt, 3)}
    sub = decomposition(s, CHUNKS, dt)
    block.update(sub)
    block.update({k: v for k, v in s.items() if k.startswith("dispatch_")})
    print(json.dumps(block), flush=True)
    bench._ledger_row("stime", sub, CHUNKS,
                      {"metric": "stime_decomposition",
                       "trials_per_sec": round(D * CHUNKS / dt, 3)})


if __name__ == "__main__":
    sys.exit(main())
