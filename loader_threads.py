#!/usr/bin/env python3
"""
Does a journaled survey's chunk dispatch wait for a core behind the next
chunk's loader threads? On one CUDA card:

    python3 loader_threads.py [--threads 16 7] [--runs 3]

Writes ``chip_smoke.py`` phase 7's PRESTO DM trials of the headline
series (48 files, 3 chunks of 16) into a temporary directory under the
port's build directory, then runs phase 8 (a)'s journaled
``Pipeline.process`` with every chunk shadow-probed, ``--runs`` times at
each loader pool size of ``--threads`` (the pool is set once the
pipeline has built its searcher, past the batcher's ``loader_threads``
cap). While chunk i is dispatched, the loader pool scans and de-reddens
chunk i + 1; the last chunk is dispatched alone. Prints the card's name and power
limit and the host's cores, then for each run its wall, each chunk's
journaled ``chunk_s`` and the journal's ``straggler_ratio`` (the slowest
chunk over the median, the signal ``rwatch`` alerts on at 3.0).

Imports nothing of jax and nothing of the JAX package.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

import torch

import chip_smoke as smoke


def journaled_walls(dev, conf, files, root, nthreads):
    """One journaled, probed ``Pipeline.process`` over ``files`` with
    ``nthreads`` loader threads: (wall, chunk walls, straggler ratio)."""
    from riptide_tpu_torch.obs import report
    from riptide_tpu_torch.pipeline import Pipeline

    jdir = tempfile.mkdtemp(dir=root)
    out = os.path.join(jdir, "products")
    os.makedirs(out)
    with smoke.env_flags(smoke.PROBE_ENV):
        pipe = Pipeline(conf, device=dev, journal=jdir)
        prepare = pipe.prepare

        def sized(names):
            prepare(names)
            pipe.searcher.io_threads = nthreads

        pipe.prepare = sized
        t0 = time.perf_counter()
        pipe.process(files, out)
        wall = time.perf_counter() - t0
    state = report.JournalFollower(jdir).poll()
    walls = [state["chunks"][cid]["timings"]["chunk_s"]
             for cid in sorted(state["chunks"])]
    return wall, walls, report.watch_snapshot(state)["straggler_ratio"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[16, 7],
                    help="loader pool sizes to compare")
    ap.add_argument("--runs", type=int, default=3,
                    help="journaled runs at each pool size")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loader_threads: no CUDA device", file=sys.stderr)
        return 2
    from riptide_tpu_torch.utils.cuda_build import BUILD_DIR

    dev = torch.device("cuda")
    cfg = smoke.HEADLINE
    conf = smoke.pipeline_config(cfg, smoke.PIPE_CHUNK)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    print(f"{smoke.gpu_line()}; {len(os.sched_getaffinity(0))} host cores",
          flush=True)
    try:
        files, _ = smoke.write_dm_trials(tmp, smoke.PIPE_FILES, cfg)
        journaled_walls(dev, conf, files, tmp, args.threads[0])
        for _ in range(args.runs):
            for n in args.threads:
                wall, walls, ratio = journaled_walls(dev, conf, files, tmp, n)
                print(f"{n} loader threads: {wall:.3f} s wall; chunk_s "
                      + ", ".join(f"{w:.3f}" for w in walls)
                      + f" s; straggler_ratio {ratio}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
