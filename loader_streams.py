#!/usr/bin/env python3
"""
Does a chunk's search wait behind other series' de-reddening on the
pipeline's loader threads? On one CUDA card:

    python3 loader_streams.py [--reps N]

Writes one chunk (16 files) of ``chip_smoke.py`` phase 7's PRESTO DM
trials of the headline series into a temporary directory under the
port's build directory, loads and prepares them as the pipeline's
``BatchSearcher`` does, and times ``run_search_batch`` on the chunk:
alone, and while one thread per series de-reddens it ``--reps`` times
on (a) a CUDA stream of its own and (b) the thread's current stream,
the stream the search runs on (as the batcher's loader threads do).
Prints the card's name and power limit, then the median walls of
``--reps`` searches each.

The batcher's loader threads de-redden on the current stream; this
script keeps the comparison that decided it. Imports nothing of jax and
nothing of the JAX package.
"""
import argparse
import contextlib
import os
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as smoke


def compare(dev, plan, series, tobs, reps):
    """Median walls of ``run_search_batch`` on ``series``: alone, and
    beside one de-reddening thread per series on streams of their own
    and on the shared current stream."""
    from riptide_tpu_torch.search import engine

    batch = np.stack([ts.data for ts in series])
    dms = [ts.metadata["dm"] for ts in series]
    prepared = engine.prepare_stage_data(plan, batch)

    def search():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        engine.run_search_batch(plan, batch, tobs, dms=dms,
                                prepared=prepared, device=dev,
                                **smoke.PIPE_FIND_PEAKS)
        return time.perf_counter() - t0

    local = threading.local()

    def own_stream():
        if not hasattr(local, "stream"):
            local.stream = torch.cuda.Stream(dev)
        return torch.cuda.stream(local.stream)

    def deredden(ts, stream_of):
        for _ in range(reps):
            with stream_of():
                ts.deredden(4.0, minpts=101, device=dev)

    search()
    walls = {"alone": [search() for _ in range(reps)]}
    for label, stream_of in (("own streams", own_stream),
                             ("one shared stream", contextlib.nullcontext)):
        with ThreadPoolExecutor(len(series)) as ex:
            futs = [ex.submit(deredden, ts, stream_of) for ts in series]
            walls[label] = [search() for _ in range(reps)]
            for f in futs:
                f.result()
    return {k: float(np.median(v)) for k, v in walls.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="searches per case, and de-reddenings per thread")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loader_streams: no CUDA device", file=sys.stderr)
        return 2
    from riptide_tpu_torch.pipeline.batcher import BatchSearcher
    from riptide_tpu_torch.utils.cuda_build import BUILD_DIR

    dev = torch.device("cuda")
    cfg, chunk = smoke.HEADLINE, smoke.PIPE_CHUNK
    conf = smoke.pipeline_config(cfg, chunk)
    searcher = BatchSearcher(conf["dereddening"], conf["ranges"],
                             io_threads=chunk, device=dev)
    plan = searcher._plan_for(conf["ranges"][0], cfg["nsamp"], cfg["tsamp"])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        files, _ = smoke.write_dm_trials(tmp, chunk, cfg)
        with ThreadPoolExecutor(chunk) as ex:
            series = list(ex.map(
                lambda f: searcher.load_prepared(f, search=False), files))
        medians = compare(dev, plan, series, cfg["nsamp"] * cfg["tsamp"],
                          args.reps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smoke.gpu_line())
    print(f"search of one chunk (D = {chunk}): " + ", ".join(
        f"{k} {v:.4f} s" for k, v in medians.items())
        + f" (median of {args.reps}; {chunk} threads de-reddening "
        f"{args.reps} times each)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
