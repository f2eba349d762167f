"""
The measured window: the program's queue-ahead posture (a copy of the
port's ``bench._pipeline_pass``, less the host prep, which set-up did),
run until the window's time is up.

Per chunk i: the ship thread copies chunk i + 1's prepared wire to the
card (``ship_stage_data``) while the card runs chunk i, queued by
``queue_search_batch``; the main thread then collects chunk i - 1
(``collect_search_batch``). Chunks cycle through the ring of prepared
wires, whose pinned buffers are never released. The window runs from
the first ship to the last collect, and every chunk queued in it is
collected in it.
"""
import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["run_window"]


def run_window(plan, tobs, ring, seconds, peak_kw, device, annotate=None,
               min_chunks=2):
    """Run the window over ``ring`` (prepared wires). Returns a dict:
    ``t0``/``t1`` (host clock at the first ship and the last collect),
    ``chunks``, per chunk ``ship_s``, ``queue_s``, ``collect_s`` and
    ``peaks`` (peaks per trial), ``slots`` (each chunk's ring slot), and
    ``snr``: per ring slot the S/N cube of its last chunk, referenced
    before the collect released it."""
    from riptide_tpu_torch.search import engine

    note = annotate or (lambda name: contextlib.nullcontext())
    R = len(ring)
    D = int(ring[0][0].shape[0])
    dms = np.zeros(D)
    out = {"ship_s": [], "queue_s": [], "collect_s": [], "peaks": [],
           "slots": [], "snr": {}}

    def ship(i):
        with note(f"ship.{i}"):
            t = time.perf_counter()
            shipped = engine.ship_stage_data(ring[i % R], device)
            out["ship_s"].append(time.perf_counter() - t)
        return shipped

    def collect(i, handle, snr):
        with note(f"collect.{i}"):
            t = time.perf_counter()
            peaks, _ = engine.collect_search_batch(handle, dms)
            out["collect_s"].append(time.perf_counter() - t)
        out["peaks"].append(peaks)
        out["slots"].append(i % R)
        out["snr"][i % R] = snr

    with ThreadPoolExecutor(max_workers=1) as shipper:
        out["t0"] = time.perf_counter()
        shipped = ship(0)
        pending = None
        i = 0
        while True:
            with note(f"queue.{i}"):
                t = time.perf_counter()
                handle = engine.queue_search_batch(plan, None, tobs,
                                                   shipped=shipped, **peak_kw)
                out["queue_s"].append(time.perf_counter() - t)
            queued = (i, handle, engine.search_snr_dev(handle))
            shipped = None
            more = (i + 1 < min_chunks
                    or time.perf_counter() - out["t0"] < seconds)
            fut = shipper.submit(ship, i + 1) if more else None
            if pending is not None:
                collect(*pending)
            pending = queued
            if not more:
                break
            with note(f"wait.{i}"):
                shipped = fut.result()
            i += 1
        collect(*pending)
        out["t1"] = time.perf_counter()
    out["chunks"] = i + 1
    return out
