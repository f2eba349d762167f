"""
The measured window: the program's queue-ahead posture (a copy of the
port's ``bench._pipeline_pass``, less the host prep, which set-up did),
run until the window's time is up. Each chunk is searched over every
search range of the configuration, in its order, as the pipeline's
``BatchSearcher.process_stream`` searches one
(``_queue_chunk``, ``_collect_chunk``).

Per chunk i: the ship thread copies every range's prepared wire of
chunk i + 1 to the card (``ship_stage_data``) while the card runs chunk
i, whose ranges ``queue_search_batch`` queued; the main thread then
collects chunk i - 1's ranges (``collect_search_batch``). Chunks cycle
through the ring of prepared wires, whose pinned buffers are never
released. The window runs from the first ship to the last collect, and
every chunk queued in it is collected in it.
"""
import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["run_window"]


def run_window(ranges, ring, seconds, device, annotate=None, min_chunks=2):
    """Run the window over ``ring`` (per ring slot, each range's prepared
    wire), ``ranges`` being each search range's (plan, tobs, peak
    keywords, name) in the configuration's order. Returns a dict:
    ``t0``/``t1`` (host clock at the first ship and the last collect),
    ``chunks``; per chunk ``ship_s``, ``queue_s`` and ``collect_s``
    (over all its ranges), ``peaks`` (per range, peaks per trial) and
    ``slots`` (its ring slot); and ``snr``: per ring slot each range's
    S/N cube of its last chunk, referenced before the collect released
    it. With ``annotate``, a named range's queue is annotated
    ``queue.<i>.<name>`` inside the chunk's ``queue.<i>``."""
    from riptide_tpu_torch.search import engine

    note = annotate or (lambda name: contextlib.nullcontext())
    R = len(ring)
    D = int(ring[0][0][0].shape[0])
    dms = np.zeros(D)
    out = {"ship_s": [], "queue_s": [], "collect_s": [], "peaks": [],
           "slots": [], "snr": {}}

    def ship(i):
        with note(f"ship.{i}"):
            t = time.perf_counter()
            shipped = [engine.ship_stage_data(p, device) for p in ring[i % R]]
            out["ship_s"].append(time.perf_counter() - t)
        return shipped

    def queue(i, shipped):
        handles = []
        for (plan, tobs, peak_kw, name), wire in zip(ranges, shipped):
            with (note(f"queue.{i}.{name}") if name is not None
                  else contextlib.nullcontext()):
                handles.append(engine.queue_search_batch(
                    plan, None, tobs, shipped=wire, **peak_kw))
        return handles

    def collect(i, handles, snr):
        with note(f"collect.{i}"):
            t = time.perf_counter()
            peaks = [engine.collect_search_batch(h, dms)[0] for h in handles]
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
                handles = queue(i, shipped)
                out["queue_s"].append(time.perf_counter() - t)
            queued = (i, handles, [engine.search_snr_dev(h) for h in handles])
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
