"""
Chrome trace-event export of a tracer's span ring (the port's copy of
the JAX package's ``obs/chrome.py``).

Writes the `Trace Event Format`_ JSON-object form (``{"traceEvents":
[...]}``) that Perfetto and ``chrome://tracing`` load directly: one
``"X"`` (complete) event per span with microsecond ``ts``/``dur``,
``pid`` = the survey process index and ``tid`` = the recording host
thread, plus ``"M"`` metadata events naming each process/thread lane.
Nesting needs no explicit parent links — properly nested complete
events on one tid render as a flame stack.

Multihost runs write one file per process (each process traces only
its own host work) and merge them with :func:`merge_chrome_traces`:
every process keeps its own ``pid`` lane, so a merged file shows the
whole survey's host timelines side by side. Per-process monotonic
clocks are unsynchronised across hosts; the merge aligns lanes on each
file's UTC wall anchor (recorded at tracer creation), which is as good
as the hosts' clock sync — fine for the second-scale chunk phases this
tracer records.

.. _Trace Event Format: https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""
import glob
import json
import logging
import os

from ..utils import fsio

log = logging.getLogger("riptide_tpu_torch.obs.chrome")

__all__ = ["chrome_events", "write_chrome_trace", "merge_chrome_traces",
           "export_run_trace", "rotate_trace_file"]

# How many prior attempts' trace files survive a rotation:
# trace.json.1 (newest prior) .. trace.json.3 (oldest kept).
TRACE_ROTATE_DEPTH = 3


def rotate_trace_file(path, depth=TRACE_ROTATE_DEPTH):
    """Shift an existing ``path`` to ``path.1`` (and ``path.1`` to
    ``path.2``, ...), dropping anything beyond ``depth``. Called by
    :func:`export_run_trace` before a DIFFERENT tracer (a resumed
    attempt in a fresh process) first writes to ``path``, so a resume
    no longer destroys the killed attempt's trace."""
    if not os.path.exists(path):
        return
    oldest = f"{path}.{int(depth)}"
    if os.path.exists(oldest):
        os.remove(oldest)
    for i in range(int(depth) - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i + 1}")
    os.replace(path, f"{path}.1")


def chrome_events(tracer, pid=0, process_name="riptide_tpu_torch"):
    """The trace-event list of one tracer's ring: ``X`` span events and
    ``M`` metadata naming the process/thread lanes. (Cross-process lane
    alignment happens once, in :func:`merge_chrome_traces`.)"""
    events = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"{process_name} (process {pid})"},
    }]
    for tid, tname in sorted(tracer.thread_names().items()):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": tname},
        })
    for name, ts, dur, tid, attrs, sid in tracer.events():
        events.append({
            "name": name, "ph": "X", "cat": "riptide",
            "pid": pid, "tid": tid,
            "ts": round(ts * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            # span_id is the handle journal `incident` records carry,
            # so an incident row finds its enclosing span in the file.
            "args": dict(attrs, span_id=sid),
        })
    return events


def write_chrome_trace(path, tracer, pid=0, process_name="riptide_tpu_torch"):
    """Write one process's span ring as a Perfetto-loadable trace file.
    The ``otherData`` block records the UTC wall anchor (for merging)
    and how many spans the bounded ring dropped, so a truncated
    timeline is detectable in the file itself."""
    doc = {
        "traceEvents": chrome_events(tracer, pid=pid,
                                     process_name=process_name),
        "displayTimeUnit": "ms",
        "otherData": {
            "wall_t0_unix_s": tracer.wall_t0,
            "recorded": tracer.recorded,
            "dropped_events": tracer.dropped_events,
        },
    }
    return fsio.atomic_write_text(path, json.dumps(doc),
                                  site="trace_export")


def merge_chrome_traces(paths, out):
    """Merge per-process trace files (one per multihost process) into a
    single Perfetto-loadable file. Each input keeps its own ``pid``
    lane; event timestamps are re-anchored to the earliest process's
    UTC wall anchor so the lanes line up in absolute time."""
    docs = []
    for path in paths:
        with open(path) as fobj:
            docs.append(json.load(fobj))
    anchors = [d.get("otherData", {}).get("wall_t0_unix_s", 0.0)
               for d in docs]
    base = min(anchors) if anchors else 0.0
    events = []
    for doc, anchor in zip(docs, anchors):
        shift_us = (anchor - base) * 1e6
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "X":
                ev = dict(ev, ts=round(ev["ts"] + shift_us, 3))
            events.append(ev)
    merged = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_from": [os.path.basename(p) for p in paths],
            "wall_t0_unix_s": base,
        },
    }
    return fsio.atomic_write_text(out, json.dumps(merged),
                                  site="trace_export")


def export_run_trace(directory, process_index=0, process_count=1,
                     tracer=None):
    """End-of-run trace export into ``directory`` (typically the
    journal directory). No-op (returns None) while tracing is disabled,
    so survey layers call it unconditionally.

    Single process: writes ``trace.json``. Multihost: each process
    writes its own ``trace_<p>.json`` lane file, and process 0
    additionally merges every per-process file PRESENT AT THAT MOMENT
    into ``trace.json`` — best-effort, since peers finish at their own
    pace; re-running :func:`merge_chrome_traces` over the lane files
    afterwards yields the complete picture.

    A target file this tracer has not written before is first rotated
    (``trace.json`` -> ``trace.json.1``, bounded depth): a RESUMED run
    (fresh process, fresh tracer) preserves the killed attempt's trace
    instead of overwriting it, while same-run re-exports (e.g. the
    scheduler's end-of-search export followed by rffa's post-stage
    re-export, or per-chunk multihost lane rewrites) keep overwriting
    in place.

    Export failure is NEVER fatal: a full disk or I/O error while
    writing the trace degrades to an ``obs_write_failed`` incident plus
    the ``obs_write_errors`` counter, and the run whose trace this is
    completes regardless (the hard invariant of the observability
    surface)."""
    if tracer is None:
        from .trace import get_tracer

        tracer = get_tracer()
    if tracer is None:
        return None

    def target(path):
        if path not in tracer.exported_paths:
            rotate_trace_file(path)
            tracer.exported_paths.add(path)
        return path

    merged_path = os.path.join(directory, "trace.json")
    writing = merged_path  # the file in flight when a failure hits
    try:
        if process_count <= 1:
            return write_chrome_trace(target(merged_path), tracer)
        own = os.path.join(directory,
                           f"trace_{int(process_index):04d}.json")
        writing = own
        write_chrome_trace(target(own), tracer, pid=int(process_index))
        if int(process_index) == 0:
            lanes = sorted(glob.glob(os.path.join(directory,
                                                  "trace_[0-9]*.json")))
            writing = merged_path
            merge_chrome_traces(lanes, target(merged_path))
        return own
    except (OSError, ValueError) as err:
        log.warning("trace export of %r failed: %s", writing, err)
        from .ledger import _obs_write_failed

        _obs_write_failed("trace", writing, err)
        return None
