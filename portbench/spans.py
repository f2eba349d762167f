"""
The program's spans in the traced window's records: while
``torch.profiler`` records and the program's tracer
(``riptide_tpu_torch.obs.trace``) is installed, each span of the program
is a ``user_annotation`` named ``riptide.<span>`` (``riptide.ffa_stage.7``
for stage 7) on the profiler's clock. A kernel belongs to the span that
launched it: its ``correlation`` names the CUDA runtime call that
launched it, and that call lies inside the innermost ``riptide.*``
annotation of its thread.

:func:`load_records` reads the profiler's trace into the records
``portbench.trace.load_chrome_trace`` reads, with more: the program's
spans (category :data:`SPAN_CAT`, so that no reader of
``portbench.trace`` takes them for the harness's own annotations), the
CUDA API calls, the thread of every host record and the
``correlation`` of every record that has one. Every reader of
``portbench/trace.py`` and ``portbench/metrics/`` reads the same values
from these records as from that function's.
"""
import json
import os
import tempfile
from bisect import bisect_right

from .trace import (ANNOTATION, DEVICE_CATS, device_events, idle_gaps,
                    kernel_base)

__all__ = ["PREFIX", "SPAN_CAT", "RUNTIME_CATS", "SYNC_CALLS", "QUEUE_SPANS",
           "load_records", "parse_events", "launch_stacks", "sync_calls",
           "kernel_ms", "tail_spans", "tail_idle_us", "main_tid",
           "range_ms", "report_lines"]

PREFIX = "riptide."
SPAN_CAT = "program_span"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# Calls in which the host blocks until the card has done the work queued
# before them: the synchronisations, and the copies that are synchronous
# whatever their memory.
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy", "cuMemcpy",
                        "cuStreamSynchronize", "cuCtxSynchronize",
                        "cuEventSynchronize"))
# The spans of queue_search_batch: the stage loop, the assembly and the
# device peak program.
QUEUE_SPANS = (PREFIX + "stages", PREFIX + "assemble", PREFIX + "peaks")


def parse_events(events):
    """The records of a Chrome trace's complete (``ph`` X) events."""
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), str(e.get("name", ""))
        if cat == "user_annotation":
            if name.startswith(PREFIX):
                cat = SPAN_CAT
            elif not name.startswith(ANNOTATION):
                continue
        elif cat not in DEVICE_CATS and cat not in RUNTIME_CATS:
            continue
        r = {"name": name, "cat": cat, "ts": float(e["ts"]),
             "dur": float(e.get("dur", 0.0))}
        if cat not in DEVICE_CATS:
            r["tid"] = e.get("tid")
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            r["correlation"] = corr
        out.append(r)
    return out


def load_records(prof):
    """The records of a finished ``torch.profiler.profile``, the
    program's spans and the runtime calls included: its Chrome trace
    written to a temporary file (``TMPDIR``), read and removed."""
    fd, path = tempfile.mkstemp(prefix="portbench_spans_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fobj:
            data = json.load(fobj)
    finally:
        os.unlink(path)
    return parse_events(data["traceEvents"] if isinstance(data, dict)
                        else data)


def _in(r, span):
    return span is None or span[0] <= r["ts"] < span[1]


def _stacks(records, points):
    """For each (tid, t) of ``points``, the names of the program spans
    open at ``t`` on thread ``tid``, outermost first. The spans of one
    thread nest, so one sweep in time order finds them all."""
    threads = {}
    for r in records:
        if r["cat"] == SPAN_CAT:
            threads.setdefault(r["tid"], []).append(r)
    for spans in threads.values():
        spans.sort(key=lambda r: (r["ts"], -r["dur"]))
    state = {tid: [0, []] for tid in threads}
    out = [()] * len(points)
    for i in sorted(range(len(points)), key=lambda i: points[i][1]):
        tid, t = points[i]
        if tid not in state:
            continue
        spans, (k, stack) = threads[tid], state[tid]
        while k < len(spans) and spans[k]["ts"] <= t:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= \
                    spans[k]["ts"]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        state[tid][0] = k
        out[i] = tuple(r["name"] for r in stack)
    return out


def launch_stacks(records):
    """``{correlation: names of the program spans open around the
    runtime call}`` for every runtime call that has a correlation."""
    calls = [r for r in records
             if r["cat"] in RUNTIME_CATS and "correlation" in r]
    stacks = _stacks(records, [(r["tid"], r["ts"]) for r in calls])
    return {r["correlation"]: s for r, s in zip(calls, stacks)}


def sync_calls(records, span=None):
    """Every blocking call (:data:`SYNC_CALLS`) that starts in ``span``,
    inside one of :data:`QUEUE_SPANS`: a list of (record, names of the
    program spans open around it)."""
    calls = [r for r in records if r["cat"] in RUNTIME_CATS
             and r["name"] in SYNC_CALLS and _in(r, span)]
    stacks = _stacks(records, [(r["tid"], r["ts"]) for r in calls])
    return [(r, s) for r, s in zip(calls, stacks)
            if any(name in QUEUE_SPANS for name in s)]


def kernel_ms(records, span, within):
    """Device milliseconds of the kernels in ``span`` (clipped to it)
    whose launch lay inside a program span named ``within``."""
    stacks = launch_stacks(records)
    us = sum(e["dur"] for e in device_events(records, span)
             if e["cat"] == "kernel"
             and within in stacks.get(e.get("correlation"), ()))
    return us * 1e-3


def range_ms(records, span, k1_names):
    """``{range: [K1, peak program, other]}``: device milliseconds in
    ``span`` of the kernels launched inside the harness's
    ``queue.<i>.<range>`` annotations (a configuration's named search
    ranges), K1's by name (``k1_names``), the peak program's by the
    program's ``peaks`` span; empty where no range is named."""
    ranges = {}
    for r in records:
        parts = r["name"].split(".", 3)
        if r["cat"] == "user_annotation" and len(parts) == 4 \
                and parts[:2] == [ANNOTATION[:-1], "queue"]:
            ranges.setdefault(r.get("tid"), []).append(
                (r["ts"], r["ts"] + r["dur"], parts[3]))
    if not ranges:
        return {}
    for anns in ranges.values():
        anns.sort()
    of_call = {}
    for r in records:
        if r["cat"] in RUNTIME_CATS and "correlation" in r:
            anns = ranges.get(r["tid"], [])
            k = bisect_right(anns, (r["ts"], float("inf"), "")) - 1
            if k >= 0 and r["ts"] < anns[k][1]:
                of_call[r["correlation"]] = anns[k][2]
    stacks = launch_stacks(records)
    out = {}
    for e in device_events(records, span):
        name = of_call.get(e.get("correlation"))
        if e["cat"] != "kernel" or name is None:
            continue
        if kernel_base(e["name"]) in k1_names:
            j = 0
        elif PREFIX + "peaks" in stacks.get(e["correlation"], ()):
            j = 1
        else:
            j = 2
        out.setdefault(name, [0.0, 0.0, 0.0])[j] += e["dur"] * 1e-3
    return out


def tail_spans(records, span=None):
    """The program's ``tail`` spans (the collect's host tail) that start
    in ``span``."""
    return [r for r in records if r["cat"] == SPAN_CAT
            and r["name"] == PREFIX + "tail" and _in(r, span)]


def tail_idle_us(records, span):
    """Microseconds of ``span`` inside a ``tail`` span in which no
    kernel, copy or set ran on the card."""
    gaps = idle_gaps(device_events(records, span), span)
    starts = [a for a, _ in gaps]
    idle = 0.0
    for r in tail_spans(records, span):
        a, b = r["ts"], min(r["ts"] + r["dur"], span[1])
        for g0, g1 in gaps[max(0, bisect_right(starts, a) - 1):]:
            if g0 >= b:
                break
            idle += max(0.0, min(b, g1) - max(a, g0))
    return idle


def main_tid(records):
    """The thread of the harness's window annotation (the thread that
    queues and collects), or None."""
    window = ANNOTATION + "window"
    for r in records:
        if r["cat"] == "user_annotation" and r["name"] == window:
            return r.get("tid")
    return None


def _label(name):
    """A span's name without the prefix, a stage's index kept apart:
    ``riptide.ffa_stage.7`` -> ("ffa_stage", "7")."""
    base = name[len(PREFIX):]
    if base.startswith("ffa_stage."):
        return "ffa_stage", base.split(".", 1)[1]
    return base, None


def report_lines(records, span, chunks, k1_names, top=10):
    """Lines for the harness's standard error: the ``top`` longest idle
    gaps, each named by the innermost program span open on the main
    thread halfway through it (where the host spent the gap), host
    milliseconds a chunk by span on that thread, the blocking calls of
    the queue by their innermost span, and device
    milliseconds a chunk of K1's kernels (``k1_names``) by ``ffa_stage``
    and of every other kernel by the innermost span that launched it
    (``assemble``, the ``peaks.*`` steps); with named search ranges,
    device milliseconds a chunk by range (:func:`range_ms`)."""
    if span is None or not chunks:
        return []
    tid = main_tid(records)
    gaps = sorted(idle_gaps(device_events(records, span), span),
                  key=lambda g: g[0] - g[1])[:top]
    names = _stacks(records, [(tid, (a + b) / 2) for a, b in gaps])
    lines = ["idle gaps by program span at their midpoint (main thread): "
             + json.dumps([[s[-1] if s else "none", round((b - a) * 1e-6, 6)]
                           for (a, b), s in zip(gaps, names)])]
    host = {}
    for r in records:
        if r["cat"] == SPAN_CAT and r.get("tid") == tid and _in(r, span):
            name = _label(r["name"])[0]
            host[name] = host.get(name, 0.0) + r["dur"]
    lines.append("host ms a chunk by program span (main thread): "
                 + json.dumps({k: round(v * 1e-3 / chunks, 4) for k, v in
                               sorted(host.items(), key=lambda kv: -kv[1])}))
    syncs = {}
    for r, s in sync_calls(records, span):
        key = f"{s[-1]} {r['name']}"
        n, us = syncs.get(key, (0, 0.0))
        syncs[key] = (n + 1, us + r["dur"])
    lines.append("queue's blocking calls a chunk by innermost span: "
                 + json.dumps({k: [n / chunks, round(us * 1e-3 / chunks, 4)]
                               for k, (n, us) in sorted(
                                   syncs.items(), key=lambda kv: -kv[1][1])}))
    stacks = launch_stacks(records)
    stage, other = {}, {}
    for e in device_events(records, span):
        if e["cat"] != "kernel":
            continue
        s = stacks.get(e.get("correlation"), ())
        name, index = _label(s[-1]) if s else ("none", None)
        if index is not None and kernel_base(e["name"]) in k1_names:
            stage[index] = stage.get(index, 0.0) + e["dur"]
        else:
            other[name] = other.get(name, 0.0) + e["dur"]

    def ms(d):
        return {k: round(v * 1e-3 / chunks, 4) for k, v in sorted(
            d.items(), key=lambda kv: (len(kv[0]), kv[0]))}

    lines.append(f"K1 device ms a chunk by ffa_stage (sum "
                 f"{sum(stage.values()) * 1e-3 / chunks:.4f}): "
                 + json.dumps(ms(stage)))
    lines.append("device ms a chunk of the other kernels by innermost span "
                 "(assembly and peak program steps): " + json.dumps(ms(other)))
    by_range = range_ms(records, span, k1_names)
    if by_range:
        lines.append("device ms a chunk by search range [K1, peak program, "
                     "other]: " + json.dumps(
                         {k: [round(v / chunks, 4) for v in vs]
                          for k, vs in by_range.items()}))
    return lines
