"""
The traced window's records: the device's kernels, copies and sets from
``torch.profiler``'s trace, the harness's own host annotations, and the
reductions every reader shares (the union of busy intervals, the idle
gaps and what the host did in each).

A record is a dict with ``name``, ``cat`` (``kernel``, ``gpu_memcpy``,
``gpu_memset`` for the device, ``user_annotation`` for the host), ``ts``
and ``dur`` in microseconds of the trace's clock.
"""
import json
import os
import tempfile

__all__ = ["DEVICE_CATS", "ANNOTATION", "load_chrome_trace", "kernel_base",
           "device_events", "union_us", "idle_gaps", "breakdown"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "portbench."


def load_chrome_trace(prof):
    """The records of a finished ``torch.profiler.profile``: its Chrome
    trace written to a temporary file (``TMPDIR``), read and removed."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fobj:
            data = json.load(fobj)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    keep = DEVICE_CATS + ("user_annotation",)
    return [{"name": e.get("name", ""), "cat": e.get("cat", ""),
             "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0))}
            for e in events
            if e.get("ph") == "X" and e.get("cat") in keep
            and (e.get("cat") != "user_annotation"
                 or str(e.get("name", "")).startswith(ANNOTATION))]


def kernel_base(name):
    """A kernel's bare function name: ``void f<...>(args)`` -> ``f``,
    ``void (anonymous namespace)::f(args)`` and ``ns::f(args)`` -> ``f``."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = head.strip()
    if head.startswith("void "):
        head = head[5:]
    head = head.split("<", 1)[0]
    return head.rsplit("::", 1)[-1].strip()


def window_span(records):
    """(start, end) in trace microseconds of the ``portbench.window``
    annotation, or None."""
    for r in records:
        if r["cat"] == "user_annotation" and r["name"] == ANNOTATION + "window":
            return r["ts"], r["ts"] + r["dur"]
    return None


def device_events(records, span=None):
    """The device's records, clipped to ``span`` when given."""
    out = []
    for r in records:
        if r["cat"] not in DEVICE_CATS:
            continue
        if span is not None:
            a = max(r["ts"], span[0])
            b = min(r["ts"] + r["dur"], span[1])
            if b <= a:
                continue
            r = dict(r, ts=a, dur=b - a)
        out.append(r)
    return out


def _merged(events):
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(events):
    """Microseconds covered by at least one of ``events``."""
    return sum(b - a for a, b in _merged(events))


def idle_gaps(events, span):
    """(start, end) of every stretch of ``span`` that no event covers."""
    gaps, t = [], span[0]
    for a, b in _merged(events):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if span[1] > t:
        gaps.append((t, span[1]))
    return gaps


def _host_phase(annotations, t):
    """The harness annotation in progress at trace time ``t``, preferring
    the main thread's (queue, collect, wait) over the ship thread's."""
    best = None
    for r in annotations:
        if r["ts"] <= t < r["ts"] + r["dur"]:
            name = r["name"][len(ANNOTATION):]
            if name == "window":
                continue
            if best is None or best.startswith("ship"):
                best = name
    return best or "other"


def breakdown(records, span, top=10):
    """The ``--trace 1`` line's ``breakdown``: the ``top`` device
    operations by total seconds in ``span`` (kernels by bare name,
    copies and sets by their name) and the ``top`` longest idle gaps,
    each named by what the host was doing when it began."""
    dev = device_events(records, span)
    totals = {}
    for e in dev:
        key = kernel_base(e["name"]) if e["cat"] == "kernel" else e["name"]
        totals[key] = totals.get(key, 0.0) + e["dur"] * 1e-6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    ann = [r for r in records if r["cat"] == "user_annotation"]
    gaps = sorted(idle_gaps(dev, span), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[_host_phase(ann, a), (b - a) * 1e-6]
                          for a, b in gaps]}
