"""
A configuration's search ranges on the card's timeline, from the records
every traced run has (``portbench.trace.load_chrome_trace``): the
device's kernels, copies and sets, and the harness's annotations.

The window queues a chunk's ranges one after another on the card's
stream, each inside the harness's ``queue.<i>.<range>`` annotation, and
each range's queue ends with the one pull of its peak buffer into
pinned host memory (``peaks_device.queue_find_peaks``), a copy named
:data:`PULL` in the trace. The stream runs its work in the order it was
queued, so the pulls cut the card's timeline into one block a queued
range: the kernels that start after the previous pull ends and before
the range's own pull starts, named by the annotations taken in the same
order. The readers of ``portbench/metrics/`` take the blocks from here
rather than from each launch's ``correlation``, which these records do
not hold.
"""
from .trace import ANNOTATION, device_events

__all__ = ["PULL", "range_blocks", "switch_idle_us"]

PULL = "Memcpy DtoH (Device -> Pinned)"


def _range_queues(records, span):
    """[(start, range name)] of the harness's ``queue.<i>.<range>``
    annotations that start in ``span``, in time order."""
    out = []
    for r in records:
        parts = r["name"].split(".", 3)
        if r["cat"] == "user_annotation" and len(parts) == 4 \
                and parts[:2] == [ANNOTATION[:-1], "queue"] \
                and span[0] <= r["ts"] < span[1]:
            out.append((r["ts"], parts[3]))
    return sorted(out)


def range_blocks(records, span):
    """[(range name, its kernels' records)] in the card's order, one a
    queued range of the window; None where ``span`` is None, no range is
    named, or the pulls do not match the queues one for one (a pull
    cannot start before the annotation its range was queued in)."""
    if span is None:
        return None
    queues = _range_queues(records, span)
    if not queues:
        return None
    dev = sorted(device_events(records, span), key=lambda e: e["ts"])
    pulls = [e for e in dev if e["cat"] == "gpu_memcpy" and e["name"] == PULL]
    if len(pulls) != len(queues) or any(
            p["ts"] < t for p, (t, _) in zip(pulls, queues)):
        return None
    blocks, k, start = [], 0, span[0]
    for pull, (_, name) in zip(pulls, queues):
        kernels = []
        while k < len(dev) and dev[k]["ts"] < pull["ts"]:
            e = dev[k]
            if e["cat"] == "kernel" and e["ts"] >= start:
                kernels.append(e)
            k += 1
        blocks.append((name, kernels))
        start = pull["ts"] + pull["dur"]
    return blocks


def switch_idle_us(records, span, blocks):
    """Microseconds in which the card ran no kernel, copy or set between
    the end of one range's last kernel and the start of the next
    range's first, summed over every switch of ``blocks`` from one
    range to another (across chunks too); None where there is none."""
    dev = device_events(records, span)
    idle, switches = 0.0, 0
    for (a_name, a), (b_name, b) in zip(blocks, blocks[1:]):
        if a_name == b_name or not a or not b:
            continue
        switches += 1
        t0 = max(e["ts"] + e["dur"] for e in a)
        t1 = min(e["ts"] for e in b)
        if t1 <= t0:
            continue
        busy = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                      for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
        t = t0
        for s, f in busy:
            if s > t:
                idle += s - t
            t = max(t, f)
        idle += max(0.0, t1 - t)
    return idle if switches else None
