"""
Lightweight metrics registry for survey runs (the port's copy of the
JAX package's ``survey/metrics.py``, with the same metric names).

Counters (monotonic sums), timers (accumulated seconds + call counts)
and gauges (last-set values), all behind one lock, with a process-wide
default registry reachable from any layer via :func:`get_metrics`. The
engine, peak program, batcher and pipeline record into it
unconditionally — recording is two dict operations under a lock, cheap
next to anything they instrument — and the survey scheduler snapshots
it into the journal.

Metric names used by the framework (all optional — a snapshot simply
contains whatever was recorded):

========================  ====================================================
``prep_s``                timer: host wire preparation (downsample + quantise)
``wire_s``                timer: host->device transfer of prepared wire data
``wire_bytes``            counter: bytes shipped over the wire
``device_s``              timer: blocking waits on queued device work
``chunk_s``               timer: whole-chunk wall time in the scheduler/bench
``gather_s``              timer: multi-process peak all-gathers
``chunks_done``           counter: chunks searched to completion
``chunks_retried``        counter: chunk dispatch attempts beyond the first
``chunks_skipped``        counter: chunks satisfied from the journal on resume
``queue_depth``           gauge: work items not yet collected
``dq_scanned_samples``    counter: samples through the data-quality scan
``dq_masked_samples``     counter: samples masked by the scan
``dq_ingest_nonfinite``   counter: non-finite samples seen at raw ingest
``series_quarantined``    counter: series dropped for exceeding max_masked_frac
``files_salvaged``        counter: malformed files read as a prefix (policy)
``files_skipped``         counter: malformed files dropped (policy)
``oom_bisections``        counter: DM-batch halvings after device OOM
``oom_predicted``         counter: DM-batch splits the peak-memory model made
``chunks_timed_out``      counter: dispatch attempts abandoned by the watchdog
``breaker_opens``         counter: circuit-breaker closed/half-open -> open
``chunks_parked``         counter: chunks set aside by the open breaker
``peer_losses``           counter: collectives degraded
``device_errors``         counter: non-OOM CUDA runtime errors hit in dispatch
``integrity_checks``      counter: result-integrity digest comparisons run
``integrity_mismatches``  counter: digest comparisons that DISAGREED
``shadow_probes``         counter: extra shadow/arbitration dispatches fired
``incidents``             counter: structured incident records emitted
``dispatch_cluster``      counter: peak programs queued with device clustering
``cluster_cols_device``   counter: peak columns taken from the device clusters
``cluster_cols_host``     counter: peak columns clustered on the host
``harmonic_suspects``     counter: advisory harmonic-screen hits
``ranges_queued``         counter: (search range x chunk) searches queued
``range.*.queue_s``       timer: host queue of one search range, by its name
``range.*.collect_s``     timer: host collect of one search range, by name
``heartbeat_age_s``       gauge: age of the stalest peer heartbeat
========================  ====================================================

The liveness counters (``chunks_timed_out`` .. ``device_errors``) are
always present in :meth:`summary` (zero when nothing fired) so survey
health dashboards and the bench JSON sub-metrics block have a stable
schema.

Derived rates (e.g. ``wire_MBps``, ``dq_masked_frac``) are computed by
:meth:`summary`, not stored.

Timers additionally feed fixed-log-bucket **histograms** (Prometheus
semantics: per-bucket counts + exact sum + count), so the obs layer's
text exposition (:mod:`riptide_tpu_torch.obs.prom`) can serve latency
distributions — not just totals — without a second recording path.
Because every ``observe`` lands in both the timer and its histogram,
a histogram's ``_sum`` always equals the timer's total seconds.
Non-timer distributions (e.g. per-chunk ``wire_MBps``) record through
:meth:`observe_hist`.
"""
import bisect
import threading
import time
from contextlib import contextmanager

__all__ = ["MetricsRegistry", "get_metrics", "set_metrics",
           "TIME_BUCKETS", "RATE_BUCKETS"]

# Fixed log buckets (Prometheus `le` upper bounds, +Inf implied).
# Durations: 1 ms .. ~17 min in 4x steps — spans a CPU-test chunk
# (~ms) through a slow survey chunk (~100 s). The JAX package's
# ladders, so the two Prometheus pages agree.
TIME_BUCKETS = (0.001, 0.004, 0.016, 0.064, 0.25, 1.0, 4.0, 16.0,
                64.0, 256.0, 1024.0)
# Rates in MB/s: 0.5 .. 1024 in 2x steps.
RATE_BUCKETS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                256.0, 512.0, 1024.0)

# Metric-name -> bucket ladder; anything unlisted uses TIME_BUCKETS
# (every timer is a duration unless declared otherwise).
HIST_BUCKETS = {"wire_MBps": RATE_BUCKETS}


class MetricsRegistry:
    """Thread-safe counters/timers/gauges with dict snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._timers = {}  # name -> [total_seconds, count]
        self._gauges = {}
        # name -> [per-bucket counts (len(buckets) + 1, last = overflow),
        #          sum, count]; buckets per HIST_BUCKETS.
        self._hists = {}

    # -- recording ----------------------------------------------------------

    def add(self, name, value=1):
        """Increment counter ``name`` by ``value``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def observe(self, name, seconds):
        """Accumulate ``seconds`` into timer ``name`` (and its
        histogram — one recording call feeds both, so the histogram sum
        can never drift from the timer total)."""
        with self._lock:
            t = self._timers.setdefault(name, [0.0, 0])
            t[0] += float(seconds)
            t[1] += 1
            self._hist_observe_locked(name, float(seconds))

    def observe_hist(self, name, value):
        """Record ``value`` into histogram ``name`` only (non-timer
        distributions, e.g. the per-chunk achieved ``wire_MBps``)."""
        with self._lock:
            self._hist_observe_locked(name, float(value))

    def _hist_observe_locked(self, name, value):
        h = self._hists.get(name)
        if h is None:
            nb = len(HIST_BUCKETS.get(name, TIME_BUCKETS))
            h = self._hists[name] = [[0] * (nb + 1), 0.0, 0]
        buckets = HIST_BUCKETS.get(name, TIME_BUCKETS)
        h[0][bisect.bisect_left(buckets, value)] += 1
        h[1] += value
        h[2] += 1

    @contextmanager
    def timer(self, name):
        """Context manager observing the enclosed block's wall time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def set_gauge(self, name, value):
        with self._lock:
            self._gauges[name] = value

    # -- reading ------------------------------------------------------------

    def counter(self, name, default=0):
        with self._lock:
            return self._counters.get(name, default)

    def timer_total(self, name, default=0.0):
        """Accumulated seconds of timer ``name`` (0.0 when never
        observed). Deltas of this across a code region attribute that
        region's share of a timer recorded deeper in the stack — e.g.
        the scheduler reads the engine's ``device_s`` around one chunk's
        dispatch to get that chunk's device seconds."""
        with self._lock:
            t = self._timers.get(name)
            return t[0] if t else default

    def snapshot(self):
        """Raw state: ``{"counters": {...}, "timers": {name: {"total_s",
        "count"}}, "gauges": {...}, "hists": {name: {"buckets",
        "counts", "sum", "count"}}}``. Values are plain JSON types;
        ``counts`` are per-bucket (non-cumulative) with one trailing
        overflow bucket (the Prometheus ``+Inf`` bucket)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "timers": {
                    k: {"total_s": round(v[0], 6), "count": v[1]}
                    for k, v in self._timers.items()
                },
                "gauges": dict(self._gauges),
                "hists": {
                    k: {
                        "buckets": list(HIST_BUCKETS.get(k, TIME_BUCKETS)),
                        "counts": list(v[0]),
                        "sum": round(v[1], 6),
                        "count": v[2],
                    }
                    for k, v in self._hists.items()
                },
            }

    def summary(self):
        """Flat dict of headline sub-metrics with derived rates: every
        counter and gauge verbatim, every timer as ``<name>`` total
        seconds, plus ``wire_MBps`` (wire_bytes / wire_s) when both were
        recorded. This is the block the journal records."""
        snap = self.snapshot()
        out = {}
        out.update(snap["counters"])
        out.update(snap["gauges"])
        for k, v in snap["timers"].items():
            out[k] = round(v["total_s"], 6)
        wire_s = out.get("wire_s")
        wire_bytes = out.get("wire_bytes")
        if wire_s and wire_bytes:
            out["wire_MBps"] = round(wire_bytes / 1e6 / wire_s, 3)
        scanned = out.get("dq_scanned_samples")
        if scanned:
            out["dq_masked_frac"] = round(
                out.get("dq_masked_samples", 0) / scanned, 6
            )
        # Survey-health counters keep a stable schema: always present,
        # zero when the corresponding machinery never fired.
        for name in ("chunks_timed_out", "breaker_opens", "chunks_parked",
                     "peer_losses", "device_errors", "integrity_checks",
                     "integrity_mismatches", "shadow_probes", "incidents"):
            out.setdefault(name, 0)
        return out

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._gauges.clear()
            self._hists.clear()


_default = MetricsRegistry()


def get_metrics():
    """The process-wide default registry."""
    return _default


def set_metrics(registry):
    """Replace the default registry (tests); returns the previous one."""
    global _default
    prev, _default = _default, registry
    return prev
