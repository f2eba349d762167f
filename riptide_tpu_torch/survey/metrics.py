"""
Metrics registry for survey runs: the counters and gauges of the JAX
package's ``survey/metrics.py`` (its timers and histograms come with
the survey scheduler).

Counters (monotonic sums) and gauges (last-set values), behind one
lock, with a process-wide default registry reachable from any layer
via :func:`get_metrics`. The batcher and the data-quality steps record
into it unconditionally: recording is one dict operation under a lock.

Metric names the port records (a summary holds whatever was recorded):

========================  ====================================================
``chunks_done``           counter: chunks searched to completion
``queue_depth``           gauge: chunks not yet collected
``dq_scanned_samples``    counter: samples through the data-quality scan
``dq_masked_samples``     counter: samples masked by the scan
``series_quarantined``    counter: series dropped for exceeding max_masked_frac
``dq_ingest_nonfinite``   counter: non-finite samples seen at ingest
``files_salvaged``        counter: malformed files read up to their damage
``files_skipped``         counter: malformed files skipped
``oom_bisections``        counter: DM-batch halvings after device OOM
``incidents``             counter: structured incident records emitted
========================  ====================================================
"""
import threading

__all__ = ["MetricsRegistry", "get_metrics", "set_metrics"]


class MetricsRegistry:
    """Thread-safe counters and gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}

    def add(self, name, value=1):
        """Increment counter ``name`` by ``value``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name, value):
        with self._lock:
            self._gauges[name] = value

    def counter(self, name, default=0):
        with self._lock:
            return self._counters.get(name, default)

    def summary(self):
        """Flat dict: every counter and gauge, and ``dq_masked_frac``
        (masked over scanned samples) when samples were scanned."""
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
        scanned = out.get("dq_scanned_samples")
        if scanned:
            out["dq_masked_frac"] = round(
                out.get("dq_masked_samples", 0) / scanned, 6)
        return out


_default = MetricsRegistry()


def get_metrics():
    """The process-wide default registry."""
    return _default


def set_metrics(registry):
    """Replace the default registry (tests); returns the previous one."""
    global _default
    prev, _default = _default, registry
    return prev
