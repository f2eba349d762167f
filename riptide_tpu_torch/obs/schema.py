"""
The ONE timing-key schema of the survey path (the port's copy of the JAX
package's ``obs/schema.py``: the journal's per-chunk ``timing`` and
``integrity`` and ``hbm`` blocks and the ledger's run decomposition have the JAX
package's keys, so each package's readers take the other's records).

Two shapes:

* **run decomposition** (:func:`decomposition`) — where a whole timed
  pass went, derived from the metrics-registry summary: ``prep_s`` /
  ``wire_s`` / ``device_s`` totals, the achieved ``wire_MBps``, and the
  steady-state per-chunk cost ``chunk_s``.
* **per-chunk timing** (:func:`chunk_timing`) — one chunk's phase
  split as journaled by the survey scheduler: ``prep_s`` (host staging,
  OVERLAPPED with the previous chunk's device work — deliberately not
  part of the wall-clock sum), then the serial phases ``wire_s``
  (ship: queueing the copy to the card), ``queue_s`` (queueing the
  search), ``device_s`` (blocking device wait inside collect),
  ``collect_s`` (full collect call: device wait plus host peak decode)
  and ``host_s`` (everything else on the dispatch path: digest checks,
  fault hooks, retries' bookkeeping). ``wire_s + queue_s + collect_s +
  host_s == chunk_s`` by construction, so the decomposition always sums
  to the measured wall-clock. Each block also carries the chunk's
  achieved ``wire_MBps`` and a ``bound`` classification: ``tunnel``
  (the JAX package's word for a chunk whose host-to-device transfer
  rivals its device time) or ``device``.

:data:`LEGACY_ALIASES` records the aliasing contract for any key this
schema ever renames (currently none).
"""
__all__ = [
    "TIMING_VERSION", "PHASES", "DECOMPOSITION_KEYS", "CHUNK_TIMING_KEYS",
    "LEGACY_ALIASES", "decomposition", "chunk_timing", "classify_bound",
    "integrity_block", "hbm_block",
]

TIMING_VERSION = 1

# Phase names, in pipeline order (span names and timing-key prefixes).
PHASES = ("prep", "wire", "queue", "device", "collect", "host")

# Keys of a run-level decomposition block (the ledger's rows).
# cluster_s / postsearch_s total the post-pull host tail of the
# collects — the share the peak program's device clustering moves onto
# the device.
DECOMPOSITION_KEYS = ("prep_s", "wire_s", "device_s", "cluster_s",
                      "postsearch_s", "chunk_s", "wire_MBps")

# Keys of a journal chunk record's `timing` block. cluster_s and
# postsearch_s are REPORTED sub-phases of collect_s (the clustering
# tail and the whole post-pull host work) — like prep_s they are never
# part of the serial wall-clock sum, which stays
# wire_s + queue_s + collect_s + host_s == chunk_s.
CHUNK_TIMING_KEYS = ("prep_s", "wire_s", "queue_s", "device_s",
                     "collect_s", "cluster_s", "postsearch_s",
                     "host_s", "chunk_s", "wire_MBps", "bound")

# old key -> canonical key, kept readable for one release after a
# rename. Empty today: the schema adopted the historical names.
LEGACY_ALIASES = {}

# A chunk whose wire time rivals its device time is throughput-bound on
# the host->device transfer, not on compute. The margin keeps borderline
# chunks from flapping between labels on timer noise.
_TUNNEL_BOUND_RATIO = 0.8


def classify_bound(wire_s, device_s):
    """``"tunnel"`` when the wire transfer dominates (wire_s >= 0.8 x
    device_s), ``"device"`` otherwise — or ``"unknown"`` when no
    device time was measured at all (e.g. a path that never blocks on
    the device timer), where a ratio against zero would always scream
    "tunnel"."""
    if device_s <= 0.0:
        return "unknown"
    if wire_s >= _TUNNEL_BOUND_RATIO * device_s:
        return "tunnel"
    return "device"


def decomposition(summary, nchunks, elapsed):
    """Run-level decomposition block from a metrics-registry
    :meth:`~riptide_tpu_torch.survey.metrics.MetricsRegistry.summary`
    dict."""
    return {
        "prep_s": round(summary.get("prep_s", 0.0), 3),
        "wire_s": round(summary.get("wire_s", 0.0), 3),
        "device_s": round(summary.get("device_s", 0.0), 3),
        "cluster_s": round(summary.get("cluster_s", 0.0), 3),
        "postsearch_s": round(summary.get("postsearch_s", 0.0), 3),
        "chunk_s": round(elapsed / max(nchunks, 1), 3),
        "wire_MBps": summary.get("wire_MBps"),
    }


def chunk_timing(chunk_s, prep_s=0.0, wire_s=0.0, queue_s=0.0,
                 device_s=0.0, collect_s=0.0, cluster_s=0.0,
                 postsearch_s=0.0, wire_bytes=0):
    """One chunk's journal ``timing`` block. ``host_s`` is the serial
    remainder (``chunk_s`` minus ship/queue/collect), clamped at zero
    against timer skew, so the serial phases always sum to the measured
    wall-clock. ``prep_s`` is reported but excluded from the sum — host
    staging overlaps the previous chunk's device execution — and so are
    ``cluster_s`` / ``postsearch_s``, sub-phases already inside
    ``collect_s`` (the clustering tail and the whole post-pull host
    work of the collect; legacy readers simply never see the new keys,
    nothing they consume changed)."""
    host_s = max(0.0, chunk_s - wire_s - queue_s - collect_s)
    out = {
        "prep_s": round(prep_s, 6),
        "wire_s": round(wire_s, 6),
        "queue_s": round(queue_s, 6),
        "device_s": round(device_s, 6),
        "collect_s": round(collect_s, 6),
        "cluster_s": round(cluster_s, 6),
        "postsearch_s": round(postsearch_s, 6),
        "host_s": round(host_s, 6),
        "chunk_s": round(chunk_s, 6),
        "bound": classify_bound(wire_s, device_s),
    }
    if wire_bytes and wire_s > 0:
        out["wire_MBps"] = round(wire_bytes / 1e6 / wire_s, 3)
    return out


def hbm_block(predicted_bytes, actual_bytes, budget_bytes):
    """One chunk's journal ``hbm`` block, sibling of the ``timings``/
    ``dq`` blocks: the peak-memory model's predicted device bytes for
    the chunk's queued searches vs the measured peak
    (``torch.cuda.max_memory_allocated``), plus the seeding budget.
    ``actual_bytes`` is absent on the CPU (no device memory stats) AND
    on chunks that did not raise the process-lifetime high-water mark:
    only the mark-setting chunk's ratio is a calibration signal (see
    BatchSearcher.chunk_hbm_block). rreport's hbm section reduces
    these."""
    out = {"predicted_bytes": int(predicted_bytes),
           "budget_bytes": int(budget_bytes)}
    if actual_bytes:
        out["actual_bytes"] = int(actual_bytes)
        if predicted_bytes > 0:
            out["ratio"] = round(actual_bytes / predicted_bytes, 4)
    return out


def integrity_block(mode, result, peaks, path=None, probe=False,
                    votes=None):
    """One chunk's journal ``integrity`` block, sibling of ``timings``/
    ``dq``: the result-integrity layer's Ring 1 digests
    (:mod:`riptide_tpu_torch.survey.integrity`). ``result`` is the sha256
    fold over the raw collected device buffers (dtype + shape + bytes,
    in collect order — comparable only against another dispatch of the
    SAME chunk in the same process); ``peaks`` the digest over the
    journal's canonical peak-row serialisation, recomputable from
    replayed peaks so a resume can re-verify the record without the
    device. ``path`` labels the collect path (``batch``);
    ``probe`` marks a chunk whose record survived a Ring 2 shadow
    comparison, and ``votes`` (present only after a re-arbitration)
    the three short digests the majority vote saw."""
    out = {
        "v": 1,
        "algo": "sha256",
        "mode": str(mode),
        "result": result,
        "peaks": peaks,
    }
    if path:
        out["path"] = str(path)
    if probe:
        out["probe"] = True
    if votes:
        out["votes"] = list(votes)
    return out
