"""
Structured incident records: the forensic trail of a degraded run (the
port's copy of the JAX package's ``survey/incidents.py``, with its
record shape and its run-context sinks).

The liveness/robustness layers already *count* what goes wrong
(``chunks_timed_out``, ``breaker_opens``, ``oom_bisections``, ...) and
*log* it as prose, but a post-mortem needs the event sequence as data:
when did the watchdog fire, on which chunk, with what budget; when did
the breaker open; which files were quarantined. This module is the one
emission point. Each call to :func:`emit` produces a journal-shaped
record::

    {"kind": "incident", "incident": "watchdog_timeout",
     "utc": "...Z", "chunk_id": 3, "span_id": 41217,
     "detail": {"budget_s": 12.0, ...}}

``span_id`` is the id of the span open on the emitting thread
(:func:`riptide_tpu_torch.obs.trace.current_span_id`), so an incident can be
correlated with the exact span in an exported Chrome trace; it is None
while tracing is disabled.

Emission is decoupled from storage, with two sink layers. If the
emitting thread belongs to a job-scoped
:class:`~riptide_tpu_torch.utils.runctx.RunContext` (installed by
``SurveyScheduler.run()``), that context's ``incident_sink`` receives
the record — so two concurrent runs each journal ONLY their own
incidents. Otherwise the process-wide sink installed via
:func:`set_sink` (what every batch CLI path uses) applies.
With no sink at either layer (non-journaled runs) an incident still
bumps the ``incidents`` counter and is retained as
:func:`last_incident` for the ``/status`` surface — it is never an
error to emit one.

Journal readers are tolerant by construction: every reader filters
records by ``kind``, so ``incident`` lines are invisible to readers
that do not know them, and journals without them read back an empty
incident list.
"""
import logging
import threading

from ..utils import runctx
from .journal import _utc_iso
from .metrics import get_metrics

log = logging.getLogger("riptide_tpu_torch.survey.incidents")

__all__ = ["emit", "set_sink", "last_incident", "clear_last",
           "INCIDENT_KINDS"]

# The catalog of incident kinds (the JAX package's; the port emits the
# survey-path ones, the service kinds wait for the serve plane).
# emit() accepts unlisted kinds — the catalog is a reference, not a
# gate — but staying on it keeps reports groupable.
INCIDENT_KINDS = (
    "watchdog_timeout",   # liveness: dispatch abandoned at its deadline
    "breaker_open",       # scheduler: circuit breaker tripped open
    "chunk_parked",       # scheduler: chunk set aside without completing
    "oom_bisection",      # batcher: DM batch halved after device OOM
    "quarantine",         # quality: series dropped by the DQ scan
    "peer_loss",          # multihost: degraded to local-only mode
    "storage_recovered",  # journal/fsio: torn tail truncated or healed
    "record_corrupt",     # journal: checksum-failed record(s) dropped
    "obs_write_failed",   # ledger/trace/prom/heartbeat/fleet write degraded
    "cache_corrupt",      # exec cache: corrupt entry evicted + rebuilt
    "alert_fired",        # obs.alerts: a rule started firing
    "alert_resolved",     # obs.alerts: a firing rule cleared
    "job_rejected",       # serve: admission refused (capacity/quota)
    "quota_exceeded",     # serve: tenant device-seconds budget exhausted
    "job_cancelled",      # serve: job cancelled at a chunk boundary
    "job_timeout",        # serve: per-job deadline_s exceeded at the gate
    "device_error",       # scheduler: non-OOM device runtime error exhausted
    "result_mismatch",    # integrity: result digests diverged (shadow/replay)
    "integrity_quarantine",  # integrity: device marked suspect, chunks parked
    "canary_failed",      # integrity: golden canary missed its pinned digest
    "job_drained",        # serve: job parked resumable at a drain boundary
)

_lock = threading.Lock()
_sink = None
_last = None


def set_sink(sink):
    """Install ``sink(record)`` as the process-wide incident store
    (normally a journal's ``record_incident``); returns the previous
    sink so callers can restore it. ``None`` uninstalls."""
    global _sink
    with _lock:
        prev, _sink = _sink, sink
    return prev


def last_incident():
    """The most recently emitted incident record (or None) — the
    ``last_incident`` field of the live ``/status`` surface."""
    with _lock:
        return _last


def clear_last():
    """Forget the retained incident. Called at run start (the survey
    scheduler, journaled rseek) so a fresh run's ``/status`` never
    reports a PREVIOUS run's incident as its own; after a run it stays
    queryable until the next one starts."""
    global _last
    with _lock:
        _last = None


def emit(kind, chunk_id=None, **detail):
    """Record one incident. Builds the record (UTC stamp, active span
    id, JSON-safe detail), bumps the ``incidents`` counter, retains it
    for :func:`last_incident` and hands it to the installed sink.
    Emission is best-effort: a failing sink is logged, never raised —
    an incident must not take down the run it is describing."""
    from ..obs.trace import current_span_id

    global _last
    rec = {"kind": "incident", "incident": str(kind), "utc": _utc_iso()}
    if chunk_id is not None:
        rec["chunk_id"] = int(chunk_id)
    sid = current_span_id()
    if sid is not None:
        rec["span_id"] = int(sid)
    if detail:
        rec["detail"] = {k: _json_safe(v) for k, v in detail.items()}
    get_metrics().add("incidents")
    with _lock:
        _last = rec
        sink = _sink
    # Context-first resolution: a thread owned by a run context
    # journals into ITS sink; the process-global sink stays the
    # fallback so batch paths are byte-unchanged.
    ctx = runctx.current()
    if ctx is not None:
        ctx.note_incident(rec)
        if ctx.incident_sink is not None:
            sink = ctx.incident_sink
    log.warning("incident: %s%s", kind,
                f" (chunk {chunk_id})" if chunk_id is not None else "")
    if sink is not None:
        try:
            sink(rec)
        except Exception as err:
            log.warning("incident sink failed for %r: %s", kind, err)
    return rec


def _json_safe(value):
    """Coerce a detail value to a JSON-representable type (numpy
    scalars and arbitrary objects become their float/str forms)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)
