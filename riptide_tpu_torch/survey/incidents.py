"""
Structured incident records: the forensic trail of a degraded run (the
port's copy of the JAX package's ``survey/incidents.py::emit``; its
sinks, which journal the records, come with the journal).

Each call to :func:`emit` produces a journal-shaped record::

    {"kind": "incident", "incident": "oom_bisection",
     "utc": "...Z", "chunk_id": 3, "span_id": 41217,
     "detail": {"batch": 16, ...}}

``span_id`` is the id of the span open on the emitting thread
(:func:`riptide_tpu_torch.obs.trace.current_span_id`), absent while
tracing is disabled. An incident bumps the ``incidents`` counter and is
logged; emitting one is never an error.
"""
import logging
from datetime import datetime, timezone

from .metrics import get_metrics

log = logging.getLogger("riptide_tpu_torch.survey.incidents")

__all__ = ["emit"]


def _utc_iso():
    """UTC wall-clock timestamp, ISO-8601 with a Z suffix."""
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] \
        + "Z"


def emit(kind, chunk_id=None, **detail):
    """Record one incident: builds the record (UTC stamp, active span
    id, JSON-safe detail), bumps the ``incidents`` counter, logs it and
    returns it."""
    from ..obs.trace import current_span_id

    rec = {"kind": "incident", "incident": str(kind), "utc": _utc_iso()}
    if chunk_id is not None:
        rec["chunk_id"] = int(chunk_id)
    sid = current_span_id()
    if sid is not None:
        rec["span_id"] = int(sid)
    if detail:
        rec["detail"] = {k: _json_safe(v) for k, v in detail.items()}
    get_metrics().add("incidents")
    log.warning("incident: %s%s", kind,
                f" (chunk {chunk_id})" if chunk_id is not None else "")
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
