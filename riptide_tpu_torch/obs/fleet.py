"""
Per-process fleet status sidecars: the writer half of the fleet plane
(the port's copy of the JAX package's ``obs/fleet.py``, with its
sidecar schema).

A multi-process run (several schedulers sharing a run directory) has N
processes each holding rich live state — chunk progress, breaker
state, bound counts, phase totals, the last incident. This module makes
that state durable and mergeable: each process atomically rewrites ONE
small JSON sidecar, ``fleet_<p>.json``, next to the journal after
every chunk (the heartbeat-sidecar discipline: single writer per file,
no cross-process contention, whole-file atomic replace so a reader
never sees a torn page). Any reader — ``/status``'s ``fleet`` block,
the JAX package's report tools — merges whatever sidecars exist via
:func:`riptide_tpu_torch.obs.report.read_fleet` /
:func:`~riptide_tpu_torch.obs.report.merge_fleet` into one fleet view.

Fleet writes are **observability, never correctness**: a failed write
degrades to an ``obs_write_failed`` incident + ``obs_write_errors``
counter (:func:`write_snapshot` returns None) and the survey carries
on. Disable
entirely with ``RIPTIDE_FLEET=0``.

Snapshot schema (version :data:`FLEET_VERSION`; readers treat every
field as optional so the schema can grow):

``kind`` (``"fleet"``), ``v``, ``process``, ``ts`` (unix seconds),
``utc``, ``survey_id``, ``running``, ``chunks_done``,
``chunks_parked``, ``chunk_in_flight``, ``rate_chunks_per_s``,
``breaker``, ``bound_counts``, ``phases`` (per-phase total seconds
over this process's chunks), ``counters`` (the health counters),
``last_incident``.
"""
import json
import logging
import os
import time

from ..utils import envflags, fsio
from .alerts import _utc_iso

log = logging.getLogger("riptide_tpu_torch.obs.fleet")

__all__ = ["FLEET_VERSION", "enabled", "fleet_path", "snapshot",
           "phase_totals", "write_snapshot"]

FLEET_VERSION = 1


def enabled():
    """Whether fleet sidecar writes are on (``RIPTIDE_FLEET``)."""
    return bool(envflags.get("RIPTIDE_FLEET"))


def fleet_path(directory, process_index):
    """``fleet_<p>.json`` path of one process's sidecar."""
    return os.path.join(directory, f"fleet_{int(process_index):04d}.json")


def phase_totals(timings):
    """Per-phase total seconds over a run's chunk ``timings`` blocks
    (the fleet snapshot's ``phases`` field — what a report's fleet
    section turns into per-process phase attribution)."""
    out = {}
    for t in timings or ():
        for key, val in (t or {}).items():
            if key.endswith("_s"):
                out[key] = round(out.get(key, 0.0) + float(val), 6)
    return out


def snapshot(process_index, status=None, metrics=None, timings=None,
             ts=None):
    """Build one process's fleet snapshot dict.

    ``status`` is a scheduler-:meth:`~riptide_tpu_torch.survey.scheduler.
    SurveyScheduler.status`-shaped dict (every field optional — the
    multihost layer passes a minimal one); ``metrics`` a registry for
    the health counters; ``timings`` this process's journaled chunk
    timing blocks (phase totals + bound counts)."""
    status = status or {}
    ts = time.time() if ts is None else float(ts)
    bound_counts = {}
    for t in timings or ():
        b = (t or {}).get("bound")
        if b:
            bound_counts[b] = bound_counts.get(b, 0) + 1
    counters = {}
    if metrics is not None:
        # The health counters the fleet view compares per process.
        # A literal dict, the JAX package's keys: the prom federation
        # renders whatever keys the sidecar carries, so extending
        # this dict is a one-place change.
        counters = {
            "obs_write_errors": int(metrics.counter("obs_write_errors")),
            "incidents": int(metrics.counter("incidents")),
            "chunks_retried": int(metrics.counter("chunks_retried")),
            "chunks_timed_out": int(metrics.counter("chunks_timed_out")),
            "oom_bisections": int(metrics.counter("oom_bisections")),
            "integrity_mismatches":
                int(metrics.counter("integrity_mismatches")),
        }
    return {
        "kind": "fleet",
        "v": FLEET_VERSION,
        "process": int(process_index),
        "ts": round(ts, 3),
        "utc": _utc_iso(ts),
        "survey_id": status.get("survey_id"),
        "running": bool(status.get("running")),
        "chunks_done": status.get("chunks_done"),
        "chunks_parked": status.get("chunks_parked"),
        "chunk_in_flight": status.get("chunk_in_flight"),
        "rate_chunks_per_s": status.get("rate_chunks_per_s"),
        "breaker": status.get("breaker"),
        "bound_counts": bound_counts,
        "phases": phase_totals(timings),
        "counters": counters,
        "last_incident": status.get("last_incident"),
    }


def write_snapshot(directory, snap):
    """Atomically (re)write ``snap`` to its ``fleet_<p>.json`` sidecar
    under ``directory``; returns the path, or None when degraded.

    Never fatal (the obs-writes invariant): ENOSPC, EIO or a failing
    fsync becomes an ``obs_write_failed`` incident + counter and the
    caller's survey completes. Storage faults inject through the
    ``fleet_snapshot`` fsio site."""
    path = fleet_path(directory, snap.get("process", 0))
    try:
        fsio.atomic_write_bytes(
            path, json.dumps(snap, separators=(",", ":")).encode(),
            site="fleet_snapshot")
    except OSError as err:
        log.warning("fleet snapshot write to %r failed: %s", path, err)
        from .ledger import _obs_write_failed

        _obs_write_failed("fleet_snapshot", path, err)
        return None
    return path
