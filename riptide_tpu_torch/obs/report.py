"""
The reading half of the survey's observability artifacts that the
scheduler itself uses (the port's copy of part of the JAX package's
``obs/report.py``): the incremental journal follower, the fleet
sidecar readers and merge, the live signal vector the alert rules
evaluate, and the run decomposition of a ledger row. The report and
watch CLIs (``rreport``, ``rtop``, ``rwatch``) wait for a later slice;
the JAX package's tools read the port's journals as they are.

Stdlib-only: every reader applies the same lenient-line discipline as
the journal (a per-record CRC32 suffix stripped and verified, torn or
garbage lines skipped).
"""
import glob
import json
import os
import time
import zlib

__all__ = [
    "JournalFollower", "read_journal", "read_heartbeats", "read_fleet",
    "merge_fleet", "watch_snapshot", "run_decomposition_from_chunks",
    "strip_checksum", "parse_record_line",
]

_HEXDIGITS = frozenset(b"0123456789abcdef")


def strip_checksum(line):
    """``(payload, ok)`` of one record line (bytes): the `` #crc32``
    suffix removed when present. ``ok`` is False only when a suffix is
    present and its CRC does not match — a corrupted record the caller
    must drop. Suffix-less lines pass through unchanged (ok=True)."""
    if len(line) > 10 and line[-10:-8] == b" #" \
            and all(c in _HEXDIGITS for c in line[-8:]):
        payload = line[:-10]
        ok = line[-8:].decode() == format(
            zlib.crc32(payload) & 0xFFFFFFFF, "08x")
        return payload, ok
    return line, True


def parse_record_line(line):
    """One lenient record parse: checksum-stripped/verified JSON, or
    None for a torn, garbage or corrupt line."""
    payload, ok = strip_checksum(line.strip())
    if not ok:
        return None
    try:
        return json.loads(payload)
    except ValueError:
        return None


class JournalFollower:
    """Incremental journal reader for long-lived monitors.

    Keeps a byte offset into ``journal.jsonl`` between polls and folds
    only the *appended complete lines* into its running state, so each
    poll costs O(new data) rather than O(survey length) — the
    discipline a monitor watching a long campaign over a shared
    filesystem must keep. :meth:`poll` returns the same dict shape as
    :func:`read_journal` (which is a one-shot follower):

        {"directory", "header", "chunks": {cid: record},
         "parked": {cid: record}, "incidents": [...],
         "metrics": last summary or None}

    ``chunks`` keeps the LAST record per chunk id (a retried chunk's
    final journaling wins, matching the resume loader); ``parked``
    holds only chunks never subsequently completed. Journals written
    before incidents/utc existed parse identically (missing fields stay
    missing — every consumer here treats them as optional). A torn or
    still-being-written tail line does not advance the offset, so it is
    re-read whole on a later poll; a shrunken file (journal replaced)
    resets the state and re-reads from the start."""

    def __init__(self, journal_dir):
        self.directory = os.path.abspath(journal_dir)
        self._path = os.path.join(journal_dir, "journal.jsonl")
        self._offset = 0
        self._reset()

    def _reset(self):
        self._header = None
        self._chunks, self._parked, self._incidents = {}, {}, []
        self._alerts = []
        self._metrics = None

    def _fold(self, rec):
        kind = rec.get("kind")
        if kind == "header" and self._header is None:
            self._header = rec
        elif kind == "chunk":
            self._chunks[int(rec.get("chunk_id", -1))] = rec
        elif kind == "parked":
            self._parked[int(rec.get("chunk_id", -1))] = rec
        elif kind == "incident":
            self._incidents.append(rec)
        elif kind == "alert":
            # Alert-engine fire/resolve records; invisible to
            # kind-filtering readers that do not know them, and
            # journals without them simply yield an empty timeline.
            self._alerts.append(rec)
        elif kind == "metrics":
            self._metrics = rec.get("summary", self._metrics)

    def poll(self):
        """Fold any newly appended records and return the current
        state (see the class docstring for the shape)."""
        raw = b""
        try:
            with open(self._path, "rb") as fobj:
                fobj.seek(0, os.SEEK_END)
                if fobj.tell() < self._offset:
                    self._offset = 0
                    self._reset()
                fobj.seek(self._offset)
                raw = fobj.read()
        except OSError:
            pass
        end = raw.rfind(b"\n")
        if end >= 0:
            for line in raw[:end].split(b"\n"):
                if not line.strip():
                    continue
                obj = parse_record_line(line)
                if obj is not None:
                    self._fold(obj)
            self._offset += end + 1
        parked = {cid: rec for cid, rec in self._parked.items()
                  if cid not in self._chunks}
        return {"directory": self.directory, "header": self._header,
                "chunks": dict(self._chunks), "parked": parked,
                "incidents": list(self._incidents),
                "alerts": list(self._alerts),
                "metrics": self._metrics}


def read_journal(journal_dir):
    """One-shot parse of a journal directory into its record families
    (a fresh :class:`JournalFollower`'s first poll — see there for the
    shape and tolerance guarantees)."""
    return JournalFollower(journal_dir).poll()


def read_heartbeats(journal_dir, tail_bytes=4096):
    """``{process_index: newest heartbeat unix timestamp}`` from the
    ``heartbeat_*.jsonl`` sidecars, reading only each file's tail (the
    journal's own tail-read discipline — a monitor must stay O(1) in
    survey length)."""
    out = {}
    for path in glob.glob(os.path.join(journal_dir, "heartbeat_*.jsonl")):
        try:
            with open(path, "rb") as fobj:
                fobj.seek(0, os.SEEK_END)
                size = fobj.tell()
                fobj.seek(max(0, size - tail_bytes))
                tail = fobj.read()
        except OSError:
            continue
        for line in reversed([l for l in tail.split(b"\n") if l.strip()]):
            rec = parse_record_line(line)
            if isinstance(rec, dict) and "ts" in rec:
                out[int(rec.get("process", -1))] = float(rec["ts"])
                break
    return out


# Per-process status sidecars: each process of a run atomically rewrites
# `fleet_<p>.json` next to the journal after every chunk (see
# riptide_tpu_torch.obs.fleet — the writer half). A reader merges
# whatever sidecars exist into ONE fleet view. A process slower than
# this fraction of the fleet's median chunk rate is a straggler.

FLEET_STRAGGLER_FRAC = 0.5
# A sidecar older than this (seconds) marks its process stale in the
# merged view (the alert layer applies
# its own configurable staleness budget).
FLEET_STALE_S = 120.0


def read_fleet(journal_dir):
    """``{process_index: snapshot dict}`` from the ``fleet_*.json``
    sidecars of a journal directory. Sidecars are whole-file atomic
    writes (never torn); unparseable or foreign files are skipped, and
    a directory without any — every pre-fleet journal — reads as an
    empty fleet."""
    out = {}
    for path in glob.glob(os.path.join(journal_dir, "fleet_*.json")):
        try:
            with open(path, "rb") as fobj:
                raw = fobj.read()
        except OSError:
            continue
        obj = parse_record_line(raw.strip())
        if not isinstance(obj, dict):
            continue
        try:
            out[int(obj["process"])] = obj
        except (KeyError, TypeError, ValueError):
            # Foreign/hand-edited file matching the glob: skip, per
            # this reader's contract — a bad sidecar must not crash
            # every fleet surface (/status, the alert engine).
            continue
    return out


def merge_fleet(snapshots, now=None, stale_s=FLEET_STALE_S):
    """One fleet view over per-process snapshots (see
    :func:`read_fleet`): per-process rows plus cross-process totals,
    the chunk-rate skew spread, straggler processes (rate below
    :data:`FLEET_STRAGGLER_FRAC` of the fleet median) and stale
    processes (snapshot older than ``stale_s``)."""
    now = time.time() if now is None else now
    processes, rates = {}, {}
    totals = {"chunks_done": 0, "chunks_parked": 0}
    bound_counts = {}
    for p in sorted(snapshots):
        snap = snapshots[p]
        ts = snap.get("ts")
        age = None if ts is None else round(max(0.0, now - float(ts)), 3)
        row = {
            "chunks_done": int(snap.get("chunks_done") or 0),
            "chunks_parked": int(snap.get("chunks_parked") or 0),
            "chunk_in_flight": snap.get("chunk_in_flight"),
            "running": bool(snap.get("running")),
            "breaker": snap.get("breaker"),
            "rate_chunks_per_s": snap.get("rate_chunks_per_s"),
            "bound_counts": snap.get("bound_counts") or {},
            "phases": snap.get("phases") or {},
            "snapshot_age_s": age,
            "last_incident": (snap.get("last_incident") or {}).get(
                "incident") if snap.get("last_incident") else None,
            "obs_write_errors": int(snap.get("counters", {}).get(
                "obs_write_errors", 0)),
        }
        processes[str(p)] = row
        totals["chunks_done"] += row["chunks_done"]
        totals["chunks_parked"] += row["chunks_parked"]
        for k, v in row["bound_counts"].items():
            bound_counts[k] = bound_counts.get(k, 0) + int(v)
        if row["rate_chunks_per_s"]:
            rates[str(p)] = float(row["rate_chunks_per_s"])
    out = {
        "processes": processes,
        "nprocesses": len(processes),
        "chunks_done": totals["chunks_done"],
        "chunks_parked": totals["chunks_parked"],
        "bound_counts": bound_counts,
        "stale": sorted(
            p for p, row in processes.items()
            if row["snapshot_age_s"] is not None
            and row["running"] and row["snapshot_age_s"] > stale_s),
        "stragglers": [],
    }
    if rates:
        med = _median(list(rates.values()))
        out["rate_chunks_per_s"] = round(sum(rates.values()), 4)
        out["skew"] = {
            "rate_min": round(min(rates.values()), 4),
            "rate_median": round(med, 4),
            "rate_max": round(max(rates.values()), 4),
            "ratio": round(max(rates.values())
                           / max(min(rates.values()), 1e-9), 2),
        }
        out["stragglers"] = sorted(
            p for p, r in rates.items()
            if med and r < FLEET_STRAGGLER_FRAC * med)
    return out


# Chunks the windowed signals of watch_snapshot are computed over: a
# windowed signal RESOLVES once the offending chunks age out, where a
# whole-run aggregate would latch forever.
WATCH_WINDOW = 8


def watch_snapshot(state, heartbeats=None, now=None, window=WATCH_WINDOW):
    """The live signal vector the alert rules evaluate, derived from a
    :class:`JournalFollower` poll ``state`` (plus the heartbeat
    sidecars). This is the ONE derivation shared by the in-process
    scheduler engine and an out-of-process
    follower, so both fire on identical evidence.

    Keys (None = signal not measurable yet):

    * ``chunks_done`` / ``chunks_total`` / ``chunks_parked`` /
      ``complete`` — progress;
    * ``consecutive_tunnel`` — how many of the newest chunks, counting
      back from the latest, were tunnel-bound;
    * ``straggler_ratio`` — slowest/median chunk wall-clock over the
      last ``window`` chunks;
    * ``heartbeat_age_s`` — age of the FRESHEST heartbeat (a run is
      stalled only when even its newest beat is old);
    * ``obs_write_failures`` — count of ``obs_write_failed`` incidents
      so far (a monotone series the growth rule differentiates);
    * ``hbm_ratio_median`` — actual/predicted peak-HBM ratio over the
      windowed chunks (model drift signal);
    * ``integrity_mismatches`` — count of result-integrity divergence
      incidents (``result_mismatch``/``canary_failed``) so far: the
      journal-derived twin of the scheduler's counter, so the
      ``integrity`` alert rule fires on identical evidence in-process
      and from outside;
    * ``integrity_probed`` — how many of the windowed chunks' records
      carry a shadow-verified ``integrity`` block (coverage signal;
      older journals simply report 0).
    """
    now = time.time() if now is None else now
    header = state.get("header") or {}
    chunks = state.get("chunks") or {}
    total = header.get("chunks_total")
    parked = state.get("parked") or {}
    recent = [chunks[cid] for cid in sorted(chunks)][-int(window):]
    walls, bounds, hbm_ratios = [], [], []
    integrity_probed = 0
    for rec in recent:
        t = rec.get("timings") or {}
        w = float(t.get("chunk_s", 0.0))
        if w > 0:
            walls.append(w)
        bounds.append(t.get("bound"))
        h = rec.get("hbm") or {}
        if h.get("ratio") is not None:
            hbm_ratios.append(float(h["ratio"]))
        if (rec.get("integrity") or {}).get("probe"):
            integrity_probed += 1
    consecutive_tunnel = 0
    for b in reversed(bounds):
        if b != "tunnel":
            break
        consecutive_tunnel += 1
    straggler_ratio = None
    if len(walls) >= 2:
        med = _median(walls)
        if med:
            straggler_ratio = round(max(walls) / med, 3)
    beat_age = None
    if heartbeats:
        beat_age = round(max(0.0, now - max(heartbeats.values())), 3)
    done = len(chunks)
    return {
        "now": now,
        "survey_id": header.get("survey_id"),
        "chunks_total": total,
        "chunks_done": done,
        "chunks_parked": len(parked),
        "complete": (total is not None
                     and done + len(parked) >= int(total)),
        "consecutive_tunnel": consecutive_tunnel,
        "straggler_ratio": straggler_ratio,
        "heartbeat_age_s": beat_age,
        "obs_write_failures": sum(
            1 for inc in state.get("incidents") or ()
            if inc.get("incident") == "obs_write_failed"),
        "hbm_ratio_median": (round(_median(hbm_ratios), 4)
                             if hbm_ratios else None),
        "integrity_mismatches": sum(
            1 for inc in state.get("incidents") or ()
            if inc.get("incident") in ("result_mismatch",
                                       "canary_failed")),
        "integrity_probed": integrity_probed,
    }


def _median(vals):
    s = sorted(vals)
    n = len(s)
    if not n:
        return None
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def run_decomposition_from_chunks(timings):
    """Run-level decomposition derived from journal chunk ``timings``
    blocks: phase totals, mean ``chunk_s``, median per-chunk
    ``wire_MBps``, ``nchunks`` and the ``bound_counts`` split. This is
    the ONE derivation shared by the scheduler's ledger row and
    a report's comparison side, so a run always compares equal against
    its own ledger row."""
    timings = [t for t in timings if t]
    n = len(timings)
    out = {"prep_s": 0.0, "wire_s": 0.0, "device_s": 0.0,
           "cluster_s": 0.0, "postsearch_s": 0.0,
           "chunk_s": 0.0, "wire_MBps": None}
    bound_counts = {}
    if not n:
        return out, 0, bound_counts
    for key in ("prep_s", "wire_s", "device_s", "cluster_s",
                "postsearch_s"):
        out[key] = round(sum(float(t.get(key, 0.0)) for t in timings), 6)
    out["chunk_s"] = round(
        sum(float(t.get("chunk_s", 0.0)) for t in timings) / n, 6)
    rates = [float(t["wire_MBps"]) for t in timings
             if t.get("wire_MBps") is not None]
    if rates:
        out["wire_MBps"] = round(_median(rates), 3)
    for t in timings:
        b = t.get("bound", "unknown")
        bound_counts[b] = bound_counts.get(b, 0) + 1
    return out, n, bound_counts
