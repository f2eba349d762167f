"""
Append-only survey journal: the crash-safe record of completed work
(the port's copy of the JAX package's ``survey/journal.py``: the same
records, lines and checksums, so each package resumes the other's
journals).

Two JSONL files live in the journal directory:

* ``journal.jsonl`` — one record per event: a ``header`` naming the
  survey (an identity digest over the input files and search config,
  so a journal cannot silently resume a different survey), one
  ``chunk`` record per completed work unit (chunk id, input files, DM
  values, wire digest, peak-store offsets, attempt count, a ``timings``
  phase decomposition — see :mod:`riptide_tpu_torch.obs.schema` — and a UTC
  ISO-8601 wall-clock stamp; readers tolerate records without the
  newer fields, so pre-existing journals resume unchanged),
  ``parked`` records for chunks the circuit breaker set aside (a
  parked chunk has no completed record, so a later resume re-dispatches
  it), structured ``incident`` records (watchdog timeouts, breaker
  opens, OOM bisections, quarantines, peer losses — see
  :mod:`riptide_tpu_torch.survey.incidents`; invisible to kind-filtering
  readers, so pre-incident journals and readers interoperate both
  ways) and optional ``metrics`` snapshots.

Per-process ``heartbeat_<p>.jsonl`` sidecars carry liveness beats for
multi-host peer-loss detection: each process appends only to its OWN
sidecar (no cross-process write contention on shared storage) and the
:class:`~riptide_tpu_torch.survey.liveness.PeerLivenessMonitor` reads them
all to decide who is alive and who writes the shared journal.
* ``peaks.jsonl`` — the peak store: one line per peak, eight numeric
  fields in :data:`PEAK_FIELDS` order, full float precision (JSON
  round-trips float64 exactly), so a resumed survey reproduces
  byte-identical final data products.

Appends are atomic at the line level: each record is a single
``write()`` of one ``\\n``-terminated line on an ``O_APPEND`` fd,
followed by ``fsync`` (via :mod:`riptide_tpu_torch.utils.fsio`, which is also
where storage faults inject). Journal and peak-store lines carry a
per-record CRC32 suffix (`` #xxxxxxxx`` after the JSON payload) so a
*corrupted* record — bit rot, a lying disk — is distinguishable from a
*torn* one (kill mid-append); checksum-less lines parse as legacy, so
journals written before the suffix existed resume unchanged.

Recovery happens once per writing run (:meth:`SurveyJournal.write_header`
calls :meth:`SurveyJournal.recover`): a torn or corrupt TAIL of either
file is truncated back to the last good record (appending after a torn
tail would glue the next record onto the fragment, losing both), and
peak-store rows beyond every chunk record's claim — the process died
between the peak append and the chunk record — are truncated too, so a
re-dispatched chunk re-appends its peaks at the same offsets and the
final data products stay byte-identical. Both recoveries are
incident-recorded (``storage_recovered``); corrupt records in the
MIDDLE of the journal are never truncated, only dropped at read (and
incident-recorded as ``record_corrupt`` during recovery). The loader
additionally reconciles every chunk record against the peak store: a
chunk whose claimed ``[peaks_offset, peaks_offset + peaks_count)`` rows
are missing is treated as never completed and re-dispatched by the
scheduler.
"""
import json
import logging
import os
from datetime import datetime, timezone

from ..peak_detection import PEAK_FIELDS, PEAK_INT_FIELDS, Peak
from ..utils import fsio

log = logging.getLogger("riptide_tpu_torch.survey.journal")

__all__ = ["SurveyJournal", "JournalMismatch", "PEAK_FIELDS"]

JOURNAL_VERSION = 1


class JournalMismatch(ValueError):
    """The journal on disk belongs to a different survey (different
    input files or search config)."""


def _utc_iso():
    """UTC wall-clock timestamp, ISO-8601 with a Z suffix. Journal and
    heartbeat records carry one for operators correlating a survey with
    external logs; monotonic deltas stay authoritative for DURATIONS
    (wall clocks step under NTP). Readers must tolerate records without
    it — journals written before this field existed resume fine."""
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] \
        + "Z"


def _append_lines(path, objs, site=None, checksum=True):
    """Append JSON lines in ONE write on an O_APPEND fd, fsync'd once
    before returning — a chunk's whole peak batch costs a single
    open/write/fsync cycle, and each line is still torn-tolerantly
    parseable (and, with ``checksum``, corruption-detectable) on its
    own."""
    fsio.append_jsonl(path, objs, site=site, checksum=checksum)


def _append_line(path, obj, site=None, checksum=True):
    """Single-write append of one JSON line, fsync'd before returning."""
    _append_lines(path, [obj], site=site, checksum=checksum)


def _read_lines(path):
    """Parsed JSON objects of every valid complete line. Torn final
    lines, unparseable garbage and checksum-failed records are dropped
    (recovery — which truncates bad tails and incident-records the
    rest — is a WRITER-side act; reading stays read-only so monitors
    can share a live journal)."""
    out = []
    for i, (obj, status, _) in enumerate(fsio.scan_jsonl(path)[0]):
        if obj is not None and status in ("ok", "legacy"):
            out.append(obj)
        else:
            log.warning("%s: dropping %s record at line %d",
                        path, status, i + 1)
    return out


def _read_last_record(path, tail_bytes=4096):
    """Newest parseable JSON record of an append-only file, reading
    only the final ``tail_bytes`` — heartbeat sidecars grow by one line
    per chunk and only the last beat matters, so a full parse would
    make liveness checks O(survey length) each. A torn final line (or
    a first line truncated by the tail window) is skipped, as are
    checksum-suffixed records whose CRC no longer matches."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - tail_bytes))
            tail = f.read()
    except OSError:
        return None
    for line in reversed([l for l in tail.split(b"\n") if l]):
        payload, status = fsio.split_checksum(line)
        if status == "corrupt":
            continue
        try:
            return json.loads(payload)
        except ValueError:
            continue
    return None


def _peak_to_row(p):
    return [int(getattr(p, f)) if f in PEAK_INT_FIELDS
            else float(getattr(p, f)) for f in PEAK_FIELDS]


def _row_to_peak(row):
    kw = {f: (int(v) if f in PEAK_INT_FIELDS else float(v))
          for f, v in zip(PEAK_FIELDS, row)}
    return Peak(**kw)


class SurveyJournal:
    """
    Parameters
    ----------
    directory : str
        Journal directory (created if missing). Holds ``journal.jsonl``
        and ``peaks.jsonl``.
    """

    def __init__(self, directory):
        self.directory = os.path.realpath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.journal_path = os.path.join(self.directory, "journal.jsonl")
        self.peaks_path = os.path.join(self.directory, "peaks.jsonl")
        self._peak_rows = None  # lazily loaded peak-store line count
        self._header_cache = None  # immutable once written (see _header)
        self._recovered = False

    # -- crash recovery -----------------------------------------------------

    def _truncate(self, path, length, reason, dropped):
        fd = os.open(path, os.O_WRONLY)
        try:
            os.ftruncate(fd, length)
            os.fsync(fd)
        finally:
            os.close(fd)
        log.warning("%s: truncated to %d bytes (%s, %d record(s) "
                    "dropped)", path, length, reason, dropped)
        from .incidents import emit

        emit("storage_recovered", action=reason,
             path=os.path.basename(path), records=int(dropped))

    def _recover_file(self, path):
        """Truncate a torn/corrupt TAIL back to the last good record;
        incident-record (without truncating) corrupt records in the
        middle. Returns the surviving parsed records."""
        entries, size = fsio.scan_jsonl(path)
        good, good_end, tail_bad, mid_bad = [], 0, 0, 0
        for obj, status, end in entries:
            if obj is not None and status in ("ok", "legacy"):
                good.append(obj)
                good_end = end
                mid_bad += tail_bad
                tail_bad = 0
            else:
                tail_bad += 1
        if tail_bad:
            self._truncate(path, good_end, "truncated_torn_tail",
                           tail_bad)
        if mid_bad:
            # Mid-file damage cannot be truncated away without losing
            # good records after it; readers drop the lines and — for
            # chunk records — the resume loader re-dispatches them.
            log.warning("%s: %d corrupt/garbage record(s) mid-file "
                        "(dropped at read)", path, mid_bad)
            from .incidents import emit

            emit("record_corrupt", path=os.path.basename(path),
                 records=int(mid_bad))
        return good

    def recover(self):
        """One-shot crash recovery before this process first appends
        (invoked by :meth:`write_header`; idempotent per instance, and
        a no-op — byte-for-byte — on a healthy journal):

        1. torn/corrupt tails of ``journal.jsonl`` and ``peaks.jsonl``
           are truncated back to the last good record;
        2. peak-store rows beyond every chunk record's claimed range
           (the writer died after the peak append, before the chunk
           record) are truncated, so the re-dispatched chunk re-appends
           at the same offsets and data products stay byte-identical.
        """
        if self._recovered:
            return
        self._recovered = True
        recs = self._recover_file(self.journal_path)
        if not os.path.exists(self.peaks_path):
            return
        self._recover_file(self.peaks_path)
        claimed = 0
        for rec in recs:
            if rec.get("kind") == "chunk":
                claimed = max(claimed, int(rec.get("peaks_offset", 0))
                              + int(rec.get("peaks_count", 0)))
        entries, _ = fsio.scan_jsonl(self.peaks_path)
        rows = [(obj, end) for obj, status, end in entries
                if obj is not None and status in ("ok", "legacy")]
        self._peak_rows = None
        if len(rows) <= claimed:
            return
        end = rows[claimed - 1][1] if claimed else 0
        self._truncate(self.peaks_path, end, "truncated_orphan_peaks",
                       len(rows) - claimed)

    # -- writing ------------------------------------------------------------

    def write_header(self, survey_id, chunks_total):
        """Record the survey identity. Idempotent for a matching id; a
        journal holding a DIFFERENT survey raises :class:`JournalMismatch`
        rather than silently mixing two surveys' chunks. As the first
        write-intent call of every run it also performs crash recovery
        (:meth:`recover`) so this process never appends after a torn
        tail."""
        self.recover()
        hdr = self._header()
        if hdr is not None:
            if hdr.get("survey_id") != survey_id:
                raise JournalMismatch(
                    f"journal at {self.directory!r} belongs to survey "
                    f"{hdr.get('survey_id')!r}, not {survey_id!r}; refusing "
                    "to resume (point --journal elsewhere or delete it)"
                )
            return
        _append_line(self.journal_path, {
            "kind": "header", "version": JOURNAL_VERSION,
            "survey_id": survey_id, "chunks_total": int(chunks_total),
            "utc": _utc_iso(),
        }, site="journal_append")

    def record_chunk(self, chunk_id, files, dms, peaks, wire_digest=None,
                     timings=None, attempts=1, dq=None, hbm=None,
                     extra=None):
        """Journal one completed chunk. The peak rows are appended (and
        fsync'd) BEFORE the chunk record, so a chunk record always
        implies its peaks are durable. ``dq`` is the chunk's
        data-quality summary (masked samples / quarantined files) for
        downstream provenance; ``hbm`` the predicted-vs-actual peak
        device-memory block (:func:`riptide_tpu_torch.obs.schema.hbm_block`,
        empty while model seeding is off); ``extra`` merges additional
        provenance fields into the record (e.g. the multihost layer's
        degraded ``scope``/``process`` markers)."""
        offset = self._peak_store_len()
        _append_lines(self.peaks_path, [_peak_to_row(p) for p in peaks],
                      site="peaks_append")
        self._peak_rows = offset + len(peaks)
        rec = {
            "kind": "chunk", "chunk_id": int(chunk_id),
            "utc": _utc_iso(),
            "files": [os.path.basename(f) for f in files],
            "dms": [float(d) for d in dms],
            "wire_digest": wire_digest,
            "peaks_offset": offset, "peaks_count": len(peaks),
            "timings": timings or {}, "attempts": int(attempts),
            "dq": dq or {}, "hbm": hbm or {},
        }
        rec.update(extra or {})
        _append_line(self.journal_path, rec, site="journal_append")

    def record_parked(self, chunk_id, reason, files=None):
        """Journal one *parked* chunk: set aside by the circuit breaker
        (or any exhausted-retry path running degraded) without a
        completed record, so a later resume re-dispatches it. Purely
        informational for resume — :meth:`completed_chunks` ignores it
        — but it makes the degraded run auditable."""
        _append_line(self.journal_path, {
            "kind": "parked", "chunk_id": int(chunk_id),
            "utc": _utc_iso(), "reason": str(reason),
            "files": [os.path.basename(f) for f in files or []],
        }, site="journal_append")

    def record_metrics(self, summary):
        """Append a metrics snapshot (see MetricsRegistry.summary)."""
        _append_line(self.journal_path, {"kind": "metrics",
                                         "utc": _utc_iso(),
                                         "summary": summary},
                     site="journal_append")

    def record_incident(self, record):
        """Append one structured ``incident`` record (built by
        :func:`riptide_tpu_torch.survey.incidents.emit` — watchdog timeout,
        breaker open, OOM bisection, quarantine, peer loss, ...).
        Purely additive for every reader: resume, heartbeat and metrics
        loaders all filter by ``kind`` and never see these lines."""
        rec = dict(record)
        rec.setdefault("kind", "incident")
        rec.setdefault("utc", _utc_iso())
        _append_line(self.journal_path, rec, site="journal_append")

    def record_alert(self, record):
        """Append one ``alert`` record (built by
        :meth:`riptide_tpu_torch.obs.alerts.AlertEngine._event` — a rule
        firing or resolving). Like incidents, purely additive: every
        other reader filters by ``kind``, so pre-alert journals and
        readers interoperate both ways."""
        rec = dict(record)
        rec.setdefault("kind", "alert")
        rec.setdefault("utc", _utc_iso())
        _append_line(self.journal_path, rec, site="journal_append")

    def heartbeat(self, process_index, ts=None):
        """Append one liveness beat to THIS process's sidecar
        (``heartbeat_<p>.jsonl``). Sidecars are single-writer by
        construction; readers (:meth:`read_heartbeats`) scan them all.
        Beats stay checksum-less plain JSON: the tail reader already
        tolerates torn lines, and a stale beat is self-correcting —
        callers treat a failed append as an observability degradation
        (incident + counter), never a fatal error."""
        import time

        p = int(process_index)
        _append_line(
            os.path.join(self.directory, f"heartbeat_{p:04d}.jsonl"),
            {"process": p,
             "ts": float(ts if ts is not None else time.time()),
             "utc": _utc_iso()},
            site="heartbeat_append", checksum=False,
        )

    # -- reading ------------------------------------------------------------

    def _records(self):
        return _read_lines(self.journal_path)

    def _header(self):
        """The journal's header record, or None. A header is written
        once and never changes, so a non-None result is cached — the
        per-chunk readers (fleet publication, survey_id lookups) must
        not re-read the whole append-only journal every chunk. A None
        result is deliberately NOT cached: write_header's idempotence
        check runs before the header exists."""
        if self._header_cache is not None:
            return self._header_cache
        for rec in self._records():
            if rec.get("kind") == "header":
                self._header_cache = rec
                return rec
        return None

    def _peak_store_len(self):
        if self._peak_rows is None:
            self._peak_rows = len(_read_lines(self.peaks_path))
        return self._peak_rows

    def survey_id(self):
        hdr = self._header()
        return hdr.get("survey_id") if hdr else None

    def parked_chunks(self):
        """``{chunk_id: parked record}`` for chunks that were parked and
        never subsequently completed (a chunk that later succeeded —
        e.g. a half-open probe after a resume — is not parked)."""
        done = self.completed_chunks()
        out = {}
        for rec in self._records():
            if rec.get("kind") == "parked" \
                    and int(rec["chunk_id"]) not in done:
                out[int(rec["chunk_id"])] = rec
        return out

    def read_heartbeats(self):
        """``{process_index: newest heartbeat timestamp}`` across every
        ``heartbeat_*.jsonl`` sidecar in the journal directory (only
        each file's tail is read — sidecars are append-only and only
        the last beat matters)."""
        import glob

        out = {}
        pattern = os.path.join(self.directory, "heartbeat_*.jsonl")
        for path in glob.glob(pattern):
            rec = _read_last_record(path)
            if isinstance(rec, dict) and "ts" in rec:
                out[int(rec.get("process", -1))] = float(rec["ts"])
        return out

    def incidents(self):
        """Every ``incident`` record, in journal (append) order — the
        raw material of an incident timeline. Journals written
        before incident records existed return an empty list."""
        return [rec for rec in self._records()
                if rec.get("kind") == "incident"]

    def last_metrics(self):
        """Most recent journaled metrics summary, or None."""
        out = None
        for rec in self._records():
            if rec.get("kind") == "metrics":
                out = rec.get("summary")
        return out

    def completed_chunks(self):
        """Resume loader: ``{chunk_id: (record, [Peak, ...])}`` for every
        chunk record whose claimed peak rows exist in the peak store.
        Chunks with missing/torn peak rows are dropped (re-dispatched);
        duplicate chunk ids keep the LAST record (a retried chunk's
        final successful journaling wins)."""
        rows = _read_lines(self.peaks_path)
        out = {}
        for rec in self._records():
            if rec.get("kind") != "chunk":
                continue
            off, cnt = rec.get("peaks_offset", 0), rec.get("peaks_count", 0)
            if off + cnt > len(rows):
                log.warning(
                    "journal chunk %s claims peak rows [%d, %d) but the "
                    "peak store holds %d; re-dispatching it",
                    rec.get("chunk_id"), off, off + cnt, len(rows),
                )
                continue
            try:
                peaks = [_row_to_peak(r) for r in rows[off : off + cnt]]
            except (TypeError, ValueError):
                log.warning("journal chunk %s has malformed peak rows; "
                            "re-dispatching it", rec.get("chunk_id"))
                continue
            out[int(rec["chunk_id"])] = (rec, peaks)
        return out
