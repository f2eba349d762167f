"""
Crash-safe file I/O: the ONE place survey persistence touches disk (the
port's copy of the JAX package's ``utils/fsio.py``; the framing, the
checksums and the sites are the same bytes, so each package reads the
other's journals).

Every durable artifact the package writes — the survey journal and its
peak store, heartbeat sidecars, the perf ledger, Chrome trace exports,
the Prometheus textfile — funnels through the
helpers here, which hold the crash-consistency discipline in one spot:

* **checksummed line appends** (:func:`append_jsonl`): each record is a
  single ``write()`` of one ``\\n``-terminated line on an ``O_APPEND``
  fd, fsync'd, optionally suffixed with `` #xxxxxxxx`` — a CRC32 over
  the JSON payload — so a reader can tell a *torn* record (kill
  mid-append) from a *corrupted* one (bit rot, lying firmware) from a
  valid legacy record written before checksums existed. Compact JSON
  never ends in `` #<8 hex>``, so the suffix is self-describing and
  suffix-less lines parse as legacy (:func:`split_checksum`).
* **torn-tail healing**: an append to a file whose last byte is not a
  newline (a prior writer died mid-record) first writes a lone newline
  so the new record starts on its own line instead of gluing onto the
  torn fragment — without healing, one torn append would also destroy
  the NEXT record. Healing emits a ``storage_recovered`` incident.
* **atomic whole-file writes** (:func:`atomic_write_bytes`): tmp file
  in the target directory, fsync, ``os.replace``, then fsync of the
  directory itself — a reader never observes a torn page and the
  rename survives a machine crash.
* **storage fault injection**: the survey fault plan
  (:mod:`riptide_tpu_torch.survey.faults`) installs a hook via
  :func:`set_storage_faults`; every helper announces its operation
  (``write`` / ``fsync`` / ``placed``) and *site* (which persistence
  path: :data:`SITES`) to the hook, which may raise ``OSError``
  (``enospc`` / ``fsync_fail``), request a torn partial write
  (``torn_write``), hard-exit the process mid-write (``kill_at``), or
  corrupt the placed file (``cache_corrupt``, which waits for the
  executable cache: the port's fault parser refuses it). With no hook
  installed every announcement is a single ``None`` check.

This module is deliberately stdlib-only (no torch, no package imports
at module level) so every persistence layer can use it.
"""
import errno
import json
import logging
import os
import tempfile
import threading
import zlib

log = logging.getLogger("riptide_tpu_torch.utils.fsio")

__all__ = [
    "SITES", "KILL_EXIT", "crc32_hex", "encode_record_line",
    "split_checksum", "scan_jsonl", "append_bytes", "append_jsonl",
    "atomic_write_bytes", "atomic_write_text", "fsync_dir",
    "set_storage_faults",
]

# Exit status of an injected mid-write kill (mirrors SIGKILL's 128+9 so
# a supervisor treats it like a real kill).
KILL_EXIT = 137

# The named persistence paths storage faults can target (the JAX
# package's names; its executable cache and service job registry are
# not ported yet). Fault specs validate against this tuple so a typo'd
# site fails at parse time instead of silently never firing.
SITES = (
    "journal_append",     # journal.jsonl records
    "peaks_append",       # peaks.jsonl peak-store rows
    "heartbeat_append",   # heartbeat_<p>.jsonl liveness sidecars
    "ledger_append",      # perf-ledger rows (RIPTIDE_LEDGER)
    "trace_export",       # Chrome trace-event JSON exports
    "prom_textfile",      # Prometheus textfile page
    "fleet_snapshot",     # fleet_<p>.json per-process status sidecars
)

_HEX = frozenset(b"0123456789abcdef")
# " #" + 8 lowercase hex chars appended after the JSON payload.
_SUFFIX_LEN = 10


def crc32_hex(payload):
    """8-hex-digit CRC32 of ``payload`` bytes."""
    return format(zlib.crc32(payload) & 0xFFFFFFFF, "08x")


def encode_record_line(payload, checksum=True):
    """One record line: ``payload`` (compact JSON bytes, no newline)
    plus the optional `` #crc32`` suffix and the terminating newline."""
    if checksum:
        return payload + b" #" + crc32_hex(payload).encode() + b"\n"
    return payload + b"\n"


def split_checksum(line):
    """``(payload, status)`` of one newline-stripped record line.

    ``status`` is ``"ok"`` (suffix present, CRC verified), ``"legacy"``
    (no suffix — a record written before checksums existed, or a
    format that never carries them) or ``"corrupt"`` (suffix present,
    CRC mismatch: the payload bytes changed after they were written).
    Compact JSON always ends in ``}``/``]``/a digit/a quote, never in
    `` #<8 hex>``, so suffix detection cannot misfire on legacy lines.
    """
    if len(line) > _SUFFIX_LEN and line[-_SUFFIX_LEN:-8] == b" #" \
            and all(c in _HEX for c in line[-8:]):
        payload = line[:-_SUFFIX_LEN]
        if line[-8:].decode() == crc32_hex(payload):
            return payload, "ok"
        return payload, "corrupt"
    return line, "legacy"


def scan_jsonl(path):
    """``(entries, size)`` over every line of an append-only JSONL file.

    ``entries`` is a list of ``(obj, status, end_offset)`` where
    ``status`` is ``"ok"``/``"legacy"`` (parsed, ``obj`` set),
    ``"corrupt"`` (checksum mismatch), ``"garbage"`` (unparseable) or
    ``"torn"`` (the final line, missing its newline — a kill
    mid-append); ``end_offset`` is the byte offset just past the line's
    newline (for recovery truncation). Blank lines are skipped."""
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as fobj:
        raw = fobj.read()
    entries = []
    pos = 0
    lines = raw.split(b"\n")
    for i, line in enumerate(lines):
        if i == len(lines) - 1:
            # Past the final newline: empty when the file is cleanly
            # terminated, else an unterminated (torn) tail. A torn line
            # is never trusted even if it happens to parse — appending
            # after it would glue two records onto one line.
            if line:
                entries.append((None, "torn", pos + len(line)))
            break
        end = pos + len(line) + 1
        if line:
            payload, status = split_checksum(line)
            if status == "corrupt":
                entries.append((None, "corrupt", end))
            else:
                try:
                    entries.append((json.loads(payload), status, end))
                except ValueError:
                    entries.append((None, "garbage", end))
        pos = end
    return entries, len(raw)


# ---------------------------------------------------------------------------
# Storage fault injection.
#
# The hook is a callable ``hook(op, site, path)``; ``op`` is "write"
# (about to write), "fsync" (about to fsync the data fd) or "placed"
# (atomic write landed at its final path). It may raise OSError, may
# hard-exit the process, or may return a command dict:
# ``{"torn_frac": f, "exit": callable_or_None}`` asking the writer to
# write only the first ``f`` of the payload and then either call
# ``exit(KILL_EXIT)`` (a mid-write kill) or raise EIO (a torn write the
# caller survives). Installed process-wide by the survey layers for the
# duration of a run; ``None`` (the default) costs one attribute read.
#
# A thread owned by a job-scoped RunContext (utils.runctx) resolves its
# ``storage_faults`` plan FIRST, so two concurrent runs each see only
# their own injected plan; the process-wide hook stays the fallback
# layer for batch paths.
# ---------------------------------------------------------------------------

try:  # fsio stays usable standalone; runctx is stdlib-only anyway
    from . import runctx as _runctx
except ImportError:  # pragma: no cover - standalone module use
    _runctx = None

_fault_hook = None
# Reentrancy guard: healing a torn tail emits an incident, whose sink
# appends to the journal, which may itself need healing — bounded, but
# the inner heal must not announce to the fault hook again mid-action.
_in_recovery = threading.local()


def set_storage_faults(hook):
    """Install ``hook(op, site, path)`` as the process-wide storage
    fault injector (normally a FaultPlan's ``storage_op``); returns the
    previous hook. ``None`` uninstalls."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, hook
    return prev


def _fire(op, site, path):
    if site is None:
        return None
    if _runctx is not None:
        ctx = _runctx.current()
        if ctx is not None and ctx.storage_faults is not None:
            return ctx.storage_faults(op, site, path)
    hook = _fault_hook
    if hook is None:
        return None
    return hook(op, site, path)


def _emit_recovery_incident(action, path, **detail):
    """Best-effort ``storage_recovered`` incident (lazy import: fsio is
    stdlib-only at module level; emission must never fail a write)."""
    if getattr(_in_recovery, "active", False):
        return
    _in_recovery.active = True
    try:
        from ..survey.incidents import emit

        emit("storage_recovered", action=action,
             path=os.path.basename(path), **detail)
    except Exception as err:  # pragma: no cover - emission is advisory
        log.warning("storage_recovered incident failed for %s: %s",
                    path, err)
    finally:
        _in_recovery.active = False


def _write_all(fd, data):
    """Loop ``os.write`` to completion (short writes are legal on
    signals/ENOSPC boundaries; a silent short write would tear the
    record this module exists to protect)."""
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def _torn_write(fd, data, cmd, site, path):
    """Execute an injected torn write: a prefix of ``data`` lands (and
    is fsync'd, so it survives the coming death), then the process
    either hard-exits (``kill_at``) or sees EIO (``torn_write``)."""
    frac = float(cmd.get("torn_frac", 0.5))
    prefix = data[:max(1, int(len(data) * frac))]
    _write_all(fd, prefix)
    os.fsync(fd)
    exit_fn = cmd.get("exit")
    if exit_fn is not None:
        log.warning("fault injection: killing the process mid-%s (%s, "
                    "%d/%d bytes written)", site, path, len(prefix),
                    len(data))
        exit_fn(KILL_EXIT)
    raise OSError(
        errno.EIO,
        f"injected torn write at {site}: {len(prefix)}/{len(data)} "
        f"bytes of {path!r} written",
    )


def append_bytes(path, data, site=None, heal=True):
    """Append ``data`` to ``path`` in one write on an ``O_APPEND`` fd,
    fsync'd before returning.

    With ``heal`` (the default), a file whose last byte is not a
    newline — a previous writer died mid-record — gets a lone newline
    first, so the new record starts on its own line instead of gluing
    onto the torn fragment (which readers drop as garbage); the heal is
    incident-recorded. Raises ``OSError`` on failure — the CALLER
    decides whether the path is correctness-critical (journal: raise)
    or observability (ledger/trace/prom/heartbeat: degrade to an
    incident)."""
    if not data:
        return
    cmd = _fire("write", site, path)
    # O_RDWR (not O_WRONLY): the heal check preads the current last
    # byte through the same fd; appends still go through O_APPEND.
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        if heal:
            size = os.fstat(fd).st_size
            if size > 0 and os.pread(fd, 1, size - 1) != b"\n":
                _write_all(fd, b"\n")
                log.warning("%s: healed a torn tail before appending "
                            "(previous writer died mid-record)", path)
                _emit_recovery_incident("healed_torn_tail", path,
                                        site=site)
        if cmd and cmd.get("torn_frac") is not None:
            _torn_write(fd, data, cmd, site, path)
        _write_all(fd, data)
        _fire("fsync", site, path)
        os.fsync(fd)
    finally:
        os.close(fd)


def append_jsonl(path, objs, site=None, checksum=False, heal=True):
    """Append JSON records as individually-parseable lines in ONE
    write/fsync cycle (a chunk's whole peak batch costs one append).
    ``checksum`` adds the per-record CRC32 suffix."""
    data = b"".join(
        encode_record_line(
            json.dumps(obj, separators=(",", ":")).encode(), checksum)
        for obj in objs
    )
    append_bytes(path, data, site=site, heal=heal)


def fsync_dir(dirpath):
    """Best-effort fsync of a directory (persists a just-renamed
    entry's existence across a machine crash; some filesystems reject
    directory fsync, which is as good as it gets there)."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fs-dependent
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data, site=None):
    """Crash-safe whole-file write: unique tmp file in the target
    directory, fsync, ``os.replace`` onto ``path``, fsync of the
    directory. A reader never sees a torn page; a kill mid-write leaves
    at worst a stale ``*.tmp`` next to an intact previous version."""
    cmd = _fire("write", site, path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        try:
            if cmd and cmd.get("torn_frac") is not None:
                _torn_write(fd, data, cmd, site, path)
            _write_all(fd, data)
            _fire("fsync", site, path)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(d)
    _fire("placed", site, path)
    return path


def atomic_write_text(path, text, site=None):
    """:func:`atomic_write_bytes` for text content."""
    return atomic_write_bytes(path, text.encode(), site=site)
