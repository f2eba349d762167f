"""
Append-only JSONL performance ledger: the machine-readable run history
(the port's copy of the JAX package's ``obs/ledger.py``, with its row
schema; the platform block describes the card).

Every journaled survey appends ONE row to the file named by
``RIPTIDE_LEDGER``, carrying

* the run-level phase decomposition (the
  :func:`riptide_tpu_torch.obs.schema.decomposition` keys: ``prep_s`` /
  ``wire_s`` / ``device_s`` / ``chunk_s`` / ``wire_MBps``) plus
  ``nchunks`` and the per-chunk ``bound_counts`` (how many chunks were
  transfer- vs device-bound);
* provenance that explains run-to-run deltas: git sha, a fingerprint
  of every non-default ``RIPTIDE_*`` flag, and the device platform
  (:func:`platform_info`: the torch device type, the card's name,
  power limit and count, and a digest of the CUDA sources the kernels
  are built from).

Rows are single ``O_APPEND`` writes, fsync'd, one JSON object per line
— the same torn-line-tolerant discipline as the survey journal — so
concurrent writers interleave without locks and a reader drops at most
one torn tail line.
"""
import hashlib
import json
import logging
import os
import subprocess
from datetime import datetime, timezone

from ..utils import envflags, fsio

log = logging.getLogger("riptide_tpu_torch.obs.ledger")

__all__ = ["LEDGER_VERSION", "make_row", "append_row", "maybe_append",
           "read_rows", "git_sha", "envflag_fingerprint",
           "platform_info", "kernel_source_digest", "ledger_path"]

LEDGER_VERSION = 1

# Flags that only control the RECORDING of observability artifacts —
# where the ledger/textfile goes, whether the status endpoint is up.
# They cannot affect the measured run, and RIPTIDE_LEDGER in particular
# is non-default in EVERY row (a row is only written while it is set),
# so including them would make two perf-identical runs recording to
# different paths fingerprint as different flag regimes.
FINGERPRINT_EXCLUDE = frozenset({
    "RIPTIDE_LEDGER", "RIPTIDE_PROM_PORT", "RIPTIDE_PROM_TEXTFILE",
    "RIPTIDE_STATUS", "RIPTIDE_STATUS_STALE_S",
    # Wire-prep thread count: a pure throughput knob — the native job
    # pool writes disjoint output regions per (stage, trial) job, so
    # wire bytes are identical at any thread count.
    "RIPTIDE_PREP_THREADS",
})


def ledger_path():
    """The configured ledger path (``RIPTIDE_LEDGER``), or None when
    ledger recording is disabled."""
    return envflags.get("RIPTIDE_LEDGER")


def git_sha(repo=None):
    """Short git sha of the working tree this process runs from, or
    None outside a checkout (an installed wheel has no history — the
    row is still useful, just less attributable)."""
    repo = repo or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=10.0,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def envflag_fingerprint():
    """``(digest, flags)``: a 12-hex digest over — and the dict of —
    every registered ``RIPTIDE_*`` flag whose parsed value differs
    from its default. Two rows with the same fingerprint ran under the
    same flag regime; the dict says exactly what a differing one
    changed. Recording-only flags (:data:`FINGERPRINT_EXCLUDE`) are
    ignored — they cannot change the run being measured. Flags set to
    unparsable values are recorded as their raw error string rather
    than failing the run being ledgered."""
    flags = {}
    for name in sorted(envflags.FLAGS):
        if name in FINGERPRINT_EXCLUDE:
            continue
        try:
            value = envflags.get(name)
        except Exception as err:  # unparsable operator value
            flags[name] = f"<unparsable: {err}>"
            continue
        if value != envflags.FLAGS[name].default:
            flags[name] = value
    digest = hashlib.sha1(
        json.dumps(flags, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]
    return digest, flags


def _power_limit(index):
    """The card's power limit as ``nvidia-smi`` reports it (e.g.
    ``"700.00 W"``), or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={int(index)}",
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10.0,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else None


def kernel_source_digest():
    """12-hex sha1 over the package's CUDA sources (``csrc/*.cu``, by
    name order): two rows with the same digest ran the same kernels."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc")
    h = hashlib.sha1()
    try:
        names = sorted(n for n in os.listdir(csrc) if n.endswith(".cu"))
        for name in names:
            h.update(name.encode() + b"\0")
            with open(os.path.join(csrc, name), "rb") as fobj:
                h.update(fobj.read())
    except OSError:
        return None
    return h.hexdigest()[:12]


def platform_info():
    """Device/platform block of a row: ``backend`` (the torch device
    type the searches run on: ``cuda`` when a card is visible, else
    ``cpu``), and for a card its ``device_kind``
    (``torch.cuda.get_device_name()``), ``power_limit`` and
    ``device_count``; ``kernel_digest`` names the CUDA sources. Never
    raises: ``{"backend": "unknown"}`` where torch cannot say."""
    try:
        import torch

        if not torch.cuda.is_available():
            info = {"backend": "cpu"}
        else:
            index = torch.cuda.current_device()
            info = {"backend": "cuda",
                    "device_kind": torch.cuda.get_device_name(index),
                    "power_limit": _power_limit(index),
                    "device_count": torch.cuda.device_count()}
    except Exception:
        info = {"backend": "unknown"}
    info["kernel_digest"] = kernel_source_digest()
    return info


def make_row(kind, decomposition, nchunks=None, bound_counts=None,
             extra=None):
    """One ledger row: the decomposition keys verbatim plus provenance.
    ``bound_counts`` is ``{"device": n, "tunnel": m, ...}`` over the
    run's chunks (a run without per-chunk timing records its run-level
    classification as a single-entry count)."""
    fp, flags = envflag_fingerprint()
    row = {
        "kind": str(kind),
        "v": LEDGER_VERSION,
        # Same stamp format as survey.journal._utc_iso (readers
        # correlate ledger rows with journal records by utc; obs must
        # not import the survey layer, so the format lives twice).
        "utc": datetime.now(timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z",
        "git_sha": git_sha(),
        "envflags_fingerprint": fp,
        "envflags": flags,
        "platform": platform_info(),
    }
    row.update(decomposition or {})
    if nchunks is not None:
        row["nchunks"] = int(nchunks)
    if bound_counts:
        row["bound_counts"] = {str(k): int(v)
                               for k, v in bound_counts.items()}
    if extra:
        row.update(extra)
    return row


def append_row(row, path):
    """Append one row to ``path`` as a single fsync'd JSONL write (the
    journal's atomic-append discipline: concurrent writers interleave
    whole lines, a kill tears at most the final line — and the fsio
    append first heals a torn tail left by a prior kill, so the torn
    fragment is confined to its own dropped line instead of eating
    this row too). Rows stay plain JSON lines — no checksum suffix —
    so every existing ledger consumer keeps parsing them raw; the
    report readers tolerate suffixed rows anyway should that change."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fsio.append_jsonl(path, [row], site="ledger_append", checksum=False)
    return path


def maybe_append(kind, decomposition, nchunks=None, bound_counts=None,
                 extra=None, path=None):
    """Build and append a row when a ledger is configured (``path`` or
    ``RIPTIDE_LEDGER``); returns the path written, or None when ledger
    recording is off. Best-effort by design: a full disk or bad path
    must not take down the run it is recording."""
    path = path or ledger_path()
    if not path:
        return None
    row = make_row(kind, decomposition, nchunks=nchunks,
                   bound_counts=bound_counts, extra=extra)
    try:
        append_row(row, path)
    except OSError as err:
        # The hard invariant: observability writes are never fatal. A
        # full disk or failing fsync degrades to an incident + counter
        # and the run it was recording completes.
        log.warning("ledger append to %r failed: %s", path, err)
        _obs_write_failed("ledger", path, err)
        return None
    log.info("ledger: appended %s row to %s", kind, path)
    return path


def _obs_write_failed(op, path, err):
    """Incident + ``obs_write_errors`` counter for a degraded
    observability write (imports deferred: obs modules must not pull
    the survey layer at import time)."""
    try:
        from ..survey.incidents import emit
        from ..survey.metrics import get_metrics

        get_metrics().add("obs_write_errors")
        emit("obs_write_failed", op=op, path=os.path.basename(str(path)),
             error=str(err))
    except Exception as err2:  # pragma: no cover - advisory path
        log.warning("obs_write_failed incident emission failed: %s", err2)


def read_rows(path):
    """Every parseable row of ``path``, oldest first; torn/garbage
    lines are dropped."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path, "rb") as fobj:
        for line in fobj.read().split(b"\n"):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                log.warning("%s: dropping torn ledger line", path)
    return out
