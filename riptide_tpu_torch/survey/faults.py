"""
Pluggable fault injection for the survey scheduler and batch searcher
(the port's copy of the JAX package's ``survey/faults.py``, with its
spec grammar).

Device faults on real hardware (transient dispatch errors, corrupted
host-to-device transfers, memory exhaustion, multi-second stalls) and degraded
inputs (NaN blocks from upstream excision) are rare and unreproducible,
so the robustness machinery is exercised instead through an injected
:class:`FaultPlan`, configured from a spec string (CLI
``--fault-inject`` or the ``RIPTIDE_FAULT_INJECT`` environment
variable). This keeps the retry/backoff, resume, data-quality masking
and OOM-bisection paths testable on the CPU.

Spec grammar: comma-separated directives, each
``kind:chunk[:arg][xN]`` —

* ``raise:2``       raise a transient error dispatching chunk 2 (once);
* ``raise:2x3``     ... on the first three dispatch attempts of chunk 2;
* ``stall:1:0.5``   sleep 0.5 s before dispatching chunk 1;
* ``corrupt:0``     flip bytes in chunk 0's prepared wire buffer (the
  scheduler detects the digest mismatch and re-prepares);
* ``abort:3``       raise a NON-retryable :class:`FaultAbort` on chunk 3
  (simulates a kill/preemption: completed chunks stay journaled and a
  ``--resume`` run picks up from there);
* ``nan_inject:0``  overwrite a contiguous block of chunk 0's loaded
  samples with NaN *before* the data-quality scan (arg = block
  fraction, default 0.05; consumed once per loaded file, so ``xN``
  covers N files of the chunk) — exercises the masking/repair path of
  :mod:`riptide_tpu_torch.quality`;
* ``oom:4``         raise a simulated out-of-memory error whenever a
  device batch LARGER than 4 DM trials dispatches (the "chunk" field is
  a batch-size floor here, not a chunk id) — exercises the batcher's
  adaptive bisection. ``oom:0`` fails the first full batch once;
  ``oom:1x8`` keeps failing until batches bisect down to single trials.
* ``hang:2:5``      wedge chunk 2's dispatch for 5 s *inside* the
  watchdog-guarded region (unlike ``stall``, which fires before the
  deadline starts): with a watchdog whose budget is below 5 s the
  attempt is abandoned, counted as ``chunks_timed_out`` and retried;
* ``straggle:1:0.2``  slow chunk 1's dispatch by 0.2 s, again inside
  the guarded region — a *straggler* that must NOT be killed while it
  stays within the deadline (and whose duration feeds the EWMA, so
  budgets adapt to genuinely slower chunks);
* ``device_error:2``  raise :class:`InjectedDeviceError` dispatching
  chunk 2: a non-OOM, non-timeout runtime error shaped like CUDA's
  (the message reads ``CUDA error: ...``). The scheduler classifies it
  via ``is_device_error``, checks that the CUDA context still works and
  re-fires the chunk through the ordinary retry path; ``x9`` (more
  firings than retries) exhausts the retries and fails the run with a
  ``device_error`` incident.
* ``bitflip:1``     silently corrupt chunk 1's collected result buffer
  in-flight (one XOR-flipped byte in the first device buffer the
  dispatch attempt collects) — the device "returns" plausible but
  wrong bytes and NOTHING raises, which is exactly the failure the
  result-integrity layer (:mod:`riptide_tpu_torch.survey.integrity`,
  ``RIPTIDE_INTEGRITY=probe``) exists to detect. Each consumed hit
  flips a DIFFERENT byte, so ``bitflip:1`` corrupts only the primary
  dispatch (the shadow probe detects it and the third-dispatch vote
  out-votes it) while ``bitflip:1x3`` corrupts all three dispatches
  distinctly (the device cannot agree with itself → quarantine).

**Storage faults** target a persistence *site* (a name from
:data:`riptide_tpu_torch.utils.fsio.SITES`) instead of a chunk id, and fire
through the fsio layer's hook (the survey layers install the plan's
:meth:`FaultPlan.storage_op` for the run's duration). The optional
``:n`` selects the n-th write-class operation on that site (1-based,
default 1); ``xN`` keeps firing for N consecutive operations from
there —

* ``kill_at:journal_append:3``  write HALF of the third journal append
  then hard-exit the process (exit ``fsio.KILL_EXIT``), leaving a
  genuinely torn tail for resume to recover;
* ``torn_write:ledger_append``  write a partial record then raise
  ``EIO`` (the device reported failure after a partial transfer) —
  observability paths must degrade to an incident, not die;
* ``enospc:trace_export``       raise ``ENOSPC`` before writing;
* ``fsync_fail:heartbeat_append``  the write lands but its fsync
  raises ``EIO``.

Two kinds of the JAX package are refused with an error that names the
slice they wait for: ``peer_loss`` (a dead peer behind a collective;
the multi-GPU slice) and ``cache_corrupt`` (bit rot in the executable
cache; the exec-cache slice).

Example: ``RIPTIDE_FAULT_INJECT="stall:0:0.1,raise:2x2,oom:0"``.
"""
import errno
import logging
import os
import re
import threading
import time

import numpy as np

from ..utils import fsio

__all__ = ["FaultPlan", "FaultAbort", "InjectedDeviceError",
           "InjectedFault", "InjectedOOM"]

log = logging.getLogger("riptide_tpu_torch.survey.faults")

_KINDS = ("raise", "stall", "corrupt", "abort", "nan_inject", "oom",
          "hang", "straggle", "device_error", "bitflip",
          "torn_write", "enospc", "fsync_fail", "kill_at")

# The JAX package's kinds that wait for a later slice of the port, with
# the slice named in the refusal.
_REFUSED = {
    "peer_loss": "the multi-GPU slice (a dead peer behind a collective "
                 "needs more than one process)",
    "cache_corrupt": "the executable-cache slice (the port keeps no "
                     "executable cache yet)",
}

# Directive kinds whose second field is a persistence SITE (string from
# fsio.SITES) rather than a chunk id, consumed via storage_op().
_STORAGE_KINDS = ("torn_write", "enospc", "fsync_fail", "kill_at")

# Which fsio operation each storage kind fires on.
_STORAGE_TRIGGER_OP = {
    "torn_write": "write",
    "enospc": "write",
    "kill_at": "write",
    "fsync_fail": "fsync",
}

_TIMES_RE = re.compile(r"x(\d+)$")


class InjectedFault(RuntimeError):
    """Transient injected device error (retryable)."""


class FaultAbort(RuntimeError):
    """Injected fatal fault (not retryable): simulates a kill."""


class InjectedDeviceError(RuntimeError):
    """Simulated non-OOM device runtime error: the message reads like a
    CUDA runtime failure (``CUDA error: ...``, and none of the
    OOM/timeout markers), so it routes through the same
    ``is_device_error`` classification as a real
    ``torch.AcceleratorError``."""

    def __init__(self, chunk_id):
        super().__init__(
            f"CUDA error: injected device error on chunk {chunk_id} "
            "(simulated device runtime failure)"
        )


class InjectedOOM(RuntimeError):
    """Simulated device memory exhaustion: the message carries the
    RESOURCE_EXHAUSTED marker, so it routes through the same
    ``search.engine.is_oom_error`` detection as a real
    ``torch.cuda.OutOfMemoryError``."""

    def __init__(self, batch_size, floor):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device OOM on a "
            f"{batch_size}-trial batch (floor {floor})"
        )


class FaultPlan:
    """Parsed fault directives, consumed as the scheduler/batcher hits
    their trigger points. ``sleep`` is injectable for tests, as is
    ``exit`` (the hard-kill primitive of ``kill_at`` storage faults —
    ``os._exit`` in production, a raising stub in-process tests).
    Trigger methods are thread-safe: the batcher's loader pool fires
    ``nan_inject`` concurrently and fsio announces storage operations
    from whichever thread is persisting."""

    def __init__(self, directives=(), sleep=time.sleep, exit=os._exit):
        # directive: dict(kind, chunk, arg, remaining) — storage kinds
        # carry dict(kind, site, nth, remaining) instead.
        self._directives = [dict(d) for d in directives]
        self._sleep = sleep
        self._exit = exit
        self._lock = threading.Lock()
        # Per-site write-class operation counter (1-based after the
        # first increment) for the storage directives' :n selector.
        self._site_ops = {}
        self._has_storage = any("site" in d for d in self._directives)

    @classmethod
    def parse(cls, spec, sleep=time.sleep, exit=os._exit):
        """Build a plan from a spec string; None/empty -> inert plan."""
        directives = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            times = 1
            # xN repeat suffix — matched as a trailing x<digits> so
            # site names containing an 'x' (trace_export) never parse
            # as repeats.
            m = _TIMES_RE.search(part.rsplit(":", 1)[-1])
            if m:
                part = part[: -len(m.group(0))]
                times = int(m.group(1))
            bits = part.split(":")
            if bits[0] in _REFUSED:
                raise ValueError(
                    f"bad fault directive {part!r}: kind {bits[0]!r} is "
                    f"not ported yet; it waits for {_REFUSED[bits[0]]}"
                )
            if len(bits) < 2 or bits[0] not in _KINDS:
                raise ValueError(
                    f"bad fault directive {part!r}: expected "
                    f"kind:chunk[:arg][xN] with kind in {_KINDS}"
                )
            kind = bits[0]
            if kind in _STORAGE_KINDS:
                site = bits[1]
                if site not in fsio.SITES:
                    raise ValueError(
                        f"bad fault directive {part!r}: {site!r} is not "
                        f"a storage site (expected one of {fsio.SITES})"
                    )
                nth = int(bits[2]) if len(bits) > 2 else 1
                if nth < 1:
                    raise ValueError(
                        f"bad fault directive {part!r}: the operation "
                        "index is 1-based"
                    )
                directives.append({"kind": kind, "site": site,
                                   "nth": nth, "remaining": times})
                continue
            chunk = int(bits[1])
            arg = float(bits[2]) if len(bits) > 2 else None
            directives.append(
                {"kind": kind, "chunk": chunk, "arg": arg, "remaining": times}
            )
        return cls(directives, sleep=sleep, exit=exit)

    def _take(self, kind, chunk_id):
        with self._lock:
            for d in self._directives:
                if d["kind"] == kind and d.get("chunk") == chunk_id \
                        and d["remaining"] > 0:
                    d["remaining"] -= 1
                    return d
        return None

    # -- trigger points (called by the scheduler) ---------------------------

    def before_dispatch(self, chunk_id):
        """Called at the top of every dispatch attempt: may stall, raise
        a transient :class:`InjectedFault`, or raise :class:`FaultAbort`."""
        d = self._take("stall", chunk_id)
        if d is not None:
            secs = d["arg"] if d["arg"] is not None else 1.0
            log.warning("fault injection: stalling %.3fs on chunk %d",
                        secs, chunk_id)
            self._sleep(secs)
        if self._take("abort", chunk_id) is not None:
            log.warning("fault injection: aborting on chunk %d", chunk_id)
            raise FaultAbort(f"injected abort on chunk {chunk_id}")
        if self._take("raise", chunk_id) is not None:
            log.warning("fault injection: transient error on chunk %d",
                        chunk_id)
            raise InjectedFault(f"injected device error on chunk {chunk_id}")
        if self._take("device_error", chunk_id) is not None:
            log.warning("fault injection: device runtime error on chunk %d",
                        chunk_id)
            raise InjectedDeviceError(chunk_id)

    def in_flight(self, chunk_id):
        """Called inside the watchdog-guarded dispatch region (the
        sacrificial attempt thread): ``hang`` and ``straggle``
        directives sleep here. The two kinds are identical mechanically
        — a blocking sleep — and differ by intent: a ``hang``'s
        duration is chosen to blow through the watchdog budget (the
        attempt is abandoned and retried), a ``straggle``'s to stay
        within it (the attempt must complete and its duration feed the
        EWMA)."""
        for kind, default_s in (("hang", 30.0), ("straggle", 1.0)):
            d = self._take(kind, chunk_id)
            if d is not None:
                secs = d["arg"] if d["arg"] is not None else default_s
                log.warning("fault injection: %s %.3fs inside chunk %d's "
                            "dispatch", kind, secs, chunk_id)
                self._sleep(secs)

    def bitflip_arm(self, chunk_id):
        """Called once per dispatch attempt: consume one ``bitflip``
        hit for this chunk and return its 0-based hit index (the byte
        offset the integrity layer's fold will XOR-flip in the first
        collected buffer), or None with no hit armed. Distinct offsets
        per hit keep repeated corruption from ever producing two
        AGREEING wrong digests — a persistent fault must look like a
        device that cannot agree with itself, not like consensus."""
        with self._lock:
            for d in self._directives:
                if d["kind"] == "bitflip" and d.get("chunk") == chunk_id \
                        and d["remaining"] > 0:
                    d["remaining"] -= 1
                    d["fired"] = d.get("fired", 0) + 1
                    hit = d["fired"] - 1
                    break
            else:
                return None
        log.warning("fault injection: arming result bitflip (hit %d) on "
                    "chunk %d's dispatch", hit, chunk_id)
        return hit

    def corrupt_wire(self, chunk_id, items):
        """Called once per chunk after host preparation, before any copy
        of it to the card is queued: flips the first byte of each
        prepared wire buffer in place (its numpy view of the staging
        tensor), detected downstream by the scheduler's digest
        verification."""
        if self._take("corrupt", chunk_id) is None:
            return False
        hit = False
        for item in items:
            prepared = item[-1]
            if isinstance(prepared, tuple) and len(prepared) == 2 \
                    and hasattr(prepared[0], "view"):
                buf = prepared[0]
                flat = buf.view("uint8").reshape(-1)
                if flat.size:
                    flat[0] ^= 0xFF
                    hit = True
        if hit:
            log.warning("fault injection: corrupted chunk %d's wire buffer",
                        chunk_id)
        return hit

    # -- trigger points (called by the batch searcher) ----------------------

    def nan_inject(self, chunk_id, data):
        """Called per loaded file, BEFORE the data-quality scan:
        overwrite a contiguous block of ``data`` (float array, modified
        in place) with NaN. Block length is ``arg`` (default 0.05) of
        the series; the block starts a third of the way in so it lands
        well inside any detrending window. Returns True when injected."""
        d = self._take("nan_inject", chunk_id)
        if d is None or data.size == 0:
            return False
        frac = d["arg"] if d["arg"] is not None else 0.05
        n = max(1, int(round(frac * data.size)))
        start = min(data.size // 3, data.size - n)
        data[start : start + n] = np.nan
        log.warning(
            "fault injection: NaN block of %d samples (%.1f%%) into a "
            "chunk-%d series", n, 100.0 * n / data.size, chunk_id,
        )
        return True

    def maybe_oom(self, batch_size):
        """Called before every device-batch execution attempt: raise a
        simulated out-of-memory error while an ``oom`` directive with a
        batch-size floor below ``batch_size`` has firings left."""
        with self._lock:
            for d in self._directives:
                if d["kind"] == "oom" and d["remaining"] > 0 \
                        and batch_size > d["chunk"]:
                    d["remaining"] -= 1
                    floor = d["chunk"]
                    break
            else:
                return
        log.warning("fault injection: device OOM on a %d-trial batch",
                    batch_size)
        raise InjectedOOM(batch_size, floor)

    # -- trigger points (called by the fsio layer) --------------------------

    def storage_op(self, op, site, path=None):
        """The storage fault hook fsio announces every persistence
        operation to (installed process-wide via
        ``fsio.set_storage_faults`` by the survey layers for a run's
        duration). ``op`` is ``write``/``fsync``/``placed``; write-class
        operations advance the per-site counter the directives' ``:n``
        selector indexes. Decisions are taken under the plan lock;
        ACTIONS (raising, killing, corrupting) run outside it."""
        if not self._has_storage:
            return None
        actions = []
        with self._lock:
            if op == "write":
                self._site_ops[site] = self._site_ops.get(site, 0) + 1
            cur = self._site_ops.get(site, 0)
            for d in self._directives:
                if d.get("site") != site or d["remaining"] <= 0:
                    continue
                if _STORAGE_TRIGGER_OP[d["kind"]] != op or cur < d["nth"]:
                    continue
                d["remaining"] -= 1
                actions.append(d["kind"])
        cmd = None
        for kind in actions:
            if kind == "enospc":
                log.warning("fault injection: ENOSPC at %s (%s)",
                            site, path)
                raise OSError(errno.ENOSPC,
                              f"injected ENOSPC at {site}: {path!r}")
            if kind == "fsync_fail":
                log.warning("fault injection: fsync failure at %s (%s)",
                            site, path)
                raise OSError(errno.EIO,
                              f"injected fsync failure at {site}: {path!r}")
            if kind == "kill_at":
                log.warning("fault injection: arming mid-write kill at "
                            "%s (%s)", site, path)
                cmd = {"torn_frac": 0.5, "exit": self._exit}
            if kind == "torn_write":
                log.warning("fault injection: arming torn write at %s "
                            "(%s)", site, path)
                cmd = {"torn_frac": 0.5, "exit": None}
        return cmd
