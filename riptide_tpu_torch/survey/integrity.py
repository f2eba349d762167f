"""
The end-to-end result-integrity layer (the port's copy of the JAX
package's ``survey/integrity.py``).

The journal CRC-protects every byte on disk and the scheduler digest-
checks the prepared *input* wire (``wire_digest``), but the device->
host **result** path would otherwise be taken on faith: a bit flip in
device memory, a kernel race or numerically drifting hardware keeps
returning plausible S/N values, and nothing would notice. For a
multi-week FFA survey that failure mode dominates: one silently wrong
card poisons a whole candidate archive. This module closes the loop
with three detection rings, flag-gated via ``RIPTIDE_INTEGRITY``
(``off|digest|probe|strict``):

**Ring 1 — per-chunk result digests.** A cheap deterministic fold
(sha256 over dtype + shape + bytes of every collected device buffer,
in collect order) runs host-side at the collect point
(:func:`riptide_tpu_torch.search.peaks_device.collect_peaks`, the
funnel every batch and bisected path drains through: the pulled peak
buffer, and the overflow gather's block values), paired with a
canonical digest over the journal's own peak-row serialisation. Both
land in the chunk record's ``integrity`` block
(:func:`riptide_tpu_torch.obs.schema.integrity_block`), and the peaks
digest is re-verified when a resume replays the chunk: a replayed
chunk that no longer reproduces its journaled bytes is a *detected*
``result_mismatch`` incident instead of silent divergence.

**Ring 2 — shadow recompute probes.** Every Nth chunk
(``RIPTIDE_INTEGRITY_PROBE_EVERY``; every chunk under ``strict``) is
dispatched twice and the raw result digests compared bit-exactly
before the record is written. This assumes that two dispatches of one
chunk give the same bytes on the card: the port's search path has no
atomics and no order-dependent reductions, and ``chip_smoke.py``
checks the assumption on every chunk of a full-width survey. A
mismatch emits ``result_mismatch`` and a bounded re-arbitration
fires: a third dispatch votes, the majority pair's peaks are kept,
and three distinct digests mean the card cannot agree with itself: it
is marked **suspect** through the quarantine latch
(:class:`IntegrityQuarantineError`), and the run parks that chunk and
every remaining one (a later fault-free resume re-dispatches them).

**Ring 3 — golden-canary chunk.** A tiny pinned-input search whose
collected-buffer digest is pinned per device in the package's own
``integrity_canary.json`` (next to this module), keyed by the torch
device type and, for a CUDA device, the card's name (``cuda:NVIDIA
H100 80GB HBM3``). It runs on the scheduler's device at warmup under
``strict`` (failure aborts before any survey work) and on every
quarantine decision, so "the card is wrong" (the canary fails too) is
distinguishable from "this input tickled a kernel bug". A device with
no pin passes with a note; ``python -m
riptide_tpu_torch.survey.integrity --repin`` writes the current
device's digest.

Every ring feeds the observability stack: incidents
(``result_mismatch`` / ``integrity_quarantine`` / ``canary_failed``),
the ``integrity_checks`` / ``integrity_mismatches`` /
``shadow_probes`` counters (metrics summary, fleet sidecars, prom) and
the ``integrity`` builtin alert rule. The layer is proven honest by
the ``bitflip`` fault kind (:mod:`riptide_tpu_torch.survey.faults`)
corrupting collected result buffers in flight: each hit flips a
*different* byte, so a persistent fault cannot masquerade as
agreement.

Off-mode cost is one attribute load and a ``None`` test per collected
buffer: with no fold accumulator installed on the calling thread,
:func:`fold_result` returns its argument untouched.

The fold accumulator is **thread-local** on purpose: the dispatch
path runs on the scheduler thread or a watchdog sacrificial thread,
and an abandoned attempt's thread must never fold into the next
attempt's accumulator (each attempt begins its own, on its own
thread).
"""
import hashlib
import json
import logging
import os
import threading

import numpy as np

from ..utils import envflags
from . import incidents
from .journal import PEAK_FIELDS, PEAK_INT_FIELDS
from .metrics import get_metrics

__all__ = [
    "IntegrityConfig", "IntegrityManager", "IntegrityQuarantineError",
    "fold_result", "set_collect_path", "peaks_digest",
    "compute_canary_digest", "canary_pin_path", "MODES",
]

log = logging.getLogger("riptide_tpu_torch.survey.integrity")

MODES = ("off", "digest", "probe", "strict")

# The golden canary: a tiny fixed search whose every input is pinned
# (explicit rng seed, fixed plan geometry), so its collected-buffer
# digest depends only on the device/compiler actually computing it.
CANARY_SEED = 0x51DE
CANARY_TRIALS = 2
CANARY_NSAMP = 4096
CANARY_TSAMP = 1e-3
CANARY_WIDTHS = (1, 2, 3)
CANARY_SEARCH = {"period_min": 0.3, "period_max": 1.2,
                 "bins_min": 64, "bins_max": 71}


class IntegrityQuarantineError(RuntimeError):
    """A device could not agree with itself: the shadow-probe
    re-arbitration saw three distinct result digests for one chunk.
    ``retryable = False`` — re-dispatching onto a suspect device cannot
    make the results trustworthy, so :func:`run_with_retry` propagates
    immediately instead of burning retries."""

    retryable = False

    def __init__(self, chunk_id, digests):
        self.chunk_id = int(chunk_id)
        self.digests = tuple(digests)
        short = [d[:12] if d else "none" for d in self.digests]
        super().__init__(
            f"chunk {chunk_id}: persistent result mismatch — three "
            f"dispatches produced three distinct digests {short}; "
            "device marked suspect"
        )


class IntegrityConfig:
    """Parsed integrity policy of one run.

    Parameters
    ----------
    mode : str
        ``off`` (nothing), ``digest`` (Ring 1 only), ``probe``
        (Ring 1 + shadow probes per ``probe_every`` + canary on
        quarantine decisions), ``strict`` (probe every chunk + canary
        at warmup, aborting startup on canary failure).
    probe_every : int
        Shadow-probe cadence: dispatch every Nth chunk twice
        (0 disables probing; ``strict`` probes every chunk regardless).
    policy : str
        What a quarantine decision does: ``park`` (batch — park the
        chunk and latch every remaining chunk parked, resumable) or
        ``fail`` (raise, so that only the implicated run fails).
    canary_pin : str or None
        Override the pin file path (tests); default
        :func:`canary_pin_path`.
    """

    def __init__(self, mode="off", probe_every=0, policy="park",
                 canary_pin=None):
        mode = str(mode or "off")
        if mode not in MODES:
            raise ValueError(
                f"unknown integrity mode {mode!r} (expected one of "
                f"{MODES})")
        if policy not in ("park", "fail"):
            raise ValueError(
                f"unknown quarantine policy {policy!r} (expected "
                "'park' or 'fail')")
        self.mode = mode
        self.probe_every = max(0, int(probe_every or 0))
        if self.mode == "strict" and self.probe_every < 1:
            self.probe_every = 1
        self.policy = policy
        self.canary_pin = canary_pin

    @property
    def enabled(self):
        return self.mode != "off"

    @property
    def probing(self):
        return self.mode in ("probe", "strict") and self.probe_every > 0

    @classmethod
    def from_env(cls, policy="park"):
        """The run-wide config from ``RIPTIDE_INTEGRITY`` /
        ``RIPTIDE_INTEGRITY_PROBE_EVERY``."""
        return cls(
            mode=envflags.get("RIPTIDE_INTEGRITY"),
            probe_every=envflags.get("RIPTIDE_INTEGRITY_PROBE_EVERY"),
            policy=policy,
        )


# -- the thread-local fold accumulator --------------------------------------

_tls = threading.local()


class _FoldAccumulator:
    """One dispatch attempt's running result digest: sha256 over
    dtype + shape + raw bytes of every buffer folded, in fold order
    (collection is sequential per attempt, so the fold is order-stable
    by construction). ``corrupt_hit`` arms the bitflip fault: the
    FIRST buffer folded gets byte ``hit`` XOR-flipped (a different
    byte per consumed hit, so repeated corruption can never produce
    agreeing digests) — corrupting the array *returned* to the caller,
    so the flip genuinely poisons the downstream peak extraction."""

    def __init__(self, corrupt_hit=None):
        self._h = hashlib.sha256()
        self.nbuf = 0
        self.path = None
        self._corrupt_hit = corrupt_hit

    def fold(self, buf):
        arr = np.asarray(buf)
        if self._corrupt_hit is not None:
            hit = int(self._corrupt_hit)
            self._corrupt_hit = None
            arr = np.array(arr, copy=True)
            flat = arr.view(np.uint8).reshape(-1)
            if flat.size:
                flat[hit % flat.size] ^= 0xFF
                log.warning(
                    "fault injection: bitflip in collected result "
                    "buffer (byte %d of %d)", hit % flat.size,
                    flat.size)
        self._h.update(str(arr.dtype).encode())
        self._h.update(np.asarray(arr.shape, np.int64).tobytes())
        self._h.update(arr.tobytes())
        self.nbuf += 1
        return arr

    def hexdigest(self):
        return self._h.hexdigest() if self.nbuf else None


def _active():
    return getattr(_tls, "acc", None)


def fold_result(buf):
    """The collect-point hook: fold one collected device buffer into
    the calling thread's active accumulator (and apply any armed
    in-flight corruption), returning the buffer the caller should keep
    using. With no accumulator active — integrity off, or a collect
    outside any dispatch — this is a no-op returning ``buf``
    untouched, so the fast path never pays digest cost."""
    acc = _active()
    if acc is None:
        return buf
    return acc.fold(buf)


def set_collect_path(path):
    """Label the active fold with its collect path (``batch``) for the
    integrity block's provenance; no-op with no accumulator active."""
    acc = _active()
    if acc is not None:
        acc.path = str(path)


# -- canonical peak digest (Ring 1's resume-verifiable half) ----------------

def peaks_digest(peaks):
    """Order-stable digest over the journal's OWN canonical peak-row
    serialisation (:data:`PEAK_FIELDS` order, ints exact, floats via
    JSON repr — the same round-trip the peak store uses), so the value
    is recomputable from journal-replayed peaks on resume without the
    device."""
    h = hashlib.sha256()
    for p in peaks:
        row = [int(getattr(p, f)) if f in PEAK_INT_FIELDS
               else float(getattr(p, f)) for f in PEAK_FIELDS]
        h.update(json.dumps(row).encode())
        h.update(b"\n")
    return h.hexdigest()


# -- Ring 3: the golden canary ----------------------------------------------

def canary_pin_path():
    """Where the port's canary digest pins live: ``integrity_canary.json``
    next to this module (a device without a pin there is unpinned and
    the canary passes with a note)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "integrity_canary.json")


def canary_platform(device=None):
    """The pin key of ``device`` (the card when None): ``cpu``, or
    ``cuda:<the card's name>``, so that a pin taken on one model of
    card never judges another."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def compute_canary_digest(device=None):
    """Run the pinned-input canary search on ``device`` (the card when
    None) through the real collect path and return its
    collected-buffer digest (hex). Deterministic per device: explicit
    rng seed, fixed plan geometry, and the fold covers the exact bytes
    the device handed back. The canary runs under DEFAULT
    ``RIPTIDE_DEVICE_CLUSTER`` semantics regardless of the surrounding
    run's setting — the flag changes the pulled buffer's layout (the
    on-device cluster sections ride along), and the canary exists to
    catch a device computing a KNOWN-good input wrongly, not a
    configuration override."""
    from ..search.engine import run_search_batch
    from ..search.peaks_device import force_device_cluster
    from ..search.plan import periodogram_plan

    plan = periodogram_plan(
        CANARY_NSAMP, CANARY_TSAMP, CANARY_WIDTHS,
        CANARY_SEARCH["period_min"], CANARY_SEARCH["period_max"],
        CANARY_SEARCH["bins_min"], CANARY_SEARCH["bins_max"])
    rng = np.random.default_rng(CANARY_SEED)
    batch = rng.standard_normal(
        (CANARY_TRIALS, CANARY_NSAMP)).astype(np.float32)
    acc = _FoldAccumulator()
    prev = _active()
    _tls.acc = acc
    try:
        with force_device_cluster(True):
            run_search_batch(
                plan, batch, CANARY_NSAMP * CANARY_TSAMP,
                dms=np.arange(CANARY_TRIALS, dtype=np.float64),
                device=device)
    finally:
        _tls.acc = prev
    return acc.hexdigest()


def write_canary_pin(device=None, path=None):
    """Compute the canary digest on ``device`` and write it as that
    device's pin (atomically, keeping the other devices' pins).
    Returns (platform, digest)."""
    from ..utils import fsio

    path = path or canary_pin_path()
    platform = canary_platform(device)
    digest = compute_canary_digest(device)
    pins = _read_canary_pin(path)
    pins[platform] = digest
    fsio.atomic_write_text(path, json.dumps(
        {"platform_digests": dict(sorted(pins.items()))}, indent=2) + "\n")
    return platform, digest


def _read_canary_pin(path):
    try:
        with open(path) as fobj:
            data = json.load(fobj)
    except (OSError, ValueError):
        return {}
    pins = data.get("platform_digests")
    return pins if isinstance(pins, dict) else {}


# -- the per-run manager ----------------------------------------------------

class IntegrityManager:
    """One run's integrity state: the fold-context lifecycle around
    each dispatch attempt, the shadow-probe cadence, the quarantine
    latch and the canary. Owned by the scheduler (one manager per
    run); ``None`` while the mode is ``off``, so the off path carries
    no state at all."""

    def __init__(self, config, metrics=None, device=None):
        self.config = config
        self.metrics = metrics or get_metrics()
        # Where the canary runs: the scheduler's device (None: the card).
        self.device = device
        self.quarantined = False

    # -- fold-context lifecycle (one per dispatch attempt) ------------------

    def begin_fold(self, chunk_id, corrupt_hit=None):
        """Install a fresh accumulator on the CALLING thread (the
        thread that will run collect) for one dispatch attempt;
        ``corrupt_hit`` arms an injected bitflip for this attempt."""
        acc = _FoldAccumulator(corrupt_hit=corrupt_hit)
        _tls.acc = acc
        return acc

    def finish_fold(self, acc):
        """Uninstall ``acc`` and return its partial integrity info:
        ``{"result": hex|None, "nbuf": n, "path": str|None}``."""
        if _active() is acc:
            _tls.acc = None
        return {"result": acc.hexdigest(), "nbuf": acc.nbuf,
                "path": acc.path}

    # -- Ring 2 cadence ------------------------------------------------------

    def probe_due(self, chunk_id):
        """Should this chunk be shadow-dispatched? ``strict`` probes
        every chunk; ``probe`` every ``probe_every``-th (0 = never);
        ``digest``/``off`` never."""
        if self.quarantined:
            return False
        if self.config.mode == "strict":
            return True
        if not self.config.probing:
            return False
        return int(chunk_id) % self.config.probe_every == 0

    def record_mismatch(self, chunk_id, **detail):
        """One detected divergence: counter + ``result_mismatch``
        incident (chunk + span id attach automatically)."""
        self.metrics.add("integrity_mismatches")
        incidents.emit("result_mismatch", chunk_id=chunk_id, **detail)

    def quarantine(self, chunk_id, digests):
        """Latch the device suspect (idempotent) and run the canary so
        the ``integrity_quarantine`` incident records whether the
        device fails a KNOWN-good input too. Returns the canary
        verdict."""
        verdict = self.canary_verdict()
        if not self.quarantined:
            self.quarantined = True
            incidents.emit(
                "integrity_quarantine", chunk_id=chunk_id,
                digests=[d[:12] if d else "none" for d in digests],
                canary=verdict, policy=self.config.policy)
        return verdict

    # -- Ring 3 --------------------------------------------------------------

    def canary_verdict(self):
        """Run the golden canary against its platform pin: ``ok`` /
        ``failed`` / ``unpinned`` (no pin for this platform — noted,
        never fatal) / ``error`` (the canary search itself raised; a
        suspect device may not even complete it)."""
        pin_path = self.config.canary_pin or canary_pin_path()
        pins = _read_canary_pin(pin_path)
        try:
            platform = canary_platform(self.device)
        except Exception as err:
            log.warning("integrity canary: no device to run on (%s)", err)
            return "unpinned"
        pinned = pins.get(platform)
        if pinned is None:
            log.info("integrity canary: no pin for platform %r in %s "
                     "(pass-with-note; `python -m "
                     "riptide_tpu_torch.survey.integrity --repin` writes "
                     "one)", platform, pin_path)
            return "unpinned"
        try:
            digest = compute_canary_digest(self.device)
        except Exception as err:
            log.error("integrity canary raised: %s", err)
            incidents.emit("canary_failed", platform=platform,
                           error=str(err))
            self.metrics.add("integrity_mismatches")
            return "error"
        self.metrics.add("integrity_checks")
        if digest == pinned:
            log.info("integrity canary: ok (%s)", digest[:12])
            return "ok"
        self.metrics.add("integrity_mismatches")
        incidents.emit("canary_failed", platform=platform,
                       expected=pinned[:12], actual=(digest or "")[:12])
        return "failed"

    def startup_canary(self):
        """``strict``-mode warmup gate: run the canary before any
        tenant work and abort the run on failure — a device that
        cannot reproduce the pinned digest must not be trusted with a
        single chunk. Other modes skip (their canary runs on
        quarantine decisions only)."""
        if self.config.mode != "strict":
            return None
        verdict = self.canary_verdict()
        if verdict in ("failed", "error"):
            raise RuntimeError(
                "integrity canary failed at startup (verdict "
                f"{verdict!r}): refusing to dispatch survey work on a "
                "device that cannot reproduce the pinned golden-canary "
                "digest")
        return verdict

    # -- Ring 1 resume verification ------------------------------------------

    def verify_replay(self, chunk_id, rec, peaks):
        """Re-verify one journal-replayed chunk against its recorded
        ``integrity`` block. Records without one (older journals,
        off-mode writers) are skipped silently — reader compat both
        ways. A mismatch is a detected event, not a fatal one: the
        incident (``replayed`` marked) is the forensic record and the
        replay proceeds, exactly like every other observability
        signal."""
        blk = rec.get("integrity") if isinstance(rec, dict) else None
        expected = blk.get("peaks") if isinstance(blk, dict) else None
        if not expected:
            return True
        actual = peaks_digest(peaks)
        self.metrics.add("integrity_checks")
        if actual == expected:
            return True
        self.record_mismatch(
            chunk_id, replayed=True, expected=expected[:12],
            actual=actual[:12])
        log.error(
            "chunk %d: replayed peaks no longer match their journaled "
            "integrity digest (%s != %s)", chunk_id, actual[:12],
            expected[:12])
        return False


def main(argv=None):
    """``python -m riptide_tpu_torch.survey.integrity [--repin]
    [--device DEV]``: print the canary digest of the device (the card
    by default) beside its pin; ``--repin`` writes it as the pin."""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--repin", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.repin:
        platform, digest = write_canary_pin(args.device)
    else:
        platform = canary_platform(args.device)
        digest = compute_canary_digest(args.device)
    pinned = _read_canary_pin(canary_pin_path()).get(platform)
    print(json.dumps({"platform": platform, "digest": digest,
                      "pinned": pinned}))


if __name__ == "__main__":
    main()
