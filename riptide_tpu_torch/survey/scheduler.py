"""
Checkpointed work-queue scheduler over DM-trial chunks (the port's copy
of the JAX package's ``survey/scheduler.py``).

Wraps the pipeline's :class:`~riptide_tpu_torch.pipeline.batcher.BatchSearcher`
chunk machinery (host load/detrend/wire-prep into pinned staging
buffers, the copy to the card, the queued search, collect) in a
resumable queue:

* chunks already recorded in the :class:`SurveyJournal` are skipped and
  their peaks replayed from the journal's peak store (kill-and-resume);
* each pending chunk's device dispatch runs under per-chunk **retry
  with exponential backoff + jitter**: a transient device error (or an
  injected one) re-dispatches the chunk, re-preparing from the host
  data when the prepared wire buffer's digest no longer matches (a
  corrupted buffer). The digest is taken, and the ``corrupt`` fault
  fires, on the host wire BEFORE any copy of it to the card is queued;
* chunk i+1's host preparation overlaps chunk i's device execution on a
  dedicated staging thread, preserving the batcher's prep/compute
  overlap (the collect round trip is paid per chunk — the price of a
  durable checkpoint after every chunk);
* completed chunks append to the journal (peaks first, then the chunk
  record — both fsync'd) so a kill at any instant loses at most the
  in-flight chunk;
* with a :class:`~riptide_tpu_torch.survey.liveness.ChunkWatchdog`, each
  dispatch attempt runs under an adaptive wall-clock deadline (budget =
  k x EWMA of chunk durations) so a *hung* attempt is abandoned and
  retried instead of stalling the survey forever;
* with a :class:`CircuitBreaker`, a persistently failing target stops
  burning retries: its chunks are *parked* (journaled, skipped,
  re-dispatched by a later resume) and the survey completes degraded
  rather than aborting.

Fault injection (:mod:`riptide_tpu_torch.survey.faults`) hooks the
dispatch path so all of the above is testable on the CPU.

**A CUDA device error differs from the JAX package's.** There a device
runtime error poisons resident executables, which the scheduler evicts
before the retry. A sticky CUDA error (an illegal address, a launch
failure) leaves the whole CUDA context unusable: every later call in
the process fails again. So after a device error the port first checks
that the context still works (a ``torch.cuda.synchronize()``); if it
does not, the run journals a ``device_error`` incident and raises
:class:`StickyDeviceError` (not retryable), and ``--resume`` in a fresh
process continues the survey. An injected ``device_error`` leaves the
context working and takes the ordinary retry path.

**Buffers of an abandoned attempt.** A watchdog-abandoned attempt runs
on in its own thread with its kernels still queued, so the retry
prepares the chunk again into fresh staging buffers, and the abandoned
attempt's buffers go back to the pool when its thread ends, with the
event of their last copy (the pool hands a buffer out again only once
that copy has completed), never at abandonment.

Observability: for the run's duration the journal doubles as the
process-wide *incident sink* (watchdog timeouts, breaker opens, parks,
OOM bisections, quarantines land as structured ``incident`` records
next to the chunk records), journaled runs heartbeat every chunk,
:meth:`SurveyScheduler.status` serves the live ``/status`` +
``/healthz`` surface on the Prometheus endpoint, and each run appends
one row to the perf ledger (``RIPTIDE_LEDGER``).
"""
import hashlib
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..obs import fleet, prom
from ..obs import report as obs_report
from ..obs.alerts import AlertEngine, install_engine, rules_from_spec
from ..obs.chrome import export_run_trace
from ..obs.schema import chunk_timing, integrity_block
from ..obs.trace import span
from ..utils import envflags, fsio, runctx
from . import incidents
from .faults import FaultAbort, FaultPlan
from .integrity import (IntegrityConfig, IntegrityManager,
                        IntegrityQuarantineError, peaks_digest)
from .liveness import is_device_error, is_timeout_error
from .metrics import get_metrics

log = logging.getLogger("riptide_tpu_torch.survey.scheduler")

__all__ = ["SurveyScheduler", "RetryPolicy", "CircuitBreaker",
           "TransientChunkError", "StickyDeviceError", "survey_identity",
           "run_with_retry", "context_usable", "stop_if_sticky"]


class TransientChunkError(RuntimeError):
    """A chunk dispatch failed in a way worth retrying (e.g. the
    prepared wire buffer's digest no longer matches)."""


class StickyDeviceError(RuntimeError):
    """A device error left the CUDA context unusable: a retry in this
    process would fail again, so the run stops here (``retryable =
    False``) and ``--resume`` in a fresh process continues it."""

    retryable = False

    def __init__(self, chunk_id, err):
        super().__init__(
            f"chunk {chunk_id}: device error left the CUDA context "
            f"unusable ({err}); resume the survey in a fresh process")
        self.chunk_id = chunk_id


def stop_if_sticky(chunk_id, err, device):
    """After a device error ``err``: raise :class:`StickyDeviceError`
    (with a journaled ``device_error`` incident) when ``device``'s CUDA
    context no longer works, so that no retry runs in this process."""
    if not is_device_error(err):
        return
    if not context_usable(device):
        incidents.emit("device_error", chunk_id=chunk_id, error=str(err),
                       sticky=True)
        raise StickyDeviceError(chunk_id, err) from err
    log.warning("chunk %d: device error classified; the CUDA context "
                "still works, re-firing", chunk_id)


def context_usable(device):
    """Whether ``device``'s CUDA context still runs work: a
    ``torch.cuda.synchronize()`` that does not raise. Always True off
    the card."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return True
    try:
        torch.cuda.synchronize(device)
    except Exception as err:
        log.error("CUDA context check failed: %s", err)
        return False
    return True


class RetryPolicy:
    """Exponential backoff with jitter around per-chunk device dispatch.

    Delay before retry ``k`` (0-based) is ``min(cap_s, base_s * 2**k)``
    scaled by a uniform jitter in ``[1 - jitter, 1 + jitter]`` — jitter
    decorrelates retry storms when many hosts share a flaky
    interconnect. ``deadline_s`` is a TOTAL wall-clock budget for one
    work unit's retry loop: attempts plus backoff can never exceed it
    (a retry whose backoff would overrun the budget re-raises instead),
    so a chunk that keeps timing out cannot stall the survey
    open-endedly. ``sleep``/``rng``/``clock`` are injectable for tests.
    """

    def __init__(self, max_retries=3, base_s=0.25, cap_s=8.0, jitter=0.5,
                 deadline_s=None, sleep=time.sleep, rng=None,
                 clock=time.monotonic):
        self.max_retries = int(max_retries)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.jitter = float(jitter)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._clock = clock

    def delay(self, attempt):
        """Backoff delay in seconds before retry ``attempt`` (0-based)."""
        d = min(self.cap_s, self.base_s * (2.0 ** attempt))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(d, 0.0)

    def backoff(self, attempt):
        self._sleep(self.delay(attempt))


def survey_identity(files, config=None):
    """Stable digest naming a survey: input file basenames (order
    matters — it defines chunk ids) plus the search-relevant config."""
    import json

    h = hashlib.sha1()
    for f in files:
        h.update(os.path.basename(str(f)).encode())
        h.update(b"\0")
    if config is not None:
        h.update(json.dumps(config, sort_keys=True, default=str).encode())
    return h.hexdigest()


def run_with_retry(work, chunk_id, retry, faults, metrics, on_retry=None):
    """The ONE retry/backoff loop around a work unit's dispatch, shared
    by the chunk scheduler and the rseek CLI: fires the fault plan's
    dispatch trigger, runs ``work()``, and on a retryable failure calls
    ``on_retry(err)`` (recovery hook, e.g. re-preparing a corrupted
    buffer, or checking the CUDA context after a device runtime error,
    which may raise), bumps ``chunks_retried``, backs off and tries
    again.
    ``KeyboardInterrupt``/``SystemExit`` re-raise immediately — an
    operator interrupt must never be "retried" or slept through — as do
    :class:`FaultAbort` and exhausted retries. Watchdog/device timeouts
    are counted as ``chunks_timed_out`` before retrying, and the whole
    loop respects ``retry.deadline_s`` (attempts + backoff never exceed
    the budget). Returns ``(result, attempts)``."""
    attempt = 0
    t0 = retry._clock()
    while True:
        try:
            faults.before_dispatch(chunk_id)
            return work(), attempt + 1
        except (KeyboardInterrupt, SystemExit):
            raise
        except FaultAbort:
            raise
        except Exception as err:
            if is_timeout_error(err):
                # Hang rate is a first-class survey health signal,
                # tracked apart from generic transient retries.
                metrics.add("chunks_timed_out")
            elif is_device_error(err):
                # Non-OOM device runtime errors get their own count:
                # the recovery hook checks the CUDA context before the
                # re-fire (see SurveyScheduler._dispatch_with_retry).
                metrics.add("device_errors")
            if not getattr(err, "retryable", True):
                # e.g. QuarantinedSeries: re-dispatching cannot fix the
                # data, so propagate instead of burning retries.
                raise
            if attempt >= retry.max_retries:
                log.error("chunk %d failed after %d attempts: %s",
                          chunk_id, attempt + 1, err)
                raise
            delay = retry.delay(attempt)
            if retry.deadline_s is not None:
                elapsed = retry._clock() - t0
                if elapsed + delay > retry.deadline_s:
                    log.error(
                        "chunk %d: retry budget exhausted (%.2fs elapsed "
                        "+ %.2fs backoff > %.2fs deadline); giving up: %s",
                        chunk_id, elapsed, delay, retry.deadline_s, err,
                    )
                    raise
            if on_retry is not None:
                # Before the count and the backoff: the hook may find
                # that no retry can succeed (a CUDA context left
                # unusable) and raise.
                on_retry(err)
            metrics.add("chunks_retried")
            log.warning(
                "chunk %d dispatch failed (%s); retry %d/%d in %.2fs",
                chunk_id, err, attempt + 1, retry.max_retries, delay,
            )
            retry._sleep(delay)
            attempt += 1


class CircuitBreaker:
    """Per-target circuit breaker over chunk dispatch outcomes.

    Retry/backoff handles *transient* faults; a shard or device that
    fails every attempt would still burn the full retry budget on every
    subsequent chunk. The breaker cuts that loss: ``failure_threshold``
    consecutive chunk failures open the circuit (``breaker_opens``
    metric), and while open every arriving chunk is *parked* — journaled
    as a ``parked`` record, skipped, survey continues — without touching
    the device. After ``cooldown_s`` the breaker goes half-open and
    admits ONE probe chunk: success closes the circuit, failure re-opens
    it and restarts the cooldown.

    States: ``closed`` (normal) -> ``open`` (parking) -> ``half-open``
    (one probe in flight) -> closed/open.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold=3, cooldown_s=60.0,
                 clock=time.monotonic, metrics=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._state = self.CLOSED
        self._failures = 0       # consecutive failures while closed
        self._opened_at = None
        # None = unbound: the owning scheduler adopts the breaker into
        # its own registry, so breaker_opens lands next to chunks_parked
        # even with a non-default registry.
        self.metrics = metrics

    @property
    def state(self):
        if self._state == self.OPEN and self._opened_at is not None \
                and self._clock() - self._opened_at >= self.cooldown_s:
            return self.HALF_OPEN
        return self._state

    def allow(self):
        """May the next chunk dispatch? While open (cooldown running)
        the answer is no; once the cooldown elapses the breaker turns
        half-open and admits a single probe."""
        state = self.state
        if state == self.CLOSED:
            return True
        if state == self.HALF_OPEN:
            # Admit the probe. Dispatch is sequential, so the probe's
            # outcome is recorded before the next allow() call.
            self._state = self.HALF_OPEN
            self._opened_at = None
            return True
        return False

    def record_success(self):
        if self._state == self.HALF_OPEN:
            log.info("circuit breaker: probe chunk succeeded; closing")
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = None

    def record_failure(self):
        if self._state == self.HALF_OPEN:
            log.warning("circuit breaker: probe chunk failed; re-opening "
                        "for %.1fs", self.cooldown_s)
            self._open()
            return
        self._failures += 1
        if self._failures >= self.failure_threshold:
            log.warning(
                "circuit breaker: %d consecutive chunk failures; opening "
                "for %.1fs (chunks will be parked, not retried)",
                self._failures, self.cooldown_s,
            )
            self._open()

    def _open(self):
        self._state = self.OPEN
        self._failures = 0
        self._opened_at = self._clock()
        (self.metrics or get_metrics()).add("breaker_opens")
        incidents.emit("breaker_open", cooldown_s=self.cooldown_s,
                       failure_threshold=self.failure_threshold)


def _wire_digest(items):
    """sha1 over every prepared wire buffer (and its scales) of a
    chunk's work items: the host bytes in the staging buffers, read
    before any copy of them is queued. None when no item holds a host
    (array, meta) pair."""
    h = hashlib.sha1()
    seen = False
    for item in items:
        prepared = item[-1]
        if isinstance(prepared, tuple) and len(prepared) == 2 \
                and hasattr(prepared[0], "tobytes"):
            h.update(prepared[0].tobytes())
            scales = prepared[1].get("scales") if isinstance(prepared[1], dict) else None
            if scales is not None:
                h.update(scales.tobytes())
            seen = True
    return h.hexdigest() if seen else None


class _ChunkWire:
    """The prepared work items of one chunk (their staging buffers are
    the pool's) and the dispatch attempts using them. Items replaced
    by :meth:`replace` go back to the pool at once when no attempt
    uses them, else when the last such attempt ends (:meth:`done`):
    an attempt the watchdog abandoned runs on in its own thread, and
    its copies may still be queued."""

    def __init__(self, searcher, items, digest):
        self._searcher = searcher
        self.items, self.digest = items, digest
        self._lock = threading.Lock()
        self._users = {}      # id(items) -> attempts using them
        self._retired = {}    # id(items) -> replaced items still in use

    def acquire(self):
        """The current (items, digest), held until :meth:`done`."""
        with self._lock:
            key = id(self.items)
            self._users[key] = self._users.get(key, 0) + 1
            return self.items, self.digest

    def done(self, items):
        with self._lock:
            key = id(items)
            self._users[key] -= 1
            old = (self._retired.pop(key, None) if not self._users[key]
                   else None)
        self._release(old)

    def replace(self, items):
        """Make ``items`` the chunk's current items (digest recomputed)
        and retire the old ones."""
        with self._lock:
            old, self.items = self.items, items
            self.digest = _wire_digest(items)
            if self._users.get(id(old)):
                self._retired[id(old)] = old
                old = None
        self._release(old)

    def close(self):
        """Retire the current items (the chunk is recorded or parked)."""
        self.replace([])

    def _release(self, items):
        if items and hasattr(self._searcher, "release_chunk"):
            self._searcher.release_chunk(items)


class SurveyScheduler:
    """
    Parameters
    ----------
    searcher : BatchSearcher
        Configured batch searcher (the scheduler drives its chunk
        stages directly).
    chunks : list of list of str
        DM-trial filename chunks, in survey order (defines chunk ids).
    journal : SurveyJournal or None
        When given, completed chunks are checkpointed and — with
        ``resume=True`` — replayed.
    resume : bool
        Skip chunks already journaled (requires ``journal``).
    retry : RetryPolicy or None
    faults : FaultPlan or None
    survey_id : str or None
        Identity recorded in the journal header; defaults to a digest
        of the chunk filenames.
    metrics : MetricsRegistry or None
        Defaults to the process-wide registry.
    watchdog : ChunkWatchdog or None
        When given, every dispatch attempt runs under its adaptive
        wall-clock deadline: a hung attempt is abandoned, raises a
        retryable ChunkTimeout, and is re-dispatched.
    breaker : CircuitBreaker or None
        When given, a chunk whose retries are exhausted is *parked*
        (journaled as a ``parked`` record, survey continues) instead of
        aborting the run, and consecutive failures open the circuit so
        further chunks park without burning retry budget. Without a
        breaker, exhausted retries propagate (legacy behaviour).
    monitor : PeerLivenessMonitor or None
        When given, a heartbeat is appended to this process's journal
        sidecar as each chunk starts (multi-host peer-loss detection).
    process_index : int
        This process's index within a multi-process run: names the
        fleet snapshot sidecar (``fleet_<p>.json``) and offsets the
        Prometheus endpoint port (``RIPTIDE_PROM_PORT_OFFSET``).
    fleet_dir : str or None
        Directory the fleet snapshot sidecar is written to (default:
        the journal directory). A process whose journal lives
        elsewhere — e.g. a per-process shard journal — can still
        federate into a shared run directory by pointing this there.
    alerts : AlertEngine or None
        Rule engine evaluated over the live run after every chunk
        (fire/resolve -> ``alert`` journal record + ``alert_fired`` /
        ``alert_resolved`` incident + prom gauge). Default: built from
        ``RIPTIDE_ALERT_RULES`` when ``RIPTIDE_ALERTS`` is on and the
        run is journaled.
    integrity : IntegrityConfig, IntegrityManager or None
        Result-integrity policy (:mod:`riptide_tpu_torch.survey.integrity`):
        per-chunk result digests, shadow recompute probes and the
        suspect-device quarantine latch. None (the default) builds the
        config from ``RIPTIDE_INTEGRITY`` / ``RIPTIDE_INTEGRITY_PROBE_
        EVERY``; the canary runs on the searcher's ``device``; an
        ``off``-mode config resolves to ``self.integrity =
        None`` so the fast path carries no integrity state at all.
    chunk_gate : object or None
        Serve-mode yield point (``riptide_tpu_torch.serve.queue``): an
        object with ``begin(chunk_id)`` / ``end(chunk_id)``. ``begin``
        is called once the chunk is staged in host memory and before
        anything of it is copied to the card; it may BLOCK until this
        survey's fair-share turn, or raise (``JobCancelled`` /
        ``QuotaExceeded`` / ``JobDeadlineExceeded`` / ``JobDrained``)
        to stop the run at the chunk boundary — the only interruption
        point, so the journal is always left resumable, and only the
        job holding the turn has chunk buffers on the card. ``end`` is
        called in a ``finally`` once the chunk's results are on the
        host and journaled (success, park, or failure alike), so the
        turn's begin-to-end wall time covers the chunk's queued CUDA
        work. A gate may also have ``device_lost(chunk_id)``, called
        before ``end`` when the chunk raises :class:`StickyDeviceError`
        (the serve queue then parks every other job rather than start
        its turn on a dead context). None (the default) keeps batch
        behaviour: no gating.
    """

    def __init__(self, searcher, chunks, journal=None, resume=False,
                 retry=None, faults=None, survey_id=None, metrics=None,
                 watchdog=None, breaker=None, monitor=None,
                 process_index=0, fleet_dir=None, alerts=None,
                 chunk_gate=None, integrity=None):
        self.searcher = searcher
        self.chunks = [list(c) for c in chunks]
        self.journal = journal
        self.resume = bool(resume)
        self.retry = retry or RetryPolicy()
        self.faults = faults or FaultPlan()
        self.metrics = metrics or get_metrics()
        self.watchdog = watchdog
        self.breaker = breaker
        if breaker is not None and breaker.metrics is None:
            breaker.metrics = self.metrics
        self.monitor = monitor
        self.process_index = int(process_index)
        self.fleet_dir = fleet_dir
        self.alerts = alerts
        self.chunk_gate = chunk_gate
        if integrity is None:
            integrity = IntegrityConfig.from_env()
        if isinstance(integrity, IntegrityConfig):
            integrity = (IntegrityManager(
                integrity, metrics=self.metrics,
                device=getattr(searcher, "device", None))
                if integrity.enabled else None)
        self.integrity = integrity
        if survey_id is None:
            survey_id = survey_identity([f for c in self.chunks for f in c])
        self.survey_id = survey_id
        # Live-status state: the chunk currently dispatched (None
        # between chunks) and this run's journaled timing blocks (the
        # ledger row derives from them, identically to how a report
        # re-derives it from the journal — so a run always compares
        # equal against its own ledger row).
        self._in_flight = None
        self._run_timings = []
        self._replayed_timings = []
        self._running = False
        # Incremental reader over this run's OWN journal, feeding the
        # alert engine the same watch_snapshot an outside watcher
        # derives (None while alerting is off).
        self._follower = None
        # This run's job-scoped RunContext (built by run()): status()
        # reads ITS last incident so a sibling run can never clobber
        # this run's /status tail.
        self._ctx = None

    # -- staging ------------------------------------------------------------

    def _stage(self, loaders, fnames, chunk_id):
        """Host half of one chunk: load + DQ-scan/repair + detrend +
        wire-prep. Returns (tslist, items, digest, prep_s) — tslist is
        retained so a corrupted chunk can be re-prepared without
        re-reading files; prep_s feeds the chunk's journaled timing
        block (this runs on the staging thread, OVERLAPPED with the
        previous chunk's device work, so it is reported but excluded
        from the serial wall-clock sum). Files skipped by the ingest
        policy or quarantined by the data-quality scan load as None and
        are dropped here (the journal's chunk record carries their DQ
        summary)."""
        t0 = time.perf_counter()
        with self.metrics.timer("chunk_prep_s"), \
                span("stage", chunk=chunk_id):
            tslist = [
                ts for ts in loaders.map(
                    runctx.wrap(lambda f: self.searcher.load_prepared(
                        f, chunk_id=chunk_id)),
                    fnames,
                )
                if ts is not None
            ]
            items = self.searcher._prepare_chunk(tslist)
        return (tslist, items, _wire_digest(items),
                time.perf_counter() - t0)

    # -- dispatch -----------------------------------------------------------

    def _dispatch_once(self, chunk_id, items, digest, deadline=None):
        """One dispatch attempt: digest check, ship, queue, collect.
        (The fault plan's dispatch trigger fires in run_with_retry;
        hang/straggle faults fire here, inside the watchdog deadline.)
        An attempt the watchdog already abandoned aborts at the
        deadline check instead of shipping real device work.

        Returns ``(peaks, parts, rinfo)`` where ``parts`` holds the
        attempt's serial phase seconds (ship/queue/collect wall time
        measured here; device seconds and wire bytes read as deltas of
        the engine's own metrics, so the scheduler never re-times what
        the engine already records) and ``rinfo`` is the attempt's
        result-integrity fold (``{"result": hex, "nbuf": n, "path":
        str}``; None while integrity is off). The fold context is
        installed on THIS thread for the attempt's duration: with a
        watchdog, that is the sacrificial attempt thread — so an
        abandoned attempt still blocked in collect folds into its own
        dead accumulator and can never pollute a newer attempt's
        digest. The chunk-tagged spans around each phase are what the
        engine-level prep/wire/dispatch/device spans nest under — span
        attribute inheritance is how they pick up the chunk id."""
        self.faults.in_flight(chunk_id)
        if deadline is not None:
            deadline.check()
        if digest is not None and _wire_digest(items) != digest:
            raise TransientChunkError(
                f"chunk {chunk_id}: prepared wire buffer digest mismatch "
                "(corrupted transfer buffer)"
            )
        m = self.metrics
        dev0 = m.timer_total("device_s")
        cl0 = m.timer_total("cluster_s")
        ps0 = m.timer_total("postsearch_s")
        wb0 = m.counter("wire_bytes")
        acc = None
        if self.integrity is not None:
            acc = self.integrity.begin_fold(
                chunk_id, corrupt_hit=self.faults.bitflip_arm(chunk_id))
        rinfo = None
        try:
            t0 = time.perf_counter()
            with span("ship", chunk=chunk_id):
                shipped = self.searcher._ship_chunk(items)
            t1 = time.perf_counter()
            with span("queue", chunk=chunk_id):
                queued = self.searcher._queue_chunk(shipped)
            t2 = time.perf_counter()
            with span("collect", chunk=chunk_id):
                peaks = self.searcher._collect_chunk(queued)
            t3 = time.perf_counter()
        finally:
            if acc is not None:
                rinfo = self.integrity.finish_fold(acc)
        collect_s = t3 - t2
        # The device wait happens INSIDE collect, so its delta can
        # never legitimately exceed collect_s; clamping bounds the
        # pollution from a watchdog-abandoned attempt's sacrificial
        # thread recording into the registry while this attempt's
        # delta window is open (wire_bytes keeps the same residual
        # imprecision — it only feeds the display-grade wire_MBps).
        parts = {
            "wire_s": t1 - t0,
            "queue_s": t2 - t1,
            "collect_s": collect_s,
            "device_s": min(m.timer_total("device_s") - dev0, collect_s),
            # Host-tail sub-phases of the collect (engine-recorded, read
            # as deltas like device_s): the clustering tail and the
            # whole post-pull host work — the share the on-device
            # clustering flag moves off the host.
            "cluster_s": min(m.timer_total("cluster_s") - cl0, collect_s),
            "postsearch_s": min(m.timer_total("postsearch_s") - ps0,
                                collect_s),
            "wire_bytes": int(m.counter("wire_bytes") - wb0),
        }
        return peaks, parts, rinfo

    def _dispatch_with_retry(self, chunk_id, tslist, wire):
        """One chunk's device dispatch under :func:`run_with_retry`,
        with a recovery hook that re-prepares the chunk from the
        retained host data when the prepared buffer was corrupted or a
        watchdog-abandoned attempt still holds it, and that stops the
        run when a device error left the CUDA context unusable
        (:class:`StickyDeviceError`). ``wire`` is the chunk's
        :class:`_ChunkWire`. Returns (peaks, parts, attempts, rinfo) —
        ``parts`` is the phase decomposition of the SUCCESSFUL attempt
        (failed attempts' time lands in the chunk's ``host_s``
        remainder) and ``rinfo`` the accepted attempt's integrity fold
        (None while integrity is off). When the chunk is shadow-probe
        due, the probe/vote arbitration runs AFTER the retry loop
        succeeds (see :meth:`_probe_vote`) — a shadow that disagrees
        persistently raises :class:`IntegrityQuarantineError`
        (``retryable=False``, so the retry loop can never "retry" a
        suspect device back to trusted)."""

        def work():
            if self.watchdog is not None:
                return self.watchdog.run(
                    lambda deadline: self._dispatch_held(
                        chunk_id, wire, deadline=deadline),
                    chunk_id,
                )
            return self._dispatch_held(chunk_id, wire)

        def recover(err=None):
            if err is not None:
                stop_if_sticky(chunk_id, err,
                               getattr(self.searcher, "device", None))
            abandoned = err is not None and is_timeout_error(err)
            if abandoned or (wire.digest is not None
                             and _wire_digest(wire.items) != wire.digest):
                # A corrupted prepared buffer, or one an abandoned
                # attempt may still be copying from: rebuild the chunk
                # from host data into fresh staging buffers.
                with self.metrics.timer("chunk_prep_s"):
                    wire.replace(self.searcher._prepare_chunk(tslist))

        (peaks, parts, rinfo), attempts = run_with_retry(
            work, chunk_id, self.retry, self.faults, self.metrics,
            on_retry=recover,
        )
        if self.integrity is not None:
            self.metrics.add("integrity_checks")
            if self.integrity.probe_due(chunk_id):
                peaks, parts, rinfo = self._probe_vote(
                    chunk_id, wire, peaks, parts, rinfo)
        return peaks, parts, attempts, rinfo

    def _dispatch_held(self, chunk_id, wire, deadline=None):
        """:meth:`_dispatch_once` on the chunk's current items, held for
        the attempt's duration (on the attempt's own thread), so that
        items replaced meanwhile go back to the pool only once this
        attempt has ended."""
        items, digest = wire.acquire()
        try:
            return self._dispatch_once(chunk_id, items, digest,
                                       deadline=deadline)
        finally:
            wire.done(items)

    def _probe_vote(self, chunk_id, wire, peaks, parts, rinfo):
        """Ring 2: shadow-recompute one probe-due chunk through the
        SAME already-compiled executables and compare result digests
        bit-exactly. Agreement keeps the primary. Disagreement emits a
        ``result_mismatch`` incident and a bounded re-arbitration: one
        third dispatch votes, the majority pair's peaks are accepted
        (votes journaled in the integrity block), and three distinct
        digests — a device that cannot agree with itself — raise
        :class:`IntegrityQuarantineError`."""
        m = self.metrics

        def shadow():
            m.add("shadow_probes")
            m.add("integrity_checks")
            with span("shadow_probe", chunk=chunk_id):
                return self._dispatch_held(chunk_id, wire)

        d1 = (rinfo or {}).get("result")
        peaks2, parts2, rinfo2 = shadow()
        d2 = (rinfo2 or {}).get("result")
        if d1 == d2:
            rinfo["probe"] = True
            return peaks, parts, rinfo
        m.add("integrity_mismatches")
        incidents.emit("result_mismatch", chunk_id=chunk_id,
                       primary=(d1 or "")[:12], shadow=(d2 or "")[:12])
        log.error(
            "chunk %d: shadow recompute disagrees with primary dispatch "
            "(%s != %s); arbitrating with a third dispatch", chunk_id,
            (d1 or "")[:12], (d2 or "")[:12])
        peaks3, parts3, rinfo3 = shadow()
        d3 = (rinfo3 or {}).get("result")
        votes = [(d or "")[:12] for d in (d1, d2, d3)]
        if d3 == d2:
            # The primary was the flip: the shadow pair out-votes it.
            log.warning("chunk %d: vote resolved — primary dispatch "
                        "out-voted 2:1 (transient corruption)", chunk_id)
            rinfo3["probe"] = True
            rinfo3["votes"] = votes
            return peaks3, parts3, rinfo3
        if d3 == d1:
            # The shadow was the flip: the primary stands.
            log.warning("chunk %d: vote resolved — shadow dispatch "
                        "out-voted 2:1 (transient corruption)", chunk_id)
            rinfo["probe"] = True
            rinfo["votes"] = votes
            return peaks, parts, rinfo
        raise IntegrityQuarantineError(chunk_id, (d1, d2, d3))

    # -- parking ------------------------------------------------------------

    def _park(self, chunk_id, reason):
        """Park one chunk: journal a ``parked`` record and skip it. A
        parked chunk has NO completed record, so a later ``--resume``
        run re-dispatches it once the underlying fault clears."""
        log.warning("parking chunk %d: %s", chunk_id, reason)
        self.metrics.add("chunks_parked")
        incidents.emit("chunk_parked", chunk_id=chunk_id,
                       reason=str(reason))
        if self.journal is not None:
            self.journal.record_parked(chunk_id, reason,
                                       files=self.chunks[chunk_id])

    # -- heartbeats ---------------------------------------------------------

    def _heartbeat_safe(self):
        """One per-chunk liveness beat (the monitor's sidecar when
        multi-host, this process's own otherwise: the /healthz probe
        and a status reader take beat age as THE liveness signal of a run they
        cannot otherwise observe). Heartbeats are observability, so a
        failed append can never be fatal: it degrades to an
        ``obs_write_failed`` incident + ``obs_write_errors`` counter
        and the survey carries on (a wedged sidecar should make this
        process LOOK stale, not actually kill it)."""
        try:
            if self.monitor is not None:
                self.monitor.beat()
            elif self.journal is not None:
                self.journal.heartbeat(0)
        except OSError as err:
            log.warning("heartbeat append failed: %s", err)
            self.metrics.add("obs_write_errors")
            incidents.emit("obs_write_failed", op="heartbeat",
                           error=str(err))

    # -- fleet + alerts -----------------------------------------------------

    def _fleet_directory(self):
        """Where this process's ``fleet_<p>.json`` sidecar lives (None
        disables fleet writes: no journal and no explicit fleet_dir
        means there is no run directory to federate under)."""
        if self.fleet_dir is not None:
            return self.fleet_dir
        return self.journal.directory if self.journal is not None else None

    def _fleet_safe(self):
        """(Re)write this process's fleet snapshot sidecar — the
        per-chunk publication any reader merges into the fleet view.
        write_snapshot already degrades failures to an incident +
        counter; the extra guard keeps snapshot ASSEMBLY bugs from
        ever becoming scheduling failures (obs must not kill the run
        it observes)."""
        directory = self._fleet_directory()
        if directory is None or not fleet.enabled():
            return
        try:
            fleet.write_snapshot(directory, fleet.snapshot(
                self.process_index, status=self.status(include_fleet=False),
                metrics=self.metrics, timings=self._run_timings))
        except Exception as err:
            log.warning("fleet snapshot failed: %s", err)

    def _build_alerts(self):
        """The run's alert engine: the constructor-injected one, else
        built from ``RIPTIDE_ALERT_RULES`` when ``RIPTIDE_ALERTS`` is
        on and the run is journaled (the follower-based snapshot needs
        a journal to follow). Returns None when alerting is off."""
        if self.alerts is not None:
            return self.alerts
        if self.journal is None or not envflags.get("RIPTIDE_ALERTS"):
            return None
        try:
            rules = rules_from_spec(envflags.get("RIPTIDE_ALERT_RULES"))
        except ValueError as err:
            raise ValueError(
                f"bad RIPTIDE_ALERT_RULES: {err}") from err
        return AlertEngine(rules)

    def _alert_event(self, event):
        """Engine fire/resolve hook: journal the ``alert`` record and
        mirror it as a structured incident (which the installed sink
        also journals, next to the chunk records)."""
        if self.journal is not None:
            try:
                self.journal.record_alert(event)
            except OSError as err:
                log.warning("alert record append failed: %s", err)
                self.metrics.add("obs_write_errors")
                incidents.emit("obs_write_failed", op="alert",
                               error=str(err))
        incidents.emit("alert_" + str(event.get("event")),
                       rule=event.get("rule"), value=event.get("value"),
                       limit=event.get("limit"))

    def _alerts_safe(self):
        """Evaluate the alert rules over the live run: poll this run's
        own journal through the SAME follower/snapshot derivation
        an outside watcher applies from another process, so in-process and
        out-of-process watchers fire on identical evidence. Never
        fatal — a broken rule must not take down the survey."""
        if self.alerts is None or self._follower is None:
            return
        try:
            state = self._follower.poll()
            beats = (self.journal.read_heartbeats()
                     if self.journal is not None else {})
            self.alerts.evaluate(
                obs_report.watch_snapshot(state, heartbeats=beats))
        except Exception as err:
            log.warning("alert evaluation failed: %s", err)

    # -- live status --------------------------------------------------------

    def status(self, include_fleet=True):
        """The live ``/status`` document of this survey (registered
        with :func:`riptide_tpu_torch.obs.prom.set_status_provider` while
        ``RIPTIDE_STATUS`` is on, and the same numbers a journal reader
        derives by tail-reading the journal): chunk progress, the EWMA
        chunk rate and ETA, heartbeat ages, breaker state, the most
        recent incident, the active-alert map, and — when fleet
        sidecars exist — the merged cross-process ``fleet`` block
        (``include_fleet=False`` skips the merge: the fleet snapshot
        writer itself must not recurse into it)."""
        m = self.metrics
        done = int(m.counter("chunks_done") + m.counter("chunks_skipped"))
        parked = int(m.counter("chunks_parked"))
        total = len(self.chunks)
        ewma = (self.watchdog.ewma.value
                if self.watchdog is not None else None)
        if ewma is None:
            t = m.snapshot()["timers"].get("chunk_s")
            if t and t["count"]:
                ewma = t["total_s"] / t["count"]
        remaining = max(0, total - done - parked)
        status = {
            "survey_id": self.survey_id,
            # Gates /healthz: once the run finishes, heartbeats stop
            # LEGITIMATELY — the probe must not page over a completed
            # run's aging beats (the provider stays registered so this
            # final state remains queryable).
            "running": self._running,
            "chunks_total": total,
            "chunks_done": done,
            "chunks_parked": parked,
            "chunk_in_flight": self._in_flight,
            "ewma_chunk_s": None if ewma is None else round(ewma, 4),
            "rate_chunks_per_s": (None if not ewma
                                  else round(1.0 / ewma, 4)),
            "eta_s": None if ewma is None else round(remaining * ewma, 1),
            "breaker": (self.breaker.state
                        if self.breaker is not None else None),
            # Context-first: with a run context built (run() started),
            # only incidents attributed to THIS run appear; the global
            # tail is the fallback for a scheduler queried before run().
            "last_incident": (self._ctx.last_incident()
                              if self._ctx is not None
                              else incidents.last_incident()),
        }
        if self.alerts is not None:
            status["alerts"] = self.alerts.active()
        if self.journal is not None:
            now = time.time()
            status["heartbeat_age_s"] = {
                str(p): round(max(0.0, now - ts), 3)
                for p, ts in self.journal.read_heartbeats().items()
            }
        directory = self._fleet_directory()
        if include_fleet and directory is not None:
            snapshots = obs_report.read_fleet(directory)
            if snapshots:
                # One merged cross-process view on ANY member's
                # /status: the sidecars federate the whole run.
                status["fleet"] = obs_report.merge_fleet(snapshots)
        return status

    # -- recording ----------------------------------------------------------

    def _record(self, cid, tslist, wire, peaks, timing, attempts, rinfo,
                de0):
        """Journal one completed chunk: its peaks and the chunk record
        with its timing, data-quality summary, integrity block and the
        device-error retries it burned, and the chunk's predicted-vs-
        measured peak-memory ``hbm`` block (empty while model seeding is
        off, so such records keep the JAX package's bytes)."""
        dq = {}
        if hasattr(self.searcher, "chunk_dq_summary"):
            dq = self.searcher.chunk_dq_summary(self.chunks[cid])
        # Per-chunk attribution extras: the chunk's integrity block
        # (Ring 1 digests + probe/vote provenance) and how many
        # device-error retries THIS chunk burned (the run-wide counter
        # is monotone). Falsy values are dropped so off-mode records
        # stay the JAX package's bytes.
        iblk = None
        if rinfo is not None:
            iblk = integrity_block(
                mode=self.integrity.config.mode,
                result=rinfo.get("result"),
                peaks=peaks_digest(peaks),
                path=rinfo.get("path"),
                probe=bool(rinfo.get("probe")),
                votes=rinfo.get("votes"),
            )
        hbm = {}
        if hasattr(self.searcher, "chunk_hbm_block"):
            hbm = self.searcher.chunk_hbm_block(wire.items) or {}
        extra = {
            "integrity": iblk,
            "device_error_retries":
                int(self.metrics.counter("device_errors") - de0),
        }
        extra = {k: v for k, v in extra.items() if v}
        with span("journal", chunk=cid):
            self.journal.record_chunk(
                cid, self.chunks[cid],
                [float(ts.metadata["dm"] or 0.0) for ts in tslist],
                peaks, wire_digest=wire.digest,
                timings=timing, attempts=attempts, dq=dq, hbm=hbm,
                extra=extra or None,
            )

    def _gated_chunk(self, cid, tslist, wire, prep_s, peaks_by_chunk):
        """Dispatch, record and publish one staged chunk inside its
        device turn (the caller ends the turn once this returns or
        raises: the results are on the host and journaled by then,
        however the chunk ends)."""
        if self.integrity is not None \
                and self.integrity.quarantined:
            # The quarantine latch: once a device is marked
            # suspect, no further chunk may trust it — park
            # everything remaining (a later resume on a
            # healthy process re-dispatches them).
            self._park(cid, "integrity quarantine: device "
                            "marked suspect")
            self._fleet_safe()
            self._alerts_safe()
            return
        if self.breaker is not None \
                and not self.breaker.allow():
            self._park(cid, f"circuit {self.breaker.state}")
            self._fleet_safe()
            self._alerts_safe()
            return
        self._in_flight = cid
        t0 = time.perf_counter()
        de0 = self.metrics.counter("device_errors")
        # The digest was taken at staging; the corrupt fault
        # fires here, on the host wire, before any copy of
        # it is queued.
        self.faults.corrupt_wire(cid, wire.items)
        try:
            # One span per dispatched chunk: its ship, queue
            # and collect spans (and any retries and shadow
            # probes) nest under it on this thread.
            with span("chunk", chunk=cid):
                peaks, parts, attempts, rinfo = \
                    self._dispatch_with_retry(cid, tslist, wire)
        except StickyDeviceError:
            # The CUDA context is dead for every run in this
            # process: a gate that can tell its siblings parks them
            # before this turn ends, so none starts on it.
            lost = getattr(self.chunk_gate, "device_lost", None)
            if lost is not None:
                lost(cid)
            raise
        except (KeyboardInterrupt, SystemExit, FaultAbort):
            raise
        except IntegrityQuarantineError as err:
            # Three dispatches, three answers: the device is
            # suspect. The latch parks every remaining chunk
            # ("park"); under "fail" the run raises.
            verdict = self.integrity.quarantine(
                cid, err.digests)
            log.error(
                "chunk %d: device quarantined (golden canary "
                "verdict: %s): %s", cid, verdict, err)
            if self.integrity.config.policy == "fail":
                raise
            self._park(cid, f"integrity quarantine: {err}")
            self._fleet_safe()
            self._alerts_safe()
            return
        except Exception as err:
            if is_device_error(err):
                # The retries (each of which found the CUDA
                # context working) did not clear it:
                # attribute the failure as a device_error
                # incident.
                incidents.emit("device_error", chunk_id=cid,
                               error=str(err))
            if self.breaker is None:
                raise
            # Breaker configured: a chunk that exhausted its
            # retries parks instead of aborting the survey.
            self.breaker.record_failure()
            self._park(cid,
                       f"dispatch failed after retries: {err}")
            self._fleet_safe()
            self._alerts_safe()
            return
        finally:
            self._in_flight = None
        if self.breaker is not None:
            self.breaker.record_success()
        chunk_s = time.perf_counter() - t0
        self.metrics.observe("chunk_s", chunk_s)
        self.metrics.add("chunks_done")
        peaks_by_chunk[cid] = peaks
        timing = chunk_timing(chunk_s, prep_s=prep_s, **parts)
        self._run_timings.append(timing)
        if self.journal is not None:
            self._record(cid, tslist, wire, peaks, timing,
                         attempts, rinfo, de0)
        # Per-chunk fleet publication + live alert evaluation
        # (both no-ops while their flags are off, both
        # never-fatal): the measure→detect half of the loop.
        self._fleet_safe()
        self._alerts_safe()
        log.debug("chunk %d/%d done: %d peaks, %d attempt(s)",
                  cid + 1, len(self.chunks), len(peaks),
                  attempts)

    # -- main loop ----------------------------------------------------------

    def run(self):
        """Process every chunk; returns the flat Peak list in chunk
        order (journal-replayed and freshly-searched chunks interleave
        exactly as an uninterrupted run would produce them).

        For the run's duration a job-scoped
        :class:`~riptide_tpu_torch.utils.runctx.RunContext` owns the calling
        thread (inherited by the stager/loader pool and any watchdog or
        beater thread it starts): incidents emitted anywhere down-stack
        journal into THIS run's journal even with sibling runs in
        flight, and storage-fault directives resolve this run's plan.
        The journal is ALSO installed as the process-wide incident sink
        and the plan as the process-wide storage hook — the
        fallback layer, so context-free threads and batch paths behave
        unchanged. Unless ``RIPTIDE_STATUS=0``, :meth:`status` is
        registered as the live ``/status`` source on the Prometheus
        endpoint (the provider stays registered after the run, so a
        final state remains queryable)."""
        # Build (and so VALIDATE) the alert engine before any
        # process-wide hook is installed: a typo'd RIPTIDE_ALERT_RULES
        # must fail this run without leaking the incident sink or the
        # storage-fault hook to whatever runs next in the process.
        self.alerts = self._build_alerts()
        prev_sink = None
        sink_set = False
        # A fresh run's /status must not inherit the previous run's
        # last_incident (one long-lived process can host many surveys).
        incidents.clear_last()
        if self.journal is not None:
            prev_sink = incidents.set_sink(self.journal.record_incident)
            sink_set = True
        # Storage fault directives (torn_write/enospc/fsync_fail/
        # kill_at/cache_corrupt) fire through the fsio layer; point its
        # hook at this run's plan for the duration.
        prev_hook = fsio.set_storage_faults(self.faults.storage_op)
        if envflags.get("RIPTIDE_STATUS"):
            prom.set_status_provider(self.status)
        # Alert engine + fleet plumbing for the run's duration: the
        # engine is installed process-wide so the Prometheus page can
        # render riptide_alert_active{rule=...}; the fleet source lets
        # /metrics federate every process's sidecar under a `process`
        # label. Both stay registered after the run (like the status
        # provider) so the final state remains queryable; the NEXT run
        # re-points them.
        if self.alerts is not None:
            self.alerts.on_event = self._alert_event
            install_engine(self.alerts)
            if self.journal is not None:
                self._follower = obs_report.JournalFollower(
                    self.journal.directory)
        fleet_directory = self._fleet_directory()
        if fleet_directory is not None and fleet.enabled():
            prom.set_fleet_source(
                lambda: obs_report.read_fleet(fleet_directory))
        # The job-scoped layer: this run's context on the calling
        # thread (and, via runctx.wrap, on every worker thread the run
        # starts). The process-global installs above stay as the
        # fallback so behavior is unchanged when no
        # sibling run is in flight.
        self._ctx = runctx.RunContext(
            incident_sink=(self.journal.record_incident
                           if self.journal is not None else None),
            status_provider=self.status,
            storage_faults=self.faults.storage_op,
            label=self.survey_id,
        )
        prev_ctx = runctx.install(self._ctx)
        self._running = True
        try:
            return self._run()
        finally:
            self._running = False
            self._in_flight = None
            # Final sidecar: the at-rest record of this process
            # (running=false, final counters) for late readers.
            self._fleet_safe()
            runctx.install(prev_ctx)
            fsio.set_storage_faults(prev_hook)
            if sink_set:
                incidents.set_sink(prev_sink)

    def _run(self):
        t_run0 = time.perf_counter()
        # Ring 3 warmup gate (strict mode only): the golden canary must
        # reproduce its pinned digest BEFORE any tenant work — a raise
        # here aborts the run with a ``canary_failed`` incident already
        # journaled (the sink was installed by run()).
        if self.integrity is not None:
            self.integrity.startup_canary()
        done = {}
        if self.journal is not None:
            self.journal.write_header(self.survey_id, len(self.chunks))
            if self.resume:
                for cid, (rec, peaks) in self.journal.completed_chunks().items():
                    if cid >= len(self.chunks):
                        continue
                    expect = [os.path.basename(f) for f in self.chunks[cid]]
                    if rec.get("files") != expect:
                        log.warning("journal chunk %d names %s, expected %s; "
                                    "re-dispatching", cid, rec.get("files"),
                                    expect)
                        continue
                    done[cid] = peaks
                    # Ring 1 resume verification: a replayed chunk that
                    # no longer reproduces its journaled peaks digest is
                    # a detected ``result_mismatch`` incident (records
                    # without an integrity block — older journals —
                    # skip silently).
                    if self.integrity is not None:
                        self.integrity.verify_replay(cid, rec, peaks)
                    # Retained for the ledger: a fully-replayed run
                    # still owes its row (see end of _run).
                    if rec.get("timings"):
                        self._replayed_timings.append(rec["timings"])
                    # Replayed chunks never re-load their files: restore
                    # their DQ provenance from the journal so data
                    # products stay byte-identical to an uninterrupted
                    # run.
                    if hasattr(self.searcher, "restore_dq_reports"):
                        self.searcher.restore_dq_reports(rec.get("dq"))
                if done:
                    log.info("resuming: %d/%d chunks replayed from journal",
                             len(done), len(self.chunks))
                self.metrics.add("chunks_skipped", len(done))

        pending = [i for i in range(len(self.chunks)) if i not in done]
        peaks_by_chunk = dict(done)
        # Exposition hooks: a scraper polls the RUNNING survey via the
        # optional localhost endpoint (RIPTIDE_PROM_PORT); both calls
        # are single flag reads when the operator left them off. The
        # port is offset by this process's index so co-hosted
        # processes each get their own endpoint.
        prom.maybe_serve(self.metrics, process_index=self.process_index)
        # Run-context inheritance into the staging thread: pool workers
        # have empty thread-locals, so the submitted callable carries
        # this thread's context in (and _stage re-wraps the per-file
        # load for the loader pool).
        stage = runctx.wrap(self._stage)
        with ThreadPoolExecutor(max_workers=1) as stager, \
                ThreadPoolExecutor(max_workers=self.searcher.io_threads) \
                as loaders:
            staged = (stager.submit(stage, loaders,
                                    self.chunks[pending[0]], pending[0])
                      if pending else None)
            for k, cid in enumerate(pending):
                self.metrics.set_gauge("queue_depth", len(pending) - k)
                tslist, items, digest, prep_s = staged.result()
                if k + 1 < len(pending):
                    staged = stager.submit(
                        stage, loaders, self.chunks[pending[k + 1]],
                        pending[k + 1],
                    )
                self._heartbeat_safe()
                wire = _ChunkWire(self.searcher, items, digest)
                try:
                    if self.chunk_gate is not None:
                        # Serve-mode yield point: block for this
                        # survey's fair-share turn on the card. A
                        # cancellation, quota, deadline or drain stop
                        # raises HERE — between chunks, after the
                        # previous chunk's journal write — so the
                        # journal is always left resumable.
                        self.chunk_gate.begin(cid)
                    try:
                        self._gated_chunk(cid, tslist, wire, prep_s,
                                          peaks_by_chunk)
                    finally:
                        # The turn is over whether the chunk completed,
                        # parked, or failed: the gate measures
                        # begin->end to charge the tenant's
                        # device-seconds budget.
                        if self.chunk_gate is not None:
                            self.chunk_gate.end(cid)
                finally:
                    # Results recorded, the chunk parked or the run
                    # failing: the chunk's wire-prep buffers go back to
                    # the staging pool. Never earlier — the retry and
                    # shadow-probe paths re-ship from the same prepared
                    # buffers.
                    wire.close()
        self.metrics.set_gauge("queue_depth", 0)
        # One closing evaluation over the final journal state, so a
        # condition that cleared on the last chunk still resolves
        # before the run's engine goes quiescent.
        self._alerts_safe()
        if self.journal is not None:
            self.journal.record_metrics(self.metrics.summary())
            # One Perfetto-loadable trace file per run, next to the
            # journal (no-op while tracing is disabled; a resumed run's
            # fresh tracer rotates the killed attempt's file to
            # trace.json.1 instead of overwriting it).
            export_run_trace(self.journal.directory)
        prom.maybe_write_textfile(self.metrics)
        # One perf-ledger row per COMPLETED run (no-op unless
        # RIPTIDE_LEDGER is set), derived from the journaled chunk
        # timings by the same reduction a report applies to the journal.
        # A resume that replayed EVERY chunk did fresh work only if the
        # prior attempt died between its final journal write and its
        # ledger append — in that case (no valid row for this survey in
        # the ledger yet) the row is derived from the replayed timing
        # blocks, so "a ledger row per completed run" holds across any
        # kill point without double-counting ordinary replays.
        from ..obs import ledger
        from ..obs.report import run_decomposition_from_chunks

        timings = self._run_timings
        if not timings and self._replayed_timings:
            path = ledger.ledger_path()
            if path and not any(
                r.get("kind") == "survey"
                and r.get("survey_id") == self.survey_id
                for r in ledger.read_rows(path)
            ):
                timings = self._replayed_timings
        if timings:

            run_dec, nchunks, bound_counts = \
                run_decomposition_from_chunks(timings)
            ledger.maybe_append(
                "survey", run_dec, nchunks=nchunks,
                bound_counts=bound_counts,
                extra={
                    "survey_id": self.survey_id,
                    "chunks_total": len(self.chunks),
                    "chunks_parked":
                        int(self.metrics.counter("chunks_parked")),
                    "chunks_replayed": len(self._replayed_timings),
                    "elapsed_s": round(time.perf_counter() - t_run0, 3),
                },
            )
        return [p for cid in sorted(peaks_by_chunk)
                for p in peaks_by_chunk[cid]]
