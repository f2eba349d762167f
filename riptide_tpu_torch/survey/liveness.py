"""
Liveness layer: deadline-driven hang detection for survey chunks (the
port's copy of the JAX package's ``survey/liveness.py``) and the
classification of the card's errors.

A survey that merely retries cannot tell a *hung* work unit from a slow
one: a wedged device dispatch blocks forever and no amount of backoff
helps. This module supplies the wall-clock primitives the scheduler
builds on:

* :class:`Deadline` — a wall-clock budget with an explicit ``expire()``
  so an abandoned attempt can observe that its result is no longer
  wanted and stop short of dispatching real work;
* :class:`DurationEWMA` + :class:`ChunkWatchdog` — an online
  exponentially-weighted moving average of per-chunk durations; the
  watchdog runs each dispatch on a sacrificial thread with budget
  ``clamp(k * EWMA, floor_s, cap_s)`` and raises a *retryable*
  :class:`ChunkTimeout` when it blows through it. Until the EWMA is
  primed the budget is ``initial_s`` (None = no deadline for the first
  chunks, which pay one-off kernel builds);
* :func:`bounded_wait` — run any blocking callable with a timeout,
  raising :class:`PeerTimeout`;
* :class:`PeerLivenessMonitor` — heartbeats in the journal's
  per-process sidecars (one process a survey in the port so far: peer
  loss, journal-writer failover and the JAX package's bounded
  collectives, ``bounded_allgather`` and ``barrier_with_timeout``, wait
  for the multi-GPU slice);
* :func:`is_device_error` / :func:`is_timeout_error` — which failures
  are the card's runtime errors and which are hangs (a
  ``torch.cuda.OutOfMemoryError`` is neither: it is
  ``search.engine.is_oom_error``'s).

Python cannot kill a thread, so a timed-out attempt's thread is
*abandoned*: it is a daemon, its :class:`Deadline` is expired, and the
dispatch path re-checks the deadline after every fault-injection sleep
so an abandoned attempt aborts before shipping real device work.
"""
import logging
import threading
import time

from ..utils import runctx
from .metrics import get_metrics

log = logging.getLogger("riptide_tpu_torch.survey.liveness")

__all__ = [
    "ChunkTimeout", "PeerTimeout", "Deadline", "DurationEWMA",
    "ChunkWatchdog", "bounded_wait", "PeerLivenessMonitor", "is_device_error",
    "is_timeout_error",
]

# Substrings identifying a deadline/hang condition in an exception
# message: the watchdog's ChunkTimeout carries "deadline exceeded".
_TIMEOUT_MARKERS = ("deadline_exceeded", "deadline exceeded",
                    "chunk timeout")


def is_timeout_error(err):
    """True when an exception looks like a hang/deadline condition (the
    watchdog's :class:`ChunkTimeout`, or a message carrying a
    deadline-exceeded marker). Timeouts are retryable — the work may
    simply have landed on a wedged queue — but are counted separately
    (``chunks_timed_out``) from generic retries so a survey's hang rate
    is observable."""
    if isinstance(err, ChunkTimeout):
        return True
    msg = str(err).lower()
    return any(marker in msg for marker in _TIMEOUT_MARKERS)


# Substrings of a CUDA runtime failure that is neither memory pressure
# nor a hang: torch raises ``torch.AcceleratorError`` (or, in older
# releases, a RuntimeError) whose message reads "CUDA error: <the
# runtime's text>"; the port's kernels return cudaGetLastError(), which
# their wrappers raise the same way. The OOM markers are repeated here
# (engine.py owns is_oom_error, but importing it would pull torch into
# this stdlib-only module) purely to EXCLUDE them.
_DEVICE_ERROR_MARKERS = ("cuda error", "cudaerror", "acceleratorerror",
                         "illegal memory access", "illegal address",
                         "unspecified launch failure",
                         "device-side assert", "misaligned address",
                         "illegal instruction", "launch timed out",
                         "cublas_status", "nccl error")
_OOM_MARKERS = ("resource_exhausted", "resource exhausted",
                "out of memory")


def is_device_error(err):
    """True when an exception looks like a NON-OOM, non-timeout CUDA
    runtime error: a ``torch.AcceleratorError`` ("CUDA error: an illegal
    memory access was encountered", "unspecified launch failure", ...),
    or any error whose message carries one of those markers. A
    ``torch.cuda.OutOfMemoryError`` (its message reads "CUDA out of
    memory") is not one. The scheduler re-fires such a chunk through
    the ordinary retry path once it has checked that the CUDA context
    still works; a sticky error, which leaves the context unusable,
    ends the run for a ``--resume`` in a fresh process (see
    ``SurveyScheduler``). Repeated failure is a ``device_error``
    incident."""
    if is_timeout_error(err):
        return False
    if type(err).__name__ == "OutOfMemoryError":
        return False
    msg = str(err).lower()
    if any(marker in msg for marker in _OOM_MARKERS):
        return False
    if type(err).__name__ == "AcceleratorError":
        return True
    return any(marker in msg for marker in _DEVICE_ERROR_MARKERS)


class ChunkTimeout(RuntimeError):
    """A chunk dispatch exceeded its watchdog deadline. Retryable: the
    attempt is abandoned and the chunk re-dispatched."""

    retryable = True

    def __init__(self, chunk_id, budget_s):
        super().__init__(
            f"chunk {chunk_id}: dispatch deadline exceeded "
            f"({budget_s:.2f}s watchdog budget); abandoning the attempt"
        )
        self.chunk_id = chunk_id
        self.budget_s = budget_s


class PeerTimeout(RuntimeError):
    """A bounded wait on a multi-host collective (or any blocking call)
    expired — the usual cause is a dead or wedged peer process."""


class Deadline:
    """Wall-clock budget handed to an in-flight dispatch attempt.

    ``expired`` becomes True either when the budget elapses or when the
    watchdog explicitly calls :meth:`expire` after abandoning the
    attempt; :meth:`check` raises :class:`ChunkTimeout` so an abandoned
    thread stops before dispatching real work.
    """

    def __init__(self, budget_s, chunk_id=0, clock=time.monotonic):
        self.budget_s = float(budget_s)
        self.chunk_id = chunk_id
        self._clock = clock
        self._t0 = clock()
        self._expired = threading.Event()

    @property
    def elapsed(self):
        return self._clock() - self._t0

    @property
    def remaining(self):
        return self.budget_s - self.elapsed

    @property
    def expired(self):
        return self._expired.is_set() or self.remaining <= 0.0

    def expire(self):
        """Mark the deadline blown (called by the watchdog when it
        abandons the attempt)."""
        self._expired.set()

    def check(self):
        """Raise :class:`ChunkTimeout` if the deadline has passed."""
        if self.expired:
            raise ChunkTimeout(self.chunk_id, self.budget_s)


class DurationEWMA:
    """Online exponentially-weighted moving average of durations
    (seconds). Thread-safe: the batcher's stream path and the
    scheduler's watchdog may observe concurrently."""

    def __init__(self, alpha=0.3):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._value = None
        self._count = 0

    def observe(self, seconds):
        with self._lock:
            s = float(seconds)
            self._value = (s if self._value is None
                           else self.alpha * s
                           + (1.0 - self.alpha) * self._value)
            self._count += 1

    @property
    def value(self):
        with self._lock:
            return self._value

    @property
    def count(self):
        with self._lock:
            return self._count


class ChunkWatchdog:
    """Run chunk dispatches under an adaptive wall-clock deadline.

    The budget for the next dispatch is ``clamp(k * EWMA(chunk
    durations), floor_s, cap_s)``; until the EWMA holds at least one
    sample it is ``initial_s`` (None = unbounded, the safe default
    while the first chunks pay compilation costs). A dispatch that
    exceeds its budget is abandoned — its daemon thread's
    :class:`Deadline` is expired so it aborts at the next check — and
    :class:`ChunkTimeout` (retryable) is raised to the caller.

    Parameters
    ----------
    k : float
        Budget multiplier over the EWMA (headroom for stragglers).
    floor_s, cap_s : float
        Clamp bounds on the computed budget.
    alpha : float
        EWMA smoothing factor (weight of the newest sample).
    initial_s : float or None
        Budget before the EWMA is primed; None disables the deadline
        for un-primed dispatches.
    """

    def __init__(self, k=4.0, floor_s=5.0, cap_s=900.0, alpha=0.3,
                 initial_s=None, clock=time.monotonic):
        if k <= 0 or floor_s <= 0 or cap_s < floor_s:
            raise ValueError(
                f"bad watchdog parameters: need k > 0, floor_s > 0, "
                f"cap_s >= floor_s (got k={k}, floor_s={floor_s}, "
                f"cap_s={cap_s})"
            )
        self.k = float(k)
        self.floor_s = float(floor_s)
        self.cap_s = float(cap_s)
        self.initial_s = None if initial_s is None else float(initial_s)
        self.ewma = DurationEWMA(alpha=alpha)
        self._clock = clock
        # Consecutive timed-out attempts: timeouts never feed the EWMA
        # (an abandoned attempt has no true duration), so the budget
        # escalates 2x per consecutive timeout instead — a workload
        # that genuinely slowed down converges to a workable budget
        # rather than timing out every chunk until the breaker parks
        # the whole survey. Reset by any successful dispatch.
        self._timeouts = 0

    def observe(self, seconds):
        """Feed one chunk duration into the EWMA (also called by the
        batcher's non-journaled stream path, so a later journaled run
        starts with primed budgets)."""
        self.ewma.observe(seconds)

    def budget(self):
        """Wall-clock budget (seconds) for the next dispatch, or None
        when no deadline applies yet. Escalates 2x per consecutive
        timed-out attempt (capped at ``cap_s``) so a genuine workload
        slowdown can re-converge instead of dying at a stale budget."""
        mean = self.ewma.value
        if mean is None:
            base = self.initial_s
        else:
            base = min(self.cap_s, max(self.floor_s, self.k * mean))
        if base is None:
            return None
        return min(self.cap_s, base * (2.0 ** self._timeouts))

    def run(self, fn, chunk_id=0):
        """Execute ``fn(deadline)`` under the current budget.

        Returns ``fn``'s result and feeds the measured duration into
        the EWMA; raises :class:`ChunkTimeout` after expiring the
        deadline when the budget elapses first. ``fn`` receives the
        :class:`Deadline` (or None when unbounded) and should re-check
        it after any internal blocking so an abandoned attempt stops
        early.
        """
        budget = self.budget()
        t0 = self._clock()
        if budget is None:
            result = fn(None)
            self._timeouts = 0
            self.observe(self._clock() - t0)
            return result

        deadline = Deadline(budget, chunk_id=chunk_id, clock=self._clock)
        completed, box = _run_sacrificial(
            lambda: fn(deadline), budget, f"chunk-{chunk_id}-dispatch",
        )
        if not completed:
            deadline.expire()
            self._timeouts += 1
            log.warning(
                "watchdog: chunk %s dispatch exceeded its %.2fs budget "
                "(EWMA %.3fs over %d chunks, %d consecutive timeouts); "
                "abandoning the attempt",
                chunk_id, budget, self.ewma.value or float("nan"),
                self.ewma.count, self._timeouts,
            )
            # Forensic record next to the count: which chunk, at what
            # budget, under which EWMA — the incident a post-mortem
            # pivots on.
            from .incidents import emit as emit_incident

            emit_incident(
                "watchdog_timeout", chunk_id=chunk_id,
                budget_s=round(budget, 3),
                ewma_s=(None if self.ewma.value is None
                        else round(self.ewma.value, 3)),
                consecutive=self._timeouts,
            )
            raise ChunkTimeout(chunk_id, budget)
        if "error" in box:
            raise box["error"]
        self._timeouts = 0
        self.observe(self._clock() - t0)
        return box["result"]


def _run_sacrificial(fn, timeout_s, name):
    """Run ``fn()`` on a sacrificial daemon thread, waiting at most
    ``timeout_s`` seconds. Returns ``(completed, box)`` where ``box``
    holds ``result`` or ``error`` when completed; on timeout the thread
    is simply abandoned (Python cannot kill it). Shared by
    :func:`bounded_wait` and :meth:`ChunkWatchdog.run` so the subtle
    relay semantics (result box, BaseException capture, done event)
    live in one place."""
    box = {}
    done = threading.Event()

    def attempt():
        try:
            box["result"] = fn()
        except BaseException as err:  # noqa: BLE001 - relayed by callers
            box["error"] = err
        finally:
            done.set()

    # runctx.wrap: the sacrificial thread inherits the caller's
    # job-scoped run context, so incidents it emits (OOM bisection,
    # quarantine, cache heal) journal into the owning run.
    worker = threading.Thread(target=runctx.wrap(attempt), daemon=True,
                              name=name)
    worker.start()
    return done.wait(float(timeout_s)), box


def bounded_wait(fn, timeout_s, what="blocking call"):
    """Run ``fn()`` with a wall-clock bound.

    ``timeout_s=None`` calls ``fn`` inline (unbounded). Otherwise ``fn``
    runs on a sacrificial daemon thread; if it has not returned within
    ``timeout_s`` seconds a :class:`PeerTimeout` is raised and the
    thread is abandoned, so a dead or wedged peer no longer deadlocks
    the caller forever.
    Exceptions from ``fn`` propagate unchanged.
    """
    if timeout_s is None:
        return fn()
    completed, box = _run_sacrificial(fn, timeout_s, f"bounded-{what}")
    if not completed:
        raise PeerTimeout(
            f"{what} did not complete within {timeout_s:.1f}s "
            "(dead or straggling peer?)"
        )
    if "error" in box:
        raise box["error"]
    return box.get("result")


class PeerLivenessMonitor:
    """This process's heartbeats in the journal's sidecars
    (:meth:`SurveyJournal.heartbeat`), and the ages of every process's
    newest beat. The port runs one process a survey; deciding from the
    ages which peers are lost, and failing the journal writer over to a
    survivor, waits for the multi-GPU slice.

    Parameters
    ----------
    journal : SurveyJournal
        Shared journal (its directory holds the heartbeat sidecars).
    process_index, process_count : int
        This process's identity in the run.
    max_age_s : float
        Heartbeat age beyond which a peer counts as stale; the
        background beater beats every third of it.
    """

    def __init__(self, journal, process_index, process_count,
                 max_age_s=60.0, clock=time.time, metrics=None):
        self.journal = journal
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.max_age_s = float(max_age_s)
        self._clock = clock
        self.metrics = metrics or get_metrics()
        self._beater_stop = None

    def beat(self):
        """Append one heartbeat for this process (call at least once
        per chunk). Raises ``OSError`` on a failed append — callers on
        the survey path go through :meth:`beat_retrying` (or the
        scheduler's own guard) so a sick filesystem degrades the
        OBSERVABILITY of liveness without killing the process whose
        liveness it observes."""
        self.journal.heartbeat(self.process_index, ts=self._clock())

    def beat_retrying(self, attempts=3, base_backoff_s=0.05):
        """One beat with bounded retry: a transient ``OSError`` (NFS
        blip, momentary ENOSPC) is retried ``attempts`` times with
        doubling backoff (capped at 1 s per sleep, so a beater can
        never wedge past its own interval); on give-up an
        ``obs_write_failed`` incident + ``obs_write_errors`` counter
        record the degradation and the caller carries on — a peer with
        a sick disk should look STALE to survivors, not die and make
        the staleness real. Returns True on a landed beat."""
        delay = float(base_backoff_s)
        last_err = None
        for i in range(max(1, int(attempts))):
            try:
                self.beat()
                return True
            except OSError as err:
                last_err = err
                if i + 1 < attempts:
                    time.sleep(min(delay, 1.0))
                    delay *= 2.0
        log.warning(
            "heartbeat append for process %d failed %d time(s), giving "
            "up until the next interval: %s",
            self.process_index, attempts, last_err,
        )
        self.metrics.add("obs_write_errors")
        from .incidents import emit as emit_incident

        emit_incident("obs_write_failed", op="heartbeat",
                      process=self.process_index,
                      attempts=int(attempts), error=str(last_err))
        return False

    def start_beating(self, interval_s=None):
        """Heartbeat from a background daemon thread every
        ``interval_s`` seconds (default ``max_age_s / 3``).

        Per-chunk :meth:`beat` calls alone make liveness track chunk
        *progress*: a healthy process on one slow chunk would go stale
        and another survivor could claim the journal-writer role while
        the original writer still holds it (two writers on one
        journal). A background beater decouples liveness from progress
        — only a process that is actually dead, or wedged so hard the
        interpreter makes no progress, stops beating. Beats run through
        :meth:`beat_retrying`: an I/O failure is retried with bounded
        backoff and incident-recorded on give-up instead of dying
        silently in the thread. Idempotent; call :meth:`stop_beating`
        (or exit the process) to stop."""
        if self._beater_stop is not None:
            return
        stop = threading.Event()
        interval = float(interval_s if interval_s is not None
                         else self.max_age_s / 3.0)

        def beater():
            while not stop.wait(interval):
                self.beat_retrying()

        self.beat_retrying()
        # runctx.wrap: the beater inherits the starting run's context,
        # so its give-up obs_write_failed incidents attribute to the
        # run whose journal it is beating for.
        threading.Thread(target=runctx.wrap(beater), daemon=True,
                         name=f"heartbeat-{self.process_index}").start()
        self._beater_stop = stop

    def stop_beating(self):
        """Stop the background heartbeat thread (tests/shutdown)."""
        if self._beater_stop is not None:
            self._beater_stop.set()
            self._beater_stop = None

    def peer_ages(self):
        """``{process_index: seconds since its newest heartbeat}`` for
        every process that has ever heartbeat. Also publishes the
        ``heartbeat_age_s`` gauge (max age over the *other* processes,
        0 when alone) so a survey's liveness is observable."""
        now = self._clock()
        ages = {p: max(0.0, now - ts)
                for p, ts in self.journal.read_heartbeats().items()}
        others = [a for p, a in ages.items() if p != self.process_index]
        self.metrics.set_gauge("heartbeat_age_s",
                               round(max(others), 3) if others else 0.0)
        return ages
