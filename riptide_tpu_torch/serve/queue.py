"""
Fair-share device multiplexing at DM-chunk granularity (the port's copy
of the JAX package's ``serve/queue.py``).

One card, many concurrent journaled surveys: every job's scheduler
asks the :class:`FairShareQueue` for a *turn* once a chunk is staged in
host memory and before anything of it is copied to the card (the
``chunk_gate`` hook of
:class:`~riptide_tpu_torch.survey.scheduler.SurveyScheduler`) and
releases it once the chunk's results are on the host, so jobs
interleave between chunks without ever co-occupying the card: every
chunk's copies, launches and synchronizations run inside its job's
turn, so launch counts read across a turn are that job's.
The pick rule is priority-then-fair-share: among the jobs
waiting for a turn, the lowest ``priority`` number wins; within a
priority band the job whose *tenant* has consumed the least device
time so far goes first (ties break to the job with the least device
time, then to submission order), so a tenant running five jobs cannot
starve a tenant running one — classic weighted-fair-queueing vruntime,
charged from the gate's own begin→end wall clock.

The gate is also the service's ONLY interruption point: cancellation,
quota enforcement, per-job deadlines and a graceful drain raise
:class:`JobCancelled` / :class:`QuotaExceeded` /
:class:`JobDeadlineExceeded` / :class:`JobDrained` out of ``begin()``,
i.e. between chunks, after the previous chunk's journal record was
fsync'd — so an interrupted job's journal is always resumable (the
durability contract of docs/survey_service.md).

One addition to the JAX package's queue: :meth:`FairShareQueue.
lose_device` (called through a gate's ``device_lost`` by a scheduler
whose chunk left the CUDA context unusable, BEFORE it releases its
turn) parks every other job at its next ``begin`` like a drain, so no
job's turn starts on a dead context.

Stdlib-only; the daemon (:mod:`riptide_tpu_torch.serve.daemon`) owns
the lifecycle around it.
"""
import threading
import time

__all__ = ["FairShareQueue", "JobCancelled", "JobDeadlineExceeded",
           "JobDrained", "QuotaExceeded"]


class JobCancelled(Exception):
    """Raised out of a job's chunk gate when the job was cancelled;
    the scheduler unwinds at the chunk boundary, journal intact."""


class QuotaExceeded(Exception):
    """Raised out of a job's chunk gate when its tenant's
    device-seconds budget is exhausted."""


class JobDeadlineExceeded(Exception):
    """Raised out of a job's chunk gate when its ``deadline_s`` wall
    clock (measured from registration) has expired. Like a quota stop,
    the journal is left resumable — a resubmit with a fresh deadline
    continues from the completed chunks."""


class JobDrained(Exception):
    """Raised out of a job's chunk gate when the daemon is draining:
    the running chunk finished, this job parks WITHOUT a terminal
    registry record, and a restart re-queues it (``resumed``)."""


class _Entry:
    __slots__ = ("job_id", "tenant", "priority", "seq", "device_s",
                 "waiting", "cancelled", "t0", "deadline")

    def __init__(self, job_id, tenant, priority, seq, deadline_s=None):
        self.job_id = job_id
        self.tenant = tenant
        self.priority = int(priority)
        self.seq = int(seq)
        self.device_s = 0.0      # this job's charged turn seconds
        self.waiting = False     # parked in begin(), wanting a turn
        self.cancelled = False
        self.t0 = None           # perf_counter at turn grant
        # Wall-clock cutoff (monotonic) from registration; None = no
        # per-job deadline.
        self.deadline = (None if deadline_s is None
                         else time.monotonic() + float(deadline_s))


class _Gate:
    """One job's ``chunk_gate`` view of the queue (the object handed to
    its SurveyScheduler): begin/end delegate with the job id bound."""

    def __init__(self, queue, job_id):
        self._queue = queue
        self.job_id = job_id

    def begin(self, chunk_id):
        self._queue.begin(self.job_id, chunk_id)

    def end(self, chunk_id):
        self._queue.end(self.job_id, chunk_id)

    def device_lost(self, chunk_id):
        self._queue.lose_device(self.job_id)


class FairShareQueue:
    """Priority + weighted-fair-share turn arbiter over one device.

    ``tenants`` is an optional :class:`riptide_tpu_torch.serve.tenants.
    TenantTable`; when given, each turn's seconds are charged to the
    job's tenant and ``begin`` enforces the tenant's device-seconds
    budget (raising :class:`QuotaExceeded` once it is exhausted).
    """

    def __init__(self, tenants=None):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries = {}
        self._tenant_device_s = {}
        self._active = None     # job_id holding the device turn
        self._seq = 0
        self._draining = False
        self._device_lost = False
        self.tenants = tenants

    # -- registration ----------------------------------------------------

    def register(self, job_id, tenant="default", priority=0,
                 deadline_s=None):
        """Add a job and return its :class:`_Gate` (the scheduler's
        ``chunk_gate``). Re-registering an id replaces the old entry
        (a restarted job keeps its tenant's accumulated fair share —
        that lives in the per-tenant total, not the entry).
        ``deadline_s`` arms a per-job wall-clock cutoff enforced at the
        gate like quotas."""
        with self._cond:
            self._entries[job_id] = _Entry(
                job_id, tenant, priority, self._seq,
                deadline_s=deadline_s)
            self._seq += 1
            self._tenant_device_s.setdefault(tenant, 0.0)
        return _Gate(self, job_id)

    def unregister(self, job_id):
        with self._cond:
            entry = self._entries.pop(job_id, None)
            if entry is not None and self._active == job_id:
                self._active = None
            self._cond.notify_all()

    def cancel(self, job_id):
        """Flag a job cancelled; its gate raises JobCancelled at the
        next chunk boundary (or immediately if parked in begin())."""
        with self._cond:
            entry = self._entries.get(job_id)
            if entry is None:
                return False
            entry.cancelled = True
            self._cond.notify_all()
            return True

    def drain(self):
        """Flag the whole queue draining: every gate raises
        :class:`JobDrained` at its next ``begin()`` (a chunk already
        holding the turn finishes and charges normally through
        ``end()``), so every running job parks at a chunk boundary
        with its journal resumable."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    @property
    def draining(self):
        with self._cond:
            return self._draining

    def lose_device(self, job_id):
        """Flag the card's CUDA context lost (a sticky error in
        ``job_id``'s turn, flagged before that turn ends): every gate
        then raises :class:`JobDrained` at its next ``begin()``, the
        waiting ones at once, so every other job parks at a chunk
        boundary with its journal resumable for a fresh process."""
        with self._cond:
            self._device_lost = True
            self._cond.notify_all()

    @property
    def device_lost(self):
        with self._cond:
            return self._device_lost

    def _check_stop(self, job_id):
        """Raise the exception that stops ``job_id`` at its gate, if any
        (lock held): cancelled, draining or the card lost."""
        entry = self._entries.get(job_id)
        if entry is None:
            raise JobCancelled(f"{job_id}: not registered")
        if entry.cancelled:
            raise JobCancelled(f"{job_id}: cancelled")
        if self._draining:
            raise JobDrained(f"{job_id}: daemon draining")
        if self._device_lost:
            raise JobDrained(f"{job_id}: CUDA context lost; parked for "
                             "a restart")
        self._check_deadline(entry)

    # -- the turn protocol ----------------------------------------------

    def _pick(self):
        """The waiting entry that should run next (lock held)."""
        waiting = [e for e in self._entries.values() if e.waiting]
        if not waiting:
            return None
        return min(waiting, key=lambda e: (
            e.priority,
            self._tenant_device_s.get(e.tenant, 0.0),
            e.device_s,
            e.seq,
        ))

    @staticmethod
    def _check_deadline(entry):
        if entry.deadline is not None \
                and time.monotonic() >= entry.deadline:
            raise JobDeadlineExceeded(
                f"{entry.job_id}: deadline_s exceeded at the chunk "
                "boundary")

    def begin(self, job_id, chunk_id):
        with self._cond:
            self._check_stop(job_id)
            entry = self._entries[job_id]
            if self.tenants is not None \
                    and self.tenants.exhausted(entry.tenant):
                raise QuotaExceeded(
                    f"{job_id}: tenant {entry.tenant!r} device-seconds "
                    "budget exhausted")
            entry.waiting = True
            try:
                while not (self._active is None
                           and self._pick() is entry):
                    self._cond.wait(timeout=0.5)
                    self._check_stop(job_id)
            finally:
                entry.waiting = False
            self._active = job_id
            entry.t0 = time.perf_counter()

    def end(self, job_id, chunk_id):
        with self._cond:
            entry = self._entries.get(job_id)
            if entry is None or entry.t0 is None:
                return
            elapsed = time.perf_counter() - entry.t0
            entry.t0 = None
            entry.device_s += elapsed
            self._tenant_device_s[entry.tenant] = \
                self._tenant_device_s.get(entry.tenant, 0.0) + elapsed
            if self._active == job_id:
                self._active = None
            self._cond.notify_all()
        if self.tenants is not None:
            self.tenants.charge(entry.tenant, elapsed)

    # -- introspection ---------------------------------------------------

    def job_device_s(self, job_id):
        with self._cond:
            entry = self._entries.get(job_id)
            return round(entry.device_s, 6) if entry is not None else None

    def snapshot(self):
        """Queue state for /jobs listings: per-job turn accounting."""
        with self._cond:
            return {
                "active": self._active,
                "draining": self._draining,
                "device_lost": self._device_lost,
                "jobs": {
                    e.job_id: {
                        "tenant": e.tenant,
                        "priority": e.priority,
                        "device_s": round(e.device_s, 6),
                        "waiting": e.waiting,
                        "cancelled": e.cancelled,
                    }
                    for e in self._entries.values()
                },
                "tenant_device_s": {
                    t: round(s, 6)
                    for t, s in self._tenant_device_s.items()
                },
            }
