"""
The survey service daemon: warm, multi-tenant survey-as-a-service (the
port's copy of the JAX package's ``serve/daemon.py``).

One long-lived process turns the batch CLI into a job-accepting
service. A :class:`ServeDaemon` rooted at a *serve directory* holds

* the **job registry** — ``jobs.jsonl``, an event-sourced, CRC-framed
  append log (fsio site ``job_append``, the JAX package's framing, so
  either package's daemon replays the other's registry) of every job's
  lifecycle (``submitted`` → ``started`` → ``done``/``failed``/
  ``cancelled``). Replaying it on start is the crash-safety story: a
  killed daemon restarts, folds the log, and re-queues every
  pending/running job; each job's own survey journal then resumes its
  chunks, so the rewritten ``peaks.csv`` is byte-identical to an
  uninterrupted run (the ``serve-kill-mid-job`` chaos schedule asserts
  exactly this);
* the **HTTP surface** — the stdlib endpoint
  (:mod:`riptide_tpu_torch.obs.prom`) carries ``/jobs`` beside
  ``/metrics`` ``/status`` ``/healthz``: POST /jobs submits (a
  directory, a file manifest, or an inline config), GET /jobs lists,
  GET /jobs/<id> inspects, GET /jobs/<id>/peaks fetches the CSV
  product, DELETE /jobs/<id> cancels at the next chunk boundary.
  Loopback only, like every endpoint in this package;
* the **fair-share queue** (:mod:`riptide_tpu_torch.serve.queue`) —
  concurrent jobs interleave through the one card at DM-chunk
  granularity via the scheduler's ``chunk_gate`` hook, under
  per-tenant quotas (:mod:`riptide_tpu_torch.serve.tenants`). A chunk
  waits for its turn staged in pinned host memory, so only the job
  holding the turn has chunk buffers on the card;
* the **warm pins** — the built CUDA and native libraries, the
  periodogram plans, their segment plans and peak plans live in
  process-wide caches, so a job whose plan geometry was already served
  starts its first chunk with ZERO cold builds; the daemon's
  :class:`GeometryPins` attribute the warmth per geometry and per job
  (``warm_start`` in the job document; the ``exec_cold_builds``
  counter stays flat over such a job).

Every job runs through the ordinary :class:`~riptide_tpu_torch.survey.
scheduler.SurveyScheduler` on the daemon's device (``cuda`` unless the
caller asks for the CPU) with its own journal/peaks store under
``<root>/jobs/<id>/``, appends its kind-scoped ledger row, publishes
fleet sidecars and evaluates alert rules — ``rreport --compare``,
``rwatch`` and ``rtop`` work unchanged on a service job's directory.

Incident/fault attribution is job-scoped: each job's worker thread owns
a :class:`~riptide_tpu_torch.utils.runctx.RunContext` carrying the
job's incident sink and storage-fault plan (inherited by every thread
its scheduler starts), so with several jobs in flight every incident
record — including daemon-level ones like ``job_cancelled`` or
``job_timeout`` — lands in its own job's journal.

Service survival: a SIGTERM/SIGINT to ``rserve`` (or ``POST /drain``)
triggers a **graceful drain** — admission stops (503 + ``draining`` in
``/status``), the running chunk finishes, every running job parks
through the chunk gate WITHOUT a terminal record, and the process exits
0 with a registry a restart resumes exactly.

**A sticky CUDA error, the one intended difference from the JAX
daemon.** There a persistent device error fails only the job that met
it and the daemon keeps serving. On the card a
:class:`~riptide_tpu_torch.survey.scheduler.StickyDeviceError` means
the CUDA context is dead for every job in the process. The implicated
job gets its ``failed`` record (so a job whose data triggers the error
cannot loop), every other job parks at its gate without a terminal
record (its scheduler flags the queue before its own turn ends),
admission and ``/healthz`` answer 503 (``device_lost``), and ``rserve``
exits non-zero so that a supervisor restarts it and the replay resumes
the parked jobs. An injected ``device_error`` leaves the context
usable and keeps the JAX behaviour.
"""
import datetime
import glob
import json
import logging
import os
import threading
import time

from ..obs import prom
from ..survey import incidents
from ..survey.journal import SurveyJournal, _utc_iso
from ..survey.scheduler import StickyDeviceError
from ..utils import envflags, fsio, runctx
from ..utils.device import resolve_device
from .queue import (FairShareQueue, JobCancelled, JobDeadlineExceeded,
                    JobDrained, QuotaExceeded)
from .tenants import TenantTable

log = logging.getLogger("riptide_tpu_torch.serve.daemon")

__all__ = ["ServeDaemon", "JobRegistry", "GeometryPins", "job_record",
           "fold_job_events", "write_peaks_csv", "geometry_key",
           "JOB_EVENTS", "TERMINAL"]

# Lifecycle events of one job, in order; the last one folded wins.
JOB_EVENTS = ("submitted", "started", "done", "failed", "cancelled")
# Folded statuses that end a job (it no longer counts as resident).
TERMINAL = ("done", "failed", "cancelled")

_STATUS = {"submitted": "pending", "started": "running", "done": "done",
           "failed": "failed", "cancelled": "cancelled"}

# Default de-reddening parameters for jobs that do not override them
# (the same running-median config the chaos campaign and demos use).
DEFAULT_DEREDDEN = {"rmed_width": 4.0, "rmed_minpts": 101}

# Retry-After hints (seconds) on refused admissions. A 429 clears as
# soon as a resident job finishes; a 503 drain (or a lost card) clears
# only once a supervisor restarts the daemon.
ADMISSION_RETRY_AFTER_S = 2
DRAIN_RETRY_AFTER_S = 30


def job_record(job_id, event, tenant=None, priority=None, spec=None,
               error=None, npeaks=None, device_s=None, queue_wait_s=None,
               chunks_total=None, resumed=None, idempotency_key=None):
    """The ONE maker of ``jobs.jsonl`` records — every key a reader
    (obs/report.py's job table, rtop's serve view) can see is a literal
    here::

        {"kind": "job", "job_id": "j0001", "event": "submitted",
         "utc": "...Z", "tenant": "...", "priority": 0, "spec": {...}}

    ``submitted`` events may carry the client's ``idempotency_key``
    (replayed into the dedupe map on restart). Terminal events add
    ``npeaks`` / ``device_s`` / ``queue_wait_s`` / ``chunks_total``
    (done) or ``error`` (failed)."""
    rec = {"kind": "job", "job_id": str(job_id), "event": str(event),
           "utc": _utc_iso()}
    if tenant is not None:
        rec["tenant"] = str(tenant)
    if priority is not None:
        rec["priority"] = int(priority)
    if spec is not None:
        rec["spec"] = spec
    if idempotency_key is not None:
        rec["idempotency_key"] = str(idempotency_key)
    if error is not None:
        rec["error"] = str(error)
    if npeaks is not None:
        rec["npeaks"] = int(npeaks)
    if device_s is not None:
        rec["device_s"] = round(float(device_s), 6)
    if queue_wait_s is not None:
        rec["queue_wait_s"] = round(float(queue_wait_s), 6)
    if chunks_total is not None:
        rec["chunks_total"] = int(chunks_total)
    if resumed is not None:
        rec["resumed"] = bool(resumed)
    return rec


def fold_job_events(records):
    """``{job_id: state}`` folded from job records, oldest first. The
    state keeps the submit-time identity (tenant/priority/spec), the
    latest lifecycle ``status`` and the terminal summary fields."""
    jobs = {}
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "job":
            continue
        jid = rec.get("job_id")
        event = rec.get("event")
        if not jid or event not in JOB_EVENTS:
            continue
        st = jobs.setdefault(jid, {"job_id": jid})
        st["status"] = _STATUS[event]
        if event == "submitted":
            st["tenant"] = rec.get("tenant") or "default"
            st["priority"] = int(rec.get("priority") or 0)
            st["spec"] = rec.get("spec") or {}
            st["submitted_utc"] = rec.get("utc")
            if rec.get("idempotency_key"):
                st["idempotency_key"] = rec["idempotency_key"]
        elif event == "started":
            st["started_utc"] = rec.get("utc")
            st["resumed"] = bool(rec.get("resumed"))
        else:
            st["finished_utc"] = rec.get("utc")
            for key in ("error", "npeaks", "device_s", "queue_wait_s",
                        "chunks_total"):
                if rec.get(key) is not None:
                    st[key] = rec[key]
    return jobs


def parse_utc(stamp):
    """Unix seconds of a journal-format UTC stamp, or None."""
    if not stamp:
        return None
    try:
        return datetime.datetime.strptime(
            stamp, "%Y-%m-%dT%H:%M:%S.%fZ").replace(
            tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        return None


def write_peaks_csv(peaks, path):
    """The service's data product: the SAME peaks.csv serialization as
    the batch pipeline and the chaos campaign (one row per peak,
    9-decimal floats through ``table.Table.to_csv``; an empty file when
    no peaks) — byte-identity between a service job and its batch-mode
    control is the contract the serve chaos schedules assert."""
    from ..table import Table

    if not peaks:
        fsio.atomic_write_text(path, "")
        return
    Table.from_records([p.summary_dict() for p in peaks]).to_csv(
        path, sep=",", float_format="%.9f")


def geometry_key(spec):
    """Canonical identity of a job's plan geometry: everything the
    compiled executables specialize on that the SPEC controls (search
    ranges, de-reddening, format). Data-dependent parts (nsamp, batch
    width) key the executable caches themselves."""
    return json.dumps({
        "fmt": spec.get("fmt") or "presto",
        "deredden": spec.get("deredden") or DEFAULT_DEREDDEN,
        "search": spec.get("search"),
    }, sort_keys=True, separators=(",", ":"))


def resolve_files(spec):
    """The job's input files from either payload shape: ``files`` (an
    explicit manifest) or ``data_dir`` (every series header under it,
    sorted — ``*.inf`` for presto jobs, ``*.tim`` for sigproc). Raises
    ValueError when the spec names no readable inputs."""
    files = spec.get("files")
    if not files and spec.get("data_dir"):
        pat = "*.tim" if (spec.get("fmt") == "sigproc") else "*.inf"
        files = sorted(glob.glob(os.path.join(spec["data_dir"], pat)))
    if not files:
        raise ValueError(
            "job spec names no input files (give 'files' or 'data_dir')")
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise ValueError(f"job input files missing: {missing[:3]}")
    return [os.path.abspath(f) for f in files]


class JobRegistry:
    """The crash-safe job event log: ``jobs.jsonl`` under the serve
    root, CRC-framed per record (fsio site ``job_append``), replayed
    on daemon start. Torn/corrupt lines drop per fsio's lenient-line
    discipline — at worst the daemon forgets an event the client never
    got a 2xx for."""

    def __init__(self, root):
        self.root = os.path.abspath(root)
        self.path = os.path.join(self.root, "jobs.jsonl")

    def append(self, rec):
        os.makedirs(self.root, exist_ok=True)
        fsio.append_jsonl(self.path, [rec], site="job_append",
                          checksum=True)

    def read(self):
        if not os.path.exists(self.path):
            return []
        entries, _ = fsio.scan_jsonl(self.path)
        return [obj for obj, status, _ in entries
                if status in ("ok", "legacy") and obj is not None]

    def replay(self):
        """``(jobs, next_seq)``: the folded job states and the next
        unused numeric job id."""
        jobs = fold_job_events(self.read())
        seq = 0
        for jid in jobs:
            try:
                seq = max(seq, int(jid.lstrip("j")))
            except ValueError:
                continue
        return jobs, seq + 1


class GeometryPins:
    """Warmth attribution per plan geometry: which geometries this
    daemon has already built for. The builds themselves are pinned by
    the process-wide caches (the loaded CUDA and native libraries, the
    periodogram, segment and peak plans) — living in one long process
    IS the pin; this table makes it observable per job."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pins = {}

    def warm_start(self, key):
        """True when ``key``'s geometry was already served (record the
        use either way)."""
        with self._lock:
            pin = self._pins.get(key)
            if pin is None:
                self._pins[key] = {"jobs": 1, "first_use_utc": _utc_iso()}
                return False
            pin["jobs"] += 1
            return True

    def snapshot(self):
        with self._lock:
            return {k: dict(v) for k, v in self._pins.items()}


class ServeDaemon:
    """The long-lived service process (driven by ``rserve``; tests
    construct it in-process).

    Parameters
    ----------
    root : str
        Serve directory: ``jobs.jsonl``, ``jobs/<id>/`` per-job
        directories, ``serve.port`` discovery file.
    port : int or None
        HTTP port (None reads ``RIPTIDE_SERVE_PORT``; 0 = ephemeral).
    max_jobs : int or None
        Resident-job cap (None reads ``RIPTIDE_SERVE_MAX_JOBS``).
    tenants : TenantTable or None
    workers : int
        Job worker threads — the concurrency of the fair-share
        interleave (each job still gets at most one device turn at a
        time).
    serve_jobs : bool or None
        Whether to register the /jobs API (None reads
        ``RIPTIDE_SERVE``); False leaves the endpoint
        metrics/status-only.
    device : str, torch.device or None
        Where every job searches (``utils.device.resolve_device``:
        None means ``cuda``, and a host without a card raises).
    fault_exit : callable
        The hard-exit primitive of injected ``kill_at`` faults
        (``os._exit``; a chaos leg passes one that writes its report
        first).
    """

    def __init__(self, root, port=None, max_jobs=None, tenants=None,
                 workers=2, serve_jobs=None, device=None,
                 fault_exit=os._exit):
        self.root = os.path.abspath(root)
        self.device = resolve_device(device)
        self.fault_exit = fault_exit
        self.registry = JobRegistry(self.root)
        self.tenants = tenants or TenantTable()
        self.queue = FairShareQueue(self.tenants)
        self.pins = GeometryPins()
        self.max_jobs = int(envflags.get("RIPTIDE_SERVE_MAX_JOBS")
                            if max_jobs is None else max_jobs)
        self.port = int(envflags.get("RIPTIDE_SERVE_PORT")
                        if port is None else port)
        self.serve_jobs = bool(envflags.get("RIPTIDE_SERVE")
                               if serve_jobs is None else serve_jobs)
        self.workers = int(workers)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._jobs = {}
        self._pending = []
        self._seq = 1
        self._stop = False
        self._threads = []
        self._server = None
        # Idempotency-Key -> job_id dedupe map (rebuilt from the
        # registry on start, TERMINAL jobs included: a retried POST
        # after completion still returns the original job).
        self._idem = {}
        self._draining = False
        self._device_lost = False
        self._drained = threading.Event()

    # -- lifecycle -------------------------------------------------------

    def start(self):
        """Replay the registry, re-queue unfinished jobs, bind the HTTP
        endpoint (publishing the bound port in ``serve.port``), register
        the /jobs API and start the workers. Returns self."""
        os.makedirs(os.path.join(self.root, "jobs"), exist_ok=True)
        self._jobs, self._seq = self.registry.replay()
        self._idem = {st["idempotency_key"]: jid
                      for jid, st in self._jobs.items()
                      if st.get("idempotency_key")}
        resumed = [jid for jid in sorted(self._jobs)
                   if self._jobs[jid].get("status") in
                   ("pending", "running")]
        for jid in resumed:
            st = self._jobs[jid]
            # Unfinished jobs re-enter admission accounting and the
            # run queue; a previously RUNNING job resumes its own
            # journal (the scheduler replays completed chunks).
            self.tenants.job_started(st.get("tenant", "default"))
            if st.get("status") == "running":
                st["resumed"] = True
            self._pending.append(jid)
        if resumed:
            log.info("serve: re-queued %d unfinished job(s) after "
                     "restart: %s", len(resumed), ", ".join(resumed))
        self._server = prom.serve(self.port)
        self.port = self._server.port
        fsio.atomic_write_text(os.path.join(self.root, "serve.port"),
                               f"{self.port}\n")
        if self.serve_jobs:
            prom.set_jobs_api(self)
        for i in range(self.workers):
            t = threading.Thread(target=self._worker,
                                 name=f"riptide-serve-worker-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        log.info("serve: daemon on http://127.0.0.1:%d/jobs (root %s)",
                 self.port, self.root)
        return self

    def stop(self, timeout=30.0):
        """Graceful stop: deregister the /jobs API, cancel running
        jobs at their next chunk boundary, join workers, close the
        endpoint. Pending jobs stay pending in the registry — the next
        start() re-queues them."""
        if self.serve_jobs:
            prom.set_jobs_api(None)
        with self._cond:
            self._stop = True
            running = [jid for jid, st in self._jobs.items()
                       if st.get("status") == "running"]
            self._cond.notify_all()
        for jid in running:
            self.queue.cancel(jid)
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []
        if self._server is not None:
            self._server.close()
            self._server = None

    def drain(self, timeout=None):
        """Initiate a graceful drain (SIGTERM/SIGINT in rserve, or
        ``POST /drain``): stop admission (submit answers 503 with
        ``draining``), stop workers picking pending jobs, and flag the
        fair-share queue so every RUNNING job finishes its in-flight
        chunk and parks at the gate WITHOUT a terminal registry record
        — a restart replays ``jobs.jsonl`` and resumes each parked
        job's journal exactly. Idempotent; returns immediately (a
        background thread joins the workers and sets the drained
        event — :meth:`wait_drained`). ``timeout`` bounds that join
        (default ``RIPTIDE_SERVE_DRAIN_TIMEOUT_S``)."""
        with self._cond:
            if self._draining:
                return
            self._draining = True
            self._stop = True
            self._cond.notify_all()
        log.info("serve: draining — admission stopped, running chunks "
                 "finishing")
        self.queue.drain()
        self._start_park_wait(timeout)

    def _start_park_wait(self, timeout):
        """A background join of the workers that sets the drained event
        (:meth:`wait_drained`), bounded by ``timeout`` (default
        ``RIPTIDE_SERVE_DRAIN_TIMEOUT_S``)."""
        timeout = (float(envflags.get("RIPTIDE_SERVE_DRAIN_TIMEOUT_S"))
                   if timeout is None else float(timeout))
        threading.Thread(target=self._finish_drain, args=(timeout,),
                         name="riptide-serve-drain", daemon=True).start()

    def _lose_device(self, jid, err):
        """A sticky CUDA error in ``jid``'s turn: the context is dead for
        every job in this process. Stop picking jobs (the scheduler
        already flagged the queue, so every other running job parks at
        its gate without a terminal record), refuse admission and
        fail ``/healthz`` (``device_lost``), and join the workers so
        ``rserve`` can exit non-zero for a supervisor's restart."""
        with self._cond:
            if self._device_lost:
                return
            self._device_lost = True
            self._stop = True
            self._cond.notify_all()
        log.error("serve: %s left the CUDA context unusable (%s); parking "
                  "every job for a restart", jid, err)
        self.queue.lose_device(jid)
        self._start_park_wait(None)

    def _finish_drain(self, timeout):
        deadline = time.monotonic() + max(0.1, timeout)
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        stuck = [t.name for t in self._threads if t.is_alive()]
        if stuck:
            log.warning("serve: drain timed out waiting for %s",
                        ", ".join(stuck))
        else:
            log.info("serve: drained — all workers parked, registry "
                     "flushed")
        self._drained.set()

    def wait_drained(self, timeout=None):
        """Block until a drain started by :meth:`drain` has parked all
        workers (True) or ``timeout`` elapsed (False)."""
        return self._drained.wait(timeout)

    @property
    def draining(self):
        with self._lock:
            return self._draining

    @property
    def device_lost(self):
        """True once a sticky CUDA error killed this process's context
        (the daemon then serves no job until it is restarted)."""
        with self._lock:
            return self._device_lost

    # -- the jobs API (called from HTTP handler threads) -----------------

    def submit(self, payload, idempotency_key=None):
        """``(code, doc)`` for POST /jobs. 202 on acceptance; 400 on a
        bad spec; 429 on admission refusal (resident cap or tenant
        quota), with a ``job_rejected`` incident and a
        ``retry_after_s`` hint; 503 while draining. A repeated
        ``idempotency_key`` returns the EXISTING job's document (202)
        instead of double-enqueueing — the client retry contract after
        a timed-out response."""
        spec = dict(payload or {})
        tenant = str(spec.get("tenant") or "default")
        priority = int(spec.get("priority") or 0)
        with self._lock:
            if self._device_lost:
                return 503, {"error": "CUDA context lost; resubmit after "
                                      "the daemon restarts",
                             "device_lost": True,
                             "retry_after_s": DRAIN_RETRY_AFTER_S}
            if self._draining:
                return 503, {"error": "service draining; resubmit after "
                                      "the daemon restarts",
                             "draining": True,
                             "retry_after_s": DRAIN_RETRY_AFTER_S}
            if idempotency_key is not None \
                    and str(idempotency_key) in self._idem:
                jid = self._idem[str(idempotency_key)]
            else:
                jid = None
        if jid is not None:
            log.info("serve: idempotent replay of %s (key %s)",
                     jid, idempotency_key)
            return 202, self._job_doc(jid)
        try:
            files = resolve_files(spec)
        except (ValueError, TypeError, OSError) as err:
            return 400, {"error": str(err)}
        if not isinstance(spec.get("search"), list) or not spec["search"]:
            return 400, {"error": "job spec needs 'search': a non-empty "
                                  "list of range configs"}
        if spec.get("deadline_s") is not None:
            try:
                if float(spec["deadline_s"]) <= 0:
                    raise ValueError
            except (TypeError, ValueError):
                return 400, {"error": "'deadline_s' must be a positive "
                                      "number of seconds"}
        if spec.get("integrity") is not None:
            # Validate at admission: a typo'd integrity spec must 400
            # here, not fail the job at run.
            from ..survey.integrity import IntegrityConfig
            try:
                IntegrityConfig.from_spec(spec["integrity"])
            except ValueError as err:
                return 400, {"error": str(err)}
        with self._lock:
            resident = sum(1 for st in self._jobs.values()
                           if st.get("status") in ("pending", "running"))
        if resident >= self.max_jobs:
            incidents.emit("job_rejected", tenant=tenant,
                           reason=f"resident job cap {self.max_jobs}")
            return 429, {"error": f"service at max resident jobs "
                                  f"({self.max_jobs})",
                         "retry_after_s": ADMISSION_RETRY_AFTER_S}
        ok, reason = self.tenants.admit(tenant)
        if not ok:
            incidents.emit("job_rejected", tenant=tenant, reason=reason)
            return 429, {"error": reason,
                         "retry_after_s": ADMISSION_RETRY_AFTER_S}
        with self._cond:
            # Re-check under the lock: two concurrent POSTs sharing a
            # key must still enqueue exactly one job.
            if idempotency_key is not None \
                    and str(idempotency_key) in self._idem:
                jid = self._idem[str(idempotency_key)]
                replay = True
            else:
                replay = False
        if replay:
            log.info("serve: idempotent replay of %s (key %s)",
                     jid, idempotency_key)
            return 202, self._job_doc(jid)
        with self._cond:
            jid = f"j{self._seq:04d}"
            self._seq += 1
            rec = job_record(jid, "submitted", tenant=tenant,
                             priority=priority, spec=spec,
                             idempotency_key=idempotency_key)
            self.registry.append(rec)
            self._jobs[jid] = fold_job_events([rec])[jid]
            self._jobs[jid]["nfiles"] = len(files)
            self._pending.append(jid)
            self.tenants.job_started(tenant)
            if idempotency_key is not None:
                self._idem[str(idempotency_key)] = jid
            self._cond.notify_all()
        log.info("serve: accepted %s (tenant %s, %d file(s))",
                 jid, tenant, len(files))
        return 202, self._job_doc(jid)

    def list(self):
        """The GET /jobs document: every job's summary plus the queue,
        tenant-quota and geometry-pin state."""
        with self._lock:
            ids = sorted(self._jobs)
        return {
            "jobs": [self._job_doc(jid) for jid in ids],
            "queue": self.queue.snapshot(),
            "tenants": self.tenants.snapshot(),
            "geometry_pins": self.pins.snapshot(),
            "max_jobs": self.max_jobs,
        }

    def get(self, job_id):
        with self._lock:
            known = job_id in self._jobs
        if not known:
            return 404, {"error": f"no such job {job_id!r}"}
        return 200, self._job_doc(job_id)

    def cancel(self, job_id):
        """``(code, doc)`` for DELETE /jobs/<id>: a pending job is
        cancelled immediately; a running one at its next chunk
        boundary (202 — poll until status=cancelled); a finished one
        is a 409 no-op."""
        with self._cond:
            st = self._jobs.get(job_id)
            if st is None:
                return 404, {"error": f"no such job {job_id!r}"}
            status = st.get("status")
            if status in TERMINAL:
                return 409, {"error": f"{job_id} already {status}"}
            if status == "pending" and job_id in self._pending:
                self._pending.remove(job_id)
                rec = job_record(job_id, "cancelled")
                self.registry.append(rec)
                st["status"] = "cancelled"
                st["finished_utc"] = rec["utc"]
                tenant = st.get("tenant", "default")
            else:
                # Running (or popped-but-not-yet-registered: the flag
                # below closes that race — _run_job re-checks it right
                # after registering its gate).
                st["cancel_requested"] = True
                tenant = None
        if tenant is not None:
            self.tenants.job_finished(tenant)
            incidents.emit("job_cancelled", job_id=job_id, tenant=tenant,
                           while_status="pending")
            return 200, self._job_doc(job_id)
        self.queue.cancel(job_id)
        return 202, self._job_doc(job_id)

    def peaks_csv(self, job_id):
        """``(200, bytes)`` of a done job's peaks.csv, else an error
        document."""
        with self._lock:
            st = self._jobs.get(job_id)
            status = (st or {}).get("status")
        if st is None:
            return 404, {"error": f"no such job {job_id!r}"}
        if status != "done":
            return 409, {"error": f"{job_id} is {status}, not done"}
        path = os.path.join(self.job_dir(job_id), "peaks.csv")
        try:
            with open(path, "rb") as fobj:
                return 200, fobj.read()
        except OSError as err:
            return 500, {"error": f"peaks.csv unreadable: {err}"}

    # -- internals -------------------------------------------------------

    def job_dir(self, job_id):
        return os.path.join(self.root, "jobs", job_id)

    def _job_doc(self, job_id):
        with self._lock:
            st = dict(self._jobs.get(job_id) or {})
        if st.get("status") == "running":
            live = self.queue.job_device_s(job_id)
            if live is not None:
                st["device_s"] = live
        sub = parse_utc(st.get("submitted_utc"))
        beg = parse_utc(st.get("started_utc"))
        if st.get("queue_wait_s") is None and sub and beg:
            st["queue_wait_s"] = round(max(0.0, beg - sub), 6)
        st["directory"] = self.job_dir(job_id)
        return st

    def _worker(self):
        while True:
            with self._cond:
                while not self._stop and not self._pending:
                    self._cond.wait(timeout=0.2)
                if self._stop:
                    return
                jid = self._pending.pop(0)
            try:
                self._run_job(jid)
            except Exception:
                log.exception("serve: job %s runner crashed", jid)

    def _run_job(self, jid):
        with self._lock:
            st = self._jobs[jid]
            spec = st.get("spec") or {}
            tenant = st.get("tenant", "default")
            priority = st.get("priority", 0)
            resumed = bool(st.get("resumed"))
        jobdir = self.job_dir(jid)
        os.makedirs(jobdir, exist_ok=True)
        # The job-scoped run context: installed for the whole worker
        # body so DAEMON-level incidents (job_cancelled, quota,
        # job_timeout, device_error attribution) journal into THIS
        # job's journal — _execute's scheduler then nests its own
        # context (same journal, plus status/fault plan) inside it.
        ctx = runctx.RunContext(
            incident_sink=SurveyJournal(jobdir).record_incident,
            label=jid)
        with runctx.activate(ctx):
            self._run_job_in_ctx(jid, st, spec, tenant, priority,
                                 resumed, jobdir)

    def _run_job_in_ctx(self, jid, st, spec, tenant, priority, resumed,
                        jobdir):
        started = job_record(jid, "started", resumed=resumed)
        self.registry.append(started)
        with self._lock:
            st["status"] = "running"
            st["started_utc"] = started["utc"]
        warm = self.pins.warm_start(geometry_key(spec))
        with self._lock:
            st["warm_start"] = warm
        deadline_s = spec.get("deadline_s")
        gate = self.queue.register(jid, tenant=tenant, priority=priority,
                                   deadline_s=deadline_s)
        with self._lock:
            if st.get("cancel_requested"):
                self.queue.cancel(jid)
        try:
            peaks, nchunks = self._execute(jid, spec, jobdir, gate)
            # Product BEFORE the terminal event: a kill between the
            # two re-runs the job on restart, which replays every
            # chunk from its journal and rewrites the same bytes.
            write_peaks_csv(peaks, os.path.join(jobdir, "peaks.csv"))
            done = job_record(
                jid, "done", npeaks=len(peaks),
                device_s=self.queue.job_device_s(jid),
                queue_wait_s=self._queue_wait(jid),
                chunks_total=nchunks)
            self.registry.append(done)
            with self._lock:
                st.update(status="done", finished_utc=done["utc"],
                          npeaks=len(peaks),
                          device_s=done.get("device_s"),
                          queue_wait_s=done.get("queue_wait_s"),
                          chunks_total=nchunks)
            log.info("serve: %s done (%d peak(s))", jid, len(peaks))
        except JobDrained:
            # Graceful drain: NO terminal record — the job stays
            # `running` in the registry, so the restart's replay
            # re-queues it (`resumed`) and its journal picks up at the
            # chunk after the one that finished. In-memory status is
            # left running too: /status and /jobs keep telling the
            # truth while the daemon finishes draining. The park IS
            # journaled: this worker runs under its job's RunContext,
            # so the record lands in the job's own incident journal.
            incidents.emit("job_drained", job_id=jid, tenant=tenant)
            log.info("serve: %s parked at chunk boundary for drain "
                     "(resumable on restart)", jid)
        except StickyDeviceError as err:
            # The implicated job fails (the scheduler journaled the
            # sticky device_error incident), so a job whose data
            # triggers the error cannot loop through restarts; every
            # other job parks for the restart.
            log.error("serve: %s failed with a sticky device error: %s",
                      jid, err)
            rec = job_record(jid, "failed", error=str(err))
            self.registry.append(rec)
            with self._lock:
                st.update(status="failed", finished_utc=rec["utc"],
                          error=str(err))
            self._lose_device(jid, err)
        except JobCancelled:
            incidents.emit("job_cancelled", job_id=jid, tenant=tenant,
                           while_status="running")
            rec = job_record(jid, "cancelled")
            self.registry.append(rec)
            with self._lock:
                st.update(status="cancelled", finished_utc=rec["utc"])
            log.info("serve: %s cancelled at chunk boundary", jid)
        except JobDeadlineExceeded as err:
            incidents.emit("job_timeout", job_id=jid, tenant=tenant,
                           deadline_s=spec.get("deadline_s"),
                           detail_msg=str(err))
            rec = job_record(jid, "failed", error=str(err))
            self.registry.append(rec)
            with self._lock:
                st.update(status="failed", finished_utc=rec["utc"],
                          error=str(err))
            log.info("serve: %s stopped at its deadline (journal "
                     "resumable)", jid)
        except QuotaExceeded as err:
            incidents.emit("quota_exceeded", job_id=jid, tenant=tenant,
                           detail_msg=str(err))
            rec = job_record(jid, "failed", error=str(err))
            self.registry.append(rec)
            with self._lock:
                st.update(status="failed", finished_utc=rec["utc"],
                          error=str(err))
        except Exception as err:
            from ..survey.integrity import IntegrityQuarantineError
            from ..survey.liveness import is_device_error

            if isinstance(err, IntegrityQuarantineError):
                # Containment, integrity edition: serve-mode
                # quarantine policy is "fail", so only THIS job dies —
                # the scheduler already journaled the result_mismatch /
                # integrity_quarantine incidents (with the canary
                # verdict) into the job's own journal. An expected,
                # classified terminal outcome logs clean, no traceback.
                log.error("serve: %s failed integrity quarantine: %s",
                          jid, err)
            elif is_device_error(err):
                # Classified, contained failure: the scheduler already
                # journaled the device_error incident, and each retry
                # found the CUDA context working — an expected
                # terminal outcome logs clean, no traceback.
                log.error("serve: %s failed with a persistent device "
                          "error: %s", jid, err)
            else:
                log.exception("serve: %s failed", jid)
            rec = job_record(jid, "failed", error=str(err))
            self.registry.append(rec)
            with self._lock:
                st.update(status="failed", finished_utc=rec["utc"],
                          error=str(err))
        finally:
            self.queue.unregister(jid)
            self.tenants.job_finished(tenant)

    def _queue_wait(self, jid):
        with self._lock:
            st = self._jobs.get(jid) or {}
        sub = parse_utc(st.get("submitted_utc"))
        beg = parse_utc(st.get("started_utc"))
        if sub is None or beg is None:
            return None
        return max(0.0, beg - sub)

    def _execute(self, jid, spec, jobdir, gate):
        """Run one job through the ordinary survey machinery on the
        daemon's device. Runs inside the job's RunContext (installed by
        :meth:`_run_job`); ``scheduler.run()`` nests its own context —
        same journal sink, plus this job's status provider and fault
        plan — so every scheduler-started thread attributes to this
        job. Returns ``(peaks, nchunks)``."""
        from ..pipeline.batcher import BatchSearcher
        from ..survey.faults import FaultPlan
        from ..survey.scheduler import RetryPolicy, SurveyScheduler

        files = resolve_files(spec)
        per = max(1, int(spec.get("chunk_files") or 1))
        chunks = [files[i:i + per] for i in range(0, len(files), per)]
        searcher = BatchSearcher(
            spec.get("deredden") or dict(DEFAULT_DEREDDEN),
            spec["search"], fmt=spec.get("fmt") or "presto",
            io_threads=max(1, int(spec.get("io_threads") or 1)),
            device=self.device)
        # Fault plumbing for the chaos campaign: the scheduler installs
        # its own storage-fault hook per run, so serve-mode faults must
        # ride the job itself — either in the spec or (serve chaos
        # legs) via RIPTIDE_FAULT_INJECT in the daemon's environment.
        fault_spec = spec.get("fault_inject") \
            or envflags.get("RIPTIDE_FAULT_INJECT")
        faults = (FaultPlan.parse(fault_spec, exit=self.fault_exit)
                  if fault_spec else None)
        # Result-integrity policy rides the job the same way faults do
        # (per-job spec field, environment fallback), with the serve
        # quarantine policy: "fail" — a suspect verdict fails only the
        # implicated job instead of parking the whole process's queue.
        from ..survey.integrity import IntegrityConfig
        integrity = IntegrityConfig.from_spec(spec.get("integrity"),
                                              policy="fail")
        scheduler = SurveyScheduler(
            searcher, chunks, journal=SurveyJournal(jobdir),
            resume=True, faults=faults, integrity=integrity,
            retry=RetryPolicy(max_retries=2, base_s=0.01, cap_s=0.05),
            chunk_gate=gate)
        with self._lock:
            self._jobs[jid]["survey_id"] = scheduler.survey_id
        return scheduler.run(), len(chunks)
