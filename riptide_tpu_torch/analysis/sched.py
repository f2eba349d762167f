"""
ripsched for the port: deterministic schedule-exploration model checking
of ``riptide_tpu_torch``'s concurrency protocols (the port's copy of the
JAX package's ``riptide_tpu/analysis/sched.py``, retargeted).

* the REAL protocol code is loaded with its synchronization primitives
  swapped for instrumented shims (:class:`SchedLock`,
  :class:`SchedCondition`, a virtual clock) driven by a cooperative
  :class:`Scheduler`: one task runs at a time, and every blocking
  operation is a *decision point* where the scheduler picks who runs
  next;
* a bounded DFS (:func:`explore_model`) enumerates interleavings under
  iterative preemption bounding (all schedules with 0 preemptions, then
  exactly 1, ... up to ``--bound``), so the first violation found is
  minimal in preemptions;
* every run is replayable: the decision digits form a schedule ID
  (``model[+mutation]:digits``) that :func:`replay` re-executes
  byte-deterministically.

Six models. ``fairshare``, ``staging``, ``runctx`` and ``quarantine``
are the JAX package's four, with their invariants and mutations, over
the port's code: ``serve/queue.py`` + ``serve/tenants.py`` loaded under
a synthetic package prefix (so ``riptide_tpu_torch/__init__`` and torch
never import); ``StagingPool``/``release_prepared`` AST-extracted from
``search/engine.py`` with torch and the device behind shims (a buffer is
a numpy array; the model needs no pinned memory); ``utils/runctx.py``
loaded whole; the quarantine latch mirrored from
``survey/integrity.py::IntegrityManager.quarantine`` and the
scheduler's park-on-latch loop (the real manager drags the journal and
torch), as is the runctx model's ``mini_emit`` from
``survey/incidents.py::emit``: each mirror says so at its definition
and must be updated with its source. Two models cover protocol the port
added: ``devicelost`` (``FairShareQueue.lose_device``: a sticky CUDA
error parks every sibling, the waiting ones at once) and
``staging_events`` (``StagingPool.acquire`` hands out no buffer whose
copy to the card, its event, has not completed; ``event.query()`` is a
decision point).

Timed waits are modeled as UNTIMED on purpose: production code's
``cond.wait(timeout=0.5)`` would eventually paper over a lost wakeup;
under the model a dropped ``notify_all`` parks its waiters forever and
surfaces as a detected deadlock instead of a 500 ms stutter.

Each invariant is proven non-vacuous by a named MUTATION that re-arms a
real bug shape (``drop_notify``, ``double_release``, ``ignore_event``,
...); ``python -m riptide_tpu_torch.apps.ripsched --mutate`` and the
seeded-regression tests assert each one is found with a printed minimal
schedule. Imports neither torch nor the package.
"""
import ast
import importlib
import importlib.util
import os
import random
import sys
import threading
import types

__all__ = [
    "InvariantViolation", "Scheduler", "SchedLock", "SchedCondition",
    "MODELS", "SARIF_RULES", "ExploreResult", "Violation",
    "explore_model", "replay", "parse_schedule_id", "format_schedule_id",
    "spec_doc", "env_default",
]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "riptide_tpu_torch"

# Decision budget per run: a schedule still undecided after this many
# scheduler choices is reported as a (non-)termination violation, never
# silently truncated.
DEFAULT_MAX_STEPS = 400
# Schedules explored per (model, mutation): hitting the cap is logged
# and marked on the result — bounded coverage must never read as
# exhaustive coverage.
DEFAULT_MAX_SCHEDULES = 800


class InvariantViolation(BaseException):
    """An invariant check failed mid-schedule. BaseException so the
    target code's own ``except Exception`` recovery paths (which are
    part of what is being model-checked) can never swallow it."""

    def __init__(self, invariant, message):
        super().__init__(f"[{invariant}] {message}")
        self.invariant = invariant
        self.message = message


class _TaskAbort(BaseException):
    """Unwinds a parked task when a run aborts (violation found or
    shutdown); BaseException so target-code ``except Exception``
    blocks cannot absorb the unwind."""


def _violate(invariant, message):
    raise InvariantViolation(invariant, message)


# -- the controlled scheduler -----------------------------------------------

class _Task:
    __slots__ = ("index", "name", "fn", "thread", "sem", "done", "pred",
                 "label", "exc")

    def __init__(self, index, name, fn):
        self.index = index
        self.name = name
        self.fn = fn
        self.thread = None
        self.sem = threading.Semaphore(0)
        self.done = False
        self.pred = None          # enabledness predicate (None = always)
        self.label = "start"      # what the task does when next granted
        self.exc = None


class Scheduler:
    """Cooperative sequentializer: model tasks run on real daemon
    threads but exactly one holds the (semaphore-passed) execution
    token at a time, yielding it back at every :meth:`op_point`. The
    controller picks the next task per the given ``schedule`` digits
    (replay / DFS prefix) and, past them, a deterministic default:
    keep the last task running while it is enabled, else the
    lowest-index enabled task — so the base schedule of any prefix
    uses zero additional preemptions.

    ``trace`` records ``(chosen_index, enabled_indices, label)`` per
    decision; the chosen indices ARE the schedule ID digits.
    """

    def __init__(self, schedule=(), max_steps=DEFAULT_MAX_STEPS):
        self.tasks = []
        self._by_thread = {}
        self._ctl = threading.Semaphore(0)
        self._schedule = tuple(int(d) for d in schedule)
        self.trace = []
        self.max_steps = int(max_steps)
        self.clock = 0.0
        self.violation = None     # (invariant id, message)
        self.diverged = None      # replay step whose digit was disabled
        self._abort = False
        self._lock_seq = 0        # per-run lock naming: replay renders
                                  # byte-identical traces

    # -- task-side API ---------------------------------------------------

    def spawn(self, name, fn):
        if len(self.tasks) >= 10:
            raise ValueError("schedule IDs encode one digit per task: "
                             "a model may declare at most 10 tasks")
        self.tasks.append(_Task(len(self.tasks), name, fn))

    def current_task(self):
        return self._by_thread.get(threading.get_ident())

    def current_name(self):
        task = self.current_task()
        return task.name if task is not None else "<main>"

    def op_point(self, pred=None, label="yield"):
        """One visible operation about to happen on the calling task:
        park, hand the token to the controller, resume when granted
        (the controller only grants a task whose ``pred`` holds, so
        the operation itself then runs atomically — no other task
        executes until the next op_point). On the controller/build
        thread this is a pass-through: the op runs immediately and a
        blocked one is a harness bug."""
        task = self.current_task()
        if task is None:
            if pred is not None and not pred():
                raise RuntimeError(
                    f"blocking operation {label!r} outside a scheduled "
                    "task (model build phase must not contend)")
            return
        if self._abort:
            raise _TaskAbort()
        task.pred = pred
        task.label = label
        self._ctl.release()
        task.sem.acquire()
        if self._abort:
            raise _TaskAbort()
        task.pred = None

    # -- controller ------------------------------------------------------

    def _task_main(self, task):
        self._by_thread[threading.get_ident()] = task
        task.sem.acquire()
        try:
            if not self._abort:
                task.fn()
        except (_TaskAbort, GeneratorExit):
            pass
        except InvariantViolation as vio:
            if self.violation is None:
                self.violation = (vio.invariant, vio.message)
        except BaseException as exc:  # a crashed task IS a finding
            task.exc = exc
            if self.violation is None:
                self.violation = (
                    "termination",
                    f"task {task.name!r} crashed: {exc!r}")
        finally:
            task.done = True
            self._ctl.release()

    def _choose(self, step, enabled, last):
        if step < len(self._schedule):
            want = self._schedule[step]
            for task in enabled:
                if task.index == want:
                    return task
            return None
        if last is not None and not last.done:
            for task in enabled:
                if task is last:
                    return task
        return enabled[0]

    def run(self):
        for task in self.tasks:
            task.thread = threading.Thread(
                target=self._task_main, args=(task,), daemon=True,
                name=f"ripsched-{task.name}")
            task.thread.start()
        step = 0
        last = None
        while self.violation is None:
            live = [t for t in self.tasks if not t.done]
            if not live:
                break
            enabled = [t for t in live
                       if t.pred is None or t.pred()]
            if not enabled:
                parked = ", ".join(
                    f"{t.name} ({t.label})" for t in live)
                self.violation = (
                    "no-lost-wakeup",
                    f"deadlock: no task is runnable; parked: {parked}")
                break
            if step >= self.max_steps:
                self.violation = (
                    "termination",
                    f"schedule exceeded the {self.max_steps}-decision "
                    "budget without quiescing")
                break
            chosen = self._choose(step, enabled, last)
            if chosen is None:
                self.diverged = step
                break
            self.trace.append((chosen.index,
                               tuple(t.index for t in enabled),
                               chosen.label))
            last = chosen
            self.clock += 1.0
            chosen.sem.release()
            self._ctl.acquire()
            step += 1
        self._shutdown()

    def _shutdown(self):
        self._abort = True
        for task in self.tasks:
            if not task.done:
                task.sem.release()
        for task in self.tasks:
            if task.thread is not None:
                task.thread.join(timeout=5.0)

    def digits(self):
        return "".join(str(c) for c, _, _ in self.trace)

    def trace_lines(self):
        lines = []
        for k, (chosen, enabled, label) in enumerate(self.trace):
            marks = "".join(str(i) for i in enabled)
            lines.append(f"  step {k:3d} [{marks}] -> "
                         f"{self.tasks[chosen].name}: {label}")
        return lines


# -- instrumented primitives -------------------------------------------------

class SchedLock:
    """``threading.Lock`` under scheduler control: ``acquire`` is a
    decision point enabled while the lock is free; ``release`` is NOT
    a decision point — a switch right after a release is only
    observable at the next acquire/wait, which is itself a decision
    point, so eliding it prunes equivalent schedules without losing
    any distinguishable interleaving."""

    def __init__(self, sched, name=None):
        self._sched = sched
        if name is None:
            sched._lock_seq += 1
            name = f"lock#{sched._lock_seq}"
        self.name = name
        self.owner = None

    def acquire(self, blocking=True, timeout=-1):
        self._sched.op_point(pred=lambda: self.owner is None,
                             label=f"acquire {self.name}")
        self.owner = self._sched.current_name()
        return True

    def release(self):
        self.owner = None

    def locked(self):
        return self.owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class SchedRLock(SchedLock):
    """Reentrant variant (none of the current targets need one, but a
    target growing an RLock must not silently get non-reentrant
    semantics)."""

    def __init__(self, sched, name=None):
        super().__init__(sched, name)
        self._count = 0

    def acquire(self, blocking=True, timeout=-1):
        me = self._sched.current_name()
        self._sched.op_point(
            pred=lambda: self.owner is None or self.owner == me,
            label=f"acquire {self.name}")
        self.owner = me
        self._count += 1
        return True

    def release(self):
        self._count -= 1
        if self._count <= 0:
            self._count = 0
            self.owner = None


class SchedCondition:
    """``threading.Condition`` under scheduler control. ``wait`` is
    modeled UNTIMED even when the caller passes a timeout: production
    timeouts only bound how long a lost wakeup stalls the process, so
    honoring them would hide exactly the bug class this checker exists
    to find — a dropped notify parks its waiters forever and the
    scheduler reports the deadlock."""

    def __init__(self, lock=None, sched=None):
        self._sched = sched
        self._lock = lock if lock is not None else SchedLock(sched)
        self._waiting = []
        self._notified = set()

    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def wait(self, timeout=None):
        token = object()
        self._waiting.append(token)
        self._lock.release()
        self._sched.op_point(pred=lambda: token in self._notified,
                             label=f"wait on {self._lock.name}")
        self._waiting.remove(token)
        self._notified.discard(token)
        # Re-acquire races the other woken waiters: its own decision.
        self._lock.acquire()
        return True

    def wait_for(self, predicate, timeout=None):
        while not predicate():
            self.wait()
        return True

    def notify(self, n=1):
        for token in self._waiting[:n]:
            self._notified.add(token)

    def notify_all(self):
        self._notified.update(self._waiting)


class _ThreadingShim:
    """Drop-in for a target module's ``threading`` attribute: locks
    and conditions come under scheduler control, ``local`` stays the
    REAL thread-local class (model tasks are real threads, so real
    TLS — the thing the runctx model verifies — keeps its production
    semantics)."""

    def __init__(self, sched):
        self._sched = sched
        self.local = threading.local
        self.current_thread = threading.current_thread
        self.get_ident = threading.get_ident

    def Lock(self):
        return SchedLock(self._sched)

    def RLock(self):
        return SchedRLock(self._sched)

    def Condition(self, lock=None):
        return SchedCondition(lock, self._sched)


class _TimeShim:
    """Virtual clock: each read advances the scheduler's deterministic
    clock by one unit, so elapsed-time arithmetic in the target (turn
    charging) stays exact and replayable; ``sleep`` is a plain yield."""

    def __init__(self, sched):
        self._sched = sched

    def _tick(self):
        self._sched.clock += 1.0
        return self._sched.clock

    def perf_counter(self):
        return self._tick()

    def monotonic(self):
        return self._tick()

    def time(self):
        return self._tick()

    def sleep(self, seconds=0):
        self._sched.op_point(label=f"sleep({seconds})")


# -- loading the real protocol code (torch-free) -----------------------------

_TGT_PREFIX = "_ripsched_torch_tgt"


def _ensure_target_pkg(repo):
    """Synthetic package skeleton over the real source tree: parent
    modules whose ``__path__`` points at the real directories, so
    ``import _ripsched_torch_tgt.serve.queue`` loads the real file (and
    its ``from ..utils import envflags`` relative imports resolve)
    WITHOUT ever executing ``riptide_tpu_torch/__init__``, which imports
    torch."""
    if _TGT_PREFIX in sys.modules:
        return
    root = os.path.join(repo, PKG)

    def pkg(name, path):
        mod = types.ModuleType(name)
        mod.__path__ = [path]
        mod.__package__ = name
        sys.modules[name] = mod

    pkg(_TGT_PREFIX, root)
    for sub in ("serve", "utils", "survey", "obs"):
        pkg(f"{_TGT_PREFIX}.{sub}", os.path.join(root, sub))


def load_target(repo, dotted_rel):
    """The real module ``riptide_tpu_torch/<dotted_rel>`` under the synthetic
    prefix (cached across runs; re-instrumented per run)."""
    _ensure_target_pkg(repo)
    return importlib.import_module(f"{_TGT_PREFIX}.{dotted_rel}")


def instrument(mod, sched):
    """Point an already-loaded target module's ``threading`` / ``time``
    attributes at this run's shims. Primitive INSTANCES are created in
    the model build phase (after this call), so they bind the run's
    scheduler; module-level ``threading.local()`` objects from import
    time stay real, which is exactly right."""
    mod.threading = _ThreadingShim(sched)
    if hasattr(mod, "time"):
        mod.time = _TimeShim(sched)


class _Buffer:
    """A staging buffer as the pool sees it: its shape and dtype."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


class _TorchShim:
    """What the extracted staging pool reads of torch: ``empty`` gives a
    :class:`_Buffer` (``pin_memory`` ignored: the model needs no card
    and allocates nothing)."""

    @staticmethod
    def empty(shape, dtype=None, pin_memory=False):
        return _Buffer(shape, dtype)


class _CopyEvent:
    """A copy's CUDA event as the staging pool sees it: ``query()`` is a
    decision point and reads whether the model's copy stream has
    completed the copy."""

    def __init__(self, sched, name):
        self._sched = sched
        self.name = name
        self.done = False

    def query(self):
        self._sched.op_point(label=f"query {self.name}")
        return self.done


def _load_staging_pool(repo, sched):
    """``StagingPool`` + ``release_prepared`` AST-extracted from the
    port's ``search/engine.py`` (the module imports torch at scope, so
    the two defs are compiled alone) with ``threading`` behind the
    scheduler's shim, ``torch`` behind :class:`_TorchShim` and
    ``resolve_device`` giving the CPU (unpinned buffers)."""
    path = os.path.join(repo, PKG, "search", "engine.py")
    with open(path) as fobj:
        tree = ast.parse(fobj.read(), filename=path)
    wanted = {"StagingPool", "release_prepared"}
    picked = [node for node in tree.body
              if isinstance(node, (ast.ClassDef, ast.FunctionDef))
              and node.name in wanted]
    if {n.name for n in picked} != wanted:
        raise RuntimeError(
            f"search/engine.py no longer defines {sorted(wanted)} at "
            "module scope — update the staging model extraction")
    glb = {"__name__": "_ripsched_torch_staging",
           "threading": _ThreadingShim(sched), "torch": _TorchShim,
           "resolve_device": lambda device=None: types.SimpleNamespace(
               type="cpu")}
    exec(compile(ast.Module(body=picked, type_ignores=[]), path, "exec"),
         glb)
    return glb["StagingPool"], glb["release_prepared"]


# -- models ------------------------------------------------------------------

class ModelSpec:
    """One checkable model: its real-code targets, the invariants its
    runs assert, the named mutations that re-arm known-bad shapes, and
    the builder returning ``(tasks, final_check)``."""

    def __init__(self, name, description, targets, invariants,
                 mutations, build):
        self.name = name
        self.description = description
        self.targets = tuple(targets)
        self.invariants = tuple(invariants)   # (id, description) pairs
        self.mutations = dict(mutations)      # name -> description
        self.build = build


def _fair_key(queue, entry):
    return (entry.priority,
            queue._tenant_device_s.get(entry.tenant, 0.0),
            entry.device_s, entry.seq)


def _build_fairshare(repo, sched, mutation):
    qmod = load_target(repo, "serve.queue")
    tmod = load_target(repo, "serve.tenants")
    instrument(qmod, sched)
    instrument(tmod, sched)
    tenants = tmod.TenantTable(budget_device_s=0.0, max_active=8)
    queue = qmod.FairShareQueue(tenants)

    if mutation == "drop_notify":
        queue._cond.notify_all = lambda *a, **k: None
    elif mutation == "drop_charge":
        tenants.charge = lambda *a, **k: None
    elif mutation == "unfair_pick":
        def _fifo_pick():
            waiting = [e for e in queue._entries.values() if e.waiting]
            if not waiting:
                return None
            return min(waiting, key=lambda e: e.seq)
        queue._pick = _fifo_pick

    # Pick-minimality recorder: every grant decision the queue makes
    # must be the minimum of the documented fair-share key over the
    # waiting set — wraps whatever _pick is installed (including a
    # mutated one), so an unfair pick is caught at its first use.
    inner_pick = queue._pick

    def _checked_pick():
        entry = inner_pick()
        if entry is not None:
            waiting = [e for e in queue._entries.values() if e.waiting]
            best = min(waiting, key=lambda e: _fair_key(queue, e))
            if _fair_key(queue, entry) != _fair_key(queue, best):
                _violate(
                    "fair-share-pick",
                    f"_pick chose {entry.job_id!r} over {best.job_id!r} "
                    "— starves the tenant with the least charged device "
                    "time (fair key (priority, tenant_device_s, "
                    "device_s, seq))")
        return entry

    queue._pick = _checked_pick

    jobs = (("A1", "tenantA"), ("A2", "tenantA"), ("B1", "tenantB"))
    gates = {jid: queue.register(jid, tenant) for jid, tenant in jobs}
    state = {"turn": None, "completed": set(), "drained": set()}

    def _job(jid):
        def run():
            gate = gates[jid]
            try:
                for cid in range(2):
                    # The model DRIVES the raw protocol so the explorer
                    # can catch a missed end — the pairing rule is for
                    # production code.
                    gate.begin(cid)  # riplint: disable=RIP014
                    if state["turn"] is not None:
                        _violate(
                            "gate-mutual-exclusion",
                            f"{jid} granted chunk {cid} while "
                            f"{state['turn']} still holds the device "
                            "turn")
                    state["turn"] = jid
                    sched.op_point(label=f"device work chunk {cid}")
                    state["turn"] = None
                    gate.end(cid)
                state["completed"].add(jid)
            except qmod.JobDrained:
                if not queue._draining:
                    _violate("drain-termination",
                             f"{jid} drained while the queue was not "
                             "draining")
                state["drained"].add(jid)
            finally:
                queue.unregister(jid)
        return run

    def _drain():
        sched.op_point(label="issue drain")
        queue.drain()

    tasks = [(jid, _job(jid)) for jid, _ in jobs] + [("drain", _drain)]

    def final_check():
        out = []
        missing = {jid for jid, _ in jobs} \
            - state["completed"] - state["drained"]
        if missing:
            out.append((
                "drain-termination",
                f"job(s) {sorted(missing)} quiesced neither completed "
                "nor parked by drain — a non-terminal record survived"))
        charged = sum(queue._tenant_device_s.values())
        recorded = sum(tenants._spent.values())
        if abs(charged - recorded) > 1e-9:
            out.append((
                "charge-conservation",
                f"queue charged {charged:g} device-units but the "
                f"TenantTable recorded {recorded:g} — quota enforcement "
                "drifts from the fair-share accounting"))
        return out

    return tasks, final_check


def _build_staging(repo, sched, mutation):
    pool_cls, release_prepared = _load_staging_pool(repo, sched)
    pool = pool_cls(max_per_key=4)
    held = {}         # id(buf) -> (worker, chunk) currently in use
    journaled = set()

    def _free_ids():
        return [id(b) for stack in pool._free.values() for b, _ in stack]

    def _release_checked(worker, cid, buf):
        if (worker, cid) not in journaled:
            _violate(
                "staging-release-after-journal",
                f"{worker} released chunk {cid}'s staging buffer before "
                "its journal record was appended (retry re-ship would "
                "read a recycled buffer)")
        held.pop(id(buf), None)
        release_prepared(pool, (buf, {"staging": (buf,)}))
        ids = _free_ids()
        if len(ids) != len(set(ids)):
            _violate(
                "staging-no-double-release",
                f"{worker} chunk {cid}: the pool free list holds the "
                "same buffer twice — the next two acquires alias one "
                "array")

    def _worker(worker, cids):
        def run():
            for cid in cids:
                # Raw acquire on purpose: the release-after-journal
                # discipline under test IS the pairing.
                buf = pool.acquire((4, 8), "float32")  # riplint: disable=RIP014
                if id(buf) in held:
                    _violate(
                        "staging-no-double-release",
                        f"acquire handed {worker} chunk {cid} a buffer "
                        f"still held by {held[id(buf)]}")
                held[id(buf)] = (worker, cid)
                sched.op_point(label=f"prep+dispatch chunk {cid}")
                if mutation == "early_release":
                    _release_checked(worker, cid, buf)
                    sched.op_point(label=f"journal chunk {cid}")
                    journaled.add((worker, cid))
                else:
                    sched.op_point(label=f"journal chunk {cid}")
                    journaled.add((worker, cid))
                    _release_checked(worker, cid, buf)
                    if mutation == "double_release":
                        _release_checked(worker, cid, buf)
        return run

    tasks = [("w1", _worker("w1", (0, 1))), ("w2", _worker("w2", (2, 3)))]

    def final_check():
        out = []
        if len(journaled) != 4 or held:
            out.append((
                "staging-release-after-journal",
                f"quiesced with {len(journaled)}/4 chunks journaled and "
                f"{len(held)} buffer(s) still held"))
        return out

    return tasks, final_check


def _build_runctx(repo, sched, mutation):
    rmod = load_target(repo, "utils.runctx")
    instrument(rmod, sched)
    sinks = {"jobA": [], "jobB": []}
    global_records = []
    inbox = []
    progress = {"jobs_done": 0}
    inbox_lock = SchedLock(sched, name="inbox")

    def mini_emit(kind, job):
        # Mirrors survey/incidents.py::emit's resolution order
        # (context first, process-global sink second) — update with it.
        rec = {"incident": kind, "job": job}
        sink = global_records.append
        ctx = rmod.current()
        if ctx is not None:
            ctx.note_incident(rec)
            if ctx.incident_sink is not None:
                sink = ctx.incident_sink
        sink(rec)

    def _job(job):
        def run():
            ctx = rmod.RunContext(incident_sink=sinks[job].append,
                                  label=job)
            with rmod.activate(ctx):
                mini_emit("chunk_parked", job)
                def emit_remote(j=job):
                    mini_emit("watchdog_timeout", j)
                handed = (emit_remote if mutation == "unwrapped_worker"
                          else rmod.wrap(emit_remote))
                with inbox_lock:
                    inbox.append(handed)
                sched.op_point(label="mid-chunk work")
                mini_emit("device_error", job)
            if rmod.current() is not None:
                _violate("runctx-restore",
                         f"{job}: a context is still installed after "
                         "activate() exited")
            progress["jobs_done"] += 1
        return run

    def _pool_worker():
        while True:
            sched.op_point(
                pred=lambda: bool(inbox) or progress["jobs_done"] >= 2,
                label="poll inbox")
            with inbox_lock:
                item = inbox.pop(0) if inbox else None
            if item is None:
                if progress["jobs_done"] >= 2:
                    return
                continue
            item()
            if rmod.current() is not None:
                _violate("runctx-restore",
                         "pool worker: a handed-off callable leaked its "
                         "context past the call")

    tasks = [("jobA", _job("jobA")), ("jobB", _job("jobB")),
             ("worker", _pool_worker)]

    def final_check():
        out = []
        for rec in global_records:
            out.append((
                "incident-own-journal",
                f"incident {rec['incident']!r} of {rec['job']} landed "
                "in the process-global sink instead of its job's "
                "journal"))
        for job, recs in sorted(sinks.items()):
            stray = [r for r in recs if r["job"] != job]
            if stray:
                out.append((
                    "incident-own-journal",
                    f"{job}'s journal received "
                    f"{[r['incident'] for r in stray]} emitted by "
                    f"{stray[0]['job']}"))
            kinds = [r["incident"] for r in recs if r["job"] == job]
            want = ["chunk_parked", "watchdog_timeout", "device_error"]
            if sorted(kinds) != sorted(want):
                out.append((
                    "incident-own-journal",
                    f"{job}'s journal holds {sorted(kinds)}; expected "
                    f"{sorted(want)}"))
        return out

    return tasks, final_check


def _build_quarantine(repo, sched, mutation):
    incidents = []
    parked = []
    completed = []

    class _Latch:
        """Mirror of survey/integrity.py::IntegrityManager's quarantine
        latch (the idempotence guard + single incident emission) — the
        real manager drags the journal and torch; update with it."""

        def __init__(self, job):
            self.job = job
            self.quarantined = False

        def quarantine(self, chunk_id):
            if mutation == "drop_guard" or not self.quarantined:
                self.quarantined = True
                incidents.append(
                    ("integrity_quarantine", self.job, chunk_id))

    latches = {"jobA": _Latch("jobA"), "jobB": _Latch("jobB")}
    if mutation == "shared_latch":
        latches["jobB"] = latches["jobA"]
    bad = {("jobA", 1)}
    if mutation == "drop_guard":
        bad.add(("jobA", 2))

    def _job(job):
        def run():
            latch = latches[job]
            for cid in range(3):
                sched.op_point(label=f"chunk {cid} gate")
                # Mirrors the scheduler's park-on-latch check
                # (survey/scheduler.py, quarantine park branch).
                if mutation != "drop_guard" and latch.quarantined:
                    parked.append((job, cid))
                    continue
                sched.op_point(label=f"chunk {cid} dispatch")
                if (job, cid) in bad:
                    latch.quarantine(cid)
                    parked.append((job, cid))
                    continue
                completed.append((job, cid))
        return run

    tasks = [("jobA", _job("jobA")), ("jobB", _job("jobB"))]

    def final_check():
        out = []
        per_job = {}
        for kind, job, cid in incidents:
            per_job[job] = per_job.get(job, 0) + 1
        for job, n in sorted(per_job.items()):
            if n > 1:
                out.append((
                    "quarantine-single-incident",
                    f"{job} emitted {n} integrity_quarantine incidents "
                    "for one latch — the idempotence guard is gone"))
        expected = {("jobA", 1), ("jobA", 2)}
        extra = set(parked) - expected
        missing = expected - set(parked)
        if extra:
            out.append((
                "quarantine-implicated-set",
                f"quarantine parked {sorted(extra)} beyond the "
                "implicated job's post-latch chunks — a healthy "
                "sibling lost its device"))
        if missing:
            out.append((
                "quarantine-implicated-set",
                f"chunk(s) {sorted(missing)} dispatched after the "
                "device was latched suspect instead of parking"))
        return out

    return tasks, final_check



def _build_devicelost(repo, sched, mutation):
    qmod = load_target(repo, "serve.queue")
    tmod = load_target(repo, "serve.tenants")
    instrument(qmod, sched)
    instrument(tmod, sched)
    tenants = tmod.TenantTable(budget_device_s=0.0, max_active=8)
    queue = qmod.FairShareQueue(tenants)

    if mutation == "lost_no_notify":
        def _lose_quietly(job_id):
            with queue._cond:
                queue._device_lost = True
        queue.lose_device = _lose_quietly

    jobs = (("A1", "tenantA"), ("B1", "tenantB"), ("B2", "tenantB"))
    gates = {jid: queue.register(jid, tenant) for jid, tenant in jobs}
    others = {"B1", "B2"}
    state = {"turn": None, "lost": False, "completed": set(),
             "drained": set(), "failed": set()}

    def _job(jid):
        def run():
            gate = gates[jid]
            try:
                for cid in range(2):
                    # The raw protocol again, as in the fairshare model.
                    gate.begin(cid)  # riplint: disable=RIP014
                    if state["lost"]:
                        _violate(
                            "device-lost-parks",
                            f"{jid} granted chunk {cid} after the CUDA "
                            "context was lost")
                    if state["turn"] is not None:
                        _violate(
                            "gate-mutual-exclusion",
                            f"{jid} granted chunk {cid} while "
                            f"{state['turn']} still holds the device "
                            "turn")
                    state["turn"] = jid
                    sched.op_point(label=f"device work chunk {cid}")
                    if jid == "A1":
                        # A sticky CUDA error: the scheduler flags the
                        # queue through the gate BEFORE its turn ends
                        # (survey/scheduler.py, StickyDeviceError), and
                        # the queue must wake the waiting gates at once,
                        # not at the turn's end.
                        state["lost"] = True
                        gate.device_lost(cid)
                        sched.op_point(
                            pred=lambda: others <= (state["completed"]
                                                    | state["drained"]),
                            label="sticky error: siblings park")
                        state["turn"] = None
                        gate.end(cid)
                        state["failed"].add(jid)
                        return
                    state["turn"] = None
                    gate.end(cid)
                state["completed"].add(jid)
            except qmod.JobDrained:
                if not state["lost"]:
                    _violate("device-lost-parks",
                             f"{jid} drained while the device was not "
                             "lost")
                state["drained"].add(jid)
            finally:
                queue.unregister(jid)
        return run

    tasks = [(jid, _job(jid)) for jid, _ in jobs]

    def final_check():
        out = []
        ends = state["completed"] | state["drained"] | state["failed"]
        missing = {jid for jid, _ in jobs} - ends
        if missing:
            out.append((
                "device-lost-parks",
                f"job(s) {sorted(missing)} neither completed, failed nor "
                "parked after the loss"))
        return out

    return tasks, final_check


def _build_staging_events(repo, sched, mutation):
    pool_cls, release_prepared = _load_staging_pool(repo, sched)
    pool = pool_cls(max_per_key=4)

    if mutation == "ignore_event":
        def _acquire_ignoring_event(shape, dtype):
            key = pool._key(shape, dtype)
            with pool._lock:
                stack = pool._free.get(key, [])
                if stack:
                    return stack.pop()[0]
            return _TorchShim.empty(key[0], dtype=dtype)
        pool.acquire = _acquire_ignoring_event

    held = {}
    inflight = []     # copy events the copy stream has not completed
    last_copy = {}    # id(buf) -> the event of its last copy
    progress = {"workers_done": 0, "n": 0}

    def _worker(worker, cids):
        def run():
            for cid in cids:
                buf = pool.acquire((4, 8), "float32")
                ev = last_copy.get(id(buf))
                if ev is not None and not ev.done:
                    _violate(
                        "staging-copy-complete",
                        f"acquire handed {worker} chunk {cid} a buffer "
                        f"whose copy to the card ({ev.name}) has not "
                        "completed — the prep would overwrite bytes "
                        "still being copied")
                if id(buf) in held:
                    _violate(
                        "staging-no-double-release",
                        f"acquire handed {worker} chunk {cid} a buffer "
                        f"still held by {held[id(buf)]}")
                held[id(buf)] = (worker, cid)
                sched.op_point(label=f"prep chunk {cid}")
                progress["n"] += 1
                ev = _CopyEvent(sched, f"copy#{progress['n']}")
                last_copy[id(buf)] = ev
                inflight.append(ev)
                sched.op_point(label=f"queue+collect chunk {cid}")
                held.pop(id(buf), None)
                release_prepared(pool, (buf, {"staging": (buf,),
                                              "copy_event": ev}))
            progress["workers_done"] += 1
        return run

    def _copy_stream():
        while True:
            sched.op_point(
                pred=lambda: bool(inflight) or progress["workers_done"] >= 2,
                label="copy stream")
            if inflight:
                inflight.pop(0).done = True
            elif progress["workers_done"] >= 2:
                return

    tasks = [("w1", _worker("w1", (0, 1))), ("w2", _worker("w2", (2,))),
             ("copy", _copy_stream)]

    def final_check():
        if held:
            return [("staging-copy-complete",
                     f"quiesced with {len(held)} buffer(s) still held")]
        return []

    return tasks, final_check


_INV = {
    "no-lost-wakeup": ("RIPS01", "no schedule deadlocks: every dropped "
                                 "notify or stuck waiter is reported"),
    "termination": ("RIPS01", "every schedule quiesces within the "
                              "decision budget"),
    "gate-mutual-exclusion": ("RIPS02", "at most one job holds the "
                                        "device turn"),
    "drain-termination": ("RIPS02", "drain quiesces every job as "
                                    "completed or parked-resumable"),
    "staging-no-double-release": ("RIPS03", "no staging buffer is freed "
                                            "twice or handed out while "
                                            "held"),
    "staging-release-after-journal": ("RIPS03", "staging buffers "
                                                "recycle only after the "
                                                "chunk's journal "
                                                "record"),
    "incident-own-journal": ("RIPS04", "every incident lands in its own "
                                       "job's journal under "
                                       "concurrency"),
    "runctx-restore": ("RIPS04", "run contexts restore on every "
                                 "install/activate/wrap path"),
    "fair-share-pick": ("RIPS05", "every turn grant is minimal in the "
                                  "fair-share key (no tenant "
                                  "starvation)"),
    "charge-conservation": ("RIPS05", "turn seconds charged to the "
                                      "queue and the tenant table "
                                      "agree"),
    "quarantine-single-incident": ("RIPS06", "one quarantine latch "
                                             "emits one incident"),
    "quarantine-implicated-set": ("RIPS06", "quarantine parks exactly "
                                            "the implicated job's "
                                            "post-latch chunks"),
    "device-lost-parks": ("RIPS02", "a lost CUDA context parks every "
                                    "sibling job at its gate, the "
                                    "waiting ones at once, and grants no "
                                    "later turn"),
    "staging-copy-complete": ("RIPS03", "no staging buffer is handed "
                                        "out before its last copy to the "
                                        "card completed"),
}

# SARIF rule metadata (one rule per invariant family), reused by
# ``apps/ripsched.py --format sarif`` (analysis/sarif.py).
SARIF_RULES = (
    ("RIPS01", "sched-liveness",
     "no lost wakeups or divergence in any explored schedule"),
    ("RIPS02", "sched-drain",
     "fair-share turns are mutually exclusive and drain terminates "
     "with zero non-terminal records"),
    ("RIPS03", "sched-staging",
     "staging buffers: no double release, release only after the "
     "chunk's journal record"),
    ("RIPS04", "sched-runctx",
     "incidents route to their own job's journal; contexts restore on "
     "every path"),
    ("RIPS05", "sched-fairshare",
     "turn grants are fair-share minimal and charges are conserved"),
    ("RIPS06", "sched-quarantine",
     "the integrity quarantine latch parks exactly the implicated "
     "set, once"),
)


def _invariants(ids):
    return tuple((i, _INV[i][1]) for i in ids)


MODELS = {
    "fairshare": ModelSpec(
        "fairshare",
        "REAL FairShareQueue + TenantTable: three jobs across two "
        "tenants take chunk turns while a drain lands",
        ("riptide_tpu_torch/serve/queue.py",
         "riptide_tpu_torch/serve/tenants.py"),
        _invariants(("no-lost-wakeup", "termination",
                     "gate-mutual-exclusion", "drain-termination",
                     "fair-share-pick", "charge-conservation")),
        {"drop_notify": "end() forgets notify_all — waiters park "
                        "forever (lost wakeup)",
         "unfair_pick": "_pick degrades to FIFO-by-submission — "
                        "starves the lighter tenant",
         "drop_charge": "end() skips TenantTable.charge — quota "
                        "enforcement diverges from reality"},
        _build_fairshare,
    ),
    "staging": ModelSpec(
        "staging",
        "REAL StagingPool (AST-extracted from search/engine.py): two "
        "prep workers recycle wire buffers under the "
        "release-after-journal discipline",
        ("riptide_tpu_torch/search/engine.py",),
        _invariants(("no-lost-wakeup", "termination",
                     "staging-no-double-release",
                     "staging-release-after-journal")),
        {"double_release": "a chunk's buffers are released twice — two "
                           "later acquires alias one array",
         "early_release": "buffers released before the chunk's journal "
                          "record — a retry re-ship reads recycled "
                          "memory"},
        _build_staging,
    ),
    "runctx": ModelSpec(
        "runctx",
        "REAL utils/runctx.py: two jobs activate contexts and hand "
        "emitting work to a shared pool worker via wrap()",
        ("riptide_tpu_torch/utils/runctx.py",),
        _invariants(("no-lost-wakeup", "termination",
                     "incident-own-journal", "runctx-restore")),
        {"unwrapped_worker": "work handed to the pool without "
                             "runctx.wrap — its incidents land in the "
                             "process-global sink"},
        _build_runctx,
    ),
    "quarantine": ModelSpec(
        "quarantine",
        "mirrored IntegrityManager quarantine latch + scheduler park "
        "loop: one job's device goes suspect mid-run beside a healthy "
        "sibling",
        ("riptide_tpu_torch/survey/integrity.py",
         "riptide_tpu_torch/survey/scheduler.py"),
        _invariants(("no-lost-wakeup", "termination",
                     "quarantine-single-incident",
                     "quarantine-implicated-set")),
        {"shared_latch": "both jobs share one latch object — a "
                         "sibling's chunks park for a device it never "
                         "touched",
         "drop_guard": "park check and idempotence guard dropped — "
                       "post-latch chunks dispatch and re-emit"},
        _build_quarantine,
    ),
    "devicelost": ModelSpec(
        "devicelost",
        "REAL FairShareQueue.lose_device: one job's chunk hits a sticky "
        "CUDA error while two sibling jobs wait for or take turns",
        ("riptide_tpu_torch/serve/queue.py",
         "riptide_tpu_torch/survey/scheduler.py"),
        _invariants(("no-lost-wakeup", "termination",
                     "gate-mutual-exclusion", "device-lost-parks")),
        {"lost_no_notify": "lose_device() sets the flag but forgets "
                           "notify_all — a waiting gate sleeps until the "
                           "lost turn ends"},
        _build_devicelost,
    ),
    "staging_events": ModelSpec(
        "staging_events",
        "REAL StagingPool event-gated reuse: two prep workers recycle "
        "wire buffers while a copy stream completes their copies",
        ("riptide_tpu_torch/search/engine.py",),
        _invariants(("no-lost-wakeup", "termination",
                     "staging-no-double-release",
                     "staging-copy-complete")),
        {"ignore_event": "acquire() hands out a released buffer without "
                         "querying its copy event — the prep overwrites "
                         "bytes still being copied"},
        _build_staging_events,
    ),
}


# -- schedule IDs ------------------------------------------------------------

def format_schedule_id(model, mutation, digits):
    tag = f"{model}+{mutation}" if mutation else model
    return f"{tag}:{digits}"


def parse_schedule_id(schedule_id):
    """``(model, mutation_or_None, digit_tuple)`` from a schedule ID;
    raises ValueError with a usable message on malformed input."""
    if ":" not in schedule_id:
        raise ValueError(
            f"malformed schedule id {schedule_id!r}: expected "
            "model[+mutation]:digits")
    tag, _, digits = schedule_id.partition(":")
    model, _, mutation = tag.partition("+")
    mutation = mutation or None
    if model not in MODELS:
        raise ValueError(
            f"unknown model {model!r} (known: {sorted(MODELS)})")
    if mutation is not None and mutation not in MODELS[model].mutations:
        raise ValueError(
            f"unknown mutation {mutation!r} for model {model!r} "
            f"(known: {sorted(MODELS[model].mutations)})")
    if digits and not digits.isdigit():
        raise ValueError(
            f"malformed schedule digits {digits!r}: decimal task "
            "indices only")
    return model, mutation, tuple(int(d) for d in digits)


# -- exploration -------------------------------------------------------------

class Violation:
    """One invariant violation with its minimal failing schedule."""

    def __init__(self, model, mutation, invariant, message,
                 schedule_id, trace_lines, preemptions):
        self.model = model
        self.mutation = mutation
        self.invariant = invariant
        self.message = message
        self.schedule_id = schedule_id
        self.trace_lines = list(trace_lines)
        self.preemptions = preemptions

    def render(self):
        lines = [
            f"ripsched VIOLATION [{self.invariant}] in model "
            f"{self.model!r}"
            + (f" (mutation {self.mutation!r})" if self.mutation
               else ""),
            f"  {self.message}",
            f"  minimal failing schedule ({self.preemptions} "
            f"preemption(s)):",
        ]
        lines.extend(self.trace_lines)
        lines.append(f"  replay: python -m riptide_tpu_torch.apps.ripsched "
                     "--replay "
                     f"'{self.schedule_id}'")
        return "\n".join(lines)


class ExploreResult:
    def __init__(self, model, mutation, bound, schedules, decisions,
                 capped, violation):
        self.model = model
        self.mutation = mutation
        self.bound = bound
        self.schedules = schedules
        self.decisions = decisions
        self.capped = capped
        self.violation = violation


_ENVFLAGS_MOD = [None]


def _envflags(repo=REPO):
    if _ENVFLAGS_MOD[0] is None:
        path = os.path.join(repo, PKG, "utils", "envflags.py")
        spec = importlib.util.spec_from_file_location(
            "riptide_tpu_torch_envflags_for_sched", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ENVFLAGS_MOD[0] = mod
    return _ENVFLAGS_MOD[0]


def env_default(name, repo=REPO):
    """Registered default/override for a RIPTIDE_SCHED_* flag, via the
    typed envflags registry (the port's, loaded standalone)."""
    return _envflags(repo).get(name)


def _run_schedule(repo, model, mutation, prefix,
                  max_steps=DEFAULT_MAX_STEPS):
    spec = MODELS[model]
    sched = Scheduler(schedule=prefix, max_steps=max_steps)
    tasks, final_check = spec.build(repo, sched, mutation)
    for name, fn in tasks:
        sched.spawn(name, fn)
    sched.run()
    if sched.violation is None and sched.diverged is None:
        for invariant, message in final_check():
            sched.violation = (invariant, message)
            break
    return sched


def _make_violation(model, mutation, sched, preemptions):
    invariant, message = sched.violation
    return Violation(
        model, mutation, invariant, message,
        format_schedule_id(model, mutation, sched.digits()),
        sched.trace_lines(), preemptions)


def _trace_preemptions(trace):
    """Per-step cumulative preemption counts: step ``i`` preempts when
    it switches away from a task that was still enabled."""
    cum = [0] * (len(trace) + 1)
    for i, (chosen, enabled, _) in enumerate(trace):
        pre = (i > 0 and chosen != trace[i - 1][0]
               and trace[i - 1][0] in enabled)
        cum[i + 1] = cum[i] + (1 if pre else 0)
    return cum


def explore_model(model, mutation=None, bound=None, seed=None,
                  max_schedules=None, repo=REPO, log=None):
    """Iterative preemption-bounded DFS over ``model``'s schedules:
    every schedule with exactly ``b`` preemptions is run once for
    ``b = 0..bound`` (expansion prefixes are filed by their exact
    preemption count, so no schedule repeats across bounds), and the
    first violation — minimal in preemptions by construction — stops
    the search with its replayable schedule ID."""
    if model not in MODELS:
        raise ValueError(
            f"unknown model {model!r} (known: {sorted(MODELS)})")
    if mutation is not None and mutation not in MODELS[model].mutations:
        raise ValueError(
            f"unknown mutation {mutation!r} for model {model!r} "
            f"(known: {sorted(MODELS[model].mutations)})")
    if bound is None:
        bound = int(env_default("RIPTIDE_SCHED_BOUND", repo))
    if seed is None:
        seed = int(env_default("RIPTIDE_SCHED_SEED", repo))
    if max_schedules is None:
        max_schedules = DEFAULT_MAX_SCHEDULES
    rng = random.Random(seed)
    pending = {b: [] for b in range(bound + 1)}
    pending[0].append(())
    schedules = decisions = 0
    capped = False
    for b in range(bound + 1):
        stack = pending[b]
        while stack:
            if max_schedules and schedules >= max_schedules:
                capped = True
                if log is not None:
                    log(f"ripsched: {model}"
                        + (f"+{mutation}" if mutation else "")
                        + f": schedule cap {max_schedules} reached at "
                        f"bound {b} — coverage is BOUNDED, not "
                        "exhaustive (raise --max-schedules)")
                break
            prefix = stack.pop()
            sched = _run_schedule(repo, model, mutation, prefix)
            schedules += 1
            decisions += len(sched.trace)
            if sched.diverged is not None:
                # A prefix replays deterministically, so divergence
                # means the model itself went nondeterministic — a
                # harness bug worth failing loudly on.
                raise RuntimeError(
                    f"model {model!r} diverged at step {sched.diverged} "
                    f"replaying its own prefix {prefix!r}")
            if sched.violation is not None:
                return ExploreResult(
                    model, mutation, bound, schedules, decisions,
                    capped,
                    _make_violation(
                        model, mutation, sched,
                        _trace_preemptions(sched.trace)[-1]))
            choices = [c for c, _, _ in sched.trace]
            cum = _trace_preemptions(sched.trace)
            for i in range(len(prefix), len(sched.trace)):
                _, enabled, _ = sched.trace[i]
                alts = [a for a in enabled if a != choices[i]]
                rng.shuffle(alts)
                for alt in alts:
                    extra = (i > 0 and alt != choices[i - 1]
                             and choices[i - 1] in enabled)
                    total = cum[i] + (1 if extra else 0)
                    if total <= bound:
                        pending[total].append(
                            tuple(choices[:i]) + (alt,))
        if capped:
            break
    return ExploreResult(model, mutation, bound, schedules, decisions,
                         capped, None)


class ReplayResult:
    def __init__(self, schedule_id, model, mutation, trace_lines,
                 violation, diverged):
        self.schedule_id = schedule_id
        self.model = model
        self.mutation = mutation
        self.trace_lines = list(trace_lines)
        self.violation = violation
        self.diverged = diverged

    def render(self):
        head = [f"ripsched replay {self.schedule_id}"]
        head.extend(self.trace_lines)
        if self.diverged is not None:
            head.append(f"  DIVERGED at step {self.diverged}: the "
                        "recorded digit is not enabled (model changed "
                        "since recording?)")
        elif self.violation is not None:
            head.append(self.violation.render())
        else:
            head.append("  clean: no invariant violated on this "
                        "schedule")
        return "\n".join(head)


def replay(schedule_id, repo=REPO, max_steps=DEFAULT_MAX_STEPS):
    """Re-execute one recorded schedule exactly. Deterministic: the
    same ID renders a byte-identical trace, so a violation's repro is
    stable across machines and runs."""
    model, mutation, digits = parse_schedule_id(schedule_id)
    sched = _run_schedule(repo, model, mutation, digits,
                          max_steps=max_steps)
    violation = None
    if sched.violation is not None:
        violation = _make_violation(
            model, mutation, sched, _trace_preemptions(sched.trace)[-1])
    return ReplayResult(schedule_id, model, mutation,
                        sched.trace_lines(), violation, sched.diverged)


def sarif_rule_of(invariant):
    """The RIPS rule id an invariant reports under (SARIF output)."""
    return _INV[invariant][0]


def spec_doc():
    """The machine-readable invariant spec pinned in
    ``riptide_tpu_torch/analysis/ripsched_invariants.json``: model
    targets, invariants and mutations. The CLI refuses to run when the
    pinned file drifts from this registry (``--write-specs`` re-pins),
    so the checked-in spec always names what ripsched proves."""
    return {
        "version": 1,
        "models": {
            name: {
                "description": spec.description,
                "targets": list(spec.targets),
                "invariants": [
                    {"id": i, "rule": _INV[i][0], "description": d}
                    for i, d in spec.invariants
                ],
                "mutations": dict(sorted(spec.mutations.items())),
            }
            for name, spec in sorted(MODELS.items())
        },
    }
