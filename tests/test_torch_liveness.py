"""
The port's liveness layer (``riptide_tpu_torch.survey.liveness``) and
the scheduler's retry, breaker and watchdog machinery, against the JAX
package's on the CPU; and the classification of CUDA's errors, which
differs from the JAX package's by design (its markers are XLA's).
"""
import threading
import time

import pytest
import torch

from riptide_tpu.survey import liveness as ref_liveness
from riptide_tpu.survey import scheduler as ref_sched
from riptide_tpu_torch.search.engine import is_oom_error
from riptide_tpu_torch.survey import liveness, scheduler
from riptide_tpu_torch.survey.faults import FaultPlan, InjectedDeviceError
from riptide_tpu_torch.survey.journal import SurveyJournal
from riptide_tpu_torch.survey.liveness import (ChunkTimeout, ChunkWatchdog,
                                               Deadline, DurationEWMA,
                                               PeerLivenessMonitor,
                                               bounded_wait, is_device_error,
                                               is_timeout_error)
from riptide_tpu_torch.survey.metrics import MetricsRegistry

from test_torch_survey import _both, _compare, _rows, _schedule, WIRE_ENV
from test_torch_survey import clean, trials  # noqa: F401 (fixtures)

_ACCEL = getattr(torch, "AcceleratorError", None)


def _accelerator_error(msg):
    """A ``torch.AcceleratorError`` where this torch has one (its
    constructor takes the message), else the RuntimeError older
    releases raise for a CUDA error."""
    if _ACCEL is not None:
        try:
            return _ACCEL(msg)
        except TypeError:
            pass
    return RuntimeError(msg)


@pytest.fixture(autouse=True)
def _wire(monkeypatch):
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)


# --------------------------------------------------------- classification

CUDA_ERRORS = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "CUDA error: misaligned address",
]


@pytest.mark.parametrize("msg", CUDA_ERRORS)
def test_cuda_runtime_errors_are_device_errors(msg):
    err = _accelerator_error(msg)
    assert is_device_error(err)
    assert not is_timeout_error(err)
    assert not is_oom_error(err)
    # The same text as a plain RuntimeError (older torch, or a kernel
    # wrapper's cudaGetLastError()) classifies the same way.
    assert is_device_error(RuntimeError(msg))
    # The JAX package's markers are XLA's: they never match CUDA's text,
    # which is why the port has its own.
    assert not ref_liveness.is_device_error(RuntimeError(msg))


def test_accelerator_error_type_alone_is_a_device_error():
    if _ACCEL is None:
        pytest.skip("this torch has no torch.AcceleratorError")
    assert is_device_error(_accelerator_error("the device went away"))


def test_out_of_memory_is_not_a_device_error():
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 80.00 GiB")
    assert is_oom_error(oom)
    assert not is_device_error(oom)
    assert not is_device_error(RuntimeError("CUDA error: out of memory"))
    assert is_oom_error(RuntimeError("CUDA error: out of memory"))


def test_timeouts_are_not_device_errors():
    t = ChunkTimeout(3, 1.5)
    assert is_timeout_error(t) and not is_device_error(t)
    assert is_timeout_error(RuntimeError("DEADLINE_EXCEEDED: stuck"))
    assert not is_timeout_error(RuntimeError("CUDA error: launch failure"))
    assert t.retryable


def test_injected_device_error_classifies_as_a_device_error():
    err = InjectedDeviceError(2)
    assert is_device_error(err) and not is_oom_error(err)
    assert not is_timeout_error(err)


def test_ordinary_errors_are_neither():
    for err in (ValueError("bad shape"), RuntimeError("boom")):
        assert not is_device_error(err) and not is_timeout_error(err)


# ------------------------------------------------- primitives vs reference

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_deadline_matches_reference():
    for mod in (liveness, ref_liveness):
        clock = FakeClock()
        d = mod.Deadline(2.0, chunk_id=4, clock=clock)
        assert not d.expired and d.remaining == 2.0
        clock.t += 1.5
        d.check()
        clock.t += 1.0
        assert d.expired
        with pytest.raises(mod.ChunkTimeout, match="chunk 4"):
            d.check()
        e = mod.Deadline(10.0)
        e.expire()
        assert e.expired


def test_ewma_and_watchdog_budgets_match_reference():
    for samples in ([1.0], [1.0, 3.0, 0.5], [100.0, 100.0]):
        ours, ref = DurationEWMA(0.3), ref_liveness.DurationEWMA(0.3)
        for s in samples:
            ours.observe(s)
            ref.observe(s)
        assert ours.value == ref.value and ours.count == ref.count
        wd = ChunkWatchdog(k=4.0, floor_s=2.0, cap_s=50.0, initial_s=3.0)
        rwd = ref_liveness.ChunkWatchdog(k=4.0, floor_s=2.0, cap_s=50.0,
                                         initial_s=3.0)
        assert wd.budget() == rwd.budget() == 3.0
        for s in samples:
            wd.observe(s)
            rwd.observe(s)
        assert wd.budget() == rwd.budget()
    with pytest.raises(ValueError):
        ChunkWatchdog(k=0)
    with pytest.raises(ValueError):
        ChunkWatchdog(floor_s=5.0, cap_s=1.0)


def test_watchdog_abandons_a_hung_attempt_and_escalates():
    wd = ChunkWatchdog(k=1.0, floor_s=0.05, cap_s=1.0, initial_s=0.05)
    release = threading.Event()
    seen = {}

    def hung(deadline):
        seen["deadline"] = deadline
        release.wait(5.0)
        return "late"

    t0 = time.monotonic()
    with pytest.raises(ChunkTimeout):
        wd.run(hung, chunk_id=7)
    assert time.monotonic() - t0 < 2.0
    assert seen["deadline"].expired
    assert wd.budget() == pytest.approx(0.1)     # 2x after one timeout
    release.set()
    assert wd.run(lambda d: "ok", chunk_id=8) == "ok"
    assert wd.ewma.count == 1


def test_watchdog_relays_errors_and_unbounded_runs_inline():
    wd = ChunkWatchdog(initial_s=1.0)

    def bad(deadline):
        raise KeyError("x")

    with pytest.raises(KeyError):
        wd.run(bad)
    inline = ChunkWatchdog()
    assert inline.run(lambda d: d) is None


def test_bounded_wait():
    assert bounded_wait(lambda: 3, None) == 3
    assert bounded_wait(lambda: 4, 1.0) == 4
    with pytest.raises(liveness.PeerTimeout):
        bounded_wait(lambda: time.sleep(1.0), 0.05, what="nap")


def test_multi_gpu_collectives_are_not_in_this_slice():
    assert not hasattr(liveness, "bounded_allgather")
    assert not hasattr(liveness, "barrier_with_timeout")


def test_monitor_single_process_heartbeat(tmp_path):
    journal = SurveyJournal(tmp_path)
    clock = FakeClock()
    metrics = MetricsRegistry()
    mon = PeerLivenessMonitor(journal, 0, 1, max_age_s=10.0, clock=clock,
                              metrics=metrics)
    mon.beat()
    assert journal.read_heartbeats() == {0: 100.0}
    clock.t += 4.0
    assert mon.peer_ages() == {0: 4.0}
    assert metrics.summary()["heartbeat_age_s"] == 0.0
    mon.start_beating(interval_s=60.0)
    mon.stop_beating()
    assert journal.read_heartbeats() == {0: 104.0}


# ------------------------------------------------------ retry and breaker

def _retry_runs(pkg, errors, **policy):
    """run_with_retry of ``pkg`` over a work unit failing with
    ``errors`` in turn: (result or the error's type name, the backoff
    sleeps, the counters)."""
    from riptide_tpu.survey.faults import FaultPlan as RefPlan
    from riptide_tpu.survey.metrics import MetricsRegistry as RefRegistry

    mod = scheduler if pkg == "port" else ref_sched
    metrics = MetricsRegistry() if pkg == "port" else RefRegistry()
    plan = FaultPlan() if pkg == "port" else RefPlan()
    slept = []
    rp = mod.RetryPolicy(sleep=slept.append, jitter=0.0, **policy)
    it = iter(errors)

    def work():
        err = next(it, None)
        if err is not None:
            raise err
        return "done"

    try:
        out = mod.run_with_retry(work, 0, rp, plan, metrics)
    except Exception as err:
        out = type(err).__name__
    return out, slept, {k: metrics.counter(k) for k in
                        ("chunks_retried", "chunks_timed_out",
                         "device_errors")}


@pytest.mark.parametrize("case", ["transient", "timeouts", "exhausted",
                                  "budget"])
def test_run_with_retry_matches_reference(case):
    errors, policy = {
        "transient": ([RuntimeError("x"), RuntimeError("y")], {}),
        "timeouts": ([ChunkTimeout(0, 1.0)], {}),
        "exhausted": ([RuntimeError("x")] * 5, {"max_retries": 2}),
        "budget": ([RuntimeError("x")] * 5,
                   {"base_s": 10.0, "deadline_s": 15.0}),
    }[case]
    ref_errors = [ref_liveness.ChunkTimeout(0, 1.0)
                  if isinstance(e, ChunkTimeout) else e for e in errors]
    ours = _retry_runs("port", errors, **policy)
    ref = _retry_runs("ref", ref_errors, **policy)
    assert ours == ref


def test_retry_never_retries_an_operator_interrupt():
    def work():
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        scheduler.run_with_retry(work, 0, scheduler.RetryPolicy(),
                                 FaultPlan(), MetricsRegistry())


def test_breaker_state_machine_matches_reference():
    for mod in (scheduler, ref_sched):
        clock = FakeClock()
        br = mod.CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                                clock=clock, metrics=MetricsRegistry()
                                if mod is scheduler else None)
        trace = [br.state]
        br.record_failure()
        trace.append(br.state)
        br.record_failure()
        trace += [br.state, br.allow()]
        clock.t += 6.0
        trace += [br.state, br.allow()]
        br.record_failure()
        trace.append(br.state)
        clock.t += 6.0
        br.allow()
        br.record_success()
        trace.append(br.state)
        if mod is scheduler:
            ours = trace
        else:
            assert ours == trace
    assert ours[-1] == "closed"


# --------------------------------------------- the watchdog on the survey

def _watchdog(pkg):
    mod = liveness if pkg == "port" else ref_liveness
    return mod.ChunkWatchdog(k=4.0, floor_s=0.3, cap_s=5.0, initial_s=0.8)


def test_hang_is_abandoned_retried_and_matches_reference(trials, tmp_path,
                                                         clean):
    out = {pkg: _schedule(pkg, trials, tmp_path / pkg, "hang:1:3",
                          watchdog=_watchdog(pkg))
           for pkg in ("port", "ref")}
    _compare(out["port"], out["ref"])
    counts = out["port"][1]
    assert counts["chunks_timed_out"] == 1 and counts["chunks_retried"] == 1
    assert out["port"][2] == ["watchdog_timeout"]
    assert _rows(out["port"][0]) == _rows(clean["port"])


def test_straggler_within_its_deadline_is_not_killed(trials, tmp_path,
                                                     clean):
    port, ref = _both(trials, tmp_path, "straggle:1:0.1",
                      watchdog=None)
    _compare(port, ref)
    wd = _watchdog("port")
    again = _schedule("port", trials, tmp_path / "wd", "straggle:1:0.1",
                      watchdog=wd)
    assert again[1]["chunks_timed_out"] == 0
    assert _rows(again[0]) == _rows(clean["port"])


def test_abandoned_attempt_buffers_return_after_it_ends(trials, tmp_path,
                                                        monkeypatch):
    """A hung attempt's staging buffers stay out of the pool while its
    thread runs; the retry prepares the chunk into fresh buffers; the
    abandoned buffers come back once that thread has ended (not at
    abandonment), so every buffer is released exactly once."""
    from riptide_tpu_torch.pipeline.batcher import BatchSearcher

    released, prepared = [], []
    rel = BatchSearcher.release_chunk
    prep = BatchSearcher._prepare_chunk

    def track_release(self, items):
        released.append([id(it[-1][0]) for it in items])
        return rel(self, items)

    def track_prepare(self, tslist):
        items = prep(self, tslist)
        prepared.append([id(it[-1][0]) for it in items])
        return items

    monkeypatch.setattr(BatchSearcher, "release_chunk", track_release)
    monkeypatch.setattr(BatchSearcher, "_prepare_chunk", track_prepare)
    hang_s = 1.5
    t0 = time.monotonic()
    out = _schedule("port", trials[:2], tmp_path, f"hang:0:{hang_s}",
                    watchdog=ChunkWatchdog(k=4.0, floor_s=0.2, cap_s=5.0,
                                           initial_s=0.3))
    assert out[1]["chunks_timed_out"] == 1
    # chunk 0 was prepared twice (the retry's fresh buffers), chunk 1 once
    assert len(prepared) == 3
    abandoned = prepared[0]
    # Released so far: the retry's and chunk 1's, not yet the abandoned
    # attempt's (its thread still sleeps if we got here early).
    if time.monotonic() - t0 < hang_s:
        assert abandoned not in released
    time.sleep(max(0.0, hang_s + 0.5 - (time.monotonic() - t0)))
    # (An earlier test's abandoned thread may end during this one and
    # release its own buffers through the patched method: count ours.)
    ours = [r for r in released if r in prepared]
    assert sorted(ours) == sorted(prepared)


def test_chunk_wire_releases_each_buffer_once_under_contention():
    """Many attempt threads hold and drop the chunk's items while the
    main thread replaces them: every retired set goes back to the pool
    exactly once, and never while an attempt still holds it."""
    import sys

    held = {}
    released = []
    lock = threading.Lock()

    class Pool:
        def release_chunk(self, items):
            with lock:
                assert not held.get(id(items)), "released while in use"
                released.append(id(items))

    sets = [[("set", k)] for k in range(200)]
    wire = scheduler._ChunkWire(Pool(), sets[0], None)
    stop = threading.Event()

    def attempt():
        while not stop.is_set():
            items, _ = wire.acquire()
            with lock:
                held[id(items)] = held.get(id(items), 0) + 1
            time.sleep(0)
            with lock:
                held[id(items)] -= 1
            wire.done(items)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=attempt) for _ in range(16)]
        for t in threads:
            t.start()
        for items in sets[1:]:
            wire.replace(items)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        wire.close()
    finally:
        sys.setswitchinterval(old)
    assert sorted(released) == sorted(id(s) for s in sets)
