"""
The port's survey service (``riptide_tpu_torch.serve``, ``apps/rserve``,
``rseek --submit``) on the CPU, over REAL loopback HTTP.

* The JAX package's service tests (``tests/test_serve.py``), ported to
  the port's daemon on ``device="cpu"`` with the same tiny survey (12 s
  at 1 ms, bins 64-71, three DMs): lifecycle, fair-share interleaving
  of concurrent jobs, admission and runtime quotas, chunk-boundary
  cancellation, warm reuse across jobs, registry-replay restart,
  idempotent submission, back-pressure, deadlines, drain, job-scoped
  incident attribution and device-error containment.
* Against the JAX package's daemon: the same spec gives equal folded
  job states and equal peaks (period, width and DM text equal, S/N
  within rtol 1e-5 / atol 1e-4); ``job_record``, ``fold_job_events``
  and ``geometry_key`` agree, registry lines are the same bytes, and a
  registry the JAX daemon wrote replays in the port's to the same
  re-queue set. The JAX daemon runs one job at a time (``workers=1``);
  concurrency is tested on the port's daemon only.
* A sticky CUDA error (``context_usable`` patched False, an injected
  ``device_error``): the implicated job fails, its sibling parks with
  no terminal record, and admission and ``/healthz`` answer 503.
* ``rseek --submit`` against the port's daemon, and ``rserve`` as a
  process: SIGTERM drains it and it exits 0.
* The scheduler's ``chunk_gate``: ``begin`` before a chunk's ship, ``end``
  after its collect; the service flags, ``fsio.SITES``, the endpoints
  and ``IntegrityConfig.from_spec`` are the JAX package's.

Both packages run on the uint6 wire (``RIPTIDE_WIRE_DTYPE=uint6
RIPTIDE_FFA_PATH=gather``), as ``tests/test_torch_survey.py`` runs
them.
"""
import csv
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from riptide_tpu.serve import ServeDaemon as RefDaemon
from riptide_tpu.serve import daemon as ref_daemon
from riptide_tpu_torch.apps import rseek
from riptide_tpu_torch.serve import FairShareQueue, ServeDaemon, TenantTable
from riptide_tpu_torch.serve import daemon as port_daemon
from riptide_tpu_torch.serve.daemon import (fold_job_events, geometry_key,
                                            job_record)
from riptide_tpu_torch.serve.queue import (JobCancelled,
                                           JobDeadlineExceeded, JobDrained,
                                           QuotaExceeded)
from riptide_tpu_torch.survey import incidents, scheduler
from riptide_tpu_torch.survey.journal import SurveyJournal
from riptide_tpu_torch.survey.metrics import get_metrics

from synth import generate_data_presto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRE_ENV = {"RIPTIDE_WIRE_DTYPE": "uint6", "RIPTIDE_FFA_PATH": "gather"}
SNR_RTOL, SNR_ATOL = 1e-5, 1e-4

# The chaos campaign's tiny deterministic survey.
TOBS, TSAMP, PERIOD = 12.0, 1e-3, 0.5
DMS = (0.0, 5.0, 10.0)

SEARCH = [{
    "ffa_search": {"period_min": 0.3, "period_max": 1.2,
                   "bins_min": 64, "bins_max": 71},
    "find_peaks": {"smin": 6.0},
}]


@pytest.fixture(autouse=True)
def _wire(monkeypatch):
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("serve_data")
    return [
        generate_data_presto(str(outdir), f"s_DM{dm:.2f}", tobs=TOBS,
                             tsamp=TSAMP, period=PERIOD, dm=dm,
                             amplitude=30.0)
        for dm in DMS
    ]


def _spec(files, tenant="default", priority=0):
    return {"files": list(files), "fmt": "presto", "tenant": tenant,
            "priority": priority,
            "deredden": {"rmed_width": 4.0, "rmed_minpts": 101},
            "search": SEARCH}


def _req_full(base, path, method="GET", body=None, timeout=10.0,
              headers=None):
    """(status, body_bytes, response_headers)."""
    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"} if data else {}
    hdrs.update(headers or {})
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, err.read(), dict(err.headers)


def _req(base, path, method="GET", body=None, timeout=10.0, headers=None):
    code, raw, _ = _req_full(base, path, method=method, body=body,
                             timeout=timeout, headers=headers)
    return code, raw


def _req_json(base, path, method="GET", body=None, headers=None):
    code, raw = _req(base, path, method=method, body=body, headers=headers)
    return code, json.loads(raw)


def _wait_terminal(base, jid, timeout_s=180.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        code, doc = _req_json(base, f"/jobs/{jid}")
        assert code == 200, doc
        if doc.get("status") in ("done", "failed", "cancelled"):
            return doc
        time.sleep(0.05)
    raise AssertionError(f"{jid} did not finish within {timeout_s}s")


def _spin(predicate, timeout_s=120.0, tick=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(tick)
    return False


@pytest.fixture
def daemon(tmp_path):
    """Start port daemons on one serve root (``device="cpu"``); each is
    stopped at teardown."""
    started = []

    def _start(**kw):
        kw.setdefault("port", 0)
        kw.setdefault("device", "cpu")
        d = ServeDaemon(str(tmp_path / "serve"), **kw).start()
        started.append(d)
        return d, f"http://127.0.0.1:{d.port}"

    yield _start
    for d in started:
        d.stop()


def _step_one_chunk(d, jid, blocker):
    """With ``blocker`` (priority -1) holding the turn and ``jid``
    waiting at its gate: let the job run exactly one chunk, then the
    re-queued blocker takes the next turn. Returns the blocker's
    thread."""
    assert _spin(lambda: d.queue.snapshot()["jobs"]
                 .get(jid, {}).get("waiting"))
    blocker.end(0)
    assert _spin(lambda: d.queue.snapshot()["active"] == jid)
    t = threading.Thread(target=lambda: blocker.begin(1), daemon=True)
    t.start()
    assert _spin(lambda: d.queue.snapshot()["active"] == "blocker")
    return t


# ------------------------------------------------------------- unit layer

def test_fold_job_events_lifecycle():
    recs = [
        job_record("j0001", "submitted", tenant="a", priority=2,
                   spec={"search": SEARCH}),
        job_record("j0001", "started"),
        job_record("j0001", "done", npeaks=4, device_s=1.5,
                   queue_wait_s=0.1, chunks_total=3),
        job_record("j0002", "submitted", tenant="b"),
    ]
    jobs = fold_job_events(recs)
    assert jobs["j0001"]["status"] == "done"
    assert jobs["j0001"]["tenant"] == "a"
    assert jobs["j0001"]["priority"] == 2
    assert jobs["j0001"]["npeaks"] == 4
    assert jobs["j0001"]["chunks_total"] == 3
    assert jobs["j0002"]["status"] == "pending"
    # Garbage and foreign kinds fold to nothing.
    assert fold_job_events([{"kind": "chunk"}, "junk", None]) == {}


def test_geometry_key_canonical():
    a = _spec(["x.inf"])
    b = _spec(["y.inf"], tenant="other")  # data/tenant don't change it
    assert geometry_key(a) == geometry_key(b)
    c = dict(a, search=[{"ffa_search": {"period_min": 0.4}}])
    assert geometry_key(a) != geometry_key(c)


def test_fair_share_queue_pick_order():
    q = FairShareQueue()
    q.register("a1", tenant="a")
    q.register("a2", tenant="a")
    q.register("b1", tenant="b")
    # Tenant a has consumed more device time, so b's waiting job wins
    # the next turn; priority trumps both.
    q._tenant_device_s["a"] = 5.0
    q._tenant_device_s["b"] = 1.0
    for jid in ("a1", "a2", "b1"):
        q._entries[jid].waiting = True
    assert q._pick().job_id == "b1"
    q.register("a0", tenant="a", priority=-1)
    q._entries["a0"].waiting = True
    assert q._pick().job_id == "a0"


def test_queue_cancel_raises_at_begin():
    q = FairShareQueue()
    gate = q.register("j1")
    q.cancel("j1")
    with pytest.raises(JobCancelled):
        gate.begin(0)


def test_queue_drain_raises_at_begin():
    q = FairShareQueue()
    gate = q.register("j1")
    q.drain()
    assert q.draining
    with pytest.raises(JobDrained):
        gate.begin(0)


def test_queue_device_lost_parks_waiting_gates():
    """A gate's ``device_lost`` (a sticky CUDA error in its turn, before
    the turn ends) raises JobDrained in a job already waiting for the
    turn and at every later begin."""
    q = FairShareQueue()
    lost, waiting = q.register("j1"), q.register("j2")
    lost.begin(0)
    raised = []

    def wait():
        try:
            waiting.begin(0)
        except JobDrained as err:
            raised.append(err)

    t = threading.Thread(target=wait)
    t.start()
    assert _spin(lambda: q.snapshot()["jobs"]["j2"]["waiting"])
    lost.device_lost(0)
    lost.end(0)
    t.join(10)
    assert raised and q.device_lost and q.snapshot()["device_lost"]
    with pytest.raises(JobDrained):
        lost.begin(1)


def test_queue_deadline_raises_at_begin():
    q = FairShareQueue()
    gate = q.register("j1", deadline_s=0.01)
    time.sleep(0.03)
    with pytest.raises(JobDeadlineExceeded):
        gate.begin(0)
    # An unexpired deadline admits normally.
    gate2 = FairShareQueue().register("j2", deadline_s=60.0)
    gate2.begin(0)
    gate2.end(0)


def test_tenant_quota_admission_and_budget():
    t = TenantTable(budget_device_s=2.0, max_active=1)
    ok, _ = t.admit("a")
    assert ok
    t.job_started("a")
    ok, reason = t.admit("a")
    assert not ok and "max active" in reason
    t.job_finished("a")
    t.charge("a", 2.5)
    assert t.exhausted("a")
    ok, reason = t.admit("a")
    assert not ok and "budget exhausted" in reason
    assert t.remaining("a") == 0.0
    # Unlimited tenant budget (0) never exhausts.
    t2 = TenantTable(budget_device_s=0.0)
    t2.charge("a", 1e9)
    assert not t2.exhausted("a")
    q = FairShareQueue(tenants=t)
    gate = q.register("j1", tenant="a")
    with pytest.raises(QuotaExceeded):
        gate.begin(0)


def test_daemon_defaults_to_the_card(tmp_path, monkeypatch):
    """ServeDaemon's ``device=None`` is ``cuda`` (raising here, where
    there is no card) and rserve's ``--device`` defaults to ``cuda``."""
    from riptide_tpu_torch.apps import rserve

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeDaemon(str(tmp_path / "serve"))
    assert rserve.get_parser().parse_args([]).device == "cuda"
    assert ServeDaemon(str(tmp_path / "s2"), device="cpu").device.type \
        == "cpu"


SERVE_FLAGS = ("RIPTIDE_SERVE", "RIPTIDE_SERVE_MAX_JOBS",
               "RIPTIDE_SERVE_QUOTA_DEVICE_S", "RIPTIDE_SERVE_PORT",
               "RIPTIDE_SERVE_DIR", "RIPTIDE_SERVE_DRAIN_TIMEOUT_S")


@pytest.mark.parametrize("name", SERVE_FLAGS)
def test_serve_flags_are_the_reference(name, monkeypatch):
    """The six service flags have the JAX package's names, types and
    defaults, and parse a set value alike."""
    from riptide_tpu.utils import envflags as ref
    from riptide_tpu_torch.utils import envflags

    port, want = envflags.FLAGS[name], ref.FLAGS[name]
    assert (port.type, port.default) == (want.type, want.default)
    assert envflags.get(name) == ref.get(name)
    raw = {"bool": "0", "int": "7", "float": "2.5", "str": "/srv/x"}
    monkeypatch.setenv(name, raw[port.type])
    assert envflags.get(name) == ref.get(name)


def test_fsio_sites_endpoints_and_integrity_spec_are_the_reference():
    from riptide_tpu.obs import prom as ref_prom
    from riptide_tpu.survey.integrity import IntegrityConfig as RefConfig
    from riptide_tpu.utils import fsio as ref_fsio
    from riptide_tpu_torch.obs import prom
    from riptide_tpu_torch.survey.integrity import IntegrityConfig
    from riptide_tpu_torch.utils import fsio

    assert fsio.SITES == ref_fsio.SITES and "job_append" in fsio.SITES
    assert prom.ENDPOINTS == ref_prom.ENDPOINTS
    for spec in (None, "off", "digest", "probe",
                 {"mode": "probe", "probe_every": 3}, {"probe_every": 0}):
        for policy in ("park", "fail"):
            got = IntegrityConfig.from_spec(spec, policy=policy)
            want = RefConfig.from_spec(spec, policy=policy)
            assert (got.mode, got.probe_every, got.policy) == \
                (want.mode, want.probe_every, want.policy)
    for bad in (3, ["probe"]):
        with pytest.raises(ValueError):
            IntegrityConfig.from_spec(bad)


class _RecordingGate:
    """A chunk gate that logs its calls beside the scheduler's ship and
    collect, and can stop the run at a chosen chunk."""

    def __init__(self, log, stop_at=None):
        self.log, self.stop_at = log, stop_at

    def begin(self, cid):
        if cid == self.stop_at:
            raise JobCancelled(f"stop at {cid}")
        self.log.append(("begin", cid))

    def end(self, cid):
        self.log.append(("end", cid))


def test_chunk_gate_brackets_ship_to_collect(data_files, tmp_path):
    """``begin`` runs once a chunk is staged and before its ship; ``end``
    after its collect and journal record; an exception out of ``begin``
    stops the run at that boundary with the journal resumable."""
    from riptide_tpu_torch.pipeline.batcher import BatchSearcher

    def searcher(log):
        s = BatchSearcher({"rmed_width": 4.0, "rmed_minpts": 101}, SEARCH,
                          fmt="presto", io_threads=1, device="cpu")
        for name in ("_ship_chunk", "_collect_chunk"):
            real = getattr(s, name)

            def logged(arg, real=real, name=name):
                log.append((name, None))
                return real(arg)
            setattr(s, name, logged)
        return s

    log = []
    chunks = [[f] for f in data_files]
    peaks = scheduler.SurveyScheduler(
        searcher(log), chunks, journal=SurveyJournal(tmp_path / "j"),
        chunk_gate=_RecordingGate(log)).run()
    assert peaks
    want = []
    for cid in range(len(chunks)):
        want += [("begin", cid), ("_ship_chunk", None),
                 ("_collect_chunk", None), ("end", cid)]
    assert log == want
    log = []
    with pytest.raises(JobCancelled):
        scheduler.SurveyScheduler(
            searcher(log), chunks, journal=SurveyJournal(tmp_path / "k"),
            chunk_gate=_RecordingGate(log, stop_at=1)).run()
    assert log == want[:4]
    assert sorted(SurveyJournal(tmp_path / "k").completed_chunks()) == [0]


# ----------------------------------------------------------- service layer

def test_job_lifecycle_over_http(daemon, data_files):
    d, base = daemon(workers=1)
    code, doc = _req_json(base, "/jobs", "POST", _spec(data_files[:1]))
    assert code == 202, doc
    jid = doc["job_id"]
    assert doc["status"] == "pending"
    doc = _wait_terminal(base, jid)
    assert doc["status"] == "done", doc.get("error")
    assert doc["npeaks"] > 0
    assert doc["chunks_total"] == 1
    assert doc["device_s"] > 0
    assert doc["queue_wait_s"] >= 0
    # The served CSV is byte-identical to the job directory's product.
    code, payload = _req(base, f"/jobs/{jid}/peaks")
    assert code == 200
    with open(os.path.join(doc["directory"], "peaks.csv"), "rb") as fobj:
        assert payload == fobj.read()
    assert payload.startswith(b"period,")
    code, listing = _req_json(base, "/jobs")
    assert code == 200
    assert [j["job_id"] for j in listing["jobs"]] == [jid]
    assert "default" in listing["tenants"]
    assert listing["geometry_pins"]
    assert _req_json(base, "/jobs/j9999")[0] == 404
    code, _ = _req_json(base, "/jobs", "POST", {"search": SEARCH})
    assert code == 400  # no input files
    # The job's artifacts are ordinary survey artifacts.
    j = SurveyJournal(os.path.join(d.root, "jobs", jid))
    assert sorted(j.completed_chunks()) == [0]


def test_concurrent_jobs_fair_share_interleaving(daemon, data_files):
    d, base = daemon(workers=2)
    # Both jobs wait at their first gate behind a blocker, so the
    # interleave does not depend on how fast either one stages.
    blocker = d.queue.register("blocker", priority=-1)
    blocker.begin(0)
    jids = []
    for spec in (_spec(data_files, tenant="alice"),
                 _spec(data_files, tenant="bob")):
        code, doc = _req_json(base, "/jobs", "POST", spec)
        assert code == 202, doc
        jids.append(doc["job_id"])
    assert _spin(lambda: all(d.queue.snapshot()["jobs"].get(j, {})
                             .get("waiting") for j in jids))
    blocker.end(0)
    d.queue.unregister("blocker")
    docs = [_wait_terminal(base, jid) for jid in jids]
    assert all(doc["status"] == "done" for doc in docs)
    # Merge both jobs' chunk records by their journaled stamps: the
    # fair-share gate alternates turns between the tenants.
    stamped = []
    for jid in jids:
        j = SurveyJournal(os.path.join(d.root, "jobs", jid))
        for cid, (rec, _peaks) in j.completed_chunks().items():
            stamped.append((rec["utc"], jid, cid))
        assert sorted(j.completed_chunks()) == [0, 1, 2]
    stamped.sort()
    order = [jid for _, jid, _ in stamped]
    switches = sum(1 for a, b in zip(order, order[1:]) if a != b)
    assert switches >= 2, f"no fair-share interleaving: {order}"
    code, listing = _req_json(base, "/jobs")
    assert set(listing["tenants"]) >= {"alice", "bob"}
    assert all(v["device_s_spent"] > 0
               for k, v in listing["tenants"].items()
               if k in ("alice", "bob"))
    # Same inputs, same bytes, whoever's turns they ran in.
    with open(os.path.join(docs[0]["directory"], "peaks.csv"), "rb") as a, \
            open(os.path.join(docs[1]["directory"], "peaks.csv"), "rb") as b:
        assert a.read() == b.read()


def test_admission_rejection_and_incident(daemon, data_files):
    captured = []
    prev = incidents.set_sink(captured.append)
    try:
        # workers=0: jobs stay pending, so the admission checks are
        # deterministic.
        d, base = daemon(workers=0, max_jobs=2,
                         tenants=TenantTable(max_active=1))
        code, doc = _req_json(base, "/jobs", "POST",
                              _spec(data_files[:1], tenant="alice"))
        assert code == 202
        code, doc = _req_json(base, "/jobs", "POST",
                              _spec(data_files[:1], tenant="alice"))
        assert code == 429
        assert "max active" in doc["error"]
        code, doc = _req_json(base, "/jobs", "POST",
                              _spec(data_files[:1], tenant="bob"))
        assert code == 202
        code, doc = _req_json(base, "/jobs", "POST",
                              _spec(data_files[:1], tenant="carol"))
        assert code == 429
        assert "max resident" in doc["error"]
    finally:
        incidents.set_sink(prev)
    kinds = [rec["incident"] for rec in captured]
    assert kinds.count("job_rejected") == 2


def test_runtime_quota_stops_at_chunk_boundary(daemon, data_files):
    tenants = TenantTable(budget_device_s=1e-6)
    d, base = daemon(workers=1, tenants=tenants)
    code, doc = _req_json(base, "/jobs", "POST",
                          _spec(data_files, tenant="meter"))
    assert code == 202
    doc = _wait_terminal(base, doc["job_id"])
    # The first turn exhausts the micro-budget; the stop lands at the
    # NEXT chunk boundary, so the journal keeps the completed chunk.
    assert doc["status"] == "failed"
    assert "budget exhausted" in doc["error"]
    j = SurveyJournal(doc["directory"])
    done = j.completed_chunks()
    assert 0 < len(done) < len(DMS)
    assert any(rec["incident"] == "quota_exceeded"
               for rec in j.incidents())


def test_cancellation_leaves_resumable_journal(daemon, data_files):
    d, base = daemon(workers=1)
    blocker = d.queue.register("blocker", priority=-1)
    blocker.begin(0)
    code, doc = _req_json(base, "/jobs", "POST", _spec(data_files))
    assert code == 202
    jid = doc["job_id"]
    jdir = os.path.join(d.root, "jobs", jid)
    _step_one_chunk(d, jid, blocker)
    code, doc = _req_json(base, f"/jobs/{jid}", "DELETE")
    assert code in (200, 202), doc
    doc = _wait_terminal(base, jid)
    blocker.end(1)
    d.queue.unregister("blocker")
    assert doc["status"] == "cancelled"
    assert sorted(SurveyJournal(jdir).completed_chunks()) == [0]
    assert _req_json(base, f"/jobs/{jid}/peaks")[0] == 409
    assert _req_json(base, f"/jobs/{jid}", "DELETE")[0] == 409


def test_second_job_runs_warm(daemon, data_files):
    d, base = daemon(workers=1)
    code, doc = _req_json(base, "/jobs", "POST", _spec(data_files[:1]))
    assert code == 202
    first = _wait_terminal(base, doc["job_id"])
    assert first["status"] == "done"
    cold_before = get_metrics().counter("exec_cold_builds")
    warm_before = get_metrics().counter("exec_warm_hits")
    code, doc = _req_json(base, "/jobs", "POST", _spec(data_files[:1]))
    assert code == 202
    second = _wait_terminal(base, doc["job_id"])
    assert second["status"] == "done"
    # A repeat geometry builds NOTHING: the cold-build counter stays
    # flat while warm hits accrue, and the job document says so.
    assert get_metrics().counter("exec_cold_builds") == cold_before
    assert get_metrics().counter("exec_warm_hits") > warm_before
    assert first["warm_start"] is False and second["warm_start"] is True
    code, listing = _req_json(base, "/jobs")
    pin = listing["geometry_pins"][geometry_key(_spec(data_files[:1]))]
    assert pin["jobs"] >= 2
    with open(os.path.join(first["directory"], "peaks.csv"), "rb") as f1, \
            open(os.path.join(second["directory"], "peaks.csv"), "rb") as f2:
        assert f1.read() == f2.read()


def test_restart_requeues_unfinished_jobs(daemon, data_files):
    d1, base1 = daemon(workers=0)
    code, doc = _req_json(base1, "/jobs", "POST", _spec(data_files[:1]))
    assert code == 202
    jid = doc["job_id"]
    d1.stop()
    d2, base2 = daemon(workers=1)
    assert d2.root == d1.root
    doc = _wait_terminal(base2, jid)
    assert doc["status"] == "done"
    code, doc2 = _req_json(base2, "/jobs", "POST", _spec(data_files[:1]))
    assert doc2["job_id"] != jid
    code, payload = _req(base2, f"/jobs/{jid}/peaks")
    assert code == 200 and payload.startswith(b"period,")


def test_idempotent_submission_dedupes_across_restart(daemon, data_files):
    d1, base1 = daemon(workers=0)
    hdr = {"Idempotency-Key": "key-abc"}
    code, doc = _req_json(base1, "/jobs", "POST", _spec(data_files[:1]),
                          headers=hdr)
    assert code == 202
    jid = doc["job_id"]
    code, doc2 = _req_json(base1, "/jobs", "POST", _spec(data_files[:1]),
                           headers=hdr)
    assert code == 202 and doc2["job_id"] == jid
    code, doc3 = _req_json(base1, "/jobs", "POST", _spec(data_files[:1]),
                           headers={"Idempotency-Key": "key-def"})
    assert code == 202 and doc3["job_id"] != jid
    code, listing = _req_json(base1, "/jobs")
    assert len(listing["jobs"]) == 2
    d1.stop()
    d2, base2 = daemon(workers=0)
    code, doc4 = _req_json(base2, "/jobs", "POST", _spec(data_files[:1]),
                           headers=hdr)
    assert code == 202 and doc4["job_id"] == jid


def test_backpressure_carries_retry_after(daemon, data_files):
    d, base = daemon(workers=0, max_jobs=1)
    code, _, _ = _req_full(base, "/jobs", "POST", _spec(data_files[:1]))
    assert code == 202
    code, raw, hdrs = _req_full(base, "/jobs", "POST",
                                _spec(data_files[:1]))
    doc = json.loads(raw)
    assert code == 429
    assert doc["retry_after_s"] > 0
    assert hdrs.get("Retry-After") == str(doc["retry_after_s"])


def test_deadline_fails_job_with_timeout_incident(daemon, data_files):
    d, base = daemon(workers=1)
    code, doc = _req_json(base, "/jobs", "POST",
                          dict(_spec(data_files[:1]), deadline_s=-1))
    assert code == 400 and "deadline_s" in doc["error"]
    blocker = d.queue.register("blocker", priority=-1)
    blocker.begin(0)
    try:
        code, doc = _req_json(base, "/jobs", "POST",
                              dict(_spec(data_files[:1]), deadline_s=0.2))
        assert code == 202
        doc = _wait_terminal(base, doc["job_id"], timeout_s=30.0)
    finally:
        blocker.end(0)
        d.queue.unregister("blocker")
    assert doc["status"] == "failed"
    assert "deadline" in doc["error"]
    j = SurveyJournal(doc["directory"])
    assert any(rec["incident"] == "job_timeout" for rec in j.incidents())
    assert j.completed_chunks() == {}


def test_drain_parks_job_and_restart_resumes(daemon, data_files):
    d, base = daemon(workers=1)
    blocker = d.queue.register("blocker", priority=-1)
    blocker.begin(0)
    code, doc = _req_json(base, "/jobs", "POST", _spec(data_files))
    assert code == 202
    jid = doc["job_id"]
    _step_one_chunk(d, jid, blocker)
    code, doc = _req_json(base, "/drain", "POST", {})
    assert code == 202 and doc["draining"] is True
    code, raw, hdrs = _req_full(base, "/jobs", "POST",
                                _spec(data_files[:1]))
    body = json.loads(raw)
    assert code == 503 and body["draining"] is True
    assert hdrs.get("Retry-After") == str(body["retry_after_s"])
    code, status = _req_json(base, "/status")
    assert code == 200 and status.get("draining") is True
    blocker.end(1)
    d.queue.unregister("blocker")
    assert d.wait_drained(timeout=60)
    code, doc = _req_json(base, f"/jobs/{jid}")
    assert doc["status"] in ("pending", "running")
    jdir = os.path.join(d.root, "jobs", jid)
    assert sorted(SurveyJournal(jdir).completed_chunks()) == [0]
    d.stop()
    d2, base2 = daemon(workers=1)
    doc = _wait_terminal(base2, jid)
    assert doc["status"] == "done", doc.get("error")
    assert doc.get("resumed") is True
    assert sorted(SurveyJournal(jdir).completed_chunks()) \
        == list(range(len(DMS)))


def test_drain_journals_park_record_into_each_jobs_journal(daemon,
                                                           data_files):
    d, base = daemon(workers=2)
    blocker = d.queue.register("blocker", priority=-1)
    blocker.begin(0)
    jids = []
    for tenant in ("alice", "bob"):
        code, doc = _req_json(base, "/jobs", "POST",
                              _spec(data_files, tenant=tenant))
        assert code == 202
        jids.append(doc["job_id"])
    assert _spin(lambda: all(
        d.queue.snapshot()["jobs"].get(j, {}).get("waiting")
        for j in jids))
    blocker.end(0)
    assert _spin(lambda: d.queue.snapshot()["active"] in jids)
    t = threading.Thread(target=lambda: blocker.begin(1), daemon=True)
    t.start()
    assert _spin(lambda: d.queue.snapshot()["active"] == "blocker")
    code, doc = _req_json(base, "/drain", "POST", {})
    assert code == 202 and doc["draining"] is True
    blocker.end(1)
    d.queue.unregister("blocker")
    assert d.wait_drained(timeout=60)
    for jid, sibling in ((jids[0], jids[1]), (jids[1], jids[0])):
        code, doc = _req_json(base, f"/jobs/{jid}")
        assert doc["status"] in ("pending", "running")
        jdir = os.path.join(d.root, "jobs", jid)
        parks = [rec for rec in SurveyJournal(jdir).incidents()
                 if rec["incident"] == "job_drained"]
        assert len(parks) == 1, f"{jid}: {parks}"
        assert parks[0]["detail"]["job_id"] == jid
        assert not any(rec["detail"].get("job_id") == sibling
                       for rec in SurveyJournal(jdir).incidents())


def test_concurrent_fault_attribution_is_job_scoped(daemon, data_files):
    d, base = daemon(workers=2)
    jids = []
    for tenant in ("alice", "bob"):
        spec = _spec(data_files, tenant=tenant)
        spec["fault_inject"] = "fsync_fail:heartbeat_append"
        code, doc = _req_json(base, "/jobs", "POST", spec)
        assert code == 202
        jids.append(doc["job_id"])
    docs = [_wait_terminal(base, jid) for jid in jids]
    assert all(doc["status"] == "done" for doc in docs)
    for doc, jid, sibling in ((docs[0], jids[0], jids[1]),
                              (docs[1], jids[1], jids[0])):
        errs = [rec["detail"].get("error", "")
                for rec in SurveyJournal(doc["directory"]).incidents()
                if rec["incident"] == "obs_write_failed"]
        assert errs, f"{jid}: no obs_write_failed journaled"
        assert all(jid in err for err in errs)
        assert not any(sibling in err for err in errs)


def test_device_error_single_fault_retries_to_done(daemon, data_files):
    d, base = daemon(workers=1)
    before = get_metrics().counter("device_errors")
    spec = _spec(data_files[:1])
    spec["fault_inject"] = "device_error:0"
    code, doc = _req_json(base, "/jobs", "POST", spec)
    assert code == 202
    doc = _wait_terminal(base, doc["job_id"])
    # One injected device error leaves the context usable: the retry
    # re-dispatches and the job completes.
    assert doc["status"] == "done", doc.get("error")
    assert get_metrics().counter("device_errors") > before


def test_persistent_device_error_fails_only_that_job(daemon, data_files):
    d, base = daemon(workers=2)
    code, clean = _req_json(base, "/jobs", "POST", _spec(data_files[:1]))
    assert code == 202
    spec = _spec(data_files[:1], tenant="victim")
    spec["fault_inject"] = "device_error:0x9"  # outlasts every retry
    code, faulted = _req_json(base, "/jobs", "POST", spec)
    assert code == 202
    fdoc = _wait_terminal(base, faulted["job_id"])
    cdoc = _wait_terminal(base, clean["job_id"])
    assert cdoc["status"] == "done", cdoc.get("error")
    assert fdoc["status"] == "failed"
    fj = SurveyJournal(fdoc["directory"])
    assert any(rec["incident"] == "device_error" for rec in fj.incidents())
    cj = SurveyJournal(cdoc["directory"])
    assert not any(rec["incident"] == "device_error"
                   for rec in cj.incidents())
    assert not d.device_lost
    code, doc = _req_json(base, "/jobs", "POST", _spec(data_files[:1]))
    assert code == 202
    assert _wait_terminal(base, doc["job_id"])["status"] == "done"


def test_jobs_endpoint_without_daemon():
    from riptide_tpu_torch.obs import prom

    server = prom.serve(0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        code, doc = _req_json(base, "/jobs")
        assert code == 503
        assert "no survey service" in doc["error"]
        code, doc = _req_json(base, "/jobs", "POST", {})
        assert code == 503
        code, doc = _req_json(base, "/drain", "POST", {})
        assert code == 503
    finally:
        server.close()


# ------------------------------------------------------ the sticky error

def test_sticky_device_error_fails_one_job_and_parks_the_rest(
        daemon, data_files, monkeypatch):
    """The port's one intended difference from the JAX daemon: an error
    that leaves the CUDA context unusable fails the implicated job,
    parks its sibling without a terminal record (so a restart resumes
    it), and turns admission and /healthz to 503."""
    monkeypatch.setattr(scheduler, "context_usable", lambda device: False)
    d, base = daemon(workers=2)
    blocker = d.queue.register("blocker", priority=-2)
    blocker.begin(0)
    spec = _spec(data_files, tenant="victim", priority=-1)
    spec["fault_inject"] = "device_error:0x9"
    code, faulted = _req_json(base, "/jobs", "POST", spec)
    assert code == 202
    code, sibling = _req_json(base, "/jobs", "POST",
                              _spec(data_files, tenant="bystander"))
    assert code == 202
    jids = (faulted["job_id"], sibling["job_id"])
    # Both wait for the turn; the faulted job's priority wins it.
    assert _spin(lambda: all(d.queue.snapshot()["jobs"].get(j, {})
                             .get("waiting") for j in jids))
    blocker.end(0)
    d.queue.unregister("blocker")
    fdoc = _wait_terminal(base, jids[0])
    assert fdoc["status"] == "failed" and "CUDA context" in fdoc["error"]
    assert d.wait_drained(timeout=60) and d.device_lost
    code, sdoc = _req_json(base, f"/jobs/{jids[1]}")
    assert sdoc["status"] in ("pending", "running")
    sdir = os.path.join(d.root, "jobs", jids[1])
    assert SurveyJournal(sdir).completed_chunks() == {}
    assert any(rec["incident"] == "job_drained"
               for rec in SurveyJournal(sdir).incidents())
    kinds = [(rec["incident"], rec["detail"].get("sticky"))
             for rec in SurveyJournal(fdoc["directory"]).incidents()]
    assert ("device_error", True) in kinds
    code, raw, hdrs = _req_full(base, "/jobs", "POST",
                                _spec(data_files[:1]))
    assert code == 503 and json.loads(raw)["device_lost"] is True
    assert hdrs.get("Retry-After")
    code, health = _req_json(base, "/healthz")
    assert code == 503 and health["status"]["device_lost"] is True


# -------------------------------------------- against the JAX package's daemon

def _csv_rows(text):
    return list(csv.DictReader(io.StringIO(text)))


def _assert_same_peaks(port_csv, ref_csv):
    port, ref = _csv_rows(port_csv), _csv_rows(ref_csv)
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        for key in ("period", "width", "dm"):
            assert a[key] == b[key], (key, a, b)
        assert float(a["snr"]) == pytest.approx(
            float(b["snr"]), rel=SNR_RTOL, abs=SNR_ATOL)


def test_same_spec_through_both_daemons(data_files, tmp_path):
    """One job through each package's daemon (the JAX one with one
    worker): equal folded job states and equal peaks."""
    docs, csvs = {}, {}
    for name, cls, kw in (("port", ServeDaemon, {"device": "cpu"}),
                          ("ref", RefDaemon, {})):
        d = cls(str(tmp_path / name), port=0, workers=1, **kw).start()
        try:
            base = f"http://127.0.0.1:{d.port}"
            code, doc = _req_json(base, "/jobs", "POST", _spec(data_files))
            assert code == 202, doc
            docs[name] = _wait_terminal(base, doc["job_id"])
            code, raw = _req(base, f"/jobs/{doc['job_id']}/peaks")
            assert code == 200
            csvs[name] = raw.decode()
        finally:
            d.stop()
    keys = ("job_id", "status", "npeaks", "chunks_total", "warm_start",
            "tenant", "priority", "spec")
    assert {k: docs["port"].get(k) for k in keys} == \
        {k: docs["ref"].get(k) for k in keys}
    assert docs["port"]["status"] == "done"
    _assert_same_peaks(csvs["port"], csvs["ref"])


def test_records_fold_and_registry_bytes_match_the_reference(tmp_path,
                                                             monkeypatch):
    utc = "2026-01-01T00:00:00.000000Z"
    monkeypatch.setattr(port_daemon, "_utc_iso", lambda: utc)
    monkeypatch.setattr(ref_daemon, "_utc_iso", lambda: utc)
    events = [
        ("j0001", "submitted", dict(tenant="a", priority=2,
                                    spec=_spec(["x.inf"]),
                                    idempotency_key="k1")),
        ("j0001", "started", dict(resumed=True)),
        ("j0001", "done", dict(npeaks=4, device_s=1.2345678,
                               queue_wait_s=0.1, chunks_total=3)),
        ("j0002", "submitted", dict(tenant="b")),
        ("j0002", "failed", dict(error="boom")),
        ("j0003", "cancelled", {}),
    ]
    paths = {}
    for name, mod in (("port", port_daemon), ("ref", ref_daemon)):
        recs = [mod.job_record(jid, ev, **kw) for jid, ev, kw in events]
        reg = mod.JobRegistry(str(tmp_path / name))
        for rec in recs:
            reg.append(rec)
        paths[name] = reg.path
        assert mod.fold_job_events(recs) == \
            ref_daemon.fold_job_events(recs)
    assert [port_daemon.job_record(j, e, **k) for j, e, k in events] == \
        [ref_daemon.job_record(j, e, **k) for j, e, k in events]
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    for spec in (_spec(["x.inf"]), {"search": SEARCH, "fmt": "sigproc"},
                 {"deredden": {"rmed_width": 2.0}}):
        assert port_daemon.geometry_key(spec) == ref_daemon.geometry_key(spec)
    assert port_daemon.JobRegistry(str(tmp_path / "ref")).replay() == \
        ref_daemon.JobRegistry(str(tmp_path / "port")).replay()


def test_reference_registry_replays_to_the_same_requeue_set(tmp_path,
                                                            data_files):
    """A jobs.jsonl the JAX JobRegistry wrote (one running, one pending,
    one done job) re-queues the same jobs in both packages' daemons."""
    root = tmp_path / "serve"
    reg = ref_daemon.JobRegistry(str(root))
    for jid in ("j0001", "j0002", "j0003"):
        reg.append(ref_daemon.job_record(jid, "submitted", tenant="a",
                                         spec=_spec(data_files[:1])))
    reg.append(ref_daemon.job_record("j0001", "started"))
    reg.append(ref_daemon.job_record("j0003", "started"))
    reg.append(ref_daemon.job_record("j0003", "done", npeaks=1))
    out = {}
    for name, cls, kw in (("port", ServeDaemon, {"device": "cpu"}),
                          ("ref", RefDaemon, {})):
        d = cls(str(root), port=0, workers=0, **kw).start()
        try:
            out[name] = (list(d._pending),
                         {jid: (st["status"], st.get("resumed"))
                          for jid, st in d._jobs.items()},
                         d._seq)
        finally:
            d.stop()
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["j0001", "j0002"]
    assert out["port"][1]["j0001"] == ("running", True)


# ------------------------------------------------------------ the clients

def test_rseek_submit_against_the_port_daemon(daemon, data_files, capsys):
    """``rseek --submit`` posts the search, polls it and prints the
    served CSV: the same bytes the job directory holds; the client
    touches no CUDA."""
    import torch

    d, base = daemon(workers=1)
    argv = ["-f", "presto", "--Pmin", "0.3", "--Pmax", "1.2", "--bmin",
            "64", "--bmax", "71", "--smin", "6.0", "--submit", base,
            "--tenant", "cli", "--priority", "1", data_files[0]]
    args = rseek.get_parser().parse_args(argv)
    assert rseek.run_program(args) is None
    out = capsys.readouterr().out
    header, _, body = out.partition("\n")
    assert header.startswith("# job j0001 done:")
    doc = d.list()["jobs"][0]
    assert doc["tenant"] == "cli" and doc["priority"] == 1
    with open(os.path.join(doc["directory"], "peaks.csv")) as fobj:
        assert body == fobj.read()
    assert len(_csv_rows(body)) == doc["npeaks"] > 0
    assert not torch.cuda.is_initialized()


def test_rserve_process_drains_on_sigterm(tmp_path):
    """rserve as a process on the CPU: it publishes serve.port, answers
    /jobs, and SIGTERM drains it to exit 0."""
    root = tmp_path / "serve"
    env = dict(os.environ, **WIRE_ENV)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "riptide_tpu_torch.apps.rserve", "--root",
         str(root), "--port", "0", "--device", "cpu", "--workers", "1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port_file = root / "serve.port"
        assert _spin(port_file.exists, timeout_s=60)
        base = f"http://127.0.0.1:{int(port_file.read_text())}"
        assert _spin(lambda: _req_json(base, "/jobs")[0] == 200,
                     timeout_s=30)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "drained, exiting" in out
