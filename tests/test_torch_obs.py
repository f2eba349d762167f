"""
The port's observability layer (``riptide_tpu_torch.obs``) against the
JAX package's, on the CPU: the span tracer, the Chrome export of a
journaled survey (one span per chunk, its ship/queue/collect children
nested, its stage span on the staging thread), the spans inside one
queued and collected survey batch and their ``riptide.*`` annotations
in a ``torch.profiler`` trace, the Prometheus page (the
JAX package's metric names and values for the same registry contents),
the timing schema, the ledger row, the fleet sidecars, the alert rules
and the journal readers the scheduler uses.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from riptide_tpu.obs import alerts as ref_alerts
from riptide_tpu.obs import fleet as ref_fleet
from riptide_tpu.obs import prom as ref_prom
from riptide_tpu.obs import report as ref_report
from riptide_tpu.obs import schema as ref_schema
from riptide_tpu.survey.metrics import MetricsRegistry as RefRegistry
from riptide_tpu_torch.obs import (alerts, chrome, fleet, ledger, prom,
                                   report, schema, trace)
from riptide_tpu_torch.search import engine, peaks_device
from riptide_tpu_torch.search.plan import periodogram_plan
from riptide_tpu_torch.survey.metrics import MetricsRegistry

from test_torch_survey import WIRE_ENV, _schedule
from test_torch_survey import clean, trials  # noqa: F401 (fixtures)


@pytest.fixture(autouse=True)
def _wire(monkeypatch):
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)


@pytest.fixture
def tracer():
    tr = trace.enable()
    yield tr
    trace.disable()


# ------------------------------------------------------------------ tracer

def test_spans_nest_and_inherit_the_chunk(tracer):
    with trace.span("outer", chunk=4):
        with trace.span("inner") as sp:
            sp.set(bytes=10)
            sid = trace.current_span_id()
    (inner, outer) = tracer.events()
    assert (inner[0], outer[0]) == ("inner", "outer")
    assert inner[4] == {"chunk": 4, "bytes": 10} and inner[5] == sid
    assert outer[1] <= inner[1] and inner[1] + inner[2] <= outer[1] + outer[2]
    assert trace.current_span_id() is None


def test_disabled_tracer_is_the_shared_null_span():
    assert trace.get_tracer() is None
    assert trace.span("x", chunk=1) is trace.NULL_SPAN


def test_ring_is_bounded_and_counts_drops():
    tr = trace.Tracer(capacity=3)
    prev = trace.set_tracer(tr)
    try:
        for i in range(5):
            with trace.span("s", i=i):
                pass
    finally:
        trace.set_tracer(prev)
    assert len(tr.events()) == 3
    assert (tr.recorded, tr.dropped_events) == (5, 2)


# ------------------------------------------------------ the survey's trace

def test_journaled_survey_exports_a_nested_chrome_trace(trials, tmp_path,
                                                        tracer):
    out = _schedule("port", trials, tmp_path, "")
    assert out[1]["chunks_done"] == 3
    doc = json.loads((tmp_path / "trace.json").read_text())
    spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert all(ev["dur"] >= 0 for ev in spans)
    for cid in range(3):
        mine = [ev for ev in spans if ev["args"].get("chunk") == cid]
        names = [ev["name"] for ev in mine]
        assert names.count("chunk") == 1
        for child in ("stage", "ship", "queue", "collect", "journal"):
            assert child in names, (cid, child)
        (parent,) = [ev for ev in mine if ev["name"] == "chunk"]
        for ev in mine:
            if ev["name"] in ("ship", "queue", "collect"):
                assert ev["tid"] == parent["tid"]
                assert parent["ts"] <= ev["ts"]
                assert ev["ts"] + ev["dur"] <= \
                    parent["ts"] + parent["dur"] + 1.0
        stage = [ev for ev in mine if ev["name"] == "stage"]
        assert stage[0]["tid"] != parent["tid"]      # the staging thread
    meta = [ev for ev in doc["traceEvents"] if ev["ph"] == "M"]
    assert any(ev["name"] == "thread_name" for ev in meta)


# ------------------------------------------ spans inside one survey batch

# A D = 2 batch of 1200 samples (a pulsar in trial 0) with the device
# clustering on, so that every step of the peak program runs.
BATCH_CFG = (1200, 1e-3, (1, 2, 3), 32e-3, 0.11, 32, 40)
BATCH_TOBS = 1.2
PEAK_KW = dict(smin=6.0, segwidth=0.2, nstd=6.0, minseg=10, polydeg=2,
               clrad=0.1)
PEAK_STEPS = tuple(f"peaks.{step}" for step in (
    "stats", "fit", "counts", "select", "cluster", "harm", "pack"))
# Each child span and the span it lies in.
SPAN_PARENTS = dict({"stages": "chunk", "ffa_stage": "stages",
                     "assemble": "chunk", "peaks": "chunk", "pull": "chunk",
                     "tail": "chunk", "overflow": "tail", "cluster": "tail"},
                    **{step: "peaks" for step in PEAK_STEPS})


def _search_batch(overflow=False, chunk=7):
    """Queue and collect one batch inside a ``chunk`` span; with
    ``overflow``, one block carried home per column and smin 2, so that
    columns take the overflow gather. Returns the plan."""
    plan = periodogram_plan(*BATCH_CFG)
    kw = dict(PEAK_KW, smin=2.0) if overflow else PEAK_KW
    pp = engine._peak_plan(plan, BATCH_TOBS, **kw)
    pp.CAP = 1 if overflow else peaks_device.PeakPlan.CAP
    rng = np.random.default_rng(3)
    batch = rng.standard_normal((2, BATCH_CFG[0])).astype(np.float32)
    batch[0, ::50] += 6.0
    with trace.span("chunk", chunk=chunk):
        handle = engine.queue_search_batch(plan, batch, BATCH_TOBS,
                                           device="cpu", **kw)
        engine.collect_search_batch(handle, np.zeros(2))
    return plan


def _inside(inner, outer, slack=0.0):
    return (outer[0] - slack <= inner[0]
            and inner[0] + inner[1] <= outer[0] + outer[1] + slack)


@pytest.mark.parametrize("overflow", [False, True])
def test_search_batch_spans_nest_and_inherit_the_chunk(tracer, overflow):
    plan = _search_batch(overflow)
    events = tracer.events()
    names = [ev[0] for ev in events]
    for name in ("stages", "assemble", "peaks", "pull", "tail",
                 "cluster") + PEAK_STEPS:
        assert names.count(name) == 1, name
    assert "device" not in names
    assert names.count("overflow") == int(overflow)
    stages = [ev[4]["stage"] for ev in events if ev[0] == "ffa_stage"]
    assert sorted(stages) == list(range(len(plan.stages)))
    assert all(ev[4].get("chunk") == 7 for ev in events), events
    for name, _, _, _, attrs, _ in events:
        if name == "overflow":
            assert attrs["blocks"] > 0
    spans = {}
    for name, ts, dur, tid, _, _ in events:
        spans.setdefault(name, []).append((ts, dur, tid))
    for name, parent in SPAN_PARENTS.items():
        (outer,) = spans[parent]
        for ts, dur, tid in spans.get(name, []):
            assert tid == outer[2] and _inside((ts, dur), outer), name


def _annotations(path):
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [ev for ev in events if ev.get("ph") == "X"
            and ev.get("cat") == "user_annotation"]


@pytest.mark.parametrize("traced", [True, False])
def test_search_batch_spans_are_profiler_annotations(tmp_path, traced):
    """With a tracer installed, every span of the batch is a
    ``riptide.<name>`` annotation (``riptide.ffa_stage.<i>`` for a
    stage) in the profiler's trace, inside the enclosing
    ``record_function`` and nested as the spans are; with none, there is
    no ``riptide.*`` annotation and ``span()`` is the null span."""
    tr = trace.enable() if traced else None
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.batch"):
                _search_batch()
                assert (trace.span("x") is trace.NULL_SPAN) == (not traced)
    finally:
        trace.disable()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    ann = _annotations(path)
    (outer,) = [ev for ev in ann if ev["name"] == "test.batch"]
    mine = [ev for ev in ann if ev["name"].startswith("riptide.")]
    if not traced:
        assert mine == []
        return
    want = sorted("riptide." + name + (f".{attrs['stage']}"
                                       if "stage" in attrs else "")
                  for name, _, _, _, attrs, _ in tr.events())
    assert sorted(ev["name"] for ev in mine) == want
    box = {ev["name"]: (ev["ts"], ev["dur"]) for ev in mine}
    for ev in mine:
        assert ev["tid"] == outer["tid"]
        assert _inside((ev["ts"], ev["dur"]), (outer["ts"], outer["dur"]),
                       slack=1e-3)
        base = ev["name"][len("riptide."):].split(".")
        name = ".".join(base[:2]) if base[0] == "peaks" else base[0]
        if name != "chunk":
            parent = "riptide." + SPAN_PARENTS.get(name, "chunk")
            assert _inside((ev["ts"], ev["dur"]), box[parent], slack=1e-3), \
                ev["name"]


def test_resumed_run_rotates_the_previous_trace(trials, tmp_path):
    trace.enable()
    try:
        _schedule("port", trials[:1], tmp_path, "")
    finally:
        trace.disable()
    first = (tmp_path / "trace.json").read_bytes()
    trace.enable()
    try:
        _schedule("port", trials[:1], tmp_path, "", resume=True)
    finally:
        trace.disable()
    assert (tmp_path / "trace.json.1").read_bytes() == first


def test_trace_export_failure_is_not_fatal(tmp_path, tracer):
    with trace.span("x"):
        pass
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert chrome.export_run_trace(str(blocker / "sub")) is None


# -------------------------------------------------------------- prometheus

def _fill(reg):
    reg.add("chunks_done", 3)
    reg.add("shadow_probes", 2)
    reg.set_gauge("queue_depth", 2)
    for sec in (0.5, 3.0):
        reg.observe("chunk_s", sec)
    reg.observe_hist("wire_MBps", 42.0)
    return reg


def test_prometheus_page_is_the_reference_page():
    # (Without the fleet sources earlier survey runs left installed.)
    prev = prom.set_fleet_source(None), ref_prom.set_fleet_source(None)
    try:
        ours = prom.render(_fill(MetricsRegistry()))
        ref = ref_prom.render(_fill(RefRegistry()))
    finally:
        prom.set_fleet_source(prev[0])
        ref_prom.set_fleet_source(prev[1])
    assert ours == ref
    values = report_values(ours)
    assert values["riptide_chunks_done_total"][""] == 3
    assert values["riptide_chunk_seconds_count"][""] == 2


def report_values(text):
    return ref_report.parse_prom_text(text)


def test_textfile_and_endpoint(tmp_path, monkeypatch):
    reg = _fill(MetricsRegistry())
    path = tmp_path / "riptide.prom"
    monkeypatch.setenv("RIPTIDE_PROM_TEXTFILE", str(path))
    assert prom.maybe_write_textfile(reg) == str(path)
    assert path.read_text() == prom.render(reg)
    server = prom.serve(0, registry=reg)
    prev = prom.set_status_provider(lambda: {"breaker": "open"})
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=5.0) as resp:
            assert "riptide_chunks_done_total 3" in resp.read().decode()
        with urllib.request.urlopen(base + "/status", timeout=5.0) as resp:
            assert json.loads(resp.read())["breaker"] == "open"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/healthz", timeout=5.0)
        assert err.value.code == 503
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/jobs", timeout=5.0)
    finally:
        prom.set_status_provider(prev)
        server.close()


def test_survey_textfile_carries_the_reference_metric_names(trials,
                                                           tmp_path,
                                                           monkeypatch):
    """The textfile a journaled run writes names the metrics as the JAX
    package's run does."""
    names = {}
    for pkg in ("port", "ref"):
        path = tmp_path / f"{pkg}.prom"
        monkeypatch.setenv("RIPTIDE_PROM_TEXTFILE", str(path))
        _schedule(pkg, trials[:2], tmp_path / pkg, "raise:1")
        names[pkg] = {name for name in report_values(path.read_text())
                      if not name.endswith("_bucket")}
    core = {"riptide_chunks_done_total", "riptide_chunks_retried_total",
            "riptide_chunk_seconds_sum", "riptide_device_seconds_sum",
            "riptide_prep_seconds_sum", "riptide_wire_seconds_sum",
            "riptide_wire_bytes_total", "riptide_queue_depth"}
    assert core <= names["port"] and core <= names["ref"]


# ------------------------------------------------------------------ schema

def test_timing_schema_matches_reference():
    kw = dict(prep_s=0.4, wire_s=0.5, queue_s=0.1, collect_s=1.2,
              device_s=1.0, cluster_s=0.05, postsearch_s=0.1,
              wire_bytes=4_000_000)
    assert schema.chunk_timing(2.0, **kw) == ref_schema.chunk_timing(2.0, **kw)
    assert schema.CHUNK_TIMING_KEYS == ref_schema.CHUNK_TIMING_KEYS
    assert schema.DECOMPOSITION_KEYS == ref_schema.DECOMPOSITION_KEYS
    for w, d in ((1.0, 1.0), (0.1, 1.0), (1.0, 0.0)):
        assert schema.classify_bound(w, d) == ref_schema.classify_bound(w, d)
    blk = dict(mode="probe", result="ab", peaks="cd", path="batch",
               probe=True, votes=["a", "b", "c"])
    assert schema.integrity_block(**blk) == ref_schema.integrity_block(**blk)
    summary = {"prep_s": 1.0, "device_s": 2.0, "wire_MBps": 30.0}
    assert schema.decomposition(summary, 4, 8.0) == \
        ref_schema.decomposition(summary, 4, 8.0)


# ------------------------------------------------------------------ ledger

def test_ledger_row_and_platform(tmp_path, monkeypatch):
    path = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("RIPTIDE_LEDGER", str(path))
    monkeypatch.setenv("RIPTIDE_PROM_PORT_OFFSET", "0")
    assert ledger.maybe_append("survey", {"device_s": 1.5}, nchunks=2,
                               bound_counts={"device": 2}) == str(path)
    (row,) = ledger.read_rows(str(path))
    assert row["kind"] == "survey" and row["nchunks"] == 2
    assert row["envflags"]["RIPTIDE_PROM_PORT_OFFSET"] is False
    assert "RIPTIDE_LEDGER" not in row["envflags"]
    plat = row["platform"]
    assert plat["backend"] in ("cpu", "cuda")
    assert len(plat["kernel_digest"]) == 12
    if plat["backend"] == "cuda":
        assert plat["device_kind"] and plat["device_count"] >= 1


def test_survey_appends_one_ledger_row(trials, tmp_path, monkeypatch):
    path = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("RIPTIDE_LEDGER", str(path))
    _schedule("port", trials[:2], tmp_path / "j", "")
    (row,) = ledger.read_rows(str(path))
    assert row["nchunks"] == 2 and row["chunks_total"] == 2
    assert set(schema.DECOMPOSITION_KEYS) <= set(row)


# ---------------------------------------------------- fleet, alerts, report

def test_survey_writes_the_reference_fleet_sidecar(trials, tmp_path):
    snaps = {}
    for pkg in ("port", "ref"):
        _schedule(pkg, trials[:2], tmp_path / pkg, "")
        snaps[pkg] = report.read_fleet(str(tmp_path / pkg))[0]
        assert snaps[pkg] == ref_report.read_fleet(str(tmp_path / pkg))[0]
    assert sorted(snaps["port"]) == sorted(snaps["ref"])
    assert snaps["port"]["chunks_done"] == 2
    assert not snaps["port"]["running"]
    merged = report.merge_fleet(snaps, now=snaps["port"]["ts"])
    assert merged == ref_report.merge_fleet(snaps, now=snaps["port"]["ts"])
    assert fleet.fleet_path("d", 3) == ref_fleet.fleet_path("d", 3)


def test_alert_rules_fire_like_the_reference():
    snaps = [{"chunks_parked": 0, "integrity_mismatches": 0,
              "consecutive_tunnel": 0, "heartbeat_age_s": 1.0},
             {"chunks_parked": 1, "integrity_mismatches": 1,
              "consecutive_tunnel": 3, "heartbeat_age_s": 500.0},
             {"chunks_parked": 0, "integrity_mismatches": 1,
              "consecutive_tunnel": 0, "heartbeat_age_s": 1.0}]
    events = {}
    for mod in (alerts, ref_alerts):
        eng = mod.AlertEngine(mod.rules_from_spec(None))
        for i, snap in enumerate(snaps):
            eng.evaluate(dict(snap), now=1000.0 + i)
        events[mod] = [(e["rule"], e["event"]) for e in eng.events()]
    assert events[alerts] == events[ref_alerts]
    assert ("integrity", "fired") in events[alerts]
    with pytest.raises(ValueError):
        alerts.rules_from_spec("no_such_rule")


def test_journal_readers_match_reference(trials, tmp_path):
    """The follower, the watch snapshot and the run decomposition of a
    port journal (with a parked chunk and incidents) equal the JAX
    package's readers' on the same directory."""
    from test_torch_survey import _integrity
    from riptide_tpu_torch.survey.scheduler import CircuitBreaker

    _schedule("port", trials, tmp_path, "raise:0x9,bitflip:1",
              breaker=CircuitBreaker(failure_threshold=5),
              integrity=_integrity("port", "probe", 1))
    ours = report.JournalFollower(str(tmp_path)).poll()
    ref = ref_report.JournalFollower(str(tmp_path)).poll()
    assert ours == ref
    assert sorted(ours["parked"]) == [0]
    beats = report.read_heartbeats(str(tmp_path))
    assert beats == ref_report.read_heartbeats(str(tmp_path))
    assert report.watch_snapshot(ours, heartbeats=beats, now=1e10) == \
        ref_report.watch_snapshot(ref, heartbeats=beats, now=1e10)
    timings = [rec["timings"] for rec in ours["chunks"].values()]
    assert report.run_decomposition_from_chunks(timings) == \
        ref_report.run_decomposition_from_chunks(timings)


def test_scheduler_status_document(trials, tmp_path):
    from riptide_tpu_torch.pipeline.batcher import BatchSearcher
    from riptide_tpu_torch.survey.journal import SurveyJournal
    from riptide_tpu_torch.survey.scheduler import SurveyScheduler
    from test_torch_survey import DERED, SEARCH_CONF

    sched = SurveyScheduler(
        BatchSearcher(DERED, SEARCH_CONF, fmt="presto", io_threads=1,
                      device="cpu"),
        [[f] for f in trials[:2]], journal=SurveyJournal(tmp_path),
        metrics=MetricsRegistry())
    sched.run()
    st = sched.status()
    assert (st["chunks_total"], st["chunks_done"], st["running"]) == \
        (2, 2, False)
    assert "0" in st["heartbeat_age_s"] and "fleet" in st
