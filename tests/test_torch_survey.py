"""
The port's checkpointed survey path (``riptide_tpu_torch.survey``)
against the JAX package's, on the CPU.

* **Journal format**: the fsio framing gives the JAX package's bytes for
  the same records, and each package's ``SurveyJournal`` reads a journal
  the other's pipeline wrote: the same completed chunk ids, peak rows,
  parked ids and incidents.
* **Journaled pipeline**: configs A and B through both packages'
  ``rffa --journal``; the port's products are its unjournaled run's
  bits, its peaks the JAX journaled run's (peak lists equal but the
  S/N, rtol 1e-5), and an ``abort:1`` + resume gives the same bytes
  with chunk 0 replayed.
* **Fault kinds**: each scheduler and storage kind runs through both
  packages' schedulers on the same spec and tiny survey (16 s at 1 ms,
  64-71 bins), and the counters and incidents agree; the survey still
  gives the fault-free peaks. ``peer_loss`` and ``cache_corrupt`` are
  refused.
* **rseek** ``--journal``/``--resume``/``--fault-inject`` and the
  data-quality provenance a resume restores from the journal.

Both packages run on the uint6 wire (``RIPTIDE_WIRE_DTYPE=uint6
RIPTIDE_FFA_PATH=gather``), as ``tests/test_torch_pipeline.py`` runs
them.
"""
import csv
import json
import os

import numpy as np
import pytest
import yaml

import riptide_tpu.pipeline as ref_pipeline
import riptide_tpu_torch.pipeline as port_pipeline
from riptide_tpu.pipeline.batcher import BatchSearcher as RefSearcher
from riptide_tpu.survey import faults as ref_faults
from riptide_tpu.survey import scheduler as ref_sched
from riptide_tpu.survey.journal import SurveyJournal as RefJournal
from riptide_tpu.survey.metrics import get_metrics as ref_metrics
from riptide_tpu.utils import fsio as ref_fsio
from riptide_tpu_torch.pipeline.batcher import BatchSearcher
from riptide_tpu_torch.quality import QualityReport
from riptide_tpu_torch.survey import faults, scheduler
from riptide_tpu_torch.survey.journal import SurveyJournal
from riptide_tpu_torch.survey.metrics import get_metrics
from riptide_tpu_torch.utils import fsio

from synth import generate_data_presto

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = {"A": os.path.join(HERE, "pipeline_config_A.yml"),
           "B": os.path.join(HERE, "pipeline_config_B.yml")}
WIRE_ENV = {"RIPTIDE_WIRE_DTYPE": "uint6", "RIPTIDE_FFA_PATH": "gather"}
SNR_RTOL = 1e-5
PRODUCTS = ("peaks.csv", "clusters.csv", "candidates.csv")
DERED = {"rmed_width": 4.0, "rmed_minpts": 101}
SEARCH_CONF = [{
    "ffa_search": {"period_min": 0.3, "period_max": 1.2,
                   "bins_min": 64, "bins_max": 71},
    "find_peaks": {"smin": 6.0},
}]
# The counters a fault moves, compared between the packages.
COUNTERS = ("chunks_done", "chunks_retried", "chunks_skipped",
            "chunks_timed_out", "chunks_parked", "breaker_opens",
            "device_errors", "integrity_checks", "integrity_mismatches",
            "shadow_probes", "incidents")


@pytest.fixture(autouse=True)
def _wire(monkeypatch):
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)


def _fast_retry(pkg, max_retries=3):
    return pkg.RetryPolicy(max_retries=max_retries, base_s=0.01, cap_s=0.02,
                           sleep=lambda s: None)


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    """Three single-file chunks: DM 0, 5 and 10 (16 s at 1 ms)."""
    root = tmp_path_factory.mktemp("trials")
    return [generate_data_presto(str(root), f"t{i}_DM{dm:.2f}", tobs=16.0,
                                 tsamp=1e-3, period=0.5, dm=dm,
                                 amplitude=amp)
            for i, (dm, amp) in enumerate([(0.0, 15.0), (5.0, 25.0),
                                           (10.0, 15.0)])]


def _port_searcher():
    return BatchSearcher(DERED, SEARCH_CONF, fmt="presto", io_threads=1,
                         device="cpu")


def _ref_searcher():
    return RefSearcher(DERED, SEARCH_CONF, fmt="presto", io_threads=1)


def _rows(peaks):
    return [tuple(p) for p in peaks]


def _schedule(pkg, trials, jdir, spec, **kw):
    """One scheduler run of ``pkg`` ("port" or "ref") over ``trials`` as
    single-file chunks: (peaks or the exception, counters, incident
    kinds, journal)."""
    port = pkg == "port"
    sched_mod = scheduler if port else ref_sched
    fault_mod = faults if port else ref_faults
    metrics = get_metrics() if port else ref_metrics()
    journal = (SurveyJournal if port else RefJournal)(jdir)
    metrics.reset()
    kw.setdefault("retry", _fast_retry(sched_mod))
    plan = fault_mod.FaultPlan.parse(spec, **kw.pop("plan_kw", {}))
    run = sched_mod.SurveyScheduler(
        _port_searcher() if port else _ref_searcher(), [[f] for f in trials],
        journal=journal, faults=plan, **kw)
    try:
        out = run.run()
    except Exception as err:
        out = err
    counts = {k: int(metrics.counter(k)) for k in COUNTERS}
    kinds = [rec["incident"] for rec in journal.incidents()]
    return out, counts, kinds, journal


@pytest.fixture(scope="module")
def clean(trials, tmp_path_factory):
    """The fault-free survey of both packages."""
    root = tmp_path_factory.mktemp("clean")
    with pytest.MonkeyPatch.context() as mp:
        for key, value in WIRE_ENV.items():
            mp.setenv(key, value)
        return {pkg: _schedule(pkg, trials, root / pkg, "")[0]
                for pkg in ("port", "ref")}


def _both(trials, tmp_path, spec, **kw):
    port = _schedule("port", trials, tmp_path / "port", spec, **kw)
    ref = _schedule("ref", trials, tmp_path / "ref", spec, **kw)
    return port, ref


def assert_peaks_match(port_peaks, ref_peaks):
    assert len(port_peaks) == len(ref_peaks) > 0
    for p, r in zip(port_peaks, ref_peaks):
        p, r = p._asdict(), r._asdict()
        assert p.pop("snr") == pytest.approx(r.pop("snr"), rel=SNR_RTOL)
        assert p == r


def test_clean_survey_matches_reference(clean):
    assert_peaks_match(clean["port"], clean["ref"])


# ----------------------------------------------------------- journal format

def test_fsio_framing_is_the_reference_bytes(tmp_path):
    records = [{"kind": "chunk", "chunk_id": 3, "dms": [0.1, 2.5e-7]},
               {"kind": "incident", "detail": {"a": [1, "x"]}}]
    for checksum in (True, False):
        for obj in records:
            line = json.dumps(obj, separators=(",", ":")).encode()
            assert fsio.encode_record_line(line, checksum) == \
                ref_fsio.encode_record_line(line, checksum)
        fsio.append_jsonl(tmp_path / f"port{checksum}", records,
                          checksum=checksum)
        ref_fsio.append_jsonl(tmp_path / f"ref{checksum}", records,
                              checksum=checksum)
        assert (tmp_path / f"port{checksum}").read_bytes() == \
            (tmp_path / f"ref{checksum}").read_bytes()
    assert set(fsio.SITES) < set(ref_fsio.SITES)
    assert fsio.split_checksum(b'{"a":1} #00000000') == \
        ref_fsio.split_checksum(b'{"a":1} #00000000')


def test_journal_records_are_the_reference_bytes(tmp_path, monkeypatch,
                                                 clean):
    """The same header, chunk, parked, incident and metrics records
    written through both journals give the same two files."""
    from riptide_tpu.survey import journal as ref_journal_mod
    from riptide_tpu_torch.survey import journal as journal_mod

    for mod in (journal_mod, ref_journal_mod):
        monkeypatch.setattr(mod, "_utc_iso", lambda: "2026-01-01T00:00:00Z")
    peaks = clean["port"][:5]
    for name, cls in (("port", SurveyJournal), ("ref", RefJournal)):
        j = cls(tmp_path / name)
        j.write_header("sid", 3)
        j.record_chunk(0, ["a.inf"], [0.5], peaks, wire_digest="ab",
                       timings={"chunk_s": 1.0}, attempts=2,
                       dq={"masked_samples": 0},
                       extra={"integrity": {"v": 1}})
        j.record_parked(1, "circuit open", files=["b.inf"])
        j.record_incident({"kind": "incident", "incident": "x",
                           "utc": "2026-01-01T00:00:00Z"})
        j.record_metrics({"chunks_done": 1})
    for fname in ("journal.jsonl", "peaks.jsonl"):
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "ref" / fname).read_bytes()


def _read_back(journal):
    done = journal.completed_chunks()
    return ({cid: (rec["files"], _rows(peaks))
             for cid, (rec, peaks) in done.items()},
            sorted(journal.parked_chunks()),
            [(r["incident"], r.get("chunk_id")) for r in journal.incidents()])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journals_read_each_other(trials, tmp_path, writer):
    """A journal written by one package's scheduler (an aborted run with
    a parked chunk and incidents) reads back the same through both
    packages' SurveyJournal."""
    out = _schedule(writer, trials, tmp_path / "j",
                    "raise:0x9,bitflip:1,abort:2",
                    breaker=(scheduler if writer == "port" else ref_sched)
                    .CircuitBreaker(failure_threshold=5),
                    integrity=_integrity(writer, "probe", 1))
    assert isinstance(out[0], (faults.FaultAbort, ref_faults.FaultAbort))
    port_view = _read_back(SurveyJournal(tmp_path / "j"))
    ref_view = _read_back(RefJournal(tmp_path / "j"))
    assert port_view == ref_view
    done, parked, kinds = port_view
    assert sorted(done) == [1] and parked == [0]
    assert ("result_mismatch", 1) in kinds and ("chunk_parked", 0) in kinds


def _integrity(pkg, mode, every):
    """An integrity config of ``pkg`` whose canary is unpinned in both
    packages (the JAX package's checked-in CPU pin is not current, so a
    quarantine would run its canary against a stale digest)."""
    from riptide_tpu.survey.integrity import IntegrityConfig as RefConfig
    from riptide_tpu_torch.survey.integrity import IntegrityConfig

    return (IntegrityConfig if pkg == "port" else RefConfig)(
        mode, every, canary_pin=os.devnull)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_resume_from_the_other_packages_journal(trials, tmp_path, clean,
                                                writer, reader):
    """A survey aborted under one package resumes under the other: the
    completed chunk is replayed, the rest searched, and the peaks are
    the resuming package's clean run's."""
    out = _schedule(writer, trials, tmp_path, "abort:1")
    assert sorted(out[3].completed_chunks()) == [0]
    peaks, counts, _, _ = _schedule(reader, trials, tmp_path, "",
                                    resume=True)
    assert counts["chunks_skipped"] == 1 and counts["chunks_done"] == 2
    assert _rows(peaks[len(out[3].completed_chunks()[0][1]):]) == \
        _rows(clean[reader][len(out[3].completed_chunks()[0][1]):])


# ------------------------------------------------------------- fault kinds

def _compare(port, ref):
    assert port[1] == ref[1]
    assert port[2] == ref[2]


@pytest.mark.parametrize("spec,moved", [
    ("raise:1", {"chunks_retried": 1}),
    ("stall:0:0.01", {}),
    ("corrupt:0", {"chunks_retried": 1}),
    ("straggle:2:0.05", {}),
    ("device_error:1", {"chunks_retried": 1, "device_errors": 1}),
])
def test_transient_fault_matches_reference(trials, tmp_path, clean, spec,
                                           moved):
    port, ref = _both(trials, tmp_path, spec)
    _compare(port, ref)
    for key, value in moved.items():
        assert port[1][key] == value, key
    assert port[1]["chunks_done"] == 3
    assert _rows(port[0]) == _rows(clean["port"])
    assert_peaks_match(port[0], ref[0])
    attempts = {cid: rec["attempts"] for cid, (rec, _)
                in port[3].completed_chunks().items()}
    assert attempts == {cid: rec["attempts"] for cid, (rec, _)
                        in ref[3].completed_chunks().items()}


def test_corrupt_fires_before_the_copy_is_queued(trials, tmp_path,
                                                 monkeypatch):
    """The digest mismatch is caught before any copy of the corrupted
    wire is shipped: chunk 0 ships once (its re-prepared wire), not
    twice."""
    from riptide_tpu_torch.pipeline import batcher

    shipped = []
    ship = batcher.ship_stage_data

    def counting(prepared, device):
        shipped.append(prepared[0][0, 0, 0] if prepared[0].ndim == 3
                       else None)
        return ship(prepared, device)

    monkeypatch.setattr(batcher, "ship_stage_data", counting)
    out = _schedule("port", trials[:1], tmp_path, "corrupt:0")
    assert out[1]["chunks_retried"] == 1
    assert len(shipped) == 1


def test_exhausted_device_errors_match_reference(trials, tmp_path):
    port, ref = _both(trials, tmp_path, "device_error:0x9",
                      retry=None, plan_kw={})
    assert isinstance(port[0], faults.InjectedDeviceError)
    assert isinstance(ref[0], ref_faults.InjectedDeviceError)
    _compare(port, ref)
    assert "device_error" in port[2]


def test_breaker_parks_and_resume_completes(trials, tmp_path, clean):
    """Exhausted retries under a circuit breaker park the chunk; the
    counters match the JAX scheduler's, and a resume completes it to the
    clean peaks."""
    port = _schedule("port", trials, tmp_path / "port", "raise:0x9",
                     breaker=scheduler.CircuitBreaker(failure_threshold=5))
    ref = _schedule("ref", trials, tmp_path / "ref", "raise:0x9",
                    breaker=ref_sched.CircuitBreaker(failure_threshold=5))
    _compare(port, ref)
    assert port[1]["chunks_parked"] == 1
    assert sorted(port[3].parked_chunks()) == [0]
    resumed = _schedule("port", trials, tmp_path / "port", "", resume=True)
    assert resumed[1]["chunks_skipped"] == 2
    assert _rows(resumed[0]) == _rows(clean["port"])


def test_abort_and_resume_match_reference(trials, tmp_path, clean):
    port, ref = _both(trials, tmp_path, "abort:1")
    assert isinstance(port[0], faults.FaultAbort)
    _compare(port, ref)
    assert sorted(port[3].completed_chunks()) == [0]
    port2 = _schedule("port", trials, tmp_path / "port", "", resume=True)
    ref2 = _schedule("ref", trials, tmp_path / "ref", "", resume=True)
    _compare(port2, ref2)
    assert port2[1]["chunks_skipped"] == 1
    assert _rows(port2[0]) == _rows(clean["port"])


def test_kill_at_journal_append_recovers_torn_tail(trials, tmp_path,
                                                   clean):
    """``kill_at:journal_append:3`` writes half of the third journal
    append (chunk 0's record, after the header and chunk 0's peaks are
    on disk) and exits; the resume truncates the torn tail and the
    orphaned peak rows (``storage_recovered``), re-searches every chunk
    and gives the clean peaks. Both packages journal the same
    recovery."""
    class Killed(Exception):
        pass

    def die(code):
        raise Killed(code)

    views = {}
    for pkg in ("port", "ref"):
        jdir = tmp_path / pkg
        out = _schedule(pkg, trials, jdir, "kill_at:journal_append:2",
                        plan_kw={"exit": die})
        assert isinstance(out[0], Killed)
        raw = (jdir / "journal.jsonl").read_bytes()
        assert not raw.endswith(b"\n")          # a genuinely torn tail
        again = _schedule(pkg, trials, jdir, "", resume=True)
        views[pkg] = (again[1], again[2])
        assert _rows(again[0]) == _rows(clean[pkg])
    assert views["port"] == views["ref"]
    assert "storage_recovered" in views["port"][1]


def test_storage_faults_on_observability_writes_are_not_fatal(
        trials, tmp_path, monkeypatch):
    """torn_write, enospc and fsync_fail on the heartbeat and trace
    sites degrade to obs_write_failed incidents; the survey completes,
    as in the JAX package."""
    from riptide_tpu.obs import trace as ref_trace
    from riptide_tpu_torch.obs import trace

    spec = ("fsync_fail:heartbeat_append,enospc:trace_export,"
            "torn_write:heartbeat_append:2")
    trace.enable()
    ref_trace.enable()
    try:
        port, ref = _both(trials, tmp_path, spec)
    finally:
        trace.disable()
        ref_trace.disable()
    _compare(port, ref)
    assert port[1]["chunks_done"] == 3
    assert port[2].count("obs_write_failed") == 3


@pytest.mark.parametrize("spec", ["peer_loss:3",
                                  "cache_corrupt:exec_cache_store"])
def test_unported_kinds_are_refused(spec):
    kind = spec.split(":")[0]
    with pytest.raises(ValueError, match="waits for"):
        faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError, match=kind):
        port_pipeline.Pipeline(_config("A"), device="cpu", fault_spec=spec)


def test_fault_grammar_matches_reference():
    spec = ("raise:2x3,stall:1:0.5,corrupt:0,abort:3,nan_inject:0:0.1x2,"
            "oom:4,hang:2:5,straggle:1:0.2,device_error:2x9,bitflip:1x3,"
            "kill_at:journal_append:3,torn_write:ledger_append,"
            "enospc:trace_export,fsync_fail:heartbeat_append")
    assert faults.FaultPlan.parse(spec)._directives == \
        ref_faults.FaultPlan.parse(spec)._directives
    for bad in ("raise", "nope:1", "kill_at:nowhere",
                "kill_at:journal_append:0"):
        with pytest.raises(ValueError):
            ref_faults.FaultPlan.parse(bad)
        with pytest.raises(ValueError):
            faults.FaultPlan.parse(bad)


# --------------------------------------------------------- sticky CUDA errors

def test_sticky_device_error_stops_the_run_for_a_resume(trials, tmp_path,
                                                        monkeypatch, clean):
    """A device error after which the CUDA context fails its check ends
    the run with a non-retryable StickyDeviceError and a journaled
    device_error incident (no retry in the same process); ``--resume``
    in a fresh scheduler continues the survey to the clean peaks."""
    monkeypatch.setattr(scheduler, "context_usable", lambda device: False)
    out = _schedule("port", trials, tmp_path, "device_error:1")
    assert isinstance(out[0], scheduler.StickyDeviceError)
    assert out[0].retryable is False
    assert out[1]["chunks_retried"] == 0 and out[1]["device_errors"] == 1
    assert out[2] == ["device_error"]
    assert sorted(out[3].completed_chunks()) == [0]
    monkeypatch.undo()
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "uint6")
    resumed = _schedule("port", trials, tmp_path, "", resume=True)
    assert resumed[1]["chunks_skipped"] == 1
    assert _rows(resumed[0]) == _rows(clean["port"])


def test_rseek_stops_on_a_sticky_device_error(trials, monkeypatch):
    monkeypatch.setattr(scheduler, "context_usable", lambda device: False)
    with pytest.raises(scheduler.StickyDeviceError):
        _rseek(trials[1], ["--fault-inject", "device_error:0"])


def test_context_check_is_a_no_op_off_the_card():
    assert scheduler.context_usable("cpu")
    assert scheduler.context_usable(None)


# ------------------------------------------------- journaled pipeline (A, B)

def _config(name):
    with open(CONFIGS[name]) as fobj:
        return yaml.safe_load(fobj)


@pytest.fixture(scope="module")
def survey_files(tmp_path_factory):
    """Three PRESTO DM trials (DM 0, 10, 20; 64 s at 256 us), the
    pulsar brightest at DM 10."""
    root = tmp_path_factory.mktemp("survey")
    return [generate_data_presto(str(root), f"fake_DM{dm:.2f}", tobs=64.0,
                                 tsamp=256e-6, period=1.0, dm=dm,
                                 amplitude=amp, ducy=0.02)
            for dm, amp in ((0.0, 10.0), (10.0, 20.0), (20.0, 10.0))]


def _run_cli(pkg, config, files, outdir, extra=()):
    outdir.mkdir(parents=True, exist_ok=True)
    argv = ["--config", CONFIGS[config], "--outdir", str(outdir),
            "--log-level", "WARNING", *extra, *[str(f) for f in files]]
    pkg.run_program(pkg.get_parser().parse_args(argv))
    return outdir


@pytest.fixture(scope="module")
def journaled(survey_files, tmp_path_factory):
    """Configs A and B: the port unjournaled and journaled, the JAX
    package journaled."""
    root = tmp_path_factory.mktemp("journaled")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, value in WIRE_ENV.items():
            mp.setenv(key, value)
        for name in CONFIGS:
            cpu = ("--device", "cpu")
            out[name, "plain"] = _run_cli(port_pipeline, name, survey_files,
                                          root / name / "plain", cpu)
            out[name, "port"] = _run_cli(
                port_pipeline, name, survey_files, root / name / "port",
                cpu + ("--journal", str(root / name / "port_j")))
            out[name, "ref"] = _run_cli(
                ref_pipeline, name, survey_files, root / name / "ref",
                ("--journal", str(root / name / "ref_j")))
            out[name, "port_j"] = root / name / "port_j"
            out[name, "ref_j"] = root / name / "ref_j"
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("product", PRODUCTS)
def test_journaled_products_are_the_unjournaled_bits(journaled, config,
                                                     product):
    plain = (journaled[config, "plain"] / product).read_bytes()
    assert plain
    assert (journaled[config, "port"] / product).read_bytes() == plain


def _csv(path):
    with open(path, newline="") as fobj:
        return list(csv.DictReader(fobj))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_journaled_peaks_match_reference(journaled, config):
    port = _csv(journaled[config, "port"] / "peaks.csv")
    ref = _csv(journaled[config, "ref"] / "peaks.csv")
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert float(p.pop("snr")) == pytest.approx(float(r.pop("snr")),
                                                    rel=SNR_RTOL)
        assert p == r
    port_j = SurveyJournal(journaled[config, "port_j"])
    ref_j = RefJournal(journaled[config, "ref_j"])
    assert sorted(port_j.completed_chunks()) == \
        sorted(ref_j.completed_chunks())
    for cid, (rec, peaks) in port_j.completed_chunks().items():
        ref_rec, ref_peaks = ref_j.completed_chunks()[cid]
        assert rec["files"] == ref_rec["files"]
        assert rec["dq"] == ref_rec["dq"]
        assert_peaks_match(peaks, ref_peaks)
    assert port_j.survey_id() == ref_j.survey_id()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pipeline_abort_and_resume_are_byte_identical(journaled,
                                                      survey_files,
                                                      tmp_path, config):
    """``abort:1`` stops the journaled pipeline after chunk 0 with no
    products; ``resume=True`` replays chunk 0 (its data-quality
    provenance restored from the journal) and gives the uninterrupted
    run's bytes."""
    jdir = tmp_path / "j"
    out = tmp_path / "out"
    with pytest.raises(faults.FaultAbort):
        _run_cli(port_pipeline, config, survey_files, out,
                 ("--device", "cpu", "--journal", str(jdir),
                  "--fault-inject", "abort:1"))
    assert sorted(SurveyJournal(jdir).completed_chunks()) == [0]
    assert not (out / "peaks.csv").exists()
    get_metrics().reset()
    _run_cli(port_pipeline, config, survey_files, out,
             ("--device", "cpu", "--journal", str(jdir), "--resume"))
    assert get_metrics().counter("chunks_skipped") == 1
    for product in PRODUCTS:
        assert (out / product).read_bytes() == \
            (journaled[config, "plain"] / product).read_bytes()


def test_resume_requires_a_journal():
    with pytest.raises(ValueError, match="journal"):
        port_pipeline.Pipeline(_config("A"), device="cpu", resume=True)


def test_rffa_parser_has_the_survey_flags():
    args = port_pipeline.get_parser().parse_args(
        ["-c", "conf.yaml", "--journal", "jdir", "--resume", "--trace",
         "--fault-inject", "raise:2", "x.inf"])
    assert (args.journal, args.resume, args.trace, args.fault_inject) == \
        ("jdir", True, True, "raise:2")


def test_liveness_section_builds_the_reference_policies():
    conf = dict(_config("A"), liveness={
        "watchdog_k": 3.0, "watchdog_floor_s": 2.0, "watchdog_cap_s": 50.0,
        "watchdog_initial_s": 9.0, "breaker_threshold": 4,
        "breaker_cooldown_s": 7.0, "retry_deadline_s": 30.0})
    port = port_pipeline.Pipeline(conf, device="cpu")
    ref = ref_pipeline.Pipeline(conf)
    for attr in ("k", "floor_s", "cap_s", "initial_s"):
        assert getattr(port.watchdog, attr) == getattr(ref.watchdog, attr)
    assert port.breaker.failure_threshold == ref.breaker.failure_threshold
    assert port.breaker.cooldown_s == ref.breaker.cooldown_s
    assert port.retry.deadline_s == ref.retry.deadline_s
    off = port_pipeline.Pipeline(dict(conf, liveness={"enabled": False}),
                                 device="cpu")
    assert (off.watchdog, off.breaker, off.retry) == (None, None, None)


# ------------------------------------------------------- data-quality replay

def test_quality_report_round_trips_like_the_reference():
    from riptide_tpu.quality import QualityReport as RefReport

    rep = QualityReport(1000, fname="/x/a.inf", dm=3.5)
    rep.n_nonfinite, rep.n_masked, rep.quarantined = 7, 70, True
    rep.reasons = ["nan block"]
    ref = RefReport(1000, fname="/x/a.inf", dm=3.5)
    ref.n_nonfinite, ref.n_masked, ref.quarantined = 7, 70, True
    ref.reasons = ["nan block"]
    assert rep.to_dict() == ref.to_dict()
    back = QualityReport.from_dict(rep.to_dict())
    assert back.to_dict() == rep.to_dict()


def test_chunk_dq_summary_matches_reference(trials):
    port, ref = _port_searcher(), _ref_searcher()
    for searcher in (port, ref):
        for f in trials[:2]:
            searcher.load_prepared(f, search=False)
    summary = port.chunk_dq_summary(trials[:2])
    assert summary == ref.chunk_dq_summary(trials[:2])
    fresh = _port_searcher()
    fresh.restore_dq_reports(summary)
    assert {k: r.to_dict() for k, r in fresh.dq_reports.items()} == \
        {k: r.to_dict() for k, r in port.dq_reports.items()}


# ------------------------------------------------------------------- rseek

def _rseek(fname, extra=()):
    from riptide_tpu_torch.apps import rseek

    args = rseek.get_parser().parse_args(
        ["-f", "presto", "--Pmin", "0.4", "--Pmax", "1.2", "--bmin", "64",
         "--bmax", "71", "--device", "cpu", *extra, str(fname)])
    return rseek.run_program(args)


def _text(table):
    from riptide_tpu_torch.apps import rseek

    return table.to_string(columns=rseek.COLUMNS, formatters=rseek.FORMATTERS)


def test_rseek_journal_resume_and_retry(trials, tmp_path, monkeypatch):
    from riptide_tpu_torch.apps import rseek

    jdir = str(tmp_path / "j")
    first = _rseek(trials[1], ["--journal", jdir])
    assert first is not None
    assert sorted(SurveyJournal(jdir).completed_chunks()) == [0]
    # The JAX package reads the port's rseek journal.
    assert _rows(RefJournal(jdir).completed_chunks()[0][1]) == \
        _rows(SurveyJournal(jdir).completed_chunks()[0][1])

    def no_search(*a, **kw):
        raise AssertionError("resume must not re-search")

    with monkeypatch.context() as mp:
        mp.setattr(rseek, "_search_peaks", no_search)
        again = _rseek(trials[1], ["--journal", jdir, "--resume"])
    assert _text(again) == _text(first)
    get_metrics().reset()
    retried = _rseek(trials[1], ["--fault-inject", "raise:0",
                                 "--deadline-s", "60"])
    assert get_metrics().counter("chunks_retried") == 1
    assert _text(retried) == _text(first)
    with pytest.raises(ValueError, match="journal"):
        _rseek(trials[1], ["--resume"])


def test_rseek_trace_writes_a_chrome_trace(trials, tmp_path):
    from riptide_tpu_torch.obs import trace

    jdir = tmp_path / "j"
    try:
        _rseek(trials[1], ["--journal", str(jdir), "--trace"])
    finally:
        trace.disable()
    doc = json.loads((jdir / "trace.json").read_text())
    names = {ev["name"] for ev in doc["traceEvents"] if ev["ph"] == "X"}
    assert {"prep", "wire"} <= names
