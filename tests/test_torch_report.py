"""
The port's report readers and CLIs (``riptide_tpu_torch/obs/report.py``,
``apps/rreport.py``, ``apps/rtop.py``, ``apps/rwatch.py``) against the
JAX package's ``obs/report.py`` and ``tools/``, on the CPU.

Over a journaled survey written by each package, a faulted port journal
(a parked chunk, incidents, integrity blocks, a trace), the JAX
package's torn-trace fixture and its pre-PR-9 journal: the port's
``build_report`` equals the JAX package's key for key and
``render_text`` string for string; ``compare_to_ledger`` and
``latest_platform`` give the same verdicts on shared row sets, and on a
ledger mixing the port's ``cuda`` rows with ``tpu`` rows neither
platform baselines the other; the three CLIs, run by path in a
subprocess where ``torch`` and ``jax`` cannot be imported, give the
tools' exit codes and output (ages and stamps masked).
"""
import json
import os
import re
import subprocess
import sys
import time

import pytest

from riptide_tpu.obs import report as ref_report
from riptide_tpu.survey.journal import SurveyJournal as RefJournal
from riptide_tpu_torch.obs import report
from riptide_tpu_torch.survey.scheduler import CircuitBreaker

from test_report import _write_pre_pr9_journal
from test_torch_survey import WIRE_ENV, _integrity, _schedule
from test_torch_survey import trials  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = os.path.join(REPO, "riptide_tpu_torch", "apps")
TOOLS = os.path.join(REPO, "tools")
NOW = 1.9e9
CARD = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3"}
TPU = {"backend": "tpu", "device_kind": "TPU v5 lite"}


@pytest.fixture(autouse=True)
def _wire(monkeypatch):
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)


def _torn_trace(root):
    """The JAX package's torn-trace fixture: one chunk, a trace.json cut
    off mid-write."""
    from riptide_tpu.peak_detection import Peak

    j = RefJournal(os.path.join(root, "torn"))
    j.write_header("t", 1)
    j.record_chunk(0, ["a.inf"], [0.0],
                   [Peak(period=0.5, freq=2.0, width=3, ducy=0.05, iw=1,
                         ip=7, snr=10.0, dm=0.0)],
                   timings={"chunk_s": 1.0})
    with open(os.path.join(j.directory, "trace.json"), "w") as f:
        f.write('{"traceEvents": [{"ph": "X", "na')
    return j.directory


@pytest.fixture(scope="module")
def journals(trials, tmp_path_factory):  # noqa: F811
    """{name: journal directory}: a clean survey of each package, a
    faulted and traced port survey, the torn-trace and pre-PR-9
    fixtures."""
    from riptide_tpu_torch.obs import trace

    root = tmp_path_factory.mktemp("journals")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for key, value in WIRE_ENV.items():
            mp.setenv(key, value)
        for pkg in ("port", "ref"):
            out[pkg] = str(root / pkg)
            _schedule(pkg, trials, out[pkg], "")
        out["faulted"] = str(root / "faulted")
        trace.enable()
        try:
            _schedule("port", trials, out["faulted"], "raise:0x9,bitflip:1",
                      breaker=CircuitBreaker(failure_threshold=5),
                      integrity=_integrity("port", "probe", 1))
        finally:
            trace.disable()
    out["torn"] = _torn_trace(str(root))
    out["pre_pr9"] = _write_pre_pr9_journal(root)
    return out


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' readers read the same ``time.time()``."""
    monkeypatch.setattr(time, "time", lambda: NOW)


NAMES = ("port", "ref", "faulted", "torn", "pre_pr9")


@pytest.mark.parametrize("name", NAMES)
def test_build_report_equals_reference(journals, fixed_clock, name):
    ours = report.build_report(journals[name])
    ref = ref_report.build_report(journals[name])
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key] == ref[key], key


@pytest.mark.parametrize("name", NAMES)
def test_render_text_equals_reference(journals, fixed_clock, name):
    text = report.render_text(report.build_report(journals[name]))
    assert text == ref_report.render_text(
        ref_report.build_report(journals[name]))
    assert text.startswith("survey ")


def test_reports_show_what_the_journals_hold(journals, fixed_clock):
    clean = report.build_report(journals["port"])
    assert clean["chunks_done"] == 3 and not clean["phase_sum_violations"]
    faulted = report.build_report(journals["faulted"])
    assert sorted(faulted["parked"]) == [0]
    kinds = {i["incident"] for i in faulted["incidents"]}
    assert {"chunk_parked", "result_mismatch"} <= kinds
    assert faulted["integrity"]["mismatch_incidents"] == 1
    assert faulted["trace"]["span_counts"]["chunk"] >= 2
    assert "trace.json" in report.build_report(
        journals["torn"])["trace_error"]
    old = report.build_report(journals["pre_pr9"])
    assert old["run"]["nchunks"] == 0 and old["chunks_done"] == 2


def _row(dev, platform, kind="survey", n=4, bound="device", sid=None):
    return {"kind": kind, "survey_id": sid, "device_s": dev * n,
            "nchunks": n, "bound_counts": {bound: n},
            "platform": dict(platform)}


def _ledgers(journals):
    """Shared row sets: the clean surveys' own decompositions as rows,
    a ledger of the port's card rows and one mixing card and TPU rows."""
    runs = [report.build_report(journals[p])["run"] for p in ("port", "ref")]
    card = [_row(1.0, CARD), _row(1.1, CARD), _row(0.9, CARD),
            _row(5.0, CARD, kind="bench"),
            _row(50.0, CARD, bound="tunnel")]
    mixed = [_row(100.0, TPU), _row(110.0, TPU), _row(105.0, TPU)] + card
    return runs, {"card": card, "mixed": mixed,
                  "mixed_tpu_last": card + [_row(100.0, TPU),
                                            _row(104.0, TPU)],
                  "runs": [dict(r, kind="survey",
                                platform={"backend": "cpu",
                                          "device_kind": "cpu"})
                           for r in runs]}


def test_compare_to_ledger_equals_reference(journals):
    runs, ledgers = _ledgers(journals)
    currents = runs + [_row(1.0, CARD), _row(4.0, CARD), _row(105.0, TPU),
                       _row(4.0, CARD, bound="tunnel"), {"nchunks": 4}]
    for rows in ledgers.values():
        for kind in (None, "survey"):
            for scope in (None, "auto", CARD, TPU):
                platform = (report.latest_platform(rows, kind=kind)
                            if scope == "auto" else scope)
                assert platform == (ref_report.latest_platform(rows,
                                                               kind=kind)
                                    if scope == "auto" else scope)
                for cur in currents:
                    for tol in ((0.15, 3.0), (0.5, 1.0)):
                        got = report.compare_to_ledger(
                            cur, rows, *tol, kind=kind, platform=platform)
                        want = ref_report.compare_to_ledger(
                            cur, rows, *tol, kind=kind, platform=platform)
                        assert got == want
    for sid in ("s", None, "absent"):
        rows = [_row(1.0, CARD, sid="s"), _row(2.0, CARD, sid="o"),
                _row(3.0, CARD, sid="s")]
        assert report.drop_own_row(rows, sid) == \
            ref_report.drop_own_row(rows, sid)


def test_card_and_tpu_rows_never_baseline_each_other(journals):
    _, ledgers = _ledgers(journals)
    mixed = ledgers["mixed"]
    assert report.latest_platform(mixed, kind="survey") == CARD
    # A 4x regression on the card: the TPU rows' 100 s/chunk would hide
    # it unscoped, and are excluded once scoped.
    v, rc = report.compare_to_ledger(_row(4.0, CARD), mixed)
    assert rc == 0 and v["verdict"] == "ok"
    v, rc = report.compare_to_ledger(_row(4.0, CARD), mixed, kind="survey",
                                     platform=CARD)
    assert rc == 1 and v["verdict"] == "regression"
    assert v["baseline_n"] == 3 and v["excluded_scope_rows"] == 4
    # The other way round: a TPU run is judged by the TPU rows alone.
    tpu_last = ledgers["mixed_tpu_last"]
    assert report.latest_platform(tpu_last, kind="survey") == TPU
    v, rc = report.compare_to_ledger(_row(104.0, TPU), tpu_last,
                                     kind="survey", platform=TPU)
    assert rc == 0 and v["verdict"] == "ok"
    assert v["baseline_median"] == 102.0
    assert v["excluded_scope_rows"] == 5


# ----------------------------------------------------------- the CLIs

_AGE = re.compile(r"\d+(?:\.\d+)?s (ago|old)")
_UTC = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d+Z")


def _masked(text):
    return _UTC.sub("<utc>", _AGE.sub(r"<age> \1", text))


def _by_path(script, args, cwd):
    """Run ``script`` by path in a fresh interpreter where torch and jax
    cannot be imported; (exit code, stdout, stderr)."""
    code = ("import runpy, sys\n"
            "for name in ('torch', 'jax', 'jaxlib'):\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = [{script!r}] + {list(args)!r}\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout, proc.stderr


def _both(tool, args, tmp_path):
    port = _by_path(os.path.join(APPS, f"{tool}.py"), args, str(tmp_path))
    ref = _by_path(os.path.join(TOOLS, f"{tool}.py"), args, str(tmp_path))
    assert "Traceback" not in port[2], port[2]
    return port, ref


CLI_CASES = [
    ("rreport", "port", []), ("rreport", "faulted", []),
    ("rreport", "pre_pr9", []), ("rreport", "torn", []),
    ("rreport", "faulted", ["--quiet", "--json", "-"]),
    ("rreport", "port", ["--compare", "LEDGER"]),
    ("rtop", "port", ["--once"]), ("rtop", "faulted", ["--once"]),
    ("rtop", "pre_pr9", ["--once"]),
    # Every rule but the heartbeat's, whose value is the clock's.
    ("rwatch", "port", ["--once", "--rules", "default,heartbeat_stale:1e9"]),
    ("rwatch", "faulted", ["--once", "--rules",
                           "default,heartbeat_stale:1e9"]),
    ("rwatch", "pre_pr9", ["--once", "--rules", "parked_chunks:1"]),
]


@pytest.mark.parametrize("tool,name,args", CLI_CASES)
def test_cli_by_path_matches_the_tool(journals, tmp_path, tool, name, args):
    if "LEDGER" in args:
        ledger = tmp_path / "ledger.jsonl"
        _, rows = _ledgers(journals)
        with open(ledger, "w") as fobj:
            for row in rows["runs"] + rows["card"]:
                fobj.write(json.dumps(row) + "\n")
        args = [str(ledger) if a == "LEDGER" else a for a in args]
    port, ref = _both(tool, [journals[name], *args], tmp_path)
    assert port[0] == ref[0], (port, ref)
    if "--json" in args:
        ours, theirs = json.loads(port[1]), json.loads(ref[1])
        for doc in (ours, theirs):
            doc.pop("fleet", None)
        assert ours == theirs
    else:
        assert _masked(port[1]) == _masked(ref[1])
    assert port[1]


def test_cli_exit_codes(journals, tmp_path):
    """rreport: 1 on a phase-sum violation, 2 without a journal or
    ledger; rtop and rwatch: 2 without a directory; rwatch: 1 with an
    alert firing, 2 on a bad rule spec; rreport and rtop print a service
    directory's job table and exit 0, as the tools do."""
    broken = RefJournal(tmp_path / "broken")
    broken.write_header("sid", 1)
    broken.record_chunk(0, ["a.inf"], [0.0], [],
                        timings={"chunk_s": 4.0, "wire_s": 0.5,
                                 "queue_s": 0.1, "collect_s": 0.0,
                                 "host_s": 0.1})
    serve = tmp_path / "serve"
    serve.mkdir()
    (serve / "jobs.jsonl").write_text("")
    cases = [
        ("rreport", [str(tmp_path / "broken"), "--quiet"], 1),
        ("rreport", [str(tmp_path / "nope"), "--quiet"], 2),
        ("rreport", [journals["port"], "--quiet", "--compare",
                     str(tmp_path / "missing.jsonl")], 2),
        ("rtop", [str(tmp_path / "nope"), "--once"], 2),
        ("rwatch", [str(tmp_path / "nope"), "--once"], 2),
        ("rwatch", [journals["faulted"], "--once", "--rules",
                    "parked_chunks"], 1),
        ("rwatch", [journals["port"], "--once", "--rules", "no_such"], 2),
    ]
    for tool, args, rc in cases:
        port, ref = _both(tool, args, tmp_path)
        assert port[0] == ref[0] == rc, (tool, args, port, ref)
    for tool, args in (("rreport", [str(serve)]),
                       ("rtop", [str(serve), "--once"])):
        port, ref = _both(tool, args, tmp_path)
        assert port[0] == ref[0] == 0, (tool, port, ref)
        assert "service jobs:" in port[1] and port[1] == ref[1]


def _serve_dir(root, journals):
    """A service directory: a JAX-written registry of four jobs (done,
    failed, running and pending; one resumed), the first two with the
    port's clean and faulted journals as their own."""
    import shutil

    from riptide_tpu.serve.daemon import JobRegistry, job_record

    reg = JobRegistry(str(root))
    for jid, tenant in (("j0001", "a"), ("j0002", "b"), ("j0003", "a"),
                        ("j0004", "b")):
        reg.append(job_record(jid, "submitted", tenant=tenant, priority=0,
                              spec={"files": ["x.inf"]}))
    for jid in ("j0001", "j0002", "j0003"):
        reg.append(job_record(jid, "started", resumed=jid == "j0003"))
    reg.append(job_record("j0001", "done", npeaks=3, device_s=1.25,
                          queue_wait_s=0.5, chunks_total=3))
    reg.append(job_record("j0002", "failed", error="device error x"))
    for jid, name in (("j0001", "port"), ("j0002", "faulted")):
        shutil.copytree(journals[name], os.path.join(root, "jobs", jid))
    return str(root)


def test_job_table_matches_the_reference(journals, tmp_path):
    """On the same service directory the port's ``read_jobs``,
    ``job_table`` and ``render_jobs_text`` equal the JAX package's, and
    rreport and rtop by path print the tools' output."""
    serve = _serve_dir(tmp_path / "serve", journals)
    assert report.read_jobs(serve) == ref_report.read_jobs(serve)
    rows = report.job_table(serve)
    assert rows == ref_report.job_table(serve)
    assert [r["status"] for r in rows] == ["done", "failed", "running",
                                           "pending"]
    assert report.render_jobs_text(rows) == \
        ref_report.render_jobs_text(rows)
    for tool, args in (("rreport", [serve]), ("rtop", [serve, "--once"])):
        port, ref = _both(tool, args, tmp_path)
        assert port[0] == ref[0] == 0 and port[1] == ref[1], (tool, port)


def test_rtop_frame_and_rwatch_loop_in_process(journals):
    """The CLIs' functions, imported with ``python -m``'s package path:
    rtop's frame at a fixed ``now`` equals the tool's, and rwatch's loop
    ends on a complete run."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import rtop as ref_rtop

    from riptide_tpu_torch.apps import rreport, rtop, rwatch

    rep = rreport.load_report_module()
    ref_rep = ref_rtop.load_report_module()
    for name in ("port", "faulted", "pre_pr9"):
        for fleet in (False, True):
            assert rtop.render_frame(rep, journals[name], now=NOW,
                                     show_fleet=fleet) == \
                ref_rtop.render_frame(ref_rep, journals[name], now=NOW,
                                      show_fleet=fleet)
    al = rwatch.load_alerts_module()
    code, result = rwatch.watch(rep, al, journals["faulted"],
                                rules=al.rules_from_spec("parked_chunks"),
                                interval=0.0, quiet=True)
    assert code == 1 and result["complete"]
    assert result["unresolved"] == ["parked_chunks"]
