"""
The port's chaos campaign (``riptide_tpu_torch/survey/chaos.py``,
``apps/rchaos.py``) on the CPU: the builtin schedules are the JAX
package's, its three service schedules included, the seeded sweep the
JAX package's; the ``kill-journal-append`` and ``cache-corrupt`` schedules
run end to end after ``control`` (subprocess legs on ``cpu``), and the
control run's peaks match the JAX package's scheduler on the same trials
(equal periods and widths, S/N within rtol 1e-5 / atol 1e-4: the port
prints float32 S/N, so the bytes are its own). The full builtin campaign
plus a seeded sweep runs under ``-m slow``.
"""
import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from riptide_tpu.survey import chaos as ref_chaos
from riptide_tpu.survey.scheduler import SurveyScheduler as RefScheduler
from riptide_tpu_torch.obs import report
from riptide_tpu_torch.survey import chaos

from test_torch_survey import WIRE_ENV, _fast_retry, _ref_searcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNR_RTOL, SNR_ATOL = 1e-5, 1e-4


def test_builtin_schedules_are_the_reference_without_serve():
    """The builtin schedules are the JAX package's, the three serve
    schedules included since the port has the service daemon."""
    ref = ref_chaos.builtin_schedules()
    assert chaos.builtin_schedules() == ref
    assert len(ref) == 14 and sum(len(s["legs"]) for s in ref) == 22
    assert [s["name"] for s in ref if s.get("serve")] == [
        "serve-kill-mid-job", "serve-drain-mid-job", "serve-device-error"]
    assert chaos.builtin_schedules()[0]["name"] == "control"


@pytest.mark.parametrize("seed,count", [(1234, 8), (7, 5), (99, 3)])
def test_seeded_schedules_are_the_reference(seed, count):
    assert chaos.seeded_schedules(seed, count) == \
        ref_chaos.seeded_schedules(seed, count)
    assert chaos.seeded_schedules(seed, count) != \
        chaos.seeded_schedules(seed + 1, count)


def test_campaign_constants_are_the_reference():
    assert (chaos.TOBS, chaos.TSAMP, chaos.PERIOD, chaos.DMS,
            chaos.AMPLITUDE) == (ref_chaos.TOBS, ref_chaos.TSAMP,
                                 ref_chaos.PERIOD, ref_chaos.DMS,
                                 ref_chaos.AMPLITUDE)
    assert chaos.SEARCH_CONF == ref_chaos.SEARCH_CONF


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """control, kill-journal-append and cache-corrupt on ``cpu``."""
    root = tmp_path_factory.mktemp("chaos")
    files = chaos.write_trials(str(root / "data"))
    schedules = [s for s in chaos.builtin_schedules()
                 if s["name"] in ("control", "kill-journal-append",
                                  "cache-corrupt")]
    summary = chaos.run_campaign(files, str(root / "w"), schedules=schedules,
                                 device="cpu")
    return files, root / "w", summary


def test_trials_are_the_reference_fixture_series(campaign, tmp_path):
    from synth import generate_data_presto

    files, _, _ = campaign
    for f, dm in zip(files, chaos.DMS):
        ref = generate_data_presto(str(tmp_path), f"r{dm}", tobs=chaos.TOBS,
                                   tsamp=chaos.TSAMP, period=chaos.PERIOD,
                                   dm=dm, amplitude=chaos.AMPLITUDE)
        with open(f[:-4] + ".dat", "rb") as a, \
                open(ref[:-4] + ".dat", "rb") as b:
            assert a.read() == b.read()


def test_kill_and_cache_corrupt_schedules_end_to_end(campaign):
    _, work, summary = campaign
    assert summary["schedules"] == 3 and summary["legs"] == 5
    legs = {s["name"]: s["reports"] for s in summary["per_schedule"]}
    for reports in legs.values():
        assert all(r["device"] == "cpu" and r["k1_launches"] == 0
                   for r in reports)
    killed, resumed = legs["kill-journal-append"]
    assert killed["killed"] and not resumed["killed"]
    assert resumed["chunks_skipped"] >= 1
    assert resumed["chunks_done"] + resumed["chunks_skipped"] == 3
    kinds = [r["incident"] for r in report.read_journal(
        str(work / "kill-journal-append" / "j"))["incidents"]]
    assert "storage_recovered" in kinds
    incidents = report.read_journal(
        str(work / "cache-corrupt" / "j"))["incidents"]
    corrupt = [r for r in incidents if r["incident"] == "cache_corrupt"]
    assert len(corrupt) == 1
    detail = corrupt[0]["detail"]
    assert detail["name"] == "chaos_probe.cpp"
    assert detail["path"].startswith(str(work / "cache-corrupt" / "cache"))
    for name in ("control", "kill-journal-append", "cache-corrupt"):
        rows = report.read_ledger(str(work / name / "ledger.jsonl"))
        assert rows and rows[-1]["platform"]["backend"] == "cpu"


def _csv_rows(path):
    with open(path, newline="") as fobj:
        return list(csv.DictReader(fobj))


def test_control_peaks_match_the_reference_scheduler(campaign, monkeypatch):
    files, work, _ = campaign
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)
    from riptide_tpu.survey import scheduler as ref_sched

    want = RefScheduler(_ref_searcher(), [[f] for f in files],
                        retry=_fast_retry(ref_sched)).run()
    got = _csv_rows(work / "control" / "peaks.csv")
    assert len(got) == len(want) > 0
    for row, peak in zip(got, want):
        # peaks.csv prints floats with %.9f.
        assert row["period"] == f"{peak.period:.9f}"
        assert int(row["width"]) == peak.width
        assert row["dm"] == f"{peak.dm:.9f}"
        np.testing.assert_allclose(float(row["snr"]), peak.snr,
                                   rtol=SNR_RTOL, atol=SNR_ATOL)


def test_a_leg_on_another_device_fails_the_campaign(campaign, tmp_path):
    """A leg's report names its device; the campaign fails a leg that
    ran anywhere but where it asked (here: the leg's report is doctored
    before the check reads it)."""
    files, _, _ = campaign
    real = subprocess.run

    def doctoring(cmd, *args, **kwargs):
        out = real(cmd, *args, **kwargs)
        cfg = cmd[cmd.index("--leg") + 1]
        path = cfg.replace(".json", ".out.json")
        with open(path) as fobj:
            text = fobj.read()
        with open(path, "w") as fobj:
            fobj.write(text.replace('"cpu"', '"meta"'))
        return out

    control = chaos.builtin_schedules()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chaos.subprocess, "run", doctoring)
        with pytest.raises(chaos.ChaosFailure, match="asked for 'cpu'"):
            chaos.run_campaign(files, str(tmp_path), schedules=control,
                               device="cpu")


def test_rchaos_lists_the_schedules():
    proc = subprocess.run([sys.executable, "-m", "riptide_tpu_torch.apps.rchaos",
                           "--list", "--sweep", "2", "--seed", "7"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = [line.split()[0] for line in proc.stdout.splitlines()]
    assert names == [s["name"] for s in chaos.builtin_schedules()
                     + chaos.seeded_schedules(7, 2)]


@pytest.mark.slow
def test_full_campaign_with_sweep(tmp_path):
    """Every builtin schedule and three seeded ones through ``rchaos`` on
    ``cpu``, each ending byte-identical to the control run."""
    proc = subprocess.run(
        [sys.executable, "-m", "riptide_tpu_torch.apps.rchaos", "--device",
         "cpu", "--outdir", str(tmp_path / "w"), "--sweep", "3", "--seed",
         "99"], cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "chaos campaign OK on cpu: 17 schedule(s)" in proc.stdout
