"""
The checkpointed survey path on a card: a two-chunk journaled search
with every chunk shadow-probed (``RIPTIDE_INTEGRITY=probe``, probe
every 1), K1 on every dispatch, each chunk's two result digests equal;
an ``abort:1`` and a resume give the uninterrupted run's peaks, chunk 0
replayed; two jobs through the survey service's daemon on ``cuda`` give
``peaks.csv`` bytes equal to a direct run's, with K1 launched.

Marked ``cuda``: skipped on a host without one (the default CPU suite);
run on a card with ``python -m pytest --noconftest
tests/test_torch_survey_cuda.py``.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from synth import generate_data_presto  # noqa: E402

from riptide_tpu_torch.ops import ffa_kernel as fk  # noqa: E402
from riptide_tpu_torch.pipeline.batcher import BatchSearcher  # noqa: E402
from riptide_tpu_torch.survey.faults import FaultPlan  # noqa: E402
from riptide_tpu_torch.survey.integrity import IntegrityConfig  # noqa: E402
from riptide_tpu_torch.survey.journal import SurveyJournal  # noqa: E402
from riptide_tpu_torch.survey.metrics import MetricsRegistry  # noqa: E402
from riptide_tpu_torch.survey.scheduler import (  # noqa: E402
    RetryPolicy, SurveyScheduler)

pytestmark = pytest.mark.cuda

SEARCH_CONF = [{
    "ffa_search": {"period_min": 0.3, "period_max": 1.2,
                   "bins_min": 64, "bins_max": 71},
    "find_peaks": {"smin": 6.0},
}]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    root = tmp_path_factory.mktemp("trials")
    files = [generate_data_presto(str(root), f"t{i}_DM{dm:.2f}", tobs=16.0,
                                  tsamp=1e-3, period=0.5, dm=dm,
                                  amplitude=amp)
             for i, (dm, amp) in enumerate([(0.0, 15.0), (5.0, 25.0),
                                            (10.0, 15.0), (15.0, 20.0)])]
    return [files[:2], files[2:]]


def _run(dev, chunks, jdir, spec="", resume=False, mode="probe"):
    metrics = MetricsRegistry()
    searcher = BatchSearcher({"rmed_width": 4.0, "rmed_minpts": 101},
                             SEARCH_CONF, fmt="presto", io_threads=2,
                             batch_size=2, device=dev)
    sched = SurveyScheduler(
        searcher, chunks, journal=SurveyJournal(jdir), resume=resume,
        faults=FaultPlan.parse(spec), metrics=metrics,
        retry=RetryPolicy(sleep=lambda s: None),
        integrity=IntegrityConfig(mode, 1, canary_pin=os.devnull))
    fk.reset_launches()
    return sched.run(), metrics, dict(fk.LAUNCHES)


def test_probed_journaled_search_on_the_card(dev, chunks, tmp_path):
    peaks, metrics, launches = _run(dev, chunks, tmp_path / "j")
    assert peaks
    assert metrics.counter("shadow_probes") == 2
    assert metrics.counter("integrity_mismatches") == 0
    journal = SurveyJournal(tmp_path / "j")
    recs = journal.completed_chunks()
    assert sorted(recs) == [0, 1]
    for rec, _ in recs.values():
        assert rec["integrity"]["probe"] and "votes" not in rec["integrity"]
    # Each dispatch (primary and shadow) launched K1.
    once, _, once_launches = _run(dev, chunks, tmp_path / "once",
                                  mode="off")
    assert once_launches["fused_stage"] > 0
    assert launches["fused_stage"] == 2 * once_launches["fused_stage"]
    assert [tuple(p) for p in once] == [tuple(p) for p in peaks]


def test_abort_and_resume_on_the_card(dev, chunks, tmp_path):
    want, _, _ = _run(dev, chunks, tmp_path / "clean")
    jdir = tmp_path / "j"
    with pytest.raises(Exception, match="injected abort"):
        _run(dev, chunks, jdir, spec="abort:1")
    assert sorted(SurveyJournal(jdir).completed_chunks()) == [0]
    got, metrics, launches = _run(dev, chunks, jdir, resume=True)
    assert metrics.counter("chunks_skipped") == 1
    assert launches["fused_stage"] > 0
    assert [tuple(p) for p in got] == [tuple(p) for p in want]


def test_bitflip_is_out_voted_on_the_card(dev, chunks, tmp_path):
    want, _, _ = _run(dev, chunks, tmp_path / "clean")
    got, metrics, _ = _run(dev, chunks, tmp_path / "j", spec="bitflip:1")
    assert metrics.counter("integrity_mismatches") == 1
    assert [tuple(p) for p in got] == [tuple(p) for p in want]


def test_two_served_jobs_give_the_direct_run_bytes(dev, chunks, tmp_path):
    """Two tenants' jobs at once through ``ServeDaemon(device="cuda")``:
    both done, each ``peaks.csv`` the bytes of a direct scheduler run of
    the same chunks."""
    import json
    import time
    import urllib.request

    from riptide_tpu_torch.serve import ServeDaemon
    from riptide_tpu_torch.serve.daemon import write_peaks_csv

    direct, _, _ = _run(dev, chunks, tmp_path / "direct", mode="off")
    write_peaks_csv(direct, str(tmp_path / "direct.csv"))
    want = (tmp_path / "direct.csv").read_bytes()
    files = [f for c in chunks for f in c]
    d = ServeDaemon(str(tmp_path / "serve"), port=0, workers=2,
                    device="cuda").start()
    try:
        base = f"http://127.0.0.1:{d.port}"
        fk.reset_launches()
        jids = []
        for tenant in ("a", "b"):
            spec = {"files": files, "fmt": "presto", "tenant": tenant,
                    "chunk_files": 2, "io_threads": 2,
                    "deredden": {"rmed_width": 4.0, "rmed_minpts": 101},
                    "search": SEARCH_CONF}
            req = urllib.request.Request(
                base + "/jobs", data=json.dumps(spec).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=10) as resp:
                jids.append(json.loads(resp.read())["job_id"])
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and not all(
                doc["status"] in ("done", "failed")
                for doc in d.list()["jobs"]):
            time.sleep(0.1)
        docs = {doc["job_id"]: doc for doc in d.list()["jobs"]}
    finally:
        d.stop()
    assert fk.LAUNCHES["fused_stage"] > 0
    for jid in jids:
        assert docs[jid]["status"] == "done", docs[jid].get("error")
        with open(os.path.join(docs[jid]["directory"], "peaks.csv"),
                  "rb") as fobj:
            assert fobj.read() == want
