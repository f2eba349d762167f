"""
The checkpointed survey path on a card: a two-chunk journaled search
with every chunk shadow-probed (``RIPTIDE_INTEGRITY=probe``, probe
every 1), K1 on every dispatch, each chunk's two result digests equal;
an ``abort:1`` and a resume give the uninterrupted run's peaks, chunk 0
replayed; two jobs through the survey service's daemon on ``cuda`` give
``peaks.csv`` bytes equal to a direct run's, with K1 launched. The
survey queue makes no host-blocking call once warm (the sync debug
mode's ``error``), and two chunks queued before either is collected
each give their standalone peaks and pulled bytes, one of them through
the overflow gather on its side stream.

Marked ``cuda``: skipped on a host without one (the default CPU suite);
run on a card with ``python -m pytest --noconftest
tests/test_torch_survey_cuda.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from synth import generate_data_presto  # noqa: E402

from riptide_tpu_torch.ops import ffa_kernel as fk  # noqa: E402
from riptide_tpu_torch.pipeline.batcher import BatchSearcher  # noqa: E402
from riptide_tpu_torch.search import engine, peaks_device  # noqa: E402
from riptide_tpu_torch.search.plan import periodogram_plan  # noqa: E402
from riptide_tpu_torch.survey.faults import FaultPlan  # noqa: E402
from riptide_tpu_torch.survey.integrity import IntegrityConfig  # noqa: E402
from riptide_tpu_torch.survey.journal import SurveyJournal  # noqa: E402
from riptide_tpu_torch.survey.metrics import (  # noqa: E402
    MetricsRegistry, set_metrics)
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


# A survey batch whose S/N cube spans 22 peak blocks a column (more than
# PeakPlan.CAP), and the peak keywords of a normal and an overflowing
# search: at smin and nstd 0.5 a noise column keeps points in most
# blocks and clusters past REP_CAP, so it is untrusted and overflows.
PLAN = (2 ** 14, 1e-3, (1, 2, 3), 0.05, 1.0, 32, 40)
TOBS = PLAN[0] * PLAN[1]
PKW = dict(smin=6.0, segwidth=0.2, nstd=6.0, minseg=10, polydeg=2,
           clrad=0.1)
LOW = dict(PKW, smin=0.5, nstd=0.5)


def _batch(seed, amplitude):
    from riptide_tpu_torch.libffa import generate_signal

    rng = np.random.default_rng(seed)
    b = rng.standard_normal((2, PLAN[0])).astype(np.float32)
    np.random.seed(seed)
    b[0] += generate_signal(PLAN[0], 0.25 / PLAN[1], amplitude=amplitude,
                            ducy=0.05)
    b -= b.mean(axis=1, keepdims=True)
    b /= b.std(axis=1, keepdims=True)
    return b


def test_warm_survey_queue_makes_no_host_sync(dev):
    """After one warm batch, ``queue_search_batch`` on a shipped wire
    runs under ``torch.cuda.set_sync_debug_mode("error")`` (any blocking
    copy, pull or synchronize raises), and its peaks are the warm
    batch's."""
    plan = periodogram_plan(*PLAN)
    prepared = engine.prepare_stage_data(plan, _batch(1, 12.0))
    dms = np.zeros(2)
    warm = engine.queue_search_batch(
        plan, None, TOBS, shipped=engine.ship_stage_data(prepared, dev),
        **PKW)
    want, _ = engine.collect_search_batch(warm, dms)
    shipped = engine.ship_stage_data(prepared, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = engine.queue_search_batch(plan, None, TOBS, shipped=shipped,
                                           **PKW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got, _ = engine.collect_search_batch(handle, dms)
    assert got == want and any(want)


def test_interleaved_chunks_collect_their_own_results(dev, monkeypatch):
    """Chunk A (overflowing) and chunk B queued before either is
    collected: each collect gives the peaks of its standalone
    ``run_search_batch`` and the same pulled bytes (the fused buffer,
    then A's overflow blocks), and A's overflow gather ran on the side
    stream."""
    plan = periodogram_plan(*PLAN)
    chunks = [(_batch(2, 0.0), LOW), (_batch(3, 12.0), PKW)]
    pulled = []
    monkeypatch.setattr(peaks_device, "fold_result",
                        lambda buf: pulled.append(buf.tobytes()) or buf)
    dms = np.zeros(2)
    want = []
    for batch, kw in chunks:
        pulled.clear()
        peaks, _ = engine.run_search_batch(plan, batch, TOBS, device=dev,
                                           **kw)
        want.append((peaks, list(pulled)))
    assert len(want[0][1]) == 2 and len(want[1][1]) == 1
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        handles = [engine.queue_search_batch(plan, batch, TOBS, device=dev,
                                             **kw) for batch, kw in chunks]
        got = []
        for handle in handles:
            pulled.clear()
            peaks, _ = engine.collect_search_batch(handle, dms)
            got.append((peaks, list(pulled)))
    finally:
        set_metrics(prev)
    assert got == want
    assert any(want[0][0]) and any(want[1][0])
    assert reg.counter("overflow_gathers") == 1
    assert reg.counter("peaks_pull_ready") in (0, 1, 2)
    assert reg.snapshot()["timers"]["peaks_pull_wait_s"]["count"] == 2
