"""
The port's result-integrity layer (``riptide_tpu_torch.survey.integrity``)
against the JAX package's, on the CPU: the fold and peak digests, the
modes and probe cadence, shadow probes and the majority vote under the
``bitflip`` fault, the quarantine latch and its resume, replay
verification, and the golden canary (computed on the CPU twice and held
to itself and to a pin file written in the test; the package's own pin
file carries no CPU digest).
"""
import json

import numpy as np
import pytest

from riptide_tpu.survey import integrity as ref_integrity
from riptide_tpu_torch.peak_detection import Peak
from riptide_tpu_torch.survey import integrity
from riptide_tpu_torch.survey.integrity import (IntegrityConfig,
                                                IntegrityManager,
                                                IntegrityQuarantineError)
from riptide_tpu_torch.survey.journal import SurveyJournal
from riptide_tpu_torch.survey.metrics import MetricsRegistry

from test_torch_survey import (WIRE_ENV, _compare, _integrity, _rows,
                               _schedule)
from test_torch_survey import clean, trials  # noqa: F401 (fixtures)


@pytest.fixture(autouse=True)
def _wire(monkeypatch):
    for key, value in WIRE_ENV.items():
        monkeypatch.setenv(key, value)


BUFFERS = [np.arange(12, dtype=np.float32).reshape(3, 4),
           np.array([7, -1, 3], dtype=np.int32),
           np.zeros((0, 5), np.float64)]


@pytest.mark.parametrize("hit", [None, 0, 5, 1000])
def test_fold_matches_reference(hit):
    ours = integrity._FoldAccumulator(corrupt_hit=hit)
    ref = ref_integrity._FoldAccumulator(corrupt_hit=hit)
    outs = [ours.fold(b) for b in BUFFERS]
    refs = [ref.fold(b) for b in BUFFERS]
    assert ours.hexdigest() == ref.hexdigest()
    assert ours.nbuf == ref.nbuf == 3
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    if hit is not None:
        assert not np.array_equal(outs[0], BUFFERS[0])
    assert integrity._FoldAccumulator().hexdigest() is None


def test_fold_result_is_a_no_op_without_a_fold():
    buf = BUFFERS[0]
    assert integrity.fold_result(buf) is buf
    integrity.set_collect_path("batch")      # no accumulator: no-op


def test_fold_is_thread_local():
    import threading

    mgr = IntegrityManager(IntegrityConfig("digest"))
    acc = mgr.begin_fold(0)
    other = {}

    def worker():
        other["out"] = integrity.fold_result(BUFFERS[1])

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert other["out"] is BUFFERS[1]        # not folded off-thread
    integrity.fold_result(BUFFERS[0])
    info = mgr.finish_fold(acc)
    assert info["nbuf"] == 1 and info["result"]


def test_peaks_digest_matches_reference():
    from riptide_tpu.peak_detection import Peak as RefPeak

    vals = [(0.5, 2.0, 3, 0.05, 1, 7, 10.25, 0.0),
            (1.0 / 3.0, 3.0, 1, 0.01, 0, 2, 7.000001, 12.5)]
    ours = integrity.peaks_digest([Peak(*v) for v in vals])
    assert ours == ref_integrity.peaks_digest([RefPeak(*v) for v in vals])
    assert ours != integrity.peaks_digest([Peak(*vals[0])])


def test_config_matches_reference(monkeypatch):
    for mode, every in (("off", 0), ("digest", 3), ("probe", 2),
                        ("strict", 0)):
        ours, ref = IntegrityConfig(mode, every), \
            ref_integrity.IntegrityConfig(mode, every)
        assert (ours.mode, ours.probe_every, ours.enabled, ours.probing) == \
            (ref.mode, ref.probe_every, ref.enabled, ref.probing)
        m, r = IntegrityManager(ours), ref_integrity.IntegrityManager(ref)
        assert [m.probe_due(c) for c in range(6)] == \
            [r.probe_due(c) for c in range(6)]
    for bad in ({"mode": "loud"}, {"policy": "maybe"}):
        with pytest.raises(ValueError):
            IntegrityConfig(**bad)
    monkeypatch.setenv("RIPTIDE_INTEGRITY", "probe")
    monkeypatch.setenv("RIPTIDE_INTEGRITY_PROBE_EVERY", "2")
    cfg = IntegrityConfig.from_env()
    assert (cfg.mode, cfg.probe_every) == ("probe", 2)


# ------------------------------------------------------- on the scheduler

def _run(pkg, trials, path, spec, mode, every=1, **kw):
    return _schedule(pkg, trials, path / pkg, spec,
                     integrity=_integrity(pkg, mode, every), **kw)


@pytest.mark.parametrize("mode", ["off", "digest", "probe"])
def test_modes_match_reference(trials, tmp_path, clean, mode):
    port = _run("port", trials, tmp_path, "", mode)
    ref = _run("ref", trials, tmp_path, "", mode)
    _compare(port, ref)
    assert _rows(port[0]) == _rows(clean["port"])
    for (cid, (rec, _)), (rcid, (rrec, _)) in zip(
            sorted(port[3].completed_chunks().items()),
            sorted(ref[3].completed_chunks().items())):
        assert sorted(rec) == sorted(rrec)
        blk, rblk = rec.get("integrity"), rrec.get("integrity")
        assert (blk is None) == (mode == "off") == (rblk is None)
        if blk is not None:
            assert sorted(blk) == sorted(rblk)
            assert blk["path"] == "batch"
            assert blk.get("probe", False) == (mode == "probe")
    if mode == "probe":
        assert port[1]["shadow_probes"] == 3
        assert port[1]["integrity_mismatches"] == 0


def test_single_bitflip_is_outvoted_like_the_reference(trials, tmp_path,
                                                       clean):
    port = _run("port", trials, tmp_path, "bitflip:1", "probe")
    ref = _run("ref", trials, tmp_path, "bitflip:1", "probe")
    _compare(port, ref)
    assert port[2] == ["result_mismatch"]
    assert port[1]["integrity_mismatches"] == 1
    assert port[1]["shadow_probes"] == 4
    rec = port[3].completed_chunks()[1][0]
    assert len(rec["integrity"]["votes"]) == 3
    assert _rows(port[0]) == _rows(clean["port"])


def test_persistent_bitflip_quarantines_parks_and_resumes(trials, tmp_path,
                                                          clean):
    """``bitflip:1x3``: three dispatches of chunk 1, three digests; the
    card is quarantined, chunks 1 and 2 park, and a fault-free resume
    gives the clean peaks. Counters and incidents as in the JAX
    package."""
    port = _run("port", trials, tmp_path, "bitflip:1x3", "probe")
    ref = _run("ref", trials, tmp_path, "bitflip:1x3", "probe")
    _compare(port, ref)
    assert port[1]["chunks_parked"] == 2
    assert "integrity_quarantine" in port[2]
    assert sorted(port[3].parked_chunks()) == [1, 2]
    assert sorted(port[3].completed_chunks()) == [0]
    resumed = _run("port", trials, tmp_path, "", "probe", resume=True)
    assert resumed[1]["chunks_skipped"] == 1
    assert _rows(resumed[0]) == _rows(clean["port"])


def test_quarantine_policy_fail_raises(trials, tmp_path):
    cfg = IntegrityConfig("probe", 1, policy="fail")
    out = _schedule("port", trials, tmp_path, "bitflip:0x3", integrity=cfg)
    assert isinstance(out[0], IntegrityQuarantineError)
    assert out[0].retryable is False


def test_replay_digest_mismatch_is_an_incident(trials, tmp_path, clean):
    """A journaled peak row altered on disk replays, but no longer
    matches its chunk's integrity digest: ``result_mismatch`` with
    ``replayed``, in both packages."""
    for pkg in ("port", "ref"):
        _run(pkg, trials[:1], tmp_path, "", "digest")
        peaks = tmp_path / pkg / "peaks.jsonl"
        lines = peaks.read_bytes().split(b"\n")
        row = json.loads(lines[0].split(b" #")[0])
        row[6] += 1.0
        lines[0] = json.dumps(row).encode()      # a legacy, unsummed line
        peaks.write_bytes(b"\n".join(lines))
    port = _run("port", trials[:1], tmp_path, "", "digest", resume=True)
    ref = _run("ref", trials[:1], tmp_path, "", "digest", resume=True)
    _compare(port, ref)
    assert port[2][-1] == "result_mismatch"
    inc = port[3].incidents()[-1]
    assert inc["detail"]["replayed"] is True


# ------------------------------------------------------------------ canary

def test_canary_is_deterministic_on_the_cpu():
    a = integrity.compute_canary_digest("cpu")
    b = integrity.compute_canary_digest("cpu")
    assert a == b and len(a) == 64
    assert integrity.canary_platform("cpu") == "cpu"


def test_canary_verdicts(tmp_path):
    digest = integrity.compute_canary_digest("cpu")
    pin = tmp_path / "pin.json"
    verdicts = {}
    for name, pins in (("ok", {"cpu": digest}), ("failed", {"cpu": "0" * 64}),
                       ("unpinned", {"cuda:other": digest})):
        pin.write_text(json.dumps({"platform_digests": pins}))
        mgr = IntegrityManager(IntegrityConfig("strict", canary_pin=str(pin)),
                               metrics=MetricsRegistry(), device="cpu")
        verdicts[name] = mgr.canary_verdict()
    assert verdicts == {"ok": "ok", "failed": "failed",
                        "unpinned": "unpinned"}
    pin.write_text(json.dumps({"platform_digests": {"cpu": "0" * 64}}))
    mgr = IntegrityManager(IntegrityConfig("strict", canary_pin=str(pin)),
                           device="cpu")
    with pytest.raises(RuntimeError, match="canary"):
        mgr.startup_canary()


def test_write_canary_pin_keeps_other_devices(tmp_path):
    pin = tmp_path / "pin.json"
    pin.write_text(json.dumps({"platform_digests": {"cuda:x": "ab"}}))
    platform, digest = integrity.write_canary_pin("cpu", path=str(pin))
    pins = json.loads(pin.read_text())["platform_digests"]
    assert pins == {"cpu": digest, "cuda:x": "ab"} and platform == "cpu"


def test_package_pin_file_has_no_cpu_digest():
    with open(integrity.canary_pin_path()) as fobj:
        pins = json.load(fobj)["platform_digests"]
    assert isinstance(pins, dict)
    assert "cpu" not in pins
    assert all(key.startswith("cuda:") for key in pins)
