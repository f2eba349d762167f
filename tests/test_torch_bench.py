"""
The port's benchmark entry points (``riptide_tpu_torch/bench.py`` and
``apps/stime.py``, ``apps/etime.py``, ``apps/warmtest.py``) against the
JAX package's root ``bench.py`` on the CPU, at a small shape: 2^16
samples at 2 ms (131 s, long enough for the period grid to put the 1 s
pulsar within the gate's 1e-4 s), periods 0.95-1.05 s, bins 240-260,
D = 2, two chunks.

* ``_make_batch`` and ``_write_sigproc_tim`` give the JAX functions'
  bytes.
* ``_pipeline_pass`` collects, chunk by chunk, the peaks of the JAX
  package's ``run_search_batch`` on the same batches (its gather path on
  the same uint6 wire), S/N within rtol 1e-5.
* The gate passes on the pulsar's batch (inside the headline run) and
  raises on a device/host mismatch, a pulsar off 1.0 s, a uint6 top
  too far from the float32 top, and, where the shape is taken for the
  headline's, a float32 reference off 17.3 +/- 0.3.
* The headline's JSON line has the JAX ``emit``'s keys, and a ledger
  row is appended.
* ``warm_stage_kernels`` warms each distinct launch shape once.
* Every entry point raises without a card unless asked for the CPU.

The JAX bench is loaded from its path, with ``os.environ`` restored
afterwards (it sets the JAX cache variables at import).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.obs.schema import DECOMPOSITION_KEYS as REF_DECOMPOSITION_KEYS
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch import bench
from riptide_tpu_torch.apps import etime, stime, warmtest
from riptide_tpu_torch.search import engine

# Many small torch ops: one intra-op thread (its spinning pool is slow
# under several test workers).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, TSAMP, DS, CHUNKS = 1 << 16, 2e-3, 2, 2
PERIODS = (0.95, 1.05)
TOBS = SIZE * TSAMP


@pytest.fixture(scope="module")
def ref_bench():
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(
            "_reference_bench", os.path.join(REPO, "bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


@pytest.fixture
def small(monkeypatch):
    """The port's bench (and the apps' own constants) at the small
    shape."""
    for mod, names in ((bench, ("N", "TSAMP", "D", "CHUNKS")),
                       (stime, ("N", "TSAMP"))):
        for name, value in zip(names, (SIZE, TSAMP, DS, CHUNKS)):
            monkeypatch.setattr(mod, name, value)
    for mod in (bench, stime):
        monkeypatch.setattr(mod, "PERIOD_MIN", PERIODS[0])
        monkeypatch.setattr(mod, "PERIOD_MAX", PERIODS[1])
    monkeypatch.setattr(etime, "TSAMP", TSAMP)
    monkeypatch.setenv("RIPTIDE_BENCH_BUDGET", "0")


def _plan():
    return bench._plan(SIZE, TSAMP, *PERIODS, bench.BINS_MIN, bench.BINS_MAX)


@pytest.fixture(scope="module")
def batches():
    return [bench._make_batch(DS, SIZE, TSAMP, seed=k) for k in range(2)]


@pytest.mark.parametrize("seed", [0, 5])
def test_make_batch_is_the_reference_bytes(ref_bench, seed):
    got = bench._make_batch(3, 4096, 1e-3, seed=seed)
    want = ref_bench._make_batch(3, 4096, 1e-3, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_write_sigproc_tim_is_the_reference_bytes(ref_bench, tmp_path):
    bench._write_sigproc_tim(tmp_path / "port.tim", n=8192)
    ref_bench._write_sigproc_tim(tmp_path / "ref.tim", n=8192)
    got = (tmp_path / "port.tim").read_bytes()
    assert got == (tmp_path / "ref.tim").read_bytes()
    assert len(got) > 8192 * 4


def test_pipeline_pass_matches_reference(monkeypatch, batches):
    """Each collected chunk's peaks are the JAX ``run_search_batch``'s on
    that chunk's batch; the chunks' staging buffers go back to the
    pool."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "uint6")
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")
    plan = _plan()
    collected = []
    real = bench.collect_search_batch

    def recording_collect(handle, dms):
        out = real(handle, dms)
        collected.append(out[0])
        return out

    monkeypatch.setattr(bench, "collect_search_batch", recording_collect)
    pool = engine.StagingPool("cpu")
    timing = {}
    with ThreadPoolExecutor(1) as prepper, ThreadPoolExecutor(1) as shipper:
        dt = bench._pipeline_pass(plan, TOBS, CHUNKS, np.zeros(DS),
                                  lambda i: batches[i % 2], prepper, shipper,
                                  device="cpu", pool=pool, timing=timing)
    assert dt > 0 and len(collected) == CHUNKS
    assert len(timing["fill"]) == 2 and len(timing["chunks"]) == CHUNKS
    assert all(set(t) == {"queue", "wait", "prep", "ship", "collect",
                          "total"} for t in timing["chunks"])
    assert timing["chunks"][-1]["prep"] == 0.0 and timing["final_collect"] > 0
    assert sum(len(v) for v in pool._free.values()) == 2 * CHUNKS
    rplan = ref_plan(SIZE, TSAMP, plan.widths, *PERIODS, bench.BINS_MIN,
                     bench.BINS_MAX)
    for i, got in enumerate(collected):
        want, _ = ref_engine.run_search_batch(rplan, batches[i % 2], TOBS,
                                              **bench.PKW)
        assert any(got)
        for g, w in zip(got, want):
            assert [(p.ip, p.iw) for p in g] == [(p.ip, p.iw) for p in w]
            np.testing.assert_allclose([p.snr for p in g],
                                       [p.snr for p in w], rtol=1e-5)


@pytest.mark.parametrize("sub,bound", [
    ({"prep_s": 2.9, "wire_s": 0.004, "device_s": 0.18}, "prep"),
    ({"prep_s": 0.1, "wire_s": 0.004, "device_s": 0.18}, "device"),
    ({"prep_s": 0.1, "wire_s": 0.16, "device_s": 0.18}, "tunnel"),
    ({"prep_s": 0.0, "wire_s": 0.0, "device_s": None}, "unknown"),
])
def test_pass_bound_names_the_prep(sub, bound):
    """A pass the host prep paced is labelled ``prep`` (on its ledger
    row too); otherwise the label is ``classify_bound``'s."""
    assert bench.pass_bound(sub) == bound


def _drop_top(find_peaks):
    def dropped(pgram, **kw):
        peaks, polycos = find_peaks(pgram, **kw)
        return peaks[1:], polycos
    return dropped


@pytest.mark.parametrize("fault,match", [
    ("host", "device/host peak mismatch"),
    ("period", "not the pulsar at 1.0 s"),
    ("wire", "apart by"),
    ("band", "the search changed"),
])
def test_parity_gate_raises(monkeypatch, batches, fault, match):
    """Each of the gate's checks fails the gate: a host peak list unlike
    the device's, a pulsar away from 1.0 s, the uint6 top S/N too far
    from the float32 top (the band narrowed to nothing), and the
    historical 17.3 +/- 0.3 band where the shape is taken for the
    headline's (the small shape's float32 top is about 19)."""
    batch = batches[0]
    if fault == "host":
        monkeypatch.setattr(bench, "find_peaks",
                            _drop_top(bench.find_peaks))
    elif fault == "period":
        batch = bench._make_batch(DS, SIZE, TSAMP, pulsar_period=0.99)
    elif fault == "wire":
        monkeypatch.setattr(bench, "WIRE_BAND", 0.0)
    else:
        monkeypatch.setattr(bench, "HEADLINE_SHAPE", (SIZE, TSAMP))
    with pytest.raises(RuntimeError, match=match):
        bench._parity_gate(_plan(), batch, TOBS, device="cpu")


def test_headline_line_has_the_reference_keys(monkeypatch, small, ref_bench,
                                              capsys, tmp_path):
    """The port's headline at the small shape (warm, gate, one pass):
    the gate's line on stderr, and the JSON line's keys those of the JAX
    ``emit`` (run with its gate and pass stubbed, its plan at the same
    shape), with a ledger row appended."""
    monkeypatch.setenv("RIPTIDE_LEDGER", str(tmp_path / "ledger.jsonl"))
    bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert "parity gate:" in err and "device == host" in err
    assert line["passes"] == 1 and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] * bench.REF_SECONDS_PER_TRIAL, 2)
    rows = [json.loads(r) for r in
            (tmp_path / "ledger.jsonl").read_text().splitlines()]
    assert [(r["kind"], r["metric"]) for r in rows] == [
        ("bench", "dm_trials_per_sec_2p23_samples")]

    monkeypatch.delenv("RIPTIDE_LEDGER")
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")
    for name, value in (("N", SIZE), ("TSAMP", TSAMP), ("D", DS),
                        ("CHUNKS", CHUNKS), ("PERIOD_MIN", PERIODS[0]),
                        ("PERIOD_MAX", PERIODS[1]), ("BUDGET", 0.0)):
        monkeypatch.setattr(ref_bench, name, value)
    monkeypatch.setattr(ref_bench, "_parity_gate", lambda *a: None)
    monkeypatch.setattr(ref_bench, "_pipeline_pass", lambda *a: 1.0)
    ref_bench.bench_headline()
    ref_out = capsys.readouterr().out
    want = json.loads(ref_out.strip().splitlines()[-1])
    assert sorted(line) == sorted(want)
    assert sorted(line["occupancy"]) == sorted(want["occupancy"])
    assert set(REF_DECOMPOSITION_KEYS) < set(line)


def test_warm_stage_kernels_warms_each_launch_shape_once(monkeypatch):
    """The count is the plan's distinct launch shapes (the shape-only
    walk's, and a recorded search's), each launched once, and every
    container's operands are uploaded; a launch whose shape was warmed
    already is skipped."""
    plan = _plan()
    calls = []
    real = engine.fused_stage
    shape = engine.launch_shape

    def counted(*args):
        calls.append(shape("fused_stage", args))
        return real(*args)

    monkeypatch.setattr(engine, "fused_stage", counted)
    n = engine.warm_stage_kernels(plan, DS, device="cpu")
    assert n == len(calls) == len(set(calls)) > 0
    assert n == len(engine.launch_shapes(plan, DS))
    for st in plan.stages:
        assert any(k[0] == "cpu" for k in st._device_operands)
    calls.clear()
    zeros = np.zeros((DS, plan.size), np.float32)
    with engine.recording() as rec:
        engine.run_periodogram_batch(plan, zeros, device="cpu")
    shapes = {engine.launch_shape(ln["kind"], ln["args"])
              for ln in rec["launches"]}
    assert shapes == set(calls) and len(shapes) == n
    # Launches of a shape already warmed are skipped: with every launch
    # taken for one shape, one kernel runs.
    monkeypatch.setattr(engine, "launch_shape", lambda kind, args: kind)
    calls.clear()
    assert engine.warm_stage_kernels(plan, DS, device="cpu") == 1
    assert len(calls) == 1


@pytest.mark.parametrize("app,argv", [
    ("stime", ["2", "2", "--device", "cpu"]),
    ("etime", ["16", "1", "1", "--device", "cpu"]),
    ("warmtest", ["2", "seq", "--device", "cpu"]),
])
def test_apps_run_on_the_cpu(small, capsys, app, argv):
    """The apps' last lines at the small shape: stime's decomposition
    block (the JAX schema's keys) after a line per chunk, etime's S/N line, warmtest's count of
    the plan's launch shapes."""
    {"stime": stime, "etime": etime, "warmtest": warmtest}[app].main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    last = lines[-1]
    if app == "stime":
        assert sum(x.startswith("iter ") for x in lines) == 2
        block = json.loads(last)
        assert block["metric"] == "stime_decomposition"
        assert set(block) >= {"trials_per_sec", *REF_DECOMPOSITION_KEYS}
    elif app == "etime":
        assert last.startswith("snr stats:") and "(1, " in last
    else:
        n = len(engine.launch_shapes(_plan(), 2))
        assert last.startswith(f"warmed {n} launch shapes (parallel=False)")


@pytest.mark.parametrize("main", [bench.main, stime.main, etime.main,
                                  warmtest.main])
def test_entry_points_raise_without_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
