"""The harness on the CPU: its files found by name, the rate, the metric
readers on synthetic profiler records, the result line, and the
isolation check."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from portbench import cell, check, trace
from portbench.loop import run_window
from portbench.tests.small import small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cell._json(os.path.join(cell.ROOT, "BENCHMARK.json"))


def test_benchmark_json_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(cell.HERE, "metrics",
                                           m["name"] + ".py"))
    for c in BENCH["configs"]:
        cfg = cell._json(os.path.join(cell.ROOT, c["file"]))
        assert set(c["reduced"]) <= set(cfg) and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["published"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(workload):
    wl, cfg, mix, limits, _ = cell.load_cell(workload)
    assert wl["config"] == workload.split(".")[0]
    assert cfg["wire"] == "uint6" and cfg["compute"] == "float32"
    assert mix["dm_trials"] >= 2 and mix["ring"] >= 1
    assert set(limits["limits"]) == {"snr_rms", "snr_max", "peaks_bad"}
    assert limits["limits"]["peaks_bad"] == 0
    assert "segment_cascade_kernel" in cell.kernel_sets()["k1"]
    for m in BENCH["per_layer"]:
        assert callable(cell.metric_reader(m["name"]))


def test_window_collects_every_chunk_and_the_rate_counts_them_all():
    """Every chunk queued in the window is collected in it; the rate is
    all of their trials over the whole window."""
    wl, cfg, mix, limits, _ = small_cell()
    st = cell.setup(cfg, mix, limits, 7, torch.device("cpu"))
    (r,) = st["ranges"]
    win = run_window([(r["plan"], r["tobs"], cfg["find_peaks"], None)],
                     st["ring"], 0.5, torch.device("cpu"))
    n = win["chunks"]
    assert n >= 2 and len(win["peaks"]) == n == len(win["queue_s"])
    assert win["slots"] == [i % 2 for i in range(n)]
    assert len(win["ship_s"]) == n and sorted(win["snr"]) == [0, 1]
    win["launches"], win["records"] = {}, None
    rec = cell.window_record(st, win, 12.5)
    rate = cell.metric_reader("survey_trials_per_s")
    assert rate(rec) == pytest.approx(4 * n / (win["t1"] - win["t0"]))
    assert rate(dict(collected_trials=1280, window_s=2.0)) == 640
    assert cell.metric_reader("setup_s")(rec) == 12.5


def _records():
    """A synthetic traced window of two chunks: [0, 1000] us, K1
    kernels 100 us each at 0 and 500, peak kernels 200 us at 150 and
    650, a copy of 40 us at 360 (inside an idle stretch) and a set."""
    ann = lambda name, ts, dur: {"name": "portbench." + name,
                                 "cat": "user_annotation", "ts": ts,
                                 "dur": dur}
    k = lambda name, ts, dur, cat="kernel": {"name": name, "cat": cat,
                                             "ts": ts, "dur": dur}
    return [ann("window", 0.0, 1000.0), ann("queue.0", 0.0, 100.0),
            ann("collect.0", 350.0, 100.0), ann("ship.1", 360.0, 40.0),
            k("void segment_cascade_kernel<4>(float const*, int)", 0, 100),
            k("ffa_level_kernel(float const*, float*)", 500, 100),
            k("void at::native::vectorized_elementwise_kernel<4>(int)",
              150, 200),
            k("at::native::reduce_kernel(int)", 650, 200),
            k("Memcpy HtoD (Pinned -> Device)", 360, 40, "gpu_memcpy"),
            k("Memset (Device)", 1500, 10, "gpu_memset")]


def _rec():
    return {"setup_s": 20.0, "records": _records(), "span": (0.0, 1000.0),
            "window_s": 2.0, "collected_trials": 8,
            "chunks": 2, "trials_per_chunk": 4,
            "host": {"ship_s": [0.001, 0.003], "queue_s": [0.1, 0.3],
                     "collect_s": [0.02, 0.04], "prep_s": [1.0, 3.0],
                     "prep_trials": 8},
            "launches": {"segment_wire": 4, "ffa_level": 10,
                         "boxcar_snr": 4, "segment_container": 0},
            "kernels": {"k1": frozenset(["segment_cascade_kernel",
                                         "ffa_level_kernel"])},
            "work": {"ops": 33.5e6, "bytes": 1.0}}


@pytest.mark.parametrize("name,want", [
    ("prep_ms_per_trial", 500.0), ("ship_ms", 2.0), ("queue_ms", 200.0),
    ("collect_ms", 30.0), ("cuda_launches_per_chunk", 9.0),
    ("k1_ms_per_chunk", 0.1), ("peaks_ms_per_chunk", 0.2),
    ("device_idle_pct", 36.0), ("setup_s", 20.0),
    ("survey_trials_per_s", 4.0),
    # 2 chunks x 1 us bound (33.5e6 ops at 33.5e12 ops/s) over 200 us.
    ("k1_roofline", 1.0),
    ("chunk_mfu", 100.0 * 2 * 1e-6 / 2.0)])
def test_metric_readers_on_synthetic_records(name, want):
    assert cell.metric_reader(name)(_rec()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["k1_roofline", "k1_ms_per_chunk",
                                  "peaks_ms_per_chunk", "device_idle_pct"])
def test_trace_readers_read_nothing_from_an_empty_trace(name):
    rec = dict(_rec(), records=[_records()[0]])
    assert cell.metric_reader(name)(rec) is None


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(_records(), (0.0, 1000.0))
    ops = {name: round(s * 1e6) for name, s in b["device_ops"]}
    assert ops == {"reduce_kernel": 200, "vectorized_elementwise_kernel": 200,
                   "segment_cascade_kernel": 100, "ffa_level_kernel": 100,
                   "Memcpy HtoD (Pinned -> Device)": 40}
    gaps = [(name, round(s * 1e6)) for name, s in b["idle_gaps"]]
    assert gaps == [("other", 150), ("collect.0", 100), ("other", 50),
                    ("other", 50), ("collect.0", 10)]
    assert trace.kernel_base("void ns::k<1, 2>(int*)") == "k"
    assert trace.kernel_base(
        "void (anonymous namespace)::ffa_level_kernel<4>(float const*)"
    ) == "ffa_level_kernel"
    assert trace.kernel_base(
        "(anonymous namespace)::boxcar_snr_kernel(float const*, float*)"
    ) == "boxcar_snr_kernel"


@pytest.mark.parametrize("traced", [0, 1])
def test_result_line_keys(traced):
    wl, cfg, mix, limits, bench = small_cell()
    result, lines = cell.run_cell(wl, cfg, mix, limits, bench, 2**40 + 3,
                                  0.5, bool(traced), torch.device("cpu"),
                                  0.0, log=lambda msg: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] * traced + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 4 == 0 and result["attempted"] >= 8
    want = ({m["name"] for m in bench["per_layer"]} if traced
            else {m["name"] for m in bench["end_to_end"]})
    # The CPU has no device trace, so its readers read nothing.
    got = set(result["metrics"])
    assert got <= want
    if not traced:
        assert got == want
    assert lines[-1].startswith("check failed_trials")
    json.dumps(result)


def test_isolation_compares_top_level_names_whole():
    assert check.forbidden_modules(["riptide_tpu_torch", "riptide_tpu_torch.x",
                                    "numpy", "jaxtyping"]) == []
    assert check.forbidden_modules(["jax.numpy", "riptide_tpu.ops", "flax",
                                    "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                   "riptide_tpu"]
    assert check.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(check.FORBIDDEN))


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "quickstart.survey", "--seed", str(2**40),
                          "--seconds", "1", "--trace", "0"], cwd=cell.ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr
    assert not [m for m in ("jax", "riptide_tpu.")
                if m in out.stderr.split("found")[0]]


def test_run_without_the_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the harness, a run
    (past the look for a card) fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(cell.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cell.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch\n"
            "from portbench import cell\n"
            "args = cell.load_cell('quickstart.survey')\n"
            "cell.run_cell(*args, 1, 0.1, False, torch.device('cpu'), 0.0)\n"
            "print('result')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "result" not in out.stdout
    assert "riptide_tpu_torch" in out.stderr


def test_uncomparable_snr_reads_as_a_number_over_any_limit():
    want = torch.zeros((1, 3, 2), dtype=torch.float64)
    for got in (torch.zeros((1, 4, 2)), torch.full((1, 3, 2), float("nan"))):
        rms, mx = check.snr_gaps(got, want)
        assert rms == mx == check.UNCOMPARABLE
        assert json.loads(json.dumps({"v": rms}))["v"] > 1e300
    assert check.snr_gaps(torch.ones((1, 3, 2)), want) == (1.0, 1.0)
