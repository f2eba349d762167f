"""The ``example_yaml`` configuration (riptide's pipeline example searched
over all three of its ranges) against the program's copy of
``example.yaml``, its cell's files, and the two readers of the card's
time by search range (``portbench/range_blocks.py``) on synthetic
records."""
import os

import pytest

from portbench import cell, check, spans
from portbench.range_blocks import PULL, range_blocks
from portbench.ranges import ranges
from portbench.tests.test_portbench_harness import _rec, _records

WORKLOAD = "example_yaml.survey_d64"
EXAMPLE = os.path.join(cell.ROOT, "riptide_tpu_torch", "pipeline", "config",
                       "example.yaml")
READERS = ("range_switch_idle_ms", "range_max_ms_per_chunk")


def test_configuration_matches_example_yaml():
    yaml = pytest.importorskip("yaml")
    with open(EXAMPLE) as fobj:
        doc = yaml.safe_load(fobj)
    cfg = cell.load_cell(WORKLOAD)[1]
    got = [(name, r["period_min"], r["period_max"], r["bins_min"],
            r["bins_max"], r["fpmin"], r["wtsp"], r["find_peaks"]["smin"])
           for name, r in ranges(cfg)]
    want = [(r["name"], r["ffa_search"]["period_min"],
             r["ffa_search"]["period_max"], r["ffa_search"]["bins_min"],
             r["ffa_search"]["bins_max"], r["ffa_search"]["fpmin"],
             r["ffa_search"]["wtsp"], r["find_peaks"]["smin"])
            for r in doc["ranges"]]
    assert got == want
    for name, r in ranges(cfg):
        assert r["period_min"] < r["pulsar_period"] < r["period_max"], name


def test_cell_reads_its_files():
    wl, cfg, mix, limits, bench = cell.load_cell(WORKLOAD)
    assert wl["config"] == "example_yaml" and wl["chips"] == 1
    assert cfg["wire"] == "uint6" and cfg["compute"] == "float32"
    assert (cfg["nsamp"], cfg["tsamp"]) == (1 << 23, 6.4e-05)
    assert mix["dm_trials"] == 64 and mix["ring"] == 2
    assert mix["pulsar"]["trials"] == [0]
    names = [name for name, _ in ranges(cfg)]
    assert names == ["short", "medium", "long"]
    want = {}
    for name in names:
        want.update(check.named({"snr_rms": 0, "snr_max": 0,
                                 "peaks_bad": 0}, name))
    assert set(limits["limits"]) == set(want)
    assert all(limits["limits"][f"peaks_bad.{n}"] == 0 for n in names)
    assert limits["sample_trials"] == 6
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [WORKLOAD]
            assert callable(cell.metric_reader(m["name"]))


def _range_records():
    """Two chunks of ranges a, b on the card over a window [0, 2000] us.
    Chunk 0: a's kernels 0-100, 100-200, its pull 200-210; b's kernel
    230-330 (20 us idle at the switch), its pull 330-340. Chunk 1: a's
    kernel 1000-1300 (the switch from b idles 660 us, 40 of them
    covered by a wire copy) and a side stream's kernel 1100-1105, its
    pull 1300-1310; b's kernel 1310-1410, its pull 1410-1420."""
    ann = lambda name, ts, dur: {"name": "portbench." + name,
                                 "cat": "user_annotation", "ts": ts,
                                 "dur": dur}
    dev = lambda name, ts, dur, cat="kernel": {"name": name, "cat": cat,
                                               "ts": ts, "dur": dur}
    return [ann("window", 0.0, 2000.0),
            ann("queue.0", 0, 50), ann("queue.0.a", 0, 30),
            ann("queue.0.b", 30, 20), ann("queue.1", 400, 50),
            ann("queue.1.a", 400, 30), ann("queue.1.b", 430, 20),
            ann("collect.0", 450, 100),
            dev("segment_cascade_kernel(int)", 0, 100),
            dev("elementwise_kernel(int)", 100, 100),
            dev(PULL, 200, 10, "gpu_memcpy"),
            dev("segment_cascade_kernel(int)", 230, 100),
            dev(PULL, 330, 10, "gpu_memcpy"),
            dev("Memcpy HtoD (Pinned -> Device)", 600, 40, "gpu_memcpy"),
            dev("segment_cascade_kernel(int)", 1000, 300),
            dev("index_elementwise_kernel(int)", 1100, 5),
            dev(PULL, 1300, 10, "gpu_memcpy"),
            dev("reduce_kernel(int)", 1310, 100),
            dev(PULL, 1410, 10, "gpu_memcpy")]


def _range_rec(records=None):
    return dict(_rec(), records=_range_records() if records is None
                else records, span=(0.0, 2000.0), chunks=2)


def test_blocks_follow_the_pulls():
    blocks = range_blocks(_range_records(), (0.0, 2000.0))
    assert [(name, [e["ts"] for e in ks]) for name, ks in blocks] == [
        ("a", [0, 100]), ("b", [230]), ("a", [1000, 1100]), ("b", [1310])]


@pytest.mark.parametrize("name,want", [
    # Switches a->b 20 us, b->a 660 - 40 us, a->b 0 us, over 2 chunks.
    ("range_switch_idle_ms", (20 + 620) * 1e-3 / 2),
    # a: 100 + 100 + 300 + 5 us, b: 100 + 100 us, over 2 chunks.
    ("range_max_ms_per_chunk", 505 * 1e-3 / 2)])
def test_range_readers_on_synthetic_records(name, want):
    assert cell.metric_reader(name)(_range_rec()) == pytest.approx(want)


def test_range_max_is_the_largest_range_by_correlation():
    """With each launch's correlation and runtime call (a traced run with
    the program's spans), ``portbench.spans.range_ms`` gives the same
    largest range where no kernel runs on a side stream."""
    records = [dict(r, tid=1) if r["cat"] == "user_annotation" else dict(r)
               for r in _range_records() if r["ts"] != 1100]
    # Each kernel's start -> its launch, inside queue.<i>.<range>.
    launched = {0: 1, 100: 2, 230: 31, 1000: 401, 1310: 431}
    for i, r in enumerate(list(records)):
        if r["cat"] == "kernel":
            r["correlation"] = i
            records.append({"name": "cudaLaunchKernel",
                            "cat": "cuda_runtime", "ts": launched[r["ts"]],
                            "dur": 1, "tid": 1, "correlation": i})
    by_range = spans.range_ms(records, (0.0, 2000.0), frozenset())
    assert {k: sum(v) for k, v in by_range.items()} == pytest.approx(
        {"a": 0.5, "b": 0.2})
    got = cell.metric_reader("range_max_ms_per_chunk")(_range_rec(records))
    assert got == pytest.approx(0.5 / 2)


@pytest.mark.parametrize("name", READERS)
def test_range_readers_read_nothing_without_ranges(name):
    """A cell without named ranges (the harness's usual records), a
    window without a trace, and pulls that do not match the queues."""
    read = cell.metric_reader(name)
    assert read(_rec()) is None
    assert read(dict(_range_rec(), span=None)) is None
    lost = [r for r in _range_records() if r["ts"] != 1410]
    assert read(_range_rec(lost)) is None
    late = [dict(r, ts=1500) if r["name"] == "portbench.queue.1.b" else r
            for r in _range_records()]
    assert read(_range_rec(late)) is None
    assert read(dict(_range_rec(), chunks=0)) is None
    assert range_blocks(_records(), (0.0, 1000.0)) is None
