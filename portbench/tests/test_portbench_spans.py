"""The readers of the program's spans (``portbench/spans.py`` and the span
metrics) on synthetic profiler records, their records against
``portbench.trace.load_chrome_trace``'s, and a traced run with the
program's spans on the CPU."""
import json
import os

import pytest
import torch

from portbench import cell, spans, spans_run, trace
from portbench.tests.small import small_cell
from portbench.tests.test_portbench_harness import (BENCH, NAME, UNIT,
                                                    _rec, _records)

SPAN_NAMES = [m["name"] for m in spans_run.SPAN_METRICS]
MAIN, SHIP = 11, 12


def _events():
    """A Chrome trace of a window [0, 800] us on the main thread, as the
    profiler writes it: the harness's annotations, the program's spans,
    runtime calls and the kernels and copies they launched
    (``correlation``), and a wire copy from the ship thread during the
    tail."""
    def x(cat, name, ts, dur, tid=MAIN, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": 1, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    ann = lambda name, ts, dur, tid=MAIN: x("user_annotation", name, ts,
                                             dur, tid)
    call = lambda name, ts, dur, corr=None, tid=MAIN: x(
        "cuda_runtime", name, ts, dur, tid, corr)
    dev = lambda name, ts, dur, corr, cat="kernel": x(cat, name, ts, dur,
                                                      7, corr)
    return [
        ann("portbench.window", 0.0, 800.0), ann("portbench.queue.0", 0, 300),
        ann("portbench.collect.0", 600, 200),
        ann("riptide.stages", 0, 100), ann("riptide.ffa_stage.0", 0, 50),
        ann("riptide.ffa_stage.1", 50, 50), ann("riptide.assemble", 100, 10),
        ann("riptide.peaks", 110, 190), ann("riptide.peaks.stats", 110, 90),
        ann("riptide.peaks.cluster", 200, 100), ann("riptide.pull", 600, 50),
        ann("riptide.tail", 650, 150), ann("riptide.overflow", 700, 20),
        ann("riptide.wire", 655, 50, SHIP), ann("other.annotation", 0, 5),
        call("cudaLaunchKernel", 10, 2, 1), call("cudaLaunchKernel", 60, 2, 2),
        call("cudaLaunchKernel", 105, 2, 3),
        call("cudaMemcpyAsync", 120, 1, 4),
        call("cudaStreamSynchronize", 121, 95),
        call("cudaLaunchKernel", 220, 2, 5),
        call("cudaStreamSynchronize", 250, 40),
        call("cudaStreamSynchronize", 620, 25),
        call("cudaLaunchKernel", 705, 2, 6),
        call("cudaMemcpyAsync", 658, 1, 7, SHIP),
        call("cudaStreamSynchronize", 660, 40, tid=SHIP),
        dev("void segment_cascade_kernel<4>(float const*, int)", 20, 100, 1),
        dev("ffa_level_kernel(float const*, float*)", 120, 80, 2),
        dev("CatArrayBatchedCopy<4>(int)", 200, 10, 3),
        dev("Memcpy HtoD (Pageable -> Device)", 215, 1, 4, "gpu_memcpy"),
        dev("void at::native::elementwise_kernel<128>(int)", 230, 170, 5),
        dev("index_elementwise_kernel(int)", 710, 5, 6),
        dev("Memcpy HtoD (Pinned -> Device)", 660, 40, 7, "gpu_memcpy"),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 10, "id": 1},
    ]


def _span_rec(chunks=2):
    records = spans.parse_events(_events())
    return dict(_rec(), records=records, span=trace.window_span(records),
                chunks=chunks)


@pytest.mark.parametrize("name,want", [
    # Two blocking calls in the queue's spans (95 and 40 us; the pull's
    # and the ship thread's are not the queue's) over 2 chunks.
    ("queue_sync_ms", 0.135 / 2), ("queue_syncs_per_chunk", 1.0),
    ("assemble_ms_per_chunk", 0.010 / 2),
    # The cluster step's kernel; the copy is no kernel.
    ("peak_program_ms_per_chunk", 0.170 / 2),
    ("collect_tail_ms", 0.150 / 2),
    # The tail [650, 800] less the wire copy [660, 700] and the
    # overflow kernel [710, 715].
    ("tail_idle_ms", 0.105 / 2)])
def test_span_readers_on_synthetic_records(name, want):
    assert cell.metric_reader(name)(_span_rec()) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_NAMES)
def test_span_readers_read_nothing_from_an_empty_trace(name):
    rec = dict(_rec(), records=[_records()[0]])
    assert cell.metric_reader(name)(rec) is None
    assert cell.metric_reader(name)(dict(_span_rec(), chunks=0)) is None


def test_kernels_belong_to_the_span_that_launched_them():
    records = spans.parse_events(_events())
    stacks = spans.launch_stacks(records)
    assert stacks[1] == ("riptide.stages", "riptide.ffa_stage.0")
    assert stacks[5] == ("riptide.peaks", "riptide.peaks.cluster")
    assert stacks[6] == ("riptide.tail", "riptide.overflow")
    assert stacks[7] == ("riptide.wire",)
    lines = spans.report_lines(records, trace.window_span(records), 1,
                               frozenset(["segment_cascade_kernel",
                                          "ffa_level_kernel"]))
    gaps, host, syncs, stage, other = (json.loads(ln.split(": ", 1)[1])
                                       for ln in lines)
    # Seconds: [400, 660] us with no span open, [715, 800] in the tail,
    # [700, 710] in the overflow gather.
    assert gaps[:2] == [["none", 260e-6], ["riptide.tail", 85e-6]]
    assert ["riptide.overflow", 10e-6] in gaps
    assert host == {"peaks": 0.19, "tail": 0.15, "ffa_stage": 0.1,
                    "stages": 0.1, "peaks.cluster": 0.1, "peaks.stats": 0.09,
                    "pull": 0.05, "overflow": 0.02, "assemble": 0.01}
    assert syncs == {"riptide.peaks.stats cudaStreamSynchronize": [1, 0.095],
                     "riptide.peaks.cluster cudaStreamSynchronize": [1, 0.04]}
    assert stage == {"0": 0.1, "1": 0.08}
    assert other == {"assemble": 0.01, "overflow": 0.005,
                     "peaks.cluster": 0.17}


class _Profile:
    """Stands in for a finished ``torch.profiler.profile``."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as fobj:
            json.dump({"traceEvents": self.events}, fobj)


def _base(records):
    """The records as ``trace.load_chrome_trace`` reads them."""
    keep = trace.DEVICE_CATS + ("user_annotation",)
    return [{k: r[k] for k in ("name", "cat", "ts", "dur")}
            for r in records if r["cat"] in keep]


def test_records_hold_the_harness_records_unchanged():
    prof = _Profile(_events())
    assert _base(spans.load_records(prof)) == trace.load_chrome_trace(prof)


def test_existing_readers_read_the_same_with_the_span_records():
    """Every reader of ``BENCHMARK.json``, ``device_events``,
    ``window_span`` and ``breakdown`` read the same from the harness's
    records as from those records with the program's spans, the runtime
    calls, threads and correlations added."""
    plain = _records()
    extra = [dict(r, tid=MAIN) if r["cat"] == "user_annotation"
             else dict(r, correlation=100 + i) for i, r in enumerate(plain)]
    extra += [r for r in spans.parse_events(_events())
              if r["cat"] in (spans.SPAN_CAT,) + spans.RUNTIME_CATS]
    for name in [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]]:
        read = cell.metric_reader(name)
        assert read(dict(_rec(), records=extra)) == read(_rec()), name
    span = (0.0, 1000.0)
    assert trace.window_span(extra) == trace.window_span(plain) == span
    assert _base(trace.device_events(extra, span)) == \
        trace.device_events(plain, span)
    assert trace.breakdown(extra, span) == trace.breakdown(plain, span)


def test_span_metrics_are_benchmark_entries():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in spans_run.SPAN_METRICS:
        assert set(m) == set(BENCH["per_layer"][0])
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["layer"] in layers and m["moves"] in e2e
        assert m["source"] == "program_span"
        assert os.path.isfile(os.path.join(cell.HERE, "metrics",
                                           m["name"] + ".py"))
    assert not set(SPAN_NAMES) & {m["name"] for m in BENCH["per_layer"]}


def test_traced_run_with_the_program_spans():
    """On the CPU the profiler sees the program's spans but no kernel:
    the tail's span metrics read, the device's do not, and the run
    leaves no tracer and the harness's loader behind."""
    from riptide_tpu_torch.obs import trace as program_trace

    wl, cfg, mix, limits, bench = small_cell()
    logged = []
    result, _ = spans_run.run_traced(wl, cfg, mix, limits, bench,
                                     2**40 + 11, 0.5, torch.device("cpu"),
                                     0.0, log=logged.append)
    assert result["correct"] is True
    got = set(result["metrics"])
    assert {"collect_tail_ms", "tail_idle_ms"} <= got
    assert not got & {"queue_sync_ms", "assemble_ms_per_chunk",
                      "peak_program_ms_per_chunk"}
    assert any(msg.startswith("idle gaps by program span") for msg in logged)
    assert program_trace.get_tracer() is None
    assert cell.load_chrome_trace is trace.load_chrome_trace
