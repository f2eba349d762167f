"""
The port's pipeline searcher (``BatchSearcher``) over a configuration of
three search ranges shaped like riptide's ``example.yaml`` (``short``,
``medium``, ``long``, the bins doubling from range to range), at a small
size on the CPU: 2^15 samples at 1 ms, a chunk of 4 DM trials with a
pulsar in each range in trial 0.

One chunk goes through the searcher's own path (``_prepare_chunk`` ->
``_ship_chunk`` -> ``_queue_chunk`` -> ``_collect_chunk``) with the span
tracer installed, the profiler recording and a fresh metrics registry.
Each range's peaks must equal those of ``queue_search_batch`` /
``collect_search_batch`` run range by range on the same chunk, as the
benchmark's harness runs them (``portbench/loop.py``); each range's S/N
must agree with the benchmark's plain reference (``portbench/reference``)
within the tolerances of ``portbench/tests``; each range's queue and
collect are ``riptide.range.<name>`` annotations in the profiler's trace
and timers in the registry, and the ranges-queued counter counts three.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import cell, check, traffic
from portbench.reference import search as ref
from riptide_tpu_torch.obs import trace
from riptide_tpu_torch.pipeline.batcher import BatchSearcher
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.survey.metrics import MetricsRegistry, set_metrics
from riptide_tpu_torch.time_series import TimeSeries

CPU = torch.device("cpu")
NSAMP, TSAMP, D = 1 << 15, 1e-3, 4
SEED = 2**35 + 17
PEAK_KW = {"smin": 6.0, "segwidth": 5.0, "nstd": 6.0, "minseg": 10,
           "polydeg": 2, "clrad": 0.1}
# (name, period_min, period_max, bins_min, bins_max, pulsar period)
RANGES = [("short", 0.1, 0.25, 60, 66, 0.15),
          ("medium", 0.25, 1.0, 120, 132, 0.5),
          ("long", 1.0, 4.0, 240, 264, 2.0)]
NAMES = [r[0] for r in RANGES]


def _pipeline_confs():
    """The ranges as the pipeline's configuration lists them."""
    return [{"name": name,
             "ffa_search": {"period_min": a, "period_max": b,
                            "bins_min": lo, "bins_max": hi, "fpmin": 8,
                            "wtsp": 1.5, "ducy_max": 0.2},
             "find_peaks": dict(PEAK_KW)}
            for name, a, b, lo, hi, _ in RANGES]


def _harness_cfg():
    """The ranges as the benchmark's configurations list them."""
    return {"nsamp": NSAMP, "tsamp": TSAMP, "wire": "uint6",
            "compute": "float32",
            "ranges": [{"name": name, "period_min": a, "period_max": b,
                        "bins_min": lo, "bins_max": hi, "fpmin": 8,
                        "ducy_max": 0.2, "wtsp": 1.5,
                        "find_peaks": dict(PEAK_KW), "pulsar_period": p}
                       for name, a, b, lo, hi, p in RANGES]}


MIX = {"dm_trials": D, "pulsar": {"trials": [0], "amplitude": 20.0,
                                  "ducy": 0.02, "phi0": 0.5}}
DMS = np.arange(D, dtype=float) * 10.0


def _searched_by_the_pipeline(x, monkeypatch):
    """One chunk through the searcher's own path with a tracer, the
    profiler and a fresh registry. Returns (per range: its peaks and
    the S/N cube it queued; the profiler's annotations; the tracer's
    span events; the registry)."""
    from riptide_tpu_torch.pipeline import batcher

    cubes = []
    real = batcher.queue_search_batch

    def queue(*args, **kw):
        handle = real(*args, **kw)
        cubes.append(engine.search_snr_dev(handle).clone())
        return handle

    monkeypatch.setattr(batcher, "queue_search_batch", queue)
    tslist = [TimeSeries(x[d], TSAMP, metadata={"dm": DMS[d]})
              for d in range(D)]
    searcher = BatchSearcher({"rmed_width": 4.0, "rmed_minpts": 101},
                             _pipeline_confs(), device="cpu")
    reg = MetricsRegistry()
    prev_reg = set_metrics(reg)
    tracer = trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            items = searcher._prepare_chunk(tslist)
            queued = searcher._queue_chunk(searcher._ship_chunk(items))
            peaks = [searcher._collect_chunk([c]) for c in queued]
            searcher.release_chunk(items)
    finally:
        trace.disable()
        set_metrics(prev_reg)
    events = prof.events()
    names = [e.name for e in events if e.name.startswith("riptide.")]
    return list(zip(peaks, cubes)), names, tracer.events(), reg


def _searched_by_the_harness(x, cfg):
    """Each range's peaks (flat, as the searcher returns them) from
    ``queue_search_batch`` / ``collect_search_batch`` on the chunk, as
    the benchmark's harness queues and collects them."""
    from portbench.ranges import ranges

    out = []
    for _, rcfg in ranges(cfg):
        plan, _, _ = cell.plan_of(rcfg)
        prepared = engine.prepare_stage_data(plan, x, mode=rcfg["wire"])
        handle = engine.queue_search_batch(
            plan, None, plan.size * plan.tsamp,
            shipped=engine.ship_stage_data(prepared, CPU),
            **rcfg["find_peaks"])
        ppt, _ = engine.collect_search_batch(handle, DMS)
        out.append([p for d in range(D) for p in ppt[d]])
    return out


@pytest.fixture(scope="module")
def searched():
    mp = pytest.MonkeyPatch()
    cfg = _harness_cfg()
    x = traffic.make_chunk(cfg, MIX, SEED, 0, CPU).numpy()
    try:
        return (cfg, x, *_searched_by_the_pipeline(x, mp),
                _searched_by_the_harness(x, cfg))
    finally:
        mp.undo()


def test_each_ranges_peaks_match_the_harness_posture(searched):
    _, _, ranges_out, _, _, _, harness = searched
    assert len(ranges_out) == len(RANGES) == len(harness)
    for name, (peaks, _), want in zip(NAMES, ranges_out, harness):
        assert peaks == want, name
        assert peaks, f"range {name}: trial 0's pulsar"


@pytest.mark.parametrize("r", range(len(RANGES)), ids=NAMES)
def test_each_ranges_snr_matches_the_reference(searched, r):
    from portbench.ranges import ranges

    cfg, x, ranges_out, _, _, _, _ = searched
    _, rcfg = ranges(cfg)[r]
    _, widths, stages = cell.plan_of(rcfg)
    want = check.reference_snr(x, stages, widths,
                               ref.wire_row(rcfg["bins_max"]), CPU)
    rms, mx = check.snr_gaps(ranges_out[r][1], want)
    assert rms < 1e-3 and mx < 0.05, (NAMES[r], rms, mx)
    assert any(abs(p.period - RANGES[r][5]) < 1e-2 and p.dm == DMS[0]
               for p in ranges_out[r][0]), f"range {NAMES[r]}: its pulsar"


def test_each_range_is_a_profiler_annotation_and_a_span(searched):
    """Each range's queue and its collect: one ``riptide.range.<name>``
    annotation and one ``range`` span each, in the ranges' order."""
    _, _, _, names, events, _ = searched[:6]
    for name in NAMES:
        assert names.count(f"riptide.range.{name}") == 2, name
    ranges_seen = [attrs["range"] for n, _, _, _, attrs, _ in events
                   if n == "range"]
    assert ranges_seen == NAMES + NAMES
    assert names.count("riptide.stages") == len(RANGES)
    assert names.count("riptide.pull") == len(RANGES)


def test_the_registry_counts_and_times_each_range(searched):
    reg = searched[5]
    assert reg.counter("ranges_queued") == len(RANGES)
    snap = reg.snapshot()["timers"]
    for name in NAMES:
        for step in ("queue_s", "collect_s"):
            assert snap[f"range.{name}.{step}"]["count"] == 1, (name, step)
    summary = reg.summary()
    assert summary["ranges_queued"] == len(RANGES)
    json.dumps(summary)


def test_an_unnamed_range_is_named_by_its_position():
    confs = [dict(c) for c in _pipeline_confs()]
    del confs[1]["name"]
    searcher = BatchSearcher({"rmed_width": 4.0, "rmed_minpts": 101},
                             confs, device="cpu")
    assert [searcher._range_name(c) for c in confs] == ["short", "1",
                                                        "long"]


def test_without_a_tracer_the_range_span_is_the_null_span():
    assert trace.get_tracer() is None
    assert trace.span("range", range="short") is trace.NULL_SPAN
