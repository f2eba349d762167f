"""A configuration of several search ranges on the CPU: each range is
searched as it would be alone, its numbers are compared under its own
names, a fault in one range fails that range's numbers only, and a
configuration without ranges reads as one range of its top-level keys."""
import copy
import json

import numpy as np
import pytest
import torch

from portbench import cell, check, control, loop, spans, trace, traffic
from portbench.ranges import RANGE_KEYS, ranges
from portbench.tests.small import RANGES, two_range_cell
from portbench.tests.test_portbench_spans import _events

CPU = torch.device("cpu")
SEED = 2**37 + 9
NUMBERS = ("snr_rms", "snr_max", "peaks_bad")


def _run(cell_args, seed=SEED, monkeypatch=None):
    """``run_cell`` of a short CPU run; with ``monkeypatch``, also the
    window's S/N cubes and peaks, as the window returned them."""
    wins = []
    if monkeypatch is not None:
        real = loop.run_window

        def keep(*args, **kw):
            win = real(*args, **kw)
            wins.append(dict(win, snr={s: list(c)
                                       for s, c in win["snr"].items()}))
            return win

        monkeypatch.setattr(cell, "run_window", keep)
    result, _ = cell.run_cell(*cell_args, seed, 0.3, False, CPU, 0.0,
                              log=lambda msg: None)
    return result, (wins[0] if wins else None)


def _last_peaks(win, r):
    """{slot: range ``r``'s peak tuples per trial of the slot's last
    chunk}."""
    return {s: [check.peak_tuples(p) for p in win["peaks"][c][r]]
            for c, s in enumerate(win["slots"])}


def test_each_range_is_searched_as_it_would_be_alone(monkeypatch):
    """Each range's S/N cubes and peaks equal those of the same range run
    alone, as a configuration without ranges, on the same chunks."""
    two = two_range_cell()
    result, win = _run(two, monkeypatch=monkeypatch)
    assert result["correct"] is True, result["checks"]
    make = traffic.make_chunk
    monkeypatch.setattr(traffic, "make_chunk",
                        lambda cfg, *a: make(two[1], *a))
    for r, (name, rcfg) in enumerate(ranges(two[1])):
        alone = dict(rcfg)
        limits = dict(two[3], limits={k: two[3]["limits"][f"{k}.{name}"]
                                      for k in NUMBERS})
        one, win1 = _run((two[0], alone, two[2], limits, two[4]),
                         monkeypatch=monkeypatch)
        assert one["correct"] is True and list(one["checks"]) == \
            list(NUMBERS)
        for s in (0, 1):
            (cube,) = win1["snr"][s]
            assert torch.equal(win["snr"][s][r], cube), (name, s)
        assert _last_peaks(win, r) == _last_peaks(win1, 0), name
        assert _last_peaks(win, r)[0][0], f"range {name}: trial 0's pulsar"


def test_numbers_are_named_by_range():
    result, _ = _run(two_range_cell())
    assert list(result["checks"]) == [f"{k}.{r['name']}" for r in RANGES
                                      for k in NUMBERS]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 4 == 0 and result["attempted"] >= 8
    json.dumps(result)


def test_one_range_wire_swapped_fails_that_range_only(monkeypatch):
    """Range b's second half of each chunk's DM trials searched on its
    first half's wire: b's numbers fail, a's hold."""
    from riptide_tpu_torch.search import engine

    real = engine.queue_search_batch

    def queue(plan, batch, tobs, shipped=None, **kw):
        if plan.bins_min == RANGES[1]["bins_min"]:
            wire, meta = shipped
            half = wire.shape[0] // 2
            wire = wire.clone()
            wire[half:] = wire[:wire.shape[0] - half]
            meta = dict(meta, scales_dev=meta["scales_dev"].clone())
            meta["scales_dev"][half:] = \
                meta["scales_dev"][:wire.shape[0] - half]
            shipped = (wire, meta)
        return real(plan, batch, tobs, shipped=shipped, **kw)

    monkeypatch.setattr(engine, "queue_search_batch", queue)
    result, _ = _run(two_range_cell())
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["snr_rms.b"]["value"] > checks["snr_rms.b"]["limit"]
    for k in NUMBERS:
        assert checks[f"{k}.a"]["value"] <= checks[f"{k}.a"]["limit"], k


def test_failed_counts_a_trial_once_over_its_ranges(monkeypatch):
    """Trial 0's first peak altered in every range of every chunk: each
    range's peaks fail, and each chunk counts trial 0 once."""
    from riptide_tpu_torch.search import engine

    real = engine.collect_search_batch

    def collect(handle, dms):
        peaks, polycos = real(handle, dms)
        p = peaks[0][0]
        peaks[0][0] = p._replace(snr=p.snr + 0.25)
        return peaks, polycos

    monkeypatch.setattr(engine, "collect_search_batch", collect)
    result, _ = _run(two_range_cell())
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] // 4
    for r in RANGES:
        assert result["checks"][f"peaks_bad.{r['name']}"]["value"] > 0


def _old_make_chunk(cfg, mix, seed, slot, device):
    """The chunk as the generator made it before configurations could
    list ranges: one train at the top-level ``pulsar_period``."""
    D, N = int(mix["dm_trials"]), int(cfg["nsamp"])
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.slot_seed(seed, slot))
    x = torch.randn((D, N), generator=gen, dtype=torch.float32,
                    device=device)
    psr = mix["pulsar"]
    train = traffic.pulse_train(N, cfg["pulsar_period"] / cfg["tsamp"],
                                psr["phi0"], psr["ducy"], psr["amplitude"],
                                device).float()
    for t in psr["trials"]:
        x[t] += train
    x -= x.mean(dim=1, keepdim=True)
    x /= x.std(dim=1, keepdim=True, correction=0)
    return x


@pytest.mark.parametrize("workload", ["quickstart.survey",
                                      "example_long.survey"])
def test_a_configuration_without_ranges_reads_as_its_top_level_keys(
        workload):
    """One unnamed range, the configuration itself: the same plan, the
    same chunk bit for bit as before ranges existed (at 2^18 samples,
    which hold a period of either pulsar), and the same again written as
    a one-range ``ranges`` list."""
    _, cfg, mix, _, _ = cell.load_cell(workload)
    assert ranges(cfg) == [(None, cfg)]
    listed = dict({k: v for k, v in cfg.items() if k not in RANGE_KEYS},
                  ranges=[dict({k: cfg.get(k, 8) for k in RANGE_KEYS},
                               name="only")])
    ((name, rcfg),) = ranges(listed)
    assert name == "only"
    plan, widths, stages = cell.plan_of(cfg)
    plan2, widths2, stages2 = cell.plan_of(rcfg)
    assert widths == widths2 and plan.length == plan2.length
    np.testing.assert_array_equal(plan.all_periods, plan2.all_periods)
    assert [(s.f, s.n) for s in stages] == [(s.f, s.n) for s in stages2]
    small = dict(copy.deepcopy(cfg), nsamp=1 << 18)
    mix = dict(mix, dm_trials=4)
    want = _old_make_chunk(small, mix, 2**40 + 1, 1, CPU)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(traffic.make_chunk(small, mix, 2**40 + 1, 1, CPU),
                       want)
    assert torch.equal(traffic.make_chunk(dict(listed, nsamp=1 << 18), mix,
                                          2**40 + 1, 1, CPU), want)


def test_ranges_need_distinct_names():
    _, cfg, _, _, _ = two_range_cell()
    cfg = dict(cfg, ranges=[cfg["ranges"][0]] * 2)
    with pytest.raises(ValueError):
        ranges(cfg)


def test_each_ranges_control_is_not_correct():
    """The controls per range, under the range's names, against the
    two-range limits."""
    _, cfg, mix, limits, _ = two_range_cell()
    lines = list(control.control_lines(cfg, mix, limits, [2**33 + 1], CPU))
    assert [(name, sorted(line)) for _, name, line, _ in lines] == [
        (c, sorted(f"{k}.{r['name']}" for k in NUMBERS))
        for r in RANGES for c in control.CONTROLS]
    assert not any(ok for *_, ok in lines)


def test_kernels_by_range_on_synthetic_records():
    """Range annotations inside the chunk's queue: K1 by name, the peak
    program by the program's ``peaks`` span, the rest as other."""
    events = _events() + [
        {"ph": "X", "cat": "user_annotation", "name": f"portbench.queue.0.{r}",
         "ts": ts, "dur": dur, "pid": 1, "tid": 11}
        for r, ts, dur in (("a", 0, 110), ("b", 110, 190))]
    records = spans.parse_events(events)
    span = trace.window_span(records)
    k1 = frozenset(["segment_cascade_kernel", "ffa_level_kernel"])
    got = spans.range_ms(records, span, k1)
    assert {k: [round(v, 6) for v in vs] for k, vs in got.items()} == {
        "a": [0.18, 0.0, 0.01], "b": [0.0, 0.17, 0.0]}
    line = spans.report_lines(records, span, 2, k1)[-1]
    assert json.loads(line.split(": ", 1)[1]) == {
        "a": [0.09, 0.0, 0.005], "b": [0.0, 0.085, 0.0]}
    assert spans.range_ms(spans.parse_events(_events()), span, k1) == {}
