"""The comparison that decides ``correct`` fails where it must: the
control (the reference in the program's place at the precision below
the configuration's) and a run with the timed path broken underneath,
at a size the CPU holds; a sound run passes."""
import numpy as np
import pytest
import torch

from portbench import cell, check, control
from portbench.reference import search as ref
from portbench.tests.small import small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", ["quickstart.survey",
                                      "example_long.survey"])
@pytest.mark.parametrize("name", sorted(control.CONTROLS))
def test_control_is_not_correct(workload, name):
    """Against the cell's own limits, on the small series."""
    _, cfg, mix, _, _ = small_cell()
    limits = cell.load_cell(workload)[3]
    _, widths, stages = cell.plan_of(cfg)
    series = control.sampled_series(cfg, mix, limits, 2**33 + 1, CPU)
    raw = np.concatenate([series[s][1] for s in sorted(series)])
    want = check.reference_snr(raw, stages, widths,
                               ref.wire_row(cfg["bins_max"]), CPU)
    nums = control.control_numbers(cfg, stages, widths, raw, want, CPU,
                                   **control.CONTROLS[name])
    _, ok = check.numbers_line(nums, limits["limits"])
    assert not ok, nums


def _run(seed=2**35 + 11):
    wl, cfg, mix, limits, bench = small_cell()
    result, _ = cell.run_cell(wl, cfg, mix, limits, bench, seed, 0.3, False,
                              CPU, 0.0, log=lambda msg: None)
    return result


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"] is True, result["checks"]


def test_half_of_the_batch_left_out(monkeypatch):
    """The second half of each chunk's DM trials searched on the first
    half's wire: the sampled last trial's S/N is wrong."""
    from riptide_tpu_torch.search import engine

    real = engine.ship_stage_data

    def ship(prepared, device):
        wire, meta = real(prepared, device)
        half = wire.shape[0] // 2
        wire = wire.clone()
        wire[half:] = wire[:wire.shape[0] - half]
        meta = dict(meta, scales_dev=meta["scales_dev"].clone())
        meta["scales_dev"][half:] = meta["scales_dev"][:wire.shape[0] - half]
        return wire, meta

    monkeypatch.setattr(engine, "ship_stage_data", ship)
    result = _run()
    assert result["correct"] is False
    assert result["checks"]["snr_rms"]["value"] > \
        result["checks"]["snr_rms"]["limit"]


def test_a_peak_altered_where_it_is_produced(monkeypatch):
    from riptide_tpu_torch.search import engine

    real = engine.collect_search_batch

    def collect(handle, dms):
        peaks, polycos = real(handle, dms)
        p = peaks[0][0]
        peaks[0][0] = p._replace(snr=p.snr + 0.25)
        return peaks, polycos

    monkeypatch.setattr(engine, "collect_search_batch", collect)
    result = _run()
    assert result["correct"] is False and result["failed"] > 0
    assert result["checks"]["peaks_bad"]["value"] > 0


def test_an_snr_altered_where_it_is_produced(monkeypatch):
    """One S/N value of the last trial raised after the stage kernels
    wrote it."""
    from riptide_tpu_torch.search import engine

    real = engine.queue_search_batch

    def queue(*args, **kw):
        handle = real(*args, **kw)
        snr = engine.search_snr_dev(handle)
        snr[-1, snr.shape[1] // 2, 0] += 1.0
        return handle

    monkeypatch.setattr(engine, "queue_search_batch", queue)
    result = _run()
    assert result["correct"] is False
    assert result["checks"]["snr_max"]["value"] > \
        result["checks"]["snr_max"]["limit"]


@pytest.mark.cuda
def test_small_cell_on_the_card_is_correct(cuda_device):
    wl, cfg, mix, limits, bench = small_cell()
    result, _ = cell.run_cell(wl, cfg, mix, limits, bench, 2**36 + 5, 0.5,
                              True, cuda_device, 0.0, log=lambda msg: None)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0
