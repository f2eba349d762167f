"""The plain reference (``portbench/reference``) held to the program's CPU
path and to its own oracles, at small sizes."""
import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference import peaks as ref_peaks
from portbench.reference import search as ref
from portbench.tests.small import small_cell


@pytest.mark.parametrize("m", [1, 2, 3, 5, 7, 16, 37, 100, 255])
def test_ffa_matches_the_recursive_definition(m):
    """Each output row is the sum of the input rows under the recursion
    of riptide's transform, written out here by recursion."""
    from portbench.reference.search import _merge_mapping

    def rec(x):
        if len(x) == 1:
            return x.copy()
        mh = len(x) // 2
        head, tail = rec(x[:mh]), rec(x[mh:])
        h, t, shift = _merge_mapping(len(x))
        cols = (np.arange(x.shape[1])[None, :] + shift[:, None]) % x.shape[1]
        return head[h] + np.take_along_axis(tail[t], cols, axis=1)

    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 13))
    got = ref.ffa(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_allclose(got, rec(x), rtol=0, atol=1e-12)


def test_ffa_and_downsample_match_the_programs_oracles():
    from riptide_tpu_torch.ops.reference import downsample, ffa_transform

    rng = np.random.default_rng(3)
    x = rng.standard_normal((77, 31)).astype(np.float32)
    np.testing.assert_allclose(
        ref.ffa(torch.from_numpy(x).double()[None])[0].numpy(),
        ffa_transform(x), rtol=0, atol=1e-4)
    s = rng.standard_normal(10_000).astype(np.float32)
    for f in (1.5, 2.37, 32.552083):
        n = ref.downsampled_size(s.size, f)
        got = ref.downsample(torch.from_numpy(s).double()[None], f, n)[0]
        np.testing.assert_allclose(got.numpy(), downsample(s, f),
                                   rtol=1e-5, atol=1e-5)


def test_quantise_is_the_uint6_wire():
    """Within half a step of the value, at most 31 steps from zero, and
    the row's largest magnitude exact."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal((2, 1000)).astype(np.float32))
    q = ref.quantise(v, 384, 31)
    rows = torch.nn.functional.pad(v, (0, 152)).view(2, 3, 384)
    scale = rows.abs().amax(-1) / 31
    step = scale.repeat_interleave(384, 1)[:, :1000]
    assert bool(((q - v).abs() <= 0.5 * step * (1 + 1e-6)).all())
    assert bool(((q / step).round().abs() <= 31).all())


def _program_search(cfg, mix, seed):
    """The program's CPU path over one chunk of the small cell: its S/N
    cube and peaks, and the chunk's raw series."""
    from riptide_tpu_torch.search import engine

    from portbench import cell, traffic

    plan, widths, stages = cell.plan_of(cfg)
    x = traffic.make_chunk(cfg, mix, seed, 0, torch.device("cpu")).numpy()
    prepared = engine.prepare_stage_data(plan, x, mode=cfg["wire"])
    handle = engine.queue_search_batch(
        plan, None, plan.size * plan.tsamp,
        shipped=engine.ship_stage_data(prepared, "cpu"), **cfg["find_peaks"])
    snr = engine.search_snr_dev(handle).numpy()
    peaks, _ = engine.collect_search_batch(handle, np.zeros(len(x)))
    return plan, widths, stages, x, snr, peaks


def test_reference_snr_matches_the_programs_cpu_path():
    """Same raw series, same plan order: the reference's S/N (float64
    downsampling and sums, the configured uint6 wire) against the
    program's plain path, and the peaks of the program against the
    reference's find_peaks of the program's S/N."""
    _, cfg, mix, _, _ = small_cell()
    plan, widths, stages, x, snr, peaks = _program_search(cfg, mix, 99)
    periods = np.concatenate([p for s in stages for *_, p in s.trials])
    np.testing.assert_array_equal(periods, plan.all_periods)
    want = check.reference_snr(x, stages, widths, ref.wire_row(
        cfg["bins_max"]), torch.device("cpu"))
    rms, mx = check.snr_gaps(snr, want)
    assert rms < 1e-3 and mx < 0.05, (rms, mx)
    assert peaks[0], "the pulsar trial has peaks"
    for d in range(len(x)):
        got = check.peak_tuples(peaks[d])
        assert got == ref_peaks.find_peaks(periods, snr[d],
                                           plan.size * plan.tsamp,
                                           **cfg["find_peaks"])
    top = check.peak_tuples(peaks[0])[0]
    assert abs(top[3] - cfg["pulsar_period"]) < 1e-2


def test_reference_find_peaks_matches_the_programs():
    from riptide_tpu_torch.peak_detection import find_peaks
    from riptide_tpu_torch.periodogram import Periodogram

    _, cfg, mix, _, _ = small_cell()
    plan, widths, _, _, snr, _ = _program_search(cfg, mix, 5)
    tobs = plan.size * plan.tsamp
    for d in range(snr.shape[0]):
        pg = Periodogram(widths, plan.all_periods, plan.all_foldbins, snr[d],
                         {"dm": 0.0, "tobs": tobs})
        want = check.peak_tuples(find_peaks(pg, **cfg["find_peaks"])[0])
        assert ref_peaks.find_peaks(plan.all_periods, snr[d], tobs,
                                    **cfg["find_peaks"]) == want
