"""
The port's periodogram search against the JAX package's, on the CPU.

* ``run_periodogram(device="cpu")`` against the JAX ``run_periodogram``
  on its gather path with the float32 wire and on its fused-kernel path
  (interpret mode) with the uint6 wire: periods and foldbins equal, S/N
  within rtol 1e-5, atol 1e-4 (the prefix-sum summation order, see
  tests/test_torch_ffa_stage.py).
* ``ffa_search(device="cpu")`` holds the 18.5 +/- 0.15 parity oracle of
  tests/test_search.py with the float32 and the uint6 wire.
* ``run_periodogram_batch`` equals per-row ``run_periodogram``: the wire
  quantises each DM trial on its own, and every stage op is row-wise.
* ``engine.recording`` keeps a search's time split and operands, from
  which the plain stage versions give back the search's own output.
"""
import numpy as np
import pytest

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch import TimeSeries, ffa_search
from riptide_tpu_torch.ops.ffa_kernel import fused_stage_plain
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.ops.reference import (generate_width_trials,
                                             periodogram_ref)
from riptide_tpu_torch.search import (periodogram_plan, run_periodogram,
                                      run_periodogram_batch)

RTOL, ATOL = 1e-5, 1e-4
TINY = (2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)


def _small():
    widths = tuple(int(w) for w in generate_width_trials(24))
    return (8192, 0.001, widths, 0.025, 0.1, 24, 26)


@pytest.mark.parametrize("cfg_name,path,wire", [
    ("tiny", "gather", "float32"),
    ("small", "gather", "float32"),
    ("tiny", "kernel", "uint6"),
])
def test_run_periodogram_matches_reference(monkeypatch, cfg_name, path, wire):
    cfg = TINY if cfg_name == "tiny" else _small()
    monkeypatch.setenv("RIPTIDE_FFA_PATH", path)
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", wire)
    rng = np.random.default_rng(5)
    data = rng.standard_normal(cfg[0]).astype(np.float32)
    P1, F1, S1 = ref_engine.run_periodogram(ref_plan(*cfg), data)
    P2, F2, S2 = run_periodogram(periodogram_plan(*cfg), data, device="cpu")
    np.testing.assert_array_equal(P2, P1)
    np.testing.assert_array_equal(F2, F1)
    assert S2.dtype == np.float32 and S2.shape == S1.shape
    np.testing.assert_allclose(S2, S1, rtol=RTOL, atol=ATOL)


def test_float32_wire_matches_numpy_oracle(monkeypatch):
    """Against the slow numpy periodogram of ops/reference.py, at the
    tolerance tests/test_search.py holds the JAX engine to."""
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "float32")
    cfg = _small()
    rng = np.random.RandomState(0)
    data = rng.normal(size=cfg[0]).astype(np.float32)
    data = ((data - data.mean()) / data.std()).astype(np.float32)
    P1, F1, S1 = periodogram_ref(data, cfg[1], np.asarray(cfg[2]), *cfg[3:])
    P2, F2, S2 = run_periodogram(periodogram_plan(*cfg), data, device="cpu")
    np.testing.assert_array_equal(F1, F2)
    np.testing.assert_allclose(P1, P2, rtol=1e-12)
    np.testing.assert_allclose(S1, S2, atol=2e-3)


@pytest.mark.parametrize("wire", ["float32", "uint6"])
def test_snr_parity_oracle(monkeypatch, wire):
    """Seeded fake pulsar, P = 1 s, amplitude 20, ducy 0.02, 128 s at
    256 us, searched over P 0.5-2.0 s, bins 480-520, ducy_max 0.3: the
    best trial at S/N 18.5 +/- 0.15, width 13, frequency within 0.1/T."""
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", wire)
    np.random.seed(0)
    ts = TimeSeries.generate(length=128.0, tsamp=256e-6, period=1.0,
                             amplitude=20.0, ducy=0.02)
    _, pgram = ffa_search(ts, period_min=0.5, period_max=2.0, bins_min=480,
                          bins_max=520, ducy_max=0.3, device="cpu")
    ip, iw = np.unravel_index(np.argmax(pgram.snrs), pgram.snrs.shape)
    assert abs(1.0 / pgram.periods[ip] - 1.0) < 0.1 / 128.0
    assert int(pgram.widths[iw]) == 13
    assert abs(pgram.snrs[ip, iw] - 18.5) < 0.15


@pytest.mark.parametrize("wire", ["float32", "uint6"])
def test_batch_equals_single(monkeypatch, wire):
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", wire)
    plan = periodogram_plan(*TINY)
    rng = np.random.default_rng(8)
    batch = rng.standard_normal((3, TINY[0])).astype(np.float32)
    P, F, S = run_periodogram_batch(plan, batch, device="cpu")
    assert S.shape == (3, plan.length, len(plan.widths))
    for d in range(3):
        Pd, Fd, Sd = run_periodogram(plan, batch[d], device="cpu")
        np.testing.assert_array_equal(P, Pd)
        np.testing.assert_array_equal(F, Fd)
        np.testing.assert_array_equal(S[d], Sd)


def test_recording_keeps_split_and_operands(monkeypatch):
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "uint6")
    plan = periodogram_plan(*TINY)
    batch = np.random.default_rng(9).standard_normal(
        (2, TINY[0])).astype(np.float32)
    with engine.recording() as rec:
        _, _, S = run_periodogram_batch(plan, batch, device="cpu")
    assert engine._RECORD is None
    for key in ("prep_s", "ship_s", "stages_s", "out_s"):
        assert rec[key] >= 0.0
    assert "stage_ms" not in rec  # per-stage time is the ffa_stage spans'
    assert len(rec["outs"]) == len(rec["layout"]) == len(plan.stages)
    outs = [o for souts in rec["outs"] for o in souts]
    assert [r["out"] for r in rec["launches"]] == outs
    for r in rec["launches"]:
        assert r["kind"] == "fused_stage"
        np.testing.assert_array_equal(r["out"].numpy(),
                                      fused_stage_plain(*r["args"]).numpy())
    np.testing.assert_array_equal(
        engine._assemble_device(plan, rec["layout"], rec["outs"]).numpy(), S)


def test_periods_monotonic_and_identity_contract():
    """Contract checks of tests/test_search.py: increasing trial periods,
    matching lengths, and deredden=False + already_normalised=True
    returns the input TimeSeries object itself."""
    np.random.seed(42)
    ts = TimeSeries.generate(length=20.0, tsamp=0.001, period=1.0,
                             amplitude=15.0)
    tsn, pgram = ffa_search(ts, period_min=0.5, period_max=2.0, bins_min=32,
                            bins_max=36, device="cpu")
    assert np.all(np.diff(pgram.periods) > 0)
    assert pgram.snrs.shape == (pgram.periods.size, pgram.widths.size)
    assert pgram.metadata is tsn.metadata
    out, _ = ffa_search(ts, period_min=0.5, period_max=1.0, bins_min=32,
                        bins_max=36, deredden=False, already_normalised=True,
                        device="cpu")
    assert out is ts


def test_masked_series_matches_reference(monkeypatch):
    """A series with NaNs and a dead span goes through the same DQ
    scan, repair and normalisation as in the JAX package (float32 wire,
    the JAX package's CPU default). The de-reddened samples differ by
    float32 rounding only (the scrunch mean and the interpolation sum in
    another order), so the S/N holds the stage tolerance."""
    import riptide_tpu

    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "float32")
    np.random.seed(4)
    data = np.random.normal(size=40000).astype(np.float32)
    data[1000:1010] = np.nan
    data[20000:22000] = 3.0
    kw = dict(period_min=0.5, period_max=2.0, bins_min=32, bins_max=36)
    ref_ts, ref_pg = riptide_tpu.ffa_search(
        riptide_tpu.TimeSeries(data.copy(), 0.001), **kw)
    ts, pg = ffa_search(TimeSeries(data.copy(), 0.001), device="cpu", **kw)
    assert ts.metadata["dq_nsamp_eff"] == ref_ts.metadata["dq_nsamp_eff"]
    np.testing.assert_allclose(ts.data, ref_ts.data, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pg.snrs, ref_pg.snrs, rtol=RTOL, atol=ATOL)
