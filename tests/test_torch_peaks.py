"""
The port's device peak detection and survey batch against the JAX
package's, on the CPU.

* Fed the same S/N cube, the port's ``PeakPlan`` segment statistics are
  bitwise the JAX package's, and ``device_find_peaks`` gives the same
  Peak lists, threshold polynomials and advisory harmonic counts, with
  ``RIPTIDE_DEVICE_CLUSTER`` on and off.
* End to end, ``run_search_batch(device="cpu")`` on a D = 2 batch with a
  pulsar in series 0 (the configuration of tests/test_row_pack.py) finds
  the peaks the JAX package's ``run_search_batch`` finds on its gather
  path (same uint6 wire), at the same (iw, ip), with S/N within rtol
  1e-5 (the S/N's summation order), and its peak CSV bytes are the same
  with row packing on and off.
"""
import csv
import io

import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.libffa import generate_signal
from riptide_tpu.search import peaks_device as ref_peaks
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu.survey.metrics import MetricsRegistry, set_metrics
from riptide_tpu_torch.survey.metrics import MetricsRegistry as PortRegistry
from riptide_tpu_torch.survey.metrics import set_metrics as port_set_metrics
from riptide_tpu_torch.search import engine, peaks_device, run_search_batch
from riptide_tpu_torch.search.plan import periodogram_plan

SIZE, TSAMP = 1200, 1e-3
CFG = (SIZE, TSAMP, (1, 2, 3), 32e-3, 0.11, 32, 40)
TOBS = SIZE * TSAMP
PKW = dict(smin=6.0, segwidth=0.2, nstd=6.0, minseg=10, polydeg=2,
           clrad=0.1)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(21)
    b = rng.standard_normal((2, SIZE)).astype(np.float32)
    np.random.seed(9)
    b[0] = generate_signal(SIZE, 0.05 / TSAMP, amplitude=14.0, ducy=0.08)
    b -= b.mean(axis=1, keepdims=True)
    b /= b.std(axis=1, keepdims=True)
    return b


@pytest.fixture(scope="module")
def cube(batch):
    _, _, snrs = engine.run_periodogram_batch(periodogram_plan(*CFG), batch,
                                              device="cpu")
    return snrs


def _csv_bytes(peaks):
    buf = io.StringIO()
    writer = csv.writer(buf)
    for p in peaks:
        writer.writerow(repr(v) for v in p.summary_dict().values())
    return buf.getvalue().encode()


@pytest.mark.parametrize("dc", ["1", "0"])
@pytest.mark.parametrize("smin", [6.0, 3.0])
def test_peaks_match_reference_on_same_cube(monkeypatch, cube, dc, smin):
    monkeypatch.setenv("RIPTIDE_DEVICE_CLUSTER", dc)
    kw = dict(PKW, smin=smin)
    pp = engine._peak_plan(periodogram_plan(*CFG), TOBS, **kw)
    ref_pp = ref_engine._peak_plan(ref_plan(*CFG), TOBS, **kw)
    assert pp.device_cluster == (dc == "1") == ref_pp.device_cluster
    s = torch.from_numpy(cube).transpose(1, 2).contiguous()
    np.testing.assert_array_equal(pp._stats_impl(s).numpy(),
                                  np.asarray(ref_pp._stats(cube)))
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        want, want_poly = ref_peaks.device_find_peaks(ref_pp, cube,
                                                      np.zeros(2))
    finally:
        set_metrics(prev)
    port_reg = PortRegistry()
    prev = port_set_metrics(port_reg)
    try:
        got, got_poly = peaks_device.device_find_peaks(pp, cube,
                                                       np.zeros(2))
    finally:
        port_set_metrics(prev)
    assert got == want
    assert any(got)
    for gp, wp in zip(got_poly, want_poly):
        assert gp.keys() == wp.keys()
        for iw in gp:
            np.testing.assert_array_equal(gp[iw], wp[iw])
    ref_counts = reg.summary()
    for key in ("harmonic_suspects", "cluster_cols_device",
                "cluster_cols_host"):
        assert port_reg.counter(key) == ref_counts.get(key, 0), key


def test_run_search_batch_matches_reference(monkeypatch, batch):
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "uint6")
    monkeypatch.setenv("RIPTIDE_KERNEL_BASE3", "0")
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")
    plan = periodogram_plan(*CFG)
    assert engine.queued_launches(plan)["paired_stage"] == 1
    want, _ = ref_engine.run_search_batch(ref_plan(*CFG), batch, TOBS,
                                          **PKW)
    got, _ = run_search_batch(plan, batch, TOBS, device="cpu", **PKW)
    assert any(got)
    for g, w in zip(got, want):
        key = sorted((p.iw, p.ip) for p in g)
        assert key == sorted((p.iw, p.ip) for p in w)
        gs = {(p.iw, p.ip): p.snr for p in g}
        for p in w:
            np.testing.assert_allclose(gs[(p.iw, p.ip)], p.snr, rtol=1e-5)
    monkeypatch.setenv("RIPTIDE_KERNEL_ROW_PACK", "0")
    assert engine.queued_launches(plan)["paired_stage"] == 0
    off, _ = run_search_batch(plan, batch, TOBS, device="cpu", **PKW)
    assert [_csv_bytes(p) for p in got] == [_csv_bytes(p) for p in off]


def test_queue_collect_with_prepared_and_shipped(monkeypatch, batch):
    """``prepared=`` and ``shipped=`` skip the host prep and the copy
    and give the same peaks; the S/N cube stays on the device until
    collect."""
    plan = periodogram_plan(*CFG)
    direct, _ = run_search_batch(plan, batch, TOBS, device="cpu", **PKW)
    prepared = engine.prepare_stage_data(plan, batch)
    assert run_search_batch(plan, None, TOBS, prepared=prepared,
                            device="cpu", **PKW)[0] == direct
    shipped = engine.ship_stage_data(prepared, torch.device("cpu"))
    with engine.recording() as rec:
        handle = engine.queue_search_batch(plan, None, TOBS,
                                           shipped=shipped, **PKW)
        snr = engine.search_snr_dev(handle)
        assert snr.shape == (2, plan.length, len(plan.widths))
        peaks, _ = engine.collect_search_batch(handle, np.zeros(2))
    assert peaks == direct
    for key in ("ship_s", "stages_s", "assemble_s", "peaks_s", "collect_s"):
        assert rec[key] >= 0.0


@pytest.mark.parametrize("dc", [True, False])
def test_block_overflow_gather_matches_reference(cube, dc):
    """With one block carried home per column, columns with more
    non-empty blocks fetch the rest by a second gather; the peaks are
    still the JAX package's."""
    kw = dict(PKW, smin=2.0)
    pp = peaks_device.PeakPlan(periodogram_plan(*CFG), TOBS,
                               device_cluster=dc, **kw)
    ref_pp = ref_peaks.PeakPlan(ref_plan(*CFG), TOBS, device_cluster=dc,
                                **kw)
    pp.CAP = ref_pp.CAP = 1
    cnt = pp._counts_impl(torch.from_numpy(cube).transpose(1, 2).contiguous(),
                          torch.from_numpy(np.zeros((2, 3, 3), np.float32)
                                           + np.float32([0, 0, 2.0])))
    assert int(((cnt > 0).sum(-1) > 1).sum()) > 0
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        want, _ = ref_peaks.device_find_peaks(ref_pp, cube, np.zeros(2))
    finally:
        set_metrics(prev)
    got, _ = peaks_device.device_find_peaks(pp, cube, np.zeros(2))
    assert got == want and any(got)


@pytest.mark.parametrize("dc", [True, False])
def test_device_constants_are_built_once_per_plan(monkeypatch, cube, dc):
    """Two batches through one ``PeakPlan`` build its device constants
    once (the second reuses the same tensors); the pulled buffer's bytes
    are those of a plan that builds them afresh, and the peaks the JAX
    package's."""
    pp = peaks_device.PeakPlan(periodogram_plan(*CFG), TOBS,
                               device_cluster=dc, **PKW)
    builds = []
    build = peaks_device.PeakPlan._build_consts
    monkeypatch.setattr(peaks_device.PeakPlan, "_build_consts",
                        lambda self, dev: builds.append(dev)
                        or build(self, dev))
    pulled = []
    monkeypatch.setattr(peaks_device, "fold_result",
                        lambda buf: pulled.append(buf.tobytes()) or buf)
    cpu = torch.device("cpu")
    first = peaks_device.device_find_peaks(pp, cube, np.zeros(2))
    consts = dict(pp._device_consts(cpu))
    second = peaks_device.device_find_peaks(pp, cube, np.zeros(2))
    assert builds == [cpu]
    assert all(pp._device_consts(cpu)[k] is v for k, v in consts.items())
    fresh = peaks_device.PeakPlan(periodogram_plan(*CFG), TOBS,
                                  device_cluster=dc, **PKW)
    third = peaks_device.device_find_peaks(fresh, cube, np.zeros(2))
    assert builds == [cpu, cpu]
    assert first[0] == second[0] == third[0]
    for polys in (second[1], third[1]):
        for got, want in zip(polys, first[1]):
            assert got.keys() == want.keys()
            for iw in got:
                np.testing.assert_array_equal(got[iw], want[iw])
    assert len(pulled) == 3 and pulled[0] == pulled[1] == pulled[2]
    ref_pp = ref_peaks.PeakPlan(ref_plan(*CFG), TOBS, device_cluster=dc,
                                **PKW)
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    try:
        want = ref_peaks.device_find_peaks(ref_pp, cube, np.zeros(2))
    finally:
        set_metrics(prev)
    assert first[0] == want[0] and any(first[0])


def test_gather_blocks_reads_the_padded_rows_in_place(cube):
    """The overflow gather reads every (trial, width, block) row from the
    cube in place: the bytes of the rows of the cube padded with -inf
    past the last trial."""
    pp = peaks_device.PeakPlan(periodogram_plan(*CFG), TOBS, **PKW)
    snr = torch.from_numpy(cube)
    D, n, NW = snr.shape
    nb, BLK = pp._nb, pp.BLK
    assert nb * BLK > n
    padded = torch.nn.functional.pad(snr.transpose(1, 2), (0, nb * BLK - n),
                                     value=-np.inf)
    want = padded.reshape(D * NW * nb, BLK)
    ids = torch.arange(D * NW * nb, dtype=torch.int32).flip(0)
    got = pp._gather_blocks(snr, ids)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want[ids.long()].numpy().tobytes()
