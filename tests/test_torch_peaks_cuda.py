"""
The peak program's cluster kernel (``csrc/cluster.cu``) on a card.

Marked ``cuda``: skipped on a host without one (the default CPU suite);
run on a card with ``python -m pytest --noconftest
tests/test_torch_peaks_cuda.py``.

* The kernel's four outputs (``ncl``, ``marg``, ``rep_idx``,
  ``rep_val``) are the plain form's (``_cluster_impl`` over
  ``_thr_impl`` on the same card tensors) bit for bit, and the
  ``cluster1d`` reference's, on the made-up columns of
  ``cluster_cases.py`` and on cubes of the benchmark configurations'
  real plans (quickstart, example_long, example_yaml's ``medium``
  range), with the threshold of the program's own fit and with a low
  one that makes hundreds of clusters a column.
* ``device_find_peaks`` on the card gives the peaks and threshold
  polynomials of the host path (device clustering off) and of the CPU.
* The made-up cases cross the kernel's tile, as the built library
  gives it.
* The wrapper refuses a wrong dtype, device, shape or a non-contiguous
  cube; it launches once per peak program queued with device clustering
  and never without, and apart from the stage kernels' counters; a cube
  on a card other than the current one is clustered on its own card
  (run on a host with two cards or more).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from cluster_cases import (CASES, OUTPUTS, TILE, made_up,  # noqa: E402
                           reference)

from riptide_tpu_torch.ffautils import generate_width_trials  # noqa: E402
from riptide_tpu_torch.ops import ffa_kernel  # noqa: E402
from riptide_tpu_torch.search import engine, peaks_device  # noqa: E402
from riptide_tpu_torch.search.plan import periodogram_plan  # noqa: E402
from riptide_tpu_torch.survey.metrics import (MetricsRegistry,  # noqa: E402
                                              set_metrics)

pytestmark = pytest.mark.cuda

CONFIGS = os.path.join(os.path.dirname(HERE), "portbench", "configs")
# The benchmark's configurations: (file, range), and the widths each has.
REAL = {"quickstart": ("quickstart.json", None, 10),
        "example_long": ("example_long.json", None, 13),
        "example_yaml.medium": ("example_yaml.json", "medium", 12)}
SMALL = (1200, 1e-3, (1, 2, 3), 32e-3, 0.11, 32, 40)
SMALL_KW = dict(smin=6.0, segwidth=0.2, nstd=6.0, minseg=10, polydeg=2,
                clrad=0.1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_bits(got, want):
    for g, w, name in zip(got, want, OUTPUTS):
        g = g.cpu().numpy()
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def _kernel(pp, s, coef):
    """The kernel's outputs through the plan, checking its one launch."""
    before = peaks_device.CLUSTER_LAUNCHES
    out = pp._cluster(s, coef)
    torch.cuda.synchronize()
    assert peaks_device.CLUSTER_LAUNCHES == before + 1
    return out


def test_made_up_cases_cross_the_kernel_tile(dev):
    lib = peaks_device._CLUSTER_LIB.load()
    assert lib.rt_cluster_tile() == TILE


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_form_on_made_up_columns(dev, case):
    pp, s, coef = made_up(case)
    sd, cd = torch.from_numpy(s).to(dev), torch.from_numpy(coef).to(dev)
    got = _kernel(pp, sd, cd)
    _assert_bits(got, pp._cluster_impl(sd, pp._thr_impl(cd)))
    _assert_bits(got, reference(pp, s, coef))


_PLANS = {}


def _real(key):
    """(plan, its configuration) of a benchmark configuration's range."""
    if key not in _PLANS:
        name, rng, _ = REAL[key]
        with open(os.path.join(CONFIGS, name)) as fobj:
            cfg = json.load(fobj)
        if rng is not None:
            cfg = dict(cfg, **next(r for r in cfg["ranges"]
                                   if r["name"] == rng))
        widths = tuple(int(w) for w in generate_width_trials(
            cfg["bins_min"], ducy_max=cfg["ducy_max"], wtsp=cfg["wtsp"]))
        plan = periodogram_plan(int(cfg["nsamp"]), float(cfg["tsamp"]),
                                widths, float(cfg["period_min"]),
                                float(cfg["period_max"]),
                                int(cfg["bins_min"]), int(cfg["bins_max"]))
        _PLANS[key] = plan, cfg
    return _PLANS[key]


def _cube(plan, dev, D=2, seed=3):
    """A (D, n, NW) S/N cube on the card: unit noise and, in every
    column, six bumps of S/N 8-30 and 0.5-4 trials wide (steep flanks,
    so most columns have no point within EPS of the threshold and their
    device clusters are trusted)."""
    n, NW = plan.length, len(plan.widths)
    rng = np.random.default_rng(seed)
    snr = rng.standard_normal((D, n, NW)).astype(np.float32)
    j = np.arange(n)
    for d in range(D):
        for w in range(NW):
            for c, a, h in zip(rng.integers(0, n, 6), rng.uniform(8, 30, 6),
                               rng.uniform(0.5, 4.0, 6)):
                snr[d, :, w] += (a * np.exp(-0.5 * ((j - c) / h) ** 2)
                                 ).astype(np.float32)
    return torch.from_numpy(snr).to(dev)


def _fit(pp, s):
    """The peak program's own f32 threshold coefficients of ``s``."""
    stats = pp._stats_impl(s)
    tc = stats[..., 1] + pp.nstd * (stats[..., 2] - stats[..., 0]) / 1.349
    return torch.einsum("ks,dws->dwk",
                        pp._device_consts(s.device)["fitmat"], tc)


@pytest.mark.parametrize("threshold", ["fit", "low"])
@pytest.mark.parametrize("key", list(REAL))
def test_kernel_matches_plain_form_on_real_plans(dev, key, threshold):
    plan, cfg = _real(key)
    kw = dict(cfg["find_peaks"])
    if threshold == "low":
        kw["smin"] = 1.0
    pp = peaks_device.PeakPlan(plan, plan.size * plan.tsamp, **kw)
    assert len(plan.widths) == REAL[key][2]
    s = _cube(plan, dev).transpose(1, 2).contiguous()
    coef = _fit(pp, s).contiguous()
    if threshold == "low":
        coef = torch.zeros_like(coef)
        coef[..., -1] = 2.75
    got = _kernel(pp, s, coef)
    _assert_bits(got, pp._cluster_impl(s, pp._thr_impl(coef)))
    ncl = got[0].cpu().numpy()
    assert (ncl > 0).all()
    if threshold == "low":
        assert (ncl > pp.REP_CAP).all()


def _host_tail(pp):
    """``pp`` with its device clustering off, as a plan whose threshold
    polynomial is above degree 2 or whose trials reach 2^24 has it: the
    host tail clusters every column (set before its first batch, so its
    device constants are built without the cluster's)."""
    pp.device_cluster = False
    return pp


def _find(pp, snr, reg=None):
    prev = set_metrics(reg or MetricsRegistry())
    try:
        return peaks_device.device_find_peaks(pp, snr, np.zeros(len(snr)))
    finally:
        set_metrics(prev)


def _same_peaks(got, want):
    assert got[0] == want[0] and any(got[0])
    for gp, wp in zip(got[1], want[1]):
        assert gp.keys() == wp.keys()
        for iw in gp:
            np.testing.assert_array_equal(gp[iw], wp[iw])


@pytest.mark.parametrize("key", list(REAL))
def test_device_find_peaks_matches_the_host_path(dev, key):
    plan, cfg = _real(key)
    tobs = plan.size * plan.tsamp
    snr = _cube(plan, dev)
    reg = MetricsRegistry()
    got = _find(peaks_device.PeakPlan(plan, tobs, **cfg["find_peaks"]), snr,
                reg)
    want = _find(_host_tail(peaks_device.PeakPlan(plan, tobs,
                                                  **cfg["find_peaks"])), snr)
    _same_peaks(got, want)
    assert reg.counter("cluster_cols_device") > 0


def test_device_find_peaks_on_the_card_matches_the_cpu(dev):
    plan = periodogram_plan(*SMALL)
    rng = np.random.default_rng(21)
    batch = rng.standard_normal((2, SMALL[0])).astype(np.float32)
    t = np.arange(SMALL[0]) * SMALL[1]
    batch[0] += 6.0 * (np.mod(t, 0.05) < 0.004)
    _, _, cube = engine.run_periodogram_batch(plan, batch, device="cpu")
    pp = peaks_device.PeakPlan(plan, SMALL[0] * SMALL[1], **SMALL_KW)
    before = peaks_device.CLUSTER_LAUNCHES
    got = _find(pp, torch.from_numpy(cube).to(dev))
    assert peaks_device.CLUSTER_LAUNCHES == before + 1
    _same_peaks(got, _find(pp, torch.from_numpy(cube)))
    assert peaks_device.CLUSTER_LAUNCHES == before + 1


@pytest.mark.parametrize("fault", ["float64_cube", "cpu_cube", "coef_shape",
                                   "noncontiguous_cube", "reach_int64"])
def test_cluster_columns_refuses(dev, fault):
    pp, s, coef = made_up("short_column")
    c = pp._device_consts(dev)
    ops = dict(s=torch.from_numpy(s).to(dev),
               coef=torch.from_numpy(coef).to(dev), logf=c["logf"],
               reach=c["reach"])
    if fault == "float64_cube":
        ops["s"] = ops["s"].double()
    elif fault == "cpu_cube":
        ops["s"] = ops["s"].cpu()
    elif fault == "coef_shape":
        ops["coef"] = ops["coef"][:1].contiguous()
    elif fault == "noncontiguous_cube":
        ops["s"] = ops["s"].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "reach_int64":
        ops["reach"] = ops["reach"].long()
    before = peaks_device.CLUSTER_LAUNCHES
    with pytest.raises(ValueError):
        peaks_device.cluster_columns(**ops, smin=pp.smin, rep_cap=pp.REP_CAP)
    assert peaks_device.CLUSTER_LAUNCHES == before


def test_one_launch_per_peak_program(dev):
    """One launch per peak program queued with device clustering (three
    for three programs), none without; the stage kernels' counters do
    not hold it."""
    plan = periodogram_plan(*SMALL)
    rng = np.random.default_rng(5)
    batch = rng.standard_normal((2, SMALL[0])).astype(np.float32)
    tobs = SMALL[0] * SMALL[1]
    snr = torch.from_numpy(rng.standard_normal(
        (2, plan.length, len(plan.widths))).astype(np.float32)).to(dev)
    on = peaks_device.PeakPlan(plan, tobs, **SMALL_KW)
    off = _host_tail(peaks_device.PeakPlan(plan, tobs, **SMALL_KW))
    before = peaks_device.CLUSTER_LAUNCHES
    handles = [peaks_device.queue_find_peaks(on, snr) for _ in range(3)]
    assert peaks_device.CLUSTER_LAUNCHES == before + 3
    peaks_device.queue_find_peaks(off, snr)
    assert peaks_device.CLUSTER_LAUNCHES == before + 3
    for h in handles:
        peaks_device.collect_peaks(on, h, np.zeros(2))
    assert "cluster" not in " ".join(ffa_kernel.KERNEL_LAUNCHES)
    engine.run_search_batch(plan, batch, tobs, device=dev, **SMALL_KW)
    assert peaks_device.CLUSTER_LAUNCHES == before + 4


def test_kernel_runs_on_the_cube_s_card(dev):
    """A cube on a card other than the current device: the launch goes
    to the cube's card and stream, and the current device is left as it
    was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    pp, s, coef = made_up("random")
    s = torch.from_numpy(s).to(other)
    coef = torch.from_numpy(coef).to(other)
    with torch.cuda.device(0):
        got = _kernel(pp, s, coef)
        assert torch.cuda.current_device() == 0
    assert all(t.device == other for t in got)
    _assert_bits(got, pp._cluster_impl(s, pp._thr_impl(coef)))
    _assert_bits(got, reference(pp, s.cpu().numpy(), coef.cpu().numpy()))
