"""
The peak program's cluster step on the CPU.

* On a CPU cube, ``PeakPlan._cluster`` takes the plain form
  (``_cluster_impl`` over ``_thr_impl``) and launches nothing; its four
  outputs equal a direct use of ``clustering.cluster1d`` on the sure
  trials, case by case (``cluster_cases.py``) and on a real plan's
  random cubes.
* The kernel's wrapper ``cluster_columns`` takes only a card's or the
  shape-only walk's (``meta``) tensors: on ``meta`` it allocates the
  outputs alone, and it refuses a CPU cube, a wrong dtype, shape or
  coefficient count and a non-contiguous operand.

The card's side (the kernel against the plain form, bit for bit) is in
``test_torch_peaks_cuda.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cluster_cases import CASES, OUTPUTS, made_up, reference  # noqa: E402

from riptide_tpu_torch.search import peaks_device  # noqa: E402
from riptide_tpu_torch.search.plan import periodogram_plan  # noqa: E402

CFG = (1200, 1e-3, (1, 2, 3), 32e-3, 0.11, 32, 40)
PKW = dict(smin=6.0, segwidth=0.2, nstd=6.0, minseg=10, polydeg=2,
           clrad=0.1)


def _assert_same(got, want):
    for g, w, name in zip(got, want, OUTPUTS):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("case", CASES)
def test_plain_form_matches_cluster1d(case):
    pp, s, coef = made_up(case)
    before = peaks_device.CLUSTER_LAUNCHES
    got = pp._cluster(torch.from_numpy(s), torch.from_numpy(coef))
    assert peaks_device.CLUSTER_LAUNCHES == before
    want = reference(pp, s, coef)
    _assert_same(got, want)
    if case in ("all_sure_apart", "many_clusters"):
        assert (want[0] > pp.REP_CAP).all()
    if case == "empty":
        assert not want[0].any() and not want[1].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_form_matches_cluster1d_on_a_plan(seed):
    """A real plan's trials (uneven frequency steps, the exact reach)
    with a random cube and the fit's kind of threshold."""
    pp = peaks_device.PeakPlan(periodogram_plan(*CFG), CFG[0] * CFG[1],
                               device_cluster=True, **PKW)
    rng = np.random.default_rng(seed)
    s = rng.normal(2.0, 2.5, (2, 3, pp.n)).astype(np.float32)
    coef = np.zeros((2, 3, 3), np.float32)
    coef[..., 0] = rng.normal(0.0, 0.05, (2, 3))
    coef[..., 2] = rng.uniform(4.0, 7.0, (2, 3))
    got = pp._cluster(torch.from_numpy(s), torch.from_numpy(coef))
    want = reference(pp, s, coef)
    assert want[0].sum() > 0
    _assert_same(got, want)


def _meta_operands(pp, D=2):
    NW, n = 3, pp.n
    return dict(s=torch.empty((D, NW, n), device="meta"),
                coef=torch.empty((D, NW, 3), device="meta"),
                logf=torch.empty((n,), device="meta"),
                reach=torch.empty((n,), dtype=torch.int32, device="meta"))


def test_cluster_on_meta_allocates_the_outputs_only():
    pp, _, _ = made_up("short_column")
    before = peaks_device.CLUSTER_LAUNCHES
    ops = _meta_operands(pp)
    ncl, marg, rep_idx, rep_val = peaks_device.cluster_columns(
        **ops, smin=pp.smin, rep_cap=pp.REP_CAP)
    assert peaks_device.CLUSTER_LAUNCHES == before
    assert (ncl.shape, ncl.dtype, ncl.device.type) == ((2, 3), torch.int32,
                                                        "meta")
    assert (marg.shape, marg.dtype) == ((2, 3), torch.bool)
    assert (rep_idx.shape, rep_idx.dtype) == ((2, 3, pp.REP_CAP),
                                              torch.int64)
    assert (rep_val.shape, rep_val.dtype) == ((2, 3, pp.REP_CAP),
                                              torch.float32)
    # The plan's own path on meta (the shape-only walk) takes the same.
    out = pp._cluster(ops["s"], ops["coef"])
    assert [tuple(t.shape) for t in out] == [(2, 3), (2, 3),
                                             (2, 3, pp.REP_CAP),
                                             (2, 3, pp.REP_CAP)]
    assert peaks_device.CLUSTER_LAUNCHES == before


@pytest.mark.parametrize("fault", ["cpu_cube", "float64_cube", "coef_shape",
                                   "noncontiguous_cube", "reach_int64",
                                   "four_coefs", "logf_length"])
def test_cluster_columns_refuses(fault):
    pp, _, _ = made_up("short_column")
    ops = _meta_operands(pp)
    if fault == "cpu_cube":
        ops = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in ops.items()}
    elif fault == "float64_cube":
        ops["s"] = ops["s"].double()
    elif fault == "coef_shape":
        ops["coef"] = torch.empty((1, 3, 3), device="meta")
    elif fault == "noncontiguous_cube":
        ops["s"] = torch.empty((2, pp.n, 3), device="meta").transpose(1, 2)
    elif fault == "reach_int64":
        ops["reach"] = ops["reach"].long()
    elif fault == "four_coefs":
        ops["coef"] = torch.empty((2, 3, 4), device="meta")
    elif fault == "logf_length":
        ops["logf"] = torch.empty((pp.n + 1,), device="meta")
    before = peaks_device.CLUSTER_LAUNCHES
    with pytest.raises(ValueError):
        peaks_device.cluster_columns(**ops, smin=pp.smin, rep_cap=pp.REP_CAP)
    assert peaks_device.CLUSTER_LAUNCHES == before
