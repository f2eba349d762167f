"""
Made-up columns for the peak program's cluster step, and its reference
built on ``clustering.cluster1d``, shared by the CPU tests
(``test_torch_cluster.py``) and the card's (``test_torch_peaks_cuda.py``).

A case is a :class:`~riptide_tpu_torch.search.peaks_device.PeakPlan` over
a plan-like object of ``n`` trials whose frequencies fall by ``df`` a
trial (so ``clrad`` in trials sets how far a cluster chains), a (D, NW,
n) float32 S/N cube and (D, NW, 3) float32 threshold coefficients. With
coefficients (0, 0, t) the threshold is t exactly at every trial.
"""
import types

import numpy as np

from riptide_tpu_torch.clustering import cluster1d
from riptide_tpu_torch.search.peaks_device import EPS, PeakPlan

__all__ = ["CASES", "OUTPUTS", "TILE", "made_up", "reference", "plain_plan"]

OUTPUTS = ("ncl", "marg", "rep_idx", "rep_val")

CASES = ("random", "empty", "all_sure_chained", "all_sure_apart",
         "many_clusters", "tile_crossing", "ties", "at_thr_eps",
         "at_smin_eps", "nan_inf", "short_column", "tile_multiple")

D, NW = 2, 3
F32 = np.float32
# The trials the cluster kernel's block reads a tile (``cluster.cu``'s
# kTile, which ``test_torch_peaks_cuda.py`` reads from the built library):
# the tile cases put columns and clusters across its boundaries.
TILE = 2048


def plain_plan(n, clrad, smin=6.0, df=1.0):
    """A PeakPlan with device clustering over ``n`` trials at linearly
    falling frequencies, ``clrad`` in trial steps (tobs 1)."""
    freqs = n * df + 10.0 - df * np.arange(n)
    plan = types.SimpleNamespace(all_periods=1.0 / freqs,
                                 all_foldbins=np.full(n, 100),
                                 widths=np.arange(1, NW + 1))
    return PeakPlan(plan, 1.0, smin=smin, segwidth=n * df / 20.0,
                    clrad=clrad * df, device_cluster=True)


def _flat(t):
    coef = np.zeros((D, NW, 3), F32)
    coef[..., 2] = t
    return coef


def _edges(*points):
    """Each float32 point and its two float32 neighbours."""
    p = np.asarray(points, F32)
    return np.concatenate([p, np.nextafter(p, F32(np.inf)),
                           np.nextafter(p, F32(-np.inf))]).astype(F32)


def made_up(case, seed=0):
    """(PeakPlan, s (D, NW, n) float32, coef (D, NW, 3) float32) of a
    named case of :data:`CASES`."""
    rng = np.random.default_rng(seed)
    n = 2 * TILE + 904          # not a multiple of the tile
    clrad = 3.5                         # chains trials up to 3 apart
    coef = _flat(7.0)
    if case == "short_column":
        n = 100
    elif case == "tile_multiple":
        n = 2 * TILE
    elif case == "all_sure_apart":
        clrad = 0.5                     # every trial its own cluster
    shape = (D, NW, n)
    if case in ("random", "short_column", "tile_multiple"):
        coef = np.zeros((D, NW, 3), F32)
        coef[..., 0] = rng.normal(0.0, 0.01, (D, NW))
        coef[..., 2] = 6.0
        s = rng.normal(3.0, 2.5, shape).astype(F32)
    elif case == "empty":
        s = rng.normal(0.0, 1.0, shape).astype(F32)
    elif case in ("all_sure_chained", "all_sure_apart"):
        s = (rng.integers(0, 3, shape) + 20).astype(F32)
    elif case == "many_clusters":
        s = np.zeros(shape, F32)
        s[..., ::5] = rng.uniform(8.0, 30.0, s[..., ::5].shape)
    elif case == "tile_crossing":
        s = np.zeros(shape, F32)
        for b in (TILE, 2 * TILE):
            # One run across the boundary, chained over gaps of two.
            run = np.arange(b - 40, b + 40, 2)
            s[..., run] = rng.uniform(8.0, 30.0, s[..., run].shape)
        s[0, 0, TILE - 1] = 99.0   # the maximum just before it
        s[0, 1, TILE] = 99.0       # and just after it
    elif case == "ties":
        s = np.zeros(shape, F32)
        pos = rng.choice(n, n // 3, replace=False)
        s[..., pos] = rng.choice(F32([7.5, 9.0, 9.0, 12.0]),
                                 s[..., pos].shape)
    elif case == "at_thr_eps":
        s = rng.choice(_edges(F32(7.0) - F32(EPS), F32(7.0) + F32(EPS), 7.0),
                       shape)
    elif case == "at_smin_eps":
        coef = _flat(5.0)               # the threshold below smin
        s = rng.choice(_edges(6.0 - EPS, 6.0 + EPS, 6.0), shape)
    elif case == "nan_inf":
        s = rng.normal(5.0, 3.0, shape).astype(F32)
        s[rng.random(shape) < 0.05] = np.nan
        s[rng.random(shape) < 0.02] = np.inf
        s[rng.random(shape) < 0.02] = -np.inf
    else:
        raise KeyError(case)
    return plain_plan(n, clrad), np.ascontiguousarray(s, F32), coef


def reference(pp, s, coef):
    """(ncl, marg, rep_idx, rep_val) as numpy: the threshold by Horner in
    float32, the masks as the port rounds them, and each column's sure
    trials clustered by ``cluster1d`` over their frequencies, each
    cluster's representative the largest (S/N, trial index), the first
    ``pp.REP_CAP`` in ascending trial order."""
    Dn, NWn, _ = s.shape
    thr = np.zeros(s.shape, F32)
    for k in range(coef.shape[-1]):
        thr = (thr * pp.logf).astype(F32) + coef[..., k, None]
    eps = F32(EPS)
    sel = (s > thr - eps) & (s > F32(pp.smin - EPS))
    sure = (s > thr + eps) & (s > F32(pp.smin + EPS))
    cap = pp.REP_CAP
    ncl = np.zeros((Dn, NWn), np.int32)
    rep_idx = np.full((Dn, NWn, cap), -1, np.int64)
    rep_val = np.full((Dn, NWn, cap), -np.inf, F32)
    for d in range(Dn):
        for w in range(NWn):
            ix = np.flatnonzero(sure[d, w])
            reps = sorted((max(zip(s[d, w, ix[cl]], ix[cl]))
                           for cl in cluster1d(pp.freqs[ix],
                                               pp.clrad / pp.tobs)),
                          key=lambda r: r[1])
            ncl[d, w] = len(reps)
            for c, (v, j) in enumerate(reps[:cap]):
                rep_idx[d, w, c] = j
                rep_val[d, w, c] = v
    return ncl, (sel & ~sure).any(-1), rep_idx, rep_val
