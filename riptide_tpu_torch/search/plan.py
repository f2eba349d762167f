"""
Host-side periodogram planning: the geometric downsampling cascade.

The reference's search loop (riptide/cpp/periodogram.hpp:117-201) runs,
for each downsampling factor f = ds_ini * ds_geo^i, an FFA transform and
boxcar S/N evaluation for every phase-bin count in [bins_min, bstop].
All of that control flow is *static* given (size, tsamp, period range,
bins range): it is unrolled once on the host, in float64, into a list of
:class:`CycleStage` objects holding

* the downsampling gather plan for the cycle,
* an :class:`~riptide_tpu_torch.ops.plan.FFABatchPlan` packing every
  bins-trial of the cycle into one padded (B, R, P) container,
* per-trial noise normalisations, boxcar coefficients, evaluated row
  counts, and float64 trial periods.

The device then runs each cycle as one stage of kernel launches with no
data-dependent shapes; everything data-dependent (trial periods, output
sizing) lives in this plan. On the quantised wires a stage runs one
launch per lane bucket (:attr:`CycleStage.lane_buckets`), each in its own
container (:meth:`CycleStage.bucket_batch`), and a later stage's bucket
may ride an earlier stage's dead container rows
(:meth:`CycleStage.paired_batch`, the engine's ``_row_pack_map``);
:func:`plan_occupancy` accounts for that layout. The plan is the search's only state:
:func:`plan_arrays` exports it as numpy arrays and :func:`plan_from_arrays`
rebuilds a plan from them.
"""
from functools import lru_cache
import math

import numpy as np

from ..ops.downsample import downsample_plan_padded
from ..ops.plan import FFABatchPlan, num_levels
from ..ops.reference import downsampled_size, downsampled_variance
from ..ops.snr import boxcar_coeffs

__all__ = ["PeriodogramPlan", "CycleStage", "periodogram_plan",
           "check_arguments", "ceilshift", "plan_arrays", "plan_from_arrays",
           "plan_occupancy"]


def plan_occupancy(plan, mode=None):
    """Container-occupancy accounting of a plan's lane-bucket layout
    under the live flags, as the JAX package's ``plan_occupancy``
    counts it (TPU container heights and 128-lane widths, from
    ``engine._bucket_shape``), so the two layouts' decisions can be
    compared number for number: per bucket and in total, the evaluated
    (live) row*lane work against the computed containers (absorbed guest
    buckets count zero), next to the pre-row-pack (legacy) layout."""
    from ..utils import envflags
    from ..ops.slottables import container_rows
    from . import engine

    mode = mode or engine._wire_mode()
    rpm = engine._row_pack_map(plan, mode)
    base3 = bool(envflags.get("RIPTIDE_KERNEL_BASE3"))
    buckets = []
    live_t = comp_t = legacy_t = 0
    for s, st in enumerate(plan.stages):
        nb = len(st.bins)
        for k, idx in enumerate(st.lane_buckets):
            ms = [st.ms_padded[i] for i in idx]
            L, rows, P = engine._bucket_shape(st, idx)
            legacy_rows = (container_rows(max(ms), L) if base3
                           else 1 << L)
            live = sum(st.rows_eval[i] * st.ps_padded[i]
                       for i in idx if i < nb)
            entry = rpm.get((s, k))
            role = entry[0] if entry else None
            comp = 0 if role == "guest" else len(idx) * rows * P
            legacy = len(idx) * legacy_rows * P
            buckets.append({
                "stage": s, "bucket": k, "B": len(idx), "rows": rows,
                "P": P, "legacy_rows": legacy_rows,
                "live_rowlane": int(live), "computed_rowlane": int(comp),
                "role": role,
                "pair_stage": entry[1] if entry else None,
            })
            live_t += live
            comp_t += comp
            legacy_t += legacy
    pad = comp_t - live_t
    legacy_pad = legacy_t - live_t
    return {
        "mode": mode,
        "row_pack": bool(envflags.get("RIPTIDE_KERNEL_ROW_PACK")),
        "pairs": sum(1 for v in rpm.values() if v[0] == "host"),
        "buckets": buckets,
        "totals": {
            "live_rowlane": int(live_t),
            "computed_rowlane": int(comp_t),
            "padded_rowlane": int(pad),
            "legacy_computed_rowlane": int(legacy_t),
            "legacy_padded_rowlane": int(legacy_pad),
            "occupancy": live_t / comp_t if comp_t else 1.0,
            "padded_reduction_vs_legacy": (
                (legacy_pad - pad) / legacy_pad if legacy_pad else 0.0),
        },
    }


def check_arguments(size, tsamp, period_min, period_max, bins_min, bins_max):
    """Argument validation, mirroring riptide/cpp/periodogram.hpp:25-40."""
    if not tsamp > 0:
        raise ValueError("tsamp must be > 0")
    if not period_min > 0:
        raise ValueError("period_min must be > 0")
    if not period_max > period_min:
        raise ValueError("period_max must be > period_min")
    if not bins_min > 1:
        raise ValueError("bins_min must be > 1")
    if not bins_max >= bins_min:
        raise ValueError("bins_max must be >= bins_min")
    if not period_min >= tsamp * bins_min:
        raise ValueError("Must have: period_min >= tsamp * bins_min")


def ceilshift(rows, cols, pmax):
    """
    First FFA row whose trial period reaches ``pmax`` (in samples); rows
    [0, ceilshift) have trial periods below it
    (riptide/cpp/periodogram.hpp:54-57).
    """
    return int(math.ceil(cols * (rows - 1.0) * (1.0 - cols / pmax)))


def _round_bucket(n):
    """Round up to the next 2^k or 1.5*2^k, so consecutive cycles share
    container heights."""
    if n <= 8:
        return 8
    k = int(math.floor(math.log2(n)))
    for cand in (1 << k, 3 << (k - 1), 1 << (k + 1)):
        if cand >= n:
            return cand
    return 1 << (k + 1)


class CycleStage:
    """One downsampling cycle of the periodogram cascade. See module doc."""

    def __init__(self, size, tsamp, f, period_max, bins_min, bins_max, widths, nout):
        self.f = f
        self.tau = tau = f * tsamp
        self.n = n = downsampled_size(size, f)
        pms = period_max / tau  # period_max in units of current samples
        bstart = bins_min
        bstop = min(bins_max, n, int(pms))

        self.bins = list(range(bstart, bstop + 1))
        self.active = bool(self.bins)
        if not self.active:
            return

        ms = [n // b for b in self.bins]
        var = downsampled_variance(size, f)

        self.rows_eval = []
        self.periods = []
        for b, rows in zip(self.bins, ms):
            period_ceil = min(pms, b + 1.0)
            rows_eval = min(rows, ceilshift(rows, b, period_ceil))
            rows_eval = max(rows_eval, 0)
            self.rows_eval.append(rows_eval)
            s = np.arange(rows_eval, dtype=np.float64)
            # float64 trial periods (riptide/cpp/periodogram.hpp:190-194)
            self.periods.append(tau * b * b / (b - s / (rows - 1.0)) if rows_eval else np.empty(0))

        # Pad the bins-trial batch to a constant B = bins_max - bins_min + 1
        # and P = bins_max for ALL cycles. Dummy problems have m = 1 /
        # rows_eval = 0 and are never read back.
        B = bins_max - bins_min + 1
        pad = B - len(self.bins)
        self.ms_padded = ms + [1] * pad
        self.ps_padded = self.bins + [bins_min] * pad
        stds = np.asarray(ms, np.float64) * var
        self.stdnoise = np.sqrt(
            np.concatenate([stds, np.ones(pad)])
        ).astype(np.float32)
        self.widths = widths
        self.rows_eval_max = max(self.rows_eval) if self.rows_eval else 0

        nw = len(widths)
        self.hcoef = np.zeros((B, nw), np.float32)
        self.bcoef = np.zeros((B, nw), np.float32)
        for i, b in enumerate(self.bins):
            h, bb = boxcar_coeffs(b, widths)
            self.hcoef[i], self.bcoef[i] = h, bb

        self.ds_plan = downsample_plan_padded(size, f, nout)
        self.length = sum(self.rows_eval)

    @property
    def batch(self):
        """:class:`FFABatchPlan` of the stage's container: R =
        ``_round_bucket(max m + 1)``, P = bins_max, L = ceil(log2 R)."""
        b = getattr(self, "_batch", None)
        if b is None:
            R = _round_bucket(max(m for m in self.ms_padded) + 1)
            b = FFABatchPlan(
                self.ms_padded, self.ps_padded, R=R, P=max(self.ps_padded),
                L=int(math.ceil(math.log2(R))),
            )
            self._batch = b
        return b

    @property
    def kernel_depth(self):
        """ceil(log2(max m)) over the stage (sizes the wire's scale
        slack, as in the JAX package's view layout)."""
        return max(num_levels(m) for m in self.ms_padded)

    @property
    def lane_buckets(self):
        """The stage's padded trial indices grouped by ceil(p / 128), as
        the JAX package groups them into lane-occupancy buckets, in
        ascending order; one bucket of every trial when
        ``RIPTIDE_KERNEL_LANE_SPLIT=0``. Every stage of a plan has the
        same bins list, so the same buckets."""
        from ..utils import envflags

        split = bool(envflags.get("RIPTIDE_KERNEL_LANE_SPLIT"))
        cached = getattr(self, "_lane_buckets", None)
        if cached is not None and cached[0] == split:
            return cached[1]
        if split:
            tiles = {}
            for i, p in enumerate(self.ps_padded):
                tiles.setdefault(-(-p // 128), []).append(i)
            buckets = tuple(tuple(ix) for _, ix in sorted(tiles.items()))
        else:
            buckets = (tuple(range(len(self.ps_padded))),)
        self._lane_buckets = (split, buckets)
        return buckets

    def _bucket_plan(self, k, guests=None, key=None):
        from ..ops.ffa_kernel import bucket_rows

        idx = self.lane_buckets[k]
        ms = [self.ms_padded[i] for i in idx]
        ps = [self.ps_padded[i] for i in idx]
        L = max(num_levels(m) for m in ms)
        R = bucket_rows(ms, L) + 1
        cache = getattr(self, "_bucket_plans", None)
        if cache is None:
            cache = self._bucket_plans = {}
        full = (idx, R, key)
        b = cache.get(full)
        if b is None:
            b = cache[full] = FFABatchPlan(ms, ps, R=R, P=max(ps), L=L,
                                           guests=guests)
        return b

    def bucket_batch(self, k):
        """:class:`FFABatchPlan` of lane bucket ``k``: L from its largest
        m, R = ``bucket_rows`` + 1 (the TPU layout's height under the
        container flags, plus the zero row), P = its largest p."""
        return self._bucket_plan(k)

    def paired_batch(self, k, guest_st, bases):
        """:class:`FFABatchPlan` of lane bucket ``k`` with ``guest_st``'s
        same-position trials at the per-trial ``bases`` (None: no guest
        on that trial): the host bucket's L, R and P."""
        idx = self.lane_buckets[k]
        guests = [None if bb is None else (guest_st.ms_padded[g], bb)
                  for g, bb in zip(idx, bases)]
        return self._bucket_plan(k, guests,
                                 key=(guest_st.f, tuple(bases)))


class PeriodogramPlan:
    """
    Full static plan of a periodogram search: the list of active
    :class:`CycleStage` s plus output bookkeeping. Replicates the output
    contract of the reference's ``libcpp.periodogram``
    (riptide/cpp/python_bindings.cpp:168-197): float64 trial periods,
    uint32 fold bin counts, float32 (num_periods, num_widths) S/N, ordered
    by cycle then by phase-bin count then by shift.
    """

    def __init__(self, size, tsamp, widths, period_min, period_max, bins_min, bins_max):
        check_arguments(size, tsamp, period_min, period_max, bins_min, bins_max)
        widths = tuple(int(w) for w in widths)
        if not all(0 < w < bins_min for w in widths):
            raise ValueError("trial widths must be all > 0 and < bins_min")
        self.size = int(size)
        self.tsamp = float(tsamp)
        self.widths = widths
        self.period_min = float(period_min)
        self.period_max = float(period_max)
        self.bins_min = int(bins_min)
        self.bins_max = int(bins_max)

        ds_ini = period_min / (tsamp * bins_min)
        ds_geo = (bins_max + 1.0) / bins_min
        num_ds = int(math.ceil(math.log(period_max / period_min) / math.log(ds_geo)))
        # Largest per-cycle buffer; every cycle's downsample plan is
        # padded to this length.
        self.nout = downsampled_size(size, ds_ini)
        self.P = int(bins_max)

        self.stages = []
        for ids in range(num_ds):
            f = ds_ini * ds_geo**ids
            st = CycleStage(size, tsamp, f, period_max, bins_min, bins_max, widths, self.nout)
            if st.active and st.length > 0:
                self.stages.append(st)
        self._finish()

    def _finish(self):
        self.length = sum(st.length for st in self.stages)
        # Assembled float64 periods / uint32 foldbins, fixed at plan time.
        self.all_periods = (
            np.concatenate([p for st in self.stages for p in st.periods])
            if self.length
            else np.empty(0)
        )
        self.all_foldbins = np.concatenate(
            [
                np.full(re, b, np.uint32)
                for st in self.stages
                for b, re in zip(st.bins, st.rows_eval)
            ]
        ) if self.length else np.empty(0, np.uint32)


@lru_cache(maxsize=64)
def periodogram_plan(size, tsamp, widths, period_min, period_max, bins_min, bins_max):
    """Cached :class:`PeriodogramPlan`; ``widths`` must be a tuple."""
    return PeriodogramPlan(size, tsamp, widths, period_min, period_max, bins_min, bins_max)


# ---------------------------------------------------------------------------
# The plan as arrays
# ---------------------------------------------------------------------------

_PLAN_SCALARS = (("size", np.int64), ("tsamp", np.float64),
                 ("period_min", np.float64), ("period_max", np.float64),
                 ("bins_min", np.int64), ("bins_max", np.int64),
                 ("nout", np.int64), ("P", np.int64))
_DS_KEYS = ("ds_imin", "ds_imax", "ds_wmin", "ds_wmax", "ds_wint")


def plan_arrays(plan):
    """Export a periodogram plan as numpy arrays: the plan's scalars,
    ``widths``, ``all_periods``, ``all_foldbins``, and per stage
    (``stages``, a list of dicts) its factor, length, bins, padded
    ``ms``/``ps``, ``rows_eval``, ``hcoef``, ``bcoef``, ``stdnoise``,
    float64 ``periods`` (trial order), the (L, B, R) ``h``/``t``/
    ``shift`` container tables and the downsampling plan. Reads only
    attributes, so any plan object with this package's attribute names
    exports."""
    out = {k: np.asarray(getattr(plan, k), dt) for k, dt in _PLAN_SCALARS}
    out["widths"] = np.asarray(plan.widths, np.int64)
    out["all_periods"] = np.asarray(plan.all_periods, np.float64)
    out["all_foldbins"] = np.asarray(plan.all_foldbins, np.uint32)
    stages = []
    for st in plan.stages:
        b = st.batch
        per = [np.asarray(p, np.float64) for p in st.periods]
        d = {
            "f": np.asarray(st.f, np.float64),
            "tau": np.asarray(st.tau, np.float64),
            "n": np.asarray(st.n, np.int64),
            "bins": np.asarray(st.bins, np.int64),
            "ms": np.asarray(st.ms_padded, np.int64),
            "ps": np.asarray(st.ps_padded, np.int64),
            "rows_eval": np.asarray(st.rows_eval, np.int64),
            "hcoef": np.asarray(st.hcoef, np.float32),
            "bcoef": np.asarray(st.bcoef, np.float32),
            "stdnoise": np.asarray(st.stdnoise, np.float32),
            "periods": np.concatenate(per) if per else np.empty(0),
            "h": np.asarray(b.h, np.int32),
            "t": np.asarray(b.t, np.int32),
            "shift": np.asarray(b.shift, np.int32),
        }
        for k, a in zip(_DS_KEYS, st.ds_plan):
            d[k] = np.asarray(a)
        stages.append(d)
    out["stages"] = stages
    return out


def plan_from_arrays(arrays):
    """Build this package's :class:`PeriodogramPlan` from
    :func:`plan_arrays` output (e.g. a plan another implementation
    built), without re-planning."""
    plan = PeriodogramPlan.__new__(PeriodogramPlan)
    for k, _ in _PLAN_SCALARS:
        setattr(plan, k, arrays[k].item())
    plan.widths = tuple(int(w) for w in arrays["widths"])
    plan.stages = []
    for d in arrays["stages"]:
        st = CycleStage.__new__(CycleStage)
        st.f = d["f"].item()
        st.tau = d["tau"].item()
        st.n = int(d["n"])
        st.bins = [int(b) for b in d["bins"]]
        st.active = True
        st.ms_padded = [int(m) for m in d["ms"]]
        st.ps_padded = [int(p) for p in d["ps"]]
        st.rows_eval = [int(r) for r in d["rows_eval"]]
        st.rows_eval_max = max(st.rows_eval)
        st.length = sum(st.rows_eval)
        bounds = np.cumsum([0] + st.rows_eval)
        st.periods = [d["periods"][a:b] for a, b in zip(bounds, bounds[1:])]
        st.hcoef = d["hcoef"].copy()
        st.bcoef = d["bcoef"].copy()
        st.stdnoise = d["stdnoise"].copy()
        st.widths = plan.widths
        st.ds_plan = tuple(d[k].copy() for k in _DS_KEYS)
        b = FFABatchPlan.__new__(FFABatchPlan)
        b.h, b.t, b.shift = d["h"].copy(), d["t"].copy(), d["shift"].copy()
        b.L, b.B, b.R = b.h.shape
        b.P = max(st.ps_padded)
        b.m = np.asarray(st.ms_padded, np.int32)
        b.p = np.asarray(st.ps_padded, np.int32)
        st._batch = b
        plan.stages.append(st)
    plan._finish()
    return plan
