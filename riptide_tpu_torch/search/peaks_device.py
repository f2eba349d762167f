"""
On-device peak detection for batched periodogram searches, in plain
PyTorch: the JAX package's ``search/peaks_device.py`` (which has no
Pallas kernel), with the same semantics and the same host protocol.

Replicates the reference's find_peaks semantics
(riptide/peak_detection.py:37-142) while keeping the (D, trials, widths)
S/N cube on the device. The device side is one call,
:meth:`PeakPlan._fused`, whose result crosses to the host in one copy:

1. per-(trial, width) segment percentiles of the S/N column (sort plus
   the linear interpolation of ``jnp.percentile``, bit for bit);
2. the float32 threshold polyfit in log(f) through a precomputed
   normal-equation matrix;
3. the mask ``s > max(dynthr, smin)`` widened by EPS, per-BLK-trial-block
   selected counts, and the first CAP non-empty blocks per (trial,
   width) column;
4. with ``RIPTIDE_DEVICE_CLUSTER`` (default on), the reference's 1-D
   friends-of-friends clustering of the sure points and the advisory
   harmonic screen. On a card the clustering is one hand-written CUDA
   kernel (``csrc/cluster.cu``, :func:`cluster_columns`: one read of the
   cube, the threshold in registers, no (D, NW, n) intermediate); on
   the CPU it is the plain form (:meth:`PeakPlan._cluster_impl`:
   cummax/cummin, a segmented log-step lexmax scan, a stable sort in
   place of ``lax.top_k``), with the same four outputs bit for bit.

The host then re-fits the threshold in float64 (``np.polyfit``),
re-checks every pulled point exactly, and keeps a column's device
cluster representatives only when it proves them equal to its own
float64 tail (:meth:`PeakPlan._trusted_cols`); otherwise it clusters the
column's block data itself. Peaks are identical to the host path's
either way. Columns with more than CAP non-empty blocks fetch their
other blocks with one more gather.

The queue makes no host-blocking call once a plan's constants are on
the device (:meth:`PeakPlan._device_consts`, built at its first batch
there). On a card the pull leaves with the chunk: the queue copies the
buffer into pinned host memory behind the program and records an event,
and the collect waits on that event alone, so a chunk queued after it
never delays its collect. The overflow gather runs on a side stream
that waits on the same event.

The pulled buffer (and the overflow gather's block values) is folded
into the dispatch attempt's integrity digest at the collect point
(:func:`riptide_tpu_torch.survey.integrity.fold_result`, a no-op while
integrity is off), and the program's counters land in the metrics
registry (:func:`riptide_tpu_torch.survey.metrics.get_metrics`):
``dispatch_cluster`` (peak programs queued with device clustering),
``cluster_cols_device`` / ``cluster_cols_host`` (columns whose peaks
came from the device representatives or the host tail),
``harmonic_suspects`` (advisory harmonic-screen hits), and on a card
``peaks_pull_ready`` (collects whose chunk was done on entry),
``peaks_pull_wait_s`` (the host's wait on the chunk's event) and
``overflow_gathers`` (overflow gathers on the side stream).
:data:`CLUSTER_LAUNCHES` counts the cluster kernel's launches: one per
peak program queued on a card with device clustering, none on the CPU.
"""
import contextlib
import ctypes
import logging
import threading
import time

import numpy as np
import torch

from ..clustering import cluster1d
from ..obs.trace import span
from ..peak_detection import Peak, fit_threshold
from ..survey.integrity import fold_result
from ..survey.metrics import get_metrics
from ..utils import cuda_build, envflags
from .engine import _dev_tensor

log = logging.getLogger("riptide_tpu_torch.peaks_device")

__all__ = ["PeakPlan", "device_find_peaks", "queue_find_peaks",
           "collect_peaks", "device_cluster_enabled",
           "force_device_cluster", "cluster_columns", "build_cluster"]

# Margin (in S/N units) by which the device-side threshold is lowered;
# marginal points are re-judged on host in float64. Device f32 rounding
# of the threshold polynomial is ~1e-5 relative; 1e-2 absolute is safe.
EPS = 1e-2

# float32 unit roundoff, for the host-side proof that the device's f32
# threshold evaluation stays inside the EPS margin (see _trusted_cols).
_EPS32 = float(np.finfo(np.float32).eps)

# Harmonic-screen maxima mirroring htest's defaults and its q <= 100
# fraction search (pipeline/harmonic_testing.py): the screen is advisory
# (a counter, never a CSV field).
_H_QMAX = 100
_H_PHASE_MAX = 1.0
_H_SNR_MAX = 3.0

# Pinned override of the flag (see force_device_cluster); None defers
# to the environment.
_DC_OVERRIDE = None

# The segment percentiles of the threshold fit's control points.
_QS = (25.0, 50.0, 75.0)

# Guards the build of a plan's device constants (several job threads
# may queue one plan at once).
_CONSTS_LOCK = threading.Lock()

# The cluster step's kernel: its source and its launches (counted under
# their lock: job threads may queue peak programs at once).
CLUSTER_SOURCE = cuda_build.CSRC / "cluster.cu"
CLUSTER_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def device_cluster_enabled():
    """``RIPTIDE_DEVICE_CLUSTER``: run the clustering and the harmonic
    screen in the device program (the host still verifies and falls
    back per column, so the flag changes where the tail runs, never what
    comes out), unless :func:`force_device_cluster` pins it."""
    if _DC_OVERRIDE is not None:
        return _DC_OVERRIDE
    return bool(envflags.get("RIPTIDE_DEVICE_CLUSTER"))


@contextlib.contextmanager
def force_device_cluster(value):
    """Pin :func:`device_cluster_enabled` to ``value`` for the block,
    overriding the environment. Used by the integrity canary, whose
    pinned digest covers the pulled buffer's LAYOUT and must therefore
    not follow a run's flag override."""
    global _DC_OVERRIDE
    prev = _DC_OVERRIDE
    _DC_OVERRIDE = bool(value)
    try:
        yield
    finally:
        _DC_OVERRIDE = prev


def _two_sum(a, b):
    """Knuth's TwoSum in float32: (s, e) with s = fl(a + b) and
    a + b = s + e exactly (six IEEE additions, no fused operation)."""
    s = a + b
    bp = s - a
    ap = s - bp
    return s, (a - ap) + (b - bp)


def _percentiles(seg, q):
    """``jnp.percentile(seg, qs, axis=-1)`` (linear interpolation) in
    float32 as the JAX package's compiled peak program computes it, with
    ``q`` the float32 positions qs / 100 * (n - 1) on the device
    (:meth:`PeakPlan._device_consts`): sort, floor/ceil indices and
    weights, then ``low * (1 - w) +
    high * w`` with the first product folded into the add (XLA contracts
    it into one fused multiply-add: one rounding). The fused form is
    taken in float32 alone, with no fused operation: 1 - w is a multiple
    of 1/4, so low * (1 - w) is exact except at 3/4, where it is low -
    low / 4 with its rounding error from :func:`_two_sum`; the product
    and its error then join high * w through a second TwoSum, rounding
    once at the end. Returns (..., len(q))."""
    n = seg.shape[-1]
    srt = torch.sort(seg, dim=-1).values
    low = torch.floor(q)
    high = torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    low = low.clamp(0, n - 1).to(torch.int64)
    high = high.clamp(0, n - 1).to(torch.int64)
    lo = srt[..., low]
    three = lw == 0.75
    prod, err = _two_sum(torch.where(three, lo, lo * lw),
                         torch.where(three, lo * -0.25, 0.0))
    total, err2 = _two_sum(prod, srt[..., high] * hw)
    return total + (err + err2)


def _seg_lexmax_scan(flag, val, idx):
    """Inclusive segmented scan along the last axis of the (S/N, trial
    index) lexmax, restarted where ``flag`` is set; ties take the larger
    index. A log-step (Hillis-Steele) scan of the combine of the JAX
    package's ``associative_scan``: it is exact (selects only), so any
    association gives the same result."""
    n = val.shape[-1]
    off = 1
    while off < n:
        fa, va, ia = flag[..., :-off], val[..., :-off], idx[..., :-off]
        fb, vb, ib = flag[..., off:], val[..., off:], idx[..., off:]
        take_b = (vb > va) | ((vb == va) & (ib > ia))
        v = torch.where(fb | take_b, vb, va)
        i = torch.where(fb | take_b, ib, ia)
        val = torch.cat([val[..., :off], v], dim=-1)
        idx = torch.cat([idx[..., :off], i], dim=-1)
        flag = torch.cat([flag[..., :off], fb | fa], dim=-1)
        off *= 2
    return val, idx


def _bind_cluster(lib):
    vp, i32, ll, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
    lib.rt_cluster_columns.argtypes = [vp, vp, i32, vp, vp, ll, i32, f32,
                                       f32, f32, i32, vp, vp, vp, vp, vp]
    lib.rt_cluster_columns.restype = i32
    lib.rt_cluster_tile.restype = i32


_CLUSTER_LIB = cuda_build.Library(CLUSTER_SOURCE, _bind_cluster)


def build_cluster():
    """Path of the built cluster kernel library, compiling it with nvcc
    first if the build cache holds none (see ``utils/cuda_build.py``)."""
    return _CLUSTER_LIB.build()


def cluster_columns(s, coef, logf, reach, smin, rep_cap):
    """The cluster step on a card: ``(ncl, marg, rep_idx, rep_val)`` of
    :meth:`PeakPlan._cluster_impl` over :meth:`PeakPlan._thr_impl`, bit
    for bit, from one launch of ``csrc/cluster.cu`` on the current
    stream of the cube's card (made the current device for the launch).
    ``s`` (D, NW, n) and ``coef`` (D, NW, K <= 3) float32, ``logf`` (n)
    float32 and ``reach`` (n) int32, all contiguous on one CUDA device;
    ``smin`` and :data:`EPS` are rounded to float32 as the
    plain form's comparisons round them. Raises ValueError on any other
    operand, RuntimeError on a failed build or launch. On the ``meta``
    device (the shape-only walk) it only allocates the outputs."""
    global CLUSTER_LAUNCHES
    dev = s.device
    if dev.type not in ("cuda", "meta") or s.dim() != 3:
        raise ValueError(f"cluster_columns: want a (D, NW, n) cube on a "
                         f"card, got {tuple(s.shape)} on {dev}")
    D, NW, n = s.shape
    K = coef.shape[-1]
    if not 1 <= K <= 3:
        raise ValueError(f"cluster_columns: {K} threshold coefficients, "
                         f"the kernel takes 1 to 3")
    cuda_build.require(s, "s", torch.float32, dev)
    cuda_build.require(coef, "coef", torch.float32, dev, (D, NW, K))
    cuda_build.require(logf, "logf", torch.float32, dev, (n,))
    cuda_build.require(reach, "reach", torch.int32, dev, (n,))
    ncl = torch.empty((D, NW), dtype=torch.int32, device=dev)
    marg = torch.empty((D, NW), dtype=torch.bool, device=dev)
    rep_idx = torch.empty((D, NW, rep_cap), dtype=torch.int64, device=dev)
    rep_val = torch.empty((D, NW, rep_cap), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return ncl, marg, rep_idx, rep_val
    lib = _CLUSTER_LIB.load()
    f32 = np.float32
    with torch.cuda.device(dev):
        cuda_build.check(lib, "cluster_columns", lib.rt_cluster_columns(
            s.data_ptr(), coef.data_ptr(), K, logf.data_ptr(),
            reach.data_ptr(), D * NW, n, float(f32(EPS)),
            float(f32(smin - EPS)), float(f32(smin + EPS)), rep_cap,
            ncl.data_ptr(), marg.data_ptr(), rep_idx.data_ptr(),
            rep_val.data_ptr(), cuda_build.stream(dev)))
    with _LAUNCH_LOCK:
        CLUSTER_LAUNCHES += 1
    return ncl, marg, rep_idx, rep_val


class PeakPlan:
    """Static (data-independent) part of on-device peak detection for one
    periodogram plan + observation length."""

    def __init__(self, plan, tobs, smin=6.0, segwidth=5.0, nstd=6.0,
                 minseg=10, polydeg=2, clrad=0.1, device_cluster=None):
        freqs = 1.0 / plan.all_periods  # decreasing, like Periodogram.freqs
        n = freqs.size
        w = segwidth / tobs
        nseg = int(np.ceil(abs(freqs[-1] - freqs[0]) / w))
        pts = n // nseg
        self.plan = plan
        self.tobs = float(tobs)
        self.smin = float(smin)
        self.nstd = float(nstd)
        self.minseg = int(minseg)
        self.polydeg = int(polydeg)
        self.clrad = float(clrad)
        self.n = n
        self.nseg = nseg
        self.pts = pts
        self.freqs = freqs
        # Static control-point frequencies (median f per segment) and the
        # log-f evaluation grid (device side, float32).
        self.fc = np.median(freqs[: nseg * pts].reshape(nseg, pts), axis=1)
        self.logf = np.log(freqs).astype(np.float32)
        # Static least-squares operator of the threshold fit: the
        # control-point frequencies are fixed at plan time, so
        # polyfit(log fc, tc) reduces to one matmul coef = fitmat @ tc.
        # Built in float64, applied in float32 on the device; the exact
        # float64 np.polyfit re-fit happens on host in _finalize.
        V = np.vander(np.log(self.fc), self.polydeg + 1)
        self.fitmat = (np.linalg.inv(V.T @ V) @ V.T).astype(np.float32)
        if device_cluster is None:
            device_cluster = device_cluster_enabled()
        # The trusted fast path needs exact-maximisable threshold
        # difference polynomials (deg <= 2) and exact trial indices in
        # float32 (n < 2^24); outside those bounds the device sections
        # would never be trusted, so don't build them at all.
        self.device_cluster = bool(device_cluster) \
            and self.polydeg <= 2 and n < (1 << 24)
        if self.device_cluster:
            self.reach = self._cluster_reach()
            self.freqs_f32 = freqs.astype(np.float32)
            self.foldbins_f32 = np.asarray(plan.all_foldbins,
                                           np.float32)
            self.widths_f32 = np.asarray(plan.widths, np.float32)
        self._consts = {}          # device -> _device_consts

    def _device_consts(self, dev):
        """The device program's constants on ``dev``, built once per
        plan and device and cached. Their upload is the program's only
        host-to-device copy (blocking), paid by its first batch there;
        the values are those each batch used to copy."""
        with _CONSTS_LOCK:
            c = self._consts.get(dev)
            if c is None:
                c = self._consts[dev] = self._build_consts(dev)
        return c

    def _build_consts(self, dev):
        f32 = np.float32
        # The percentile positions q / 100 * (n - 1), each factor
        # rounded to float32 and multiplied on the device.
        q = _dev_tensor([q / 100.0 for q in _QS], f32, dev) * torch.full(
            (), float(self.pts) - 1.0, dtype=torch.float32, device=dev)
        c = {"q": q, "fitmat": _dev_tensor(self.fitmat, f32, dev),
             "logf": _dev_tensor(self.logf, f32, dev)}
        if self.device_cluster:
            c.update(reach=_dev_tensor(self.reach, np.int32, dev),
                     freqs=_dev_tensor(self.freqs_f32, f32, dev),
                     foldbins=_dev_tensor(self.foldbins_f32, f32, dev),
                     widths=_dev_tensor(self.widths_f32, f32, dev))
        if dev.type == "cuda":
            c["side"] = torch.cuda.Stream(device=dev)
        return c

    def _cluster_reach(self):
        """reach[a] = largest trial index j >= a still within the
        clustering radius of trial a, under cluster1d's EXACT float64
        predicate ``fl(freqs[a] - freqs[j]) <= r`` (freqs decrease with
        trial index, so the subtraction is the gap between trial a and
        every later trial). NOT the algebraically equivalent
        ``freqs[j] >= freqs[a] - r``: the two round differently, and the
        device cluster boundaries must reproduce cluster1d's decisions
        bit-for-bit. A searchsorted guess under the rearranged predicate
        lands within a few ulp-indices of the exact answer; the fix-up
        loops below walk it to the exact fixed point (the predicate is
        monotone in j, so each loop converges)."""
        freqs, n = self.freqs, self.n
        r = self.clrad / self.tobs
        j = np.searchsorted(-freqs, -(freqs - r), side="right") - 1
        j = np.clip(j, np.arange(n), n - 1)
        a = np.arange(n)
        while True:
            bad = freqs[a] - freqs[j] > r
            if not bad.any():
                break
            j[bad] -= 1
        while True:
            grow = (j + 1 < n) & (freqs[a] - freqs[np.minimum(j + 1, n - 1)]
                                  <= r)
            if not grow.any():
                break
            j[grow] += 1
        return j.astype(np.int32)

    # -- step 1: device segment stats ------------------------------------

    def _stats_impl(self, s):
        """s: (D, NW, n) f32 -> (D, NW, nseg, 3) [p25, p50, p75]."""
        D, NW, _ = s.shape
        seg = s[..., : self.nseg * self.pts].reshape(D, NW, self.nseg,
                                                     self.pts)
        return _percentiles(seg, self._device_consts(s.device)["q"])

    # -- step 2: host polyfit --------------------------------------------

    def _fit(self, stats):
        """stats: (D, NW, nseg, 3) -> (D, NW, polydeg+1) float64 polyco.
        Mirrors find_peaks_single: threshold control points are
        smed + nstd * (IQR / 1.349); static-smin fallback when the
        segment count is below minseg (riptide/peak_detection.py:126)."""
        D, NW = stats.shape[:2]
        polyco = np.zeros((D, NW, self.polydeg + 1), np.float64)
        s25 = stats[..., 0].astype(np.float64)
        smed = stats[..., 1].astype(np.float64)
        s75 = stats[..., 2].astype(np.float64)
        tc = smed + self.nstd * (s75 - s25) / 1.349
        if self.nseg < self.minseg:
            polyco[..., -1] = self.smin
            return polyco
        for d in range(D):
            for iw in range(NW):
                polyco[d, iw, :] = fit_threshold(
                    self.fc, tc[d, iw], polydeg=self.polydeg
                ).coefficients
        return polyco

    # -- step 3: device mask + block counts --------------------------------
    #
    # Selected points are sparse (tens to hundreds of 2e5 trials). The
    # trial axis is cut into BLK-sample blocks; the device counts the
    # selected points per block and carries home the first CAP non-empty
    # blocks of each column.

    BLK = 512
    # Non-empty blocks carried home per (trial, width) column; columns
    # with more fetch the rest with one more gather.
    CAP = 8
    # Cluster representatives carried home per column by the device
    # clustering; a column with more clusters is never trusted.
    REP_CAP = 32

    @property
    def _nb(self):
        return -(-self.n // self.BLK)

    def _thr_impl(self, polyco):
        """Horner evaluation of the f32 threshold polynomial at every
        trial's log-frequency: (D, NW, deg+1) -> (D, NW, n)."""
        logf = self._device_consts(polyco.device)["logf"]
        thr = torch.zeros(polyco.shape[:2] + (self.n,), dtype=torch.float32,
                          device=polyco.device)
        for k in range(polyco.shape[-1]):
            thr = thr * logf[None, None, :] + polyco[:, :, k, None]
        return thr

    def _counts_impl(self, s, polyco):
        thr = self._thr_impl(polyco)
        mask = (s > thr - EPS) & (s > self.smin - EPS)
        D, NW, n = s.shape
        pad = self._nb * self.BLK - n
        mask = torch.nn.functional.pad(mask, (0, pad))
        return mask.reshape(D, NW, self._nb, self.BLK).sum(-1).to(
            torch.int32)

    # -- on-device 1-D clustering over the sure-selected mask ------------

    def _cluster(self, s, coef):
        """The cluster step from the cube ``s`` (D, NW, n) and the f32
        threshold coefficients ``coef`` (D, NW, deg + 1): the plain form
        (:meth:`_cluster_impl` over :meth:`_thr_impl`) for a cube on the
        CPU, else the kernel (:func:`cluster_columns`), which raises
        rather than fall back."""
        if s.device.type == "cpu":
            return self._cluster_impl(s, self._thr_impl(coef))
        c = self._device_consts(s.device)
        return cluster_columns(s, coef.contiguous(), c["logf"], c["reach"],
                               self.smin, self.REP_CAP)

    def _cluster_impl(self, s, thr):
        """The plain form of the cluster step: friends-of-friends
        clustering of each (trial, width) column's sure points (above
        threshold + EPS). Returns (ncl (D, NW) int32, marg (D, NW) bool,
        rep_idx (D, NW, REP_CAP) int64, rep_val (D, NW, REP_CAP)
        float32): per cluster the lexmax-(S/N, trial index)
        representative, in ascending-trial slot order. Cluster
        boundaries reproduce cluster1d exactly: adjacent selected trials
        j_prev < j chain iff j <= reach[j_prev]."""
        dev = s.device
        m_sel = (s > thr - EPS) & (s > self.smin - EPS)
        m = (s > thr + EPS) & (s > self.smin + EPS)        # sure
        marg = torch.any(m_sel & ~m, dim=-1)               # (D, NW)
        n = self.n
        reach = self._device_consts(dev)["reach"]
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        midx = idx.expand(m.shape)
        # prev_excl[j] / next_excl[j]: nearest selected index strictly
        # before / after j (-1 / n when none).
        prev = torch.cummax(torch.where(m, midx, -1), dim=2).values
        prev_excl = torch.nn.functional.pad(prev[..., :-1], (1, 0), value=-1)
        nxt = torch.flip(torch.cummin(torch.flip(
            torch.where(m, midx, n), dims=(2,)), dim=2).values, dims=(2,))
        next_excl = torch.nn.functional.pad(nxt[..., 1:], (0, 1), value=n)
        reach_prev = reach[prev_excl.clamp(0, n - 1)]
        head = m & ((prev_excl < 0) | (midx > reach_prev))
        last = m & (next_excl > reach[None, None, :])
        ncl = head.sum(-1).to(torch.int32)
        scan_v, scan_i = _seg_lexmax_scan(
            head, torch.where(m, s, -np.inf), torch.where(m, midx, -1))
        # Compact the first REP_CAP tail positions per column: strictly
        # decreasing keys REP_CAP..1 at kept tails, 0 elsewhere; a stable
        # descending sort returns them in ascending-trial order, as
        # lax.top_k does.
        rank = torch.cumsum(last.to(torch.int32), dim=-1,
                            dtype=torch.int32) - 1
        keep = last & (rank < self.REP_CAP)
        key = torch.where(keep, (self.REP_CAP - rank).to(torch.float32),
                          torch.zeros((), dtype=torch.float32, device=dev))
        kv, pos = torch.sort(key, dim=-1, descending=True, stable=True)
        kv, pos = kv[..., : self.REP_CAP], pos[..., : self.REP_CAP]
        valid = kv > 0
        rep_val = torch.gather(scan_v, -1, pos)
        rep_idx = torch.where(valid, torch.gather(scan_i, -1, pos), -1)
        rep_val = torch.where(valid, rep_val, -np.inf)
        return ncl, marg, rep_idx, rep_val

    def _harm_impl(self, rep_idx, rep_val):
        """Advisory per-trial harmonic screen over the cluster
        representatives: for each DM row, count representatives whose
        phase drift against the row's brightest representative matches
        a p/q rational (q <= 100) within the pulse width and whose S/N
        matches the expected harmonic loss. float32, counts only.
        Returns (D,) float32."""
        dev = rep_idx.device
        D = rep_idx.shape[0]
        R = rep_idx.shape[1] * rep_idx.shape[2]
        ridx = rep_idx.reshape(D, R)
        rval = rep_val.reshape(D, R)
        valid = ridx >= 0
        safe = ridx.clamp(0, self.n - 1)
        c = self._device_consts(dev)
        freq = c["freqs"][safe]
        ducy = (c["widths"].repeat_interleave(rep_idx.shape[2])[None, :]
                / c["foldbins"][safe])
        top = torch.argmax(torch.where(valid, rval, -np.inf), dim=-1)
        fF = torch.gather(freq, 1, top[:, None])
        sF = torch.gather(rval, 1, top[:, None])
        dF = torch.gather(ducy, 1, top[:, None])
        lo = torch.minimum(freq, fF)
        hi = torch.maximum(freq, fF)
        ducy_fast = torch.where(freq >= fF, ducy, dF)
        ratio = hi / lo.clamp_min(1e-30)
        q = torch.arange(1, _H_QMAX + 1, dtype=torch.float32, device=dev)
        p = torch.round(ratio[..., None] * q).clamp_min(1.0)
        err = torch.abs(ratio[..., None] - p / q)
        best = torch.argmin(err, dim=-1)
        err_b = torch.gather(err, -1, best[..., None])[..., 0]
        pq = torch.gather(p * q, -1, best[..., None])[..., 0]
        phase = err_b * lo * self.tobs / ducy_fast.clamp_min(1e-30)
        snr_d = torch.abs(rval - sF / torch.sqrt(pq))
        others = (valid
                  & (torch.arange(R, dtype=torch.int64, device=dev)[None, :]
                     != top[:, None])
                  & valid.any(-1)[:, None])
        related = others & (phase <= _H_PHASE_MAX) & (snr_d <= _H_SNR_MAX)
        return related.sum(-1).to(torch.float32)

    # -- the device program ----------------------------------------------

    def _fused(self, snr):
        """The whole device side: stats, f32 threshold fit, block counts,
        and the first CAP non-empty blocks per column, as ONE flat
        float32 buffer [stats | cnt | ids | vals], plus [coef | ncl |
        marg | rep_idx | rep_val | harm] with device clustering. Integer
        fields travel as float32 values (exact: far below 2^24). Each
        step is a span: ``peaks.stats``, ``peaks.fit``, ``peaks.counts``,
        ``peaks.select``, ``peaks.cluster`` and ``peaks.harm`` (device
        clustering only), ``peaks.pack``."""
        dev = snr.device
        with span("peaks.stats"):
            s = snr.transpose(1, 2).contiguous()         # (D, NW, n)
            stats = self._stats_impl(s)                  # (D, NW, nseg, 3)
        D, NW = stats.shape[:2]
        with span("peaks.fit"):
            if self.nseg >= self.minseg:
                tc = (stats[..., 1]
                      + self.nstd * (stats[..., 2] - stats[..., 0]) / 1.349)
                coef = torch.einsum("ks,dws->dwk",
                                    self._device_consts(dev)["fitmat"], tc)
            else:
                coef = torch.zeros((D, NW, self.polydeg + 1),
                                   dtype=torch.float32, device=dev)
                coef[..., -1] = self.smin
        with span("peaks.counts"):
            cnt = self._counts_impl(s, coef)             # (D, NW, nb)
        f32 = torch.float32
        with span("peaks.select"):
            nb, BLK, CAP = self._nb, self.BLK, self.CAP
            nz = cnt > 0
            rank = torch.cumsum(nz.to(torch.int32), dim=-1,
                                dtype=torch.int32) - 1
            oh = (nz & (rank < CAP))[..., None] & (      # (D, NW, nb, CAP)
                rank[..., None] == torch.arange(CAP, dtype=torch.int32,
                                                device=dev))
            bids = torch.arange(nb, dtype=torch.int64,
                                device=dev)[None, None, :, None]
            ids = torch.where(oh, bids, 0).sum(dim=2)    # (D, NW, CAP)
            ids = torch.where(oh.any(dim=2), ids, -1)
            sp = torch.nn.functional.pad(s, (0, nb * BLK - self.n),
                                         value=-np.inf)
            sblk = sp.reshape(D, NW, nb, BLK)
            vals = torch.gather(                         # (D, NW, CAP, BLK)
                sblk, 2,
                ids.clamp(0, nb - 1)[..., None].expand(D, NW, CAP, BLK))
            parts = [stats.reshape(-1), cnt.to(f32).reshape(-1),
                     ids.to(f32).reshape(-1), vals.reshape(-1)]
        if self.device_cluster:
            with span("peaks.cluster"):
                ncl, marg, rep_idx, rep_val = self._cluster(s, coef)
            with span("peaks.harm"):
                harm = self._harm_impl(rep_idx, rep_val)
        with span("peaks.pack"):
            if self.device_cluster:
                rep_val = torch.where(rep_idx >= 0, rep_val,
                                      torch.zeros((), dtype=f32, device=dev))
                parts += [coef.reshape(-1), ncl.to(f32).reshape(-1),
                          marg.to(f32).reshape(-1),
                          rep_idx.to(f32).reshape(-1), rep_val.reshape(-1),
                          harm]
            return torch.cat(parts)

    def _unpack(self, buf, D):
        NW, nseg, nb, CAP, BLK = (len(self.plan.widths), self.nseg,
                                  self._nb, self.CAP, self.BLK)
        sizes = [D * NW * nseg * 3, D * NW * nb, D * NW * CAP,
                 D * NW * CAP * BLK]
        if self.device_cluster:
            RC = self.REP_CAP
            sizes += [D * NW * (self.polydeg + 1), D * NW, D * NW,
                      D * NW * RC, D * NW * RC, D]
        offs = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
        stats = buf[offs[0]:offs[1]].reshape(D, NW, nseg, 3)
        cnt = buf[offs[1]:offs[2]].astype(np.int32).reshape(D, NW, nb)
        ids = buf[offs[2]:offs[3]].astype(np.int32).reshape(D, NW, CAP)
        vals = buf[offs[3]:offs[4]].reshape(D, NW, CAP, BLK)
        if not self.device_cluster:
            return stats, cnt, ids, vals, None
        RC = self.REP_CAP
        extra = {
            "coef": buf[offs[4]:offs[5]].reshape(D, NW, self.polydeg + 1),
            "ncl": buf[offs[5]:offs[6]].astype(np.int32).reshape(D, NW),
            "marg": buf[offs[6]:offs[7]].reshape(D, NW) != 0.0,
            "rep_idx": buf[offs[7]:offs[8]].astype(np.int64).reshape(
                D, NW, RC),
            "rep_val": buf[offs[8]:offs[9]].reshape(D, NW, RC),
            "harm": buf[offs[9]:offs[10]],
        }
        return stats, cnt, ids, vals, extra

    def _gather_blocks(self, snr, flat_ids):
        """The (d, iw, block) rows of BLK S/N values named by flat_ids
        ((k,) = (d * NW + iw) * nb + b), -inf past the last trial; read
        from the cube in place, with no padded copy of it."""
        _, n, NW = snr.shape
        ids = flat_ids.to(torch.int64)
        col, b = ids // self._nb, ids % self._nb
        pos = b[:, None] * self.BLK + torch.arange(
            self.BLK, dtype=torch.int64, device=snr.device)
        vals = snr[(col // NW)[:, None], pos.clamp(max=n - 1),
                   (col % NW)[:, None]]
        return torch.where(pos < n, vals, -np.inf)

    def _pull_blocks(self, snr, ids, done):
        """The overflow gather's block values (``ids``: padded flat
        block ids, host int32) on the host. On a card it runs on the
        plan's side stream after the chunk's event ``done`` alone, so it
        never waits behind work queued after the chunk; its pull blocks
        the host until the side stream is done, so the caller may free
        the cube at once."""
        if done is None:
            return self._gather_blocks(
                snr, torch.from_numpy(ids).to(snr.device)).cpu().numpy()
        side = self._device_consts(snr.device)["side"]
        side.wait_event(done)
        get_metrics().add("overflow_gathers", 1)
        with torch.cuda.stream(side):
            ids_dev = torch.from_numpy(ids).to(snr.device)
            return self._gather_blocks(snr, ids_dev).cpu().numpy()

    # -- step 4: host exact threshold + clustering -----------------------

    def _trusted_cols(self, extra, polyco):
        """(D, NW) bool: columns whose device cluster representatives
        are PROVABLY identical to the host float64 tail's. A column is
        trusted iff (a) no point fell in the +/-EPS marginal band (so
        the device's sure mask IS the host's exact-keep set, given (c)),
        (b) every cluster fit in the REP_CAP slots, and (c) the f32
        threshold the device applied provably stays within EPS of the
        host's float64 polynomial everywhere on the log-f domain: the
        difference of the two polynomials has degree <= 2, so its
        maximum over [min log f, max log f] is computed EXACTLY from
        the endpoints and the single critical point, plus a
        conservative bound on the device's f32 Horner evaluation
        rounding. Never a guess — an untrusted column costs only the
        host fallback on block data already pulled."""
        coef = extra["coef"].astype(np.float64)            # (D, NW, K)
        if self.nseg >= self.minseg:
            ref = polyco
        else:
            ref = np.zeros_like(coef)
            ref[..., -1] = self.smin
        diff = coef - ref
        logf64 = np.log(self.freqs)
        x0, x1 = float(logf64.min()), float(logf64.max())
        X = max(abs(x0), abs(x1))
        K = diff.shape[-1]
        d2 = diff.reshape(-1, K)

        def horner(x):
            r = np.zeros(d2.shape[0], np.float64)
            for k in range(K):
                r = r * x + d2[:, k]
            return r

        cand = [horner(x0), horner(x1)]
        if K == 3:
            a, b = d2[:, 0], d2[:, 1]
            with np.errstate(divide="ignore", invalid="ignore"):
                xc = np.where(a != 0.0, -b / (2.0 * a), x0)
            cand.append(horner(np.clip(xc, x0, x1)))
        maxdiff = np.max(np.abs(np.stack(cand)), axis=0).reshape(
            diff.shape[:2])
        powers = X ** np.arange(K - 1, -1, -1.0)
        mag = (np.abs(coef) * powers).sum(-1)
        dcoef = np.abs(coef[..., :-1]) * np.arange(K - 1, 0, -1.0)
        dmag = (dcoef * powers[1:]).sum(-1) if K > 1 else 0.0
        slack = 64.0 * _EPS32 * (mag + dmag * X)
        return ((maxdiff + slack < EPS) & ~extra["marg"]
                & (extra["ncl"] <= self.REP_CAP))

    def _finalize(self, cols, polyco, widths, foldbins, dms, D, NW,
                  device_reps=None):
        """cols: dict (d, iw) -> (trial indices int64, S/N float64) of
        every device-selected point in that column. ``device_reps``:
        dict (d, iw) -> [(trial index, S/N), ...] of TRUSTED device
        cluster representatives, already in the host's per-column
        emission order (ascending frequency); those columns skip the
        host re-check + clustering entirely — by the trust proof the
        result is identical, including the insertion order the final
        stable sort preserves among equal-S/N peaks."""
        peaks_per_trial = [[] for _ in range(D)]
        polycos = [{} for _ in range(D)]
        logf64 = np.log(self.freqs)
        for d in range(D):
            for iw in range(NW):
                pc = polyco[d, iw]
                poly = np.poly1d(pc if self.nseg >= self.minseg else [self.smin])
                polycos[d][iw] = poly.coefficients
                if device_reps is not None and (d, iw) in device_reps:
                    for ip, sj in device_reps[(d, iw)]:
                        fpk = float(self.freqs[ip])
                        peaks_per_trial[d].append(Peak(
                            period=float(1.0 / fpk), freq=fpk,
                            width=int(widths[iw]),
                            ducy=float(widths[iw]) / float(foldbins[ip]),
                            iw=int(iw), ip=int(ip), snr=float(sj),
                            dm=float(dms[d]),
                        ))
                    continue
                if (d, iw) not in cols:
                    continue
                ix, sv = cols[(d, iw)]
                # exact float64 re-check (the device applied thr - EPS)
                keep = (sv > poly(logf64[ix])) & (sv > self.smin)
                ix, sv = ix[keep], sv[keep]
                if ix.size == 0:
                    continue
                fsel = self.freqs[ix]
                for cl in cluster1d(fsel, self.clrad / self.tobs):
                    j = cl[sv[cl].argmax()]
                    ip = int(ix[j])
                    fpk = float(self.freqs[ip])
                    peaks_per_trial[d].append(Peak(
                        period=float(1.0 / fpk), freq=fpk,
                        width=int(widths[iw]),
                        ducy=float(widths[iw]) / float(foldbins[ip]),
                        iw=int(iw), ip=ip, snr=float(sv[j]),
                        dm=float(dms[d]),
                    ))
        return (
            [sorted(pk, key=lambda p: p.snr, reverse=True)
             for pk in peaks_per_trial],
            polycos,
        )


def queue_find_peaks(peak_plan, snr_dev):
    """Queue the device peak program on the (D, n_trials, NW) S/N cube
    (a tensor, or an array it is made from); returns a handle for
    :func:`collect_peaks` without syncing. On a card the fused buffer's
    pull is queued too: a copy into pinned host memory behind the
    program, then an event on the same stream."""
    snr_dev = torch.as_tensor(snr_dev, dtype=torch.float32)
    if peak_plan.device_cluster:
        get_metrics().add("dispatch_cluster", 1)
    buf = peak_plan._fused(snr_dev)
    # A mutable handle [buffer, cube, event]: collect_peaks drops the
    # entries to release the buffers while the caller still holds the
    # handle.
    if buf.device.type != "cuda":
        return [buf, snr_dev, None]
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(buf.device))
    return [host, snr_dev, done]


def _pull(handle):
    """The chunk's fused buffer on the host, as numpy. On a card: wait
    on the chunk's own event (its pinned copy is then done)."""
    buf, done = handle[0], handle[2]
    handle[0] = None
    if done is None:
        return buf.cpu().numpy()
    reg = get_metrics()
    reg.add("peaks_pull_ready", int(done.query()))
    t0 = time.perf_counter()
    done.synchronize()
    reg.observe("peaks_pull_wait_s", time.perf_counter() - t0)
    return buf.numpy()


def collect_peaks(peak_plan, handle, dms):
    """Pull the fused buffer (ONE transfer) and finish on host: exact
    float64 threshold re-fit/re-check + clustering -> Peak tuples. The
    wait for the chunk and the pull are the span ``pull``; everything
    after it is the span ``tail``, with ``overflow`` (the overflow
    gather, ``blocks=``) and ``cluster`` inside.

    Returns (peaks_per_trial, polycos_per_trial) where peaks_per_trial[d]
    is a list of Peak sorted by decreasing S/N — the contract of the
    host ``find_peaks`` (riptide/peak_detection.py:146-222).
    """
    with span("pull"):
        buf = _pull(handle)                                # the one pull
    with span("tail"):
        return _collect_tail(peak_plan, handle, buf, dms)


def _collect_tail(peak_plan, handle, buf, dms):
    """:func:`collect_peaks` after the pull: ``buf`` is the pulled
    buffer, ``handle[1]`` the S/N cube, released once no overflow gather
    needs it, ``handle[2]`` the chunk's event (None off a card)."""
    plan = peak_plan.plan
    snr_dev = handle[1]
    D = snr_dev.shape[0]
    # Integrity Ring 1: fold the raw pulled bytes into the dispatch
    # attempt's digest, host-side after the pull (a no-op returning
    # ``buf`` untouched when no fold context is active).
    buf = fold_result(buf)
    t_host = time.perf_counter()   # the host tail starts after the pull
    reg = get_metrics()
    stats, cnt, ids, vals, extra = peak_plan._unpack(buf, D)
    NW, nb, BLK, CAP = (cnt.shape[1], peak_plan._nb, peak_plan.BLK,
                        peak_plan.CAP)
    polyco = peak_plan._fit(stats)

    # On-device clustering: keep a column's device representatives only
    # when the trust proof holds (see _trusted_cols); untrusted columns
    # fall back to the block data already in this pull — no extra
    # round trip, bit-identical output either way.
    trusted = None
    device_reps = None
    if extra is not None:
        trusted = peak_plan._trusted_cols(extra, polyco)
        ncl, rep_idx, rep_val = (extra["ncl"], extra["rep_idx"],
                                 extra["rep_val"])
        device_reps = {}
        for d, iw in zip(*np.nonzero(trusted & (ncl > 0))):
            k = int(ncl[d, iw])
            # Representative slots are in ascending-trial (descending
            # frequency) order; the host emits clusters in ascending
            # FREQUENCY order, so walk them reversed — the final stable
            # sort preserves this order among equal-S/N peaks.
            device_reps[(int(d), int(iw))] = [
                (int(rep_idx[d, iw, c]), float(rep_val[d, iw, c]))
                for c in reversed(range(k))
            ]
        reg.add("cluster_cols_device", int((trusted & (ncl > 0)).sum()))
        reg.add("harmonic_suspects", int(extra["harm"].sum()))

    # The S/N cube is only needed again for the (pathological) overflow
    # gather below; release it as soon as the counts show no UNTRUSTED
    # column overflowed its CAP-block budget (a trusted column's
    # overflow blocks are irrelevant — its peaks come from the
    # representative section).
    over_mask = (cnt > 0).sum(axis=2) > CAP
    if trusted is not None:
        over_mask &= ~trusted
    if not over_mask.any():
        handle[1] = snr_dev = None
    off = np.arange(BLK)
    cols = {}

    def add(d, iw, b, row):
        pos = b * BLK + off
        ok = pos < peak_plan.n
        # every point of a selected block comes home; the exact float64
        # threshold cut happens in _finalize
        key = (int(d), int(iw))
        ix, sv = pos[ok].astype(np.int64), row[ok].astype(np.float64)
        if key in cols:
            pix, psv = cols[key]
            cols[key] = (np.concatenate([pix, ix]), np.concatenate([psv, sv]))
        else:
            cols[key] = (ix, sv)

    for d, iw in zip(*np.nonzero((ids >= 0).any(axis=2))):
        if trusted is not None and trusted[d, iw]:
            continue
        for c in range(CAP):
            b = ids[d, iw, c]
            if b < 0:
                break
            add(d, iw, b, vals[d, iw, c])
    if trusted is not None:
        reg.add("cluster_cols_host", len(cols))

    # Overflow: an untrusted column with more than CAP non-empty blocks
    # (threshold pathologically low) falls back to the round-trip
    # bucketed gather for the blocks the fused program could not carry
    # home.
    over = np.argwhere(over_mask)
    if over.size:
        sel = []
        for d, iw in over:
            bs = np.nonzero(cnt[d, iw])[0][CAP:]
            sel.extend((d, iw, b) for b in bs)
        sel = np.asarray(sel)
        log.warning("peak block overflow: %d extra blocks in %d columns",
                    len(sel), len(over))
        flat_ids = ((sel[:, 0] * NW + sel[:, 1]) * nb + sel[:, 2]).astype(
            np.int32
        )
        with span("overflow", blocks=len(flat_ids)):
            # Bucket the gather size so repeated batches reuse a handful
            # of compiled programs instead of one per data-dependent count.
            bucket = max(64, 1 << int(np.ceil(np.log2(len(flat_ids)))))
            padded = np.zeros(bucket, np.int32)
            padded[: len(flat_ids)] = flat_ids
            gvals = peak_plan._pull_blocks(snr_dev, padded, handle[2])
            gvals = fold_result(gvals[: len(flat_ids)])
        handle[1] = snr_dev = None
        for row, (d, iw, b) in zip(gvals, sel):
            add(d, iw, b, row)

    # Host tail: the exact float64 re-check and clustering of the
    # untrusted columns, Peak assembly from the trusted ones. cluster_s
    # times this tail, postsearch_s all the host work after the pull.
    with span("cluster", trials=int(D)):
        t_cl = time.perf_counter()
        out = peak_plan._finalize(
            cols, polyco, plan.widths, plan.all_foldbins, dms, D, NW,
            device_reps=device_reps,
        )
        reg.observe("cluster_s", time.perf_counter() - t_cl)
    reg.observe("postsearch_s", time.perf_counter() - t_host)
    return out


def device_find_peaks(peak_plan, snr_dev, dms):
    """Run the device peak detection (queue + collect in one).

    Parameters
    ----------
    peak_plan : PeakPlan
    snr_dev : (D, n_trials, NW) tensor (or array) of S/N values in plan
        trial order
    dms : (D,) DM value per batch row
    """
    return collect_peaks(peak_plan, queue_find_peaks(peak_plan, snr_dev), dms)
