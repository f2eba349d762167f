"""
Time series folding: produce the (sub-integrations, phase bins) array a
candidate plot is made of.

Behavioral contract follows the reference's fold()
(riptide/folding.py:19-81): downsample so one phase bin spans one
sample, cut into whole periods, scale so white noise keeps unit
variance, then optionally reduce the period count to ``subints`` rows.
The row reduction here is ONE vectorised real-factor downsample plan
applied to all phase-bin columns at once (an (nsub, m) weight-matrix
product in effect), not a per-column loop.
"""
import numpy as np

from .ops.reference import downsample_indices

__all__ = ["fold", "downsample_vertical"]


def downsample_vertical(X, factor):
    """
    Downsample the ROWS of a 2-D array by a real-valued ``factor``: every
    output row is the weighted sum of ~``factor`` input rows, fractional
    boundary rows split linearly (same per-axis semantics as the
    reference's downsample, riptide/cpp/downsample.hpp:44-82).

    All columns share one index/weight plan, applied in a handful of
    vectorised operations over the whole array.
    """
    X = np.asarray(X)
    m = X.shape[0]
    if not 1 < factor < m:
        raise ValueError(
            f"downsampling factor must be in (1, rows={m}), got {factor}"
        )
    imin, imax, wmin, wmax = downsample_indices(m, factor)
    x64 = X.astype(np.float64)
    cs = np.zeros((m + 1,) + X.shape[1:], np.float64)
    np.cumsum(x64, axis=0, out=cs[1:])
    interior = cs[imax] - cs[imin + 1]
    out = wmin[:, None] * x64[imin] + interior + wmax[:, None] * x64[imax]
    # float32 regardless of input dtype (integer inputs would otherwise
    # silently truncate the fractional boundary-row contributions).
    return np.ascontiguousarray(out, dtype=np.float32)


def _check_fold_args(ts, period, bins, subints):
    if period > ts.length:
        raise ValueError(
            f"cannot fold at period {period:.6f} s: longer than the "
            f"data ({ts.length:.6f} s)"
        )
    if period / bins <= ts.tsamp:
        raise ValueError(
            f"{bins} phase bins at period {period:.6f} s gives a bin "
            f"narrower than the sampling time {ts.tsamp:.2e} s"
        )
    if subints is None:
        return
    nper = ts.length / period
    if not 1 <= subints <= nper:
        raise ValueError(
            f"subints must be in [1, {int(nper)}] (whole periods in the "
            f"data), got {subints}"
        )


def fold(ts, period, bins, subints=None):
    """
    Fold a TimeSeries at ``period`` into ``bins`` phase bins.

    Returns a (subints, bins) array, or 1-D of length ``bins`` when
    ``subints`` is 1 (or only one period fits). ``subints=None`` keeps
    one row per whole period. Output is scaled by (m * factor)^-1/2 so
    unit-variance white noise stays unit variance after folding.
    """
    if subints is not None:
        subints = int(subints)
    _check_fold_args(ts, period, bins, subints)

    factor = period / (bins * ts.tsamp)
    down = ts.downsample(factor)
    m = down.nsamp // bins
    prof = down.data[: m * bins].reshape(m, bins) * (m * factor) ** -0.5

    if subints == 1 or m == 1:
        return prof.sum(axis=0)
    if subints is None or subints == m:
        return prof
    return downsample_vertical(prof, m / subints)
