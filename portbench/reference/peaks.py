"""
Plain reference of riptide's peak detection (riptide/peak_detection.py
and riptide/clustering.py), in NumPy: per width trial, the frequency
axis cut into segments of ``segwidth / T``; each segment's median S/N
and robust standard deviation (IQR / 1.349) give threshold control
points; a polynomial in log(f) through them; the points above both it
and ``smin`` clustered in frequency (friends of friends within
``clrad / T``), and each cluster's S/N maximum is a peak.

Returns peaks as plain tuples ``(ip, iw, snr, period)``, sorted by
decreasing S/N, then width, then period index.
"""
from math import ceil

import numpy as np

__all__ = ["find_peaks"]


def _cluster1d(x, r):
    if not len(x):
        return []
    order = x.argsort()
    gaps = np.flatnonzero(np.abs(np.diff(x[order])) > r)
    edges = np.concatenate(([0], gaps + 1, [len(x)]))
    return [order[lo:hi] for lo, hi in zip(edges[:-1], edges[1:])]


def _segment_stats(f, s, T, segwidth):
    w = segwidth / T
    m = ceil(abs(f[-1] - f[0]) / w)
    p = len(f) // m
    n = m * p
    fc = np.median(f[:n].reshape(m, p), axis=1)
    s25, smed, s75 = np.percentile(s[:n].reshape(m, p), (25, 50, 75),
                                   axis=-1)
    return fc, smed, (s75 - s25) / 1.349


def _peaks_single(f, s, T, smin, segwidth, nstd, minseg, polydeg, clrad):
    fc, smed, sstd = _segment_stats(f, s, T, segwidth)
    if len(fc) >= minseg:
        poly = np.poly1d(np.polyfit(np.log(fc), smed + nstd * sstd,
                                    polydeg))
    else:
        poly = np.poly1d([smin])
    idx = np.where((s > poly(np.log(f))) & (s > smin))[0]
    return [int(ix[s[ix].argmax()])
            for ix in (idx[c] for c in _cluster1d(f[idx], clrad / T))]


def find_peaks(periods, snrs, tobs, smin=6.0, segwidth=5.0, nstd=6.0,
               minseg=10, polydeg=2, clrad=0.1):
    """Peaks of one periodogram: ``periods`` (n,) float64, ``snrs`` (n,
    n_widths)."""
    f = 1.0 / np.asarray(periods, np.float64)
    snrs = np.asarray(snrs)
    out = []
    for iw in range(snrs.shape[1]):
        s = snrs[:, iw].astype(float)
        for ip in _peaks_single(f, s, tobs, smin, segwidth, nstd, minseg,
                                polydeg, clrad):
            out.append((ip, iw, float(s[ip]), float(1.0 / f[ip])))
    return sorted(out, key=lambda p: (-p[2], p[1], p[0]))
