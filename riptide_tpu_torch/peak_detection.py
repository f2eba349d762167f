"""
Peak detection in periodograms with a dynamically fitted S/N threshold.

Semantics follow the reference (riptide/peak_detection.py): per width
trial, the frequency axis is cut into ~1/T-wide segments; each segment's
median S/N and robust (IQR-based) standard deviation define threshold
control points; a polynomial in log(f) is fitted through them; points
above both the fitted threshold and the static ``smin`` are clustered in
frequency, and each cluster's S/N maximum becomes a Peak.

Host-side numpy, copied from the JAX package's ``peak_detection.py``:
the device peak program (:mod:`riptide_tpu_torch.search.peaks_device`)
finishes on the host with :class:`Peak` and :func:`fit_threshold`, and
:func:`find_peaks` is the host form it must agree with.
"""
import logging
import typing
from math import ceil

import numpy as np

from .clustering import cluster1d
from .timing import timing

log = logging.getLogger("riptide_tpu_torch.peak_detection")

__all__ = ["Peak", "find_peaks", "find_peaks_single", "segment_stats", "fit_threshold"]


class Peak(typing.NamedTuple):
    """Essential parameters of a peak found in a Periodogram."""

    period: float
    freq: float
    width: int
    ducy: float  # duty cycle
    iw: int  # width trial index
    ip: int  # period trial index
    snr: float
    dm: float

    def summary_dict(self):
        """Minimal attribute dict written as CSV by the pipeline."""
        attrs = ("period", "freq", "dm", "width", "ducy", "snr")
        return {a: getattr(self, a) for a in attrs}


# Canonical flat-record layout for Peak serialization (survey journal,
# multihost gather): field order IS the NamedTuple order, and these are
# the integer-valued fields. One definition so the encoders cannot
# drift apart and misdecode values into the wrong fields.
PEAK_FIELDS = Peak._fields
PEAK_INT_FIELDS = frozenset(("width", "iw", "ip"))


def segment_stats(f, s, T, segwidth=5.0):
    """
    Cut a periodogram into equal segments spanning ``segwidth / T`` in
    frequency; return per-segment (median frequency, median S/N, robust
    S/N std = IQR / 1.349).
    """
    w = segwidth / T
    m = ceil(abs(f[-1] - f[0]) / w)  # number of segments
    p = len(f) // m  # points per complete segment
    n = m * p
    fc = np.median(f[:n].reshape(m, p), axis=1)
    s25, smed, s75 = np.percentile(s[:n].reshape(m, p), (25, 50, 75), axis=-1)
    sstd = (s75 - s25) / 1.349
    return fc, smed, sstd


def fit_threshold(fc, tc, polydeg=2):
    """Polynomial in log(f) through the threshold control points."""
    coeffs = np.polyfit(np.log(fc), tc, polydeg)
    return np.poly1d(coeffs)


def find_peaks_single(f, s, T, smin=6.0, segwidth=5.0, nstd=7.0, minseg=10, polydeg=2, clrad=0.1):
    """
    Peak indices for one width trial. Returns (peak_indices, polyco) where
    polyco are the fitted threshold polynomial coefficients in log(f)
    (or the static [smin] fallback when too few segments).
    """
    fc, smed, sstd = segment_stats(f, s, T, segwidth=segwidth)
    sc = smed + nstd * sstd

    if len(fc) >= minseg:
        poly = fit_threshold(fc, sc, polydeg=polydeg)
        polyco = poly.coefficients
    else:
        polyco = [smin]
        poly = np.poly1d(polyco)

    dynthr = poly(np.log(f))
    mask = (s > dynthr) & (s > smin)
    indices = np.where(mask)[0]
    fsel = f[indices]

    peak_indices = []
    for cl in cluster1d(fsel, clrad / T):
        ix = indices[cl]
        peak_indices.append(ix[s[ix].argmax()])
    return peak_indices, polyco


@timing
def find_peaks(pgram, smin=6.0, segwidth=5.0, nstd=6.0, minseg=10, polydeg=2, clrad=0.1):
    """
    Identify significant peaks in a periodogram.

    Parameters
    ----------
    pgram : Periodogram
    smin : float
        Static minimum S/N every peak must exceed.
    segwidth : float
        Frequency segment width in units of 1/T_obs.
    nstd : float
        Threshold = segment median + nstd * robust std.
    minseg : int
        Below this many segments, only the static threshold applies.
    polydeg : int
        Degree of the log(f) threshold polynomial.
    clrad : float
        Peak clustering radius in frequency, in units of 1/T_obs.

    Returns
    -------
    peaks : list of Peak, sorted by decreasing S/N
    polycos : dict {width trial index: threshold polynomial coefficients}
    """
    f = pgram.freqs
    T = pgram.tobs
    dm = pgram.metadata["dm"]

    peaks = []
    polycos = {}
    for iw, width in enumerate(pgram.widths):
        s = pgram.snrs[:, iw].astype(float)
        idx, polyco = find_peaks_single(
            f, s, T, smin=smin, segwidth=segwidth, nstd=nstd,
            minseg=minseg, polydeg=polydeg, clrad=clrad,
        )
        for ipeak in idx:
            peak_freq = f[ipeak]
            peak_bins = pgram.foldbins[ipeak]
            # Plain python floats/ints: np.float32 members cause trouble in
            # downstream serialization and comparisons.
            peaks.append(
                Peak(
                    freq=float(peak_freq),
                    period=float(1.0 / peak_freq),
                    width=int(width),
                    ducy=float(width) / float(peak_bins),
                    iw=int(iw),
                    ip=int(ipeak),
                    snr=float(s[ipeak]),
                    dm=dm,
                )
            )
        polycos[iw] = polyco
    return sorted(peaks, key=lambda p: p.snr, reverse=True), polycos
