"""
Harmonic relationship testing between candidate peaks.

Given a postulated fundamental F and harmonic H (anything exposing
.freq, .snr, .ducy, .dm), decide whether H is plausibly the p/q-th
harmonic of F. The test mirrors the reference's three-distance criterion
(riptide/pipeline/harmonic_testing.py:9-155) and is deliberately tuned
to under-flag rather than over-flag:

1. phase distance — pulse-width-normalised phase drift accrued over the
   observation between H and the hypothesised p/q x F signal;
2. DM distance — difference in dispersion delay across the band implied
   by the two DMs, in units of the narrower pulse width;
3. S/N distance — |H.snr - F.snr / sqrt(p*q)|, the harmonic's expected
   matched-filter S/N loss.

H is flagged only if ALL three distances are under their maxima.
"""
import logging
from fractions import Fraction

import numpy as np

log = logging.getLogger("riptide_tpu_torch.pipeline.harmonic_testing")

__all__ = ["hdiag", "htest", "dm_distance_matrix"]

# Dispersion delay constant in s MHz^2 pc^-1 cm^3 (delay = KDM_S * DM / f^2)
KDM_S = 4.15e3


def hdiag(F, H, tobs, fmin, fmax, denom_max=100):
    """
    Diagnostic distances for the harmonic hypothesis. Returns a dict with
    the closest rational fraction H.freq/F.freq (denominator capped at
    ``denom_max`` — without a cap some fraction always matches) and the
    three distances described in the module docstring.
    """
    if not fmax > fmin:
        raise ValueError("fmax must be > fmin")
    if not tobs > 0.0:
        raise ValueError("tobs must be > 0")

    slow, fast = sorted((F, H), key=lambda x: x.freq)
    fraction = Fraction(fast.freq / slow.freq).limit_denominator(denom_max)

    # Phase drift (in turns) between `fast` and fraction x `slow` over the
    # observation, measured in units of the fast signal's pulse width.
    phase_absdiff_turns = abs(fraction * slow.freq - fast.freq) * tobs
    phase_distance = phase_absdiff_turns / fast.ducy

    # Report the fraction as H.freq / F.freq (2 => H is the 2nd harmonic).
    if H == slow:
        fraction = 1 / fraction

    width_f = F.ducy / F.freq
    width_h = H.ducy / H.freq
    dm_absdiff = abs(F.dm - H.dm)
    dm_delay_absdiff = dm_absdiff * KDM_S * abs(fmin**-2 - fmax**-2)
    dm_distance = dm_delay_absdiff / min(width_f, width_h)

    harmonic_snr_expected = F.snr / (fraction.numerator * fraction.denominator) ** 0.5
    snr_distance = abs(H.snr - harmonic_snr_expected)

    return {
        "fraction": fraction,
        "phase_absdiff_turns": phase_absdiff_turns,
        "phase_distance": phase_distance,
        "dm_absdiff": dm_absdiff,
        "dm_delay_absdiff": dm_delay_absdiff,
        "dm_distance": dm_distance,
        "harmonic_snr_expected": harmonic_snr_expected,
        "snr_distance": snr_distance,
    }


def dm_distance_matrix(peaks, fmin, fmax):
    """Pairwise :func:`hdiag` ``dm_distance`` over a peak sequence, as
    an (n, n) float64 matrix. The DM distance is the only one of the
    three htest criteria that does not depend on the fitted fraction,
    so it prefilters the O(n^2) pair loop: a pair whose entry exceeds
    ``dm_distance_max`` is rejected by :func:`htest` no matter what
    fraction fits, and skipping it cannot change which later pairs the
    sequential flagging pass visits (only *related* pairs mutate state).
    Every elementwise operation mirrors the scalar expression in
    :func:`hdiag` in the same order, so the entries are bit-identical
    to the scalar path and the prefilter never flips a verdict."""
    if not fmax > fmin:
        raise ValueError("fmax must be > fmin")
    dms = np.asarray([p.dm for p in peaks], dtype=np.float64)
    widths = np.asarray([p.ducy / p.freq for p in peaks],
                        dtype=np.float64)
    band = abs(fmin**-2 - fmax**-2)
    dm_delay = np.abs(dms[:, None] - dms[None, :]) * KDM_S * band
    return dm_delay / np.minimum(widths[:, None], widths[None, :])


def htest(F, H, tobs, fmin, fmax, denom_max=100, phase_distance_max=1.0,
          dm_distance_max=3.0, snr_distance_max=3.0):
    """
    Test whether H is a credible harmonic of F.

    Returns (related: bool, fraction: Fraction) where fraction is the
    closest rational p/q to H.freq / F.freq. ``related`` is True only if
    the phase, DM and S/N distances (see :func:`hdiag`) are ALL within
    their respective maxima.
    """
    d = hdiag(F, H, tobs, fmin, fmax, denom_max=denom_max)
    related = (
        d["phase_distance"] <= phase_distance_max
        and d["dm_distance"] <= dm_distance_max
        and d["snr_distance"] <= snr_distance_max
    )
    return related, d["fraction"]
