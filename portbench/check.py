"""
What decides ``correct``: the window's outputs against the plain
reference (``portbench/reference``), and the run's isolation from JAX.

Three numbers a search range, each with its limit from
``portbench/limits/<config>.json``, named as :func:`named` says:

``snr_rms`` and ``snr_max``
    The root mean square and the largest absolute gap, over every trial
    period and width of the sampled DM trials, between the S/N that the
    window's stage kernels wrote (the last chunk of each ring slot) and
    the reference's S/N of the same raw series: float64 downsampling,
    the configured uint6 wire, float64 FFA and boxcar S/N. A fault in
    the prepared wire or in K1 shows here.
``peaks_bad``
    Peak lists judged wrong: each sampled trial's device peaks against
    the reference ``find_peaks`` on that trial's S/N column, and every
    chunk's peaks for every trial against those of its slot's checked
    chunk (the same series give the same answer). Exact: limit 0.
"""
import sys

import numpy as np
import torch

from .reference import peaks as ref_peaks
from .reference import search as ref

__all__ = ["FORBIDDEN", "UNCOMPARABLE", "forbidden_modules", "reference_snr",
           "snr_gaps", "peak_tuples", "judge_peaks", "named", "numbers_line"]

FORBIDDEN = ("jax", "jaxlib", "flax", "riptide_tpu")


def forbidden_modules(names=None):
    """Top-level names of loaded modules that the run may not hold,
    compared whole: ``riptide_tpu_torch`` is not ``riptide_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def reference_snr(series, stages, widths, row, device, qmax=31,
                  dtype=torch.float64):
    """Reference S/N (T, n_trials, n_widths) float64 on ``device`` of
    (T, N) float32 raw series (numpy)."""
    x = torch.from_numpy(np.ascontiguousarray(series)).to(device)
    return ref.periodogram(x, stages, widths, row, qmax=qmax, dtype=dtype)


# What a number reads where the S/N cannot be compared: above any limit,
# and still a number in the result's JSON line.
UNCOMPARABLE = float(np.finfo(np.float64).max)


def snr_gaps(got, want):
    """(rms, max) of |got - want|; :data:`UNCOMPARABLE` where the shapes
    differ or a value is not finite."""
    got = torch.as_tensor(got).to(want.device, torch.float64)
    if got.shape != want.shape:
        return UNCOMPARABLE, UNCOMPARABLE
    d = got - want
    if not bool(torch.isfinite(d).all()):
        return UNCOMPARABLE, UNCOMPARABLE
    return (float(torch.sqrt(torch.mean(d * d))), float(d.abs().max()))


def peak_tuples(peaks):
    """A trial's peaks (the program's ``Peak`` tuples) as sorted (ip, iw,
    snr, period) tuples."""
    return sorted(((int(p.ip), int(p.iw), float(p.snr), float(p.period))
                   for p in peaks), key=lambda p: (-p[2], p[1], p[0]))


def _same(got, want):
    return len(got) == len(want) and all(
        g[:3] == w[:3] and abs(g[3] - w[3]) <= 1e-9 * abs(w[3])
        for g, w in zip(got, want))


def judge_peaks(peaks, slots, sampled, snr_cols, periods, tobs, peak_kw):
    """(peaks_bad, the failed (chunk, trial) pairs) of one search range
    over a window: ``peaks[c]`` are chunk c's peaks per trial and
    ``slots[c]`` its ring slot, ``sampled[slot]`` lists the slot's
    sampled trials and ``snr_cols[slot]`` their S/N columns (k,
    n_trials, n_widths) as the window wrote them."""
    last = {}
    for c, slot in enumerate(slots):
        last[slot] = c
    bad, failed = 0, set()
    for slot, c in last.items():
        for j, t in enumerate(sampled[slot]):
            want = ref_peaks.find_peaks(periods, snr_cols[slot][j], tobs,
                                        **peak_kw)
            if not _same(peak_tuples(peaks[c][t]), want):
                bad += 1
                failed.update((k, t) for k, s in enumerate(slots)
                              if s == slot)
    for c, slot in enumerate(slots):
        judged = peaks[last[slot]]
        for d, got in enumerate(peaks[c]):
            if peak_tuples(got) != peak_tuples(judged[d]):
                bad += 1
                failed.add((c, d))
    return bad, failed


def named(numbers, range_name):
    """A search range's numbers under their names: ``<number>.<range>``
    for a named range, the bare names for the one range of a
    configuration without ranges."""
    if range_name is None:
        return dict(numbers)
    return {f"{k}.{range_name}": v for k, v in numbers.items()}


def numbers_line(numbers, limits):
    """{name: {"value", "limit"}} of the compared numbers, and whether
    each is within its limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits[name]
        out[name] = {"value": value, "limit": lim}
        ok = ok and value <= lim
    return out, ok
