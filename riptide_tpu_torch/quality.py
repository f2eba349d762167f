"""
Data-quality (DQ) layer: the degraded-input defence of the search path.

Real dedispersed time series arrive damaged — NaN/Inf samples from
upstream RFI excision, clipped/saturated runs, zero-variance dead spans
where a receiver dropped out, DC-dominated blocks. A single NaN silently
poisons an entire periodogram, so the search path routes through this
module:

* :func:`scan_samples` produces a boolean bad-sample mask plus a
  :class:`QualityReport` (per-defect counts, masked fraction);
* :func:`fill_masked` replaces bad samples with the local running-median
  estimate so detrending sees plausible values;
* mask-aware normalisation (:func:`masked_moments`, used by
  ``TimeSeries.normalise``) excludes masked samples from the mean/std
  and applies the effective-nsamp S/N correction ``nsamp / n_good``;
* series whose masked fraction exceeds ``max_masked_frac`` are
  **quarantined** — reported and excluded from the search;
* ``strict | salvage | skip`` ingest policies decide whether a
  truncated/malformed file raises (:class:`MalformedFile`), salvages
  the readable prefix, or is skipped with a structured
  :class:`DegradedInputWarning` (:func:`report_malformed`,
  :func:`read_raw_samples`).

These are the parts of the JAX package's ``quality`` module that
:func:`prepare_time_series` and the file loaders reach, with the same
semantics. The scan and the quarantine record into the survey metrics
registry (:mod:`riptide_tpu_torch.survey.metrics`; a quarantine also
emits an incident record) unless ``record=False``; the ingest tripwire
and the salvaged and skipped files are counted there too.
"""
import logging
import os
import warnings

import numpy as np

from .survey.metrics import get_metrics

log = logging.getLogger("riptide_tpu_torch.quality")

__all__ = [
    "DQConfig",
    "QualityReport",
    "QuarantinedSeries",
    "MalformedFile",
    "DegradedInputWarning",
    "INGEST_POLICIES",
    "scan_samples",
    "fill_masked",
    "masked_moments",
    "quarantine_check",
    "prepare_time_series",
    "check_finite_array",
    "ingest_scan",
    "read_raw_samples",
    "report_malformed",
]

INGEST_POLICIES = ("strict", "salvage", "skip")

class DegradedInputWarning(UserWarning):
    """Structured warning about a degraded input: carries the offending
    ``fname`` and machine-readable ``reason``."""

    def __init__(self, fname, reason):
        self.fname = fname
        self.reason = reason
        super().__init__(f"{fname}: {reason}")


class MalformedFile(ValueError):
    """A data file failed structural validation on ingest (empty,
    truncated mid-sample, or with an impossible header)."""


class QuarantinedSeries(RuntimeError):
    """A series' masked fraction exceeds ``max_masked_frac``: its noise
    statistics are meaningless, so it is excluded from the search.
    Carries the :class:`QualityReport` as ``report``."""

    def __init__(self, report):
        self.report = report
        super().__init__(
            f"series quarantined by the data-quality scan: {report.describe()}"
        )


class DQConfig:
    """Data-quality scan thresholds and ingest behaviour.

    Parameters
    ----------
    enabled : bool
        Master switch; disabled -> no scan, no masking.
    max_masked_frac : float
        Quarantine threshold on the masked sample fraction.
    clip_run_min : int
        A run of >= this many consecutive samples pinned at the global
        extreme value is treated as clipping/saturation.
    dead_run_min : int
        A run of >= this many consecutive identical samples (any value)
        is a dead span.
    dc_block : int
        Block length for the DC-domination check.
    dc_nstd : float or None
        Mask a block whose mean sits more than this many robust
        standard deviations from the global median; None disables.
    ingest_policy : str
        'strict' | 'salvage' | 'skip' handling of malformed files.
    """

    def __init__(self, enabled=True, max_masked_frac=0.5, clip_run_min=64,
                 dead_run_min=1024, dc_block=8192, dc_nstd=6.0,
                 ingest_policy="strict"):
        self.enabled = bool(enabled)
        self.max_masked_frac = float(max_masked_frac)
        self.clip_run_min = int(clip_run_min)
        self.dead_run_min = int(dead_run_min)
        self.dc_block = int(dc_block)
        self.dc_nstd = None if dc_nstd is None else float(dc_nstd)
        _check_policy(ingest_policy)
        self.ingest_policy = ingest_policy

    @classmethod
    def from_any(cls, obj):
        """Coerce None / dict / DQConfig to a DQConfig."""
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        return cls(**dict(obj))


class QualityReport:
    """Per-series data-quality scan result."""

    def __init__(self, nsamp, fname=None, dm=None):
        self.fname = os.path.basename(fname) if fname else None
        self.dm = dm
        self.nsamp = int(nsamp)
        self.n_nonfinite = 0
        self.n_clipped = 0
        self.n_dead = 0
        self.n_dc = 0
        self.n_masked = 0
        self.quarantined = False
        self.reasons = []

    @property
    def masked_frac(self):
        return self.n_masked / self.nsamp if self.nsamp else 1.0

    def describe(self):
        src = f"{self.fname}: " if self.fname else ""
        return (
            f"{src}{self.n_masked}/{self.nsamp} samples masked "
            f"({100.0 * self.masked_frac:.2f}%): {'; '.join(self.reasons) or 'clean'}"
        )

    def to_dict(self):
        """JSON-able form (the journal's per-file ``dq`` entries; the
        JAX package's keys)."""
        return {
            "fname": self.fname,
            "dm": self.dm,
            "nsamp": self.nsamp,
            "n_nonfinite": self.n_nonfinite,
            "n_clipped": self.n_clipped,
            "n_dead": self.n_dead,
            "n_dc": self.n_dc,
            "n_masked": self.n_masked,
            "masked_frac": round(self.masked_frac, 6),
            "quarantined": self.quarantined,
            "reasons": list(self.reasons),
        }

    @classmethod
    def from_dict(cls, d):
        """Inverse of :meth:`to_dict` (journal replay: a resumed survey
        restores per-file reports so provenance columns stay
        byte-identical to an uninterrupted run)."""
        rep = cls(d.get("nsamp", 0), fname=d.get("fname"), dm=d.get("dm"))
        for field in ("n_nonfinite", "n_clipped", "n_dead", "n_dc",
                      "n_masked"):
            setattr(rep, field, int(d.get(field, 0)))
        rep.quarantined = bool(d.get("quarantined", False))
        rep.reasons = list(d.get("reasons", []))
        return rep

    def __repr__(self):
        return f"QualityReport({self.describe()})"


# ----------------------------------------------------------------------------
# Scanning
# ----------------------------------------------------------------------------

def _constant_runs(data):
    """Run-length encoding of consecutive equal samples: (starts,
    lengths, values). NaN != NaN, so non-finite samples form length-1
    runs and never extend a constant span."""
    change = np.empty(data.size, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, data.size))
    return starts, lengths, data[starts]


def scan_samples(data, config=None, fname=None, dm=None, record=True):
    """
    Scan a series for degraded samples; returns ``(mask, report)`` where
    ``mask`` is a boolean bad-sample array (True = bad) and ``report``
    the :class:`QualityReport`. Detects, in order: non-finite samples,
    clipped/saturated runs pinned at the global extremes, zero-variance
    dead spans, and DC-dominated blocks. With ``record`` (default),
    ``dq_scanned_samples`` / ``dq_masked_samples`` go into the metrics
    registry; pass False when re-scanning data already counted.
    """
    cfg = DQConfig.from_any(config)
    data = np.asarray(data)
    report = QualityReport(data.size, fname=fname, dm=dm)
    mask = np.zeros(data.size, dtype=bool)
    if not cfg.enabled or data.size == 0:
        return mask, report

    finite = np.isfinite(data)
    n_bad = int(data.size - np.count_nonzero(finite))
    if n_bad:
        np.logical_not(finite, out=mask)
        report.n_nonfinite = n_bad
        report.reasons.append(f"{n_bad} non-finite samples")

    if n_bad < data.size:
        starts, lengths, values = _constant_runs(data)
        # Clipping: long runs pinned at the global finite extremes.
        vmax = data[finite].max()
        vmin = data[finite].min()
        if vmax != vmin:
            clip = (lengths >= cfg.clip_run_min) & (
                (values == vmax) | (values == vmin)
            )
            n = _mask_runs(mask, starts[clip], lengths[clip])
            if n:
                report.n_clipped = n
                report.reasons.append(f"{n} clipped/saturated samples")
        # Dead spans: long constant runs of any value.
        dead = lengths >= cfg.dead_run_min
        n = _mask_runs(mask, starts[dead], lengths[dead])
        if n:
            report.n_dead = n
            report.reasons.append(f"{n} zero-variance dead samples")
        # DC-dominated blocks: block mean far from the global median.
        if cfg.dc_nstd is not None and data.size >= 2 * cfg.dc_block:
            n = _mask_dc_blocks(data, finite, mask, cfg)
            if n:
                report.n_dc = n
                report.reasons.append(f"{n} samples in DC-dominated blocks")

    report.n_masked = int(np.count_nonzero(mask))
    if record:
        metrics = get_metrics()
        metrics.add("dq_scanned_samples", report.nsamp)
        if report.n_masked:
            metrics.add("dq_masked_samples", report.n_masked)
    if report.n_masked:
        log.warning("data-quality scan: %s", report.describe())
    return mask, report


def _mask_runs(mask, starts, lengths):
    """Mask the given runs; returns the count of newly-masked samples."""
    newly = 0
    for s, n in zip(starts, lengths):
        seg = mask[s : s + n]
        newly += int(n - np.count_nonzero(seg))
        seg[:] = True
    return newly


def _mask_dc_blocks(data, finite, mask, cfg):
    """Mask whole blocks whose mean is displaced from the global median
    by more than dc_nstd robust sigmas."""
    blk = cfg.dc_block
    nblk = data.size // blk
    q25, med, q75 = np.percentile(data[finite], (25.0, 50.0, 75.0))
    rstd = (q75 - q25) / 1.349
    if rstd <= 0:
        return 0
    body = np.nan_to_num(data[: nblk * blk].reshape(nblk, blk),
                         nan=med, posinf=med, neginf=med)
    bmeans = body.mean(axis=1, dtype=np.float64)
    hit = np.abs(bmeans - med) > cfg.dc_nstd * rstd
    newly = 0
    for b in np.flatnonzero(hit):
        seg = mask[b * blk : (b + 1) * blk]
        newly += int(blk - np.count_nonzero(seg))
        seg[:] = True
    return newly


# ----------------------------------------------------------------------------
# Repair + mask-aware normalisation
# ----------------------------------------------------------------------------

def fill_masked(data, mask, width_samples=None, minpts=101, device=None):
    """
    Replace masked samples with the local running-median estimate of the
    clean data (masked samples are first pinned to the global median so
    they cannot steer the estimate). Returns a new float32 array; good
    samples are byte-identical to the input. The running median runs on
    ``device`` (the card when None).
    """
    data = np.asarray(data, dtype=np.float32)
    if not mask.any():
        return data
    good = ~mask
    if not good.any():
        raise ValueError("cannot fill a fully-masked series (quarantine it)")
    base = np.float32(np.median(data[good]))
    filled = np.where(mask, base, data).astype(np.float32)
    n = data.size
    if width_samples is None:
        width_samples = min(8191, (n - 1) | 1)
    width_samples = int(width_samples) | 1  # running medians need odd widths
    if 3 <= width_samples < n:
        from .running_medians import fast_running_median

        minpts = min(int(minpts) | 1, width_samples)
        rmed = fast_running_median(filled, width_samples, minpts,
                                   device=device)
        return np.where(mask, rmed, data).astype(np.float32)
    return filled


def masked_moments(data, mask=None):
    """
    Float64 mean/variance over unmasked samples: ``(mean, var, n_good)``.
    With ``mask=None`` this is exactly ``data.mean()`` / ``data.var()``
    with float64 accumulators.
    """
    data = np.asarray(data)
    if mask is None or not mask.any():
        return data.mean(dtype=np.float64), data.var(dtype=np.float64), data.size
    good = data[~mask]
    if good.size == 0:
        raise ValueError("cannot take moments of a fully-masked series")
    return good.mean(dtype=np.float64), good.var(dtype=np.float64), good.size


def quarantine_check(report, max_masked_frac, record=True):
    """Mark the series as quarantined when its masked fraction exceeds
    the threshold — or when no unmasked samples remain at all; with
    ``record``, count it and emit a ``quarantine`` incident. Returns
    True when quarantined."""
    fully_masked = report.n_masked >= report.nsamp
    if report.masked_frac <= max_masked_frac and not fully_masked:
        return False
    report.quarantined = True
    if fully_masked:
        report.reasons.append("no unmasked samples to search")
    else:
        report.reasons.append(
            f"masked_frac {report.masked_frac:.3f} > max_masked_frac "
            f"{max_masked_frac:.3f}"
        )
    if record:
        get_metrics().add("series_quarantined")
        from .survey.incidents import emit as emit_incident

        emit_incident("quarantine", fname=report.fname,
                      masked_frac=round(report.masked_frac, 6),
                      reasons=list(report.reasons))
    warnings.warn(DegradedInputWarning(report.fname or "<series>",
                                       report.describe()))
    log.warning("quarantined: %s", report.describe())
    return True


def prepare_time_series(ts, rmed_width=None, rmed_minpts=101, dq=None,
                        normalise=True, device=None, record=True):
    """
    DQ-aware search preparation of one TimeSeries: scan -> quarantine
    check -> repair -> (optional, when ``rmed_width`` is set) deredden
    -> mask-aware normalise with the effective-nsamp S/N correction.
    Returns ``(prepared, report)``; ``prepared`` is None when the series
    was quarantined. The prepared series' metadata carries
    ``dq_masked_frac`` and ``dq_nsamp_eff``. Running medians run on
    ``device`` (the card when None). ``dq`` is a :class:`DQConfig`, a
    dict of its arguments or None; ``record`` as in
    :func:`scan_samples`.

    ``normalise=False`` serves externally-normalised input: the full
    normalisation is skipped, but masked samples are still zeroed and
    the ``nsamp / n_good`` correction still applied. A clean series with
    nothing to do (``rmed_width=None, normalise=False``) is returned as
    the SAME object (``ffa_search``'s identity contract).
    """
    from .time_series import TimeSeries

    original = ts
    cfg = DQConfig.from_any(dq)
    mask, report = scan_samples(
        ts.data, cfg, fname=ts.metadata.get("fname"),
        dm=ts.metadata.get("dm"), record=record,
    )
    if quarantine_check(report, cfg.max_masked_frac, record=record):
        return None, report
    if report.n_masked:
        width = None
        if rmed_width:
            width = int(round(rmed_width / ts.tsamp))
        data = fill_masked(ts.data, mask, width_samples=width,
                           minpts=int(rmed_minpts), device=device)
        ts = TimeSeries(data, ts.tsamp, metadata=ts.metadata)
    else:
        mask = None
    if rmed_width:
        ts = ts.deredden(rmed_width, minpts=rmed_minpts, device=device)
    if normalise:
        ts = ts.normalise(mask=mask)
    elif mask is not None:
        out = ts.data.copy()
        out[mask] = 0.0
        out *= report.nsamp / (report.nsamp - report.n_masked)
        ts = TimeSeries(out, ts.tsamp, metadata=ts.metadata)
    if ts is not original:
        # Provenance metadata goes on derived series only.
        ts.metadata["dq_masked_frac"] = round(report.masked_frac, 6)
        ts.metadata["dq_nsamp_eff"] = report.nsamp - report.n_masked
    return ts, report


# ----------------------------------------------------------------------------
# Finite guards
# ----------------------------------------------------------------------------

def check_finite_array(x, where="input"):
    """
    Raise ValueError if a concrete host float array contains non-finite
    samples. Tensors pass through untouched (device data is guarded at
    ingest; checking them here would synchronise). Returns ``x``.
    """
    if isinstance(x, np.ndarray) and x.dtype.kind == "f" \
            and not np.isfinite(x).all():
        raise ValueError(
            f"{where}: input contains non-finite samples; run the "
            "data-quality scan/repair first (riptide_tpu_torch.quality)"
        )
    return x


def ingest_scan(data, source=None):
    """
    Cheap ingest tripwire used by the TimeSeries constructors: count
    non-finite samples into the ``dq_ingest_nonfinite`` metric and emit
    one :class:`DegradedInputWarning`.
    Never raises and never modifies the data — full masking/repair
    happens in :func:`scan_samples` / :func:`prepare_time_series`.
    Returns ``data``.
    """
    arr = np.asarray(data)
    if arr.dtype.kind == "f" and arr.size:
        bad = int(arr.size - np.count_nonzero(np.isfinite(arr)))
        if bad:
            get_metrics().add("dq_ingest_nonfinite", bad)
            warnings.warn(DegradedInputWarning(
                source or "<array>",
                f"{bad}/{arr.size} non-finite samples at ingest",
            ))
    return data


# ----------------------------------------------------------------------------
# Ingest policies for malformed / truncated files
# ----------------------------------------------------------------------------

def _check_policy(policy):
    if policy not in INGEST_POLICIES:
        raise ValueError(
            f"ingest policy must be one of {INGEST_POLICIES}, got {policy!r}"
        )


def report_malformed(fname, reason, policy, salvageable=False):
    """
    Apply an ingest policy to a malformed-file condition:

    * ``strict``  -> raise :class:`MalformedFile`;
    * ``salvage`` -> if ``salvageable``, warn + count ``files_salvaged``
      and return True (caller proceeds with the readable prefix);
      otherwise degrade to skip;
    * ``skip``    -> warn + count ``files_skipped`` and return False
      (caller returns None for the file).
    """
    _check_policy(policy)
    if policy == "strict":
        raise MalformedFile(f"{fname}: {reason}")
    if policy == "salvage" and salvageable:
        get_metrics().add("files_salvaged")
        warnings.warn(DegradedInputWarning(fname, reason + " (salvaged)"))
        log.warning("salvaging %s: %s", fname, reason)
        return True
    get_metrics().add("files_skipped")
    warnings.warn(DegradedInputWarning(fname, reason + " (skipped)"))
    log.warning("skipping %s: %s", fname, reason)
    return False


def read_raw_samples(fname, dtype=np.float32, policy="strict", offset=0,
                     expect=None):
    """
    Read raw samples from ``fname`` under an ingest policy. Rejects
    empty payloads and byte counts not divisible by the dtype itemsize
    (``strict`` raises :class:`MalformedFile`; ``salvage`` keeps the
    readable prefix; ``skip`` returns None). ``expect`` is the sample
    count a header claims: fewer available samples means a truncated
    file and triggers the same policy handling. Returns the sample
    array, or None when the file was skipped.
    """
    _check_policy(policy)
    itemsize = np.dtype(dtype).itemsize
    size = os.path.getsize(fname) - offset
    if size <= 0:
        # No readable prefix exists, so 'salvage' degrades to skip
        # (report_malformed's salvageable=False path) and only 'strict'
        # raises.
        report_malformed(fname, "empty file (no samples)", policy,
                         salvageable=False)
        return None
    rem = size % itemsize
    n = size // itemsize
    problems = []
    if rem:
        problems.append(
            f"{size} data bytes is not a multiple of the "
            f"{np.dtype(dtype).name} itemsize ({itemsize}); "
            f"{rem} trailing bytes"
        )
    if expect is not None and n < expect:
        problems.append(
            f"file holds {n} samples but the header claims {int(expect)} "
            "(truncated)"
        )
    if problems:
        # One policy event per file, whatever the defect count.
        if not report_malformed(fname, "; ".join(problems), policy,
                                salvageable=n > 0):
            return None
    with open(fname, "rb") as fobj:
        fobj.seek(offset)
        data = np.fromfile(fobj, dtype=dtype, count=n)
    if data.size != n:
        raise MalformedFile(
            f"{fname}: short read ({data.size} of {n} samples)"
        )
    return data
