"""
TimeSeries: the core input container for FFA searches.
Reference contract: riptide/time_series.py. Data lives on the host as
float32 numpy; device transfer happens inside the search/detrending ops.
The file loaders read PRESTO .inf/.dat pairs, SIGPROC time series (the
native reader when it built), headerless binary and .npy files under the
ingest policies of :mod:`riptide_tpu_torch.quality`.
"""
import copy
import os
import warnings

import numpy as np

from . import quality
from .folding import fold
from .libffa import downsample, generate_signal
from .metadata import Metadata
from .running_medians import fast_running_median
from .timing import timing


class TimeSeries:
    """
    Container for dedispersed time series data to be searched with the
    FFA. **Use classmethods to create new TimeSeries objects.**

    Parameters
    ----------
    data : array_like
        Time series samples (stored as float32).
    tsamp : float
        Sampling time in seconds.
    metadata : Metadata or dict, optional
    copy : bool, optional
        Copy the data instead of referencing it.
    """

    def __init__(self, data, tsamp, metadata=None, copy=False):
        if copy:
            self._data = np.asarray(data, dtype=np.float32).copy()
        else:
            self._data = np.asarray(data, dtype=np.float32)
        self._tsamp = float(tsamp)
        self.metadata = Metadata(metadata) if metadata is not None else Metadata({})
        # tobs is kept for downstream stages (peak detection thresholds)
        self.metadata["tobs"] = self.length

    @property
    def data(self):
        """float32 numpy array of samples."""
        return self._data

    @property
    def tsamp(self):
        """Sampling time in seconds."""
        return self._tsamp

    @property
    def nsamp(self):
        """Number of samples."""
        return self._data.size

    @property
    def length(self):
        """Data length in seconds."""
        return self.nsamp * self.tsamp

    @property
    def tobs(self):
        """Alias of :attr:`length`."""
        return self.length

    def copy(self):
        return copy.deepcopy(self)

    def normalise(self, inplace=False, mask=None):
        """
        Normalise to zero mean and unit variance, with float64 accumulators
        to avoid saturation on large-valued data
        (riptide/time_series.py:66-90).

        With a boolean bad-sample ``mask`` (see
        :func:`riptide_tpu_torch.quality.scan_samples`), the mean/std are
        computed over unmasked samples only, masked samples are zeroed,
        and the result is scaled by the effective-nsamp S/N correction
        ``nsamp / n_good``.
        """
        m, v, n_good = quality.masked_moments(self.data, mask)
        norm = v**0.5
        out = (self.data - m) / norm
        if mask is not None and n_good < self.nsamp:
            out[mask] = 0.0
            out *= self.nsamp / n_good
        if inplace:
            self._data = out.astype(np.float32)
        else:
            return TimeSeries(out, self.tsamp, metadata=self.metadata)

    @timing
    def deredden(self, width, minpts=101, inplace=False, device=None):
        """
        Subtract an approximate running median of window ``width`` seconds
        (computed on a scrunched copy, then upsampled — see
        :func:`riptide_tpu_torch.running_medians.fast_running_median`),
        on ``device`` (the card when None).
        """
        width_samples = int(round(width / self.tsamp))
        rmed = fast_running_median(self.data, width_samples, minpts,
                                   device=device).astype(np.float32)
        if inplace:
            self._data = self._data - rmed
        else:
            return TimeSeries(self.data - rmed, self.tsamp, metadata=self.metadata)

    def downsample(self, factor, inplace=False):
        """Downsample by a real-valued factor > 1."""
        if inplace:
            self._data = downsample(self.data, factor)
            self._tsamp *= factor
        else:
            return TimeSeries(
                downsample(self.data, factor), factor * self.tsamp, metadata=self.metadata
            )

    def fold(self, period, bins, subints=None):
        """Fold at ``period`` seconds into ``bins`` phase bins; see
        :func:`riptide_tpu_torch.folding.fold`."""
        return fold(self, period, bins, subints=subints)

    @classmethod
    def generate(cls, length, tsamp, period, phi0=0.5, ducy=0.02, amplitude=10.0, stdnoise=1.0):
        """
        Generate a noisy time series containing a periodic von Mises pulse
        train (fake pulsar). The expected matched-filter S/N is
        amplitude / stdnoise; see :func:`riptide_tpu_torch.libffa.generate_signal`.
        """
        nsamp = int(round(length / tsamp))
        data = quality.ingest_scan(
            generate_signal(
                nsamp,
                period / tsamp,
                phi0=phi0,
                ducy=ducy,
                amplitude=amplitude,
                stdnoise=stdnoise,
            ),
            source="TimeSeries.generate",
        )
        metadata = Metadata(
            {
                "source_name": "fake",
                "signal_shape": "Von Mises",
                "signal_period": period,
                "signal_initial_phase": phi0,
                "signal_duty_cycle": ducy,
            }
        )
        return cls(data, tsamp, copy=False, metadata=metadata)

    @classmethod
    def from_numpy_array(cls, array, tsamp, copy=False):
        """From a plain array of samples."""
        quality.ingest_scan(array, source="TimeSeries.from_numpy_array")
        return cls(array, tsamp, copy=copy)

    @classmethod
    def from_binary(cls, fname, tsamp, dtype=np.float32, policy="strict"):
        """
        From a headerless binary file of raw samples. Empty files and
        byte sizes not divisible by the dtype itemsize are rejected with
        a clear ValueError under the default ``policy='strict'``;
        ``'salvage'`` keeps the readable whole-sample prefix and
        ``'skip'`` returns None with a structured warning
        (:mod:`riptide_tpu_torch.quality`).
        """
        data = quality.read_raw_samples(fname, dtype=dtype, policy=policy)
        if data is None:
            return None
        quality.ingest_scan(data, source=fname)
        return cls(data, tsamp, metadata=Metadata({"fname": fname}))

    @classmethod
    def from_npy_file(cls, fname, tsamp, policy="strict"):
        """From a .npy array file. A truncated/malformed file raises
        under ``policy='strict'`` and is skipped (returning None, with a
        structured warning) under ``'salvage'`` or ``'skip'`` — a broken
        .npy holds no readable prefix to salvage."""
        try:
            data = np.load(fname)
        except Exception as err:
            quality.report_malformed(
                fname, f"not a readable .npy file ({err})", policy,
                salvageable=False,
            )
            return None
        quality.ingest_scan(data, source=fname)
        return cls(data, tsamp, metadata=Metadata({"fname": fname}))

    @classmethod
    @timing
    def from_presto_inf(cls, fname, policy="strict"):
        """
        From a PRESTO .inf header (loads the companion .dat file). Warns
        on X-ray/Gamma data, whose white-noise statistics assumption does
        not hold (riptide/time_series.py:283-316). ``policy`` governs
        truncated/malformed companion files: ``strict`` raises,
        ``salvage`` keeps the readable prefix, ``skip`` returns None
        (:mod:`riptide_tpu_torch.quality`).
        """
        from .reading import PrestoInf

        try:
            inf = PrestoInf(fname)
        except (ValueError, OSError) as err:
            quality.report_malformed(fname, f"unreadable .inf header ({err})",
                                     policy, salvageable=False)
            return None
        metadata = Metadata.from_presto_inf(inf)
        if metadata.get("em_band", None) in ("X-ray", "Gamma"):
            warnings.warn(
                "Loading X-ray or Gamma-ray data: the FFA search assumes "
                "Gaussian white noise, which photon-counting data generally "
                "violate. Interpret S/N values with caution."
            )
        data = inf.load_data(policy=policy)
        if data is None:
            return None
        quality.ingest_scan(data, source=inf.data_fname)
        return cls(data, metadata["tsamp"], metadata=metadata)

    @classmethod
    @timing
    def from_sigproc(cls, fname, extra_keys=None, policy="strict"):
        """
        From a SIGPROC dedispersed time series (32-bit float, or 8-bit
        with the 'signed' header key; riptide/time_series.py:318-362).
        ``policy`` governs corrupt headers and truncated payloads:
        ``strict`` raises, ``salvage`` keeps the whole-sample prefix,
        ``skip`` returns None (:mod:`riptide_tpu_torch.quality`).
        """
        from .reading import SigprocHeader

        from . import native

        try:
            sh = SigprocHeader(fname, extra_keys=extra_keys or {})
        except (ValueError, KeyError, OSError) as err:
            quality.report_malformed(fname, f"corrupt SIGPROC header ({err})",
                                     policy, salvageable=False)
            return None
        metadata = Metadata.from_sigproc(sh)
        nbits = sh["nbits"]
        payload = os.path.getsize(fname) - sh.bytesize
        if payload <= 0:
            # Nothing to salvage: 'salvage' degrades to skip, 'strict'
            # raises (inside report_malformed).
            quality.report_malformed(fname, "no data payload", policy,
                                     salvageable=False)
            return None
        rem = payload % sh.bytes_per_sample
        if rem:
            reason = (
                f"{payload} payload bytes is not a multiple of the "
                f"{sh.bytes_per_sample}-byte sample size ({rem} trailing "
                "bytes)"
            )
            if not quality.report_malformed(fname, reason, policy,
                                            salvageable=sh.nsamp > 0):
                return None
        nsamp = sh.nsamp
        if nbits == 32 and native.available():
            data = native.read_f32(fname, sh.bytesize, nsamp)
        else:
            with open(fname, "rb") as fobj:
                fobj.seek(sh.bytesize)
                if nbits == 32:
                    data = np.fromfile(fobj, dtype=np.float32, count=nsamp)
                elif native.available():
                    data = native.decode8(fobj.read(), signed=sh["signed"])
                elif sh["signed"]:
                    data = np.fromfile(fobj, dtype=np.int8).astype(np.float32)
                else:
                    data = np.fromfile(fobj, dtype=np.uint8).astype(np.float32)
        quality.ingest_scan(data, source=fname)
        return cls(data, metadata["tsamp"], metadata=metadata)

    def to_dict(self):
        return {"data": self.data, "tsamp": self.tsamp, "metadata": self.metadata}

    @classmethod
    def from_dict(cls, items):
        return cls(items["data"], items["tsamp"], metadata=items["metadata"])
