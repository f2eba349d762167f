"""
PRESTO .inf / .dat reading, and a writer of the same format
(:func:`write_presto`) for the package's own synthetic trials.

The .inf format is a fixed-column text file: every standard line has an
'=' at column 40 and the value after it (reference semantics:
riptide/reading/presto.py). The companion .dat file is raw float32.
"""
import os

import numpy as np

from ..utils.coords import SkyCoord

__all__ = ["PrestoInf", "write_presto"]

_SEP_COLUMN = 40
_FAKE_TELESCOPE = "None (Artificial Data Set)"


def _value(line, vtype):
    if not (len(line) > _SEP_COLUMN and line[_SEP_COLUMN] == "="):
        raise ValueError(f"Expected '=' character at column {_SEP_COLUMN}")
    return vtype(line[_SEP_COLUMN + 1 :].strip())


def _bool(s):
    return int(s) != 0


def _int_pair(s):
    a, b = s.split(",")
    return int(a), int(b)


def parse_inf(text):
    """Parse .inf text to a dict; raises ValueError on makedata files,
    unknown EM bands and truncated headers
    (riptide/reading/presto.py:57-121)."""
    lines = text.strip("\n").splitlines()
    if len(lines) < 13:
        raise ValueError(
            f"truncated .inf header: {len(lines)} lines (at least 13 expected)"
        )

    basename = _value(lines[0], str)
    telescope = _value(lines[1], str)
    if telescope == _FAKE_TELESCOPE:
        raise ValueError("Reading data generated with PRESTO's makedata is not supported")

    items = {
        "basename": basename,
        "telescope": telescope,
        "instrument": _value(lines[2], str),
        "source_name": _value(lines[3], str),
        "raj": _value(lines[4], str),
        "decj": _value(lines[5], str),
        "observer": _value(lines[6], str),
        "mjd": _value(lines[7], float),
        "barycentered": _value(lines[8], _bool),
        "nsamp": _value(lines[9], int),
        "tsamp": _value(lines[10], float),
        "breaks": _value(lines[11], _bool),
        "onoff_pairs": [],
    }
    lines = lines[12:]

    if items["breaks"]:
        for line in lines:
            try:
                items["onoff_pairs"].append(_value(line, _int_pair))
            except Exception:
                break
    lines = lines[len(items["onoff_pairs"]) :]

    if not lines:
        raise ValueError("truncated .inf header: EM-band block missing")
    em_band = _value(lines[0], str)
    items["em_band"] = em_band
    try:
        if em_band == "Radio":
            items["fov_arcsec"] = _value(lines[1], float)
            items["dm"] = _value(lines[2], float)
            items["fbot"] = _value(lines[3], float)
            items["bandwidth"] = _value(lines[4], float)
            items["nchan"] = _value(lines[5], int)
            items["cbw"] = _value(lines[6], float)
            items["analyst"] = _value(lines[7], str)
        elif em_band in ("X-ray", "Gamma"):
            items["fov_arcsec"] = _value(lines[1], float)
            items["central_energy_kev"] = _value(lines[2], float)
            items["energy_bandpass_kev"] = _value(lines[3], float)
            items["analyst"] = _value(lines[4], str)
        else:
            raise ValueError(f"EM Band {em_band!r} not supported")
    except IndexError:
        raise ValueError(
            f"truncated .inf header: incomplete {em_band!r} EM-band block"
        ) from None
    return items


class PrestoInf(dict):
    """Parsed PRESTO .inf header of a dedispersed time series."""

    def __init__(self, fname):
        self._fname = os.path.realpath(fname)
        with open(fname, "r") as fobj:
            super().__init__(parse_inf(fobj.read()))

    @property
    def fname(self):
        return self._fname

    @property
    def data_fname(self):
        """Path of the companion raw-float32 .dat file."""
        return self.fname.rsplit(".", maxsplit=1)[0] + ".dat"

    @property
    def skycoord(self):
        return SkyCoord.from_radec_str(self["raj"], self["decj"])

    def load_data(self, policy="strict"):
        """Time series samples as a float32 numpy array. The companion
        .dat is validated against the header's sample count: a
        truncated/odd-sized file raises under ``policy='strict'``, keeps
        the whole-sample prefix under ``'salvage'``, or returns None
        under ``'skip'`` (:mod:`riptide_tpu_torch.quality`)."""
        from ..quality import read_raw_samples

        return read_raw_samples(
            self.data_fname, dtype=np.float32, policy=policy,
            expect=self.get("nsamp"),
        )


def write_presto(path, data, tsamp, dm=0.0, observer="riptide_tpu_torch"):
    """Write a float32 series as a PRESTO .inf/.dat pair (``path`` +
    ".inf"/".dat"): PRESTO's radio header lines with their '=' at column
    40, ``tsamp`` and ``dm`` written exactly (repr), ``observer`` as the
    observer and analyst. Returns the .inf path."""
    data = np.asarray(data, np.float32)
    lines = (
        ("Data file name without suffix", os.path.basename(path)),
        ("Telescope used", "Parkes"), ("Instrument used", "Multibeam"),
        ("Object being observed", "Pulsar"),
        ("J2000 Right Ascension (hh:mm:ss.ssss)", "00:00:01.0000"),
        ("J2000 Declination     (dd:mm:ss.ssss)", "-00:00:01.0000"),
        ("Data observed by", observer),
        ("Epoch of observation (MJD)", "59000.000000"),
        ("Barycentered?           (1=yes, 0=no)", "1"),
        ("Number of bins in the time series", str(data.size)),
        ("Width of each time series bin (sec)", repr(float(tsamp))),
        ("Any breaks in the data? (1=yes, 0=no)", "0"),
        ("Type of observation (EM band)", "Radio"),
        ("Beam diameter (arcsec)", "981"),
        ("Dispersion measure (cm-3 pc)", repr(float(dm))),
        ("Central freq of low channel (Mhz)", "1182.1953125"),
        ("Total bandwidth (Mhz)", "400"), ("Number of channels", "1024"),
        ("Channel bandwidth (Mhz)", "0.390625"),
        ("Data analyzed by", observer))
    with open(path + ".inf", "w") as fobj:
        fobj.write("".join(f" {k}".ljust(_SEP_COLUMN) + f"=  {v}\n"
                           for k, v in lines))
    data.tofile(path + ".dat")
    return path + ".inf"
