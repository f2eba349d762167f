"""
PRESTO .inf / .dat reading.

The .inf format is a fixed-column text file: every standard line has an
'=' at column 40 and the value after it (reference semantics:
riptide/reading/presto.py). The companion .dat file is raw float32.
"""
import os

import numpy as np

from ..utils.coords import SkyCoord

__all__ = ["PrestoInf"]

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
