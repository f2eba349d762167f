"""
Observation metadata carried by every data product.

A dict subclass with a small set of validated reserved keys
(source_name, skycoord, dm, mjd, tobs, fname); any other key must be a
string mapping to a JSON-serializable value. Missing reserved keys
default to None. Mirrors the contract of the reference's Metadata
(riptide/metadata.py:11-51) with an internal validator and the internal
SkyCoord, built from PRESTO and SIGPROC headers by the readers of
:mod:`riptide_tpu_torch.reading`.
"""
import json
import os
import pprint

from .utils.coords import SkyCoord

__all__ = ["Metadata", "MetadataError"]


class MetadataError(ValueError):
    pass


_RESERVED = ("source_name", "skycoord", "dm", "mjd", "tobs", "fname")


def _validate(items):
    for key, val in items.items():
        if not isinstance(key, str):
            raise MetadataError(f"Metadata keys must be str, got {key!r}")
        if val is None:
            continue
        if key == "source_name" or key == "fname":
            if not isinstance(val, str):
                raise MetadataError(f"{key} must be a str or None")
        elif key == "skycoord":
            if not isinstance(val, SkyCoord):
                raise MetadataError("skycoord must be a SkyCoord or None")
        elif key == "dm" or key == "mjd":
            if not (isinstance(val, float) and val >= 0):
                raise MetadataError(f"{key} must be a non-negative float or None")
        elif key == "tobs":
            if not (isinstance(val, float) and val > 0):
                raise MetadataError("tobs must be a strictly positive float or None")
        else:
            try:
                json.dumps(val)
            except TypeError as err:
                raise MetadataError(
                    f"Metadata value for key {key!r} is not JSON-serializable"
                ) from err


class Metadata(dict):
    """
    Carries information about an observation across all data products
    (TimeSeries, Periodogram). Reserved keys, when present, must satisfy:

    - source_name: str
    - skycoord: riptide_tpu_torch.utils.coords.SkyCoord
    - dm: non-negative float
    - mjd: non-negative float
    - tobs: strictly positive float
    - fname: str

    Missing reserved keys are set to None. Any extra key must be a str
    with a JSON-serializable value.
    """

    def __init__(self, items=None):
        items = dict(items) if items else {}
        _validate(items)
        super().__init__(items)
        for key in _RESERVED:
            self.setdefault(key, None)

    def to_dict(self):
        return dict(self)

    @classmethod
    def from_dict(cls, items):
        return cls(items)

    @classmethod
    def from_presto_inf(cls, inf):
        """From a PrestoInf object or a path to a PRESTO .inf file."""
        from .reading import PrestoInf

        if isinstance(inf, str):
            inf = PrestoInf(inf)
        attrs = dict(inf)
        attrs["skycoord"] = inf.skycoord
        attrs["fname"] = os.path.realpath(inf.fname)
        attrs["tobs"] = attrs["tsamp"] * attrs["nsamp"]
        if "dm" in attrs and attrs["dm"] is not None:
            attrs["dm"] = float(attrs["dm"])
        return cls(attrs)

    @classmethod
    def from_sigproc(cls, sh, extra_keys=None):
        """
        From a SigprocHeader object or file path. Rejects multi-channel
        data and unsupported bit depths; 8-bit data requires the 'signed'
        header key (riptide/metadata.py:73-106).
        """
        from .reading import SigprocHeader

        if isinstance(sh, str):
            sh = SigprocHeader(sh, extra_keys=extra_keys or {})
        if sh["nchans"] > 1:
            raise MetadataError(
                f"File {sh.fname!r} contains multi-channel data (nchans = {sh['nchans']}), "
                "instead of a dedispersed time series"
            )
        nbits = sh["nbits"]
        if nbits not in (8, 32):
            raise MetadataError(
                f"Only 8-bit and 32-bit SIGPROC data are supported. "
                f"File {sh.fname!r} contains {nbits}-bit data"
            )
        if nbits == 8 and "signed" not in sh:
            raise MetadataError(
                "SIGPROC Header says this is 8-bit data, but does not specify "
                "its signedness via the 'signed' key"
            )
        attrs = dict(sh)
        attrs["dm"] = attrs.get("refdm", None)
        attrs["skycoord"] = sh.skycoord
        attrs["source_name"] = attrs.get("source_name", None)
        attrs["mjd"] = attrs.get("tstart", None)
        attrs["fname"] = os.path.realpath(sh.fname)
        attrs["tobs"] = sh.tobs
        return cls(attrs)

    def __str__(self):
        return "Metadata %s" % pprint.pformat(dict(self))

    __repr__ = __str__
