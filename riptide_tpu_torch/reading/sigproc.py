"""
SIGPROC dedispersed time series reading.

Binary header of length-prefixed keys between HEADER_START/HEADER_END;
int keys are 32-bit, float keys are C doubles, bool keys are unsigned
chars, strings are length-prefixed (reference semantics:
riptide/reading/sigproc.py).
"""
import os
import struct

from ..utils.coords import SkyCoord, parse_sigproc_float_coord

__all__ = ["SigprocHeader", "read_sigproc_header", "parse_float_coord"]

SIGPROC_KEYS = {
    "filename": str,
    "telescope_id": int,
    "telescope": str,
    "machine_id": int,
    "data_type": int,
    "rawdatafile": str,
    "source_name": str,
    "barycentric": int,
    "pulsarcentric": int,
    "az_start": float,
    "za_start": float,
    "src_raj": float,
    "src_dej": float,
    "tstart": float,
    "tsamp": float,
    "nbits": int,
    "nsamples": int,
    "fch1": float,
    "foff": float,
    "fchannel": float,
    "nchans": int,
    "nifs": int,
    "refdm": float,
    "flux": float,
    "period": float,
    "nbeams": int,
    "ibeam": int,
    "hdrlen": int,
    "pb": float,
    "ecc": float,
    "asini": float,
    "orig_hdrlen": int,
    "new_hdrlen": int,
    "sampsize": int,
    "bandwidth": float,
    "fbottom": float,
    "ftop": float,
    "obs_date": str,
    "obs_time": str,
    "accel": float,
    "signed": bool,
}

HEADER_START = "HEADER_START"
HEADER_END = "HEADER_END"

parse_float_coord = parse_sigproc_float_coord


# Upper bound on a length-prefixed header string. Legitimate SIGPROC
# keys and values are tens of characters; a corrupt length prefix would
# otherwise drive a huge read (and, downstream, a multi-GB data
# allocation from garbage header ints).
MAX_HEADER_STR = 1024


def _read_exact(fobj, n):
    raw = fobj.read(n)
    if len(raw) != n:
        raise ValueError(
            f"truncated SIGPROC header: wanted {n} bytes, got {len(raw)}"
        )
    return raw


def _read_str(fobj):
    (size,) = struct.unpack("i", _read_exact(fobj, 4))
    if not 0 < size <= MAX_HEADER_STR:
        raise ValueError(
            f"SIGPROC header string length {size} outside (0, "
            f"{MAX_HEADER_STR}]: corrupt header"
        )
    try:
        return _read_exact(fobj, size).decode()
    except UnicodeDecodeError:
        raise ValueError(
            "SIGPROC header string is not valid text: corrupt header"
        ) from None


def read_sigproc_header(fobj, extra_keys=None):
    """
    Read a SIGPROC header from an open binary file. Unknown keys raise
    KeyError unless their type is supplied via ``extra_keys``
    (riptide/reading/sigproc.py:86-89). Returns (attrs dict, header size
    in bytes).
    """
    keydb = dict(SIGPROC_KEYS)
    if extra_keys:
        keydb.update(extra_keys)

    fobj.seek(0)
    flag = _read_str(fobj)
    if flag != HEADER_START:
        raise ValueError(
            f"File starts with {flag!r} flag instead of the expected {HEADER_START!r}"
        )

    attrs = {}
    while True:
        key = _read_str(fobj)
        if key == HEADER_END:
            break
        atype = keydb.get(key)
        if atype is None:
            raise KeyError(
                f"Type of SIGPROC header attribute {key!r} is unknown, please specify it"
            )
        if atype == str:
            attrs[key] = _read_str(fobj)
        elif atype == int:
            (attrs[key],) = struct.unpack("i", _read_exact(fobj, 4))
        elif atype == float:
            (attrs[key],) = struct.unpack("d", _read_exact(fobj, 8))
        elif atype == bool:
            (v,) = struct.unpack("B", _read_exact(fobj, 1))
            attrs[key] = bool(v)
        else:
            raise ValueError(f"Key {key!r} has unsupported type {atype!r}")
    _validate_header_sanity(attrs)
    return attrs, fobj.tell()


def _validate_header_sanity(attrs):
    """Fail fast on physically-impossible header values so a corrupt
    header raises here instead of driving a multi-GB allocation (or a
    division by zero) downstream."""
    nbits = attrs.get("nbits")
    if nbits is not None and (nbits <= 0 or nbits % 8):
        raise ValueError(f"corrupt SIGPROC header: nbits = {nbits}")
    tsamp = attrs.get("tsamp")
    if tsamp is not None and not tsamp > 0:
        raise ValueError(f"corrupt SIGPROC header: tsamp = {tsamp}")
    for key in ("nchans", "nifs"):
        val = attrs.get(key)
        if val is not None and val <= 0:
            raise ValueError(f"corrupt SIGPROC header: {key} = {val}")
    nsamples = attrs.get("nsamples")
    if nsamples is not None and nsamples < 0:
        raise ValueError(f"corrupt SIGPROC header: nsamples = {nsamples}")


class SigprocHeader(dict):
    """Parsed SIGPROC header with file-derived size properties."""

    def __init__(self, fname, extra_keys=None):
        self._fname = os.path.abspath(fname)
        with open(self._fname, "rb") as fobj:
            attrs, self._bytesize = read_sigproc_header(fobj, extra_keys)
        super().__init__(attrs)

    @property
    def fname(self):
        return self._fname

    @property
    def bytesize(self):
        """Header size in bytes (data starts at this offset)."""
        return self._bytesize

    @property
    def bytes_per_sample(self):
        return self["nchans"] * self["nbits"] // 8

    @property
    def nsamp(self):
        """Sample count inferred from the file size."""
        return (os.path.getsize(self.fname) - self.bytesize) // self.bytes_per_sample

    @property
    def tobs(self):
        return self.nsamp * self["tsamp"]

    @property
    def skycoord(self):
        return SkyCoord.from_sigproc(self["src_raj"], self["src_dej"])
