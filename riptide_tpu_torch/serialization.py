"""
JSON round-tripping of framework objects (TimeSeries, Periodogram,
Candidate, ...).

Any object with ``to_dict()``/``from_dict()`` serializes as a tagged dict
with ``__type__`` and ``__version__`` keys; numpy arrays are embedded as
base64, tables (:class:`~riptide_tpu_torch.table.Table`, and pandas
DataFrames where pandas is loaded) as values+columns under the
DataFrame tag, SkyCoord as ra/dec degrees. Same on-disk contract as the
reference (riptide/serialization.py), and the decoder additionally
accepts the reference's 'astropy.SkyCoord' tag so files written by
riptide load here. A DataFrame record decodes into a
:class:`~riptide_tpu_torch.table.Table`, so loading needs no pandas.
"""
import base64
import importlib
import json

import numpy as np

from .table import Table
from .utils.coords import SkyCoord

__all__ = ["JSONEncoder", "object_hook", "to_json", "from_json", "save_json", "load_json"]


def _framework_version():
    return getattr(importlib.import_module("riptide_tpu_torch"), "__version__")


def _get_class(clsname):
    # Serializable classes are all re-exported from the base package.
    return getattr(importlib.import_module("riptide_tpu_torch"), clsname)


class JSONEncoder(json.JSONEncoder):
    """Encoder handling numpy, pandas, SkyCoord and to_dict()-able types."""

    def default(self, obj):
        if isinstance(obj, np.ndarray):
            b64_str = base64.b64encode(np.ascontiguousarray(obj).data).decode()
            return {
                "__type__": "numpy.ndarray",
                "data": b64_str,
                "dtype": str(obj.dtype),
                "shape": obj.shape,
            }
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, Table):
            return {
                "__type__": "pandas.DataFrame",
                "values": self.default(obj.values),
                "columns": obj.columns,
            }
        # pandas is optional: only consult it if it is already loaded
        # (a DataFrame cannot exist otherwise).
        import sys

        pandas = sys.modules.get("pandas")
        if pandas is not None and isinstance(obj, pandas.DataFrame):
            return {
                "__type__": "pandas.DataFrame",
                "values": self.default(obj.values),
                "columns": list(obj.columns),
            }
        if isinstance(obj, SkyCoord):
            return {
                "__type__": "SkyCoord",
                "rajd": obj.ra_deg,
                "decjd": obj.dec_deg,
                "frame": "icrs",
            }
        # Anything exposing to_dict() is a framework serializable object
        if hasattr(obj, "to_dict"):
            items = obj.to_dict()
            items["__type__"] = type(obj).__name__
            if getattr(obj, "version", None):
                items["__version__"] = obj.version
            else:
                items["__version__"] = _framework_version()
            return items
        return super().default(obj)


def object_hook(items):
    if "__type__" not in items:
        return items
    typename = items["__type__"]
    if typename == "numpy.ndarray":
        data = base64.b64decode(items["data"].encode())
        return np.frombuffer(data, items["dtype"]).reshape(items["shape"]).copy()
    if typename == "pandas.DataFrame":
        # Decoding happens deepest-first: 'values' is already an ndarray.
        return Table.from_values(items["values"], items["columns"])
    if typename in ("SkyCoord", "astropy.SkyCoord"):
        return SkyCoord(items["rajd"], items["decjd"])
    cls = _get_class(typename)
    obj = cls.from_dict(items)
    obj.version = items.get("__version__", _framework_version())
    return obj


def to_json(obj, **kwargs):
    """Serialize an object to a JSON string."""
    kwargs.setdefault("cls", JSONEncoder)
    return json.dumps(obj, **kwargs)


def from_json(s):
    """De-serialize a JSON string produced by :func:`to_json`."""
    return json.loads(s, object_hook=object_hook)


def save_json(fname, obj, **kwargs):
    """Save an object to a JSON file."""
    with open(fname, "w") as fobj:
        fobj.write(to_json(obj, **kwargs))


def load_json(fname):
    """Load an object from a JSON file."""
    with open(fname, "r") as fobj:
        return from_json(fobj.read())
