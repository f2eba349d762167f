"""
The ``RIPTIDE_*`` environment flags the port reads, with the JAX
package's names, types and defaults (``riptide_tpu/utils/envflags.py``).

Each flag is read through :func:`get` at call time, so a changed
environment (a test's monkeypatch, a smoke run's three layouts) takes
effect at the next search. Unset or empty means the default.
"""
import os
from typing import NamedTuple

__all__ = ["EnvFlag", "FLAGS", "get"]

# Raw values read as False for "bool" flags; anything else non-empty is
# True.
_FALSE_WORDS = ("0", "false", "off", "no")


class EnvFlag(NamedTuple):
    """One flag: ``type`` is ``bool``, ``int`` or ``choice`` (one of
    ``choices``)."""
    name: str
    type: str
    default: object
    help: str
    choices: tuple = ()


_ALL = [
    EnvFlag(
        "RIPTIDE_WIRE_DTYPE", "choice", None,
        "Host->device wire transport of the downsampled stage data. "
        "Default (unset): `uint6`. The port takes no short aliases.",
        choices=("float32", "float16", "uint12", "uint8", "uint6"),
    ),
    EnvFlag(
        "RIPTIDE_PREP_THREADS", "int", 0,
        "Worker threads of the native wire-prep runtime (downsample + "
        "quantise). `0` (default) uses every core (capped at 32); a "
        "positive value pins the count, e.g. `1` for single-core "
        "baselines. The native job pool writes disjoint output regions "
        "per (stage, trial) job, so the wire bytes are identical at any "
        "thread count.",
    ),
    EnvFlag(
        "RIPTIDE_KERNEL_BASE3", "bool", True,
        "Allow base-3 (1.5 * 2^k) container heights where a lane bucket "
        "fits; `0` forces pure 2^L containers.",
    ),
    EnvFlag(
        "RIPTIDE_KERNEL_ROW_PACK", "bool", True,
        "Row-packed containers: the odd-slot heights (5/7 * 2^(L-3)) "
        "join the family, and a later stage's same-p lane bucket rides "
        "an earlier stage's dead container rows (K3) where the pairing "
        "map finds a fit. Per-trial results are bit-identical either "
        "way.",
    ),
    EnvFlag(
        "RIPTIDE_KERNEL_LANE_SPLIT", "bool", True,
        "Split each stage's bins trials into lane buckets by "
        "ceil(p / 128), one K1 launch each; `0` keeps one bucket per "
        "stage. Results are bit-identical either way.",
    ),
    EnvFlag(
        "RIPTIDE_DEVICE_CLUSTER", "bool", True,
        "Run the 1-D peak clustering and the advisory harmonic screen "
        "inside the device peak program; the host keeps a column's "
        "device result only when it proves it equal to its own float64 "
        "tail. Peaks are identical either way.",
    ),
]

FLAGS = {f.name: f for f in _ALL}


def _parse(flag, raw):
    if flag.type == "bool":
        return raw.strip().lower() not in _FALSE_WORDS
    if flag.type == "int":
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"unsupported {flag.name}={raw!r}: expected an "
                             "integer") from None
    if raw not in flag.choices:
        raise ValueError(f"unsupported {flag.name}={raw!r}: expected one "
                         f"of {flag.choices}")
    return raw


def get(name):
    """The parsed value of flag ``name`` from the environment now:
    unset or empty gives the default. KeyError for a name that is not
    a flag, ValueError for a value that does not parse."""
    flag = FLAGS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return flag.default
    return _parse(flag, raw)
