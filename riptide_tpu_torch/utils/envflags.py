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
    """One flag: ``type`` is ``bool``, ``int``, ``float``, ``str`` or
    ``choice`` (one of ``choices``)."""
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
    EnvFlag(
        "RIPTIDE_FAULT_INJECT", "str", None,
        "Fault-injection spec for the survey scheduler and the batch "
        "searcher, e.g. `stall:0:0.1,raise:2x2,oom:0`, including the "
        "storage kinds (`kill_at:journal_append:3`); see "
        "riptide_tpu_torch/survey/faults.py for the grammar. The CLIs' "
        "`--fault-inject` takes precedence.",
    ),
    EnvFlag(
        "RIPTIDE_TRACE", "bool", False,
        "Enable the span tracer for the whole process at import time; "
        "journaled runs export it as a Chrome trace (`trace.json` next "
        "to the journal).",
    ),
    EnvFlag(
        "RIPTIDE_TRACE_RING", "int", 65536,
        "Span-ring capacity of the tracer: a long survey drops the "
        "oldest spans and the export records how many.",
    ),
    EnvFlag(
        "RIPTIDE_PROM_PORT", "int", 0,
        "Serve Prometheus text-format metrics at "
        "http://127.0.0.1:<port>/metrics (and /status, /healthz) on a "
        "daemon thread during survey runs; 0 disables the endpoint.",
    ),
    EnvFlag(
        "RIPTIDE_PROM_PORT_OFFSET", "bool", True,
        "Offset the Prometheus endpoint port by this process's "
        "torch.distributed rank, so that processes on one host get "
        "their own endpoints; `0` binds the literal port.",
    ),
    EnvFlag(
        "RIPTIDE_PROM_TEXTFILE", "str", None,
        "Path of a Prometheus textfile the survey layers write the "
        "metrics registry to at the end of each run; unset disables.",
    ),
    EnvFlag(
        "RIPTIDE_LEDGER", "str", None,
        "Path of the append-only JSONL performance ledger: every "
        "journaled survey appends one run record. Unset disables.",
    ),
    EnvFlag(
        "RIPTIDE_STATUS", "bool", True,
        "Register journaled survey runs as the /status + /healthz "
        "source of the Prometheus endpoint; `0` leaves it metrics-only.",
    ),
    EnvFlag(
        "RIPTIDE_STATUS_STALE_S", "float", 120.0,
        "Heartbeat age (seconds) beyond which /healthz reports 503.",
    ),
    EnvFlag(
        "RIPTIDE_FLEET", "bool", True,
        "Write the per-process fleet status sidecar (`fleet_<p>.json`) "
        "next to the journal after every chunk; `0` disables it.",
    ),
    EnvFlag(
        "RIPTIDE_ALERTS", "bool", False,
        "Evaluate the alert rules (riptide_tpu_torch/obs/alerts.py) "
        "over a journaled survey after every chunk.",
    ),
    EnvFlag(
        "RIPTIDE_ALERT_RULES", "str", None,
        "Alert rule spec: comma-separated `name[:limit[:for_count]]` "
        "builtin rules, or `default`; unset means the full catalog.",
    ),
    EnvFlag(
        "RIPTIDE_INTEGRITY", "choice", "off",
        "Result-integrity mode of the survey scheduler "
        "(riptide_tpu_torch/survey/integrity.py): `off`, `digest` "
        "(per-chunk result digests, re-verified on resume), `probe` "
        "(plus shadow dispatches per RIPTIDE_INTEGRITY_PROBE_EVERY) or "
        "`strict` (every chunk probed, the golden canary at start).",
        choices=("off", "digest", "probe", "strict"),
    ),
    EnvFlag(
        "RIPTIDE_INTEGRITY_PROBE_EVERY", "int", 0,
        "Shadow-probe cadence of `RIPTIDE_INTEGRITY=probe`: dispatch "
        "every Nth chunk twice and compare the result digests; `0` "
        "disables probing.",
    ),
]

FLAGS = {f.name: f for f in _ALL}


def _parse(flag, raw):
    if flag.type == "bool":
        return raw.strip().lower() not in _FALSE_WORDS
    if flag.type in ("int", "float"):
        try:
            return int(raw) if flag.type == "int" else float(raw)
        except ValueError:
            raise ValueError(f"unsupported {flag.name}={raw!r}: expected "
                             f"a number ({flag.type})") from None
    if flag.type == "str":
        return raw
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
