"""
The ``RIPTIDE_*`` environment flags the port reads, with the JAX
package's names, types and defaults (``riptide_tpu/utils/envflags.py``).

Each flag is read through :func:`get` at call time, so a changed
environment (a test's monkeypatch, a smoke run's wire modes) takes
effect at the next search. Unset or empty means the default.

This module imports the standard library alone: riplint's env-flag
rule (RIP003, ``analysis/lint/env_flags.py``) loads it by file path,
checks every ``RIPTIDE_*`` read of the port against :data:`FLAGS`, and
fails when ``analysis/env_flags.md`` differs from
:func:`render_markdown`.
"""
import os
from typing import NamedTuple

__all__ = ["EnvFlag", "FLAGS", "get", "render_markdown"]

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
    EnvFlag(
        "RIPTIDE_CACHE_ROOT", "str", None,
        "Root directory of the on-disk caches (explicit operator "
        "intent, used as given). Default: a trusted `.riptide_cache/` "
        "at the checkout root, else a per-user 0700 tempdir. The port's "
        "built libraries live under `<root>/torch_build/`.",
    ),
    EnvFlag(
        "RIPTIDE_EXEC_CACHE", "str", None,
        "Directory of the port's built-library cache (default "
        "`<cache_root>/torch_build`). Unlike the JAX package's executable "
        "cache it cannot be turned off: a library is built somewhere.",
    ),
    EnvFlag(
        "RIPTIDE_EXEC_CACHE_MAX_BYTES", "int", 2 << 30,
        "Byte cap of the built-library cache directory: a store evicts "
        "the least recently used libraries above it; <= 0 disables "
        "eviction.",
    ),
    EnvFlag(
        "RIPTIDE_CHAOS_DIR", "str", None,
        "Working directory of the storage-chaos campaign "
        "(`python -m riptide_tpu_torch.apps.rchaos`); default: a fixed "
        "per-system tempdir. Kept on failure for post-mortems.",
    ),
    EnvFlag(
        "RIPTIDE_CHAOS_SEED", "int", 1234,
        "Seed of the chaos campaign's generated schedule sweep: the "
        "same seed reproduces the same kill-point/degradation "
        "combinations (`rchaos --seed` overrides).",
    ),
    EnvFlag(
        "RIPTIDE_CHAOS_SWEEP", "int", 0,
        "How many seeded schedules the chaos campaign appends to the "
        "fixed builtin set (0 = builtin only; `rchaos --sweep` and the "
        "slow test tier run more).",
    ),
    EnvFlag(
        "RIPTIDE_CHAOS_KEEP", "bool", False,
        "Keep the chaos campaign's working directory after a PASSING "
        "run too (failures always keep it).",
    ),
    EnvFlag(
        "RIPTIDE_SERVE", "bool", True,
        "Serve the /jobs API from the survey service daemon "
        "(`python -m riptide_tpu_torch.apps.rserve`): accept, queue and "
        "run jobs submitted over HTTP. `0` starts the daemon "
        "metrics/status-only (the /jobs surface answers 503).",
    ),
    EnvFlag(
        "RIPTIDE_SERVE_MAX_JOBS", "int", 16,
        "Max jobs the service daemon keeps resident (pending + "
        "running) across ALL tenants; a submit over the cap is "
        "rejected with HTTP 429 and a `job_rejected` incident. "
        "Completed/failed/cancelled jobs do not count.",
    ),
    EnvFlag(
        "RIPTIDE_SERVE_QUOTA_DEVICE_S", "float", 0.0,
        "Default per-tenant device-seconds budget for service jobs "
        "(riptide_tpu_torch/serve/tenants.py): every fair-share device "
        "turn is charged against it, and an exhausted tenant's jobs "
        "stop at their next chunk boundary with a `quota_exceeded` "
        "incident (journals stay resumable). `0` = unlimited.",
    ),
    EnvFlag(
        "RIPTIDE_SERVE_PORT", "int", 0,
        "Port of the survey service daemon's HTTP endpoint (loopback "
        "only, like RIPTIDE_PROM_PORT). `0` binds an ephemeral port, "
        "published in the serve root's `serve.port` discovery file "
        "either way.",
    ),
    EnvFlag(
        "RIPTIDE_SERVE_DIR", "str", None,
        "Default serve root for rserve (the directory holding "
        "jobs.jsonl, per-job journal directories and the serve.port "
        "discovery file). Unset = the rserve --root argument is "
        "required.",
    ),
    EnvFlag(
        "RIPTIDE_SERVE_DRAIN_TIMEOUT_S", "float", 60.0,
        "Graceful-drain budget of the survey service daemon: on "
        "SIGTERM/SIGINT or POST /drain, how long to wait for the "
        "running chunk to finish and queued jobs to park at the chunk "
        "gate before rserve exits anyway. Parked jobs keep no terminal "
        "registry record, so a restart re-queues them (`resumed`).",
    ),
    EnvFlag(
        "RIPTIDE_NATIVE_SANITIZE", "bool", False,
        "Build the native host library with ASan+UBSan "
        "(`-fsanitize=address,undefined`, no recovery, `-g`, "
        "`-fno-omit-frame-pointer`, `-ffp-contract=off` kept). The flags "
        "are part of the build cache's key, so the sanitized library "
        "never stands in for the production one. It loads only with the "
        "sanitizer runtimes preloaded (`LD_PRELOAD` of `g++ "
        "-print-file-name=libasan.so` and `libubsan.so`); without them "
        "the native runtime raises instead of falling back to numpy.",
    ),
    EnvFlag(
        "RIPTIDE_HBM_BUDGET", "int", 0,
        "Peak device-memory budget (bytes) for the model-seeded DM-batch "
        "pick: when > 0, the batch searcher caps each queued DM batch at "
        "the largest size the plan's peak-memory model "
        "(riptide_tpu_torch/analysis/launch_contract.py, fitted from the "
        "shape-only walk of the stage loop) predicts fits, so OOM "
        "bisection becomes a fallback instead of the first resort "
        "(`oom_predicted` counts proactive splits), and journaled chunks "
        "carry a predicted-vs-actual `hbm` block (actual from "
        "`torch.cuda.max_memory_allocated`). `0` disables seeding.",
    ),
    EnvFlag(
        "RIPTIDE_PROVE_PLANS", "str", None,
        "Comma-separated subset of contract plan names that "
        "`python -m riptide_tpu_torch.apps.rprove` verifies (see "
        "riptide_tpu_torch/ops/plan.py CONTRACT_PLANS); unset verifies "
        "every fast-tier plan and `--all` adds the slow tier. The "
        "--plans option takes precedence.",
    ),
    EnvFlag(
        "RIPTIDE_SCHED_BOUND", "int", 2,
        "Preemption bound of the `ripsched` schedule-exploration model "
        "checker (`python -m riptide_tpu_torch.apps.ripsched`): schedules "
        "with at most this many preemptive context switches are explored "
        "exhaustively, shallowest first, so any violation found is "
        "minimal in preemptions. Raising it widens coverage at "
        "exponential cost. Checker-only; never read by a survey run.",
    ),
    EnvFlag(
        "RIPTIDE_SCHED_SEED", "int", 0,
        "Seed ordering the alternatives `ripsched` expands first within "
        "each preemption bound. Changes which violation (if several "
        "exist) is reported first, never whether one is found at the "
        "bound; replay IDs embed the decision digits and do not depend "
        "on it. Checker-only.",
    ),
    EnvFlag(
        "RIPTIDE_SCHED_REPLAY", "str", "",
        "When non-empty, `ripsched` replays this recorded schedule ID "
        "(`model[+mutation]:digits`) deterministically instead of "
        "exploring: the repro printed with every violation. "
        "Checker-only.",
    ),
    EnvFlag(
        "RIPTIDE_BENCH_BUDGET", "float", 1380.0,
        "Total process wall-time budget (seconds) that `python -m "
        "riptide_tpu_torch.bench` runs against: the first timed pass "
        "always emits a JSON line, further best-of-N passes (N <= 3) "
        "run only while the budget clearly covers them.",
    ),
    EnvFlag(
        "RIPTIDE_BENCH_DEBUG", "bool", False,
        "Enable the bench's periodic faulthandler stack dumps to stderr "
        "(every 180 s; locates stalls). Read through the registry, so "
        "`0` disables, where the JAX package's bench.py reads the raw "
        "value and any non-empty one enables.",
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


def get(name, env=None):
    """The parsed value of flag ``name`` from ``env`` (a mapping; the
    environment now when None): unset or empty gives the default.
    KeyError for a name that is not a flag, ValueError for a value that
    does not parse."""
    flag = FLAGS[name]
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return flag.default
    return _parse(flag, raw)


def render_markdown():
    """The port's flag reference, ``riptide_tpu_torch/analysis/
    env_flags.md``, generated from the registry (write it with ``python
    -m riptide_tpu_torch.apps.riplint --write-env-docs``)."""
    lines = [
        "# Environment flags of the port",
        "",
        "Every `RIPTIDE_*` environment variable `riptide_tpu_torch` reads, "
        "generated",
        "from its registry `riptide_tpu_torch/utils/envflags.py` "
        "(regenerate with",
        "`python -m riptide_tpu_torch.apps.riplint --write-env-docs`). "
        "The port",
        "reads flags only through `envflags.get(...)`; riplint's RIP003 "
        "rejects any",
        "other read of a `RIPTIDE_*` name. Boolean flags read `0` / "
        "`false` / `off`",
        "/ `no` as False and any other non-empty value as True; unset or "
        "empty",
        "means the default.",
        "",
        "| Flag | Type | Default |",
        "|------|------|---------|",
    ]
    for f in _ALL:
        typ = f.type
        if f.type == "choice":
            typ = " \\| ".join(f"`{c}`" for c in f.choices)
        default = "unset" if f.default is None else f"`{f.default}`"
        lines.append(f"| `{f.name}` | {typ} | {default} |")
    lines.append("")
    for f in _ALL:
        lines += [f"## `{f.name}`", "", f.help, ""]
    return "\n".join(lines)
