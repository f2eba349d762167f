"""
Prometheus text-format exposition of the metrics registry (the port's
copy of the JAX package's ``obs/prom.py``, with its metric names; the
service's ``/jobs`` surface waits for the serve plane).

Grown out of :mod:`riptide_tpu_torch.survey.metrics` rather than bolted on:
the registry already records counters, gauges, timers and fixed-log-
bucket histograms (every timer ``observe`` feeds its histogram, so a
histogram's ``_sum`` always equals the timer's total seconds — the
exposition cannot drift from the registry's own summary). This module
only *renders* a snapshot:

* :func:`render` — the text-format 0.0.4 page: counters as
  ``riptide_<name>_total``, gauges as ``riptide_<name>``, histograms as
  cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``
  (timer names ending in ``_s`` render with a ``_seconds`` base unit);
* :func:`write_prom` — atomic textfile write (node_exporter
  textfile-collector format: tmp + rename, never a torn page);
* :func:`serve` / :func:`maybe_serve` — an OPTIONAL stdlib-only
  localhost HTTP endpoint on a daemon thread, enabled by
  ``RIPTIDE_PROM_PORT`` (a scraper polls a *running* survey instead
  of waiting for its end-of-run snapshot). It serves four paths: ``/metrics`` (and ``/``, the text-format page), ``/status``
  (live survey JSON from the installed *status provider* — chunks
  done/parked/in-flight, EWMA rate, ETA, heartbeat ages, breaker
  state, last incident; see :func:`set_status_provider`) and
  ``/healthz`` (200 while healthy, **503** when the breaker is open or
  the newest heartbeat is older than ``RIPTIDE_STATUS_STALE_S`` — the
  liveness probe a supervisor or k8s readiness check points at). Any
  other path is a 404 whose body names the valid endpoints;
* :func:`maybe_write_textfile` — end-of-run textfile write when
  ``RIPTIDE_PROM_TEXTFILE`` is set (survey scheduler / rseek hook).

Everything here is host plumbing: nothing imports torch.
"""
import json
import logging
import os
import sys
import threading

from ..survey.metrics import get_metrics
from ..utils import envflags, fsio
from .alerts import get_engine

log = logging.getLogger("riptide_tpu_torch.obs.prom")

__all__ = ["render", "write_prom", "serve", "maybe_serve",
           "maybe_write_textfile", "set_status_provider",
           "set_fleet_source", "status_snapshot",
           "health_check", "PROM_PREFIX", "ENDPOINTS"]

# Every path the daemon answers; the 404 body enumerates them so a
# mistyped scrape target is self-diagnosing.
ENDPOINTS = ("/", "/metrics", "/status", "/healthz")

PROM_PREFIX = "riptide"

_HELP = {
    "chunks_done": "chunks searched to completion",
    "chunks_retried": "chunk dispatch attempts beyond the first",
    "chunks_skipped": "chunks satisfied from the journal on resume",
    "chunks_timed_out": "dispatch attempts abandoned by the watchdog",
    "chunks_parked": "chunks set aside by the open circuit breaker",
    "breaker_opens": "circuit-breaker transitions to open",
    "peer_losses": "collectives degraded to local-only mode",
    "oom_bisections": "DM-batch halvings after device OOM",
    "oom_predicted": "proactive DM-batch splits by the peak-HBM model",
    "incidents": "structured incident records emitted",
    "obs_write_errors": "observability writes degraded to incidents",
    "wire_bytes": "bytes shipped over the host->device wire",
    "queue_depth": "work items not yet collected",
    "heartbeat_age_s": "age of the stalest peer heartbeat",
}


def _metric_name(name):
    """Prometheus series name for a registry key: ``riptide_`` prefix,
    a ``_seconds`` base unit for the package's ``*_s`` timer names, and
    non-identifier characters mapped to ``_``."""
    if name.endswith("_s"):
        name = name[:-2] + "_seconds"
    clean = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"{PROM_PREFIX}_{clean}"


def _fmt(value):
    """Prometheus float rendering: integers without a trailing ``.0``
    (bucket counts must parse as exact counts), floats via repr."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int) or (isinstance(value, float)
                                  and value.is_integer()):
        return str(int(value))
    return repr(float(value))


def render(registry=None, fleet=None):
    """The full text-format page of one registry snapshot (counters,
    gauges, histograms — timers are covered by their histograms, whose
    ``_sum`` equals the timer total by construction), plus two
    federated sections:

    * **fleet series**: with per-process fleet snapshots available
      (``fleet`` dict, or the installed :func:`set_fleet_source`),
      progress and health counters render once per process under a
      ``process`` label — one scrape of any member exposes the whole
      run (``riptide_fleet_chunks_done{process="1"} 3`` ...);
    * **alert gauge**: with a process-wide alert engine installed
      (:func:`riptide_tpu_torch.obs.alerts.install_engine`), every
      configured rule renders as
      ``riptide_alert_active{rule="..."}`` 0/1 — explicit zeros, so a
      recording rule can watch for the flip rather than for series
      appearing."""
    snap = (registry or get_metrics()).snapshot()
    lines = []

    def head(name, kind, key):
        help_text = _HELP.get(key, f"riptide_tpu registry metric {key!r}")
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")

    for key in sorted(snap["counters"]):
        name = _metric_name(key) + "_total"
        head(name, "counter", key)
        lines.append(f"{name} {_fmt(snap['counters'][key])}")

    for key in sorted(snap["gauges"]):
        name = _metric_name(key)
        head(name, "gauge", key)
        lines.append(f"{name} {_fmt(snap['gauges'][key])}")

    for key in sorted(snap["hists"]):
        h = snap["hists"][key]
        name = _metric_name(key)
        head(name, "histogram", key)
        cum = 0
        for le, count in zip(h["buckets"], h["counts"]):
            cum += count
            lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{name}_sum {_fmt(h['sum'])}")
        lines.append(f"{name}_count {h['count']}")

    if fleet is None:
        with _fleet_lock:
            source = _fleet_source
        if source is not None:
            try:
                fleet = source()
            except Exception as err:
                log.warning("fleet source failed: %s", err)
    if fleet:
        lines.extend(_fleet_lines(fleet))

    engine = get_engine()
    if engine is not None:
        name = f"{PROM_PREFIX}_alert_active"
        lines.append(f"# HELP {name} 1 while the alert rule is firing "
                     "(riptide_tpu_torch.obs.alerts)")
        lines.append(f"# TYPE {name} gauge")
        for rule, active in sorted(engine.active().items()):
            lines.append(f'{name}{{rule="{rule}"}} {1 if active else 0}')

    return "\n".join(lines) + "\n"


# Per-process fleet fields federated onto the page, and their series
# suffix + TYPE. Staleness is exported as the snapshot's raw unix
# timestamp (the node_exporter textfile convention): a recording rule
# computes `time() - riptide_fleet_snapshot_timestamp_seconds`, and
# the page itself stays deterministic for unchanged sidecars (the
# textfile writer's atomic page can be byte-compared to a re-render).
_FLEET_GAUGES = (
    ("chunks_done", "fleet_chunks_done",
     "chunks this process completed"),
    ("chunks_parked", "fleet_chunks_parked",
     "chunks this process parked"),
    ("rate_chunks_per_s", "fleet_chunk_rate",
     "this process's recent chunk completion rate (1/s)"),
    ("running", "fleet_running",
     "1 while this process reports its survey running"),
)


def _fleet_lines(fleet):
    """The per-process federation section: every snapshot's progress
    gauges, snapshot timestamp and health counters under a ``process``
    label."""
    lines = []
    by_name = {}
    for p in sorted(fleet):
        snap = fleet[p]
        label = f'process="{int(p)}"'
        for key, suffix, help_text in _FLEET_GAUGES:
            val = snap.get(key)
            if val is None:
                continue
            by_name.setdefault(
                (f"{PROM_PREFIX}_{suffix}", "gauge", help_text),
                []).append((label, float(val)))
        ts = snap.get("ts")
        if ts is not None:
            by_name.setdefault(
                (f"{PROM_PREFIX}_fleet_snapshot_timestamp_seconds",
                 "gauge",
                 "unix time this process last rewrote its fleet "
                 "snapshot (staleness = time() - this)"),
                []).append((label, float(ts)))
        # Whatever health counters the sidecar carries (the snapshot
        # writer — obs/fleet.py — owns the key set).
        counters = snap.get("counters") or {}
        for key in sorted(counters):
            by_name.setdefault(
                (f"{PROM_PREFIX}_fleet_{key}_total", "counter",
                 f"this process's {key} counter"),
                []).append((label, float(counters[key])))
    for (name, kind, help_text), series in by_name.items():
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for label, val in series:
            lines.append(f"{name}{{{label}}} {_fmt(val)}")
    return lines


# Process-wide fleet source: a zero-argument callable returning
# {process_index: snapshot} (normally `lambda: report.read_fleet(jdir)`
# installed by the survey scheduler for the run's duration), so the
# /metrics page federates the whole run's processes.
_fleet_source = None
_fleet_lock = threading.Lock()


def set_fleet_source(source):
    """Install ``source()`` as the fleet-snapshot supplier for the
    exposition page (None uninstalls); returns the previous source."""
    global _fleet_source
    with _fleet_lock:
        prev, _fleet_source = _fleet_source, source
    return prev


def write_prom(path, registry=None):
    """Atomically write the exposition page to ``path`` (textfile-
    collector format: tmp + fsync + rename + directory fsync via fsio —
    a scraper never reads a torn page, even across a machine crash)."""
    return fsio.atomic_write_text(path, render(registry),
                                  site="prom_textfile")


def maybe_write_textfile(registry=None):
    """Write the page to ``RIPTIDE_PROM_TEXTFILE`` when set (end-of-run
    hook of the survey scheduler and rseek); returns the path or None.
    Never fatal: a failed write degrades to an ``obs_write_failed``
    incident + ``obs_write_errors`` counter and the run completes."""
    path = envflags.get("RIPTIDE_PROM_TEXTFILE")
    if not path:
        return None
    try:
        return write_prom(path, registry)
    except OSError as err:
        log.warning("prom textfile write to %r failed: %s", path, err)
        from .ledger import _obs_write_failed

        _obs_write_failed("prom_textfile", path, err)
        return None


# Process-wide live-status provider: a zero-argument callable returning
# the /status JSON dict, installed by whoever owns the run (the survey
# scheduler registers one per run when RIPTIDE_STATUS is on). Resolved
# per request so a second survey in the same process takes over cleanly.
_status_provider = None
_status_lock = threading.Lock()


def set_status_provider(provider):
    """Install ``provider()`` as the source of the ``/status`` page
    (None uninstalls); returns the previous provider."""
    global _status_provider
    with _status_lock:
        prev, _status_provider = _status_provider, provider
    return prev


def status_snapshot():
    """The current ``/status`` document: the provider's dict plus
    ``"active": True``, or ``{"active": False}`` when no survey has
    registered one (the endpoint may outlive — or predate — a run)."""
    with _status_lock:
        provider = _status_provider
    if provider is None:
        status = {"active": False}
    else:
        status = dict(provider())
        status.setdefault("active", True)
    return status


def health_check(status=None, stale_s=None):
    """``(healthy, problems)`` for the ``/healthz`` probe: unhealthy
    when the circuit breaker is open or the newest heartbeat is older
    than ``stale_s`` (default ``RIPTIDE_STATUS_STALE_S``) — the two
    conditions under which a survey process is up but not making
    progress. The probe answers "is the run wedged", not "is there a
    run": a process with no registered status, or whose status says
    ``running: false`` (the survey finished; its provider stays
    registered so the final state remains queryable, but heartbeats
    have legitimately stopped), is healthy — a supervisor must never
    kill an idle process over a completed run's aging heartbeats."""
    if status is None:
        status = status_snapshot()
    if not status.get("running", True):
        return True, []
    if stale_s is None:
        stale_s = envflags.get("RIPTIDE_STATUS_STALE_S")
    problems = []
    if status.get("breaker") == "open":
        problems.append("circuit breaker open")
    ages = status.get("heartbeat_age_s") or {}
    if ages:
        freshest = min(ages.values())
        if stale_s is not None and freshest > float(stale_s):
            problems.append(
                f"stale heartbeat: freshest beat {freshest:.1f}s old "
                f"(> {float(stale_s):.1f}s)"
            )
    return (not problems), problems


class _PromServer:
    """Localhost metrics/status endpoint on a daemon thread.
    ``close()`` is idempotent; ``port`` is the bound port (useful with
    port 0)."""

    def __init__(self, port, registry=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code, body, ctype, headers=None):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path in ("/metrics", "/"):
                    # Resolved at request time, not server start: a
                    # later set_registry (or, unpinned, a set_metrics
                    # swap) shows up on the next scrape instead of
                    # serving a registry frozen at whatever the first
                    # caller passed.
                    self._reply(200,
                                render(self.server._riptide_registry),
                                "text/plain; version=0.0.4")
                elif path == "/status":
                    self._reply(200, json.dumps(status_snapshot()),
                                "application/json")
                elif path == "/healthz":
                    status = status_snapshot()
                    ok, problems = health_check(status)
                    self._reply(
                        200 if ok else 503,
                        json.dumps({"ok": ok, "problems": problems,
                                    "status": status}),
                        "application/json",
                    )
                else:
                    self._reply(
                        404,
                        f"unknown path {path!r}; valid endpoints: "
                        + ", ".join(ENDPOINTS) + "\n",
                        "text/plain",
                    )

            def log_message(self, fmt, *args):
                log.debug("prom endpoint: " + fmt, *args)

        # Loopback only: exposition is operator plumbing, not a public
        # service; binding wider is a deliberate reverse-proxy decision.
        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self._httpd._riptide_registry = registry
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="riptide-prom-endpoint", daemon=True,
        )
        self._thread.start()

    def set_registry(self, registry):
        """Re-point /metrics at ``registry`` (None = the process-wide
        default via :func:`get_metrics`, looked up per scrape)."""
        self._httpd._riptide_registry = registry

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def serve(port, registry=None):
    """Start a /metrics endpoint on 127.0.0.1:``port`` (0 = ephemeral);
    returns the server object (``.port``, ``.close()``)."""
    return _PromServer(port, registry=registry)


# Process-wide endpoint handle for maybe_serve (one per process; a
# second survey run in the same process reuses it).
_server = None
_server_lock = threading.Lock()


def _detect_process_index():
    """This process's rank, WITHOUT importing torch: only a process
    that already initialized ``torch.distributed`` can have a nonzero
    rank, so an absent (or uninitialized) torch means 0."""
    mod = sys.modules.get("torch")
    dist = getattr(mod, "distributed", None) if mod is not None else None
    try:
        if dist is not None and dist.is_available() \
                and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def maybe_serve(registry=None, process_index=None):
    """Start the process-wide endpoint when ``RIPTIDE_PROM_PORT`` > 0
    and none is running yet; returns the server or None. Survey entry
    points call this unconditionally — the disabled path is one flag
    read. A caller with an explicit ``registry`` re-points a running
    endpoint (last caller wins), so a scheduler constructed with its
    own registry is the one a scraper sees during its run.

    With ``RIPTIDE_PROM_PORT_OFFSET`` (the default), the bound port is
    ``RIPTIDE_PROM_PORT + process_index`` (auto-detected from
    torch.distributed when not passed): two processes sharing one
    host no longer race to bind the same port and silently lose one
    endpoint — each gets a deterministic, documented port of its own.
    ``0`` restores the literal-port behaviour (e.g. behind a
    per-process port map)."""
    global _server
    port = envflags.get("RIPTIDE_PROM_PORT")
    if not port or port <= 0:
        return _server
    if envflags.get("RIPTIDE_PROM_PORT_OFFSET"):
        if process_index is None:
            process_index = _detect_process_index()
        port += int(process_index)
    with _server_lock:
        if _server is None:
            _server = serve(port, registry=registry)
            log.info("Prometheus endpoint on http://127.0.0.1:%d/metrics",
                     _server.port)
        elif registry is not None:
            _server.set_registry(registry)
    return _server
