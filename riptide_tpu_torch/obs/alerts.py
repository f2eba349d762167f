"""
Declarative alert rules over live survey snapshots (the port's copy of
the JAX package's ``obs/alerts.py``, with its rule names).

The observability stack so far *measures* (spans, prom, the ledger) and
*records* (journal, incidents) — but nothing turns a bad live signal
into an action: a transfer-bound run, a stalled heartbeat, parked
chunks piling up or a memory model drifting all scroll past as
numbers until a human reads a report. This module closes the
measure→detect half of the loop: a small rule engine evaluated over
the :func:`riptide_tpu_torch.obs.report.watch_snapshot` signal vector, with
hysteresis so noise cannot flap an alert.

Three rule modes (:data:`RULE_MODES`):

* ``threshold`` — fire when the signal breaches ``op``/``limit`` for
  ``for_count`` consecutive evaluations (``for_count > 1`` is the
  consecutive-count form), resolve after ``clear_count`` clean ones;
* ``absence`` — a staleness check: fire when the signal (an age in
  seconds) exceeds ``limit`` **or** is missing entirely while
  ``missing_fires`` is set (a heartbeat that never appeared is as dead
  as a stale one);
* ``rate`` — differentiate a monotone series: fire when it grew by at
  least ``limit`` within the trailing ``window_s`` seconds, resolve
  once a full window passes without growth (the ``obs_write_errors``
  shape: any growth is news, the absolute count is history).

Firing and resolving produce journal-shaped ``alert`` records (the
engine's owner — the survey scheduler — appends them via
``SurveyJournal.record_alert`` and mirrors them as ``alert_fired`` /
``alert_resolved`` incidents), and the process-wide engine installed
with :func:`install_engine` backs the ``riptide_alert_active{rule=...}``
gauge on the Prometheus page (:func:`riptide_tpu_torch.obs.prom.render`).

This module is deliberately **stdlib-only and self-contained**; wiring
into incidents/journal/prom happens through the injectable
``on_event`` hook, never by import.
"""
import logging
import threading
import time
from datetime import datetime, timezone

__all__ = [
    "RULE_MODES", "AlertRule", "AlertEngine", "default_rules",
    "rules_from_spec", "install_engine", "get_engine", "BUILTIN_HELP",
]

log = logging.getLogger("riptide_tpu_torch.obs.alerts")

RULE_MODES = ("threshold", "absence", "rate")

_OPS = {
    ">": lambda v, lim: v > lim,
    ">=": lambda v, lim: v >= lim,
    "<": lambda v, lim: v < lim,
    "<=": lambda v, lim: v <= lim,
}


def _utc_iso(ts=None):
    """UTC ISO-8601 Z stamp (the journal's format; duplicated here so
    the module stays standalone-loadable — see ledger.py's sibling)."""
    dt = (datetime.now(timezone.utc) if ts is None
          else datetime.fromtimestamp(float(ts), timezone.utc))
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


class AlertRule:
    """One declarative rule: ``key`` names a :func:`watch_snapshot`
    signal, ``op``/``limit`` the breach condition, ``mode`` the
    evaluation shape (see module docstring). ``transform`` optionally
    maps the raw signal before comparison (e.g. distance-from-1 for
    the HBM drift rule). Rules are stateless — all evaluation state
    lives in the :class:`AlertEngine` — so one rule list can be shared
    or re-created freely."""

    def __init__(self, name, key, limit, op=">=", mode="threshold",
                 for_count=1, clear_count=1, window_s=300.0,
                 missing_fires=False, transform=None, help=""):
        if mode not in RULE_MODES:
            raise ValueError(f"unknown alert rule mode {mode!r} "
                             f"(expected one of {RULE_MODES})")
        if op not in _OPS:
            raise ValueError(f"unknown alert rule op {op!r}")
        if for_count < 1 or clear_count < 1:
            raise ValueError("for_count/clear_count are 1-based")
        self.name = str(name)
        self.key = str(key)
        self.limit = float(limit)
        self.op = op
        self.mode = mode
        self.for_count = int(for_count)
        self.clear_count = int(clear_count)
        self.window_s = float(window_s)
        self.missing_fires = bool(missing_fires)
        self.transform = transform
        self.help = help

    def replace(self, **kw):
        """A copy with the given parameters overridden (how a spec
        string retunes a builtin without re-stating its shape)."""
        base = {
            "name": self.name, "key": self.key, "limit": self.limit,
            "op": self.op, "mode": self.mode,
            "for_count": self.for_count, "clear_count": self.clear_count,
            "window_s": self.window_s, "missing_fires": self.missing_fires,
            "transform": self.transform, "help": self.help,
        }
        base.update(kw)
        return AlertRule(**base)


def default_rules():
    """Fresh instances of the builtin rule catalog (the JAX package's
    names; retune via ``RIPTIDE_ALERT_RULES``)."""
    return [
        AlertRule(
            "tunnel_bound", "consecutive_tunnel", 3, op=">=",
            help="the newest N chunks were all transfer-bound: the "
                 "host-to-device copy, not compute, is the headline"),
        AlertRule(
            "heartbeat_stale", "heartbeat_age_s", 120.0, op=">",
            mode="absence",
            help="even the freshest heartbeat is older than the stall "
                 "budget: the run is up but not making progress"),
        AlertRule(
            "parked_chunks", "chunks_parked", 1, op=">=",
            help="the circuit breaker parked chunk(s): the survey is "
                 "completing degraded and owes a resume"),
        AlertRule(
            "straggler_ratio", "straggler_ratio", 3.0, op=">=",
            help="the slowest recent chunk took this many times the "
                 "windowed median wall-clock"),
        AlertRule(
            "obs_write_errors", "obs_write_failures", 1, op=">=",
            mode="rate", window_s=300.0,
            help="observability writes degraded to incidents within "
                 "the trailing window (disk filling up under the "
                 "journal?)"),
        AlertRule(
            "hbm_drift", "hbm_ratio_median", 0.5, op=">",
            transform=lambda v: abs(v - 1.0),
            help="the peak-memory model's predicted-vs-actual ratio "
                 "(journal hbm blocks, written while RIPTIDE_HBM_BUDGET "
                 "seeds the DM batch) drifted beyond the margin"),
        AlertRule(
            "integrity", "integrity_mismatches", 1, op=">=",
            help="result-integrity mismatch(es) detected: a device "
                 "returned different bytes for the same chunk, or a "
                 "replayed chunk no longer matches its journaled "
                 "digest — audit the journal's integrity blocks "
                 "before trusting this archive"),
    ]


BUILTIN_HELP = {r.name: r.help for r in default_rules()}


def rules_from_spec(spec):
    """Rule list from a spec string (``RIPTIDE_ALERT_RULES``):
    comma-separated ``name[:limit[:for_count]]``
    entries naming builtin rules, or the word ``default`` for the full
    catalog. Naming a subset runs only that subset; re-tuned entries
    override the builtin parameters. Unknown names raise — a typo'd
    rule must not silently never fire."""
    if spec is None or not str(spec).strip() or str(spec) == "default":
        return default_rules()
    builtin = {r.name: r for r in default_rules()}
    out, seen = [], {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if part == "default":
            for rule in default_rules():
                if rule.name not in seen:
                    seen[rule.name] = len(out)
                    out.append(rule)
            continue
        bits = part.split(":")
        name = bits[0]
        if name not in builtin:
            raise ValueError(
                f"unknown alert rule {name!r} (builtins: "
                f"{sorted(builtin)})")
        rule = builtin[name]
        if len(bits) > 1 and bits[1]:
            rule = rule.replace(limit=float(bits[1]))
        if len(bits) > 2 and bits[2]:
            rule = rule.replace(for_count=int(bits[2]))
        if len(bits) > 3:
            raise ValueError(f"bad alert rule entry {part!r}: expected "
                             "name[:limit[:for_count]]")
        if name in seen:
            out[seen[name]] = rule
        else:
            seen[name] = len(out)
            out.append(rule)
    return out


class AlertEngine:
    """Evaluates a rule list over successive snapshots, keeping the
    per-rule hysteresis state and the active-alert set.

    ``on_event(record)`` is called for every fire/resolve with the
    journal-shaped ``alert`` record; hook failures are logged, never
    raised — detecting a problem must not become one. Thread-safe: the
    scheduler evaluates from its run loop while the Prometheus daemon
    reads :meth:`active` per scrape."""

    def __init__(self, rules=None, on_event=None):
        self.rules = list(default_rules() if rules is None else rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        self.on_event = on_event
        self._lock = threading.Lock()
        # name -> {breach, ok, active, history [(t, value), ...]}
        self._state = {r.name: {"breach": 0, "ok": 0, "active": False,
                                "history": []} for r in self.rules}
        self._events = []

    # -- evaluation ---------------------------------------------------------

    def _breaching(self, rule, value, state, now):
        if rule.mode == "rate":
            # Differentiate a monotone series: growth within the
            # trailing window. The sample lands in history first so a
            # single evaluation can both record and judge it.
            if value is not None:
                state["history"].append((now, float(value)))
            state["history"] = [
                (t, v) for t, v in state["history"]
                if now - t <= rule.window_s]
            hist = state["history"]
            if len(hist) < 2:
                return False, None
            growth = hist[-1][1] - hist[0][1]
            return _OPS[rule.op](growth, rule.limit), growth
        if value is None:
            return (True, None) if (rule.mode == "absence"
                                    and rule.missing_fires) else (False,
                                                                  None)
        value = float(value)
        if rule.transform is not None:
            value = float(rule.transform(value))
        return _OPS[rule.op](value, rule.limit), value

    def evaluate(self, snapshot, now=None):
        """Fold one snapshot; returns the fire/resolve events it
        produced (each already handed to ``on_event``)."""
        now = float(snapshot.get("now", time.time())
                    if now is None else now)
        events = []
        with self._lock:
            for rule in self.rules:
                state = self._state[rule.name]
                breaching, value = self._breaching(
                    rule, snapshot.get(rule.key), state, now)
                if breaching:
                    state["breach"] += 1
                    state["ok"] = 0
                else:
                    state["ok"] += 1
                    state["breach"] = 0
                if not state["active"] and breaching \
                        and state["breach"] >= rule.for_count:
                    state["active"] = True
                    events.append(self._event(rule, "fired", value, now))
                elif state["active"] and not breaching \
                        and state["ok"] >= rule.clear_count:
                    state["active"] = False
                    events.append(self._event(rule, "resolved", value,
                                              now))
            self._events.extend(events)
        for event in events:
            log.warning("alert %s: %s (value %s, limit %s)",
                        event["event"], event["rule"], event["value"],
                        event["limit"])
            if self.on_event is not None:
                try:
                    self.on_event(dict(event))
                except Exception as err:
                    log.warning("alert on_event hook failed for %r: %s",
                                event["rule"], err)
        return events

    def _event(self, rule, event, value, now):
        """One journal-shaped ``alert`` record (the writer side of the
        RIP010 alert schema; ``SurveyJournal.record_alert`` appends it
        verbatim)."""
        return {
            "kind": "alert",
            "event": event,
            "rule": rule.name,
            "utc": _utc_iso(now),
            "value": (None if value is None
                      else round(float(value), 6)),
            "limit": rule.limit,
            "mode": rule.mode,
        }

    # -- reading ------------------------------------------------------------

    def active(self):
        """``{rule_name: True/False}`` over every configured rule (the
        ``riptide_alert_active`` gauge series, one per rule so a
        scraper sees explicit zeros, not absent series)."""
        with self._lock:
            return {r.name: self._state[r.name]["active"]
                    for r in self.rules}

    def unresolved(self):
        """Names of currently-firing rules."""
        with self._lock:
            return sorted(name for name, s in self._state.items()
                          if s["active"])

    def events(self):
        """Every fire/resolve event this engine produced, in order."""
        with self._lock:
            return list(self._events)


# Process-wide engine handle: the survey scheduler installs its run's
# engine so the Prometheus page can render the alert gauge without the
# exposition layer knowing who owns the run (the status-provider
# pattern). None while no engine is installed.
_engine = None
_engine_lock = threading.Lock()


def install_engine(engine):
    """Install ``engine`` as the process-wide alert engine (None
    uninstalls); returns the previous one."""
    global _engine
    with _engine_lock:
        prev, _engine = _engine, engine
    return prev


def get_engine():
    """The process-wide alert engine, or None."""
    with _engine_lock:
        return _engine
