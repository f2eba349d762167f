#!/usr/bin/env python
"""
rwatch: live alert watcher over a survey running in ANOTHER process
(the port's copy of the JAX package's ``tools/rwatch.py``).

Follows a journal directory the way ``rtop`` does — incremental
journal reads via ``report.JournalFollower``, heartbeat-sidecar tails,
fleet ``fleet_<p>.json`` snapshots — and evaluates the alert-rule
engine (``riptide_tpu_torch/obs/alerts.py``) over the merged live state
on every poll, printing fire/resolve events as they happen. The watched
run needs no flag, no endpoint and no code change (``RIPTIDE_ALERTS``
adds the in-process engine, which additionally journals its events;
rwatch works either way, and both evaluate the SAME
``report.watch_snapshot`` signal vector, so they fire on identical
evidence).

Usage::

    python -m riptide_tpu_torch.apps.rwatch JDIR [--interval 1.0]
        [--rules SPEC] [--timeout S] [--once] [--json PATH] [--quiet]
    python riptide_tpu_torch/apps/rwatch.py JDIR ...

By default rwatch follows the run until its journal says every chunk
is done or parked, then exits — **nonzero while any alert is still
firing** — so CI (or a supervising daemon) can gate on it:

* ``0`` — run complete, no unresolved alerts;
* ``1`` — run complete (or ``--once``) with unresolved alert(s);
* ``2`` — usage error (no journal directory, a bad rule spec);
* ``3`` — ``--timeout`` expired before the run completed;
* ``130`` — interrupted (Ctrl-C / SIGINT) before a verdict: never to
  be read as clean by a supervising gate.

``--rules`` takes the same ``name[:limit[:for_count]]`` spec as
``RIPTIDE_ALERT_RULES``; ``--once`` evaluates a single snapshot
(scripts/tests); ``--json`` writes the full event log + final
snapshot + fleet view for machine consumption. Run by path it loads the
torch-free reader and engine standalone, so it runs anywhere the
journal files are visible.
"""
import argparse
import json
import os
import sys
import time

if __package__:
    from .rreport import _load_standalone, load_report_module
else:   # run by path: the sibling module, not the package
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rreport import _load_standalone, load_report_module


def load_alerts_module():
    """riptide_tpu_torch.obs.alerts, loaded standalone by file path (the
    rreport pattern) so watching a run never needs torch."""
    return _load_standalone("riptide_tpu_torch_obs_alerts_standalone",
                            ("obs", "alerts.py"))


def _fmt_event(event):
    mark = "FIRED   " if event.get("event") == "fired" else "resolved"
    line = (f"{event.get('utc', '?')}  {mark} {event.get('rule', '?')}")
    if event.get("value") is not None:
        line += f"  (value {event['value']}, limit {event.get('limit')})"
    return line


def watch(rep, al, journal_dir, rules=None, interval=1.0, timeout=None,
          once=False, out=sys.stdout, quiet=False, clock=time.time,
          sleep=time.sleep):
    """The follow loop (importable for tests): returns
    ``(exit_code, result dict)``. ``result`` holds the event log, the
    final snapshot, the unresolved set and the merged fleet view."""
    engine = al.AlertEngine(rules if rules is not None
                            else al.default_rules())
    follower = rep.JournalFollower(journal_dir)
    deadline = None if timeout is None else clock() + float(timeout)
    timed_out = False
    snap = {}
    while True:
        state = follower.poll()
        beats = rep.read_heartbeats(journal_dir)
        snap = rep.watch_snapshot(state, heartbeats=beats, now=clock())
        for event in engine.evaluate(snap):
            if not quiet:
                out.write(_fmt_event(event) + "\n")
                out.flush()
        if once or snap.get("complete"):
            break
        if deadline is not None and clock() >= deadline:
            timed_out = True
            break
        sleep(float(interval))
    unresolved = engine.unresolved()
    result = {
        "directory": os.path.abspath(journal_dir),
        "events": engine.events(),
        "unresolved": unresolved,
        "snapshot": snap,
        "complete": bool(snap.get("complete")),
        "timed_out": timed_out,
        "fleet": rep.merge_fleet(rep.read_fleet(journal_dir)),
    }
    if timed_out and not snap.get("complete"):
        return 3, result
    return (1 if unresolved else 0), result


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rwatch",
        description="Alert watcher over a journaled survey running in "
                    "another process (tail-reads the journal "
                    "directory; exits nonzero on unresolved alerts).",
    )
    ap.add_argument("journal", help="journal directory to watch")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="poll period in seconds (default 1)")
    ap.add_argument("--rules", default=None,
                    help="rule spec `name[:limit[:for_count]],...` "
                         "(default: the full builtin catalog)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="give up (exit 3) if the run has not "
                         "completed after this many seconds")
    ap.add_argument("--once", action="store_true",
                    help="evaluate a single snapshot and exit")
    ap.add_argument("--json", default=None,
                    help="write the event log + final snapshot as "
                         "JSON to this path ('-' for stdout)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the live event lines")
    args = ap.parse_args(argv)

    rep = load_report_module()
    al = load_alerts_module()
    if not os.path.isdir(args.journal):
        print(f"rwatch: {args.journal!r} is not a directory",
              file=sys.stderr)
        return 2
    try:
        rules = al.rules_from_spec(args.rules)
    except ValueError as err:
        print(f"rwatch: {err}", file=sys.stderr)
        return 2
    try:
        code, result = watch(
            rep, al, args.journal, rules=rules, interval=args.interval,
            timeout=args.timeout, once=args.once, quiet=args.quiet)
    except KeyboardInterrupt:
        # An interrupted watch never reached its verdict; a CI/daemon
        # gate must not read the interruption as "clean" (130 = the
        # conventional SIGINT exit).
        print("rwatch: interrupted before the run completed",
              file=sys.stderr)
        return 130
    if not args.quiet:
        status = ("timed out before completion" if result["timed_out"]
                  else "run complete" if result["complete"]
                  else "single snapshot")
        tail = (f"; UNRESOLVED: {', '.join(result['unresolved'])}"
                if result["unresolved"] else "; all alerts resolved"
                if result["events"] else "; no alerts fired")
        print(f"rwatch: {status} — {len(result['events'])} event(s)"
              + tail)
    if args.json:
        payload = json.dumps(result, indent=2, default=str)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as fobj:
                fobj.write(payload + "\n")
    return code


if __name__ == "__main__":
    sys.exit(main())
