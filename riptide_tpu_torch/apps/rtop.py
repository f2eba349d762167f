#!/usr/bin/env python
"""
rtop: live terminal view of a survey running in ANOTHER process (the
port's copy of the JAX package's ``tools/rtop.py``).

Tail-reads the journal directory's artifacts — ``journal.jsonl``
(chunk / parked / incident records; successive frames re-read and
parse only newly appended bytes from a remembered offset, and the
per-frame aggregation runs over the in-memory state, never back over
the file) and the ``heartbeat_*.jsonl`` sidecars — the same files the
run is already fsync-appending, so watching costs the run nothing and
needs no endpoint (use the ``/status`` HTTP surface when
``RIPTIDE_PROM_PORT`` is up; rtop is the no-network fallback).

Shows chunk progress (done / parked / total with a bar), the recent
chunk rate and ETA, the transfer/device bound split, per-process
heartbeat ages, and the tail of the incident timeline.

Usage::

    python -m riptide_tpu_torch.apps.rtop JDIR [--interval 2.0] [--once]
    python riptide_tpu_torch/apps/rtop.py JDIR ...

``--once`` prints a single frame and exits (scripts/tests); otherwise
the frame redraws every ``--interval`` seconds until Ctrl-C. Run by
path it loads the torch-free reader standalone, so it runs anywhere the
journal files are visible (e.g. over a shared filesystem while the
survey runs on the card's host). Pointed at a survey-service
directory it shows the per-job table instead (point it at a
``jobs/<id>/`` subdirectory to watch one job's survey the ordinary way).
"""
import argparse
import os
import sys
import time

if __package__:
    from .rreport import is_serve_dir, load_report_module
else:   # run by path: the sibling module, not the package
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rreport import is_serve_dir, load_report_module

# Recent chunks the rate estimate averages over.
RATE_WINDOW = 8
# Incident lines shown.
INCIDENT_TAIL = 5


def _bar(frac, width=32):
    full = int(round(max(0.0, min(1.0, frac)) * width))
    return "[" + "#" * full + "-" * (width - full) + "]"


def render_frame(rep, journal_dir, now=None, follower=None,
                 show_fleet=False):
    """One frame of the progress view as a string (a function of the
    on-disk journal state — the unit tests call it directly). The live
    loop passes a persistent ``JournalFollower`` so successive frames
    only parse newly appended records; without one the journal is read
    whole (the --once path). With fleet sidecars present the frame
    carries a one-line fleet summary; ``show_fleet`` (the ``--fleet``
    flag) expands it to per-process rows with straggler/stale/breaker
    highlighting. Journals without sidecars render exactly as before."""
    now = time.time() if now is None else now
    j = (follower.poll() if follower is not None
         else rep.read_journal(journal_dir))
    header = j["header"] or {}
    chunks = j["chunks"]
    total = header.get("chunks_total")
    done, parked = len(chunks), len(j["parked"])

    lines = [f"rtop — survey {header.get('survey_id', '<no header>')} "
             f"({os.path.abspath(journal_dir)})"]

    walls = [float((chunks[cid].get("timings") or {}).get("chunk_s", 0.0))
             for cid in sorted(chunks)]
    walls = [w for w in walls if w > 0][-RATE_WINDOW:]
    rate = eta = None
    if walls:
        mean = sum(walls) / len(walls)
        if mean > 0:
            rate = 1.0 / mean
            if total is not None:
                eta = max(0, total - done - parked) * mean
    progress = f"chunks {done}"
    if total is not None:
        progress += f"/{total}"
    if parked:
        progress += f" (+{parked} parked)"
    if rate is not None:
        progress += f"  {rate:.2f} chunk/s over last {len(walls)}"
    if eta is not None:
        progress += f"  ETA {eta:.0f}s"
    lines.append(progress)
    if total:
        frac = (done + parked) / total
        lines.append(f"{_bar(frac)} {100 * frac:.0f}%")

    tun = rep.tunnel_stats(chunks)
    if tun["bound_counts"]:
        split = ", ".join(f"{k}={v}" for k, v
                          in sorted(tun["bound_counts"].items()))
        line = f"bound: {split}"
        if tun.get("n_rates"):
            line += (f"  wire {tun['wire_MBps_median']} MB/s median "
                     f"({tun['wire_MBps_min']}-{tun['wire_MBps_max']})")
        lines.append(line)

    beats = rep.read_heartbeats(journal_dir)
    if beats:
        ages = ", ".join(
            f"p{p} {max(0.0, now - ts):.1f}s ago"
            for p, ts in sorted(beats.items()))
        lines.append(f"heartbeats: {ages}")

    snapshots = rep.read_fleet(journal_dir)
    if snapshots:
        fleet = rep.merge_fleet(snapshots, now=now)
        fleet_lines = rep.render_fleet_text(fleet)
        if show_fleet:
            lines.extend(fleet_lines)
        else:
            lines.append(fleet_lines[0] + "  (--fleet for per-process "
                                          "rows)")

    alerts = j.get("alerts") or []
    if alerts:
        firing = {}
        for al in alerts:
            firing[al.get("rule")] = al.get("event") == "fired"
        active = sorted(r for r, f in firing.items() if f)
        lines.append(
            f"alerts: {len(alerts)} event(s)"
            + (f", FIRING: {', '.join(active)}" if active
               else ", all resolved"))

    if j["incidents"]:
        lines.append(f"incidents ({len(j['incidents'])}):")
        for inc in j["incidents"][-INCIDENT_TAIL:]:
            where = (f" chunk {inc['chunk_id']}"
                     if "chunk_id" in inc else "")
            lines.append(f"  {inc.get('utc', '?')} "
                         f"{inc.get('incident', '?')}{where}")
    return "\n".join(lines) + "\n"


def render_serve_frame(rep, serve_dir):
    """One frame of the SERVICE view: the per-job table of a serve
    directory — tenant, status, chunk progress, queue wait, device
    seconds — instead of a single survey's chunk view."""
    rows = rep.job_table(serve_dir)
    running = sum(1 for r in rows if r.get("status") == "running")
    pending = sum(1 for r in rows if r.get("status") == "pending")
    lines = [f"rtop — survey service ({os.path.abspath(serve_dir)})",
             f"jobs: {len(rows)} total, {running} running, "
             f"{pending} pending"]
    lines.extend(rep.render_jobs_text(rows))
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rtop",
        description="Terminal progress view of a journaled survey "
                    "running in another process (tail-reads the "
                    "journal directory).",
    )
    ap.add_argument("journal", help="journal directory to watch")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    ap.add_argument("--fleet", action="store_true",
                    help="expand the fleet summary into per-process "
                         "rows (skew/staleness highlighting)")
    args = ap.parse_args(argv)

    rep = load_report_module()
    if not os.path.isdir(args.journal):
        print(f"rtop: {args.journal!r} is not a directory",
              file=sys.stderr)
        return 2
    serve_mode = is_serve_dir(args.journal)
    if args.once:
        sys.stdout.write(render_serve_frame(rep, args.journal)
                         if serve_mode
                         else render_frame(rep, args.journal,
                                           show_fleet=args.fleet))
        return 0
    follower = None if serve_mode else rep.JournalFollower(args.journal)
    try:
        while True:
            frame = (render_serve_frame(rep, args.journal) if serve_mode
                     else render_frame(rep, args.journal,
                                       follower=follower,
                                       show_fleet=args.fleet))
            # Clear + home, then the frame: a flicker-free-enough
            # redraw without a curses dependency.
            sys.stdout.write("\x1b[2J\x1b[H" + frame)
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
