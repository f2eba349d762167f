#!/usr/bin/env python
"""
rreport: post-run report + CI regression sentinel over a survey journal
(the port's copy of the JAX package's ``tools/rreport.py``).

Merges a journal directory's artifacts — per-chunk ``timing`` blocks,
structured ``incident`` records, dq blocks, an optional ``trace.json``
and an optional Prometheus textfile — into one report:

* phase-attribution table (the serial phases must sum to each chunk's
  journaled wall-clock within 5%; a violation means a broken writer
  and exits nonzero),
* straggler chunks (> 2x the median wall-clock),
* the per-chunk transfer-rate distribution, with the per-chunk
  transfer/device bound split,
* the incident timeline (with chunk + span ids),
* with ``--compare LEDGER``: a noise-aware regression verdict of this
  run's device seconds per chunk against the perf-ledger history
  (transfer-bound rows excluded on both sides; band = baseline median
  * (1 + rel-tol) + mad-k * MAD), scoped by default to the platform of
  the ledger's newest row (the port's rows: ``cuda`` and the card's
  name). Exit 1 on regression — point CI at it.

Usage::

    python -m riptide_tpu_torch.apps.rreport JDIR [--trace PATH]
        [--prom PATH] [--json PATH] [--compare LEDGER] [--rel-tol 0.15]
        [--mad-k 3.0] [--quiet]
    python riptide_tpu_torch/apps/rreport.py JDIR ...

Exit codes: 0 clean / comparison ok / nothing to compare against;
1 regression or phase-sum violation; 2 usage or unreadable input.

Loads ``riptide_tpu_torch/obs/report.py`` standalone by file path, so
run by path it needs no torch: it works on a login node holding only
the journal files. Pointed at a survey-service directory (one holding
a ``jobs.jsonl`` registry) it prints the per-job table and exits 0;
each job's own journal stays rreport-able at ``jobs/<id>/``.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_standalone(name, relpath):
    """A stdlib-only module of the port loaded by file path, so that
    importing it never drags in torch (or riptide_tpu_torch/__init__)."""
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.normpath(os.path.join(HERE, "..", *relpath))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def load_report_module():
    """riptide_tpu_torch.obs.report, loaded standalone."""
    return _load_standalone("riptide_tpu_torch_obs_report_standalone",
                            ("obs", "report.py"))


def is_serve_dir(directory):
    """Whether ``directory`` is a survey-service root (it holds the
    ``jobs.jsonl`` job registry)."""
    return os.path.exists(os.path.join(directory, "jobs.jsonl"))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rreport",
        description="Post-run report + regression sentinel over a "
                    "survey journal directory.",
    )
    ap.add_argument("journal", help="journal directory (holds "
                                    "journal.jsonl)")
    ap.add_argument("--trace", default=None,
                    help="Chrome trace file to summarise (default: "
                         "trace.json next to the journal, when present)")
    ap.add_argument("--prom", default=None,
                    help="Prometheus textfile to fold into the JSON "
                         "report")
    ap.add_argument("--json", default=None,
                    help="write the full report (+ verdict) as JSON to "
                         "this path ('-' for stdout)")
    ap.add_argument("--compare", default=None, metavar="LEDGER",
                    help="perf-ledger JSONL to compare this run's "
                         "device time per chunk against (exit 1 on "
                         "regression)")
    ap.add_argument("--kind", default="survey",
                    help="ledger row kind the baseline is drawn from "
                         "(default 'survey'; 'any' disables the "
                         "filter — bench and survey rows are not "
                         "comparable perf points)")
    ap.add_argument("--platform", default="auto",
                    help="restrict the baseline to rows of one device "
                         "platform: 'auto' (default) scopes to the "
                         "newest matching row's platform — normally "
                         "this run's own append, so cpu smoke rows "
                         "never baseline a card's check; 'any' disables; "
                         "or 'backend[:device_kind]' literally")
    ap.add_argument("--rel-tol", type=float, default=0.15,
                    help="relative regression tolerance over the "
                         "baseline median (default 0.15)")
    ap.add_argument("--mad-k", type=float, default=3.0,
                    help="how many baseline median-absolute-deviations "
                         "widen the band (default 3.0)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human report (exit code + JSON "
                         "only)")
    args = ap.parse_args(argv)

    rep = load_report_module()
    if not os.path.exists(os.path.join(args.journal, "journal.jsonl")):
        if is_serve_dir(args.journal):
            # A survey-service directory: group its artifacts per job.
            print("\n".join(rep.render_jobs_text(
                rep.job_table(args.journal))))
            return 0
        print(f"rreport: no journal.jsonl under {args.journal!r}",
              file=sys.stderr)
        return 2

    report = rep.build_report(args.journal, trace_path=args.trace,
                              prom_path=args.prom)
    rc = 0
    if report["phase_sum_violations"]:
        # The writer guarantees the sum by construction; a violation is
        # a broken producer, which CI must surface.
        rc = 1

    verdict = None
    if args.compare:
        if not os.path.exists(args.compare):
            print(f"rreport: ledger {args.compare!r} not found",
                  file=sys.stderr)
            return 2
        rows = rep.read_ledger(args.compare)
        kind = None if args.kind == "any" else args.kind
        # Platform scope resolves BEFORE the own-row drop: the run's
        # own just-appended row is the best available record of the
        # platform this run actually executed on.
        if args.platform == "auto":
            platform = rep.latest_platform(rows, kind=kind)
        elif args.platform == "any":
            platform = None
        else:
            backend, _, device_kind = args.platform.partition(":")
            platform = {"backend": backend,
                        "device_kind": device_kind or None}
        rows, own_dropped = rep.drop_own_row(rows,
                                             report.get("survey_id"))
        verdict, cmp_rc = rep.compare_to_ledger(
            report["run"], rows, rel_tol=args.rel_tol, mad_k=args.mad_k,
            kind=kind, platform=platform)
        verdict["own_row_excluded"] = own_dropped
        report["compare"] = verdict
        rc = max(rc, cmp_rc)

    if not args.quiet:
        sys.stdout.write(rep.render_text(report))
        if verdict is not None:
            v = verdict["verdict"]
            line = f"compare vs {args.compare}: {v}"
            if verdict.get("current") is not None:
                line += (f" (device {verdict['current']}s/chunk"
                         + (f" vs baseline median "
                            f"{verdict['baseline_median']}s, "
                            f"threshold {verdict['threshold']}s"
                            if "baseline_median" in verdict else "")
                         + ")")
            print(line)

    if args.json:
        payload = json.dumps(report, indent=2, default=str)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as fobj:
                fobj.write(payload + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
