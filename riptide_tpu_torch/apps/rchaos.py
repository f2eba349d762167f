#!/usr/bin/env python
"""
rchaos: the seeded storage-chaos campaign CLI (the port's copy of the
JAX package's ``tools/rchaos.py``).

Writes the campaign's three PRESTO DM trials (12 s at 1 ms, a 0.5 s
pulsar of amplitude 30, DMs 0, 5 and 10, seed 0), then runs every chaos
schedule from :mod:`riptide_tpu_torch.survey.chaos` — subprocess legs
on one device that are killed mid-write at journal/ledger/peak-store
boundaries, restarted with resume, and degraded with
ENOSPC/fsync/torn-write faults on the observability paths, a corrupted
build-cache library and flipped result bytes, and the survey service's
daemon killed, drained and fed a device error mid-job — asserting after
each schedule:

* byte-identical ``peaks.csv`` vs the fault-free control run;
* a consistent resumed journal (one record per chunk, no torn/corrupt
  lines, phase sums within tolerance, no orphaned peak rows);
* a perf-ledger row for the completed run;
* an incident record per injected fault and zero uncaught exceptions;
* every leg on the asked device, and K1 launched by every ``cuda`` leg
  that searched a chunk;
* control-run byte transparency (recovery/report passes change no
  bytes; ledger rows stay plain JSON).

Usage::

    python -m riptide_tpu_torch.apps.rchaos [--device cuda|cpu]
        [--outdir DIR] [--sweep N] [--seed S] [--keep] [--list]
    python riptide_tpu_torch/apps/rchaos.py ...

``--sweep N`` appends N seeded schedules to the fixed builtin set
(defaults: RIPTIDE_CHAOS_SWEEP / RIPTIDE_CHAOS_SEED). Exit 0 on a clean
campaign, 1 on any violated invariant (the working directory is kept
for post-mortem).
"""
import argparse
import os
import shutil
import sys
import time

if not __package__:   # run by path: import the checkout's package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def main(argv=None):
    from riptide_tpu_torch.survey import chaos
    from riptide_tpu_torch.utils import envflags

    parser = argparse.ArgumentParser(
        prog="rchaos",
        description="storage-chaos campaign over the survey scheduler")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device every leg runs on (default cuda; no "
                             "fallback)")
    parser.add_argument("--outdir", default=None,
                        help="campaign working directory (default "
                             "RIPTIDE_CHAOS_DIR or a fixed tempdir)")
    parser.add_argument("--sweep", type=int, default=None,
                        help="extra seeded schedules beyond the builtin "
                             "set (default RIPTIDE_CHAOS_SWEEP)")
    parser.add_argument("--seed", type=int, default=None,
                        help="sweep seed (default RIPTIDE_CHAOS_SEED)")
    parser.add_argument("--keep", action="store_true",
                        help="keep the working directory on success too")
    parser.add_argument("--list", action="store_true",
                        help="print the schedule set and exit")
    args = parser.parse_args(argv)

    seed = args.seed if args.seed is not None \
        else envflags.get("RIPTIDE_CHAOS_SEED")
    sweep = args.sweep if args.sweep is not None \
        else envflags.get("RIPTIDE_CHAOS_SWEEP")
    schedules = chaos.builtin_schedules() + chaos.seeded_schedules(seed,
                                                                   sweep)
    if args.list:
        for s in schedules:
            faults = " | ".join(leg.get("faults") or "-"
                                for leg in s["legs"])
            print(f"{s['name']:<26} {len(s['legs'])} leg(s)  {faults}")
        return 0

    outdir = args.outdir or chaos.default_workdir()
    keep = args.keep or chaos.default_keep()
    shutil.rmtree(outdir, ignore_errors=True)
    files = chaos.write_trials(os.path.join(outdir, "data"))

    t0 = time.monotonic()
    try:
        summary = chaos.run_campaign(files, outdir, schedules=schedules,
                                     device=args.device)
    except chaos.ChaosFailure as err:
        print(f"\nchaos campaign FAILED: {err}", file=sys.stderr)
        print(f"  artifacts kept under {outdir}", file=sys.stderr)
        return 1
    elapsed = time.monotonic() - t0
    for s in summary["per_schedule"]:
        print(f"  {s['name']:<26} {s['legs']} leg(s) {s['wall_s']:7.2f} s, "
              f"K1 launches {s['k1_launches']}")
    print(f"\nchaos campaign OK on {args.device}: {summary['schedules']} "
          f"schedule(s), {summary['legs']} leg(s) in {elapsed:.1f}s")
    print("  every schedule ended byte-identical to the fault-free "
          "control run,\n  with a consistent resumed journal, a ledger "
          "row, and an incident per fault")
    if keep:
        print(f"  artifacts kept under {outdir}")
    else:
        shutil.rmtree(outdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
