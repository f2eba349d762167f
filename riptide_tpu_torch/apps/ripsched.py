"""
ripsched: schedule-exploration model checking of the port's concurrency
protocols (``riptide_tpu_torch/analysis/sched.py``).

Explores the thread interleavings of six models built from the port's
REAL protocol code (the FairShareQueue with its drain and its
``lose_device``, the TenantTable charge path, the StagingPool release
discipline and its event-gated reuse, the runctx layer, and a mirrored
integrity-quarantine latch) under iterative preemption bounding. Every
decision sequence is a replayable schedule ID; a violation prints the
minimal failing schedule and its ``--replay`` line.

The pinned ``riptide_tpu_torch/analysis/ripsched_invariants.json`` states
what this check proves (models, invariants, mutations). The CLI refuses
to run while it drifts from the registry in sched.py: re-pin a
deliberate change with ``--write-specs`` and commit the diff.

Exit status 0 when every explored schedule of every selected model holds
all invariants; 1 on any violation (or a ``--replay`` that reproduces
one); 2 on usage errors, spec drift or a replay whose digits no longer
match the model (divergence).

``--mutate NAME`` re-arms a known-bad code shape and EXPECTS the
violation (the non-vacuity check). ``--format sarif`` writes one SARIF
2.1.0 run (``analysis/sarif.py``, rprove's writer too).

Defaults come from the envflags registry: ``RIPTIDE_SCHED_BOUND``
(preemption bound), ``RIPTIDE_SCHED_SEED`` (exploration-order seed) and
``RIPTIDE_SCHED_REPLAY`` (a schedule ID to replay instead of exploring).

    python -m riptide_tpu_torch.apps.ripsched [--model NAME ...]
        [--mutate NAME] [--bound N] [--replay ID] [--list]
        [--format text|sarif] [--write-specs]
"""
import argparse
import json
import os
import sys

from ..analysis import sched as _sched
from ..analysis.sarif import sarif_doc

DEFAULT_SPECS = os.path.join(os.path.dirname(_sched.__file__),
                             "ripsched_invariants.json")
SPECS_REL = "riptide_tpu_torch/analysis/ripsched_invariants.json"


def _sarif_findings(sched_mod, violations):
    out = []
    for vio in violations:
        path = sched_mod.MODELS[vio.model].targets[0]
        out.append({
            "rule": sched_mod.sarif_rule_of(vio.invariant),
            "path": path,
            "line": 1,
            "col": 0,
            "message": (
                f"[{vio.invariant}] {vio.message} — replay with "
                f"`python -m riptide_tpu_torch.apps.ripsched --replay "
                f"'{vio.schedule_id}'`"),
        })
    return out


def _emit_sarif(sched_mod, violations, out):
    doc = sarif_doc(_sarif_findings(sched_mod, violations),
                    sched_mod.SARIF_RULES, "ripsched")
    json.dump(doc, out, indent=2)
    out.write("\n")


def check_specs(sched_mod, specs_path, err):
    """0 when the pinned invariant spec matches the registry; 2 (with
    the re-pin instruction) on drift or a missing file."""
    want = sched_mod.spec_doc()
    if not os.path.exists(specs_path):
        print(f"ripsched: no invariant spec at {specs_path!r}; run "
              "`python -m riptide_tpu_torch.apps.ripsched --write-specs` "
              "and commit it", file=err)
        return 2
    try:
        with open(specs_path) as fobj:
            have = json.load(fobj)
    except (OSError, ValueError) as exc:
        print(f"ripsched: unreadable invariant spec {specs_path!r}: "
              f"{exc}", file=err)
        return 2
    if have != want:
        print(f"ripsched: {SPECS_REL} drifted from the model registry "
              "in riptide_tpu_torch/analysis/sched.py — after a DELIBERATE "
              "model/invariant change, re-pin with `python -m "
              "riptide_tpu_torch.apps.ripsched --write-specs` and commit "
              "the diff", file=err)
        return 2
    return 0


def write_specs(sched_mod, specs_path, err):
    with open(specs_path, "w") as fobj:
        json.dump(sched_mod.spec_doc(), fobj, indent=1, sort_keys=True)
        fobj.write("\n")
    doc = sched_mod.spec_doc()
    n_inv = sum(len(m["invariants"]) for m in doc["models"].values())
    print(f"pinned {len(doc['models'])} model(s) / {n_inv} "
          f"invariant(s) to {specs_path}", file=err)
    return 0


def _list_models(sched_mod, out):
    for name, spec in sorted(sched_mod.MODELS.items()):
        print(f"{name}: {spec.description}", file=out)
        print(f"  targets: {', '.join(spec.targets)}", file=out)
        for inv, desc in spec.invariants:
            print(f"  invariant {inv} "
                  f"[{sched_mod.sarif_rule_of(inv)}]: {desc}", file=out)
        for mut, desc in sorted(spec.mutations.items()):
            print(f"  mutation {mut}: {desc}", file=out)
    return 0


def run(models=None, mutation=None, bound=None, seed=None,
        replay_id=None, max_schedules=None, fmt="text",
        specs_path=DEFAULT_SPECS, do_write_specs=False, list_only=False,
        out=sys.stdout, err=sys.stderr):
    """Explore (or replay / pin / list), emit, return the exit code."""
    sched_mod = _sched
    if do_write_specs:
        return write_specs(sched_mod, specs_path, err)
    if list_only:
        return _list_models(sched_mod, out)
    rc = check_specs(sched_mod, specs_path, err)
    if rc:
        return rc

    if replay_id is None:
        replay_id = sched_mod.env_default("RIPTIDE_SCHED_REPLAY")
    if replay_id:
        try:
            res = sched_mod.replay(replay_id)
        except ValueError as exc:
            print(f"ripsched: {exc}", file=err)
            return 2
        print(res.render(), file=out)
        if res.diverged is not None:
            return 2
        return 1 if res.violation is not None else 0

    if models is None:
        names = sorted(sched_mod.MODELS)
    else:
        names = models
        for name in names:
            if name not in sched_mod.MODELS:
                print(f"ripsched: unknown model {name!r} (known: "
                      f"{sorted(sched_mod.MODELS)})", file=err)
                return 2
    if mutation is not None and len(names) != 1:
        print("ripsched: --mutate needs exactly one --model", file=err)
        return 2

    violations = []
    total_schedules = total_decisions = 0
    capped = []
    for name in names:
        try:
            res = sched_mod.explore_model(
                name, mutation=mutation, bound=bound, seed=seed,
                max_schedules=max_schedules,
                log=lambda msg: print(msg, file=err))
        except ValueError as exc:
            print(f"ripsched: {exc}", file=err)
            return 2
        total_schedules += res.schedules
        total_decisions += res.decisions
        if res.capped:
            capped.append(name)
        if res.violation is not None:
            violations.append(res.violation)

    if fmt == "sarif":
        _emit_sarif(sched_mod, violations, out)
    else:
        for vio in violations:
            print(vio.render(), file=out)

    tag = "+".join(filter(None, [",".join(names), mutation]))
    if violations:
        print(f"ripsched: {len(violations)} invariant violation(s) in "
              f"{tag} ({total_schedules} schedule(s) explored)",
              file=err)
        return 1
    note = f" (CAPPED: {', '.join(capped)})" if capped else ""
    print(f"ripsched OK: {tag}: {total_schedules} schedule(s) / "
          f"{total_decisions} decision(s) explored to the preemption "
          f"bound, zero violations{note}", file=err)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ripsched", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--model", action="append", dest="models",
                    metavar="NAME",
                    help="model(s) to explore (repeatable; default: "
                         "all). See --list.")
    ap.add_argument("--mutate", default=None, metavar="NAME",
                    help="re-arm a named known-bad mutation in the "
                         "selected model (requires exactly one "
                         "--model); the run is EXPECTED to exit 1 "
                         "with a minimal schedule")
    ap.add_argument("--bound", type=int, default=None,
                    help="preemption bound (default: "
                         "RIPTIDE_SCHED_BOUND)")
    ap.add_argument("--seed", type=int, default=None,
                    help="exploration-order seed (default: "
                         "RIPTIDE_SCHED_SEED); replay never depends "
                         "on it")
    ap.add_argument("--replay", default=None, metavar="ID",
                    help="re-execute one recorded schedule ID "
                         "deterministically instead of exploring "
                         "(default: RIPTIDE_SCHED_REPLAY)")
    ap.add_argument("--max-schedules", type=int, default=None,
                    help="schedule cap per (model, mutation); hitting "
                         "it is reported, never silent (0 = unlimited)")
    ap.add_argument("--format", choices=("text", "sarif"),
                    default="text", dest="fmt",
                    help="output format: human text (default) or one "
                         "SARIF 2.1.0 run")
    ap.add_argument("--specs", default=DEFAULT_SPECS,
                    help="pinned invariant spec (default "
                         f"{SPECS_REL})")
    ap.add_argument("--write-specs", action="store_true",
                    help="re-pin the invariant spec from the model "
                         "registry (commit the diff)")
    ap.add_argument("--list", action="store_true", dest="list_only",
                    help="list models, invariants and mutations")
    args = ap.parse_args(argv)
    return run(models=args.models, mutation=args.mutate,
               bound=args.bound, seed=args.seed, replay_id=args.replay,
               max_schedules=args.max_schedules, fmt=args.fmt,
               specs_path=args.specs, do_write_specs=args.write_specs,
               list_only=args.list_only)


if __name__ == "__main__":
    sys.exit(main())
