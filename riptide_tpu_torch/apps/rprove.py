"""
rprove: verify the launch contracts of the search plans.

Walks every search the engine queues for the representative plan set
(``riptide_tpu_torch.ops.plan.CONTRACT_PLANS``) on the ``meta`` device,
shapes only (no card; see ``riptide_tpu_torch/analysis/launch_contract.py``),
and compares the launch contracts (launch counts by wrapper and CUDA
kernel, the dtype flow, the declared storage reuses, the transfers, the
peak-memory model) with the pinned
``riptide_tpu_torch/analysis/plan_contracts.json``.

Exit status 0 on no drift; 1 on any drift or absolute violation (a
float64 tensor on the device side, a dropped reuse, K2 on a quantised
wire, a wire that ships other bytes than its contract); 2 when the
contract file is missing. After a deliberate change, re-pin with
``--update`` and commit the diff.

``--all`` adds the slow-tier (survey-shaped) plan; ``--plans A,B`` (or
``RIPTIDE_PROVE_PLANS``) restricts to named plans; ``--format sarif``
writes one SARIF 2.1.0 run. Contracts are pinned under the default
flags: the flags that change launches or container heights are dropped
from the environment first.

    python -m riptide_tpu_torch.apps.rprove [--update] [--all]
        [--plans A,B] [--format text|sarif] [--contracts PATH]
"""
import argparse
import json
import os
import sys

from ..analysis import launch_contract as lc
from ..ops.plan import CONTRACT_PLANS, contract_plan_params
from ..utils import envflags


def build_current(names=None, tiers=("fast",)):
    """Freshly extracted contracts of the selected plans, under the
    default flags (the contract-changing ones dropped from the
    environment)."""
    for k in lc.CONTRACT_FLAGS:
        os.environ.pop(k, None)
    out = {}
    for spec in contract_plan_params(names, tiers=tiers):
        plan = lc.build_contract_plan(spec)
        out[spec["name"]] = lc.extract_contract(plan, spec["wire"])
    return out


def run(contracts_path=lc.CONTRACTS_PATH, names=None, all_tiers=False,
        update=False, fmt="text", out=sys.stdout, err=sys.stderr):
    """Extract, then compare (or re-pin) and report; returns the exit
    code."""
    tiers = ("fast", "slow") if all_tiers else ("fast",)
    current = build_current(names, tiers)
    all_names = [s["name"] for s in CONTRACT_PLANS]
    pinned = lc.load_contracts(contracts_path)

    if update:
        doc = pinned or {"version": 1, "plans": {}}
        doc["plans"].update(current)
        doc["plans"] = {k: v for k, v in sorted(doc["plans"].items())
                        if k in all_names}
        with open(contracts_path, "w") as fobj:
            json.dump(doc, fobj, indent=1, sort_keys=True)
            fobj.write("\n")
        print(f"pinned {len(current)} contract(s) ({len(doc['plans'])} "
              f"total) to {contracts_path}", file=err)
        return 0

    if pinned is None:
        print(f"rprove: no contract file at {contracts_path!r}; run "
              "`python -m riptide_tpu_torch.apps.rprove --update --all` "
              "and commit it", file=err)
        return 2

    findings = lc.check_contracts(pinned, current, all_names)
    if fmt == "sarif":
        from ..analysis.sarif import sarif_doc

        json.dump(sarif_doc(findings, lc.RULES, "rprove"), out, indent=2)
        out.write("\n")
    else:
        for f in findings:
            print(f"{f['path']}:{f['line']}:{f['col']}: {f['rule']} "
                  f"{f['message']}", file=out)
    n_launch = sum(sum(c["dispatch_total"].values())
                   for c in current.values())
    for name, c in sorted(current.items()):
        if not c["reuse"]["declared"]:
            print(f"rprove: plan {name!r} declares no storage reuse (every "
                  "level runs in the segment kernel's tiles, so no launch "
                  "reaches the ping-pong); its contract pins the empty set",
                  file=err)
    if findings:
        print(f"rprove: {len(findings)} contract violation(s) over "
              f"{len(current)} plan(s)", file=err)
        return 1
    print(f"rprove OK: {len(current)} plan contract(s) verified "
          f"({n_launch} launches walked, zero drift)", file=err)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rprove", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--contracts", default=lc.CONTRACTS_PATH,
                    help="pinned contract file (default "
                         f"{lc.CONTRACT_REL})")
    ap.add_argument("--update", action="store_true",
                    help="re-pin the selected plans' contracts")
    ap.add_argument("--all", action="store_true", dest="all_tiers",
                    help="include the slow-tier (survey-shaped) plan")
    ap.add_argument("--plans", default=None,
                    help="comma-separated plan names (default: the "
                         "RIPTIDE_PROVE_PLANS flag, else every plan of "
                         "the selected tiers)")
    ap.add_argument("--format", choices=("text", "sarif"), default="text",
                    dest="fmt", help="findings as text lines (default) or "
                                     "one SARIF 2.1.0 run")
    args = ap.parse_args(argv)
    plans = args.plans or envflags.get("RIPTIDE_PROVE_PLANS")
    names = [p.strip() for p in plans.split(",") if p.strip()] \
        if plans else None
    return run(contracts_path=args.contracts, names=names,
               all_tiers=args.all_tiers, update=args.update, fmt=args.fmt)


if __name__ == "__main__":
    sys.exit(main())
