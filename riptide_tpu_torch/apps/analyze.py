#!/usr/bin/env python
"""
analyze: the port's whole static surface in ONE SARIF document (the
counterpart of the JAX package's ``tools/analyze.py``).

Runs the port's three verification passes, each in a subprocess of its
own —

* **riplint** (``apps/riplint.py --format sarif``, by path): the 14
  AST/call-graph analyzers against the port's baseline;
* **rprove** (``python -m riptide_tpu_torch.apps.rprove --format
  sarif``): the launch contracts of the search plans, walked on the
  ``meta`` device (no card);
* **ripsched** (``python -m riptide_tpu_torch.apps.ripsched --format
  sarif``): the schedule-exploration model checker over the port's
  protocols —

and merges their SARIF 2.1.0 runs into one multi-run document (one
``runs[]`` entry per tool, rule metadata preserved). This script
imports neither torch nor numpy itself.

Usage::

    python -m riptide_tpu_torch.apps.analyze [OUT.sarif]
    python riptide_tpu_torch/apps/analyze.py [OUT.sarif]

The default output is ``riptide_tpu_torch/_build/riptide_torch.sarif``
(git-ignored). Exit code: the MAXIMUM of the three tools' exit codes
(0 all clean; 1 any finding or violation; 2 a usage error or a missing
pin).
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
DEFAULT_OUT = os.path.join(REPO, "riptide_tpu_torch", "_build",
                           "riptide_torch.sarif")

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

# (tool name, argv after the interpreter)
TOOLS = (
    ("riplint", [os.path.join(HERE, "riplint.py"), "--format", "sarif"]),
    ("rprove", ["-m", "riptide_tpu_torch.apps.rprove", "--format",
                "sarif"]),
    ("ripsched", ["-m", "riptide_tpu_torch.apps.ripsched", "--format",
                  "sarif"]),
)


def main(out_path=DEFAULT_OUT, tools=TOOLS):
    merged = {"version": "2.1.0", "$schema": SARIF_SCHEMA, "runs": []}
    worst = 0
    for name, argv in tools:
        proc = subprocess.run([sys.executable, *argv], capture_output=True,
                              text=True, cwd=REPO)
        worst = max(worst, proc.returncode)
        sys.stderr.write(proc.stderr)
        try:
            doc = json.loads(proc.stdout)
        except ValueError:
            # A tool that died before emitting SARIF has no run to
            # merge; its stderr and exit code carry the diagnosis.
            print(f"analyze: {name} exited {proc.returncode} without "
                  "SARIF output", file=sys.stderr)
            worst = max(worst, 1)
            continue
        runs = doc.get("runs", [])
        merged["runs"].extend(runs)
        n_results = sum(len(r.get("results", [])) for r in runs)
        n_rules = sum(len(r["tool"]["driver"].get("rules", []))
                      for r in runs)
        print(f"analyze: {name}: {n_rules} rule(s), {n_results} "
              f"result(s), exit {proc.returncode}", file=sys.stderr)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fobj:
        json.dump(merged, fobj, indent=2)
        fobj.write("\n")
    total = sum(len(r.get("results", [])) for r in merged["runs"])
    print(f"analyze: {len(merged['runs'])} run(s) merged into "
          f"{os.path.relpath(out_path, REPO)} ({total} total "
          f"result(s)); exit {worst}", file=sys.stderr)
    return worst


def cli(argv=None):
    ap = argparse.ArgumentParser(
        prog="analyze", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT,
                    help="merged SARIF file (default riptide_tpu_torch/"
                         "_build/riptide_torch.sarif)")
    return main(ap.parse_args(argv).out)


if __name__ == "__main__":
    sys.exit(cli())
