"""
The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in the nearest
precision below the configuration's, read by the same comparison. It
has to come out as not correct.

    python3 -m portbench.control --workload <name> --seeds 11 12 13

For each seed it makes the cell's ring slots (``portbench/traffic.py``)
and their sampled trials, as a run of the cell does, and prints one
JSON line a seed, search range and control: the numbers ``snr_rms``,
``snr_max`` and ``peaks_bad`` against the cell's limits, under the
range's names (``portbench/check.py::named``). Two controls: ``bfloat16``
(the FFA and the S/N in bfloat16 for the configuration's float32) and
``int4`` (a 4-bit wire, ``qmax`` 7, for the configuration's uint6). The
benchmark's own runs never run it.
"""
import argparse
import json
import sys

import numpy as np
import torch

from . import cell, check, traffic
from .ranges import ranges
from .reference import search as ref

CONTROLS = {"bfloat16": {"dtype": torch.bfloat16},
            "int4": {"qmax": 7}}


def sampled_series(cfg, mix, limits, seed, device):
    """{slot: (trials, (k, N) float32 raw series)} as a run samples
    them."""
    D = int(mix["dm_trials"])
    out = {}
    for slot in range(int(mix["ring"])):
        idx = traffic.sample_trials(D, int(limits["sample_trials"]), seed,
                                    slot)
        x = traffic.make_chunk(cfg, mix, seed, slot, device)
        out[slot] = (idx, x[idx].cpu().numpy())
        del x
    return out


def control_numbers(cfg, stages, widths, raw, want, device, **lower):
    """The comparison's numbers for the reference computed with
    ``lower`` (``dtype`` or ``qmax``) in the program's place, against
    ``want``, the reference's S/N of the ``raw`` series. Its peaks
    would be the reference's own ``find_peaks`` of its S/N, which judges
    them, so ``peaks_bad`` is 0 by construction: the S/N must fail."""
    got = check.reference_snr(raw, stages, widths, ref.wire_row(
        cfg["bins_max"]), device, **lower)
    rms, mx = check.snr_gaps(got, want)
    return {"snr_rms": rms, "snr_max": mx, "peaks_bad": 0}


def control_lines(cfg, mix, limits, seeds, device):
    """For each seed, search range and control, in that order: (seed,
    control, the numbers beside their limits under the range's names,
    whether all are within them)."""
    rs = [(name, rcfg, *cell.plan_of(rcfg)[1:])
          for name, rcfg in ranges(cfg)]
    for seed in seeds:
        series = sampled_series(cfg, mix, limits, seed, device)
        raw = np.concatenate([series[s][1] for s in sorted(series)])
        for rname, rcfg, widths, stages in rs:
            want = check.reference_snr(raw, stages, widths,
                                       ref.wire_row(rcfg["bins_max"]),
                                       device)
            for name, lower in CONTROLS.items():
                nums = check.named(control_numbers(
                    rcfg, stages, widths, raw, want, device, **lower), rname)
                yield (seed, name, *check.numbers_line(nums,
                                                       limits["limits"]))
            del want


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    wl, cfg, mix, limits, _ = cell.load_cell(args.workload)
    failed_all = True
    for seed, name, line, ok in control_lines(cfg, mix, limits, args.seeds,
                                              torch.device(args.device)):
        failed_all = failed_all and not ok
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "control": name, "correct": ok, "checks": line}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
