"""
P3: the slot levels of a 1536-row container, timed and checked exactly.

The port of ``tools/probe1536.py`` (``pallas_call`` :84, body
``slot_level_kernel`` :49, one pass ``_one_pass`` :33). A base-3
container of R = 3 * 2**9 = 1536 rows splits, at slot level l
(NL < l <= L), into R / S_d groups of S_d = R >> (L - l) rows, each two
halves of S_c = S_d / 2 rows. One pass of a level is::

    out[g S_d + s, c] = x[g S_d + ((s + delta) mod S_d) // 2, c]
                      + x[g S_d + S_c + s // 2, c]

with delta = da - 2 for da = (w >> 22) & 3 in {0, 1, 3} and delta = 0
for da = 2: the interleave of the two halves, the delta select of the
head and the add. :func:`slot_level` runs NITER = 32 passes in one
launch (``csrc/probes.cu``): every pass is column-local and its gather
map is the same in every pass, so each source row is computed once.
The levels of :data:`~.common.SLOT_REG_LEVELS` (S_d = 12, 24, 48) run
in ``slot_regs_kernel``, one thread a group column with all S_d rows in
registers; the others in ``strip_kernel``, column strips of a whole
group in shared memory for all passes, up to S_d = 1536 (8192). The
pass is one gather and one add, so the card's result is exact, and each
level is held bit for bit against :func:`numpy_ref`, the tool's own
numpy sequence (copied here), as the tool does::

    python -m riptide_tpu_torch.probes.probe1536

``--rows/--cols/--depth/--niter`` change R, P, L and NITER;
``--device cpu`` runs the plain version on the CPU.
"""
import argparse
import sys

import numpy as np
import torch

from ..utils.device import resolve_device
from . import common

__all__ = ["slot_level", "slot_level_plain", "numpy_ref", "run", "main",
           "LAUNCHES", "reset_launches"]

R, P = 1536, 384
L, NL = 11, 3
NITER = 32

LAUNCHES = {"slot_level": 0}


def reset_launches():
    """Set every launch count to 0."""
    LAUNCHES["slot_level"] = 0


def numpy_ref(x, w, S_d):
    """One pass in numpy (``tools/probe1536.py::numpy_ref``, with R and P
    taken from x)."""
    R, P = x.shape
    G = R // S_d
    S_c = S_d // 2
    v = x.reshape(G, 2, S_c, P)
    reph = np.repeat(v[:, 0], 2, axis=1)
    w3 = w.reshape(G, S_d, P)
    da = (w3 >> 22) & 3
    head = reph.copy()
    for dv in (0, 1, 3):
        delta = dv - 2
        cand = np.roll(reph, -delta, axis=1)
        head = np.where(da == dv, cand, head)
    rept = np.repeat(v[:, 1], 2, axis=1)
    return (head + rept).reshape(R, P)


def _check_level(rows, S_d):
    if S_d < 2 or S_d % 2 or rows % S_d:
        raise ValueError(f"slot level S_d = {S_d}: want an even S_d that "
                         f"divides the {rows} rows")


def slot_level_plain(x, w, S_d, niter=NITER):
    """``niter`` passes of one slot level in plain PyTorch."""
    rows, cols = x.shape
    _check_level(rows, S_d)
    G, S_c = rows // S_d, S_d // 2
    da = ((w >> 22) & 3).reshape(G, S_d, cols)
    acc = x
    for _ in range(niter):
        v = acc.reshape(G, 2, S_c, cols)
        reph = v[:, 0].repeat_interleave(2, dim=1)
        head = reph
        for dv in (0, 1, 3):
            head = torch.where(da == dv, torch.roll(reph, 2 - dv, 1), head)
        acc = (head + v[:, 1].repeat_interleave(2, dim=1)).reshape(rows, cols)
    return acc


def slot_level(x, w, S_d, niter=NITER):
    """``niter`` passes of the slot level of S_d rows on x (R, P) float32
    with w (R, P) int32, in one launch: ``slot_regs_kernel`` for the
    levels of :data:`~.common.SLOT_REG_LEVELS`, ``strip_kernel`` for the
    others."""
    if x.device.type == "cpu":
        return slot_level_plain(x, w, S_d, niter)
    _check_level(x.shape[0], S_d)
    if S_d in common.SLOT_REG_LEVELS:
        out = common.slot_regs(x, w, S_d, niter)
    else:
        out = common.strip("p3.slot", x, S_d, niter, w)
    common.count(LAUNCHES, "slot_level")
    return out


def levels(rows=R, depth=L, nl=NL):
    """(l, S_d) of every slot level the tool probes."""
    return [(lv, rows >> (depth - lv)) for lv in range(nl + 1, depth + 1)]


def run(rows=R, cols=P, depth=L, niter=NITER, device=None):
    """Run, time and check every slot level on the tool's inputs
    (``np.random.default_rng(0)``: x normal, w in {0..3} << 22).
    Returns one :class:`~.common.Result` per level, ``ok`` its bitwise
    agreement with ``niter`` passes of :func:`numpy_ref`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    w = rng.integers(0, 4, (rows, cols), dtype=np.int32) << 22
    xd, wd = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    results = []
    for lv, S_d in levels(rows, depth):
        out, ms, call_ms = common.time_call(
            lambda: slot_level(xd, wd, S_d, niter), dev)
        want = x
        for _ in range(niter):
            want = numpy_ref(want, w, S_d)
        ok = bool(np.array_equal(out.cpu().numpy(), want))
        n = rows * cols
        results.append(common.Result(
            f"l={lv} S_d={S_d}", "slot_level", (xd, wd, S_d, niter), out, ms,
            call_ms, niter, 12 * n, 2 * n * niter, ok))
    return results


def main(argv=None):
    """Entry point; returns the run's results."""
    ap = argparse.ArgumentParser(
        prog="python -m riptide_tpu_torch.probes.probe1536",
        description="Time and check the slot levels of a 1536-row "
                    "container (P3).")
    ap.add_argument("--rows", type=int, default=R)
    ap.add_argument("--cols", type=int, default=P)
    ap.add_argument("--depth", type=int, default=L)
    ap.add_argument("--niter", type=int, default=NITER)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"P3 probe1536 on {common.device_name(dev)}: R {args.rows}, P "
          f"{args.cols}, L {args.depth}, NITER {args.niter}", flush=True)
    results = run(args.rows, args.cols, args.depth, args.niter, device=dev)
    for r in results:
        print(common.format_result(r), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
