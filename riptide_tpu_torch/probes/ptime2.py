"""
P2: the card's throughput for one op repeated many times in one launch.

The port of ``tools/ptime2.py`` (Pallas program built at :22,
``pallas_call`` :28). Each body runs NITER = 20000 passes over a float32
buffer inside ONE launch of a hand-written CUDA kernel of
``csrc/probes.cu``, so the time per pass is the card's time for the op
with the data on chip, not a launch's:

=========  ======================  =====================================
wrapper    JAX body                one pass i (acc starts as x)
=========  ======================  =====================================
add        body_add :38            acc * 1.0001 + 0.5
roll1      body_roll :42           acc + roll(acc, 1, 1) * 1e-6
rollrow    body_rollrow :46        acc + roll(acc, 1, 0) * 1e-6
dynroll    body_dynroll :50        acc + roll(acc, i % P, 1) * 1e-6
select     body_select :54         where(col < i % P, acc * 1.0001, acc)
barrelbit  body_barrelbit :59      where(col & 3 == i & 3,
                                   roll(acc, 4, 1), acc)
=========  ======================  =====================================

Every body keeps its data in registers for all passes. ``add`` runs one
element a thread; ``select`` a few rows of one column a thread, so one
compare of the column against i % P serves them all; ``roll1``,
``dynroll`` and ``barrelbit`` one row a warp (``cols / 32`` values a
lane, for the widths of :data:`~.common.ROW_WIDTHS`; the lanes exchange
values by shuffles); ``rollrow`` couples every row to the one above, but
each column only to itself, so it runs one column a block, a few
consecutive rows a thread (a shuffle between lanes, one value a warp
through shared memory between warps). No body needs a grid-wide sync.

Each wrapper takes CUDA tensors to its kernel (counted in
:data:`LAUNCHES`) or raises; on CPU tensors it runs ``<wrapper>_plain``,
one PyTorch op per step and pass. The entry point prints microseconds per
pass and Gelem/s at the tool's four shapes, beside the bound::

    python -m riptide_tpu_torch.probes.ptime2 [BODY ...]

BODY defaults to the tool's add roll1 dynroll select; ``--niter`` (or
the tool's ``NITER`` environment variable) sets the passes, ``--shape
RxC`` (repeatable) the shapes, ``--device cpu`` runs the plain versions.
"""
import argparse
import os
import sys

import numpy as np
import torch

from ..utils.device import resolve_device
from . import common

__all__ = ["add", "roll1", "rollrow", "dynroll", "select", "barrelbit",
           "BODIES", "run", "main", "LAUNCHES", "reset_launches"]

NITER = 20000
SHAPES = ((2048, 384), (1024, 384), (2048, 128), (256, 384))
DEFAULT_BODIES = ("add", "roll1", "dynroll", "select")

LAUNCHES = {k: 0 for k in ("add", "roll1", "rollrow", "dynroll", "select",
                           "barrelbit")}


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def add_plain(x, niter=NITER):
    acc = x
    for _ in range(niter):
        acc = acc * 1.0001 + 0.5
    return acc


def roll1_plain(x, niter=NITER):
    acc = x
    for _ in range(niter):
        acc = acc + torch.roll(acc, 1, 1) * 1e-6
    return acc


def rollrow_plain(x, niter=NITER):
    acc = x
    for _ in range(niter):
        acc = acc + torch.roll(acc, 1, 0) * 1e-6
    return acc


def dynroll_plain(x, niter=NITER):
    acc = x
    for i in range(niter):
        acc = acc + torch.roll(acc, i % x.shape[1], 1) * 1e-6
    return acc


def select_plain(x, niter=NITER):
    cols = torch.arange(x.shape[1], device=x.device)
    acc = x
    for i in range(niter):
        acc = torch.where(cols < i % x.shape[1], acc * 1.0001, acc)
    return acc


def barrelbit_plain(x, niter=NITER):
    cols = torch.arange(x.shape[1], device=x.device)
    masks = [(cols & 3) == k for k in range(4)]
    acc = x
    for i in range(niter):
        acc = torch.where(masks[i & 3], torch.roll(acc, 4, 1), acc)
    return acc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _counted(kind, out):
    common.count(LAUNCHES, kind)
    return out


def add(x, niter=NITER):
    """``body_add``: one element a thread, in a register."""
    if x.device.type == "cpu":
        return add_plain(x, niter)
    return _counted("add", common.p2_add(x, niter))


def select(x, niter=NITER):
    """``body_select``: a few rows of one column a thread, in registers."""
    if x.device.type == "cpu":
        return select_plain(x, niter)
    return _counted("select", common.p2_select(x, niter))


def roll1(x, niter=NITER):
    """``body_roll``: one row a warp, in registers."""
    if x.device.type == "cpu":
        return roll1_plain(x, niter)
    return _counted("roll1", common.row_warp("p2.roll1", x, niter))


def dynroll(x, niter=NITER):
    """``body_dynroll``: one row a warp, in registers."""
    if x.device.type == "cpu":
        return dynroll_plain(x, niter)
    return _counted("dynroll", common.row_warp("p2.dynroll", x, niter))


def barrelbit(x, niter=NITER):
    """``body_barrelbit``: one row a warp, in registers."""
    if x.device.type == "cpu":
        return barrelbit_plain(x, niter)
    return _counted("barrelbit", common.row_warp("p2.barrelbit", x, niter))


def rollrow(x, niter=NITER):
    """``body_rollrow``: one column a block, a few rows a thread, in
    registers."""
    if x.device.type == "cpu":
        return rollrow_plain(x, niter)
    return _counted("rollrow", common.column(x, niter))


BODIES = {"add": add, "roll1": roll1, "rollrow": rollrow,
          "dynroll": dynroll, "select": select, "barrelbit": barrelbit}
# Operations per element and pass (one per add, multiply or select).
_OPS = {"add": 2, "roll1": 2, "rollrow": 2, "dynroll": 2, "select": 2,
        "barrelbit": 1}


def work(name, rows, cols, niter):
    """(compulsory bytes, operations) of one launch: x read and the output
    written once, and the body's operations on every element per pass."""
    n = rows * cols
    return 8 * n, _OPS[name] * n * niter


def run(names=DEFAULT_BODIES, shapes=SHAPES, niter=NITER, device=None):
    """Run and time each body at each shape on ``np.random.default_rng(0)``
    normals times 1e-3 (drawn anew per shape, as the tool does).
    Returns one :class:`~.common.Result` per (body, shape)."""
    dev = resolve_device(device)
    unknown = set(names) - set(BODIES)
    if unknown:
        raise ValueError(f"unknown bodies {sorted(unknown)}; choose among "
                         f"{tuple(BODIES)}")
    results = []
    for name in names:
        fn = BODIES[name]
        for shape in shapes:
            rng = np.random.default_rng(0)
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32) * np.float32(1e-3)).to(dev)
            out, ms, call_ms = common.time_call(lambda: fn(x, niter), dev)
            nbytes, ops = work(name, *shape, niter)
            results.append(common.Result(name, name, (x, niter), out, ms,
                                         call_ms, niter, nbytes, ops))
    return results


def _shape(text):
    r, c = text.lower().split("x")
    return int(r), int(c)


def main(argv=None):
    """Entry point; returns the run's results."""
    ap = argparse.ArgumentParser(
        prog="python -m riptide_tpu_torch.probes.ptime2",
        description="Per-pass time of one op repeated in one launch (P2).")
    ap.add_argument("bodies", nargs="*", default=list(DEFAULT_BODIES),
                    help=f"bodies: {' '.join(BODIES)}")
    ap.add_argument("--niter", type=int,
                    default=int(os.environ.get("NITER", NITER)))
    ap.add_argument("--shape", type=_shape, action="append",
                    help="RxC (repeatable); default the tool's four")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"P2 ptime2 on {common.device_name(dev)}: NITER {args.niter}",
          flush=True)
    results = run(args.bodies, tuple(args.shape or SHAPES), args.niter,
                  device=dev)
    for r in results:
        print(common.format_result(r), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
