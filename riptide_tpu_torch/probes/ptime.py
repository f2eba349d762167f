"""
P1: the card's time for the primitive patterns of the fused FFA kernel.

The port of ``tools/ptime.py`` (Pallas program built at :82,
``pallas_call`` :86). Each pattern repeats one primitive REPS = 32 times
over a (ROWS, P) = (2048, 384) float32 buffer, as the JAX tool's kernel
bodies do, in one launch of a hand-written CUDA kernel of
``csrc/probes.cu`` (named beside each wrapper below):

==============  =========================  ================================
wrapper         JAX body (tools/ptime.py)  one repetition i; kernel
==============  =========================  ================================
add             kern_add :137,             acc = acc * 1.0001 + x;
                make_tile_add :97          p1_add_kernel
roll_lanes      kern_roll :27,             acc += roll(x, (7i + 1) % P, 1);
                make_tile_roll :107        lane_row_kernel
roll_rows       kern_roll_rows :35         acc += roll(x, (5i + 1) % ROWS,
                                           0); row_window_kernel
select          kern_select :43            acc = where(col < 11i % P,
                                           acc + 1, acc * 0.5);
                                           p1_select_kernel
barrel          kern_barrel :52            step k < min(REPS, 9): rows with
                                           bit k set take roll(acc, 2^k,
                                           1); lane_row_kernel
interleave      kern_interleave :62        8 row groups: row s of a group =
                                           half0[s // 2] + half1[s // 2] +
                                           i; strip_kernel
repeat_tpu      kern_repeat_tpu :145       the same with pltpu.repeat, a
                                           tile: half0[s % S_c] + ... + i;
                                           strip_kernel
repeat_flat     kern_repeat_flat :157      odd rows take the row above, +
                                           i; pair_kernel
dynroll         kern_dynroll :74           acc += roll(x, shifts[i % 8],
                                           0); dynroll_kernel
stride_roll     kern_stride_roll :170      acc += x with row r rolled by
                                           i % P + r; lane_row_kernel
matmul          kern_matmul :178           acc = (a @ acc) * 0.001 + i;
                                           tf32x3_gemm_kernel
==============  =========================  ================================

``interleave`` and ``repeat_tpu`` make max(REPS // 8, 1) passes,
``repeat_flat`` max(REPS // 4, 1), ``matmul`` max(REPS // 8, 1) products
of a (ROWS, ROWS) matrix. The tile sweep runs ``add`` and ``roll_lanes``
at the eight shapes of :data:`TILES`.

Each wrapper takes CUDA tensors to its kernel (counted in
:data:`LAUNCHES`) or raises; on CPU tensors it runs ``<wrapper>_plain``,
the same function in plain PyTorch. The entry point times each pattern
with CUDA events (:func:`~.common.time_call`: the card's time per call
from calls replayed in a CUDA graph, and the time of one call through
the wrapper) and prints it beside its bound; ``sync
RT`` is the round trip of one small PyTorch op and a fetch of one
value, the tool's baseline::

    python -m riptide_tpu_torch.probes.ptime [GROUP ...]   # default: all

with GROUP among add, roll, select, barrel, inter, dyn, stride, tile, mm
(the tool's names); ``--rows/--cols/--reps`` change the shapes and
``--device cpu`` runs the plain versions on the CPU.
"""
import argparse
import sys
import time

import numpy as np
import torch

from ..utils.device import resolve_device
from . import common

__all__ = ["add", "roll_lanes", "roll_rows", "select", "barrel", "interleave",
           "repeat_tpu", "repeat_flat", "dynroll", "stride_roll", "matmul",
           "run", "main", "LAUNCHES", "reset_launches"]

ROWS, P, REPS = 2048, 384, 32
TILES = ((64, 384), (256, 384), (512, 384), (2048, 384), (2048, 128),
         (256, 128), (8, 384), (8, 128))
GROUPS = ("add", "roll", "select", "barrel", "inter", "dyn", "stride", "tile",
          "mm")
# Row groups of the interleave patterns, as in the JAX bodies.
G = 8

LAUNCHES = {k: 0 for k in ("add", "roll_lanes", "roll_rows", "select",
                           "barrel", "interleave", "repeat_tpu",
                           "repeat_flat", "dynroll", "stride_roll", "matmul")}


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _group_rows(rows):
    if rows % (2 * G):
        raise ValueError(f"{rows} rows: the interleave patterns need rows "
                         f"divisible by {2 * G}")
    return rows // G


def _passes(kind, reps):
    return {"barrel": min(reps, 9), "interleave": max(reps // 8, 1),
            "repeat_tpu": max(reps // 8, 1), "repeat_flat": max(reps // 4, 1),
            "matmul": max(reps // 8, 1)}.get(kind, reps)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def add_plain(x, reps=REPS):
    acc = x
    for _ in range(reps):
        acc = acc * 1.0001 + x
    return acc


def roll_lanes_plain(x, reps=REPS):
    acc = x
    for i in range(reps):
        acc = acc + torch.roll(x, (i * 7 + 1) % x.shape[1], 1)
    return acc


def roll_rows_plain(x, reps=REPS):
    acc = x
    for i in range(reps):
        acc = acc + torch.roll(x, (i * 5 + 1) % x.shape[0], 0)
    return acc


def select_plain(x, reps=REPS):
    cols = torch.arange(x.shape[1], device=x.device)
    acc = x
    for i in range(reps):
        acc = torch.where(cols < (i * 11) % x.shape[1], acc + 1.0, acc * 0.5)
    return acc


def barrel_plain(x, reps=REPS):
    sig = torch.arange(x.shape[0], device=x.device)[:, None]
    acc = x
    for k in range(_passes("barrel", reps)):
        acc = torch.where(((sig >> k) & 1) != 0, torch.roll(acc, 1 << k, 1),
                          acc)
    return acc


def _halves(acc, tile):
    rows, cols = acc.shape
    S_d = _group_rows(rows)
    v = acc.reshape(G, 2, S_d // 2, cols)
    if tile:   # pltpu.repeat(v, 2, axis=1) == np.tile
        return v[:, 0].repeat(1, 2, 1), v[:, 1].repeat(1, 2, 1)
    return (v[:, 0].repeat_interleave(2, dim=1),
            v[:, 1].repeat_interleave(2, dim=1))


def _interleave_plain(x, reps, tile):
    acc = x
    for i in range(_passes("interleave", reps)):
        reph, rept = _halves(acc, tile)
        acc = (reph + rept).reshape(x.shape) + float(i)
    return acc


def interleave_plain(x, reps=REPS):
    return _interleave_plain(x, reps, tile=False)


def repeat_tpu_plain(x, reps=REPS):
    return _interleave_plain(x, reps, tile=True)


def repeat_flat_plain(x, reps=REPS):
    rows2 = torch.arange(x.shape[0], device=x.device)[:, None]
    acc = x
    for i in range(_passes("repeat_flat", reps)):
        acc = torch.where((rows2 & 1) == 0, acc, torch.roll(acc, 1, 0)) + float(i)
    return acc


def dynroll_plain(shifts, x, reps=REPS):
    sh = [int(s) for s in shifts.tolist()]
    acc = x
    for i in range(reps):
        acc = acc + torch.roll(x, sh[i % 8], 0)
    return acc


def stride_roll_plain(x, reps=REPS):
    rows, cols = x.shape
    base = (torch.arange(cols, device=x.device)[None, :]
            - torch.arange(rows, device=x.device)[:, None]) % cols
    acc = x
    for i in range(reps):
        acc = acc + torch.gather(x, 1, (base - i % cols) % cols)
    return acc


def matmul_plain(a, x, reps=REPS):
    acc = x
    for i in range(_passes("matmul", reps)):
        acc = (a @ acc) * 0.001 + float(i)
    return acc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _counted(kind, out):
    common.count(LAUNCHES, kind)
    return out


def add(x, reps=REPS):
    """``kern_add`` / ``make_tile_add`` on a (rows, cols) float32 tensor:
    one thread per element."""
    if x.device.type == "cpu":
        return add_plain(x, reps)
    return _counted("add", common.p1_add(x, reps))


def roll_lanes(x, reps=REPS):
    """``kern_roll`` / ``make_tile_roll``: one row a warp in shared
    memory, every term read from there."""
    if x.device.type == "cpu":
        return roll_lanes_plain(x, reps)
    return _counted("roll_lanes", common.lane_row("p1.roll_lanes", x, reps))


def roll_rows(x, reps=REPS):
    """``kern_roll_rows``: every term from a window of the column strip
    in shared memory."""
    if x.device.type == "cpu":
        return roll_rows_plain(x, reps)
    return _counted("roll_rows", common.row_window(x, reps))


def select(x, reps=REPS):
    """``kern_select``: a few rows of one column a thread, one compare
    against a running threshold a repetition."""
    if x.device.type == "cpu":
        return select_plain(x, reps)
    return _counted("select", common.p1_select(x, reps))


def dynroll(shifts, x, reps=REPS):
    """``kern_dynroll``: ``shifts`` (8,) int32 on x's device; each
    element's eight source values in registers."""
    if x.device.type == "cpu":
        return dynroll_plain(shifts, x, reps)
    return _counted("dynroll", common.dynroll(x, shifts, reps))


def stride_roll(x, reps=REPS):
    """``kern_stride_roll``: one row a warp in shared memory."""
    if x.device.type == "cpu":
        return stride_roll_plain(x, reps)
    return _counted("stride_roll", common.lane_row("p1.stride_roll", x, reps))


def barrel(x, reps=REPS):
    """``kern_barrel``: min(reps, 9) masked roll steps, one row a warp in
    shared memory."""
    if x.device.type == "cpu":
        return barrel_plain(x, reps)
    return _counted("barrel", common.lane_row("p1.barrel", x,
                                              _passes("barrel", reps)))


def _strip(kind, x, reps):
    return _counted(kind, common.strip(f"p1.{kind}", x,
                                       _group_rows(x.shape[0]),
                                       _passes(kind, reps)))


def interleave(x, reps=REPS):
    """``kern_interleave``: each group's column strips in shared memory for
    all passes, the gather map computed once."""
    if x.device.type == "cpu":
        return interleave_plain(x, reps)
    return _strip("interleave", x, reps)


def repeat_tpu(x, reps=REPS):
    """``kern_repeat_tpu``."""
    if x.device.type == "cpu":
        return repeat_tpu_plain(x, reps)
    return _strip("repeat_tpu", x, reps)


def repeat_flat(x, reps=REPS):
    """``kern_repeat_flat``: row pairs never mix with other pairs, so a
    thread holds whole pairs of one column in registers."""
    if x.device.type == "cpu":
        return repeat_flat_plain(x, reps)
    return _counted("repeat_flat", common.pair(x, _passes("repeat_flat",
                                                          reps)))


def matmul(a, x, reps=REPS):
    """``kern_matmul``: max(reps // 8, 1) products (a @ acc) * 0.001 + i
    of a square float32 ``a`` (rows, rows) through the hand-written 3xTF32
    tensor-core GEMM, one launch each."""
    if x.device.type == "cpu":
        return matmul_plain(a, x, reps)
    if a.shape[0] != a.shape[-1]:
        raise ValueError(f"a {tuple(a.shape)}: want a square matrix")
    acc = x
    for i in range(_passes("matmul", reps)):
        acc = common.tf32x3_gemm(a, acc, 0.001, float(i))
        common.count(LAUNCHES, "matmul")
    return acc


# ---------------------------------------------------------------------------
# Work counts and the entry point
# ---------------------------------------------------------------------------

# Operations per element and pass (one per add, multiply or select).
_OPS = {"add": 2, "roll_lanes": 1, "roll_rows": 1, "select": 2, "barrel": 1,
        "interleave": 2, "repeat_tpu": 2, "repeat_flat": 2, "dynroll": 1,
        "stride_roll": 1}


def work(kind, rows, cols, reps):
    """(passes, compulsory bytes, operations) of one call: x read and the
    output written once (the matmul also reads a; dynroll its 8 shifts).
    The matmul's operations are TF32 flops on the tensor cores: a
    float32-accurate product there is three TF32 products (3xTF32), 3 *
    2 * rows * rows * cols flops a product; its float32 epilogue (two
    operations an output) is left out, under 0.3 % of that time."""
    n = rows * cols
    passes = _passes(kind, reps)
    if kind == "matmul":
        return passes, 4 * (rows * rows + 2 * n), passes * 6 * rows * n
    return passes, 8 * n + (32 if kind == "dynroll" else 0), _OPS[kind] * n * passes


def _want(which, group):
    return "all" in which or group in which


def run(which=("all",), rows=ROWS, cols=P, reps=REPS, device=None):
    """Run and time the patterns of the groups in ``which`` (see
    :data:`GROUPS`; "all" for every one) on inputs drawn as the JAX tool
    draws them (``np.random.default_rng(0)``), the tile sweep at
    :data:`TILES`. Returns one :class:`~.common.Result` per pattern."""
    dev = resolve_device(device)
    unknown = set(which) - set(GROUPS) - {"all"}
    if unknown:
        raise ValueError(f"unknown pattern groups {sorted(unknown)}; "
                         f"choose among {GROUPS} or all")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((rows, cols)).astype(
        np.float32)).to(dev)
    shifts = torch.from_numpy(np.arange(8, dtype=np.int32) * 37 + 5).to(dev)
    results = []

    def measure(name, fn, args, kind=None):
        kind = kind or fn.__name__
        out, ms, call_ms = common.time_call(lambda: fn(*args, reps), dev)
        passes, nbytes, ops = work(kind, *args[-1].shape, reps)
        results.append(common.Result(name, fn.__name__, (*args, reps), out,
                                     ms, call_ms, passes, nbytes, ops))

    if _want(which, "add"):
        measure("add", add, (x,))
    if _want(which, "roll"):
        measure("roll lanes", roll_lanes, (x,))
        measure("roll rows", roll_rows, (x,))
    if _want(which, "select"):
        measure("select", select, (x,))
    if _want(which, "barrel"):
        measure("barrel9", barrel, (x,))
    if _want(which, "inter"):
        measure("interleave", interleave, (x,))
        measure("repeat_tpu", repeat_tpu, (x,))
        measure("parity_sel", repeat_flat, (x,))
    if _want(which, "dyn"):
        measure("dynroll", dynroll, (shifts, x))
    if _want(which, "stride"):
        measure("stride_roll", stride_roll, (x,))
    if _want(which, "tile"):
        for r, c in TILES:
            xt = torch.from_numpy(rng.standard_normal((r, c)).astype(
                np.float32)).to(dev)
            measure(f"add {r}x{c}", add, (xt,))
            measure(f"roll {r}x{c}", roll_lanes, (xt,))
    if _want(which, "mm"):
        a = torch.from_numpy(rng.standard_normal((rows, rows)).astype(
            np.float32)).to(dev)
        out, ms, call_ms = common.time_call(lambda: matmul(a, x, reps), dev)
        passes, nbytes, ops = work("matmul", rows, cols, reps)
        results.append(common.Result("matmul", "matmul", (a, x, reps), out,
                                     ms, call_ms, passes, nbytes, ops,
                                     tensor=True))
    return results


def sync_rt_ms(x, count=8):
    """The tool's baseline: host milliseconds of one small op on ``x``
    and a fetch of one of its values, the mean of ``count``."""
    float((x * 1.0)[0, 0])
    t0 = time.perf_counter()
    for _ in range(count):
        float((x * 1.0)[0, 0])
    return (time.perf_counter() - t0) / count * 1e3


def main(argv=None):
    """Entry point; returns the run's results."""
    ap = argparse.ArgumentParser(
        prog="python -m riptide_tpu_torch.probes.ptime",
        description="Time the fused FFA kernel's primitive patterns (P1).")
    ap.add_argument("groups", nargs="*", default=["all"],
                    help=f"pattern groups: {' '.join(GROUPS)} or all")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=P)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"P1 ptime on {common.device_name(dev)}: ({args.rows}, "
          f"{args.cols}) float32, REPS {args.reps}", flush=True)
    x = torch.zeros((args.rows, args.cols), device=dev)
    print(f"{'sync RT':14s}: {sync_rt_ms(x):9.4f} ms/call  (baseline)",
          flush=True)
    results = run(args.groups, args.rows, args.cols, args.reps, device=dev)
    for r in results:
        print(common.format_result(r), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
