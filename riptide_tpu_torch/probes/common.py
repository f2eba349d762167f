"""
What the three chip probes share: the library of ``csrc/probes.cu`` and
its launchers, the operand checks and tile choices made before a launch,
the launch counts, timing, and the per-pattern result with the work
behind its bound.

Each launcher here checks its operands, chooses the tile, allocates the
output with ``torch.empty`` and launches on the current stream, or
raises (ValueError for an operand or shape the kernel does not take,
RuntimeError for a failed build or launch). The probe modules' wrappers
call them only for CUDA tensors and count their own launches
(:func:`count`); :data:`KERNEL_LAUNCHES` counts the launches of each
CUDA kernel of ``probes.cu``, so a run shows which kernels a pattern
went through.
"""
import ctypes
import statistics
from typing import NamedTuple

import torch

from ..utils import cuda_build, measure
from ..utils.cuda_build import MAX_DYNAMIC_SMEM

__all__ = ["SOURCE", "LIB", "BUILD_INFO", "Result", "count", "time_call",
           "format_result", "device_name", "p1_add", "lane_row",
           "row_window", "dynroll", "p1_select", "pair", "strip",
           "slot_regs", "p2_add", "p2_select", "row_warp", "column",
           "tf32x3_gemm", "lane_values", "window_shift", "pair_rows",
           "strip_tile", "select_rows", "row_values", "column_rows",
           "gemm_grid", "mma_tf32_tflops", "launch_floor_ms",
           "KERNEL_LAUNCHES", "reset_kernel_launches", "ROW_WIDTHS",
           "LANE_VALUES", "SLOT_REG_LEVELS", "GEMM_TILE"]

SOURCE = cuda_build.CSRC / "probes.cu"
# Calls of a pattern that :func:`time_call` times, and the replays of
# their CUDA graph.
CALLS, REPLAYS = 8, 3
# Streaming multiprocessors of an H100 SXM: the tile choices aim at two
# blocks for each.
SM_COUNT = 132
# The shapes probes.cu's kernels are built for (its launchers refuse
# others): row widths of ``row_warp_kernel`` (32 V columns, V values a
# lane in registers; launch_row_width); values a lane of
# ``lane_row_kernel`` (one row a warp in shared memory, 32 V >= cols;
# launch_lane_width); the output tile of ``row_window_kernel`` (kWinTile
# rows of 32 columns); rows a thread of ``column_kernel`` (R dividing
# the rows, at most 1024 threads a column; rt_column), of
# ``p2_select_kernel`` and ``p1_select_kernel`` (rt_p2_select,
# rt_p1_select; the largest that leaves two warps for each of an SM's
# four schedulers) and of ``pair_kernel`` (rt_pair, even); the most
# elements a thread of ``strip_kernel`` and ``strip_cluster_kernel``
# (kStripE, kClusterE: of 4 and 8, each kernel's faster on an H100) and
# their most threads; the slot levels ``slot_regs_kernel`` holds in
# registers (rt_slot_regs); and ``tf32x3_gemm_kernel``'s block tile (kGM,
# kGN and kGK: M, N, K depth a stage).
ROW_WIDTHS = (32, 64, 128, 256, 384)
LANE_VALUES = (1, 2, 4, 8, 12, 16, 24, 32)
WINDOW_TILE = 64
COLUMN_ROWS, COLUMN_THREADS = (16, 8, 4, 2, 1), 1024
SELECT_ROWS = (8, 4, 2, 1)
PAIR_ROWS = (8, 4, 2)
STRIP_ELEMS, CLUSTER_ELEMS, STRIP_THREADS = 4, 8, 1024
SLOT_REG_LEVELS = (12, 24, 48)
GEMM_TILE = (64, 96, 64)

# The patterns a launcher takes by code (rt_probe_code).
_PATTERNS = ("p1.roll_lanes", "p1.stride_roll", "p1.barrel", "p1.interleave",
             "p1.repeat_tpu", "p2.roll1", "p2.dynroll", "p2.barrelbit",
             "p3.slot")
_CODES = {}
# Launcher -> the CUDA kernel it launches (rt_mma_rate, a measurement of
# the card, is not counted).
_KERNELS = {"rt_p1_add": "p1_add_kernel", "rt_lane_row": "lane_row_kernel",
            "rt_row_window": "row_window_kernel",
            "rt_dynroll": "dynroll_kernel",
            "rt_p1_select": "p1_select_kernel", "rt_pair": "pair_kernel",
            "rt_strip": "strip_kernel",
            "rt_strip_cluster": "strip_cluster_kernel",
            "rt_slot_regs": "slot_regs_kernel",
            "rt_p2_add": "p2_add_kernel", "rt_p2_select": "p2_select_kernel",
            "rt_row_warp": "row_warp_kernel", "rt_column": "column_kernel",
            "rt_tf32x3_gemm": "tf32x3_gemm_kernel"}
KERNEL_LAUNCHES = {k: 0 for k in _KERNELS.values()}


def reset_kernel_launches():
    """Set every kernel's launch count to 0."""
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def _bind(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_probe_code.argtypes = [ctypes.c_char_p]
    lib.rt_p1_add.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.rt_lane_row.argtypes = [i32, vp, vp, i32, i32, i32, i32, vp]
    lib.rt_row_window.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_dynroll.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    lib.rt_p1_select.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_pair.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_strip.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                             vp]
    lib.rt_strip_cluster.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32,
                                     i32, vp]
    lib.rt_slot_regs.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.rt_p2_add.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.rt_p2_select.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_row_warp.argtypes = [i32, vp, vp, i32, i32, i32, vp]
    lib.rt_column.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_tf32x3_gemm.argtypes = [vp, vp, vp, i32, i32, i32, f32, f32, vp]
    lib.rt_mma_rate.argtypes = [vp, i32, i32, i32, vp]
    lib.rt_empty.argtypes = [i32, i32, vp]
    for fn in ("rt_probe_code", "rt_mma_rate", "rt_empty", *_KERNELS):
        getattr(lib, fn).restype = i32
    for name in _PATTERNS:
        code = lib.rt_probe_code(name.encode())
        if code < 0:
            raise RuntimeError(f"probes.cu has no pattern {name!r}")
        _CODES[name] = code


LIB = cuda_build.Library(SOURCE, _bind)
# The build this process loaded: path, nvcc output, seconds.
BUILD_INFO = LIB.info


def _launch(fn, dev, *args):
    lib = LIB.load()
    cuda_build.check(lib, fn, getattr(lib, fn)(*args, cuda_build.stream(dev)))
    if fn in _KERNELS:
        count(KERNEL_LAUNCHES, _KERNELS[fn])


# ---------------------------------------------------------------------------
# Checks and tiles
# ---------------------------------------------------------------------------

def check_matrix(x, name="x", dtype=torch.float32):
    """(rows, cols) of a nonempty contiguous 2-D ``dtype`` tensor with
    fewer than 2**31 elements (the kernels index with int32); raises
    ValueError otherwise."""
    cuda_build.require(x, name, dtype, x.device)
    if x.dim() != 2 or x.numel() == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: want a nonempty 2-D tensor of fewer than "
                         f"2**31 elements, got shape {tuple(x.shape)}")
    return tuple(x.shape)


def check_count(n, name):
    if int(n) != n or n < 0:
        raise ValueError(f"{name} = {n!r}: want an integer >= 0")
    return int(n)


def lane_values(cols):
    """Values a lane of ``lane_row_kernel`` (one row a warp in shared
    memory, lane l holding columns l + 32 j): the least of
    :data:`LANE_VALUES` with 32 V >= cols. Raises ValueError for a row
    wider than 32 * 32 columns."""
    if not 1 <= cols <= 32 * LANE_VALUES[-1]:
        raise ValueError(f"{cols} columns: one row a warp in shared memory "
                         f"takes 1 to {32 * LANE_VALUES[-1]}")
    return next(v for v in LANE_VALUES if 32 * v >= cols)


def window_shift(rows, reps):
    """The largest row shift (5 i + 1) mod rows, i < reps, of P1's
    roll_rows (0 for none): ``row_window_kernel``'s window holds
    :data:`WINDOW_TILE` + that many rows of 32 columns. Raises ValueError
    when the window exceeds the shared memory a block may have."""
    smax = max(((5 * i + 1) % rows for i in range(reps)), default=0)
    if (WINDOW_TILE + smax) * 32 * 4 > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{rows} rows at {reps} repetitions: a window of "
                         f"{WINDOW_TILE + smax} rows needs "
                         f"{(WINDOW_TILE + smax) * 128} bytes of shared "
                         f"memory, at most {MAX_DYNAMIC_SMEM}")
    return smax


def pair_rows(rows, cols):
    """Rows per thread of ``pair_kernel`` (even, so a thread holds whole
    row pairs): the largest of :data:`PAIR_ROWS` whose grid still has two
    warps for each of the SMs' four schedulers (2 when none has)."""
    for k in PAIR_ROWS:
        if -(-rows // k) * cols >= 2 * 4 * 32 * SM_COUNT:
            return k
    return PAIR_ROWS[-1]


def strip_tile(rows, cols, S):
    """(log2 of the columns a block, threads a block, cluster) of the
    row-group kernels for groups of S rows: up to 32 columns a block,
    fewer while the grid has under two blocks per SM or the strip's S *
    2**lg elements exceed :data:`STRIP_ELEMS` a thread of
    :data:`STRIP_THREADS`. A strip of one column (lg 0) runs in
    ``strip_cluster_kernel`` (cluster True, :data:`CLUSTER_ELEMS` a
    thread), whose clusters of 8 blocks load and store 8 columns
    together, a whole 32-byte sector of a row; wider strips in
    ``strip_kernel``. The threads are a whole number of warps. Raises
    ValueError for an odd S, an S that does not divide the rows, or one
    column of a group past :data:`CLUSTER_ELEMS` elements a thread of
    :data:`STRIP_THREADS`."""
    if S < 2 or S % 2 or rows % S:
        raise ValueError(f"groups of S = {S} rows: want an even S that "
                         f"divides the {rows} rows")
    if S > CLUSTER_ELEMS * STRIP_THREADS:
        raise ValueError(f"a group of {S} rows: a block holds at most "
                         f"{CLUSTER_ELEMS * STRIP_THREADS} elements")
    lg = 5
    while lg > 0 and ((S << lg) > STRIP_ELEMS * STRIP_THREADS
                      or -(-cols >> lg) * (rows // S) < 2 * SM_COUNT):
        lg -= 1
    per = CLUSTER_ELEMS if lg == 0 else STRIP_ELEMS
    return lg, -(-(S << lg) // (32 * per)) * 32, lg == 0


def select_rows(rows, cols):
    """Rows per thread of ``p2_select_kernel``: the largest of
    :data:`SELECT_ROWS` whose grid still has two warps for each of the
    SMs' four schedulers (1 when none has)."""
    for k in SELECT_ROWS:
        if -(-rows // k) * cols >= 2 * 4 * 32 * SM_COUNT:
            return k
    return 1


def row_values(cols):
    """Values per lane of ``row_warp_kernel`` (one row a warp in
    registers): cols / 32. Raises ValueError for a width not in
    :data:`ROW_WIDTHS`."""
    if cols not in ROW_WIDTHS:
        raise ValueError(f"{cols} columns: one row a warp in registers "
                         f"takes {ROW_WIDTHS}")
    return cols // 32


def column_rows(rows):
    """(R, warps) of ``column_kernel``: R rows a thread, the largest of
    :data:`COLUMN_ROWS` dividing ``rows``, and the warps of a column's
    block. Raises ValueError when a column needs more than
    :data:`COLUMN_THREADS` threads."""
    R = next(r for r in COLUMN_ROWS if rows % r == 0)
    if rows // R > COLUMN_THREADS:
        raise ValueError(f"{rows} rows at {R} a thread need {rows // R} "
                         f"threads a column, at most {COLUMN_THREADS}")
    return R, -(-(rows // R) // 32)


def gemm_grid(M, N):
    """(blocks along N, blocks along M) of ``tf32x3_gemm_kernel``: one
    block a :data:`GEMM_TILE` output tile."""
    return -(-N // GEMM_TILE[1]), -(-M // GEMM_TILE[0])


# ---------------------------------------------------------------------------
# Launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

def p1_add(x, reps):
    """``p1_add_kernel``: one thread per element, ``reps`` terms."""
    rows, cols = check_matrix(x)
    reps = check_count(reps, "reps")
    out = torch.empty_like(x)
    _launch("rt_p1_add", x.device, x.data_ptr(), out.data_ptr(), rows, cols,
            reps)
    return out


def lane_row(pattern, x, passes):
    """``lane_row_kernel``: one row a warp in shared memory, ``passes``
    terms (``p1.roll_lanes``, ``p1.stride_roll``) or steps (``p1.barrel``,
    at most 31); see :func:`lane_values`."""
    rows, cols = check_matrix(x)
    passes = check_count(passes, "passes")
    V = lane_values(cols)
    if pattern == "p1.barrel" and passes > 31:
        raise ValueError(f"{passes} barrel steps: at most 31")
    out = torch.empty_like(x)
    _launch("rt_lane_row", x.device, _code(pattern), x.data_ptr(),
            out.data_ptr(), rows, cols, V, passes)
    return out


def row_window(x, reps):
    """``row_window_kernel``: P1's roll_rows, ``reps`` terms from a window
    of each column strip in shared memory (:func:`window_shift`)."""
    rows, cols = check_matrix(x)
    reps = check_count(reps, "reps")
    smax = window_shift(rows, reps)
    out = torch.empty_like(x)
    _launch("rt_row_window", x.device, x.data_ptr(), out.data_ptr(), rows,
            cols, reps, smax)
    return out


def dynroll(x, shifts, reps):
    """``dynroll_kernel``: P1's dynroll, ``shifts`` (8,) int32 on x's
    device; an element's eight sources in registers."""
    rows, cols = check_matrix(x)
    reps = check_count(reps, "reps")
    cuda_build.require(shifts, "shifts", torch.int32, x.device, (8,))
    out = torch.empty_like(x)
    _launch("rt_dynroll", x.device, x.data_ptr(), shifts.data_ptr(),
            out.data_ptr(), rows, cols, reps)
    return out


def p1_select(x, reps):
    """``p1_select_kernel``: :func:`select_rows` rows of one column a
    thread, ``reps`` repetitions of P1's select."""
    rows, cols = check_matrix(x)
    reps = check_count(reps, "reps")
    out = torch.empty_like(x)
    _launch("rt_p1_select", x.device, x.data_ptr(), out.data_ptr(), rows,
            cols, select_rows(rows, cols), reps)
    return out


def pair(x, passes):
    """``pair_kernel``: :func:`pair_rows` rows (whole row pairs) of one
    column a thread, ``passes`` passes of P1's parity select."""
    rows, cols = check_matrix(x)
    passes = check_count(passes, "passes")
    out = torch.empty_like(x)
    _launch("rt_pair", x.device, x.data_ptr(), out.data_ptr(), rows, cols,
            pair_rows(rows, cols), passes)
    return out


def strip(pattern, x, S, passes, w=None):
    """``strip_kernel`` or ``strip_cluster_kernel``: groups of S rows
    (even, dividing the rows) in column strips in shared memory
    (:func:`strip_tile`), ``passes``
    passes of ``p1.interleave``, ``p1.repeat_tpu`` or ``p3.slot`` (with
    ``w`` (rows, cols) int32)."""
    rows, cols = check_matrix(x)
    passes = check_count(passes, "passes")
    if int(S) != S:
        raise ValueError(f"groups of S = {S!r} rows: want an integer")
    if (w is None) != (pattern != "p3.slot"):
        raise ValueError(f"{pattern}: w is taken by p3.slot alone")
    if w is not None:
        cuda_build.require(w, "w", torch.int32, x.device, (rows, cols))
    lg, threads, cluster = strip_tile(rows, cols, int(S))
    out = torch.empty_like(x)
    ptrs = (_code(pattern), x.data_ptr(), None if w is None else w.data_ptr(),
            out.data_ptr(), rows, cols, int(S))
    if cluster:
        _launch("rt_strip_cluster", x.device, *ptrs, threads, passes)
    else:
        _launch("rt_strip", x.device, *ptrs, lg, threads, passes)
    return out


def slot_regs(x, w, S, passes):
    """``slot_regs_kernel``: a slot level of S rows (one of
    :data:`SLOT_REG_LEVELS`, dividing the rows) held in registers, one
    thread a group column, ``passes`` passes."""
    rows, cols = check_matrix(x)
    passes = check_count(passes, "passes")
    cuda_build.require(w, "w", torch.int32, x.device, (rows, cols))
    if S not in SLOT_REG_LEVELS or rows % S:
        raise ValueError(f"slot level S_d = {S}: registers take "
                         f"{SLOT_REG_LEVELS}, dividing the {rows} rows")
    out = torch.empty_like(x)
    _launch("rt_slot_regs", x.device, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), rows, cols, S, passes)
    return out


def p2_add(x, niter):
    """``p2_add_kernel``: one thread per element, ``niter`` passes."""
    rows, cols = check_matrix(x)
    niter = check_count(niter, "niter")
    out = torch.empty_like(x)
    _launch("rt_p2_add", x.device, x.data_ptr(), out.data_ptr(), rows, cols,
            niter)
    return out


def p2_select(x, niter):
    """``p2_select_kernel``: :func:`select_rows` rows of one column a
    thread, ``niter`` passes."""
    rows, cols = check_matrix(x)
    niter = check_count(niter, "niter")
    out = torch.empty_like(x)
    _launch("rt_p2_select", x.device, x.data_ptr(), out.data_ptr(), rows,
            cols, select_rows(rows, cols), niter)
    return out


def row_warp(pattern, x, niter):
    """``row_warp_kernel``: one row a warp in registers, ``niter`` passes
    (``p2.roll1``, ``p2.dynroll``, ``p2.barrelbit``); the width must be
    one of :data:`ROW_WIDTHS`."""
    rows, cols = check_matrix(x)
    niter = check_count(niter, "niter")
    row_values(cols)
    out = torch.empty_like(x)
    _launch("rt_row_warp", x.device, _code(pattern), x.data_ptr(),
            out.data_ptr(), rows, cols, niter)
    return out


def column(x, niter):
    """``column_kernel``: one column a block in registers, ``niter``
    passes of ``p2.rollrow``; see :func:`column_rows`."""
    rows, cols = check_matrix(x)
    niter = check_count(niter, "niter")
    R, _ = column_rows(rows)
    out = torch.empty_like(x)
    _launch("rt_column", x.device, x.data_ptr(), out.data_ptr(), rows, cols,
            R, niter)
    return out


def tf32x3_gemm(a, b, alpha, beta):
    """``tf32x3_gemm_kernel``: (a @ b) * alpha + beta for float32 a (M, K)
    and b (K, N), any sizes, on the tensor cores in 3xTF32."""
    M, K = check_matrix(a, "a")
    K2, N = check_matrix(b, "b")
    if K2 != K or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} and b "
                         f"{tuple(b.shape)} on {b.device} do not multiply")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    _launch("rt_tf32x3_gemm", a.device, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), M, N, K, float(alpha), float(beta))
    return out


def mma_tf32_tflops(dev, iters=4096, warps=8):
    """TFLOP/s of ``mma.sync`` m16n8k8 TF32 alone on the card (an FMA two
    flops): ``mma_rate_kernel`` on two blocks of ``warps`` warps an SM,
    timed between CUDA events after a warm-up launch. The practical
    ceiling of :func:`tf32x3_gemm`'s products, beside the tensor cores'
    published dense TF32 peak (``measure.PEAK_TF32_FLOPS_PER_S``)."""
    blocks, threads = 2 * SM_COUNT, 32 * warps
    out = torch.empty(blocks * threads, dtype=torch.float32, device=dev)

    def run(n):
        _launch("rt_mma_rate", dev, out.data_ptr(), blocks, threads, n)

    run(16)
    _, ms = measure.timed(lambda: run(iters), dev)
    return blocks * warps * iters * 12 * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12


def launch_floor_ms(dev, blocks=1, threads=32):
    """Device ms of one launch of an empty kernel (``empty_kernel``, on
    ``blocks`` x ``threads`` threads), timed as the patterns are
    (:func:`time_call`: calls replayed in a CUDA graph): the floor under
    a pattern's time."""
    return time_call(lambda: _launch("rt_empty", dev, blocks, threads),
                     dev)[1]


def _code(pattern):
    LIB.load()
    return _CODES[pattern]


# ---------------------------------------------------------------------------
# Timing and results
# ---------------------------------------------------------------------------

class Result(NamedTuple):
    """One pattern of one probe run: ``wrapper`` is the name of the probe
    module's function (its plain version is ``wrapper + "_plain"``),
    ``args`` the operands it took, ``out`` its first output, ``ms`` and
    ``call_ms`` one call's device time and its time through the wrapper
    (:func:`time_call`), ``passes`` the passes one call makes, ``nbytes``
    and ``ops`` the compulsory bytes and the operations of one call
    (:func:`~..utils.measure.bound_ms`; with ``tensor``, TF32 flops on
    the tensor cores), ``ok`` a host check's verdict (None where the
    probe makes none)."""
    name: str
    wrapper: str
    args: tuple
    out: torch.Tensor
    ms: float
    call_ms: float
    passes: int
    nbytes: int
    ops: int
    ok: bool = None
    tensor: bool = False

    def bound(self):
        """(ms, what bounds it): the least time the card could take for
        one call (:func:`~..utils.measure.bound_ms`)."""
        return measure.bound_ms(self.nbytes, self.ops, self.tensor)


def count(launches, kind):
    """Add one to ``launches[kind]`` for a kernel a wrapper launched. A
    call captured into a CUDA graph launches nothing and is not counted,
    nor are the graph's replays (:func:`time_call`)."""
    if not torch.cuda.is_current_stream_capturing():
        launches[kind] += 1


def time_call(fn, dev):
    """(first output, device ms, call ms) of ``fn()``. The call ms is the
    median over :data:`CALLS` calls, each between CUDA events, after a
    warm-up, so the wrapper's host work (checks, allocation, the ctypes
    call) paces it when the kernel is shorter. The device ms is the
    card's time per call with that work out of the way: :data:`CALLS`
    calls captured into one CUDA graph, replayed once to warm up, then
    the median of :data:`REPLAYS` replays over :data:`CALLS`. On the CPU
    both are the host clock's median."""
    out = fn()
    call_ms = measure.median_ms(fn, dev, CALLS)
    if dev.type != "cuda":
        return out, call_ms, call_ms
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    device_ms = statistics.median(measure.timed(graph.replay, dev)[1]
                                  for _ in range(REPLAYS)) / CALLS
    return out, device_ms, call_ms


def format_result(r):
    """One printed line: time per call and per pass, Gelem/s and the
    bound."""
    rows, cols = r.out.shape
    bms, by = r.bound()
    ms = max(r.ms, 1e-9)
    passes = max(r.passes, 1)
    ok = "" if r.ok is None else f"  ok={r.ok}"
    return (f"{r.name:14s} {rows:5d}x{cols:<4d}: {r.ms:9.4f} ms/call "
            f"{r.ms * 1e3 / passes:10.4f} us/pass ({r.passes} passes) "
            f"{rows * cols * passes / ms / 1e6:9.1f} Gelem/s; bound "
            f"{bms:.6f} ms by {by} ({bms / ms:.1%} of the time); "
            f"{r.call_ms:.4f} ms through the wrapper{ok}")


def device_name(dev):
    """The card's name, or a note that the CPU runs the plain versions."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu (plain PyTorch versions; host clock)"
