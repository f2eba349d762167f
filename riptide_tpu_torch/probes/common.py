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
(:func:`count`).
"""
import ctypes
import statistics
from typing import NamedTuple

import torch

from ..utils import cuda_build, measure
from ..utils.cuda_build import MAX_DYNAMIC_SMEM

__all__ = ["SOURCE", "LIB", "BUILD_INFO", "Result", "count", "time_call",
           "format_result", "device_name", "p1_point", "p2_add", "p2_select",
           "row_warp", "column", "lane_loop", "strip_loop", "tf32x3_gemm",
           "lane_rows", "strip_log2", "select_rows", "row_values",
           "column_rows", "gemm_grid", "mma_tf32_tflops", "ROW_WIDTHS",
           "GEMM_TILE"]

SOURCE = cuda_build.CSRC / "probes.cu"
# Calls of a pattern that :func:`time_call` times, and the replays of
# their CUDA graph.
CALLS, REPLAYS = 8, 3
# Streaming multiprocessors of an H100 SXM: the tile choices aim at two
# blocks for each.
SM_COUNT = 132
# The shapes probes.cu's kernels are built for (its launchers refuse
# others): row widths of ``row_warp_kernel`` (32 V columns, V values a
# lane in registers; launch_row_width), rows a thread of
# ``column_kernel`` (R dividing the rows, at most 1024 threads a column;
# rt_column) and of ``p2_select_kernel`` (rt_p2_select; the largest
# that leaves two warps for each of an SM's four schedulers), and
# ``tf32x3_gemm_kernel``'s block tile (kGM, kGN and kGK: M, N, K depth
# a stage).
ROW_WIDTHS = (32, 64, 128, 256, 384)
COLUMN_ROWS, COLUMN_THREADS = (16, 8, 4, 2, 1), 1024
SELECT_ROWS = (8, 4, 2, 1)
GEMM_TILE = (64, 96, 64)

_PATTERNS = ("p1.add", "p1.roll_lanes", "p1.roll_rows", "p1.select",
             "p1.dynroll", "p1.stride_roll", "p1.barrel", "p1.interleave",
             "p1.repeat_tpu", "p1.repeat_flat", "p2.add", "p2.select",
             "p2.roll1", "p2.dynroll", "p2.barrelbit", "p2.rollrow",
             "p3.slot")
_CODES = {}


def _bind(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_probe_code.argtypes = [ctypes.c_char_p]
    lib.rt_p1_point.argtypes = [i32, vp, vp, vp, i32, i32, i32, vp]
    lib.rt_p2_add.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.rt_p2_select.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_row_warp.argtypes = [i32, vp, vp, i32, i32, i32, vp]
    lib.rt_column.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_lane_loop.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.rt_strip_loop.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32, i32,
                                  vp]
    lib.rt_tf32x3_gemm.argtypes = [vp, vp, vp, i32, i32, i32, f32, f32, vp]
    lib.rt_mma_rate.argtypes = [vp, i32, i32, i32, vp]
    for fn in (lib.rt_probe_code, lib.rt_p1_point, lib.rt_p2_add,
               lib.rt_p2_select, lib.rt_row_warp, lib.rt_column,
               lib.rt_lane_loop, lib.rt_strip_loop, lib.rt_tf32x3_gemm,
               lib.rt_mma_rate):
        fn.restype = i32
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


def lane_rows(rows, cols):
    """Rows per block of ``lane_loop_kernel``: up to 8 whole rows (two
    float32 buffers of them in shared memory), fewer while that leaves
    under two blocks per SM. Raises ValueError when one row's two buffers
    exceed the shared memory a block may have."""
    if 2 * cols * 4 > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{cols} columns: two rows of them need "
                         f"{2 * cols * 4} bytes of shared memory, at most "
                         f"{MAX_DYNAMIC_SMEM}")
    tr = 8
    while tr > 1 and (2 * tr * cols * 4 > MAX_DYNAMIC_SMEM
                      or -(-rows // tr) < 2 * SM_COUNT):
        tr //= 2
    return tr


def strip_log2(rows, cols, S, cell_bytes=8):
    """log2 of the columns per block of ``strip_loop_kernel`` for groups
    of S rows with ``cell_bytes`` of shared memory per element: up to 32
    columns, fewer while the strip exceeds shared memory or the grid has
    under two blocks per SM. Raises ValueError when one column of a group
    exceeds the shared memory a block may have."""
    if S * cell_bytes > MAX_DYNAMIC_SMEM:
        raise ValueError(f"a group of {S} rows needs {S * cell_bytes} bytes "
                         f"of shared memory per column, at most "
                         f"{MAX_DYNAMIC_SMEM}")
    groups = -(-rows // S)
    lg = 5
    while lg > 0 and ((S * cell_bytes << lg) > MAX_DYNAMIC_SMEM
                      or -(-cols >> lg) * groups < 2 * SM_COUNT):
        lg -= 1
    return lg


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

def p1_point(pattern, x, reps, shifts=None):
    """``p1_point_kernel``: one thread per element, ``reps`` terms."""
    rows, cols = check_matrix(x)
    reps = check_count(reps, "reps")
    if shifts is not None:
        cuda_build.require(shifts, "shifts", torch.int32, x.device, (8,))
    out = torch.empty_like(x)
    _launch("rt_p1_point", x.device, _code(pattern), x.data_ptr(),
            None if shifts is None else shifts.data_ptr(), out.data_ptr(),
            rows, cols, reps)
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


def lane_loop(x, passes):
    """``lane_loop_kernel``: whole rows in shared memory, ``passes``
    steps of P1's barrel."""
    rows, cols = check_matrix(x)
    passes = check_count(passes, "passes")
    tr = lane_rows(rows, cols)
    out = torch.empty_like(x)
    _launch("rt_lane_loop", x.device, x.data_ptr(), out.data_ptr(), rows,
            cols, tr, passes)
    return out


def strip_loop(pattern, x, S, passes, w=None):
    """``strip_loop_kernel``: groups of S rows (the last may be short) in
    column strips in shared memory, ``passes`` passes. ``w`` (rows, cols)
    int32 for ``p3.slot``. The caller sees to the grouping its pattern
    needs (S even and dividing the rows for the interleaves and
    ``p3.slot``)."""
    rows, cols = check_matrix(x)
    passes = check_count(passes, "passes")
    if int(S) != S or S < 1:
        raise ValueError(f"groups of S = {S!r} rows: want an integer >= 1")
    if w is not None:
        cuda_build.require(w, "w", torch.int32, x.device, (rows, cols))
    lg = strip_log2(rows, cols, S, 9 if w is not None else 8)
    out = torch.empty_like(x)
    _launch("rt_strip_loop", x.device, _code(pattern), x.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(), rows, cols,
            S, lg, passes)
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
