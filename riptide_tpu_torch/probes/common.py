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
           "format_result", "device_name", "p1_point", "p2_point",
           "lane_loop", "strip_loop", "sgemm", "lane_rows", "strip_log2"]

SOURCE = cuda_build.CSRC / "probes.cu"
# Calls of a pattern that :func:`time_call` times, and the replays of
# their CUDA graph.
CALLS, REPLAYS = 8, 3
# Streaming multiprocessors of an H100 SXM: the tile choices aim at two
# blocks for each.
SM_COUNT = 132

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
    lib.rt_p2_point.argtypes = [i32, vp, vp, i32, i32, i32, vp]
    lib.rt_lane_loop.argtypes = [i32, vp, vp, i32, i32, i32, i32, vp]
    lib.rt_strip_loop.argtypes = [i32, vp, vp, vp, i32, i32, i32, i32, i32,
                                  vp]
    lib.rt_sgemm.argtypes = [vp, vp, vp, i32, i32, i32, f32, f32, vp]
    for fn in (lib.rt_probe_code, lib.rt_p1_point, lib.rt_p2_point,
               lib.rt_lane_loop, lib.rt_strip_loop, lib.rt_sgemm):
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


def p2_point(pattern, x, niter):
    """``p2_point_kernel``: one thread per element, ``niter`` passes."""
    rows, cols = check_matrix(x)
    niter = check_count(niter, "niter")
    out = torch.empty_like(x)
    _launch("rt_p2_point", x.device, _code(pattern), x.data_ptr(),
            out.data_ptr(), rows, cols, niter)
    return out


def lane_loop(pattern, x, passes):
    """``lane_loop_kernel``: whole rows in shared memory, ``passes``
    passes."""
    rows, cols = check_matrix(x)
    passes = check_count(passes, "passes")
    tr = lane_rows(rows, cols)
    out = torch.empty_like(x)
    _launch("rt_lane_loop", x.device, _code(pattern), x.data_ptr(),
            out.data_ptr(), rows, cols, tr, passes)
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


def sgemm(a, b, alpha, beta):
    """``sgemm_kernel``: (a @ b) * alpha + beta for float32 a (M, K) and
    b (K, N)."""
    M, K = check_matrix(a, "a")
    K2, N = check_matrix(b, "b")
    if K2 != K or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} and b "
                         f"{tuple(b.shape)} on {b.device} do not multiply")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    _launch("rt_sgemm", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            M, N, K, float(alpha), float(beta))
    return out


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
    (:func:`~..utils.measure.bound_ms`), ``ok`` a host check's verdict (None where
    the probe makes none)."""
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

    def bound(self):
        """(ms, "bytes" or "operations"): the least time the card could
        take for one call."""
        return measure.bound_ms(self.nbytes, self.ops)


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
