"""
ctypes binding of the port's native host runtime (``src/riptide_native.cpp``,
the port's own copy of the JAX package's).

The shared library is built at first use with ``g++`` into
``riptide_tpu_torch/_build/``, under a name keyed by a hash of the source
and the flags, and loaded with ctypes. :func:`available` reports whether
the build and load worked; when they did not, a warning is logged and
every consumer takes its numpy path (the wire preparation records which
path made a wire as ``meta["prep"]``).

Bound here: the threaded wire preparation (:func:`prepare_wire_view`,
:func:`downsample_stages`) and the loaders' :func:`read_f32` and
:func:`decode8`.
"""
import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
from numpy.ctypeslib import ndpointer

log = logging.getLogger("riptide_tpu_torch.native")

__all__ = ["available", "build", "BUILD_INFO", "read_f32", "decode8",
           "downsample_stages", "prepare_wire_view", "default_threads"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "src" / "riptide_native.cpp"
BUILD_DIR = _PKG / "_build"
# -ffp-contract=off: the uint6/8/12 quantisers round to nearest even
# through the 1.5 * 2^23 magic constant, which gives the numpy path's
# bytes only if `v * inv + magic` is not contracted to an FMA (GCC
# contracts by default where the target has FMA). No -march=native: a
# library built on one host must not die with SIGILL on another that
# shares the checkout; the AVX2/F16C paths are chosen at run time.
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
         "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_tried = False
# The build this process made or found: the library's path and the
# seconds g++ took (0 when it was built already).
BUILD_INFO = {"path": None, "seconds": 0.0}


def _lib_path():
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libriptide_native_{key}.so"


def build():
    """Path of the built library, compiling it with g++ first if this
    source and flag set have not been built yet. Builds to a unique
    temporary name and renames it into place, so that concurrent first
    uses (test workers, survey processes) never truncate a library
    another process has mapped. Raises RuntimeError when g++ fails."""
    out = _lib_path()
    BUILD_INFO["path"] = str(out)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit "
                               f"{proc.returncode}): {proc.stderr.strip()}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return out


def _f32():
    return ndpointer(np.float32, flags="C_CONTIGUOUS")


def _bind(lib):
    c64, vp = ctypes.c_int64, ctypes.c_void_p
    i32p = ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rn_read_f32.restype = c64
    lib.rn_read_f32.argtypes = [ctypes.c_char_p, c64, c64, _f32()]
    lib.rn_decode8.restype = None
    lib.rn_decode8.argtypes = [vp, c64, ctypes.c_int, _f32()]
    lib.rn_downsample_stages.restype = None
    lib.rn_downsample_stages.argtypes = [
        _f32(), c64, c64,                  # batch, D, N
        i32p, i32p,                        # imin, imax (S, nout)
        _f32(), _f32(), _f32(),            # wmin, wmax, wint (S, nout)
        c64, c64, c64, ctypes.c_int,       # S, nout, nthreads, as_f16
        vp,                                # out (S, D, nout)
    ]
    lib.rn_prepare_wire_view.restype = None
    lib.rn_prepare_wire_view.argtypes = [
        _f32(), c64, c64,                  # batch, D, N
        i32p, i32p,                        # imin, imax (S, nout_pad)
        _f32(), _f32(), _f32(),            # wmin, wmax, wint
        c64, c64,                          # S, nout_pad
        i32p, i64p,                        # nouts (S,), roffs (S,)
        c64, i64p, c64,                    # tot_rows, soffs, stot
        c64, c64, c64,                     # PW, mode, nthreads
        _f32(),                            # scales out (D, stot)
        vp,                                # out (D, tot_rows, PW) uint8
    ]
    return lib


def _get():
    """The bound library, building it at first call; None if the build
    or the load failed (logged once)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError) as err:
            log.warning("native library unavailable (%s); using the numpy "
                        "paths", err)
            _lib = None
    return _lib


def available():
    """True when the native library built and loaded."""
    return _get() is not None


def _require():
    lib = _get()
    if lib is None:
        raise RuntimeError("riptide_tpu_torch native library is not "
                           "available")
    return lib


def default_threads():
    """Worker threads when the caller names none: every core, at most
    32."""
    return min(max(os.cpu_count() or 1, 1), 32)


def read_f32(path, offset, count):
    """Read ``count`` float32 samples at byte ``offset`` of ``path``.
    Raises OSError on an open failure or a short read."""
    lib = _require()
    out = np.empty(int(count), np.float32)
    got = lib.rn_read_f32(os.fsencode(path), int(offset), int(count), out)
    if got != count:
        raise OSError(f"expected {count} float32 samples at offset {offset} "
                      f"of {path!r}, read {got}")
    return out


def decode8(raw, signed):
    """Decode a bytes-like of 8-bit samples to float32."""
    lib = _require()
    buf = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(buf.size, np.float32)
    lib.rn_decode8(buf.ctypes.data, buf.size, int(bool(signed)), out)
    return out


def _check_out(arr, shape, dtype, name):
    if (arr.shape != tuple(int(s) for s in shape) or arr.dtype != dtype
            or not arr.flags["C_CONTIGUOUS"]):
        raise ValueError(f"{name} must be C-contiguous {tuple(shape)} "
                         f"{np.dtype(dtype).name}, got {arr.shape} "
                         f"{arr.dtype}")


def downsample_stages(batch, imin, imax, wmin, wmax, wint, dtype=np.float32,
                      nthreads=None, out=None):
    """
    All cascade stages' real-factor downsamplings of a (D, N) float32
    batch, threaded over (stage, trial) pairs with one float64 prefix
    sum per trial. ``imin``/``imax`` (S, nout) int32, ``wmin``/``wmax``/
    ``wint`` (S, nout) float32. Returns (S, D, nout) in ``dtype``
    (float32, or float16 converted natively, round to nearest even).
    ``out``, when given, is a C-contiguous (S, D, nout) array of
    ``dtype`` written in place (a recycled staging buffer).
    """
    lib = _require()
    batch = np.ascontiguousarray(batch, np.float32)
    D, N = batch.shape
    S, nout = imin.shape
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.float16)):
        raise ValueError("dtype must be float32 or float16")
    if out is None:
        out = np.empty((S, D, nout), dtype)
    else:
        _check_out(out, (S, D, nout), dtype, "out")
    lib.rn_downsample_stages(
        batch, D, N,
        np.ascontiguousarray(imin, np.int32),
        np.ascontiguousarray(imax, np.int32),
        np.ascontiguousarray(wmin, np.float32),
        np.ascontiguousarray(wmax, np.float32),
        np.ascontiguousarray(wint, np.float32),
        S, nout, int(nthreads or default_threads()),
        int(dtype == np.dtype(np.float16)), out.ctypes.data,
    )
    return out


_WIRE_MODE_CODE = {"uint6": 6, "uint8": 8, "uint12": 12}


def prepare_wire_view(batch, imin, imax, wmin, wmax, wint, nouts, mode,
                      PW, roffs, tot_rows, soffs, stot, nthreads=None,
                      out=None, scales=None):
    """
    Quantised wire preparation of a (D, N) float32 batch in the
    kernel-decodable byte-plane view, in one threaded pass (the native
    form of ``search.engine._prepare_uint``, the same bytes and scales):
    stage s computes its ``nouts[s]`` downsampled samples, quantises
    them per PW-sample view row with scale = rowmax / qmax and packs the
    byte planes at wire row ``roffs[s]``, its scales at ``soffs[s]``.

    Returns (wire (D, tot_rows, PW) uint8, scales (D, stot) float32);
    the slack regions hold zeros / 1.0. ``out`` / ``scales``, when
    given, are C-contiguous arrays of those shapes and types, reset to
    the slack values and written in place, so a recycled buffer gives
    the bytes of a fresh one. The bytes do not depend on ``nthreads``.
    """
    lib = _require()
    batch = np.ascontiguousarray(batch, np.float32)
    D, N = batch.shape
    S, nout_pad = imin.shape
    shape = (D, int(tot_rows), int(PW))
    if out is None:
        out = np.zeros(shape, np.uint8)
    else:
        _check_out(out, shape, np.uint8, "out")
        out.fill(0)
    if scales is None:
        scales = np.ones((D, int(stot)), np.float32)
    else:
        _check_out(scales, (D, int(stot)), np.float32, "scales")
        scales.fill(1.0)
    lib.rn_prepare_wire_view(
        batch, D, N,
        np.ascontiguousarray(imin, np.int32),
        np.ascontiguousarray(imax, np.int32),
        np.ascontiguousarray(wmin, np.float32),
        np.ascontiguousarray(wmax, np.float32),
        np.ascontiguousarray(wint, np.float32),
        S, nout_pad,
        np.ascontiguousarray(nouts, np.int32),
        np.ascontiguousarray(roffs, np.int64),
        int(tot_rows),
        np.ascontiguousarray(soffs, np.int64), int(stot),
        int(PW), _WIRE_MODE_CODE[mode], int(nthreads or default_threads()),
        scales, out.ctypes.data,
    )
    return out, scales
