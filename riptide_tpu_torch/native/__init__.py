"""
ctypes binding of the port's native host runtime (``src/riptide_native.cpp``,
the port's own copy of the JAX package's).

The shared library is built at first use with ``g++`` into the build
cache (:mod:`riptide_tpu_torch.utils.exec_cache`), under a name keyed by
the source, the flags and g++'s version, stored with its digest, checked
before it is loaded and loaded with ctypes. :func:`available` reports
whether the build and load worked; when they did not, a warning is
logged and every consumer takes its numpy path (the wire preparation
records which path made a wire as ``meta["prep"]``).

``RIPTIDE_NATIVE_SANITIZE`` (read at first use) builds the sanitized
flavour instead: :data:`SAN_FLAGS` (ASan + UBSan, no recovery, so any
report aborts the process) on top of :data:`FLAGS`, ``-ffp-contract=off``
kept so the wire's bytes stay the production library's. The flags are
part of the build cache's key, so it builds to its own library and
never stands in for the production one. It loads only with the
sanitizer runtimes preloaded (``LD_PRELOAD`` of ``g++
-print-file-name=libasan.so`` and ``libubsan.so``); a sanitized library
that does not build or load raises, rather than sending a path that
asked for native to numpy.

Bound here: the threaded wire preparation (:func:`prepare_wire_view`,
:func:`downsample_stages`) and the loaders' :func:`read_f32` and
:func:`decode8`.
"""
import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
from numpy.ctypeslib import ndpointer

from ..utils import envflags, exec_cache

log = logging.getLogger("riptide_tpu_torch.native")

__all__ = ["available", "build", "flags", "BUILD_INFO", "FLAGS",
           "SAN_FLAGS", "read_f32", "decode8", "downsample_stages",
           "prepare_wire_view", "default_threads"]

SOURCE = Path(__file__).resolve().parent / "src" / "riptide_native.cpp"
# -ffp-contract=off: the uint6/8/12 quantisers round to nearest even
# through the 1.5 * 2^23 magic constant, which gives the numpy path's
# bytes only if `v * inv + magic` is not contracted to an FMA (GCC
# contracts by default where the target has FMA). No -march=native: a
# library built on one host must not die with SIGILL on another that
# shares the checkout; the AVX2/F16C paths are chosen at run time.
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
         "-ffp-contract=off")
# The sanitized flavour's additions (RIPTIDE_NATIVE_SANITIZE): any ASan
# or UBSan report aborts, so "the tests pass sanitized" means zero
# reports.
SAN_FLAGS = ("-fsanitize=address,undefined", "-fno-sanitize-recover=all",
             "-g", "-fno-omit-frame-pointer")

_lock = threading.Lock()
_lib = None
_tried = False
_error = None
# The build this process made or found: the library's path, the cache's
# action and the seconds g++ took (0 when it was built already).
BUILD_INFO = {"path": None, "seconds": 0.0}


def flags():
    """The g++ flags of this process's build: :data:`FLAGS`, plus
    :data:`SAN_FLAGS` under ``RIPTIDE_NATIVE_SANITIZE``."""
    if envflags.get("RIPTIDE_NATIVE_SANITIZE"):
        return FLAGS + SAN_FLAGS
    return FLAGS


def _sanitizer_loaded():
    """Whether the ASan runtime is mapped into this process (preloaded):
    an instrumented library dlopen'ed without it aborts the process."""
    try:
        with open("/proc/self/maps") as fobj:
            return "libasan" in fobj.read()
    except OSError:
        return False


def _compile(out, flag_set):
    proc = subprocess.run(["g++", *flag_set, str(SOURCE), "-o", out],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit "
                           f"{proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout + proc.stderr


def build(load=False):
    """Path of the built library (with ``load``, the loaded
    ``ctypes.CDLL``), compiling it with g++ first if the build cache
    holds no library of this source, flag set and g++ whose digest
    checks. Concurrent first uses (test workers, survey processes) build
    once under the cache's lock. Raises RuntimeError when g++ fails."""
    flag_set = flags()
    return exec_cache.obtain(SOURCE, flag_set, ("g++", "-dumpfullversion"),
                             lambda out: _compile(out, flag_set), load=load,
                             info=BUILD_INFO)


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
    or the load failed (logged once). The sanitized flavour raises
    instead, every time."""
    global _lib, _tried, _error
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _tried = True
                try:
                    if envflags.get("RIPTIDE_NATIVE_SANITIZE") \
                            and not _sanitizer_loaded():
                        raise RuntimeError("the ASan runtime is not "
                                           "preloaded")
                    _lib = _bind(build(load=True))
                except (OSError, RuntimeError) as err:
                    if envflags.get("RIPTIDE_NATIVE_SANITIZE"):
                        _error = err
                    else:
                        log.warning("native library unavailable (%s); "
                                    "using the numpy paths", err)
    if _error is not None:
        raise RuntimeError(
            "the sanitized native library (RIPTIDE_NATIVE_SANITIZE) did "
            "not build or load; preload the sanitizer runtimes "
            "(LD_PRELOAD of `g++ -print-file-name=libasan.so` and "
            f"libubsan.so): {_error}") from _error
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
