"""
Build and load the port's CUDA sources.

Each source under ``riptide_tpu_torch/csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, at first
use, into the build cache (:mod:`riptide_tpu_torch.utils.exec_cache`,
``<cache root>/torch_build/`` by default) under a name keyed by the
source, the flags and nvcc's version, stored with its digest, checked
before every load and loaded with ctypes. A :class:`Library` builds and
loads one source once per process; several can be built at the same
time (one ``nvcc`` each). A missing or failing ``nvcc`` raises; nothing
falls back. :data:`BUILD_DIR` (``riptide_tpu_torch/_build/``) holds no
library: it is scratch space for scripts that write large files.

The helpers below are what every kernel wrapper does before and after a
launch: :func:`require` checks an operand, :func:`stream` is the current
stream's handle, :func:`check` raises on a launcher's CUDA error code.
"""
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import exec_cache
from .limits import MAX_DYNAMIC_SMEM

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "MAX_DYNAMIC_SMEM", "Library",
           "build", "require", "stream", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the port's "
                       "CUDA sources")


def _compile(source, flags):
    def run(out):
        proc = subprocess.run([_nvcc(), *flags, "-o", out, str(source)],
                              capture_output=True, text=True)
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source.name} "
                               f"(exit {proc.returncode}):\n{text}")
        return text
    return run


def build(source, flags=NVCC_FLAGS, info=None, load=False):
    """Path of the library built from ``source`` with ``flags`` (with
    ``load``, the loaded ``ctypes.CDLL``), compiling it with nvcc first
    if the build cache holds no library of this source, flag set and
    nvcc whose digest checks. ``info`` (a dict) receives the library's
    path, the cache's ``action`` (``compiled``, ``loaded``, ``cached``)
    and, when a call with this ``info`` compiled it, nvcc's output (with
    ``-Xptxas -v``: registers, shared memory, spills) and the seconds it
    took. Raises RuntimeError when nvcc is missing or fails."""
    source = Path(source)
    flags = tuple(flags)
    return exec_cache.obtain(source, flags, (_nvcc(), "--version"),
                             _compile(source, flags), load=load,
                             info=info)


class Library:
    """One CUDA source's library: built at first use, loaded once per
    process, its C functions declared by ``bind(lib)``; a source that
    exports ``int rt_init()`` (kernel attributes such as the opt-in
    shared memory, set once rather than at every launch) has it called
    at load. ``info`` holds the build's path, the cache's action, nvcc
    output and seconds (0 when it was built already)."""

    def __init__(self, source, bind, flags=NVCC_FLAGS):
        self.source = Path(source)
        self.flags = tuple(flags)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None
        self.info = {"log": "", "seconds": 0.0, "path": None}

    def build(self):
        """Path of the built library (see :func:`build`)."""
        return build(self.source, self.flags, self.info)

    def load(self):
        """The loaded, bound library (its digest checked first, see
        :func:`build`)."""
        with self._lock:
            if self._lib is None:
                lib = build(self.source, self.flags, self.info, load=True)
                lib.rt_error_string.argtypes = [ctypes.c_int]
                lib.rt_error_string.restype = ctypes.c_char_p
                self._bind(lib)
                init = getattr(lib, "rt_init", None)
                if init is not None:
                    init.restype = ctypes.c_int
                    check(lib, f"{self.source.name} rt_init", init())
                self._lib = lib
        return self._lib


def check(lib, name, code):
    """Raise RuntimeError for a launcher's nonzero CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} "
                           f"({lib.rt_error_string(code).decode()})")


def stream(dev):
    """The current CUDA stream of ``dev``, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def require(x, name, dtype, dev, shape=None):
    """Raise ValueError unless ``x`` is a contiguous ``dtype`` tensor on
    ``dev`` (of ``shape``, when given)."""
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"{dev}, got {x.dtype} on {x.device} "
                         f"(contiguous={x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
