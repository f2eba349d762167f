"""
Cascade-stage kernels: the CUDA port of the JAX package's three Pallas
stage kernels, their plain PyTorch versions, the build loader and the
launch counters.

=====================  ==============================================
wrapper                replaces (riptide_tpu/ops/ffa_kernel.py)
=====================  ==============================================
:func:`fused_stage`    K1 ``_fused_kernel``: decode the quantised
                       byte-plane wire, pack the (m, p) container, run
                       the FFA levels, boxcar S/N
:func:`cascade_stage`  K2 ``_kernel``: FFA levels + boxcar S/N on an
                       already packed float container (the float32
                       wire, and K1's cascade half)
:func:`paired_stage`   K3 ``_fused_kernel_paired``: K1 for a row-packed
                       container, a host trial plus a same-p guest
                       trial of a later stage in the host's dead rows
=====================  ==============================================

The kernels live in ``riptide_tpu_torch/csrc/ffa_stage.cu`` (its header
says how each part maps to the Pallas code and what bounds it). They are
built with ``nvcc`` for ``sm_90a`` (``NVCC_FLAGS``) at first use, into
``riptide_tpu_torch/_build/`` keyed by a hash of the source and flags,
and loaded with ctypes, by ``utils/cuda_build.py``.

A wrapper given CUDA tensors launches its kernels on the current stream
or raises (failed build, refused shape, launch error); it never falls
back. Tensors on the CPU run the plain versions :func:`fused_stage_plain`
/ :func:`cascade_stage_plain`, built from the same plain functions the
engine uses (``search.engine._udecode_view`` and ``_pack``,
``ops.ffa.ffa_levels``, ``ops.snr.snr_batched``). Every wrapper adds one
to its entry of :data:`LAUNCHES` where it launches its kernels;
:func:`fused_stage` runs its cascade half through :func:`cascade_stage`,
so a K1 stage counts one launch of each. :func:`paired_stage` runs
the same cascade half without counting a K2 launch: K3 counts alone.

Shapes. Container (D, B, R, P) float32 with R the tables' height (rows
outside the trials kept zero because the level tables read the zero row
R - 1) and P >= every trial's p; output (D, B, RE, NW) float32 for the
first RE rows. A row-packed container's tables carry the guest
(``Tables.gm``/``gbase``, :class:`~.plan.FFABatchPlan` ``guests``), and
rows at or above a trial's guest base take the guest's S/N coefficients
(``Coefs.ghcoef``/``gbcoef``/``gstdnoise``). The TPU's p <= 2047
and PW <= 2048 limits came from packed-word fields the port does not
have; the port's one limit is the S/N kernel's shared memory,
``SNR_WARPS * P * 4`` bytes per block (at most ``MAX_DYNAMIC_SMEM``).
"""
import ctypes
from typing import NamedTuple

import torch

from ..utils import cuda_build
from ..utils.cuda_build import MAX_DYNAMIC_SMEM, NVCC_FLAGS
from ..utils.cuda_build import check as _check
from ..utils.cuda_build import require as _require
from ..utils.cuda_build import stream as _stream
from .ffa import ffa_levels
from .snr import snr_batched

__all__ = ["fused_stage", "cascade_stage", "paired_stage",
           "fused_stage_plain", "cascade_stage_plain", "paired_stage_plain",
           "StageGeom", "Tables", "Coefs", "LAUNCHES", "reset_launches",
           "build", "bucket_rows", "WIRE_MODES"]

SOURCE = cuda_build.CSRC / "ffa_stage.cu"

# Quantised wire modes: mode -> (group, planes). ``group`` consecutive
# view rows share one byte-plane row; ``planes`` byte planes per stage.
WIRE_MODES = {"uint8": (1, 1), "uint12": (2, 3), "uint6": (4, 3)}
_MODE_CODE = {"uint6": 6, "uint8": 8, "uint12": 12}

# Rows (one warp each) per boxcar_snr block, as in ffa_stage.cu.
SNR_WARPS = 4

LAUNCHES = {"fused_stage": 0, "cascade_stage": 0, "paired_stage": 0}


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class StageGeom(NamedTuple):
    """Where one stage's samples sit in the shipped byte-plane wire:
    wire row offset ``roff``, rows per plane ``pr``, scale row offset
    ``soff``, view rows ``r0`` and samples ``n``."""
    mode: str
    roff: int
    pr: int
    soff: int
    r0: int
    n: int


class Tables(NamedTuple):
    """A container's FFA level tables on the device: h, t, shift (L, B,
    R) int32; p, m (B,) int32; P the container width and ``span`` the
    largest m * p, the samples the pack reads. A row-packed container
    adds the guest's rows ``gm`` and base row ``gbase`` (B,) int32 (-1:
    no guest on that trial) and ``gspan``, the largest gm * p."""
    h: torch.Tensor
    t: torch.Tensor
    shift: torch.Tensor
    p: torch.Tensor
    m: torch.Tensor
    P: int
    span: int
    gm: torch.Tensor = None
    gbase: torch.Tensor = None
    gspan: int = 0


class Coefs(NamedTuple):
    """A container's S/N inputs on the device: widths (NW,) int32,
    hcoef and bcoef (B, NW) float32, stdnoise (B,) float32, and ``rows``
    = RE, the number of leading container rows to evaluate. A row-packed
    container adds the guest trials' own ``ghcoef``, ``gbcoef`` and
    ``gstdnoise``."""
    widths: torch.Tensor
    hcoef: torch.Tensor
    bcoef: torch.Tensor
    stdnoise: torch.Tensor
    rows: int
    ghcoef: torch.Tensor = None
    gbcoef: torch.Tensor = None
    gstdnoise: torch.Tensor = None


def bucket_rows(ms, L):
    """Container height of the TPU layout for a lane bucket of problems
    ``ms`` at depth L under the container flags: 2**L when
    ``RIPTIDE_KERNEL_BASE3=0``; else the {2**L, 3 * 2**(L-2)} family,
    plus 5 and 7 * 2**(L-3) when ``RIPTIDE_KERNEL_ROW_PACK`` is on
    (``riptide_tpu/ops/ffa_kernel.py::bucket_rows``). The port's
    container is one row taller (its zero row), so the guest bases the
    JAX package's pairing gives keep their meaning."""
    from ..utils import envflags
    from .slottables import container_rows

    if not envflags.get("RIPTIDE_KERNEL_BASE3"):
        return 1 << L
    return container_rows(max(ms), L,
                          extended=bool(envflags.get(
                              "RIPTIDE_KERNEL_ROW_PACK")))


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _bind(lib):
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rt_decode_pack.argtypes = [vp, vp, vp, vp, vp, ll, i32, i32, i32, ll,
                                   i32, ll, ll, ll, ll, i32, vp]
    lib.rt_ffa_levels.argtypes = [vp, vp, vp, vp, vp, vp, i32, ll, i32, i32,
                                  i32, vp]
    lib.rt_decode_pack_paired.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, ll, i32, i32, i32, ll, i32, ll, ll, ll,
        ll, ll, ll, ll, i32, vp]
    lib.rt_boxcar_snr.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                  ll, i32, i32, i32, i32, i32, vp]
    for fn in (lib.rt_decode_pack, lib.rt_decode_pack_paired,
               lib.rt_ffa_levels, lib.rt_boxcar_snr, lib.rt_snr_warps):
        fn.restype = i32
    if lib.rt_snr_warps() != SNR_WARPS:
        raise RuntimeError("ffa_stage.cu and ffa_kernel.py disagree on "
                           "SNR_WARPS")


_LIB = cuda_build.Library(SOURCE, _bind)
# nvcc's output (with -Xptxas -v: registers, shared memory, spills) of
# the build this process loaded, and the seconds it took (0 when the
# library was already built).
BUILD_INFO = _LIB.info


def build():
    """Path of the built kernel library, compiling it with nvcc first if
    this source and flag set have not been built yet. Raises
    RuntimeError when nvcc is missing or fails."""
    return _LIB.build()


def _library():
    return _LIB.load()



def _check_stage(tables, coefs, D, B, R, P, dev):
    L = tables.h.shape[0]
    for nm in ("h", "t", "shift"):
        _require(getattr(tables, nm), f"tables.{nm}", torch.int32, dev,
                 (L, B, R))
    _require(tables.p, "tables.p", torch.int32, dev, (B,))
    _require(tables.m, "tables.m", torch.int32, dev, (B,))
    NW = coefs.widths.shape[0]
    _require(coefs.widths, "coefs.widths", torch.int32, dev, (NW,))
    _require(coefs.hcoef, "coefs.hcoef", torch.float32, dev, (B, NW))
    _require(coefs.bcoef, "coefs.bcoef", torch.float32, dev, (B, NW))
    _require(coefs.stdnoise, "coefs.stdnoise", torch.float32, dev, (B,))
    if not 0 < coefs.rows <= R:
        raise ValueError(f"coefs.rows = {coefs.rows} outside (0, {R}]")
    if tables.gbase is not None:
        _require(tables.gm, "tables.gm", torch.int32, dev, (B,))
        _require(tables.gbase, "tables.gbase", torch.int32, dev, (B,))
        _require(coefs.ghcoef, "coefs.ghcoef", torch.float32, dev, (B, NW))
        _require(coefs.gbcoef, "coefs.gbcoef", torch.float32, dev, (B, NW))
        _require(coefs.gstdnoise, "coefs.gstdnoise", torch.float32, dev,
                 (B,))
    if SNR_WARPS * P * 4 > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"P = {P} needs {SNR_WARPS * P * 4} bytes of shared memory per "
            f"S/N block; at most {MAX_DYNAMIC_SMEM} (P <= "
            f"{MAX_DYNAMIC_SMEM // (4 * SNR_WARPS)})")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def cascade_stage_plain(container, tables, coefs):
    """Plain PyTorch K2: :func:`ffa_levels` then :func:`snr_batched`
    over the first ``coefs.rows`` rows. (..., B, R, P) -> (..., B, RE,
    NW). On a row-packed container the rows at or above a trial's guest
    base take the guest's coefficients."""
    tbuf = ffa_levels(container, tables.h, tables.t, tables.shift, tables.p)
    widths = tuple(int(w) for w in coefs.widths.tolist())
    x = tbuf[..., : coefs.rows, :]
    out = snr_batched(x, tables.p, widths, coefs.hcoef, coefs.bcoef,
                      coefs.stdnoise)
    if tables.gbase is None:
        return out
    gout = snr_batched(x, tables.p, widths, coefs.ghcoef, coefs.gbcoef,
                       coefs.gstdnoise)
    rows = torch.arange(coefs.rows, device=x.device)[None, :]
    gb = tables.gbase.to(torch.int64)[:, None]
    guest = (gb >= 0) & (rows >= gb)
    return torch.where(guest[..., None], gout, out)


def _decode(wire, scales, geom):
    """One stage's (..., n) samples out of the shipped wire."""
    from ..search.engine import _decode_stage_rows

    planes = WIRE_MODES[geom.mode][1]
    return _decode_stage_rows(geom.mode, wire, scales, geom.roff,
                              planes * geom.pr, geom.soff, geom.r0, geom.n)


def decode_pack_plain(wire, scales, geom, tables, R):
    """Plain front half of K1: decode one stage's byte planes
    (``_udecode_view``) and pack its (m, p) problems (``_pack``) into the
    (D, B, R, P) container."""
    from ..search.engine import _pack

    return _pack(_decode(wire, scales, geom), tables.p, tables.m, R,
                 tables.P)


def decode_pack_paired_plain(wire, scales, geom, guest_geom, tables, R):
    """Plain front half of K3: the host rows as :func:`decode_pack_plain`
    packs them, and each guest's (gm, p) rows from the guest stage packed
    at its base row."""
    from ..search.engine import _pack

    host = decode_pack_plain(wire, scales, geom, tables, R)
    guest = _pack(_decode(wire, scales, guest_geom), tables.p, tables.gm, R,
                  tables.P, row0=tables.gbase.clamp_min(0))
    rows = torch.arange(R, device=host.device)[None, :, None]
    gb = tables.gbase.to(torch.int64)[:, None, None]
    gm = tables.gm.to(torch.int64)[:, None, None]
    in_guest = (gb >= 0) & (rows >= gb) & (rows < gb + gm)
    return torch.where(in_guest, guest, host)


def fused_stage_plain(wire, scales, geom, tables, coefs):
    """Plain PyTorch K1: :func:`decode_pack_plain` then
    :func:`cascade_stage_plain`."""
    R = tables.h.shape[2]
    return cascade_stage_plain(decode_pack_plain(wire, scales, geom, tables,
                                                 R), tables, coefs)


def paired_stage_plain(wire, scales, geom, guest_geom, tables, coefs):
    """Plain PyTorch K3: :func:`decode_pack_paired_plain` then
    :func:`cascade_stage_plain` with the guest's coefficients on its
    rows."""
    R = tables.h.shape[2]
    return cascade_stage_plain(
        decode_pack_paired_plain(wire, scales, geom, guest_geom, tables, R),
        tables, coefs)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _cascade(container, tables, coefs):
    """Launch the level kernel L times and the S/N kernel on a checked
    (D, B, R, P) container (its own scratch); counts nothing."""
    dev = container.device
    D, B, R, P = container.shape
    lib = _library()
    L = tables.h.shape[0]
    other = torch.empty_like(container)
    stream = _stream(dev)
    _check(lib, "ffa_levels", lib.rt_ffa_levels(
        container.data_ptr(), other.data_ptr(), tables.h.data_ptr(),
        tables.t.data_ptr(), tables.shift.data_ptr(), tables.p.data_ptr(),
        L, D, B, R, P, stream))
    tbuf = container if L % 2 == 0 else other
    NW = coefs.widths.shape[0]
    out = torch.empty((D, B, coefs.rows, NW), dtype=torch.float32,
                      device=dev)
    # Null guest pointers (unpaired): every row takes the host's
    # coefficients.
    guest = (tables.gbase, coefs.ghcoef, coefs.gbcoef, coefs.gstdnoise)
    _check(lib, "boxcar_snr", lib.rt_boxcar_snr(
        tbuf.data_ptr(), out.data_ptr(), tables.p.data_ptr(),
        coefs.widths.data_ptr(), coefs.hcoef.data_ptr(),
        coefs.bcoef.data_ptr(), coefs.stdnoise.data_ptr(),
        *(None if tables.gbase is None else x.data_ptr() for x in guest),
        D, B, R, P, coefs.rows, NW, stream))
    return out


def cascade_stage(container, tables, coefs):
    """K2: FFA levels + boxcar S/N of a packed (D, B, R, P) float32
    container -> (D, B, RE, NW) float32. CUDA tensors launch the kernels
    of ``ffa_stage.cu`` (L level launches ping-ponging two buffers, then
    the S/N kernel); CPU tensors run :func:`cascade_stage_plain`."""
    if container.device.type == "cpu":
        return cascade_stage_plain(container, tables, coefs)
    dev = container.device
    D, B, R, P = container.shape
    _require(container, "container", torch.float32, dev)
    _check_stage(tables, coefs, D, B, R, P, dev)
    if P != tables.P:
        raise ValueError(f"container width {P} != tables.P {tables.P}")
    out = _cascade(container, tables, coefs)
    LAUNCHES["cascade_stage"] += 1
    return out


def _check_wire(wire, scales, geom, span, dev):
    if geom.mode not in WIRE_MODES:
        raise ValueError(f"the fused stages take a quantised wire "
                         f"{tuple(WIRE_MODES)}, got {geom.mode!r}")
    _require(wire, "wire", torch.uint8, dev)
    if wire.dim() != 3 or scales.dim() != 2 or scales.shape[0] != wire.shape[0]:
        raise ValueError(f"want wire (D, WROWS, PW) and scales (D, STOT), "
                         f"got {tuple(wire.shape)} / {tuple(scales.shape)}")
    _require(scales, "scales", torch.float32, dev)
    D, wrows, PW = wire.shape
    group, planes = WIRE_MODES[geom.mode]
    if (geom.roff + planes * geom.pr > wrows
            or geom.soff + geom.r0 > scales.shape[1]
            or geom.n > geom.r0 * PW or geom.r0 > group * geom.pr
            or span > geom.n):
        raise ValueError(f"stage geometry {geom} outside the wire "
                         f"{tuple(wire.shape)} / scales {tuple(scales.shape)}")


def fused_stage(wire, scales, geom, tables, coefs):
    """K1: one cascade stage (or lane bucket) from the shipped quantised
    wire.

    wire (D, WROWS, PW) uint8 and scales (D, STOT) float32 are the whole
    shipped byte-plane view (``search.engine._view_layout``); ``geom``
    locates this stage in it. Returns (D, B, RE, NW) float32. CUDA
    tensors launch ``decode_pack`` into a fresh (D, B, R, P) container
    and then :func:`cascade_stage`; CPU tensors run
    :func:`fused_stage_plain`. The container is modified in place by the
    level ping-pong (it is this call's own scratch)."""
    if wire.device.type == "cpu":
        return fused_stage_plain(wire, scales, geom, tables, coefs)
    dev = wire.device
    _check_wire(wire, scales, geom, tables.span, dev)
    if tables.gbase is not None:
        raise ValueError("fused_stage takes unpaired tables; a row-packed "
                         "container runs paired_stage")
    D, wrows, PW = wire.shape
    B = tables.p.shape[0]
    R = tables.h.shape[2]
    P = tables.P
    _check_stage(tables, coefs, D, B, R, P, dev)
    lib = _library()
    container = torch.empty((D, B, R, P), dtype=torch.float32, device=dev)
    _check(lib, "decode_pack", lib.rt_decode_pack(
        wire.data_ptr(), scales.data_ptr(), tables.m.data_ptr(),
        tables.p.data_ptr(), container.data_ptr(), D, B, R, P, wrows, PW,
        scales.shape[1], geom.roff, geom.pr, geom.soff,
        _MODE_CODE[geom.mode], _stream(dev)))
    LAUNCHES["fused_stage"] += 1
    return cascade_stage(container, tables, coefs)


def paired_stage(wire, scales, geom, guest_geom, tables, coefs):
    """K3: one row-packed lane bucket from the shipped quantised wire.

    As :func:`fused_stage`, with ``guest_geom`` locating the guest stage
    in the same wire, and ``tables``/``coefs`` carrying the guest
    (``gm``, ``gbase``; ``ghcoef``, ``gbcoef``, ``gstdnoise``). Returns
    (D, B, RE, NW) float32 holding both trials: host rows from 0, guest
    rows from each trial's base. CUDA tensors launch
    ``decode_pack_paired`` and the cascade half (counted here, not as a
    K2 launch); CPU tensors run :func:`paired_stage_plain`."""
    if wire.device.type == "cpu":
        return paired_stage_plain(wire, scales, geom, guest_geom, tables,
                                  coefs)
    dev = wire.device
    if tables.gbase is None or coefs.ghcoef is None:
        raise ValueError("paired_stage needs guest tables and coefficients")
    if guest_geom.mode != geom.mode:
        raise ValueError(f"host wire {geom.mode!r}, guest {guest_geom.mode!r}")
    _check_wire(wire, scales, geom, tables.span, dev)
    _check_wire(wire, scales, guest_geom, tables.gspan, dev)
    D, wrows, PW = wire.shape
    B = tables.p.shape[0]
    R = tables.h.shape[2]
    P = tables.P
    _check_stage(tables, coefs, D, B, R, P, dev)
    lib = _library()
    container = torch.empty((D, B, R, P), dtype=torch.float32, device=dev)
    _check(lib, "decode_pack_paired", lib.rt_decode_pack_paired(
        wire.data_ptr(), scales.data_ptr(), tables.m.data_ptr(),
        tables.p.data_ptr(), tables.gm.data_ptr(), tables.gbase.data_ptr(),
        container.data_ptr(), D, B, R, P, wrows, PW, scales.shape[1],
        geom.roff, geom.pr, geom.soff, guest_geom.roff, guest_geom.pr,
        guest_geom.soff, _MODE_CODE[geom.mode], _stream(dev)))
    out = _cascade(container, tables, coefs)
    LAUNCHES["paired_stage"] += 1
    return out
