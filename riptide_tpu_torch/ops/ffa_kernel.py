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
                       wire); K1 and K3 share its kernels
:func:`paired_stage`   K3 ``_fused_kernel_paired``: K1 for a row-packed
                       container, a host trial plus a same-p guest
                       trial of a later stage in the host's dead rows
=====================  ==============================================

The kernels live in ``riptide_tpu_torch/csrc/ffa_stage.cu`` (its header
says how each part maps to the Pallas code and what bounds it). They are
built with ``nvcc`` for ``sm_90a`` (``NVCC_FLAGS``) at first use, into
the build cache (``utils/exec_cache.py``) keyed by the source, the flags
and nvcc's version, checked against its digest and loaded with ctypes,
by ``utils/cuda_build.py``.

Each stage is three kinds of CUDA launch: the segment kernel
(``segment_cascade_kernel``) fills shared-memory row tiles (from the
wire for K1 and K3, from the packed container for K2) and runs the
container's leading ``Tables.local`` levels there
(:func:`~.plan.segment_plan`), ``ffa_level`` runs each
remaining level over the whole container, and ``boxcar_snr`` computes
the S/N. :func:`segment_levels` runs the first two and returns the
container, for checks.

A wrapper given CUDA tensors launches its kernels on the current stream
or raises (failed build, refused shape, launch error); it never falls
back. Tensors on the CPU run the plain versions :func:`fused_stage_plain`
/ :func:`cascade_stage_plain` / :func:`paired_stage_plain`, built from
the same plain functions the engine uses (``search.engine._udecode_view``
and ``_pack``, ``ops.ffa.ffa_levels``, ``ops.snr.snr_batched``).
:func:`segment_levels_plain` runs the levels as the kernels split them
(tile by tile, then over the container), for the tests.

Counts. Every wrapper adds one to its own entry of :data:`LAUNCHES`
where it launches its kernels, and to no other. :data:`KERNEL_LAUNCHES`
counts the CUDA launches by kernel: the segment kernel's two forms apart
(``segment_wire`` fills its tiles from the wire, for K1 and K3;
``segment_container`` from a packed float container, for K2).
:data:`SNR_FORMS` counts a card's narrow S/N launches again, by the
register form P picks (:func:`snr_regs`).

Shape only. Tensors on the ``meta`` device take the card's path with
the :class:`ShapeOnlyLibrary` in place of the built one: the wrapper
checks its operands, allocates its buffers (meta tensors: shapes, no
memory), counts into the calling thread's :func:`shape_only` counters
instead of :data:`LAUNCHES`/:data:`KERNEL_LAUNCHES`, and each "launch"
only records its arguments. The shape-only walk of the stage loop
(``search.engine.walk_search``) reads the launch contract and the
peak-memory model from it; nothing runs and no card is needed.

Shapes. Container (D, B, R, P) float32 with R the tables' height (rows
outside the trials kept zero because the level tables read the zero row
R - 1) and P >= every trial's p; output (D, B, RE, NW) float32 for the
first RE rows. A row-packed container's tables carry the guest
(``Tables.gm``/``gbase``, :class:`~.plan.FFABatchPlan` ``guests``), and
rows at or above a trial's guest base take the guest's S/N coefficients
(``Coefs.ghcoef``/``gbcoef``/``gstdnoise``). The TPU's p <= 2047
and PW <= 2048 limits came from packed-word fields the port does not
have, and the kernels take every phase width up to :data:`MAX_P`.

Wide phases. P alone picks each kernel's form. Up to :data:`NARROW_P`
(14,528) a level launch gives each row a warp and the S/N kernel keeps
four rows' prefix sums in a block's shared memory (up to P = 2,048 each
lane keeps its phases' sums in registers too, in a form P picks:
:func:`snr_regs`). A wider container
(where, too, no row pair fits a segment tile, so every level is a level
launch, :func:`~.plan.segment_plan`) takes the wide forms: each level
over (row x column) blocks (:func:`level_grid`), and the S/N one row a
block, or a row a cluster of 2-8 blocks sharing their shared memory past
58,112 (:func:`snr_launch`), in the narrow kernel's summation order, so
a trial's S/N has the same bits in either form.
"""
import contextlib
import ctypes
import threading
from typing import NamedTuple

import torch

from ..utils import cuda_build
from ..utils.cuda_build import MAX_DYNAMIC_SMEM, NVCC_FLAGS
from ..utils.cuda_build import check as _check
from ..utils.cuda_build import require as _require
from ..utils.cuda_build import stream as _stream
from .ffa import _level_step, ffa_levels
from .snr import snr_batched

__all__ = ["fused_stage", "cascade_stage", "paired_stage", "segment_levels",
           "fused_stage_plain", "cascade_stage_plain", "paired_stage_plain",
           "segment_levels_plain", "fill_plain", "StageGeom", "WireSource",
           "Tables", "Coefs", "LAUNCHES", "KERNEL_LAUNCHES", "reset_launches",
           "build", "bucket_rows", "snr_launch", "SnrLaunch", "level_grid",
           "snr_regs", "SNR_FORMS", "NARROW_P", "MAX_P", "WIRE_MODES",
           "ShapeOnlyLibrary", "shape_only"]

SOURCE = cuda_build.CSRC / "ffa_stage.cu"

# Quantised wire modes: mode -> (group, planes). ``group`` consecutive
# view rows share one byte-plane row; ``planes`` byte planes per stage.
WIRE_MODES = {"uint8": (1, 1), "uint12": (2, 3), "uint6": (4, 3)}
_MODE_CODE = {"uint6": 6, "uint8": 8, "uint12": 12}

# Rows (one warp each) per narrow boxcar_snr block, as in ffa_stage.cu.
SNR_WARPS = 4
# The widest container of the narrow forms (ffa_stage.cu's kNarrowP):
# SNR_WARPS rows of P floats fill a block's shared memory.
NARROW_P = MAX_DYNAMIC_SMEM // (4 * SNR_WARPS)
# The wide forms (ffa_stage.cu): threads of a level block and the
# columns it covers, threads of an S/N block, the most blocks of an S/N
# cluster and so the widest container the S/N kernel takes.
COL_THREADS, COL_SPAN = 256, 1024
ROW_THREADS, MAX_CLUSTER = 1024, 8
MAX_P = MAX_CLUSTER * MAX_DYNAMIC_SMEM // 4
# The narrow S/N's register forms (ffa_stage.cu's snr_regs): a lane keeps
# ceil(P / 32) prefix sums in registers, the bound rounded up to a
# multiple of SNR_REGS_STEP, up to SNR_REGS_MAX (P <= 2,048).
SNR_REGS_STEP, SNR_REGS_MAX = 4, 64


class SnrLaunch(NamedTuple):
    """The S/N kernel's launch shape: evaluated ``rows`` a block and
    ``threads`` a block, blocks a ``cluster`` (1: none), and each block's
    dynamic shared memory ``smem`` in bytes. The grid is ceil(rows of
    the container / rows) * cluster blocks."""
    rows: int
    threads: int
    cluster: int
    smem: int


def snr_launch(P):
    """The S/N kernel's :class:`SnrLaunch` for container width P, as
    ``rt_boxcar_snr`` launches it. Up to :data:`NARROW_P`: SNR_WARPS rows
    a block, one warp each, their prefix sums in shared memory. Wider:
    one row a block of ROW_THREADS threads, or a cluster of 2, 4 or 8
    blocks, the fewest whose shares of the row's 32 chunks of ceil(P /
    32) phases each fit a block's shared memory (one block up to P =
    58,112, two up to 116,224). Raises ValueError past :data:`MAX_P`."""
    P = int(P)
    if P <= NARROW_P:
        return SnrLaunch(SNR_WARPS, 32 * SNR_WARPS, 1, SNR_WARPS * P * 4)
    chunk = -(-P // 32)
    n = 1
    while n <= MAX_CLUSTER:
        held = min(P, 32 // n * chunk)
        if held * 4 <= MAX_DYNAMIC_SMEM:
            return SnrLaunch(1, ROW_THREADS, n, held * 4)
        n *= 2
    raise ValueError(f"container width P = {P} past the S/N kernel's "
                     f"widest, {MAX_P}")


def snr_regs(P):
    """The narrow S/N kernel's register form at container width P, as
    ``rt_boxcar_snr`` picks it: the prefix sums a lane keeps in registers
    through the width loop, ceil(P / 32) rounded up to a multiple of
    SNR_REGS_STEP; 0 past SNR_REGS_MAX of them (P > 2,048: the form that
    keeps them in shared memory alone); None past :data:`NARROW_P`, where
    the wide kernel runs. Every form gives the same bits."""
    P = int(P)
    if P > NARROW_P:
        return None
    n = -(-P // 32)
    return 0 if n > SNR_REGS_MAX else -(-n // SNR_REGS_STEP) * SNR_REGS_STEP


def level_grid(D, B, R, P):
    """(blocks, threads a block) of one level launch over a (D, B, R, P)
    container, as ``rt_ffa_levels`` launches it: up to :data:`NARROW_P`
    a warp a row, 8 rows a block; wider, COL_THREADS threads over
    COL_SPAN columns a block (4 consecutive phases a thread), every row
    cut into ceil(P / COL_SPAN) column blocks."""
    if P <= NARROW_P:
        return D * B * -(-R // 8), 256
    return D * B * R * -(-P // COL_SPAN), COL_THREADS


LAUNCHES = {"fused_stage": 0, "cascade_stage": 0, "paired_stage": 0}
KERNEL_LAUNCHES = {"segment_wire": 0, "segment_container": 0,
                   "ffa_level": 0, "boxcar_snr": 0}
# Narrow S/N launches on a card by register form (:func:`snr_regs`):
# {form: launches}, a form's key present once it has run.
SNR_FORMS = {}


def reset_launches():
    """Set every launch count to 0 (wrapper calls and CUDA launches) and
    empty :data:`SNR_FORMS`."""
    for counts in (LAUNCHES, KERNEL_LAUNCHES):
        for k in counts:
            counts[k] = 0
    SNR_FORMS.clear()


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


class WireSource(NamedTuple):
    """A container's samples in the shipped wire (D, WROWS, PW) uint8
    and scales (D, STOT) float32: the host stage at ``geom`` and, for a
    row-packed container, the guest stage at ``guest``."""
    wire: torch.Tensor
    scales: torch.Tensor
    geom: StageGeom
    guest: StageGeom = None


class Tables(NamedTuple):
    """A container's FFA level tables on the device: h, t, shift (L, B,
    R) int32; p, m (B,) int32; P the container width and ``span`` the
    largest m * p, the samples the pack reads. ``tiles`` (ntiles, 4)
    int32, ``local`` and ``smem`` are its :class:`~.plan.SegmentPlan`:
    the segment kernel's tiles, the levels it runs and its shared memory
    per block (CUDA tables only; without them the plain levels run
    every level over the container). A row-packed container adds the guest's rows ``gm`` and
    base row ``gbase`` (B,) int32 (-1: no guest on that trial) and
    ``gspan``, the largest gm * p."""
    h: torch.Tensor
    t: torch.Tensor
    shift: torch.Tensor
    p: torch.Tensor
    m: torch.Tensor
    P: int
    span: int
    tiles: torch.Tensor = None
    local: int = 0
    smem: int = 0
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
    ``ms`` at depth L: the smallest of the {2**L, 3 * 2**(L-2), 5 and
    7 * 2**(L-3)} family that holds them
    (``riptide_tpu/ops/ffa_kernel.py::bucket_rows`` at its defaults).
    The port's container is one row taller (its zero row), so the guest
    bases the JAX package's pairing gives keep their meaning."""
    from .slottables import container_rows

    return container_rows(max(ms), L, extended=True)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _bind(lib):
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rt_segment_cascade.argtypes = [
        vp, vp, vp, vp, i32, vp, vp, vp, vp, vp, vp, vp, vp, ll, i32, i32,
        i32, i32, i32, ll, i32, ll, ll, ll, ll, ll, ll, ll, i32, vp]
    lib.rt_ffa_levels.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, ll, i32,
                                  i32, i32, vp]
    lib.rt_boxcar_snr.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                  ll, i32, i32, i32, i32, i32, vp]
    lib.rt_snr_blocks.argtypes = lib.rt_snr_smem.argtypes = [ll]
    lib.rt_snr_regs.argtypes = [ll]
    lib.rt_level_blocks.argtypes = [ll, i32, i32, i32]
    lib.rt_level_blocks.restype = ll
    for fn in (lib.rt_segment_cascade, lib.rt_ffa_levels, lib.rt_boxcar_snr,
               lib.rt_snr_warps, lib.rt_max_dynamic_smem, lib.rt_snr_blocks,
               lib.rt_snr_smem, lib.rt_snr_regs):
        fn.restype = i32
    if lib.rt_snr_warps() != SNR_WARPS:
        raise RuntimeError("ffa_stage.cu and ffa_kernel.py disagree on "
                           "SNR_WARPS")
    if lib.rt_max_dynamic_smem() != MAX_DYNAMIC_SMEM:
        raise RuntimeError("ffa_stage.cu and cuda_build.py disagree on "
                           "MAX_DYNAMIC_SMEM")
    for P in _SHAPE_CHECKS:
        want = snr_launch(P) if P <= MAX_P else SnrLaunch(0, 0, 0, 0)
        if (lib.rt_snr_blocks(P), lib.rt_snr_smem(P)) != (want.cluster,
                                                          want.smem):
            raise RuntimeError(f"ffa_stage.cu and ffa_kernel.py disagree "
                               f"on the S/N launch at P = {P}")
        if lib.rt_level_blocks(2, 9, 24, P) != level_grid(2, 9, 24, P)[0]:
            raise RuntimeError(f"ffa_stage.cu and ffa_kernel.py disagree "
                               f"on the level grid at P = {P}")
    for P in _SHAPE_CHECKS + _REGS_CHECKS:
        want = snr_regs(P)
        if lib.rt_snr_regs(P) != (-1 if want is None else want):
            raise RuntimeError(f"ffa_stage.cu and ffa_kernel.py disagree "
                               f"on the S/N register form at P = {P}")


# Widths at which the library's launch shapes are held to snr_launch and
# level_grid when it loads: each form's edges.
_SHAPE_CHECKS = (128, NARROW_P, NARROW_P + 1, 29056, 58112, 58113, 116224,
                 116225, MAX_P, MAX_P + 1)
# ... and the narrow S/N's register forms: each bound's edges.
_REGS_CHECKS = (1, 32, 33, 128, 129, 256, 257, 2048, 2049)


_LIB = cuda_build.Library(SOURCE, _bind)
# nvcc's output (with -Xptxas -v: registers, shared memory, spills) of
# the build this process loaded, and the seconds it took (0 when the
# library was already built).
BUILD_INFO = _LIB.info


def build():
    """Path of the built kernel library, compiling it with nvcc first if
    the build cache holds no library of this source, flag set and nvcc.
    Raises RuntimeError when nvcc is missing or fails."""
    return _LIB.build()


def _library():
    return _LIB.load()


class ShapeOnlyLibrary:
    """The kernel library as the meta device sees it: every launcher
    (``rt_*``) appends ``(name, args)`` to the calling thread's
    :func:`shape_only` record and returns 0, launching nothing. Its
    pointer arguments are the addresses the walk gave the meta tensors'
    storages (:func:`_ptr`, ``search.engine.walk_search``)."""

    def __getattr__(self, name):
        if not name.startswith("rt_"):
            raise AttributeError(name)

        def launcher(*args):
            _shape_state().calls.append((name[3:], args))
            return 0
        return launcher


_SHAPE_LIB = ShapeOnlyLibrary()
_SHAPE = threading.local()


def _shape_state():
    st = getattr(_SHAPE, "state", None)
    if st is None:
        raise RuntimeError("meta tensors reach the stage kernels only "
                           "inside ffa_kernel.shape_only()")
    return st


class _ShapeState:
    def __init__(self):
        self.launches = dict.fromkeys(LAUNCHES, 0)
        self.kernels = dict.fromkeys(KERNEL_LAUNCHES, 0)
        self.calls = []
        self.address = lambda x: 0


@contextlib.contextmanager
def shape_only():
    """Counters of the calling thread's shape-only launches: yields an
    object with ``launches`` and ``kernels`` (keyed as :data:`LAUNCHES`
    and :data:`KERNEL_LAUNCHES`) and ``calls``, every
    :class:`ShapeOnlyLibrary` call in order. Other threads' counts,
    and the card's, are untouched."""
    prev = getattr(_SHAPE, "state", None)
    _SHAPE.state = _ShapeState()
    try:
        yield _SHAPE.state
    finally:
        _SHAPE.state = prev


def _ptr(x):
    """``x.data_ptr()``; for a meta tensor the address the calling
    thread's walk gave its storage (0 outside a walk)."""
    if x.device.type == "meta":
        return _shape_state().address(x)
    return x.data_ptr()


def _runtime(dev):
    """(library, stream, wrapper counts, kernel counts) of a launch on
    ``dev``: the built library on the card's current stream and the
    module counters, or on the meta device the shape-only library and
    the thread's :func:`shape_only` counters."""
    if dev.type == "meta":
        st = _shape_state()
        return _SHAPE_LIB, None, st.launches, st.kernels
    return _library(), _stream(dev), LAUNCHES, KERNEL_LAUNCHES


def _check_tables(tables, B, R, dev):
    L = tables.h.shape[0]
    for nm in ("h", "t", "shift"):
        _require(getattr(tables, nm), f"tables.{nm}", torch.int32, dev,
                 (L, B, R))
    _require(tables.p, "tables.p", torch.int32, dev, (B,))
    _require(tables.m, "tables.m", torch.int32, dev, (B,))
    if tables.tiles is not None:
        _require(tables.tiles, "tables.tiles", torch.int32, dev,
                 (tables.tiles.shape[0], 4))
    if not 0 <= tables.local <= L or tables.smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"segment plan: {tables.local} local levels of "
                         f"{L}, {tables.smem} bytes of shared memory per "
                         f"tile (at most {MAX_DYNAMIC_SMEM})")
    if tables.gbase is not None:
        _require(tables.gm, "tables.gm", torch.int32, dev, (B,))
        _require(tables.gbase, "tables.gbase", torch.int32, dev, (B,))


def _check_stage(tables, coefs, D, B, R, P, dev):
    _check_tables(tables, B, R, dev)
    snr_launch(P)  # raises past the S/N kernel's widest container
    NW = coefs.widths.shape[0]
    _require(coefs.widths, "coefs.widths", torch.int32, dev, (NW,))
    _require(coefs.hcoef, "coefs.hcoef", torch.float32, dev, (B, NW))
    _require(coefs.bcoef, "coefs.bcoef", torch.float32, dev, (B, NW))
    _require(coefs.stdnoise, "coefs.stdnoise", torch.float32, dev, (B,))
    if not 0 < coefs.rows <= R:
        raise ValueError(f"coefs.rows = {coefs.rows} outside (0, {R}]")
    if tables.gbase is not None:
        _require(coefs.ghcoef, "coefs.ghcoef", torch.float32, dev, (B, NW))
        _require(coefs.gbcoef, "coefs.gbcoef", torch.float32, dev, (B, NW))
        _require(coefs.gstdnoise, "coefs.gstdnoise", torch.float32, dev,
                 (B,))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _snr_plain(x, tables, coefs):
    """Plain boxcar S/N of the first ``coefs.rows`` rows of a transformed
    container; on a row-packed container the rows at or above a trial's
    guest base take the guest's coefficients."""
    widths = tuple(int(w) for w in coefs.widths.tolist())
    x = x[..., : coefs.rows, :]
    out = snr_batched(x, tables.p, widths, coefs.hcoef, coefs.bcoef,
                      coefs.stdnoise)
    if tables.gbase is None:
        return out
    gout = snr_batched(x, tables.p, widths, coefs.ghcoef, coefs.gbcoef,
                       coefs.gstdnoise)
    rows = torch.arange(coefs.rows, dtype=torch.int64,
                        device=x.device)[None, :]
    gb = tables.gbase.to(torch.int64)[:, None]
    guest = (gb >= 0) & (rows >= gb)
    return torch.where(guest[..., None], gout, out)


def cascade_stage_plain(container, tables, coefs):
    """Plain PyTorch K2: :func:`ffa_levels` then :func:`snr_batched`
    over the first ``coefs.rows`` rows. (..., B, R, P) -> (..., B, RE,
    NW). On a row-packed container the rows at or above a trial's guest
    base take the guest's coefficients."""
    tbuf = ffa_levels(container, tables.h, tables.t, tables.shift, tables.p)
    return _snr_plain(tbuf, tables, coefs)


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
    rows = torch.arange(R, dtype=torch.int64,
                        device=host.device)[None, :, None]
    gb = tables.gbase.to(torch.int64)[:, None, None]
    gm = tables.gm.to(torch.int64)[:, None, None]
    in_guest = (gb >= 0) & (rows >= gb) & (rows < gb + gm)
    return torch.where(in_guest, guest, host)


def fill_plain(source, tables):
    """The unmerged (D, B, R, P) container of ``source``: a float
    container as it is, or a :class:`WireSource` decoded and packed
    (:func:`decode_pack_plain`, :func:`decode_pack_paired_plain`)."""
    if not isinstance(source, WireSource):
        return source
    R = tables.h.shape[2]
    if source.guest is None:
        return decode_pack_plain(source.wire, source.scales, source.geom,
                                 tables, R)
    return decode_pack_paired_plain(source.wire, source.scales, source.geom,
                                    source.guest, tables, R)


def _tile_levels_plain(x, tables):
    """The segment kernel's work on a filled container, tile by tile:
    each live tile's rows gathered into a block of their own (a zero row
    appended), the leading ``tables.local`` levels run there with the
    tables rebased to the tile, and the rows written back; dead tiles
    and phases from p on written zero. Tables without a segment plan
    run no level here."""
    if tables.tiles is None:
        return x
    dev = x.device
    R, P = x.shape[-2:]
    tiles = tables.tiles.to(dev, torch.int64)
    live = tiles[tiles[:, 3] == 1]
    out = torch.zeros_like(x)
    if live.shape[0] == 0:
        return out
    b, r0, n = live[:, 0], live[:, 1], live[:, 2]
    T = int(n.max())
    i = torch.arange(T, dtype=torch.int64, device=dev)
    inside = i[None, :] < n[:, None]
    rows = torch.where(inside, r0[:, None] + i[None, :], R - 1)
    blk = x[..., b[:, None], rows, :]
    blk = torch.cat([blk, torch.zeros_like(blk[..., :1, :])], dim=-2)
    Z = torch.full((b.shape[0], 1), T, dtype=torch.int64, device=dev)

    def local(tab):
        # Rebase to the tile: the container's zero row, and the slots
        # past a tile's rows, read the block's zero row T.
        lt = torch.where(inside & (tab != R - 1), tab - r0[:, None], T)
        return torch.cat([lt, Z], dim=1)

    p = tables.p.to(dev)[b]
    for lev in range(tables.local):
        tab = [tables.h[lev], tables.t[lev], tables.shift[lev]]
        tab = [x_.to(dev, torch.int64)[b[:, None], rows] for x_ in tab]
        shift = torch.cat([tab[2], torch.zeros_like(Z)], dim=1)
        blk = _level_step(blk, local(tab[0]), local(tab[1]), shift, p)
    cols = torch.arange(P, dtype=torch.int64, device=dev)
    blk = torch.where(cols < p[:, None, None], blk[..., :T, :], 0.0)
    bi = b[:, None].expand(-1, T)[inside]
    out[..., bi, rows[inside], :] = blk[..., inside, :]
    return out


def segment_levels_plain(source, tables, levels=None):
    """Plain version of :func:`segment_levels`: :func:`fill_plain`, the
    segment kernel's tile levels (:func:`_tile_levels_plain`), then
    ``levels`` (default all) of the remaining levels over the whole
    container with :func:`ffa_levels`. Bitwise equal to
    :func:`ffa_levels` over the same leading levels of the filled
    container."""
    L, first = tables.h.shape[0], tables.local
    last = L if levels is None else first + levels
    x = _tile_levels_plain(fill_plain(source, tables), tables)
    return ffa_levels(x, tables.h[first:last], tables.t[first:last],
                      tables.shift[first:last], tables.p)


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

def _levels(rt, source, tables, D, levels=None, scratch=None):
    """Launch the segment kernel and the remaining levels (``levels`` of
    them, default all) on checked operands. Returns the container: a
    fresh (D, B, R, P) buffer, or ``scratch`` (the level ping-pong's
    second buffer, fresh when None)."""
    if tables.tiles is None:
        raise ValueError("the CUDA stage kernels need the tables' segment "
                         "plan (tiles, local, smem)")
    lib, stream, _, kernels = rt
    B, R, P = tables.p.shape[0], tables.h.shape[2], tables.P
    dev = tables.h.device
    a = torch.empty((D, B, R, P), dtype=torch.float32, device=dev)
    src = wire = scales = gm = gbase = None
    wrows = PW = stot = mode = 0
    host = guest = (0, 0, 0)
    if isinstance(source, WireSource):
        geom = source.geom
        wire, scales = _ptr(source.wire), _ptr(source.scales)
        wrows, PW = source.wire.shape[1:]
        stot, mode = source.scales.shape[1], _MODE_CODE[geom.mode]
        host = (geom.roff, geom.pr, geom.soff)
        if source.guest is not None:
            g = source.guest
            guest = (g.roff, g.pr, g.soff)
            gm, gbase = _ptr(tables.gm), _ptr(tables.gbase)
    else:
        src = _ptr(source)
    _check(lib, "segment_cascade", lib.rt_segment_cascade(
        src, wire, scales, _ptr(tables.tiles), tables.tiles.shape[0],
        _ptr(tables.h), _ptr(tables.t), _ptr(tables.shift),
        _ptr(tables.m), _ptr(tables.p), gm, gbase, _ptr(a),
        D, B, R, P, tables.local, tables.smem, wrows, PW, stot, *host,
        *guest, mode, stream))
    kernels["segment_wire" if isinstance(source, WireSource)
            else "segment_container"] += 1
    last = tables.h.shape[0] if levels is None else tables.local + levels
    if last == tables.local:
        return a
    b = torch.empty_like(a) if scratch is None else scratch
    _check(lib, "ffa_levels", lib.rt_ffa_levels(
        _ptr(a), _ptr(b), _ptr(tables.h), _ptr(tables.t),
        _ptr(tables.shift), _ptr(tables.p), tables.local, last, D,
        B, R, P, stream))
    kernels["ffa_level"] += last - tables.local
    return a if (last - tables.local) % 2 == 0 else b


def _snr(rt, x, tables, coefs):
    """Launch the S/N kernel on a transformed (D, B, R, P) container,
    in the launch shape :func:`snr_launch` gives P."""
    lib, stream, _, kernels = rt
    D, B, R, P = x.shape
    NW = coefs.widths.shape[0]
    out = torch.empty((D, B, coefs.rows, NW), dtype=torch.float32,
                      device=x.device)
    # Null guest pointers (unpaired): every row takes the host's
    # coefficients.
    guest = (tables.gbase, coefs.ghcoef, coefs.gbcoef, coefs.gstdnoise)
    _check(lib, "boxcar_snr", lib.rt_boxcar_snr(
        _ptr(x), _ptr(out), _ptr(tables.p),
        _ptr(coefs.widths), _ptr(coefs.hcoef),
        _ptr(coefs.bcoef), _ptr(coefs.stdnoise),
        *(None if tables.gbase is None else _ptr(g) for g in guest),
        D, B, R, P, coefs.rows, NW, stream))
    kernels["boxcar_snr"] += 1
    form = snr_regs(P)
    if form is not None and x.device.type != "meta":
        SNR_FORMS[form] = SNR_FORMS.get(form, 0) + 1
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


def _check_source(source, tables):
    """Check a level source against its tables; returns D."""
    dev = tables.h.device
    B, R, P = tables.p.shape[0], tables.h.shape[2], tables.P
    if isinstance(source, WireSource):
        _check_wire(source.wire, source.scales, source.geom, tables.span,
                    dev)
        paired = source.guest is not None
        if paired != (tables.gbase is not None):
            raise ValueError("a row-packed container needs guest tables "
                             "and a guest stage, an unpaired one neither")
        if paired:
            if source.guest.mode != source.geom.mode:
                raise ValueError(f"host wire {source.geom.mode!r}, guest "
                                 f"{source.guest.mode!r}")
            _check_wire(source.wire, source.scales, source.guest,
                        tables.gspan, dev)
        return source.wire.shape[0]
    _require(source, "container", torch.float32, dev)
    if source.dim() != 4 or tuple(source.shape[1:]) != (B, R, P):
        raise ValueError(f"container {tuple(source.shape)}, want "
                         f"(D, {B}, {R}, {P}) by the tables")
    return source.shape[0]


def segment_levels(source, tables, levels=None):
    """The container after the segment kernel and ``levels`` (default
    all) of the remaining FFA levels: (D, B, R, P) float32. ``source`` is
    a packed float container (K2's input; not modified) or a
    :class:`WireSource` (K1, and K3 with its guest stage). CUDA tensors
    launch the kernels; CPU tensors run :func:`segment_levels_plain`.
    Counts no :data:`LAUNCHES` entry."""
    if tables.h.device.type == "cpu":
        return segment_levels_plain(source, tables, levels)
    D = _check_source(source, tables)
    _check_tables(tables, tables.p.shape[0], tables.h.shape[2],
                  tables.h.device)
    if levels is not None and not (
            0 <= levels <= tables.h.shape[0] - tables.local):
        raise ValueError(f"levels = {levels} outside [0, "
                         f"{tables.h.shape[0] - tables.local}]")
    return _levels(_runtime(tables.h.device), source, tables, D, levels)


def _stage(kind, source, tables, coefs, scratch=None):
    """Check, then launch the segment kernel, the remaining levels and
    the S/N kernel; count one ``kind`` launch."""
    D = _check_source(source, tables)
    B, R, P = tables.p.shape[0], tables.h.shape[2], tables.P
    _check_stage(tables, coefs, D, B, R, P, tables.h.device)
    rt = _runtime(tables.h.device)
    x = _levels(rt, source, tables, D, scratch=scratch)
    out = _snr(rt, x, tables, coefs)
    rt[2][kind] += 1
    return out


def cascade_stage(container, tables, coefs):
    """K2: FFA levels + boxcar S/N of a packed (D, B, R, P) float32
    container -> (D, B, RE, NW) float32. CUDA tensors launch the kernels
    of ``ffa_stage.cu`` (the segment kernel from the container, each
    remaining level, the S/N kernel); the container is this call's
    scratch (the levels' second buffer). CPU tensors run
    :func:`cascade_stage_plain`."""
    if container.device.type == "cpu":
        return cascade_stage_plain(container, tables, coefs)
    return _stage("cascade_stage", container, tables, coefs,
                  scratch=container)


def fused_stage(wire, scales, geom, tables, coefs):
    """K1: one cascade stage (or lane bucket) from the shipped quantised
    wire.

    wire (D, WROWS, PW) uint8 and scales (D, STOT) float32 are the whole
    shipped byte-plane view (``search.engine._view_layout``); ``geom``
    locates this stage in it. Returns (D, B, RE, NW) float32. CUDA
    tensors launch the segment kernel from the wire, each remaining
    level and the S/N kernel, counted as one K1 launch; CPU tensors run
    :func:`fused_stage_plain`."""
    if wire.device.type == "cpu":
        return fused_stage_plain(wire, scales, geom, tables, coefs)
    if tables.gbase is not None:
        raise ValueError("fused_stage takes unpaired tables; a row-packed "
                         "container runs paired_stage")
    return _stage("fused_stage", WireSource(wire, scales, geom), tables,
                  coefs)


def paired_stage(wire, scales, geom, guest_geom, tables, coefs):
    """K3: one row-packed lane bucket from the shipped quantised wire.

    As :func:`fused_stage`, with ``guest_geom`` locating the guest stage
    in the same wire, and ``tables``/``coefs`` carrying the guest
    (``gm``, ``gbase``; ``ghcoef``, ``gbcoef``, ``gstdnoise``). Returns
    (D, B, RE, NW) float32 holding both trials: host rows from 0, guest
    rows from each trial's base. CUDA tensors launch the segment kernel
    (host and guest rows from their own stages' slices), each remaining
    level and the S/N kernel, counted as one K3 launch; CPU tensors run
    :func:`paired_stage_plain`."""
    if wire.device.type == "cpu":
        return paired_stage_plain(wire, scales, geom, guest_geom, tables,
                                  coefs)
    if tables.gbase is None or coefs.ghcoef is None:
        raise ValueError("paired_stage needs guest tables and coefficients")
    return _stage("paired_stage", WireSource(wire, scales, geom, guest_geom),
                  tables, coefs)
