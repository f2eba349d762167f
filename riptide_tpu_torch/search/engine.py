"""
Execution of a periodogram plan.

Host half (float64 accumulation): every cascade stage's downsampling of
the (D, N) batch, from one prefix sum per series (mirroring the
reference's double accumulator, riptide/cpp/downsample.hpp:44-82), then
the wire the device reads. The default wire is ``uint6``: each stage's
samples laid out as (r0, PW) view rows, quantised at one float32 scale
per row and packed four samples to three byte planes
(:func:`_view_layout`, :func:`_prepare_uint`). ``RIPTIDE_WIRE_DTYPE``
selects ``uint8``, ``uint12``, ``float16`` or ``float32`` instead. The
native threaded runtime (:mod:`riptide_tpu_torch.native`,
``RIPTIDE_PREP_THREADS`` threads) prepares the wire when it built; the
numpy path (:func:`_prepare_uint_numpy`) is the fallback, and each
prepared wire names its path in ``meta["prep"]``. Both give the same
bytes, and every byte of the wire, and every scale, is identical to the
JAX package's. A :class:`StagingPool` recycles the host buffers across
chunks (pinned for the card); :func:`ship_stage_data` copies them on a
copy stream of their own that the stage loop waits on.

Device half (torch): the wire ships as one tensor; the stages then queue
(:func:`_queue_stages`) the plan's launch layout (:func:`launch_layout`,
built once per plan and wire mode), which takes the JAX package's
layout decisions at its defaults:

* quantised wires, stages with at least three FFA levels -> one
  :func:`~riptide_tpu_torch.ops.ffa_kernel.fused_stage` (K1: decode +
  pack + FFA levels + boxcar S/N) per lane bucket
  (``CycleStage.lane_buckets``), each in its own container; a bucket
  that hosts a later stage's same-p bucket in its dead rows
  (:func:`_row_pack_map`) runs
  :func:`~riptide_tpu_torch.ops.ffa_kernel.paired_stage` (K3) instead,
  and the absorbed bucket launches nothing;
* other quantised stages -> one K1 over the whole stage;
* the float32 wire -> the plain :func:`_pack` on the device, then
  :func:`~riptide_tpu_torch.ops.ffa_kernel.cascade_stage` (K2).

On a CUDA device those wrappers launch the hand-written kernels; on the
CPU they run their plain PyTorch versions. Each launch yields a
(D, B, RE, NW) S/N container, and :func:`_assemble_device` gathers the
evaluated rows in the reference's (cycle, bins, shift) order, on the
device, from the positions the layout lists. The periodogram
entry points copy the cube to the host once; the survey batch
(:func:`run_search_batch`) runs peak detection on it on the device
(:mod:`.peaks_device`). Inside :func:`recording`, each search also keeps
the time of each of those parts and its operands, for checks and
measurements.

Analysis: :func:`walk_search` runs the same queue path on the ``meta``
device (shapes only, nothing launched, no card needed) and lists every
launch, the CUDA kernels under it and every device buffer the search
allocates and frees: the launch contract and the peak-memory model
(``riptide_tpu_torch/analysis/launch_contract.py``) are read from it.
:func:`wire_transfer_contract` gives the wire's transfer shape, and
:func:`device_peak_bytes` the card's measured high-water mark.

Replaces the reference's single-threaded C++ search loop
(riptide/cpp/periodogram.hpp:117-201).
"""
import contextlib
import threading
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..ops.ffa_kernel import (MAX_DYNAMIC_SMEM, SNR_WARPS, WIRE_MODES, Coefs,
                              StageGeom, Tables, cascade_stage, fused_stage,
                              paired_stage)
from ..obs.trace import span
from ..survey.liveness import is_timeout_error  # noqa: F401 (re-exported)
from ..survey.metrics import get_metrics
from ..utils import envflags
from ..utils.device import resolve_device
from ..utils.exec_cache import count_warmth

__all__ = ["run_periodogram", "run_periodogram_batch", "run_search_batch",
           "queue_search_batch", "collect_search_batch", "search_snr_dev",
           "prepare_stage_data", "ship_stage_data", "release_prepared",
           "StagingPool", "recording", "is_oom_error", "is_timeout_error",
           "device_fingerprint", "walk_search",
           "wire_transfer_contract", "device_peak_bytes",
           "drop_device_operands", "warm_stage_kernels", "launch_shape",
           "launch_shapes"]

def device_fingerprint(device=None):
    """Identity of the device a search runs on (``device``, the card
    when None), with the JAX package's keys: ``backend`` (the torch
    device type), ``device_kind`` (the card's name; ``"cpu"`` on the
    CPU), ``device_count`` (cards visible; 1 on the CPU) and
    ``process_count`` (the ``torch.distributed`` world size, else 1).
    Two perf points are comparable only under the same fingerprint."""
    import torch.distributed as dist

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    return {
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "process_count": (dist.get_world_size() if dist.is_available()
                          and dist.is_initialized() else 1),
    }


# Substrings that mark device memory exhaustion in an exception message
# (the JAX package's markers; the fault injector's simulated OOM carries
# the first).
_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory")


def is_oom_error(err):
    """True when an exception is device memory exhaustion: a
    ``torch.cuda.OutOfMemoryError``, or any error whose message carries
    an OOM marker. The batcher recovers from it by halving the DM
    batch; other errors propagate."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err).lower()
    return any(marker in msg for marker in _OOM_MARKERS)


# Tail slack of the wire layout, as in the JAX package's byte-plane view
# (its fused TPU kernel streamed planes in DMA_CHUNK-row chunks and could
# over-read that far). The port's kernels read only a stage's own rows,
# but the layout keeps the slack so that wire bytes stay identical.
DMA_CHUNK = 32


def _prcap(rows, group):
    """Per-plane row capacity of a ``rows``-row container's stage slice,
    rounded up to whole DMA_CHUNKs (the scale slack of the layout)."""
    need = -(-(rows + 1) // group) + 1
    return -(-need // DMA_CHUNK) * DMA_CHUNK


# Quantisation parameters per wire mode: (qmax, bias). One float32
# scale per PW-sample view row, scale = rowmax / qmax, stored value
# q = rint(v / scale) + bias.
_WIRE_Q = {"uint6": (31.0, 32), "uint8": (127.0, 128),
           "uint12": (2047.0, 2048)}


# Float wires: samples that the device widens to float32 (float16) and
# packs itself.
_WIRE_FLOAT = ("float32", "float16")

# Every wire transport: the quantised byte-plane views and the float
# wires.
WIRES = (*_WIRE_Q, *_WIRE_FLOAT)


def _wire_mode():
    """The wire transport: ``RIPTIDE_WIRE_DTYPE`` (one of :data:`WIRES`),
    default ``uint6``. Read at each search, so a changed environment
    takes effect at once."""
    return envflags.get("RIPTIDE_WIRE_DTYPE") or "uint6"


# ---------------------------------------------------------------------------
# Host half: downsampling and the wire
# ---------------------------------------------------------------------------

def _stage_downsample(st, d64, c32, anchors):
    """One cascade stage's downsampling for a (..., N) float64 batch
    with its anchored prefix sums (:func:`_prefix_anchored`). Returns
    (..., nout) float32. Mirrors the reference's
    always-from-the-original-series semantics and double accumulator
    (riptide/cpp/downsample.hpp:44-82, periodogram.hpp:162-168), with the
    JAX package's reconstruction ``anchors[g(j)] + c32[j]`` and operation
    order."""
    imin, imax, wmin, wmax, wint = st.ds_plan
    ga = imin >> ANCHOR_LOG                    # g(imin + 1)
    gb = np.maximum(imax - 1, 0) >> ANCHOR_LOG  # g(imax)
    csa = np.take(anchors, ga, axis=-1) + np.take(c32, imin + 1, axis=-1)
    csb = np.take(anchors, gb, axis=-1) + np.take(c32, imax, axis=-1)
    acc = wmin * d64[..., imin]
    acc += wint * (csb - csa)
    acc += wmax * d64[..., imax]
    return acc.astype(np.float32)


def _prefix64(data):
    """Float64 prefix sums in a 4-lane vector-scan order: per group of
    4, lane sums l = [x0, x1+x0, (x2+x1)+x0, (x3+x2)+(x1+x0)], then
    cs[4v+1..4v+4] = carry_v + l with carry_{v+1} = carry_v + l[3], and a
    serial tail — the association the JAX package's native and numpy
    paths both use, so the wire bytes agree bit for bit."""
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[-1]
    lead = data.shape[:-1]
    cs = np.zeros(lead + (n + 1,), np.float64)
    nv = n // 4
    if nv:
        xv = data[..., : 4 * nv].reshape(lead + (nv, 4))
        s1 = xv.copy()
        s1[..., 1:] += xv[..., :-1]
        # In-place: reads lanes 0-1, writes lanes 2-3 (disjoint).
        s2 = s1
        s2[..., 2:] += s1[..., :-2]
        carry = np.zeros(lead + (nv,), np.float64)
        np.cumsum(s2[..., :-1, 3], axis=-1, out=carry[..., 1:])
        cs[..., 1 : 4 * nv + 1] = (s2 + carry[..., None]).reshape(
            lead + (4 * nv,)
        )
    if n > 4 * nv:
        tail = np.concatenate(
            [cs[..., 4 * nv : 4 * nv + 1], data[..., 4 * nv :]], axis=-1
        )
        cs[..., 4 * nv :] = np.cumsum(tail, axis=-1, dtype=np.float64)
    return data, cs


# Anchored-float32 prefix storage: prefix values are stored as float32
# residuals against one exact float64 anchor per ANCHOR_BLK samples.
ANCHOR_LOG = 12
ANCHOR_BLK = 1 << ANCHOR_LOG


def _prefix_anchored(data):
    """Anchored form of :func:`_prefix64`: returns ``(d64, c32,
    anchors)`` where ``cs64(j) == anchors[..., max(j - 1, 0) >>
    ANCHOR_LOG] + c32[..., j]`` up to float32 residual rounding."""
    d64, cs = _prefix64(data)
    n = data.shape[-1]
    G = -(-n // ANCHOR_BLK)
    anchors = np.ascontiguousarray(cs[..., : G * ANCHOR_BLK : ANCHOR_BLK])
    gidx = np.maximum(np.arange(n + 1) - 1, 0) >> ANCHOR_LOG
    c32 = (cs - np.take(anchors, gidx, axis=-1)).astype(np.float32)
    return d64, c32, anchors


def _ds_pack(plan):
    """Stacked (S, nout) downsample-plan arrays, cached on the plan."""
    pk = getattr(plan, "_ds_pack", None)
    if pk is None:
        cols = list(zip(*(st.ds_plan for st in plan.stages)))
        pk = plan._ds_pack = tuple(np.stack(c) for c in cols)
    return pk


def _prep_nthreads():
    """Worker threads of the native wire prep: ``RIPTIDE_PREP_THREADS``
    when positive, else None (the native default, every core up to 32).
    The (stage, trial) jobs write disjoint output regions, so the bytes
    are the same at any count."""
    n = int(envflags.get("RIPTIDE_PREP_THREADS"))
    return n if n > 0 else None


def _native():
    """The native runtime when it built and loaded, else None."""
    from .. import native

    return native if native.available() else None


def _host_downsample_all(plan, batch, dtype):
    """Every cascade stage's downsampling of a (D, N) batch as one (S, D,
    nout) array of ``dtype`` (float32 or float16): the native threaded
    runtime when available, else numpy."""
    nat = _native()
    if nat is not None:
        imin, imax, wmin, wmax, wint = _ds_pack(plan)
        return nat.downsample_stages(batch, imin, imax, wmin, wmax, wint,
                                     dtype=dtype, nthreads=_prep_nthreads())
    d64, c32, anchors = _prefix_anchored(batch)
    return np.stack([_stage_downsample(st, d64, c32, anchors).astype(dtype)
                     for st in plan.stages])


def _view_width(plan):
    """Plan-wide wire view width PW: bins_max rounded up to 128 lanes.
    One width for every stage, so a single (D, WROWS, PW) byte tensor
    carries the whole cascade."""
    return -(-int(plan.P) // 128) * 128


def _view_layout(plan, mode):
    """Row bookkeeping of a quantised wire view, cached on the plan.

    Stage s ships as ``planes`` byte planes of ``prs[s]`` rows x PW
    bytes (``group`` consecutive view rows per plane row, see
    ops.ffa_kernel.WIRE_MODES) at wire row offset ``roffs[s]``, plus
    ``r0s[s]`` per-row float32 scales at scale row ``soffs[s]``.
    ``tot_rows``/``stot`` include the layout's tail slack."""
    cache = getattr(plan, "_view_layouts", None)
    if cache is None:
        cache = plan._view_layouts = {}
    vl = cache.get(mode)
    if vl is not None:
        return vl
    group, planes = WIRE_MODES[mode]
    PW = _view_width(plan)
    r0s = [-(-st.n // PW) for st in plan.stages]
    prs = [-(-r0 // group) for r0 in r0s]
    wrows = [planes * pr for pr in prs]
    roffs = np.concatenate([[0], np.cumsum(wrows,
                                           dtype=np.int64)]).astype(np.int64)
    soffs = np.concatenate([[0], np.cumsum(r0s,
                                           dtype=np.int64)]).astype(np.int64)
    sslack = DMA_CHUNK * group
    for st in plan.stages:
        sslack = max(sslack, group * _prcap(1 << st.kernel_depth, group))
    vl = cache[mode] = {
        "PW": PW, "group": group, "planes": planes,
        "r0s": r0s, "prs": prs, "wrows": wrows,
        "roffs": roffs[:-1], "tot_rows": int(roffs[-1]) + DMA_CHUNK,
        "soffs": soffs[:-1], "stot": int(soffs[-1]) + int(sslack),
    }
    return vl


def _wire_layout(plan, mode):
    """Per-stage (offsets, lengths, total) of the wire buffer: ELEMENTS
    of the flat (D, total) sample buffer for float modes, WIRE ROWS of
    the (D, total, PW) byte-plane view for quantised modes."""
    if mode in _WIRE_Q:
        vl = _view_layout(plan, mode)
        return vl["roffs"], vl["wrows"], vl["tot_rows"]
    lens = [st.n for st in plan.stages]
    offs = np.concatenate([[0], np.cumsum(lens,
                                          dtype=np.int64)]).astype(np.int64)
    return offs[:-1], lens, int(offs[-1])


def _prepare_uint(plan, batch, mode, out=None, scales=None):
    """Quantised wire preparation in the byte-plane view
    (:func:`_view_layout`): the native single pass when available, else
    :func:`_prepare_uint_numpy`, the same bytes and scales.
    ``out``/``scales`` (native only) are recycled staging buffers, reset
    before they are written. Returns (wire (D, tot_rows, PW) uint8,
    scales (D, stot) f32)."""
    nat = _native()
    if nat is None:
        return _prepare_uint_numpy(plan, batch, mode)
    vl = _view_layout(plan, mode)
    imin, imax, wmin, wmax, wint = _ds_pack(plan)
    nouts = np.asarray([st.n for st in plan.stages], np.int32)
    return nat.prepare_wire_view(
        batch, imin, imax, wmin, wmax, wint, nouts, mode, vl["PW"],
        vl["roffs"], vl["tot_rows"], vl["soffs"], vl["stot"],
        nthreads=_prep_nthreads(), out=out, scales=scales)


def _prepare_uint_numpy(plan, batch, mode):
    """The numpy form of :func:`_prepare_uint`: float64 downsampling,
    float32 reciprocal, round-half-even, one stage at a time."""
    vl = _view_layout(plan, mode)
    qmax, bias = _WIRE_Q[mode]
    group, PW = vl["group"], vl["PW"]
    D = batch.shape[0]
    d64, c32, anchors = _prefix_anchored(batch)
    out = np.zeros((D, vl["tot_rows"], PW), np.uint8)
    # Slack scale rows stay 1.0 (finite).
    scales = np.ones((D, vl["stot"]), np.float32)
    for i, st in enumerate(plan.stages):
        xd = _stage_downsample(st, d64, c32, anchors)[..., : st.n]
        r0, pr, roff, soff = (vl["r0s"][i], vl["prs"][i],
                              int(vl["roffs"][i]), int(vl["soffs"][i]))
        buf = np.zeros((D, group * pr * PW), np.float32)
        buf[:, : st.n] = xd
        view = buf.reshape(D, group * pr, PW)
        rmax = np.abs(view[:, :r0]).max(axis=2)
        s = np.where(rmax > 0, rmax / np.float32(qmax),
                     np.float32(1.0)).astype(np.float32)
        scales[:, soff : soff + r0] = s
        inv = (np.float32(1.0) / s).astype(np.float32)
        q = np.full((D, group * pr, PW), bias, np.int32)
        q[:, :r0] = (np.rint(view[:, :r0] * inv[:, :, None]).astype(np.int32)
                     + bias) & (2 * bias - 1)
        if mode == "uint8":
            out[:, roff : roff + pr] = (q & 255).astype(np.uint8)
            continue
        qg = q.reshape(D, pr, group, PW)
        if mode == "uint6":
            word = (qg[:, :, 0] | (qg[:, :, 1] << 6) | (qg[:, :, 2] << 12)
                    | (qg[:, :, 3] << 18))
        else:  # uint12
            word = qg[:, :, 0] | (qg[:, :, 1] << 12)
        out[:, roff : roff + pr] = (word & 255).astype(np.uint8)
        out[:, roff + pr : roff + 2 * pr] = ((word >> 8) & 255).astype(np.uint8)
        out[:, roff + 2 * pr : roff + 3 * pr] = (
            (word >> 16) & 255).astype(np.uint8)
    return out, scales


class StagingPool:
    """Recyclable host staging buffers for the wire prep (the JAX
    package's ``_StagingPool``): after the first chunk, the prep writes
    into buffers an earlier chunk gave back instead of allocating (and,
    for the card, pinning) new ones. Buffers are torch tensors, pinned
    when ``device`` is a CUDA device (the card when None), so that
    :func:`ship_stage_data` copies them asynchronously; the native
    runtime writes them through their ``.numpy()`` views. Keyed by
    (shape, dtype), at most ``max_per_key`` free buffers each.

    A buffer is out of the pool from :meth:`acquire` until
    :meth:`release`; a released buffer whose copy to the card (its
    ``event``) has not completed is not handed out. Thread-safe: the
    next chunk may be prepared on a worker thread while the card runs
    the current one."""

    def __init__(self, device=None, max_per_key=4):
        self.pin = resolve_device(device).type == "cuda"
        self._lock = threading.Lock()
        self._free = {}
        self._max = int(max_per_key)

    @staticmethod
    def _key(shape, dtype):
        return tuple(int(x) for x in shape), dtype

    def acquire(self, shape, dtype):
        """A free buffer of exactly (shape, torch ``dtype``) whose last
        copy has completed, else a new one."""
        key = self._key(shape, dtype)
        with self._lock:
            stack = self._free.get(key, [])
            for j in range(len(stack) - 1, -1, -1):
                buf, event = stack[j]
                if event is None or event.query():
                    del stack[j]
                    return buf
        return torch.empty(key[0], dtype=dtype, pin_memory=self.pin)

    def release(self, buf, event=None):
        """Give ``buf`` back once the chunk that used it is collected;
        ``event`` marks the end of its last copy to the card. Buffers
        beyond ``max_per_key`` are dropped."""
        key = self._key(buf.shape, buf.dtype)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) < self._max:
                stack.append((buf, event))


def release_prepared(pool, prepared):
    """Give a :func:`prepare_stage_data` result's staging buffers back to
    ``pool``, once the chunk's results are collected, with the event of
    its last copy to the card. No-op when either is None."""
    if pool is None or prepared is None:
        return
    meta = prepared[1]
    for buf in meta.get("staging", ()):
        pool.release(buf, meta.get("copy_event"))


def _staged(pool, shape, np_dtype):
    """A staging buffer from ``pool`` as (tensor, numpy view), or (None,
    None) without a pool."""
    if pool is None:
        return None, None
    buf = pool.acquire(shape, torch.from_numpy(np.empty(0, np_dtype)).dtype)
    return buf, buf.numpy()


def prepare_stage_data(plan, batch, mode=None, pool=None):
    """
    HOST half of a search: every cascade stage's downsampling of the
    (D, N) batch, laid out as ONE wire buffer in the transport ``mode``
    (default :func:`_wire_mode`). Runs in the native threaded runtime
    when it is available (``RIPTIDE_PREP_THREADS`` threads; ctypes
    releases the GIL, so a worker thread can prepare the next chunk
    while the card runs this one), else in numpy. ``pool`` (a
    :class:`StagingPool`) supplies the output buffers; hand them back
    with :func:`release_prepared` once the chunk is collected.

    Returns ``(flat, meta)``: the byte-plane view (D, tot_rows, PW)
    uint8 with meta ``scales`` (D, stot) float32 for the quantised
    modes, else the flat (D, total) float32 or float16 buffer with
    per-stage element offsets ``offs``. ``meta["prep"]`` is ``"native"``
    or ``"numpy"``, and ``meta["staging"]`` the pool's tensors.
    """
    t0 = time.perf_counter()
    with span("prep", mode=mode or _wire_mode()):
        out = _prepare_stage_data(plan, batch, mode, pool)
    get_metrics().observe("prep_s", time.perf_counter() - t0)
    return out


def _prepare_stage_data(plan, batch, mode, pool):
    batch = np.asarray(batch, dtype=np.float32)
    if batch.ndim != 2 or batch.shape[1] != plan.size:
        raise ValueError("batch must be (D, N) with N matching the plan")
    mode = mode or _wire_mode()
    if mode not in WIRES:
        raise ValueError(f"wire mode {mode!r}: expected one of {WIRES}")
    D = batch.shape[0]
    prep = "native" if _native() is not None else "numpy"
    offs, lens, tot = _wire_layout(plan, mode)
    if mode in _WIRE_Q:
        vl = _view_layout(plan, mode)
        staging = ()
        sout = sscales = None
        if prep == "native" and pool is not None:
            t_out, sout = _staged(pool, (D, vl["tot_rows"], vl["PW"]),
                                  np.uint8)
            t_sc, sscales = _staged(pool, (D, vl["stot"]), np.float32)
            staging = (t_out, t_sc)
        flat, scales = _prepare_uint(plan, batch, mode, out=sout,
                                     scales=sscales)
        return flat, {"mode": mode, "offs": offs, "scales": scales,
                      "view": vl, "prep": prep, "staging": staging}
    dtype = np.dtype(mode)
    xds = _host_downsample_all(plan, batch, dtype)
    t_flat, flat = _staged(pool, (D, tot), dtype)
    if flat is None:
        flat = np.empty((D, tot), dtype)
    for i, st in enumerate(plan.stages):
        flat[:, offs[i] : offs[i] + st.n] = xds[i][..., : st.n]
    return flat, {"mode": mode, "offs": offs, "scales": None, "prep": prep,
                  "staging": () if t_flat is None else (t_flat,)}


# One copy stream per CUDA device, made at its first copy (once, under
# concurrent job threads too).
_COPY_STREAMS = {}
_COPY_STREAMS_LOCK = threading.Lock()


def _copy_stream(dev):
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    with _COPY_STREAMS_LOCK:
        st = _COPY_STREAMS.get(key)
        if st is None:
            st = _COPY_STREAMS[key] = torch.cuda.Stream(device=key)
    return st


def ship_stage_data(prepared, device):
    """Copy a prepared wire buffer (and its scales) to ``device`` as one
    tensor each. Returns ``(wire, meta)`` with meta ``scales_dev``.

    On a CUDA device the copies run ``non_blocking`` on the device's copy
    stream (asynchronous from a pool's pinned buffers), after the work
    already queued on the current stream; the current stream then waits
    on their event before the first stage. The event is also kept as
    ``prepared[1]["copy_event"]`` for :func:`release_prepared`."""
    flat, meta = prepared
    t0 = time.perf_counter()
    with span("wire", bytes=int(flat.nbytes)):
        out = _ship(flat, meta, torch.device(device))
    elapsed = time.perf_counter() - t0
    reg = get_metrics()
    reg.observe("wire_s", elapsed)
    reg.add("wire_bytes", int(flat.nbytes))
    if elapsed > 0:
        reg.observe_hist("wire_MBps", flat.nbytes / 1e6 / elapsed)
    return out


def _ship(flat, meta, dev):
    host = [torch.from_numpy(flat)]
    if meta["scales"] is not None:
        host.append(torch.from_numpy(meta["scales"]))
    if dev.type != "cuda":
        outs = [h.to(dev) for h in host]
    else:
        cur = torch.cuda.current_stream(dev)
        cs = _copy_stream(dev)
        # Allocated on the current stream, written on the copy stream
        # once the current stream's earlier work (which may have used
        # this memory) is done.
        outs = [torch.empty(h.shape, dtype=h.dtype, device=dev) for h in host]
        cs.wait_stream(cur)
        with torch.cuda.stream(cs):
            for o, h in zip(outs, host):
                o.copy_(h, non_blocking=True)
            event = torch.cuda.Event()
            event.record(cs)
        cur.wait_event(event)
        meta["copy_event"] = event
    meta = dict(meta)
    meta["scales_dev"] = outs[1] if len(outs) > 1 else None
    return outs[0], meta


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

def _udecode_view(mode, seg, scales):
    """Decode one stage's byte planes: ``seg`` (..., planes * pr, PW)
    uint8 + ``scales`` (..., r0, 1) float32 -> (..., r0, PW) float32
    sample view. Integer bit ops, cast, subtract, multiply: the operation
    sequence of the JAX package's ``_udecode_view`` and of the CUDA
    decode, so all three give bit-identical samples."""
    lead = tuple(seg.shape[:-2])
    PW = seg.shape[-1]
    r0 = scales.shape[-2]
    if mode == "uint8":
        xq = seg.to(torch.float32) - 128.0
    else:
        pr = seg.shape[-2] // 3
        pl3 = seg.reshape(lead + (3, pr, PW))
        b0 = pl3[..., 0, :, :].to(torch.int32)
        b1 = pl3[..., 1, :, :].to(torch.int32)
        b2 = pl3[..., 2, :, :].to(torch.int32)
        if mode == "uint6":
            word = b0 | (b1 << 8) | (b2 << 16)
            qs = [((word >> (6 * j)) & 63).to(torch.float32) - 32.0
                  for j in range(4)]
        else:  # uint12
            qs = [(b0 | ((b1 & 15) << 8)).to(torch.float32) - 2048.0,
                  ((b1 >> 4) | (b2 << 4)).to(torch.float32) - 2048.0]
        xq = torch.stack(qs, dim=-2).reshape(lead + (len(qs) * pr, PW))
    return xq[..., :r0, :] * scales


def _decode_stage_rows(mode, wire, scales, roff, nrows, soff, r0, n):
    """Slice + decode ONE stage's samples out of the (..., WROWS, PW)
    wire view and (..., STOT) scales. Returns (..., n) float32."""
    seg = wire[..., roff : roff + nrows, :]
    sc = scales[..., soff : soff + r0, None]
    xv = _udecode_view(mode, seg, sc)
    return xv.reshape(xv.shape[:-2] + (r0 * xv.shape[-1],))[..., :n]


def _pack(xd, p, m, R, P, row0=None):
    """
    Pack downsampled series (..., n) into the (..., B, R, P) FFA container:
    container[..., b, i, j] = xd[..., (i - row0[b]) * p[b] + j] for
    row0[b] <= i < row0[b] + m[b], j < p[b], else 0 (``row0`` (B,)
    defaults to 0).
    """
    dev = xd.device
    rows = torch.arange(R, dtype=torch.int64, device=dev)[None, :, None]
    if row0 is not None:
        rows = rows - row0.to(torch.int64)[:, None, None]
    cols = torch.arange(P, dtype=torch.int64, device=dev)[None, None, :]
    pb = p.to(torch.int64)[:, None, None]
    mb = m.to(torch.int64)[:, None, None]
    idx = rows * pb + cols
    valid = (rows >= 0) & (rows < mb) & (cols < pb)
    n = xd.shape[-1]
    flat = xd[..., idx.clamp(0, n - 1)]
    return torch.where(valid, flat, torch.zeros((), dtype=flat.dtype,
                                                device=dev))




def _dev_tensor(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _operands(b, widths, hcoef, bcoef, stdnoise, rows, device, guest=None):
    """(Tables, Coefs) on ``device`` of one container: the
    :class:`~riptide_tpu_torch.ops.plan.FFABatchPlan` ``b``, the S/N
    inputs of its trials and, for a row-packed container, ``guest`` =
    (hcoef, bcoef, stdnoise) of the guest trials. On a CUDA device the
    tables carry the segment kernel's plan (``b.segments``); the plain
    CPU path runs every level over the container and takes none."""
    def dev(a, dtype):
        return _dev_tensor(a, dtype, device)

    tables = Tables(
        h=dev(b.h, np.int32), t=dev(b.t, np.int32),
        shift=dev(b.shift, np.int32), p=dev(b.p, np.int32),
        m=dev(b.m, np.int32), P=int(b.P),
        span=int(max(int(m) * int(p) for m, p in zip(b.m, b.p))),
    )
    if device.type != "cpu":
        # The card's tables, and the meta device's (walk_search).
        seg = b.segments
        tables = tables._replace(tiles=dev(seg.tiles, np.int32),
                                 local=seg.levels, smem=seg.smem)
    coefs = Coefs(
        widths=dev(widths, np.int32), hcoef=dev(hcoef, np.float32),
        bcoef=dev(bcoef, np.float32), stdnoise=dev(stdnoise, np.float32),
        rows=max(int(rows), 1),
    )
    if guest is not None:
        ghcoef, gbcoef, gstd = guest
        tables = tables._replace(
            gm=dev(b.gm, np.int32), gbase=dev(b.gbase, np.int32),
            gspan=int(max(int(m) * int(p) for m, p, g in
                          zip(b.gm, b.p, b.gbase) if g >= 0)))
        coefs = coefs._replace(ghcoef=dev(ghcoef, np.float32),
                               gbcoef=dev(gbcoef, np.float32),
                               gstdnoise=dev(gstd, np.float32))
    return tables, coefs


def _cached(st, key, build):
    cache = getattr(st, "_device_operands", None)
    if cache is None:
        cache = st._device_operands = {}
    ops = cache.get(key)
    if ops is None:
        ops = cache[key] = build()
    return ops


def _stage_operands(st, plan, device):
    """(Tables, Coefs) of a whole stage in one container (the gather
    plan ``st.batch``), cached on the stage per device so repeated
    searches with a cached plan ship only the data."""
    return _cached(st, (str(device), "stage"), lambda: _operands(
        st.batch, plan.widths, st.hcoef, st.bcoef, st.stdnoise,
        st.rows_eval_max, device))


def _bucket_rows_eval(st, idx):
    nre = len(st.rows_eval)
    return max([st.rows_eval[g] for g in idx if g < nre] or [0])


def _bucket_operands(st, plan, k, device):
    """(Tables, Coefs) of lane bucket ``k`` in its own container
    (:meth:`~riptide_tpu_torch.search.plan.CycleStage.bucket_batch`):
    RE = the bucket's largest evaluated row count."""
    def build():
        ix = list(st.lane_buckets[k])
        return _operands(st.bucket_batch(k), plan.widths, st.hcoef[ix],
                         st.bcoef[ix], st.stdnoise[ix],
                         _bucket_rows_eval(st, ix), device)

    return _cached(st, (str(device), "bucket", k), build)


def _paired_operands(st, plan, k, st2, bases, device):
    """(Tables, Coefs) of lane bucket ``k`` hosting ``st2``'s
    same-position trials at ``bases``
    (:meth:`~riptide_tpu_torch.search.plan.CycleStage.paired_batch`): RE
    also covers every guest's evaluated rows above its base. A bucket
    hosts one guest in the plan's layout, so ``k`` keys the cache."""
    def build():
        ix = list(st.lane_buckets[k])
        n2 = len(st2.rows_eval)
        remax = max([_bucket_rows_eval(st, ix)] + [
            bb + st2.rows_eval[g] for bb, g in zip(bases, ix)
            if bb is not None and g < n2])
        return _operands(st.paired_batch(k, st2, bases), plan.widths,
                         st.hcoef[ix], st.bcoef[ix], st.stdnoise[ix], remax,
                         device, guest=(st2.hcoef[ix], st2.bcoef[ix],
                                        st2.stdnoise[ix]))

    return _cached(st, (str(device), "paired", k), build)


def stage_geom(meta, i, n):
    """Where stage ``i`` (``n`` samples) sits in a shipped quantised
    wire: the :class:`StageGeom` that :func:`fused_stage` takes."""
    vl = meta["view"]
    return StageGeom(meta["mode"], int(vl["roffs"][i]), int(vl["prs"][i]),
                     int(vl["soffs"][i]), int(vl["r0s"][i]), int(n))


# ---------------------------------------------------------------------------
# Lane buckets and row packing: the JAX package's layout decisions
# ---------------------------------------------------------------------------

def _bucket_shape(st, idx):
    """(L, rows, P) of one lane bucket in the TPU layout: L from its
    largest m, rows = ``bucket_rows``, P = its largest p rounded up to
    128 lanes. The pairing map and ``plan_occupancy`` reason in this
    layout, as the JAX package's do; the port's own container is
    ``rows + 1`` by the bucket's largest p (``CycleStage.bucket_batch``)."""
    from ..ops.ffa_kernel import bucket_rows
    from ..ops.plan import num_levels

    ms = [st.ms_padded[i] for i in idx]
    ps = [st.ps_padded[i] for i in idx]
    L = max(num_levels(m) for m in ms)
    return L, bucket_rows(ms, L), -(-max(ps) // 128) * 128


def _smem_fits(P):
    """Whether the S/N kernel keeps its full SNR_WARPS rows of P floats
    in a block's shared memory (P <= 14,528)."""
    return SNR_WARPS * P * 4 <= MAX_DYNAMIC_SMEM


def _kernel_eligible(st, plan):
    """Whether the stage takes the lane-bucketed kernel layout: at least
    three FFA levels (the JAX package's ``kernel_depth >= 3``; smaller
    stages keep one container) and every trial's width inside the S/N
    kernel's full shared-memory shape (:func:`_smem_fits`). Hopper's
    limits replace the TPU's VMEM budget and packed-word fields. A wider
    stage runs whole, as the JAX package runs its wide stages on the
    gather path; the kernels take its width in their wide forms (no
    tile-local level, column-split levels, one S/N block or cluster a
    row)."""
    return st.kernel_depth >= 3 and _smem_fits(max(st.ps_padded))


def _fused_eligible(st, plan, mode):
    """Whether the stage runs one K1 (or K3) launch per lane bucket:
    a quantised wire and :func:`_kernel_eligible`. Other stages run
    whole, as one K1 (quantised wire) or K2 (float32) launch."""
    return mode in WIRE_MODES and _kernel_eligible(st, plan)


def _row_pack_map(plan, mode):
    """Which later stage's lane buckets ride which earlier stage's dead
    container rows: the JAX package's greedy pairing
    (``engine._row_pack_map``) over (stage, lane bucket) pairs at the
    same bucket position and p list, earliest guest first. A bucket is
    absorbed when every trial it needs read back has a guest base
    (``ops.plan.pair_bucket_bases``). The TPU's VMEM gate has no
    counterpart: a base lies between the host's rows and the TPU height,
    below the port's zero row (``FFABatchPlan`` checks it), and the one
    Hopper limit, the S/N kernel's shared memory, is the host bucket's
    own (:func:`_kernel_eligible`). Returns {} when the wire is not
    quantised, else {(stage, bucket): ("host", guest_stage, bases) |
    ("guest", host_stage)}, cached on the plan per wire mode."""
    from ..ops.plan import pair_bucket_bases

    if mode not in WIRE_MODES:
        return {}
    cache = plan.__dict__.setdefault("_row_pack_maps", {})
    rpm = cache.get(mode)
    if rpm is not None:
        return rpm
    stages = plan.stages
    elig = [_fused_eligible(st, plan, mode) for st in stages]
    entries = {}
    for s, st in enumerate(stages):
        if not elig[s]:
            continue
        for k, idx in enumerate(st.lane_buckets):
            if (s, k) in entries:
                continue
            L, rows, _ = _bucket_shape(st, idx)
            ms = [st.ms_padded[i] for i in idx]
            ps = [st.ps_padded[i] for i in idx]
            for s2 in range(s + 1, len(stages)):
                st2 = stages[s2]
                if ((s2, k) in entries or not elig[s2]
                        or st2.lane_buckets != st.lane_buckets
                        or [st2.ps_padded[i] for i in idx] != ps):
                    continue
                nb2 = len(st2.bins)
                skip = tuple(j for j, g in enumerate(idx)
                             if g >= nb2 or st2.rows_eval[g] == 0)
                bases = pair_bucket_bases(
                    ms, [st2.ms_padded[i] for i in idx], L, rows, skip)
                if bases is None:
                    continue
                entries[(s, k)] = ("host", s2, bases)
                entries[(s2, k)] = ("guest", s)
                break
    cache[mode] = entries
    return entries


class Launch(NamedTuple):
    """One stage launch of a plan's layout: its wrapper (``kind``:
    ``fused_stage``, ``paired_stage`` or ``cascade_stage``), its stage,
    its lane bucket (None: the whole stage in one container) and, for
    K3, the guest stage and the guest trials' base rows (None: no guest
    on that trial)."""
    kind: str
    stage: int
    bucket: object = None
    guest: object = None
    bases: tuple = None


class Layout(NamedTuple):
    """A plan's launch layout on one wire mode (:func:`launch_layout`).

    ``stages[s]``: stage s's launches in queue order (none when every
    lane bucket of the stage is absorbed). ``launches``: all of them in
    that order; the stage loop's outputs come in this order.
    ``absorbed``: (stage, bucket, host stage) of each lane bucket that
    rides its host's dead rows and launches nothing. ``pieces``: per
    evaluated trial in plan order (cycle, bins, shift), (launch, row,
    base, rows): the trial's S/N are rows [base, base + rows) of row
    ``row`` of that launch's container, read by
    :func:`_assemble_device`."""
    stages: tuple
    launches: tuple
    absorbed: tuple
    pieces: tuple


def _build_layout(plan, mode):
    rpm = _row_pack_map(plan, mode)
    whole = "fused_stage" if mode in WIRE_MODES else "cascade_stage"
    stages, absorbed = [], []
    for s, st in enumerate(plan.stages):
        if not _fused_eligible(st, plan, mode):
            stages.append((Launch(whole, s),))
            continue
        lns = []
        for k in range(len(st.lane_buckets)):
            e = rpm.get((s, k))
            if e is None:
                lns.append(Launch("fused_stage", s, k))
            elif e[0] == "host":
                lns.append(Launch("paired_stage", s, k, e[1], tuple(e[2])))
            else:
                absorbed.append((s, k, e[1]))
        stages.append(tuple(lns))
    launches = tuple(ln for lns in stages for ln in lns)
    where = {}  # (stage, trial) -> (launch, row, base)
    for j, ln in enumerate(launches):
        st = plan.stages[ln.stage]
        idx = (range(len(st.ms_padded)) if ln.bucket is None
               else st.lane_buckets[ln.bucket])
        for r, g in enumerate(idx):
            where[(ln.stage, g)] = (j, r, 0)
        if ln.guest is not None:
            for r, (g, base) in enumerate(zip(idx, ln.bases)):
                if base is not None:
                    where[(ln.guest, g)] = (j, r, base)
    pieces = tuple((*where[(s, g)], re) for s, st in enumerate(plan.stages)
                   for g, re in enumerate(st.rows_eval) if re)
    return Layout(tuple(stages), launches, tuple(absorbed), pieces)


_LAYOUTS_LOCK = threading.Lock()


def launch_layout(plan, mode):
    """The plan's :class:`Layout` on ``mode``'s wire: which stage runs
    whole and which by lane bucket, which bucket runs K1, which hosts a
    guest (K3) and which is absorbed, and where each trial's rows sit in
    the assembled cube. Built once per plan and wire mode (under
    concurrent job threads too) and cached on the plan: every later call
    returns the same object. The stage loop, the assembly,
    :func:`queued_launches`, ``plan_occupancy`` and the launch contract
    read it."""
    lay = getattr(plan, "_layouts", {}).get(mode)
    if lay is None:
        with _LAYOUTS_LOCK:
            cache = plan.__dict__.setdefault("_layouts", {})
            lay = cache.get(mode)
            if lay is None:
                lay = cache[mode] = _build_layout(plan, mode)
    return lay


def queued_launches(plan, mode=None):
    """The kernel launches one search of ``plan`` queues on ``mode``'s
    wire (default :func:`_wire_mode`): {"fused_stage": K1,
    "cascade_stage": K2, "paired_stage": K3}. A quantised wire runs K1
    and K3 only, the float32 wire K2 only."""
    counts = dict.fromkeys(("fused_stage", "cascade_stage", "paired_stage"),
                           0)
    for ln in launch_layout(plan, mode or _wire_mode()).launches:
        counts[ln.kind] += 1
    return counts


# ---------------------------------------------------------------------------
# Device half: the stage loop
# ---------------------------------------------------------------------------

# The dict that searches fill while a :func:`recording` block is open.
# Only recording() writes it; a walk (walk_search) hides it from its own
# thread alone, through _recorder().
_RECORD = None


def _recorder():
    """The open recording's dict, or None: outside :func:`recording`,
    and on a thread that runs :func:`walk_search` (its searches are the
    walk's, not the recording's; other threads keep recording)."""
    if getattr(_WALK, "tally", None) is not None:
        return None
    return _RECORD


def launch_shape(kind, args):
    """The shape of one stage launch, from its wrapper's ``kind`` and
    ``args``: (kind, D, B, R, P, L, RE, NW), the batch, the container
    (B, R, P) and its FFA levels L, and the S/N rows RE and widths NW
    the launch writes. It sets what the launch allocates on the device
    and the grids of its kernels."""
    tables, coefs = args[-2], args[-1]
    return (kind, int(args[0].shape[0]), int(tables.p.shape[0]),
            int(tables.h.shape[2]), int(tables.P), int(tables.h.shape[0]),
            int(coefs.rows), int(coefs.widths.shape[0]))


def _launch(kind, fn, args, **where):
    """Call one stage wrapper on ``args``; inside :func:`recording`, keep
    its kind, operands, output and ``where`` (stage, lane bucket, guest
    stage). A float32 container is kept as a copy made before the call,
    since the kernel uses it as scratch. Inside :func:`walk_search`, the
    walk's tally takes the call instead; inside
    :func:`warm_stage_kernels`, a launch whose :func:`launch_shape` was
    queued before is skipped (returns None)."""
    tally = getattr(_WALK, "tally", None)
    if tally is not None:
        return tally.launch(kind, fn, args, where)
    warmed = getattr(_WALK, "warmed", None)
    if warmed is not None:
        shape = launch_shape(kind, args)
        if shape in warmed:
            return None
        warmed.add(shape)
    rec = _recorder()
    kept = args
    if rec is not None and kind == "cascade_stage":
        kept = (args[0].clone(),) + args[1:]
    out = fn(*args)
    if rec is not None:
        rec.setdefault("launches", []).append(
            dict(where, kind=kind, args=kept, out=out))
    return out


def _run_stage(st, plan, i, wire, meta):
    """Queue one whole cascade stage in one container; returns its
    (D, B, RE, NW) S/N (unsynced on a CUDA device). Quantised wires run
    K1 (:func:`fused_stage`) straight from the shipped view; a float wire
    slices the stage, widens float16 to float32 (as the JAX package
    does), packs it with :func:`_pack` and runs K2
    (:func:`cascade_stage`)."""
    tables, coefs = _stage_operands(st, plan, wire.device)
    if meta["mode"] in _WIRE_Q:
        return _launch("fused_stage", fused_stage,
                       (wire, meta["scales_dev"], stage_geom(meta, i, st.n),
                        tables, coefs), stage=i, bucket=None)
    off = int(meta["offs"][i])
    container = _pack(wire[:, off : off + st.n].to(torch.float32), tables.p,
                      tables.m, st.batch.R, tables.P)
    return _launch("cascade_stage", cascade_stage, (container, tables, coefs),
                   stage=i, bucket=None)


def _run_launch(plan, ln, wire, meta):
    """Queue one :class:`Launch` of the plan's layout on the shipped
    wire; returns its (D, B, RE, NW) S/N (unsynced on a CUDA device). A
    whole stage runs :func:`_run_stage`; a lane bucket runs K1 in its own
    container, or K3 with its guest stage's trials in its dead rows."""
    st = plan.stages[ln.stage]
    if ln.bucket is None:
        return _run_stage(st, plan, ln.stage, wire, meta)
    dev, scales = wire.device, meta["scales_dev"]
    geom = stage_geom(meta, ln.stage, st.n)
    if ln.guest is None:
        tables, coefs = _bucket_operands(st, plan, ln.bucket, dev)
        return _launch("fused_stage", fused_stage,
                       (wire, scales, geom, tables, coefs), stage=ln.stage,
                       bucket=ln.bucket)
    st2 = plan.stages[ln.guest]
    tables, coefs = _paired_operands(st, plan, ln.bucket, st2, ln.bases, dev)
    return _launch("paired_stage", paired_stage,
                   (wire, scales, geom, stage_geom(meta, ln.guest, st2.n),
                    tables, coefs), stage=ln.stage, bucket=ln.bucket,
                   guest=ln.guest)


def _queue_stages(plan, wire, meta):
    """Queue the launches of the plan's layout (:func:`launch_layout`)
    on the shipped wire, stage by stage, each stage in an ``ffa_stage``
    span (``stage=i``). Returns (outs, layout): each launch's S/N
    container in the layout's order, for :func:`_assemble_device`."""
    lay = launch_layout(plan, meta["mode"])
    outs = []
    for i, launches in enumerate(lay.stages):
        _walk_phase(i)
        with span("ffa_stage", stage=i):
            for ln in launches:
                outs.append(_run_launch(plan, ln, wire, meta))
    _walk_phase("assemble")
    return outs, lay


def _assemble_device(plan, pieces, outs):
    """Slice every evaluated trial's rows out of the queued containers
    ``outs`` at the positions ``pieces`` lists ((output, row, base,
    rows), in plan trial order: :attr:`Layout.pieces`) and concatenate
    them, on the device: (D, n_trials, NW). A row-packed guest's trials
    are read from its host's container at each trial's base row."""
    chunks = [outs[o][:, j, off : off + re, :] for o, j, off, re in pieces]
    if not chunks:
        D = outs[0].shape[0] if outs else 0
        return torch.empty((D, 0, len(plan.widths)), dtype=torch.float32)
    return torch.cat(chunks, dim=1)


@contextlib.contextmanager
def recording():
    """Record the searches run inside the block. Yields a dict that each
    search fills anew: the seconds of its parts on the host clock, the
    device synchronised between them (``prep_s`` wire preparation,
    ``ship_s`` copy to the device, ``stages_s`` the stage loop,
    ``out_s`` assembly and copy back; a survey batch has ``assemble_s``,
    ``peaks_s`` the device peak program and ``collect_s`` its pull and
    host tail instead of ``out_s``), and its operands: the shipped
    ``wire`` and ``meta``, every launch's S/N container ``outs`` in
    the order of the plan's ``layout`` (:func:`launch_layout`), and
    every kernel call in
    ``launches`` (kind, arguments, output, stage, lane bucket (None for a
    whole stage) and, for K3, the guest stage). The tensors stay alive with
    the dict."""
    global _RECORD
    prev, _RECORD = _RECORD, {}
    try:
        yield _RECORD
    finally:
        _RECORD = prev


class _Split:
    """Marks the parts of a recorded search (no-op when not recording)."""

    def __init__(self, dev):
        self.rec = _recorder()
        self.dev = dev
        self.t = time.perf_counter()

    def mark(self, name):
        if self.rec is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.rec[name] = now - self.t
        self.t = now


def _queue_batch(plan, batch, dev, prepared=None, shipped=None, pool=None):
    """Prepare (unless given; into ``pool``'s buffers), ship (unless
    given) and queue every stage (span ``stages``) and the assembly
    (span ``assemble``); returns the device S/N cube (D, n_trials, NW),
    unsynced, the split and the prepared wire (None when ``shipped`` was
    given)."""
    split = _Split(dev)
    if split.rec is not None:
        split.rec.clear()
    if shipped is None:
        if prepared is None:
            prepared = prepare_stage_data(plan, batch, pool=pool)
        split.mark("prep_s")
        shipped = ship_stage_data(prepared, dev)
    split.mark("ship_s")
    wire, meta = shipped
    with span("stages"):
        outs, layout = _queue_stages(plan, wire, meta)
    split.mark("stages_s")
    if split.rec is not None:
        split.rec.update(wire=wire, meta=meta, outs=outs, layout=layout)
    with span("assemble"):
        snr_dev = _assemble_device(plan, layout.pieces, outs)
    return snr_dev, split, prepared


def _search(plan, batch, device):
    snr_dev, split, _ = _queue_batch(plan, batch, device)
    # One device->host copy for the whole cube.
    snrs = np.ascontiguousarray(snr_dev.cpu().numpy(), dtype=np.float32)
    split.mark("out_s")
    return snrs


def run_periodogram(plan, data, device=None):
    """
    Execute a :class:`~riptide_tpu_torch.search.plan.PeriodogramPlan` on a
    single normalised series, on ``device`` (the card when None; pass
    ``device="cpu"`` for the plain PyTorch versions).

    Returns (periods float64, foldbins uint32, snrs float32 (len, NW)) with
    the exact output contract of the reference's ``libcpp.periodogram``
    (riptide/cpp/python_bindings.cpp:168-197).
    """
    dev = resolve_device(device)
    data = np.asarray(data, dtype=np.float32)
    if data.size != plan.size:
        raise ValueError("data length does not match plan size")
    snrs = _search(plan, data.reshape(1, -1), dev)[0]
    return plan.all_periods.copy(), plan.all_foldbins.copy(), snrs


def run_periodogram_batch(plan, batch, device=None):
    """
    Execute the plan over a (D, N) stack of normalised series (one per DM
    trial), every stage as one set of kernel launches over the whole
    batch. Runs on ``device`` like :func:`run_periodogram`.

    Returns (periods, foldbins, snrs (D, len, NW)).
    """
    dev = resolve_device(device)
    snrs = _search(plan, batch, dev)
    return plan.all_periods.copy(), plan.all_foldbins.copy(), snrs


# ---------------------------------------------------------------------------
# The survey batch: periodogram and peaks on the device
# ---------------------------------------------------------------------------

_PEAK_PLANS_LOCK = threading.Lock()


def _peak_plan(plan, tobs, **peak_kwargs):
    """The plan's cached :class:`~.peaks_device.PeakPlan` for ``tobs``
    and the peak arguments."""
    from .peaks_device import PeakPlan

    key = (float(tobs), tuple(sorted(peak_kwargs.items())))
    with _PEAK_PLANS_LOCK:
        cache = getattr(plan, "_peak_plans", None)
        if cache is None:
            cache = plan._peak_plans = {}
        pp = cache.get(key)
        fresh = pp is None
        if fresh:
            pp = cache[key] = PeakPlan(plan, tobs, **peak_kwargs)
    count_warmth(fresh)
    return pp


def queue_search_batch(plan, batch, tobs, prepared=None, shipped=None,
                       device=None, pool=None, **peak_kwargs):
    """Queue one batch's whole device side without syncing: the stage
    launches, the device assembly of the S/N cube and the peak program
    (spans ``stages``, ``assemble`` and ``peaks``).
    ``prepared`` (from :func:`prepare_stage_data`) skips the host prep,
    ``shipped`` (from :func:`ship_stage_data`) the copy as well, and then
    the wire's device is used. With ``pool`` (a :class:`StagingPool`) the
    batch is prepared into the pool's buffers, and the chunk's staging
    buffers (its own, or those of ``prepared``) go back to the pool when
    :func:`collect_search_batch` has collected it. Returns a handle for
    :func:`collect_search_batch`."""
    from .peaks_device import queue_find_peaks

    dev = shipped[0].device if shipped is not None else resolve_device(device)
    pp = _peak_plan(plan, tobs, **peak_kwargs)
    snr_dev, split, prepared = _queue_batch(plan, batch, dev, prepared,
                                            shipped, pool)
    split.mark("assemble_s")
    with span("peaks"):
        handle = queue_find_peaks(pp, snr_dev)
    split.mark("peaks_s")
    return pp, handle, (pool, prepared)


def collect_search_batch(handle, dms):
    """Sync one queued batch: one device->host pull and the host tail
    (spans ``pull`` and ``tail``, :func:`.peaks_device.collect_peaks`);
    then the chunk's staging buffers go back to its pool (their copy
    has completed by then). Returns (peaks_per_trial,
    polycos_per_trial)."""
    from ..survey.integrity import set_collect_path
    from .peaks_device import collect_peaks

    pp, peaks_handle, staged = handle
    set_collect_path("batch")
    t0 = time.perf_counter()
    # The device_s timer covers the blocking wait on the queued work and
    # the one result pull (inside collect_peaks) and the host tail.
    with get_metrics().timer("device_s"):
        out = collect_peaks(pp, peaks_handle, dms)
    rec = _recorder()
    if rec is not None:
        rec["collect_s"] = time.perf_counter() - t0
    release_prepared(*staged)
    return out


def search_snr_dev(handle):
    """The queued batch's (D, trials, NW) S/N cube on the device, until
    :func:`collect_search_batch` releases it."""
    return handle[1][1]


def run_search_batch(plan, batch, tobs, dms=None, prepared=None,
                     shipped=None, device=None, pool=None, **peak_kwargs):
    """
    Batched search with peak detection on the device: the periodogram
    stages, device assembly, the peak program, then the host's exact
    check and clustering (reference semantics:
    riptide/peak_detection.py:146-222). Only the peak buffers cross to
    the host. Runs on ``device`` (the card when None), or where
    ``shipped`` lies; ``dms`` (D,) defaults to zeros. ``pool`` as in
    :func:`queue_search_batch`.

    Returns (peaks_per_trial, polycos_per_trial).
    """
    handle = queue_search_batch(plan, batch, tobs, prepared=prepared,
                                shipped=shipped, device=device, pool=pool,
                                **peak_kwargs)
    if dms is None:
        dms = np.zeros(search_snr_dev(handle).shape[0], np.float64)
    return collect_search_batch(handle, dms)


# ---------------------------------------------------------------------------
# Analysis: the wire's transfer shape, the measured peak, the walk
# ---------------------------------------------------------------------------

def _wire_nparts(plan):
    """How many parts the JAX package's ``ship_stage_data`` cuts the
    wire into: up to 4, at stage boundaries (its ``_wire_parts``). The
    port ships the same bytes as one tensor (plus the scales)."""
    return min(4, len(plan.stages))


def wire_transfer_contract(plan, mode):
    """Host->device transfer shape of one chunk, exact from the wire
    layout, as the JAX package's ``wire_transfer_contract`` gives it for
    the same plan and wire mode: ``h2d_transfers`` (the reference's
    wire parts, plus one for the scales of a quantised wire), the bytes
    per DM trial in all and per stage, and the one device->host pull of
    the peak program's buffer. The bytes are the port's too (the same
    wire); the port copies them in one tensor and one scales tensor
    (``walk_search`` counts those copies)."""
    _, _, tot = _wire_layout(plan, mode)
    nparts = _wire_nparts(plan)
    if mode in _WIRE_Q:
        vl = _view_layout(plan, mode)
        per_stage = [int(vl["wrows"][i]) * vl["PW"] + int(vl["r0s"][i]) * 4
                     for i in range(len(plan.stages))]
        total = int(vl["tot_rows"]) * vl["PW"] + int(vl["stot"]) * 4
        h2d = nparts + 1
    else:
        item = np.dtype(mode).itemsize
        per_stage = [int(st.n) * item for st in plan.stages]
        total = int(tot) * item
        h2d = nparts
    return {"h2d_transfers": int(h2d), "h2d_bytes_per_dm": int(total),
            "per_stage_wire_bytes_per_dm": per_stage, "d2h_pulls": 1}


def device_peak_bytes(device=None):
    """The card's peak allocated bytes in this process
    (``torch.cuda.max_memory_allocated``), a process-lifetime high-water
    mark that the engine never resets; None on the CPU. ``device`` is
    the search's card (the current one when None). The journal's
    ``hbm`` block pairs it with the peak-memory model's prediction."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device)
    return int(peak) if peak else None


def _device_key(device):
    """The operand caches' key of ``device``: a card with its index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def drop_device_operands(plan, device):
    """Forget the stage operands cached on ``plan``'s stages for
    ``device``, so the next search there uploads them anew (and their
    buffers are freed once nothing else holds them)."""
    key = _device_key(device)
    for st in plan.stages:
        cache = getattr(st, "_device_operands", None)
        if cache:
            # list() copies the keys at once: another thread's search
            # may add its own meanwhile.
            for k in [k for k in list(cache) if k[0] == key]:
                cache.pop(k, None)


def _blank_prepared(plan, D, mode):
    """A prepared wire of ``D`` trials in ``mode`` with the layout of
    :func:`prepare_stage_data` and zero bytes, computed from nothing
    (``np.zeros`` touches no page until read)."""
    offs, _, tot = _wire_layout(plan, mode)
    if mode in _WIRE_Q:
        vl = _view_layout(plan, mode)
        return (np.zeros((D, vl["tot_rows"], vl["PW"]), np.uint8),
                {"mode": mode, "offs": offs, "view": vl, "prep": "blank",
                 "scales": np.zeros((D, vl["stot"]), np.float32),
                 "staging": ()})
    return (np.zeros((D, tot), np.dtype(mode)),
            {"mode": mode, "offs": offs, "scales": None, "prep": "blank",
             "staging": ()})


# The calling thread's walk (walk_search, ``tally``) or warm-up
# (warm_stage_kernels, ``warmed``), read by _launch and the stage loop.
_WALK = threading.local()


def _walk_phase(phase):
    """Tell the calling thread's walk, if any, which part of the search
    runs now (a stage index, ``"assemble"``)."""
    tally = getattr(_WALK, "tally", None)
    if tally is not None:
        tally.phase = phase


_F64 = (torch.float64, torch.complex128)


class _Tally(TorchDispatchMode):
    """The device side of the ops run under it, on ``device``: every op
    output on the device whose storage is new is an allocation of the
    storage's bytes, freed when the storage dies (a finalizer on the
    storage, so a live view keeps it, as the caching allocator would).
    Live bytes and their peak are kept, each storage gets an address
    (512-byte aligned, the allocator's rounding) for
    ``ffa_kernel._ptr``, host->device copies are counted with their
    bytes, and the dtypes made on the device and the float64/complex128
    outputs are collected, by phase (``"ship"``, a stage index,
    ``"assemble"`` and ``"peaks"``)."""

    def __init__(self, device, shape_state=None):
        super().__init__()
        self.device = device
        self.shape = shape_state
        self.live = {}
        self.base = {}
        self.next_addr = 1 << 32
        self.cur = self.peak = 0
        self.phase = "ship"
        self.h2d = {}          # phase -> [copies, bytes]
        self.f64 = {}          # phase -> float64/complex128 outputs
        self.dtypes = set()
        self.launches = []
        self._open = None      # the launch record being filled

    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def address(self, t):
        return self.base.get(self._key(t), 0) \
            + t.storage_offset() * t.element_size()

    def _free(self, key):
        self.cur -= self.live.pop(key, 0)

    def _note(self, t, func, args):
        if t.device != self.device:
            return
        self.dtypes.add(str(t.dtype).replace("torch.", ""))
        if t.dtype in _F64:
            self.f64[self.phase] = self.f64.get(self.phase, 0) + 1
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        nbytes = int(st.nbytes())
        self.live[key] = nbytes
        self.base[key] = self.next_addr
        self.next_addr += -(-max(nbytes, 1) // 512) * 512
        weakref.finalize(st, self._free, key)
        self.cur += nbytes
        self.peak = max(self.peak, self.cur)
        if self._open is not None:
            self._open["allocs"].append(
                (tuple(t.shape), str(t.dtype).replace("torch.", ""), nbytes))
        if func in (torch.ops.aten._to_copy.default,
                    torch.ops.aten.copy_.default) and any(
                isinstance(a, torch.Tensor) and a.device.type == "cpu"
                for a in tree_leaves(args)):
            h = self.h2d.setdefault(self.phase, [0, 0])
            h[0] += 1
            h[1] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._note(t, func, args)
        return out

    def launch(self, kind, fn, args, where):
        """One stage wrapper call: its kind and place, the CUDA kernels
        it counts, its shape-only library calls and its allocations."""
        kernels0 = dict(self.shape.kernels)
        ncalls = len(self.shape.calls)
        rec = dict(where, kind=kind, shape=launch_shape(kind, args),
                   allocs=[])
        self._open = rec
        try:
            out = fn(*args)
        finally:
            self._open = None
        rec["kernels"] = {k: v - kernels0[k]
                          for k, v in self.shape.kernels.items()
                          if v != kernels0[k]}
        rec["calls"] = self.shape.calls[ncalls:]
        rec["out"] = (tuple(out.shape), str(out.dtype).replace("torch.", ""))
        self.launches.append(rec)
        return out


_WALK_LOCK = threading.Lock()


def walk_peak(fn):
    """The most device bytes ``fn()`` holds live at once, run on the
    ``meta`` device (``fn`` makes its own meta tensors): the same tally
    as :func:`walk_search`, for device work outside the search (the
    loaders' de-reddening)."""
    tally = _Tally(torch.device("meta"))
    with tally:
        fn()
    return int(tally.peak)


def walk_search(plan, D, mode=None, tobs=None, data=None, survey=True):
    """The shape-only walk of one ``D``-trial survey search of ``plan``
    (:func:`queue_search_batch`'s device side: the wire's copy, every
    stage launch, the assembly and the peak program) on the ``meta``
    device, on ``mode``'s wire (default :func:`_wire_mode`). The real
    queue path runs; the stage wrappers take their shape-only form
    (``ffa_kernel.ShapeOnlyLibrary``), so nothing is computed or
    launched and no card is needed. The stage
    operands are uploaded cold (the device's cache is dropped first),
    as a plan's first search on a card uploads them. With ``data`` (a
    (D, N) float32 batch) the same walk follows the plain path on the
    CPU instead, on that data's prepared wire (the dtype-flow audit's
    second view). ``survey=False`` walks :func:`run_periodogram_batch`
    instead: no peak program, the cube is pulled whole.

    Returns a dict: ``launches`` (per wrapper call: ``kind``, ``stage``,
    ``bucket``, ``guest``, ``kernels`` counted under it, ``calls`` of
    the shape-only library with the walk's addresses, ``shape``
    (:func:`launch_shape`), ``allocs`` (shape, dtype, bytes) and ``out``
    (shape, dtype)), ``launch_counts`` and
    ``kernel_counts`` (the wrappers' own counters), ``peak_bytes`` (the
    most device bytes live at once, raw tensor bytes), ``h2d`` (per
    phase: copies, bytes), ``f64`` (float64/complex128 outputs per
    phase), ``dtypes``, ``out_dtype`` (the assembled S/N cube) and
    ``peaks`` (the pulled buffer's bytes and dtype, and whether the
    device clustering ran)."""
    from ..ops import ffa_kernel
    from .peaks_device import PeakPlan

    mode = mode or _wire_mode()
    tobs = float(tobs if tobs is not None else plan.size * plan.tsamp)
    pp = PeakPlan(plan, tobs) if survey else None
    if data is None:
        dev = torch.device("meta")
        flat, meta = _blank_prepared(plan, D, mode)
    else:
        dev, D = torch.device("cpu"), len(data)
        flat, meta = _prepare_stage_data(plan, data, mode, None)
    # One walk at a time: the operand caches of the meta device are the
    # plan's. While the walk's tally is set, this thread's searches
    # record nothing (_recorder); a recording on another thread goes on.
    with _WALK_LOCK, ffa_kernel.shape_only() as shape:
        drop_device_operands(plan, dev)
        tally = _Tally(dev, shape)
        shape.address = tally.address
        _WALK.tally = tally
        try:
            with tally:
                # The shipped wire is the queue's only: it is freed when
                # the stage loop and the assembly are done, as in
                # queue_search_batch.
                box = [_ship(flat, meta, dev)]
                snr, _, _ = _queue_batch(plan, None, dev, shipped=box.pop())
                tally.phase = "peaks"
                pulled = pp._fused(snr) if survey else snr
            out = {
                "D": int(D), "mode": mode, "launches": tally.launches,
                "launch_counts": dict(shape.launches),
                "kernel_counts": dict(shape.kernels),
                "peak_bytes": int(tally.peak), "h2d": tally.h2d,
                "f64": tally.f64, "dtypes": sorted(tally.dtypes),
                "out_dtype": str(snr.dtype).replace("torch.", ""),
                "peaks": {"device_cluster": bool(survey
                                                 and pp.device_cluster),
                          "out_bytes": int(pulled.nbytes),
                          "out_dtype": str(pulled.dtype).replace(
                              "torch.", "")},
            }
            del snr, pulled
        finally:
            _WALK.tally = None
            drop_device_operands(plan, dev)
    return out


# ---------------------------------------------------------------------------
# Warm-up: the libraries, and every launch shape once before the search
# ---------------------------------------------------------------------------

def launch_shapes(plan, D, mode=None):
    """The distinct :func:`launch_shape` values of one ``D``-trial search
    of ``plan`` on wire ``mode`` (default :func:`_wire_mode`), read from
    the shape-only walk (:func:`walk_search`): what
    :func:`warm_stage_kernels` warms."""
    walk = walk_search(plan, D, mode=mode, survey=False)
    return {ln["shape"] for ln in walk["launches"]}


def warm_stage_kernels(plan, D, parallel=True, device=None):
    """Ready ``device`` (the card when None) for a ``D``-trial search of
    ``plan``, as the JAX package's ``warm_stage_kernels`` readies the TPU.
    First the libraries the search needs come from the build cache
    (``utils/exec_cache.py``), built there at first use: the native wire
    prep and, on a CUDA device, the stage kernels (``csrc/ffa_stage.cu``)
    and the peak program's cluster kernel (``csrc/cluster.cu``, loaded at
    its first launch); with ``parallel`` the builds run together. Then
    each distinct :func:`launch_shape` of the search is queued once, at
    ``D``, on a
    zero wire of the live wire mode, and every container's operands are
    uploaded on the way (:func:`_cached`): the first allocations of each
    shape and the operand uploads leave the first search. Returns the
    number of distinct launch shapes warmed
    (``len(launch_shapes(plan, D))``)."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native
    from ..ops import ffa_kernel
    from .peaks_device import build_cluster

    dev = resolve_device(device)
    builds = [native.build]
    if dev.type == "cuda":
        builds += [ffa_kernel.build, build_cluster]
    if parallel:
        with ThreadPoolExecutor(len(builds)) as ex:
            for fut in [ex.submit(b) for b in builds]:
                fut.result()
    else:
        for b in builds:
            b()
    if dev.type == "cuda":
        ffa_kernel._library()
    wire, meta = _ship(*_blank_prepared(plan, D, _wire_mode()), dev)
    _WALK.warmed = warmed = set()
    try:
        _queue_stages(plan, wire, meta)
    finally:
        _WALK.warmed = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return len(warmed)
