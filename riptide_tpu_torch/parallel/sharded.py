"""
Mesh-sharded periodogram execution: the port of the JAX package's
``parallel/sharded.py``.

Two distributed entry points:

* :func:`run_periodogram_sharded` — the distributed counterpart of
  ``run_periodogram_batch``: the DM axis splits over the ``dm`` mesh
  axis (and each stage's bins-trial batch over an optional ``bins``
  axis). Returns the full S/N cube — use it when the periodogram itself
  is the product.
* :func:`queue_search_sharded` / :func:`collect_search_sharded` (and
  the one-shot :func:`run_search_sharded`) — the survey path: each
  shard's S/N cube stays on its device, the peak program runs there,
  and only each shard's peak buffer comes to the host, mirroring the
  reference's tiny-pickled-Peaks worker contract
  (riptide/pipeline/worker_pool.py:47-71). The queue/collect split lets
  callers queue batch i + 1 before paying batch i's round trip
  (``pipeline.batcher`` does this with a mesh).

The wire is the engine's (uint6 by default): :func:`prepare_stage_data_sharded`
pads D to the ``dm`` axis and runs the engine's preparation, and
:func:`ship_stage_data_sharded` copies each shard's D/n_dm slice of the
wire and scales to its device on the engine's copy stream. Per shard and
stage, torch ops decode the stage's rows (``engine._decode_stage_rows``)
and pack its container (``engine._pack``) on the shard's device, and
K2 (``ffa_kernel.cascade_stage``) runs the FFA levels and the S/N: one
launch per stage per shard, through ``engine._launch`` (kept by
``engine.recording()`` with its ``shard`` and ``bins`` slice), as the
JAX package runs its decode, pack and cycle kernel inside ``shard_map``.
Stages that are not ``_kernel_eligible`` run whole through K2 as well,
as the engine's float wire runs them.

A ``bins`` axis gives each (dm, bins) shard a contiguous slice of every
stage's padded bins trials, its K2 operands built from the slice's
indices as a lane bucket's are; the JAX package runs that layout on its
gather path instead, with the same outputs. The shards hold no
collectives: every stage of every shard is independent.
"""
import contextlib

import numpy as np
import torch

from ..obs.trace import span
from ..ops.ffa_kernel import WIRE_MODES, cascade_stage
from ..ops.plan import FFABatchPlan
from ..search import engine
from ..search.engine import _WIRE_Q, prepare_stage_data, ship_stage_data
from ..survey.metrics import get_metrics

__all__ = ["run_periodogram_sharded", "run_search_sharded",
           "queue_search_sharded", "collect_search_sharded",
           "prepare_stage_data_sharded", "ship_stage_data_sharded"]


def _pad_dm(batch, mesh):
    """Zero-pad the DM axis up to a multiple of the mesh's dm axis."""
    D = batch.shape[0]
    dm_size = mesh.shape["dm"]
    Dpad = -(-D // dm_size) * dm_size
    if Dpad != D:
        batch = np.concatenate(
            [batch, np.zeros((Dpad - D,) + batch.shape[1:], batch.dtype)]
        )
    return batch, D


def _grid(mesh):
    """The mesh's devices as a (dm, bins) array (bins 1 on a 1-D mesh)."""
    names = mesh.axis_names
    if "dm" not in names or set(names) - {"dm", "bins"}:
        raise ValueError(f"a sharded search takes a mesh with a 'dm' axis "
                         f"and optionally a 'bins' axis, got {names}")
    if "bins" not in names:
        return mesh.devices.reshape(-1, 1)
    return np.transpose(mesh.devices, (names.index("dm"),
                                       names.index("bins")))


def _on(dev):
    """Make ``dev`` the current CUDA device for the block (the kernels'
    launches go to the current device); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def prepare_stage_data_sharded(plan, batch, mesh, mode=None):
    """HOST half of a sharded search: pad the (D, N) batch to the mesh's
    dm axis, then run the engine's wire preparation (native when it
    built). Returns ``(prepared, D)`` with D the original (unpadded)
    trial count, also kept as ``meta["D_original"]``."""
    batch = np.asarray(batch, dtype=np.float32)
    if batch.ndim != 2 or batch.shape[1] != plan.size:
        raise ValueError("batch must be (D, N) with N matching the plan")
    batch, D = _pad_dm(batch, mesh)
    flat, meta = prepare_stage_data(plan, batch, mode=mode)
    meta["D_original"] = D
    return (flat, meta), D


def ship_stage_data_sharded(plan, prepared, mesh):
    """Start the dm-sharded host->device copies of a prepared wire: each
    dm shard's D/n_dm slice of the wire (and scales) to each of its
    devices (once per distinct device), on the engine's copy stream.
    Returns ``(shards, meta)`` for :func:`queue_search_sharded`'s
    ``shipped``: ``shards[i][j]`` is the (wire, meta) of mesh position
    (dm i, bins j)."""
    flat, meta = prepared
    grid = _grid(mesh)
    per = flat.shape[0] // grid.shape[0]
    shards = []
    for i, row in enumerate(grid):
        lo, hi = i * per, (i + 1) * per
        scales = meta["scales"]
        part = (flat[lo:hi], dict(
            meta, scales=None if scales is None else scales[lo:hi]))
        copies = {}
        for dev in row:
            if dev not in copies:
                copies[dev] = ship_stage_data(part, dev)
        shards.append([copies[dev] for dev in row])
    return shards, dict(meta)


def _bins_slices(plan, nb):
    """The padded bins-trial indices of each of ``nb`` bins shards."""
    B = len(plan.stages[0].ps_padded)
    if B % nb:
        raise ValueError(
            f"bins mesh axis size {nb} does not divide the plan's padded "
            f"bins-trial count {B}"
        )
    k = B // nb
    return [tuple(range(j * k, (j + 1) * k)) for j in range(nb)]


def _slice_operands(st, plan, idx, device):
    """(Tables, Coefs) of the stage's bins trials ``idx`` in a container
    of the whole stage's R, P and L, built as a lane bucket's are
    (``engine._bucket_operands``) and cached on the stage per device."""
    def build():
        b = st.batch
        sub = FFABatchPlan([st.ms_padded[i] for i in idx],
                           [st.ps_padded[i] for i in idx], R=b.R, P=b.P,
                           L=b.L)
        ix = list(idx)
        return engine._operands(sub, plan.widths, st.hcoef[ix],
                                st.bcoef[ix], st.stdnoise[ix],
                                engine._bucket_rows_eval(st, ix), device)

    return engine._cached(st, (str(device), "bins", tuple(idx)), build)


def _stage_shard(st, plan, s, wire, meta, idx, whole, shard):
    """Queue stage ``s`` on one shard: decode the stage's rows of the
    shard's wire, pack the container of its bins trials ``idx`` (the
    whole stage when ``whole``) and run K2. Returns (D_shard, len(idx),
    RE, NW) S/N."""
    dev = wire.device
    if whole:
        tables, coefs = engine._stage_operands(st, plan, dev)
    else:
        tables, coefs = _slice_operands(st, plan, idx, dev)
    mode = meta["mode"]
    if mode in _WIRE_Q:
        g = engine.stage_geom(meta, s, st.n)
        xd = engine._decode_stage_rows(mode, wire, meta["scales_dev"], g.roff,
                                       WIRE_MODES[mode][1] * g.pr, g.soff,
                                       g.r0, g.n)
    else:
        off = int(meta["offs"][s])
        xd = wire[:, off : off + st.n].to(torch.float32)
    container = engine._pack(xd, tables.p, tables.m, st.batch.R, tables.P)
    return engine._launch("cascade_stage", cascade_stage,
                          (container, tables, coefs), stage=s, bucket=None,
                          shard=shard, bins=tuple(idx))


def _queue_stages_sharded(plan, batch, mesh, shipped=None, mode=None):
    """Queue every cascade stage on every shard. Returns (outs, pieces,
    D_original): ``outs[i]`` dm shard i's S/N containers on its first
    device, stage by stage and bins slice by bins slice, and ``pieces``
    where each evaluated trial's rows sit among them, for
    :func:`~riptide_tpu_torch.search.engine._assemble_device`."""
    grid = _grid(mesh)
    slices = _bins_slices(plan, grid.shape[1])
    if shipped is None:
        prepared, D = prepare_stage_data_sharded(plan, batch, mesh, mode=mode)
        shipped = ship_stage_data_sharded(plan, prepared, mesh)
    else:
        # meta["D_original"] is set by prepare_stage_data_sharded: the one
        # source of truth for the unpadded trial count.
        D = shipped[1]["D_original"]
    shards = shipped[0]
    whole = len(slices) == 1
    outs = [[] for _ in shards]
    k = len(slices[0])
    for s, st in enumerate(plan.stages):
        for i, row in enumerate(shards):
            home = row[0][0].device
            for j, ((wire, meta), idx) in enumerate(zip(row, slices)):
                with _on(wire.device):
                    out = _stage_shard(st, plan, s, wire, meta, idx, whole,
                                       (i, j))
                outs[i].append(out.to(home))
    pieces = [(s * len(slices) + g // k, g % k, 0, re)
              for s, st in enumerate(plan.stages)
              for g, re in enumerate(st.rows_eval) if re]
    return outs, pieces, D


def run_periodogram_sharded(plan, batch, mesh=None):
    """
    Execute a periodogram plan over a (D, N) DM-trial batch sharded
    across a device mesh; returns the FULL S/N cube
    (periods float64, foldbins uint32, snrs float32 (D, trials, NW)).

    mesh : :class:`~riptide_tpu_torch.parallel.mesh.Mesh` with axis 'dm'
        (and optionally 'bins'). Defaults to a 1-D mesh over every card.
        D is padded up to a multiple of the dm-axis size.
    """
    from .mesh import default_mesh

    if mesh is None:
        mesh = default_mesh()
    outs, pieces, D = _queue_stages_sharded(plan, batch, mesh)
    cubes = []
    for o in outs:
        with _on(o[0].device):
            cubes.append(engine._assemble_device(plan, pieces, o).cpu()
                         .numpy())
    snrs = np.ascontiguousarray(np.concatenate(cubes)[:D], dtype=np.float32)
    return plan.all_periods.copy(), plan.all_foldbins.copy(), snrs


def queue_search_sharded(plan, batch, tobs, mesh=None, shipped=None,
                         mode=None, **peak_kwargs):
    """Queue one dm-sharded batch's ENTIRE device side — wire decode,
    periodogram stages, device assembly, the peak program on each shard —
    without syncing. Returns an opaque handle for
    :func:`collect_search_sharded`; queue batch i+1 before collecting
    batch i and the devices never idle on the host round trip."""
    from ..search.peaks_device import queue_find_peaks
    from .mesh import default_mesh

    if mesh is None:
        mesh = default_mesh()
    pp = engine._peak_plan(plan, tobs, **peak_kwargs)
    outs, pieces, D = _queue_stages_sharded(plan, batch, mesh,
                                            shipped=shipped, mode=mode)
    handles = []
    for o in outs:
        with _on(o[0].device):
            snr = engine._assemble_device(plan, pieces, o)
            handles.append(queue_find_peaks(pp, snr))
    return pp, handles, D


def collect_search_sharded(handle, dms):
    """Sync one queued sharded batch: pull each shard's peak buffer and
    finish its trials on the host (``collect_peaks``), joined in DM
    order. ``dms`` is padded to the shards' trial count. Returns
    (peaks_per_trial, polycos_per_trial) trimmed to the original
    (unpadded) D trials."""
    from ..search.peaks_device import collect_peaks
    from ..survey.integrity import set_collect_path

    pp, handles, D = handle
    set_collect_path("sharded")
    sizes = [h[1].shape[0] for h in handles]
    dms_full = np.concatenate(
        [np.asarray(dms, float), np.zeros(sum(sizes) - len(dms))]
    )
    peaks, polycos = [], []
    lo = 0
    with get_metrics().timer("device_s"), span("device"):
        for h, n in zip(handles, sizes):
            p, c = collect_peaks(pp, h, dms_full[lo : lo + n])
            peaks += p
            polycos += c
            lo += n
    return peaks[:D], polycos[:D]


def run_search_sharded(plan, batch, tobs, dms=None, mesh=None, mode=None,
                       **peak_kwargs):
    """
    Distributed survey search with on-device peak detection (queue +
    collect in one): each shard's S/N cube stays on its device; only
    KB-sized peak buffers come to the host. Returns (peaks_per_trial,
    polycos_per_trial) for the ORIGINAL (unpadded) D trials.
    """
    D = np.asarray(batch).shape[0]
    if dms is None:
        dms = np.zeros(D)
    handle = queue_search_sharded(plan, batch, tobs, mesh=mesh, mode=mode,
                                  **peak_kwargs)
    return collect_search_sharded(handle, dms)
