"""
Device batch searcher of the pipeline: the port of the JAX package's
``pipeline/batcher.py``, the replacement of the reference's
process-per-DM-trial WorkerPool (riptide/pipeline/worker_pool.py).

Where the reference forks one OS process per DM trial and searches each
series with single-threaded C++ on its own CPU core, this stage:

1. loads, scans, repairs, de-reddens and normalises a chunk of DM-trial
   files on a pool of host loader threads, and prepares the chunk's
   wire (:func:`~riptide_tpu_torch.search.engine.prepare_stage_data`)
   into a pinned :class:`~riptide_tpu_torch.search.engine.StagingPool`,
   while the card searches the chunk before (:meth:`process_stream`);
2. stacks equal-length series into one (D, N) batch, padded to
   ``batch_size`` trials so that a ragged last chunk keeps the plan's
   shapes;
3. copies the wire to the card on a ship thread (the engine's copy
   stream) and queues every configured period range's search of the
   batch through :func:`~riptide_tpu_torch.search.engine.queue_search_batch`:
   the FFA stages (K1, and K3 where buckets pair) and the device peak
   program; with a device mesh, the batch is dm-sharded over it instead
   (:mod:`riptide_tpu_torch.parallel.sharded`: each shard's slice of the
   wire to its device, K2 per stage and shard, the peak program per
   shard);
4. collects chunk i - 1's peaks after chunk i is queued, so the card
   stays busy while the host pays the previous chunk's round trip.

Only the peaks are kept, mirroring the reference's choice to move file
paths in and small Peak lists out of its workers
(riptide/pipeline/worker_pool.py:47-71).

The loader threads de-redden on their current CUDA stream, the one the
chunks are queued on: a chunk's search takes about the same time beside
16 de-reddening threads on that stream as alone (``loader_streams.py``
measures it against streams of their own). A chunk's staging buffers
go back to the pool in :meth:`release_chunk` once the chunk is
collected (the engine is not given the pool, so exactly one place
releases them). A device
out-of-memory error on a batch bisects it (:meth:`_collect_bisected`):
the failed batch's tensors are dropped, and the halves prepare and
search their own wire, recursively down to ``oom_floor`` trials.

With ``RIPTIDE_HBM_BUDGET`` set, the plan's peak-memory model
(:func:`riptide_tpu_torch.analysis.launch_contract.hbm_model`, fitted
from the shape-only walk of the stage loop) seeds the DM batch: a batch
it predicts over the budget is split before it is queued
(:meth:`_collect_seeded`, counted as ``oom_predicted``), its wire is
not prepared whole, and bisection stays the insurance against a wrong
model. :meth:`chunk_hbm_block` gives each journaled chunk its
predicted-vs-measured ``hbm`` block; on the card its prediction adds the
loader threads' de-reddening, which runs on the card beside the search
(:meth:`_loader_bytes`, one working set per loader thread).

The survey scheduler (:mod:`riptide_tpu_torch.survey.scheduler`) drives
the same chunk stages one at a time, with a journal record after each
(:meth:`chunk_dq_summary` and :meth:`restore_dq_reports` carry the
data-quality provenance through it).
"""
import logging
import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import quality
from ..ffautils import generate_width_trials
from ..obs.trace import span
from ..search import periodogram_plan
from ..search.engine import (StagingPool, collect_search_batch, is_oom_error,
                             prepare_stage_data, queue_search_batch,
                             release_prepared, run_search_batch,
                             ship_stage_data)
from ..survey import incidents
from ..survey.metrics import get_metrics
from ..time_series import TimeSeries
from ..utils import envflags
from ..utils.device import resolve_device

log = logging.getLogger("riptide_tpu_torch.pipeline.batcher")

__all__ = ["BatchSearcher"]


def loader_threads(requested):
    """The loader pool's size: ``requested``, but at most the cores this
    process may run on less one, and at least 1. The loaders' scan and
    de-reddening keep every thread of the pool busy while the chunk
    before is dispatched; with more loaders than cores, that dispatch's
    host work (the shadow probe, the pull and the peaks' host tail) runs
    on a share of a core and its wall swings by up to ten times from one
    chunk to the next (``loader_threads.py`` measures it)."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    return max(1, min(int(requested), cores - 1))


class BatchSearcher:
    """
    Parameters
    ----------
    deredden_params : dict with keys rmed_width, rmed_minpts
    range_confs : list of dicts
        The 'ranges' section of the pipeline config.
    fmt : str
        Input file format ('presto' or 'sigproc').
    io_threads : int
        Host threads used to load + detrend input files, at most the
        host's cores less one (:func:`loader_threads`).
    mesh : riptide_tpu_torch.parallel.Mesh or None
        When given, the DM batch is sharded over the mesh's 'dm' axis;
        otherwise one device runs it. The mesh's devices run the search;
        ``device`` runs the de-reddening.
    batch_size : int or None
        When set, device batches are zero-padded up to this many trials
        (the padded trials are discarded).
    dq : dict or DQConfig or None
        Data-quality configuration (:class:`riptide_tpu_torch.quality.DQConfig`):
        every loaded series is scanned, repaired and mask-normalised;
        series over max_masked_frac are quarantined (dropped from the
        batch with a report); the ingest_policy governs
        truncated/malformed files. None -> defaults.
    faults : FaultPlan or None
        Fault-injection hooks (the nan_inject and oom kinds fire here).
    oom_floor : int
        Smallest DM sub-batch the OOM bisection will retry; a batch
        that still exhausts device memory at this size propagates.
    device : str, torch.device or None
        Where the de-reddening and the search run: None means the card
        (``"cuda"``); pass ``"cpu"`` for the plain PyTorch versions.
    watchdog : ChunkWatchdog or None
        Liveness watchdog shared with the survey scheduler: the stream
        path feeds each chunk's queue-to-collect wall time into its
        duration EWMA, so deadline budgets are primed even before (or
        without) a journaled scheduler run.
    """

    TIMESERIES_LOADERS = {
        "presto": TimeSeries.from_presto_inf,
        "sigproc": TimeSeries.from_sigproc,
    }

    def __init__(self, deredden_params, range_confs, fmt="presto",
                 io_threads=4, mesh=None, batch_size=None, dq=None,
                 faults=None, oom_floor=1, device=None, watchdog=None):
        self.deredden_params = deredden_params
        self.range_confs = range_confs
        self.loader = self.TIMESERIES_LOADERS[fmt]
        self.io_threads = loader_threads(io_threads)
        self.mesh = mesh
        self.batch_size = batch_size
        self.dq = quality.DQConfig.from_any(dq)
        self.faults = faults
        self.oom_floor = max(1, int(oom_floor))
        self.device = resolve_device(device)
        self.watchdog = watchdog
        # basename -> QualityReport of every file this searcher loaded
        # (quarantined ones included); read by the pipeline for the
        # peaks.csv/candidates provenance columns and by the scheduler
        # for the journal's per-chunk DQ summary. dict assignment is
        # atomic under the GIL, so loader threads may write concurrently.
        self.dq_reports = {}
        # Wire-prep output buffers recycle across chunks through this
        # pool (acquired in _prepare_chunk, given back by release_chunk
        # once a chunk's results are collected).
        self._staging_pool = None

    # -- host side ----------------------------------------------------------

    def load_prepared(self, fname, chunk_id=0, search=True):
        """Load one file, then scan/repair/de-redden/mask-normalise it
        (once, shared by all search ranges —
        riptide/pipeline/worker_pool.py:54-58). Returns None when the
        file was skipped by the ingest policy or the series was
        quarantined by the data-quality scan.

        ``search=False`` is the candidate-rebuild reload: no fault
        injection, no DQ metrics, and the search-time QualityReport is
        kept."""
        with span("load", chunk=chunk_id):
            ts = self.loader(fname, policy=self.dq.ingest_policy)
        if ts is None:
            return None
        if search and self.faults is not None:
            self.faults.nan_inject(chunk_id, ts.data)
        with span("dq", chunk=chunk_id):
            prepared, report = quality.prepare_time_series(
                ts,
                rmed_width=self.deredden_params["rmed_width"],
                rmed_minpts=self.deredden_params["rmed_minpts"],
                dq=self.dq,
                device=self.device,
                record=search,
            )
        if search:
            self.dq_reports[os.path.basename(fname)] = report
        return prepared

    def dq_by_dm(self):
        """{dm: masked_frac} provenance map over every loaded series.
        A series without a DM in its metadata files under 0.0 — the
        same fallback its Peak rows carry — and collisions keep the
        largest masked fraction."""
        out = {}
        for r in self.dq_reports.values():
            key = float(r.dm) if r.dm is not None else 0.0
            out[key] = max(out.get(key, 0.0), r.masked_frac)
        return out

    def chunk_dq_summary(self, fnames):
        """JSON-able DQ summary of one chunk's files (for the survey
        journal's chunk records). The per-file reports ride along so a
        resumed survey can restore them (:meth:`restore_dq_reports`) and
        reproduce the provenance columns byte-identically."""
        reports = [self.dq_reports.get(os.path.basename(f)) for f in fnames]
        reports = [r for r in reports if r is not None]
        if not reports:
            return {}
        out = {
            "masked_samples": int(sum(r.n_masked for r in reports)),
            "masked_frac_max": round(max(r.masked_frac for r in reports), 6),
            "files": [r.to_dict() for r in reports],
        }
        quarantined = [r.fname for r in reports if r.quarantined]
        if quarantined:
            out["quarantined"] = quarantined
        return out

    def restore_dq_reports(self, dq_record):
        """Re-register per-file QualityReports from a journal chunk
        record's ``dq`` block (resume path: replayed chunks never
        re-load their files, so their provenance must come from the
        journal)."""
        for d in (dq_record or {}).get("files", []):
            if d.get("fname"):
                self.dq_reports.setdefault(
                    d["fname"], quality.QualityReport.from_dict(d)
                )

    # -- chunk processing ---------------------------------------------------

    def process_stream(self, fname_chunks):
        """Search a stream of DM-trial file chunks with cross-chunk
        overlap: while the card searches chunk i, the host is already
        loading, detrending and wire-preparing chunk i+1. Returns a flat
        list of Peaks."""
        chunks = [list(c) for c in fname_chunks]
        peaks = []
        metrics = get_metrics()
        # Three pools: `stager` runs the one-per-chunk prepare task
        # (load + detrend + wire preparation), `shipper` the chunk's
        # copy to the card, and `loaders` the file loads INSIDE the
        # staging task. (One shared pool would deadlock at
        # io_threads=1: the staging task would occupy the only worker
        # while waiting on its own load futures.)
        with ThreadPoolExecutor(max_workers=1) as stager, \
                ThreadPoolExecutor(max_workers=1) as shipper, \
                ThreadPoolExecutor(max_workers=self.io_threads) as loaders:

            def stage_chunk(fnames, cid):
                with span("stage", chunk=cid):
                    tslist = list(loaders.map(
                        lambda f: self.load_prepared(f, chunk_id=cid),
                        fnames
                    ))
                    items = self._prepare_chunk(tslist)
                return items, shipper.submit(self._ship_spanned, items, cid)

            def drain(queued, t_queued, cid, prep_items):
                with span("collect", chunk=cid):
                    peaks.extend(self._collect_chunk(queued))
                # Collected: this chunk's staging buffers may be reused
                # by the stager once their copies have completed.
                self.release_chunk(prep_items)
                metrics.add("chunks_done")
                if self.watchdog is not None:
                    # Prime the liveness EWMA with this chunk's queue->
                    # collect wall time, so a later journaled run starts
                    # with a calibrated deadline budget.
                    self.watchdog.observe(time.perf_counter() - t_queued)

            pending = (stager.submit(stage_chunk, chunks[0], 0)
                       if chunks else None)
            queued = q_items = None
            t_queued = 0.0
            for i, chunk in enumerate(chunks):
                metrics.set_gauge("queue_depth", len(chunks) - i)
                prep_items, ship_fut = pending.result()  # prep done
                pending = (stager.submit(stage_chunk, chunks[i + 1], i + 1)
                           if i + 1 < len(chunks) else None)
                items = ship_fut.result()     # copy queued
                # The futures hold the shipped wire too: drop them, so
                # that it is freed once its search is queued.
                ship_fut = None
                # Queue chunk i's device work BEFORE collecting chunk
                # i-1: the card stays busy while the host pays the
                # previous chunk's result round trip.
                t_nxt = time.perf_counter()
                with span("queue", chunk=i):
                    nxt = self._queue_chunk(items)
                del items
                if queued is not None:
                    drain(queued, t_queued, i - 1, q_items)
                queued, t_queued, q_items = nxt, t_nxt, prep_items
                log.debug(
                    f"Chunk {i + 1}/{len(chunks)} ({len(chunk)} files) "
                    f"queued, total peaks: {len(peaks)}"
                )
            if queued is not None:
                drain(queued, t_queued, len(chunks) - 1, q_items)
            metrics.set_gauge("queue_depth", 0)
        return peaks

    def process_fname_list(self, fnames):
        """Search one chunk of DM-trial files; returns a flat Peak list."""
        return self.process_stream([fnames])

    def _plan_for(self, conf, nsamp, tsamp):
        kw = conf["ffa_search"]
        widths = generate_width_trials(
            kw["bins_min"],
            ducy_max=kw.get("ducy_max", 0.20),
            wtsp=kw.get("wtsp", 1.5),
        )
        return periodogram_plan(
            nsamp, tsamp, tuple(int(w) for w in widths),
            float(kw["period_min"]), float(kw["period_max"]),
            int(kw["bins_min"]), int(kw["bins_max"]),
        )

    def _prepare_chunk(self, tslist):
        """Host half of one chunk: group by shape, build the (D, N)
        batches (padded to ``batch_size``) and prepare their wire into
        the staging pool (with a mesh, padded to its dm axis and
        prepared unpooled). Returns a list of (members, batch, conf, plan,
        prepared) work items. Entries of ``tslist`` that are None (files
        skipped by the ingest policy or series quarantined by the DQ
        scan) are dropped here."""
        if self._staging_pool is None:
            self._staging_pool = StagingPool(self.device)

        tslist = [ts for ts in tslist if ts is not None]
        # Batch programs need equal-shape inputs: group by (nsamp, tsamp).
        # In practice all DM trials of one observation are identical.
        groups = defaultdict(list)
        for ts in tslist:
            groups[(ts.nsamp, round(ts.tsamp, 12))].append(ts)

        items = []
        for (nsamp, _), members in groups.items():
            batch = np.stack([ts.data for ts in members])
            if self.batch_size and len(members) < self.batch_size:
                pad = self.batch_size - len(members)
                batch = np.concatenate(
                    [batch, np.zeros((pad, nsamp), np.float32)]
                )
            for conf in self.range_confs:
                plan = self._plan_for(conf, batch.shape[1], members[0].tsamp)
                if self.mesh is not None:
                    from ..parallel import prepare_stage_data_sharded

                    prepared, _ = prepare_stage_data_sharded(
                        plan, batch, self.mesh
                    )
                elif self._seed_batch_limit(plan, batch.shape[0]) \
                        is not None:
                    # The peak-memory model will split this batch at
                    # queue time (_queue_range): the whole batch's wire
                    # would be discarded work, as the slices prepare
                    # their own.
                    prepared = None
                else:
                    prepared = prepare_stage_data(plan, batch,
                                                  pool=self._staging_pool)
                items.append((members, batch, conf, plan, prepared))
        return items

    def _ship_spanned(self, items, cid):
        """:meth:`_ship_chunk` in a chunk-tagged span (on the ship
        thread)."""
        with span("ship", chunk=cid):
            return self._ship_chunk(items)

    def _ship_chunk(self, items):
        """Start every prepared work item's copy to the card (on the
        engine's copy stream), dm-sharded over the mesh when one is
        configured."""
        if self.mesh is not None:
            from ..parallel import ship_stage_data_sharded

            return [
                (members, batch, conf, plan,
                 ship_stage_data_sharded(plan, prepared, self.mesh))
                for members, batch, conf, plan, prepared in items
            ]
        return [
            (members, batch, conf, plan,
             ship_stage_data(prepared, self.device) if prepared is not None
             else None)
            for members, batch, conf, plan, prepared in items
        ]

    def _queue_chunk(self, items):
        return [
            self._queue_range(conf, members, batch, plan, shipped)
            for members, batch, conf, plan, shipped in items
        ]

    def _collect_chunk(self, queued):
        return [p for collect in queued for p in collect()]

    def release_chunk(self, items):
        """Give a collected chunk's wire-prep buffers back to the staging
        pool, each with the event of its copy to the card: the pool
        hands a buffer out again only once that copy has completed.
        Call only once the chunk's results are in hand."""
        if self._staging_pool is None or not items:
            return
        for it in items:
            release_prepared(self._staging_pool, it[-1])

    # -- model-seeded DM-batch pick (the launch-contract memory model) -----

    def _hbm_model(self, plan):
        """The plan's peak-memory model
        (:func:`riptide_tpu_torch.analysis.launch_contract.hbm_model`,
        cached on the plan), or None when the walk fails: the model is
        an optimisation and never a reason a search cannot run. A
        failure is cached too (one warning, one walk per plan)."""
        if getattr(plan, "_hbm_model_failed", False):
            return None
        try:
            from ..analysis.launch_contract import hbm_model

            return hbm_model(plan)
        except Exception as err:
            plan._hbm_model_failed = True
            log.warning("peak-memory model unavailable for this plan (%s); "
                        "OOM bisection remains the only throttle", err)
            return None

    def _seed_batch_limit(self, plan, D):
        """Largest DM batch the model predicts fits the
        ``RIPTIDE_HBM_BUDGET`` budget, or None when seeding is off (no
        budget, or a mesh), the model is unavailable or D already fits.
        Seeding makes the dispatch -> OOM -> halve cycle a split before
        queueing; bisection stays for a model miss."""
        budget = envflags.get("RIPTIDE_HBM_BUDGET")
        if not budget or self.mesh is not None:
            return None
        model = self._hbm_model(plan)
        if model is None:
            return None
        limit = max(1, model.max_batch(int(budget)))
        return limit if limit < D else None

    def _loader_bytes(self, nsamp, tsamp):
        """Device bytes one loader thread's de-reddening of an
        ``nsamp``-sample series holds at its peak, from a walk of
        :func:`~riptide_tpu_torch.ops.running_median.fast_running_median_torch`
        on the meta device (cached per shape). While chunk i is
        searched, the loaders de-redden chunk i + 1 on the card, so
        their working sets sit under the same high-water mark."""
        cache = self.__dict__.setdefault("_loader_cache", {})
        key = (int(nsamp), round(float(tsamp), 12))
        if key not in cache:
            import torch

            from ..ops.running_median import fast_running_median_torch
            from ..search.engine import walk_peak

            width = int(round(self.deredden_params["rmed_width"] / tsamp))
            minpts = int(self.deredden_params["rmed_minpts"])
            cache[key] = walk_peak(lambda: fast_running_median_torch(
                torch.empty(int(nsamp), device="meta"), width, minpts))
        return cache[key]

    def chunk_hbm_block(self, items):
        """Predicted-vs-measured peak device bytes of one chunk's
        searches, as the journal's per-chunk ``hbm`` block; None while
        seeding is off. Predictions sum over the chunk's work items at
        their seeded (post-split) batch sizes; on the card they add one
        de-reddening working set (:meth:`_loader_bytes`) per loader
        thread that can run beside the search. The measured peak
        (``engine.device_peak_bytes``) is a process-lifetime high-water
        mark, so ``actual`` goes only to a chunk that raised it: a
        later chunk under the mark carries no calibration signal."""
        budget = envflags.get("RIPTIDE_HBM_BUDGET")
        if not budget or self.mesh is not None:
            return None
        predicted = 0
        for item in items:
            batch, plan = item[1], item[3]
            model = self._hbm_model(plan)
            if model is None:
                return None
            D = batch.shape[0]
            predicted += model.predict(min(D, model.max_batch(int(budget))))
        if items and self.device.type == "cuda" \
                and self.deredden_params.get("rmed_width"):
            members, batch = items[0][0], items[0][1]
            predicted += min(self.io_threads, len(members)) \
                * self._loader_bytes(batch.shape[1], members[0].tsamp)
        from ..obs.schema import hbm_block
        from ..search.engine import device_peak_bytes

        actual = device_peak_bytes(self.device)
        prev = getattr(self, "_hbm_peak_seen", None)
        if actual is not None:
            self._hbm_peak_seen = actual
            if prev is not None and actual <= prev:
                actual = None
        return hbm_block(predicted, actual, int(budget))

    def _queue_range(self, conf, members, batch, plan, shipped):
        """Queue one (search range x chunk) device search; returns a
        zero-argument collector producing the chunk's Peak list."""
        dms = [float(ts.metadata["dm"] or 0.0) for ts in members]
        dms += [0.0] * (batch.shape[0] - len(members))
        tobs = batch.shape[1] * members[0].tsamp
        fp_kwargs = conf.get("find_peaks", {})
        nreal = len(members)
        if self.mesh is not None:
            from ..parallel import (collect_search_sharded,
                                    queue_search_sharded)

            # Queue-ahead like the unsharded path: the whole sharded
            # device side (decode, stages, peak programs) is queued
            # without syncing; the collector pays the one round trip.
            handle = queue_search_sharded(
                plan, batch, tobs=tobs, mesh=self.mesh, shipped=shipped,
                **fp_kwargs
            )

            def collect_mesh():
                peaks_per_trial, _ = collect_search_sharded(handle, dms)
                return [p for d in range(nreal) for p in peaks_per_trial[d]]

            return collect_mesh
        args = (plan, batch, dms, tobs, fp_kwargs, nreal)
        limit = self._seed_batch_limit(plan, batch.shape[0])
        if limit is not None:
            # The model says this batch exceeds the budget: split it
            # now at the largest size predicted to fit, instead of a
            # queue + OOM + halving cycle. The slices prepare their own
            # wire, and a real OOM inside a slice still bisects: the
            # model seeds, the bisection insures.
            get_metrics().add("oom_predicted")
            incidents.emit("oom_predicted", batch=batch.shape[0],
                           limit=int(limit))
            log.info("peak-memory model caps the %d-trial batch at %d "
                     "trials per search", batch.shape[0], limit)
            return lambda: self._collect_seeded(*args, limit)
        try:
            self._maybe_oom(batch.shape[0])
            handle = queue_search_batch(
                plan, batch, tobs=tobs, shipped=shipped, **fp_kwargs
            )
        except Exception as exc:
            if not is_oom_error(exc):
                raise
            # Queue-time OOM: fall back to a bisecting collector. The
            # traceback goes, so the failed queue's tensors are freed.
            err = exc.with_traceback(None)
            return lambda: self._collect_bisected(*args, err)

        def collect():
            nonlocal handle
            try:
                peaks_per_trial, _ = collect_search_batch(handle, dms)
            except Exception as exc:
                if not is_oom_error(exc):
                    raise
                err = exc.with_traceback(None)
            else:
                # Padded trials (zero data) produce no peaks; slice to
                # the real ones.
                return [p for d in range(nreal) for p in peaks_per_trial[d]]
            finally:
                handle = None
            # The failed batch's tensors are unreferenced by now.
            return self._collect_bisected(*args, err)

        return collect

    def _collect_seeded(self, plan, batch, dms, tobs, fp_kwargs, nreal,
                        limit):
        """Collector of a model-capped batch: search the DM batch in
        ``limit``-trial slices, one after another as the bisection path
        does. A real OOM inside a slice still bisects."""
        dms = np.asarray(dms, dtype=float)
        D = batch.shape[0]
        ppt = []
        for lo in range(0, D, limit):
            ppt += self._search_slice(plan, batch, dms, tobs, fp_kwargs,
                                      lo, min(lo + limit, D))
        return [p for d in range(nreal) for p in ppt[d]]

    # -- OOM-aware adaptive bisection ---------------------------------------

    def _maybe_oom(self, batch_size):
        """Fault-injection hook: a configured ``oom`` directive raises a
        simulated out-of-memory error here, before the batch is queued,
        so the bisection path runs on the CPU too."""
        if self.faults is not None:
            self.faults.maybe_oom(batch_size)

    def _collect_bisected(self, plan, batch, dms, tobs, fp_kwargs, nreal,
                          err):
        """Recovery after device memory exhaustion on a full (search
        range x chunk) batch: split the DM batch in half and search the
        halves synchronously, recursing down to ``oom_floor`` trials.
        Each split is counted as ``oom_bisections``. The halves prepare
        their own wire; per-trial quantisation makes the sub-batch S/N
        (hence the peaks) identical to an unthrottled run's."""
        D = batch.shape[0]
        if D <= self.oom_floor:
            raise err
        get_metrics().add("oom_bisections")
        incidents.emit("oom_bisection", batch=D, halves=[(D + 1) // 2,
                                                         D - (D + 1) // 2])
        log.warning(
            "device OOM on a %d-trial batch (%s); bisecting into %d + %d",
            D, err, (D + 1) // 2, D - (D + 1) // 2,
        )
        dms = np.asarray(dms, dtype=float)
        mid = (D + 1) // 2
        ppt = (
            self._search_slice(plan, batch, dms, tobs, fp_kwargs, 0, mid)
            + self._search_slice(plan, batch, dms, tobs, fp_kwargs, mid, D)
        )
        return [p for d in range(nreal) for p in ppt[d]]

    def _search_slice(self, plan, batch, dms, tobs, fp_kwargs, lo, hi):
        """Search DM trials [lo, hi) as one device batch, bisecting
        recursively on further OOM; returns per-trial peak lists."""
        D = hi - lo
        try:
            self._maybe_oom(D)
            ppt, _ = run_search_batch(
                plan, batch[lo:hi], tobs=tobs, dms=dms[lo:hi],
                device=self.device, **fp_kwargs
            )
            return list(ppt)
        except Exception as exc:
            if not is_oom_error(exc) or D <= self.oom_floor:
                raise
            err = exc.with_traceback(None)
        get_metrics().add("oom_bisections")
        mid = lo + (D + 1) // 2
        incidents.emit("oom_bisection", batch=D, halves=[mid - lo, hi - mid])
        log.warning(
            "device OOM on a %d-trial sub-batch (%s); bisecting into "
            "%d + %d", D, err, mid - lo, hi - mid,
        )
        return (
            self._search_slice(plan, batch, dms, tobs, fp_kwargs, lo, mid)
            + self._search_slice(plan, batch, dms, tobs, fp_kwargs, mid, hi)
        )
