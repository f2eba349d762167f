"""
Multi-process survey execution: the port of the JAX package's
``parallel/multihost.py`` over ``torch.distributed``.

DM trials are embarrassingly parallel, so the multi-process layout is
one DM shard per process: each process searches its local (D_local, N)
batch on its own card (:func:`~.distributed.local_device`) through the
engine's ``run_search_batch`` (K1), and only the resulting Peak lists —
KB-scale, the same tiny-results contract as the reference's worker pool
(riptide/pipeline/worker_pool.py:47-71) — cross process boundaries, via
one pair of host all-gathers over the process group
(:mod:`.distributed`, gloo).

This is the counterpart of the reference's tested ``processes: 2``
parallel pipeline mode (riptide/tests/test_pipeline.py:14-31): where the
reference forks local worker processes, a multi-process run starts one
process per card (or several on one card) with the coordinator wiring of
:func:`~.distributed.init_distributed`.

Peer liveness: every collective here goes through the bounded-wait
wrappers of :mod:`riptide_tpu_torch.survey.liveness`, so a dead or
wedged peer raises :class:`~riptide_tpu_torch.survey.liveness.PeerTimeout`
instead of deadlocking every process forever. On a peer loss the
survivors *degrade to local-only mode*: collectives are skipped for the
rest of the run, each process finishes (and journals) its own shards,
the journal-writer role fails over from process 0 to the lowest alive
process (per the heartbeat sidecars), and the lost shard's unfinished
chunks can be re-enqueued from the journal
(:meth:`PeerLivenessMonitor.unfinished_chunks`).
"""
import logging

import numpy as np

from ..obs.trace import span
from ..peak_detection import PEAK_FIELDS, PEAK_INT_FIELDS, Peak
from ..survey import incidents
from ..survey.liveness import PeerTimeout, bounded_allgather
from ..survey.metrics import get_metrics
from . import distributed

log = logging.getLogger("riptide_tpu_torch.multihost")

__all__ = ["gather_peaks", "run_search_multihost", "is_degraded",
           "reset_degraded"]

# Once a peer is lost the process group cannot be trusted: any further
# collective would hang on the dead peer (or desynchronise the
# survivors). The flag is process-wide and sticky for the run.
_degraded = False


def is_degraded():
    """True once this process has dropped to local-only mode after a
    peer loss (collectives are skipped for the rest of the run)."""
    return _degraded


def reset_degraded():
    """Clear local-only mode (tests only — a real run cannot rejoin a
    process group it stopped participating in)."""
    global _degraded
    _degraded = False


def _degrade(reason):
    global _degraded
    if not _degraded:
        log.error(
            "peer loss detected (%s): degrading to local-only mode — "
            "surviving processes finish their own shards and skip all "
            "further collectives", reason,
        )
    _degraded = True
    get_metrics().add("peer_losses")
    incidents.emit("peer_loss", reason=str(reason),
                   process=int(distributed.process_index()))


# Peak is a flat record of 8 numeric fields; encode/decode as float64
# in the canonical PEAK_FIELDS order (shared with the survey journal).
_FIELDS = PEAK_FIELDS
_INT_FIELDS = PEAK_INT_FIELDS


def _encode(peaks):
    arr = np.zeros((len(peaks), len(_FIELDS)), np.float64)
    for i, p in enumerate(peaks):
        arr[i] = [float(getattr(p, f)) for f in _FIELDS]
    return arr


def _decode(arr):
    out = []
    for row in arr:
        kw = {
            f: (int(v) if f in _INT_FIELDS else float(v))
            for f, v in zip(_FIELDS, row)
        }
        out.append(Peak(**kw))
    return out


def _allgather(arr, timeout_s, what):
    """Single chokepoint for the gather collectives (monkeypatchable in
    tests); delegates to the liveness layer's bounded wrapper."""
    return bounded_allgather(arr, timeout_s=timeout_s, what=what)


def gather_peaks(local_peaks, faults=None, chunk_id=0, timeout_s=None,
                 monitor=None):
    """All-gather Peak lists across every process of the process group;
    every process returns the identical concatenated list (process
    order, then local order). Single-process: a plain copy.

    Every collective runs under a bounded wait of ``timeout_s`` seconds
    (None = unbounded). When one times out — or an injected
    ``peer_loss`` fault fires — the process *degrades to local-only
    mode*: ``peer_losses`` is counted, the flag is sticky for the rest
    of the run (subsequent gathers skip collectives entirely), and the
    LOCAL peak list is returned so this process can still finish and
    journal its own shard.
    """
    local_peaks = list(local_peaks)
    if distributed.process_count() == 1 or _degraded:
        return local_peaks

    try:
        if faults is not None:
            faults.before_gather(chunk_id)
        with get_metrics().timer("gather_s"), \
                span("gather", chunk=chunk_id):
            arr = _encode(local_peaks)
            counts = _allgather(
                np.asarray([arr.shape[0]], np.int64), timeout_s,
                f"peak-count allgather (chunk {chunk_id})",
            ).reshape(-1)
            mx = max(int(counts.max()), 1)
            padded = np.zeros((mx, len(_FIELDS)), np.float64)
            padded[: arr.shape[0]] = arr
            gathered = _allgather(
                padded, timeout_s, f"peak allgather (chunk {chunk_id})",
            )
            out = []
            for cnt, block in zip(counts, gathered):
                out.extend(_decode(block[: int(cnt)]))
    except PeerTimeout as err:
        _degrade(err)
        if monitor is not None:
            monitor.peer_ages()  # refresh the heartbeat_age_s gauge
        return local_peaks
    return out


def run_search_multihost(plan, batch_local, tobs, dms_local=None,
                         journal=None, chunk_id=0, faults=None,
                         gather_timeout_s=None, monitor=None, device=None,
                         **peak_kwargs):
    """
    Search this process's local DM-trial batch and exchange results:
    returns (peaks, polycos_local) where ``peaks`` is the SAME global
    flat Peak list on every process (sorted by decreasing S/N) and
    ``polycos_local`` are this process's per-trial threshold
    polynomials. The search runs on ``device``, by default this
    process's card (:func:`~.distributed.local_device`); pass
    ``device="cpu"`` for the plain PyTorch versions.

    When a :class:`~riptide_tpu_torch.survey.journal.SurveyJournal` is
    given, exactly one process — the *journal writer* — records the
    gathered result as chunk ``chunk_id`` together with a metrics
    snapshot, so a shared journal directory sees a single writer. The
    writer is process 0; with a
    :class:`~riptide_tpu_torch.survey.liveness.PeerLivenessMonitor` the
    role fails over to the lowest alive process when heartbeats go stale
    (so losing process 0 does not stop journaling).

    The peak exchange runs under ``gather_timeout_s``-bounded
    collectives; a peer loss degrades this process to local-only mode
    (see :func:`gather_peaks`): the returned ``peaks`` then cover only
    the local shard, which is exactly what the surviving process must
    finish and journal. A survivor can then re-enqueue the lost shard's
    unfinished chunks via ``monitor.unfinished_chunks``.
    """
    from ..search.engine import run_search_batch

    if monitor is not None:
        monitor.beat()
    D = np.asarray(batch_local).shape[0]
    if dms_local is None:
        dms_local = np.zeros(D)
    if device is None:
        device = distributed.local_device()
    peaks_per_trial, polycos = run_search_batch(
        plan, batch_local, tobs=tobs, dms=dms_local, device=device,
        **peak_kwargs
    )
    flat = [p for trial in peaks_per_trial for p in trial]
    peaks = sorted(
        gather_peaks(flat, faults=faults, chunk_id=chunk_id,
                     timeout_s=gather_timeout_s, monitor=monitor),
        key=lambda p: p.snr, reverse=True,
    )
    index, count = distributed.process_index(), distributed.process_count()
    writer = 0
    extra = None
    if _degraded:
        # A degraded record holds only THIS process's shard: mark it so
        # the journal is honest about its scope. With more than two
        # processes the OTHER survivors' peaks for this chunk id are
        # not merged (no collectives in degraded mode) — each survivor
        # must finish and account for its own shards.
        extra = {"scope": "local", "process": index}
        if count > 2:
            log.warning(
                "degraded chunk %d record covers only process %d's "
                "local shard; peaks searched by other surviving "
                "processes are NOT merged into this journal record",
                chunk_id, index,
            )
        if monitor is not None:
            writer = monitor.journal_writer()
    if journal is not None and index == writer:
        metrics = get_metrics()
        journal.record_chunk(
            chunk_id, files=[], dms=[float(d) for d in np.ravel(dms_local)],
            peaks=peaks, extra=extra,
        )
        journal.record_metrics(metrics.summary())
        metrics.add("chunks_done")
    if journal is not None:
        # EVERY process (not just the journal writer) exports its own
        # host-span lane file next to the journal; process 0 merges the
        # lanes present so far into trace.json. Rewritten atomically
        # after each chunk — like a heartbeat, the trace survives a
        # kill. No-op while tracing is disabled.
        from ..obs.chrome import export_run_trace

        export_run_trace(journal.directory, process_index=index,
                         process_count=count)
        # ... and its own fleet snapshot sidecar (fleet_<p>.json): the
        # per-process status any reader — the /status fleet block,
        # rreport, rtop --fleet, rwatch — merges into the one fleet
        # view of the run. Never fatal, like every obs write.
        from ..obs import fleet

        if fleet.enabled():
            # This layer is called once per chunk with sequential ids,
            # so chunk_id + 1 is the chunks THIS process has searched
            # (the writer-only chunks_done counter undercounts on
            # non-writer peers). `running` derives from the journal
            # header's total where one exists: the final chunk's
            # snapshot must read running=false, or every COMPLETED
            # multi-process run would look stale/hung to the fleet view
            # two minutes later. The whole publication is guarded like
            # the scheduler's _fleet_safe: snapshot assembly (incl.
            # the header read off shared storage) is observability and
            # must never kill the survey it describes.
            try:
                done = int(chunk_id) + 1
                hdr = journal._header() or {}
                total = hdr.get("chunks_total")
                fleet.write_snapshot(journal.directory, fleet.snapshot(
                    index,
                    status={
                        "survey_id": hdr.get("survey_id"),
                        "running": (True if total is None
                                    else done < int(total)),
                        "chunks_done": done,
                        "last_incident": incidents.last_incident(),
                    },
                    metrics=get_metrics(),
                ))
            except Exception as err:
                log.warning("fleet snapshot failed: %s", err)
    return peaks, polycos
