"""
rseek: FFA-search a single dedispersed time series and print a table of
significant peaks. Same CLI surface and defaults as the reference's
``rseek`` console script (riptide/apps/rseek.py); the search runs on
the card unless ``--device cpu`` is given. Run as ``python -m
riptide_tpu_torch.apps.rseek``. Supports the survey layer's journaling
(``--journal``/``--resume``), fault injection (``--fault-inject``),
retry budget (``--deadline-s``) and span trace (``--trace``), treating
the whole search as a single work unit.

The table is printed without pandas (a
:class:`~riptide_tpu_torch.table.Table`, whose text is pandas'
``to_string`` of the same rows). Not ported yet: the JAX package's
service client (``--submit``, ``--tenant``, ``--priority``).
"""
import argparse
import logging
import time

import numpy as np

from riptide_tpu_torch.table import Table

log = logging.getLogger("riptide_tpu_torch.rseek")

# The printed columns and their formats (the reference's formatters).
COLUMNS = ["period", "freq", "width", "ducy", "dm", "snr"]
FORMATTERS = {
    "period": "  {:.9f}".format,
    "freq": "  {:.9f}".format,
    "ducy": lambda x: "  {:#.2f}%".format(100 * x),
    "dm": "  {:.2f}".format,
    "snr": "  {:.1f}".format,
}


def _help_formatter(prog):
    return argparse.ArgumentDefaultsHelpFormatter(prog, max_help_position=16)


def get_parser():
    from riptide_tpu_torch import __version__

    parser = argparse.ArgumentParser(
        formatter_class=_help_formatter,
        description=(
            "Run an FFA periodogram search on one dedispersed time series "
            "and print every significant peak's parameters. Nearby peaks "
            "from different width trials are merged into one line per "
            "period; harmonics are left in the output."
        ),
    )
    parser.add_argument(
        "-f", "--format", type=str, choices=("presto", "sigproc"), required=True,
        help="On-disk format of the dedispersed series to load",
    )
    parser.add_argument("--Pmin", type=float, default=1.0,
                        help="Shortest trial period, in seconds")
    parser.add_argument("--Pmax", type=float, default=10.0,
                        help="Longest trial period, in seconds")
    parser.add_argument("--bmin", type=int, default=240,
                        help="Lower bound on the phase-bin count of a trial folding")
    parser.add_argument("--bmax", type=int, default=260,
                        help="Upper bound on the phase-bin count of a trial folding")
    parser.add_argument("--smin", type=float, default=7.0,
                        help="Drop peaks whose S/N falls below this value")
    parser.add_argument(
        "--wtsp", type=float, default=1.5,
        help="Ratio between one trial pulse width and the next in the ladder",
    )
    parser.add_argument(
        "--rmed_width", type=float, default=4.0,
        help="Running-median detrending window length, in seconds",
    )
    parser.add_argument(
        "--rmed_minpts", type=float, default=101,
        help="Smallest number of downsampled points the running-median "
        "window may span (smaller runs faster at some accuracy cost)",
    )
    parser.add_argument(
        "--clrad", type=float, default=0.2,
        help="Radius (in units of 1/Tobs) for merging peaks of nearly equal "
        "frequency; only the brightest peak of each group is printed",
    )
    parser.add_argument(
        "--journal", type=str, default=None,
        help="Journal directory: record the completed search (peaks + "
        "metrics) so a later --resume run can replay it",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="Replay the peaks recorded in --journal instead of searching, "
        "when the journal already holds this input's completed search",
    )
    parser.add_argument(
        "--fault-inject", type=str, default=None,
        help="Fault-injection spec for robustness testing: raise/stall/"
        "abort directives on chunk 0, e.g. 'raise:0' (see "
        "riptide_tpu_torch.survey.faults); the search retries with backoff",
    )
    parser.add_argument(
        "--deadline-s", type=float, default=None,
        help="Total wall-clock budget (seconds) for the search's retry "
        "loop: attempts plus backoff never exceed it, so a persistently "
        "failing search errors out instead of backing off forever",
    )
    parser.add_argument(
        "--trace", action="store_true",
        help="Record host-side phase spans (prep/wire/dispatch/collect) "
        "and write a Perfetto-loadable Chrome trace-event JSON next to "
        "--journal (trace.json), or next to the input file "
        "(<input>.trace.json) when not journaling",
    )
    parser.add_argument(
        "--profile-dir", type=str, default=None,
        help="Capture a torch.profiler trace of the search into this "
        "directory (trace.json, a kernel-level timeline viewable in "
        "Perfetto)",
    )
    parser.add_argument(
        "--plan-stats", action="store_true",
        help="Print the search plan's container-occupancy accounting "
        "(live vs padded row*lane work per bucket, row-pack pairing, "
        "and the padded-work reduction vs the legacy layout) as JSON "
        "and exit without searching",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device of the de-reddening and the search: 'cuda' (the "
        "card) or 'cpu' (the plain PyTorch versions)",
    )
    parser.add_argument("fname", type=str,
                        help="Path of the time series file to search")
    parser.add_argument("--version", action="version", version=__version__)
    return parser


def _search_peaks(args, ts):
    """The rseek work unit: ffa_search + find_peaks on the loaded
    series. Returns the raw Peak list (possibly empty)."""
    from riptide_tpu_torch import ffa_search
    from riptide_tpu_torch.peak_detection import find_peaks

    _, pgram = ffa_search(
        ts,
        period_min=args.Pmin,
        period_max=args.Pmax,
        bins_min=args.bmin,
        bins_max=args.bmax,
        rmed_width=args.rmed_width,
        rmed_minpts=args.rmed_minpts,
        wtsp=args.wtsp,
        fpmin=1,
        ducy_max=0.3,
        device=args.device,
    )
    peaks, _ = find_peaks(pgram, smin=args.smin, clrad=args.clrad)
    return peaks


def _search_with_survey_hooks(args, ts):
    """Run the search under the survey machinery: optional journal
    replay (--resume), retry/backoff with fault injection, and a journal
    record of the completed unit."""
    import os

    from riptide_tpu_torch.utils import envflags, fsio
    from riptide_tpu_torch.survey import incidents
    from riptide_tpu_torch.survey.faults import FaultPlan
    from riptide_tpu_torch.survey.journal import SurveyJournal
    from riptide_tpu_torch.survey.metrics import get_metrics
    from riptide_tpu_torch.survey.scheduler import (
        RetryPolicy, run_with_retry, stop_if_sticky, survey_identity,
    )

    if args.resume and not args.journal:
        raise ValueError("--resume requires --journal")
    journal = SurveyJournal(args.journal) if args.journal else None
    sid = survey_identity(
        [args.fname],
        {k: getattr(args, k) for k in
         ("Pmin", "Pmax", "bmin", "bmax", "smin", "wtsp",
          "rmed_width", "rmed_minpts", "clrad")},
    )
    faults = FaultPlan.parse(args.fault_inject
                             or envflags.get("RIPTIDE_FAULT_INJECT"))
    metrics = get_metrics()
    # Journaled searches sink incidents (quarantine, OOM bisection,
    # watchdog timeout, storage recovery) into the journal for the
    # run's duration, like the survey scheduler does per survey — the
    # sink is installed BEFORE write_header so the crash-recovery pass
    # (torn-tail truncation) journals what it repaired. Storage fault
    # directives fire through the fsio hook for the same window.
    prev_sink = None
    prev_hook = fsio.set_storage_faults(faults.storage_op)
    if journal is not None:
        incidents.clear_last()
        prev_sink = incidents.set_sink(journal.record_incident)
    try:
        if journal is not None:
            journal.write_header(sid, 1)
            if args.resume:
                done = journal.completed_chunks()
                if 0 in done and done[0][0].get("files") == \
                        [os.path.basename(args.fname)]:
                    log.info("resuming: peaks replayed from journal "
                             f"{args.journal!r}")
                    get_metrics().add("chunks_skipped")
                    return done[0][1]

        # nan_inject directives corrupt the loaded samples BEFORE the
        # data-quality scan inside ffa_search, exercising the masking
        # path.
        faults.nan_inject(0, ts.data)
        retry = RetryPolicy(deadline_s=getattr(args, "deadline_s", None))
        # Phase attribution via timer deltas: the engine records prep/
        # wire/device seconds while the search runs; the deltas across
        # this one work unit feed the journal's `timing` block (the
        # same schema the survey scheduler journals per chunk).
        prep0 = metrics.timer_total("prep_s")
        wire0 = metrics.timer_total("wire_s")
        dev0 = metrics.timer_total("device_s")
        wb0 = metrics.counter("wire_bytes")
        t0 = time.perf_counter()
        peaks, attempts = run_with_retry(
            lambda: _search_peaks(args, ts), 0, retry, faults, metrics,
            # A CUDA error that leaves the context unusable ends the
            # search: a retry in this process would fail again.
            on_retry=lambda err: stop_if_sticky(0, err, args.device),
        )
        chunk_s = time.perf_counter() - t0
        metrics.add("chunks_done")
        metrics.observe("chunk_s", chunk_s)
        if journal is not None:
            from riptide_tpu_torch.obs import ledger
            from riptide_tpu_torch.obs.report import run_decomposition_from_chunks
            from riptide_tpu_torch.obs.schema import chunk_timing

            device_s = metrics.timer_total("device_s") - dev0
            timing = chunk_timing(
                chunk_s,
                prep_s=metrics.timer_total("prep_s") - prep0,
                wire_s=metrics.timer_total("wire_s") - wire0,
                device_s=device_s,
                # The blocking device wait happens inside the search
                # call's collect; attribute it there rather than to the
                # host remainder.
                collect_s=device_s,
                wire_bytes=int(metrics.counter("wire_bytes") - wb0),
            )
            try:
                journal.heartbeat(0)
            except OSError as err:
                # Observability writes are never fatal (the survey
                # scheduler applies the same guard per chunk).
                log.warning("heartbeat append failed: %s", err)
                metrics.add("obs_write_errors")
                incidents.emit("obs_write_failed", op="heartbeat",
                               error=str(err))
            journal.record_chunk(
                0, [args.fname], [float(ts.metadata["dm"] or 0.0)], peaks,
                timings=timing, attempts=attempts,
            )
            journal.record_metrics(metrics.summary())
            # One perf-ledger row per journaled search (no-op unless
            # RIPTIDE_LEDGER is set) — same derivation as the
            # scheduler's.
            run_dec, nchunks, bound_counts = \
                run_decomposition_from_chunks([timing])
            ledger.maybe_append("rseek", run_dec, nchunks=nchunks,
                                bound_counts=bound_counts,
                                extra={"survey_id": sid})
        return peaks
    finally:
        fsio.set_storage_faults(prev_hook)
        if journal is not None:
            incidents.set_sink(prev_sink)


def run_program(args):
    """
    Run rseek; returns a :class:`~riptide_tpu_torch.table.Table` of
    detected peak parameters (columns period/freq/width/ducy/snr/dm), or
    None if nothing significant was found.
    """
    from riptide_tpu_torch import TimeSeries
    from riptide_tpu_torch.clustering import cluster1d
    from riptide_tpu_torch.obs import prom, trace
    from riptide_tpu_torch.quality import QuarantinedSeries
    from riptide_tpu_torch.timing import maybe_trace

    if args.trace and not trace.enabled():
        trace.enable()
    prom.maybe_serve()

    logging.basicConfig(
        level="DEBUG",
        format="%(asctime)s %(filename)18s:%(lineno)-4s %(levelname)-8s %(message)s",
    )

    loaders = {"sigproc": TimeSeries.from_sigproc, "presto": TimeSeries.from_presto_inf}
    ts = loaders[args.format](args.fname)

    if args.plan_stats:
        # Occupancy accounting only: build the same plan the search
        # would (detrending does not change the sample count) and emit
        # the machine-readable live-vs-padded layout report.
        import json

        from riptide_tpu_torch.ffautils import generate_width_trials
        from riptide_tpu_torch.search.plan import periodogram_plan, plan_occupancy

        widths = generate_width_trials(args.bmin, ducy_max=0.3,
                                       wtsp=args.wtsp)
        plan = periodogram_plan(
            ts.nsamp, ts.tsamp, tuple(int(w) for w in widths),
            float(args.Pmin), float(args.Pmax), int(args.bmin),
            int(args.bmax),
        )
        print(json.dumps(plan_occupancy(plan), indent=2))
        return None

    log.debug(
        f"Searching period range [{args.Pmin}, {args.Pmax}] seconds "
        f"with {args.bmin} to {args.bmax} phase bins"
    )
    try:
        with maybe_trace(args.profile_dir):
            peaks = _search_with_survey_hooks(args, ts)
    except QuarantinedSeries as err:
        # Degraded beyond searchability: report, don't crash.
        log.error("input quarantined by the data-quality scan: %s",
                  err.report.to_dict())
        print(f"Input quarantined: {err.report.describe()}")
        return None
    # Export whenever the tracer is live — via --trace OR RIPTIDE_TRACE=1
    # — so environment-enabled runs don't record spans only to drop them.
    if trace.enabled():
        import os

        from riptide_tpu_torch.obs.chrome import (
            export_run_trace, write_chrome_trace,
        )

        tracer = trace.get_tracer()
        if args.journal:
            # Journal-relative export: a resumed run's fresh tracer
            # rotates the prior attempt's trace.json to trace.json.1
            # instead of overwriting it.
            trace_path = os.path.join(args.journal, "trace.json")
            export_run_trace(args.journal, tracer=tracer)
        else:
            trace_path = args.fname + ".trace.json"
            if tracer is not None:
                try:
                    write_chrome_trace(trace_path, tracer)
                except OSError as err:
                    # Observability writes are never fatal: a full disk
                    # must not eat the completed search's results.
                    log.warning("trace write to %r failed: %s",
                                trace_path, err)
                    from riptide_tpu_torch.obs.ledger import _obs_write_failed

                    _obs_write_failed("trace", trace_path, err)
        log.info(f"host span trace written to {trace_path!r} "
                 "(load in Perfetto or chrome://tracing)")
    prom.maybe_write_textfile()
    if not peaks:
        print(f"No peaks found above S/N = {args.smin:.2f}")
        return None

    # Group peaks across width trials: keep the brightest per frequency
    # cluster.
    freqs = np.asarray([p.freq for p in peaks])
    clusters = cluster1d(freqs, r=args.clrad / ts.length)
    peaks = [max((peaks[i] for i in idx), key=lambda p: p.snr) for idx in clusters]
    peaks = sorted(peaks, key=lambda p: p.snr, reverse=True)

    table = Table.from_records(
        {k: v for k, v in p._asdict().items() if k not in ("iw", "ip")}
        for p in peaks)
    print(table.to_string(columns=COLUMNS, formatters=FORMATTERS))
    return table


def main():
    """Console entry point for 'rseek'."""
    run_program(get_parser().parse_args())


if __name__ == "__main__":
    main()
