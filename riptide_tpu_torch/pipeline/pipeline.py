"""
End-to-end multi-DM FFA search pipeline (the ``rffa`` application).

Stage structure mirrors the reference (riptide/pipeline/pipeline.py:56-394):
prepare -> search -> cluster_peaks -> flag_harmonics ->
apply_candidate_filters -> build_candidates -> save_products, driven by a
validated config (a dict, or a YAML file through
:meth:`Pipeline.from_yaml_config`). The search stage is where the
architecture diverges: instead of a multiprocessing pool of single-CPU
workers, DM trials are batched onto the card through
:class:`riptide_tpu_torch.pipeline.batcher.BatchSearcher`; everything
downstream of the periodogram — peak clustering, harmonic flagging,
candidate building — operates on small host-side peak lists exactly as
in the reference. With a journal directory the search stage runs
through the checkpointed survey scheduler
(:class:`riptide_tpu_torch.survey.scheduler.SurveyScheduler`: resume,
retries, the watchdog and circuit breaker, result integrity), and
``trace=True`` exports a Chrome trace of the run's host spans. The port
of the JAX package's pipeline, without its device mesh.

The products (peaks.csv, clusters.csv, candidates.csv and one
candidate_NNNN.json each) are written without pandas: the tables are
:class:`~riptide_tpu_torch.table.Table` objects, with the bytes pandas
would write. PyYAML is imported only to read a config file, and
matplotlib only to plot.
"""
import argparse
import itertools
import json
import logging
import os
import traceback
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import __version__
from ..candidate import Candidate
from ..clustering import cluster1d
from ..obs import chrome, prom
from ..obs.trace import enable as trace_enable
from ..obs.trace import enabled as trace_enabled
from ..obs.trace import span
from ..serialization import save_json
from ..survey.faults import FaultPlan
from ..table import Table
from ..timing import maybe_trace, timing
from ..utils import envflags
from ..utils.device import resolve_device
from .batcher import BatchSearcher
from .config_validation import validate_pipeline_config, validate_ranges
from .dmiter import DMIterator
from .harmonic_testing import htest, dm_distance_matrix
from .peak_cluster import PeakCluster, clusters_to_dataframe

log = logging.getLogger("riptide_tpu_torch.pipeline")

__all__ = ["Pipeline", "CandidateWriter", "get_parser", "run_program", "main"]


class CandidateWriter:
    """Writes one (rank, Candidate) to JSON (+ optional PNG); used with a
    multiprocessing pool so plot rendering parallelises across cores."""

    def __init__(self, outdir, plot=False):
        self.outdir = os.path.realpath(outdir)
        self.plot = plot

    def __call__(self, arg):
        rank, cand = arg
        fname = os.path.join(self.outdir, f"candidate_{rank:04d}.json")
        log.debug(f"Saving to {fname}: {cand}")
        save_json(fname, cand)
        if self.plot:
            fname = os.path.join(self.outdir, f"candidate_{rank:04d}.png")
            log.debug(f"Saving plot to {fname}")
            cand.savefig(fname)


def render_spawned(writer, arglist, processes):
    """Render candidate JSON+PNGs concurrently in spawned CPU-only
    worker processes (the parallel-plotting counterpart of the
    reference's fork pool, riptide/pipeline/pipeline.py:370-379). The
    environment is patched for the duration of the pool — spawned
    interpreters read it at startup, so they come up with no CUDA
    device visible and the non-interactive matplotlib backend; any
    failure falls back to sequential rendering."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    patched = {"CUDA_VISIBLE_DEVICES": "", "MPLBACKEND": "Agg"}
    saved = {k: os.environ.get(k) for k in patched}
    os.environ.update(patched)
    try:
        with ProcessPoolExecutor(
            max_workers=int(processes), mp_context=mp.get_context("spawn"),
        ) as ex:
            list(ex.map(writer, arglist, chunksize=4))
    except Exception as err:  # pragma: no cover - defensive
        log.warning(f"spawned plot rendering failed ({err}); "
                    "rendering sequentially")
        for arg in arglist:
            writer(arg)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Pipeline:
    """
    Top-level multi-DM-trial search.

    Parameters
    ----------
    config : dict
        Configuration dictionary (see
        riptide_tpu_torch/pipeline/config/example.yaml). Format is
        validated immediately; value checks against the data happen in
        prepare(). The ``liveness`` section configures the watchdog,
        the circuit breaker and the retry budget of journaled runs.
    device : str, torch.device or None
        Where the de-reddening and the search run: None means the card
        (``"cuda"``), and a host without one raises; ``"cpu"`` runs the
        plain PyTorch versions.
    trace_dir : str or None
        Capture a ``torch.profiler`` trace of the search stage into
        this directory.
    journal : str or None
        Directory for the survey journal. When set, the search stage
        runs through the checkpointed
        :class:`riptide_tpu_torch.survey.scheduler.SurveyScheduler`:
        completed chunks are journaled (fsync'd) as they finish, device
        dispatch retries with exponential backoff, and ``resume=True``
        replays journaled chunks instead of re-searching them. The JAX
        package reads (and resumes) the same journal.
    resume : bool
        Resume from the journal (requires ``journal``).
    fault_spec : str or None
        Fault-injection spec (see :mod:`riptide_tpu_torch.survey.faults`);
        defaults to the ``RIPTIDE_FAULT_INJECT`` environment variable.
    trace : bool
        Record host-side phase spans (:mod:`riptide_tpu_torch.obs`) for
        the whole run and export a Perfetto-loadable Chrome trace next
        to the journal (or into the output directory). Equivalent to
        ``RIPTIDE_TRACE=1``; ``trace_dir`` remains the card's
        ``torch.profiler`` capture.
    """

    def __init__(self, config, device=None, trace_dir=None, journal=None,
                 resume=False, fault_spec=None, trace=False):
        self.config = validate_pipeline_config(config)
        self.device = resolve_device(device)
        self.trace_dir = trace_dir
        self.trace = bool(trace)
        self.journal_dir = journal
        self.resume = bool(resume)
        self.fault_spec = (fault_spec if fault_spec is not None
                           else envflags.get("RIPTIDE_FAULT_INJECT"))
        # ONE fault plan shared by the scheduler (raise/stall/abort/
        # corrupt/hang/straggle kinds) and the batch searcher
        # (nan_inject/oom kinds), so directive budgets are consumed
        # consistently. Parsing here also fails fast on a bad spec.
        self.faults = FaultPlan.parse(self.fault_spec)
        if self.resume and not self.journal_dir:
            raise ValueError("resume=True requires a journal directory")
        self.watchdog, self.breaker, self.retry = self._build_liveness()
        self.dmiter = None
        self.searcher = None
        self.peaks = []
        self.clusters = []
        self.clusters_filtered = []
        self.candidates = []

    def _build_liveness(self):
        """(watchdog, breaker, retry) from the optional ``liveness``
        config section. The layer is ON by default — an absent section
        gets the documented defaults, matching example.yaml — and ``liveness: {enabled: false}``
        returns (None, None, None), reverting the scheduler to its
        legacy retry-only behaviour."""
        liv = self.config.get("liveness") or {}
        if not liv.get("enabled", True):
            return None, None, None
        from ..survey.liveness import ChunkWatchdog
        from ..survey.scheduler import CircuitBreaker, RetryPolicy

        watchdog = ChunkWatchdog(
            k=liv.get("watchdog_k", 4.0),
            floor_s=liv.get("watchdog_floor_s", 5.0),
            cap_s=liv.get("watchdog_cap_s", 900.0),
            initial_s=liv.get("watchdog_initial_s"),
        )
        breaker = CircuitBreaker(
            failure_threshold=liv.get("breaker_threshold", 3),
            cooldown_s=liv.get("breaker_cooldown_s", 60.0),
        )
        retry = (RetryPolicy(deadline_s=liv["retry_deadline_s"])
                 if liv.get("retry_deadline_s") is not None else None)
        return watchdog, breaker, retry

    # -- config helpers -----------------------------------------------------

    def wmin(self):
        """Minimum pulse width searched across all ranges."""
        return min(
            rg["ffa_search"]["period_min"] / rg["ffa_search"]["bins_min"]
            for rg in self.config["ranges"]
        )

    def get_search_range(self, period):
        """Search-range config dict whose period span contains ``period``
        (used to pick candidate fold bins/subints)."""
        ranges = sorted(
            self.config["ranges"], key=lambda r: r["ffa_search"]["period_max"]
        )
        pmin_global = min(r["ffa_search"]["period_min"] for r in ranges)
        pmax_global = max(r["ffa_search"]["period_max"] for r in ranges)

        if period < pmin_global:
            log.warning(
                f"Given period={period:.9f} is shorter than the minimum search "
                f"period={pmin_global:.9f}; using the shortest-period range."
            )
            return dict(ranges[0])
        # Trials slightly above pmax_global legitimately occur (the cascade
        # searches a little past period_max).
        if period >= pmax_global:
            return dict(ranges[-1])
        for rg in ranges:
            if rg["ffa_search"]["period_min"] <= period < rg["ffa_search"]["period_max"]:
                return dict(rg)
        # Non-contiguous ranges (possible when a Pipeline is built from a
        # raw config dict — YAML configs are contiguity-checked) can leave
        # a period in a gap; fail loudly rather than returning None into
        # candidate building.
        raise ValueError(
            f"period={period:.9f} s falls in a gap between non-contiguous "
            f"search ranges; no range covers it"
        )

    # -- stages -------------------------------------------------------------

    @timing
    def prepare(self, files):
        """Inspect input files, select the minimal DM-trial subset, check
        the config against the data, and build the batch searcher."""
        log.info(f"Preparing pipeline; input files: {len(files)}")
        conf = self.config
        self.dmiter = DMIterator(
            files,
            conf["dmselect"]["min"],
            conf["dmselect"]["max"],
            dmsinb_max=conf["dmselect"]["dmsinb_max"],
            fmt=conf["data"]["format"],
            wmin=self.wmin(),
            fmin=conf["data"]["fmin"],
            fmax=conf["data"]["fmax"],
            nchans=conf["data"]["nchans"],
        )
        tsamp_max = self.dmiter.tsamp_max()
        log.info(f"Max sampling time = {tsamp_max:.6e} s; validating ranges")
        validate_ranges(conf["ranges"], tsamp_max)

        dq_conf = dict(conf.get("data_quality") or {})
        oom_floor = dq_conf.pop("oom_floor", 1)
        self.searcher = BatchSearcher(
            conf["dereddening"],
            conf["ranges"],
            fmt=conf["data"]["format"],
            io_threads=conf["processes"],
            batch_size=conf["processes"],
            dq=dq_conf,
            faults=self.faults,
            oom_floor=oom_floor,
            device=self.device,
            watchdog=self.watchdog,
        )
        log.info("Pipeline ready")

    @timing
    def search(self):
        """Search all selected DM trials in device-sized batches. The
        config's 'processes' value sets the DM batch size per device
        search (and the host loader thread count), not a worker process
        count. With a journal configured the chunk queue runs through
        the checkpointed survey scheduler (resume / retry / fault
        injection); otherwise through the batcher's overlapped
        stream."""
        log.info("Running search")
        batch = max(self.config["processes"], 1)
        chunks = [list(c) for c in
                  self.dmiter.iterate_filenames(chunksize=batch)]
        with maybe_trace(self.trace_dir):
            if self.journal_dir:
                peaks = self._search_journaled(chunks)
            else:
                peaks = self.searcher.process_stream(chunks)
        self.peaks = sorted(peaks, key=lambda p: p.period)
        log.info(f"Total peaks found: {len(peaks)}")

    def _search_journaled(self, chunks):
        """Checkpointed search through the survey scheduler."""
        from ..survey.journal import SurveyJournal
        from ..survey.scheduler import SurveyScheduler, survey_identity

        survey_id = survey_identity(
            [f for c in chunks for f in c],
            {"ranges": self.config["ranges"],
             "dereddening": self.config["dereddening"]},
        )
        scheduler = SurveyScheduler(
            self.searcher, chunks,
            journal=SurveyJournal(self.journal_dir),
            resume=self.resume,
            retry=self.retry,
            faults=self.faults,
            survey_id=survey_id,
            watchdog=self.watchdog,
            breaker=self.breaker,
        )
        return scheduler.run()

    @timing
    def cluster_peaks(self):
        """Friends-of-friends clustering of peak frequencies with radius
        (config radius) / median Tobs."""
        if not self.peaks:
            log.info("No peaks found: skipping clustering")
            return
        tmed = self.dmiter.tobs_median()
        clrad = self.config["clustering"]["radius"] / tmed
        log.debug(f"Median Tobs = {tmed:.2f} s, clustering radius = {clrad:.3e} Hz")
        # self.peaks is sorted by period hence by 1/freq; cluster1d sorts
        # internally anyway.
        freqs = np.asarray([p.freq for p in self.peaks])
        self.clusters = [
            PeakCluster(self.peaks[i] for i in ids)
            for ids in cluster1d(freqs, clrad)
        ]
        log.info(f"Total clusters found: {len(self.clusters)}")

    @timing
    def flag_harmonics(self):
        """Rank clusters by S/N and flag harmonically-related pairs; the
        brighter member of each related pair becomes the fundamental."""
        if not self.clusters:
            log.info("No clusters found: skipping harmonic flagging")
            return
        tobs = self.dmiter.tobs_median()
        fmin, fmax = self.dmiter.fmin, self.dmiter.fmax
        kwargs = self.config["harmonic_flagging"]

        by_snr = sorted(self.clusters, key=lambda c: c.centre.snr, reverse=True)
        for rank, cl in enumerate(by_snr):
            cl.rank = rank

        # DM-distance prefilter: of htest's three criteria only the DM
        # one is fraction-free, so its pairwise matrix (bit-identical
        # to the scalar path, see dm_distance_matrix) rejects most of
        # the O(n^2) pairs before paying a Fraction fit each. Skipped
        # pairs are exactly pairs htest returns related=False for, and
        # unrelated pairs never mutate flagging state, so the flagged
        # set is byte-identical with or without the prefilter.
        dmat = dm_distance_matrix([cl.centre for cl in by_snr], fmin, fmax)
        dm_max = kwargs.get("dm_distance_max", 3.0)
        for (i, F), (j, H) in itertools.combinations(enumerate(by_snr), 2):
            if F.is_harmonic or H.is_harmonic:
                continue
            if dmat[i, j] > dm_max:
                continue
            related, fraction = htest(F.centre, H.centre, tobs, fmin, fmax, **kwargs)
            if related:
                H.parent_fundamental = F
                H.hfrac = fraction

        nharm = sum(1 for c in self.clusters if c.is_harmonic)
        log.info(f"Harmonics flagged: {nharm}")
        log.info(f"Fundamental clusters: {len(self.clusters) - nharm}")

    @timing
    def apply_candidate_filters(self):
        """dm_min -> snr_min -> remove_harmonics -> max_number, in that
        order (riptide/pipeline/pipeline.py:251-289)."""
        log.info("Applying candidate filters")
        params = self.config["candidate_filters"]
        kept = self.clusters

        dm_min = params["dm_min"]
        if dm_min is not None:
            log.warning(f"Applying DM threshold of {dm_min}")
            kept = [c for c in kept if c.centre.dm >= dm_min]

        snr_min = params["snr_min"]
        if snr_min is not None:
            log.warning(f"Applying S/N threshold of {snr_min}")
            kept = [c for c in kept if c.centre.snr >= snr_min]

        if params["remove_harmonics"]:
            log.warning(
                "Harmonic removal enabled: flagged clusters will NOT become candidates"
            )
            kept = [c for c in kept if not c.is_harmonic]

        nmax = params["max_number"]
        if nmax:
            if len(kept) > nmax:
                log.warning(
                    f"Cluster count ({len(kept)}) exceeds max_number ({nmax}); "
                    f"the faintest {len(kept) - nmax} will not be saved"
                )
            kept = sorted(kept, key=lambda c: c.centre.snr, reverse=True)[:nmax]

        self.clusters_filtered = kept
        log.info(f"Clusters remaining: {len(kept)}")

    @timing
    def build_candidates(self):
        """Fold the best-DM TimeSeries of each surviving cluster into a
        Candidate. Clusters are grouped by DM so each file is loaded and
        detrended once; each candidate is built under try/except so one
        failure cannot lose the run (riptide/pipeline/pipeline.py:292-333)."""
        log.info("Building candidates")
        by_snr = sorted(
            self.clusters_filtered, key=lambda c: c.centre.snr, reverse=True
        )
        if not by_snr:
            log.info("No clusters: no candidates to build")
            return

        grouped = defaultdict(list)
        for cl in by_snr:
            grouped[cl.centre.dm].append(cl)
        log.debug(f"{len(by_snr)} candidates to build from {len(grouped)} TimeSeries")

        dq_by_dm = self.searcher.dq_by_dm()
        for dm, clusters in grouped.items():
            # search=False: a rebuild reload must not re-fire fault
            # directives or double-count the DQ metrics the search
            # already recorded for this file.
            ts = self.searcher.load_prepared(self.dmiter.get_filename(dm),
                                             search=False)
            if ts is None:
                # Only possible if the file degraded between the search
                # and the re-load (a searched DM cannot have been
                # quarantined); report rather than crash the run.
                log.error(
                    "DM %.3f trial was skipped/quarantined on re-load; "
                    "dropping its %d candidate cluster(s)", dm, len(clusters),
                )
                continue
            for cl in clusters:
                try:
                    rng = self.get_search_range(cl.centre.period)
                    cand = Candidate.from_pipeline_output(
                        ts, cl,
                        rng["candidates"]["bins"],
                        subints=rng["candidates"]["subints"],
                    )
                    # Data provenance for downstream vetting: fraction
                    # of this trial's samples masked by the DQ scan.
                    cand.params["masked_frac"] = round(
                        dq_by_dm.get(cl.centre.dm, 0.0), 6
                    )
                    self.candidates.append(cand)
                except Exception as err:
                    log.error(err)
                    log.error(traceback.format_exc())

        self.candidates = sorted(
            self.candidates, key=lambda c: c.params["snr"], reverse=True
        )
        log.info(f"Total candidates: {len(self.candidates)}")

    @timing
    def save_products(self, outdir=None):
        """peaks.csv, clusters.csv, candidates.csv + per-candidate JSON
        (and optional PNG) written by a process pool."""
        outdir = outdir or os.getcwd()
        if not self.peaks:
            log.info("No peaks found: no data products to save")
            return

        df_peaks = Table.from_records(
            [p.summary_dict() for p in self.peaks]
        )
        # Data provenance column: the masked fraction of the DM trial
        # each peak came from, so downstream vetting can weigh peaks
        # from degraded data accordingly.
        dq_by_dm = self.searcher.dq_by_dm() if self.searcher else {}
        df_peaks["masked_frac"] = [
            round(dq_by_dm.get(p.dm, 0.0), 6) for p in self.peaks
        ]
        fname = os.path.join(outdir, "peaks.csv")
        df_peaks.to_csv(fname, sep=",", float_format="%.9f")
        log.info(f"Saved Peak data to {fname!r}")

        if self.clusters:
            fname = os.path.join(outdir, "clusters.csv")
            clusters_to_dataframe(self.clusters).to_csv(
                fname, sep=",", float_format="%.9f"
            )
            log.info(f"Saved Cluster data to {fname!r}")

        if self.candidates:
            fname = os.path.join(outdir, "candidates.csv")
            Table.from_records(
                [c.params for c in self.candidates]
            ).to_csv(fname, sep=",", float_format="%.9f")

        log.info("Writing candidate files")
        writer = CandidateWriter(outdir, plot=self.config["plot_candidates"])
        arglist = list(enumerate(self.candidates))
        # JSON writing parallelises over host threads (I/O bound). PNG
        # rendering goes through matplotlib's non-thread-safe state, so
        # plots render in a SPAWN-based process pool (the reference uses
        # a fork pool, riptide/pipeline/pipeline.py:370-379; fork is off
        # the table here — by this point the CUDA runtime and the
        # batcher's threads hold state a forked child would snapshot
        # mid-use). Spawned children see no CUDA device and use the
        # Agg backend.
        if not self.config["plot_candidates"]:
            with ThreadPoolExecutor(max_workers=self.config["processes"]) as ex:
                list(ex.map(writer, arglist))
        elif self.config["processes"] > 1 and len(arglist) > 2:
            render_spawned(writer, arglist, self.config["processes"])
        else:
            for arg in arglist:
                writer(arg)
        log.info("Data products written")

    @timing
    def process(self, files, outdir):
        """Run all stages. Candidate filters apply *after* harmonic
        flagging so e.g. a bright zero-DM signal still claims its
        harmonics before any DM cut removes it. Each stage runs in a
        span of its name (:mod:`riptide_tpu_torch.obs.trace`); with
        tracing on (``trace=True`` or ``RIPTIDE_TRACE=1``) the run's
        spans are exported as a Chrome trace next to the journal, or
        into ``outdir`` when not journaling."""
        if self.trace and not trace_enabled():
            trace_enable()
        prom.maybe_serve()
        with span("prepare"):
            self.prepare(files)
        with span("search"):
            self.search()
        with span("cluster_peaks"):
            self.cluster_peaks()
        with span("flag_harmonics"):
            self.flag_harmonics()
        with span("apply_candidate_filters"):
            self.apply_candidate_filters()
        with span("build_candidates"):
            self.build_candidates()
        with span("save_products"):
            self.save_products(outdir=outdir)
        # The scheduler exported a search-stage trace next to the
        # journal; re-export after the post-search stages so the
        # host-tail spans land in the same file. Both are no-ops while
        # tracing is disabled.
        chrome.export_run_trace(self.journal_dir or outdir or os.getcwd())
        prom.maybe_write_textfile()

    @classmethod
    def from_yaml_config(cls, fname, **kwargs):
        """A Pipeline from a YAML config file (imports PyYAML)."""
        import yaml

        log.debug(f"Creating pipeline from config file: {fname}")
        with open(fname) as fobj:
            conf = yaml.safe_load(fobj)
        log.debug(f"Pipeline configuration: {json.dumps(conf, indent=4)}")
        return cls(conf, **kwargs)


# ----------------------------------------------------------------------------
# CLI (the rffa console application)
# ----------------------------------------------------------------------------

def get_parser():
    def outdir(path):
        if not os.path.isdir(path):
            raise argparse.ArgumentTypeError(
                f"Specified output directory {path!r} does not exist"
            )
        return path

    parser = argparse.ArgumentParser(
        formatter_class=lambda prog: argparse.ArgumentDefaultsHelpFormatter(
            prog, max_help_position=16
        ),
        description="Search multiple DM trials with the riptide_tpu_torch end-to-end FFA pipeline.",
    )
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="Pipeline configuration file")
    parser.add_argument("-o", "--outdir", type=outdir, default=os.getcwd(),
                        help="Output directory for the data products")
    parser.add_argument("-f", "--logfile", type=str, default=None,
                        help="Save logs to given file")
    parser.add_argument("--log-level", type=str, default="DEBUG",
                        choices=["DEBUG", "INFO", "WARNING"],
                        help="Logging level for the riptide_tpu_torch logger")
    parser.add_argument("--log-timings", action="store_true",
                        help="Log the execution times of all major functions")
    parser.add_argument("--trace-dir", type=str, default=None,
                        help="Capture a torch.profiler trace of the search "
                             "stage into this directory (trace.json, "
                             "viewable in Perfetto)")
    parser.add_argument("--fault-inject", type=str, default=None,
                        help="Fault-injection spec for robustness testing, "
                             "e.g. 'raise:2,stall:1:0.5' (see "
                             "riptide_tpu_torch.survey.faults)")
    parser.add_argument("--trace", action="store_true",
                        help="Record host-side phase spans (prep/wire/"
                             "dispatch/collect per chunk) and write a "
                             "Perfetto-loadable Chrome trace-event JSON "
                             "next to the journal (or into --outdir)")
    parser.add_argument("--journal", type=str, default=None,
                        help="Survey journal directory: checkpoint each "
                             "completed DM chunk (with retry/backoff around "
                             "device dispatch) so a killed run can resume")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the --journal directory, skipping "
                             "chunks it already records")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the de-reddening and the search: "
                             "'cuda' (the card) or 'cpu' (the plain "
                             "PyTorch versions)")
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("files", type=str, nargs="+",
                        help="Input file(s) of the configured format")
    return parser


def run_program(args):
    handlers = [logging.StreamHandler()]
    if args.logfile:
        handlers.append(logging.FileHandler(args.logfile, mode="w"))
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(filename)18s:%(lineno)-4s %(levelname)-8s %(message)s",
        handlers=handlers,
    )
    logging.getLogger("matplotlib").setLevel("WARNING")
    logging.getLogger("riptide_tpu_torch.timing").setLevel(
        "DEBUG" if args.log_timings else "WARNING"
    )

    pipeline = Pipeline.from_yaml_config(
        args.config,
        device=args.device,
        trace_dir=args.trace_dir,
        journal=args.journal,
        resume=args.resume,
        fault_spec=args.fault_inject,
        trace=args.trace,
    )
    if pipeline.config["plot_candidates"]:
        # Non-interactive matplotlib backend; switched here rather than
        # at import time so library users keep their own backend.
        import matplotlib.pyplot as plt

        plt.switch_backend("Agg")
    pipeline.process(args.files, args.outdir)
    log.info("CALCULATIONS CORRECT")


def main():
    run_program(get_parser().parse_args())


if __name__ == "__main__":
    main()
