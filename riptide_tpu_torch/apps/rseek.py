"""
rseek: FFA-search a single dedispersed time series and print a table of
significant peaks. Same CLI surface and defaults as the reference's
``rseek`` console script (riptide/apps/rseek.py) for the flags this
package has; the search runs on the card unless ``--device cpu`` is
given. Run as ``python -m riptide_tpu_torch.apps.rseek``.

The table is printed without pandas (a
:class:`~riptide_tpu_torch.table.Table`, whose text is pandas'
``to_string`` of the same rows). Not ported yet: the JAX package's
service client (``--submit``, ``--tenant``, ``--priority``) and its
survey hooks (``--journal``, ``--resume``, ``--fault-inject``,
``--deadline-s``, ``--trace``).
"""
import argparse
import logging

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


def run_program(args):
    """
    Run rseek; returns a :class:`~riptide_tpu_torch.table.Table` of
    detected peak parameters (columns period/freq/width/ducy/snr/dm), or
    None if nothing significant was found.
    """
    from riptide_tpu_torch import TimeSeries
    from riptide_tpu_torch.clustering import cluster1d
    from riptide_tpu_torch.quality import QuarantinedSeries
    from riptide_tpu_torch.timing import maybe_trace

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
            peaks = _search_peaks(args, ts)
    except QuarantinedSeries as err:
        # Degraded beyond searchability: report, don't crash.
        log.error("input quarantined by the data-quality scan: %s",
                  err.report.describe())
        print(f"Input quarantined: {err.report.describe()}")
        return None
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
