"""
Clusters of Peak objects detected at the same frequency across DM trials.

Produces the same summary-row schema and CSV column order as the
reference's PeakCluster (riptide/pipeline/peak_cluster.py:4-85) — the
columns are a file-format contract — with a composition-based container:
member peaks are stored sorted by decreasing S/N, so the cluster centre
(best peak) is simply the first member. The summaries are
:class:`~riptide_tpu_torch.table.Table` objects where the JAX package
returns pandas DataFrames, with the same columns and CSV bytes.
"""
from operator import attrgetter

from ..table import Table

__all__ = ["PeakCluster", "clusters_to_dataframe"]

# CSV schema of clusters.csv — fixed order, integer harmonic columns.
SUMMARY_COLUMNS = [
    "rank", "period", "dm", "snr", "ducy", "freq", "npeaks",
    "hfrac_num", "hfrac_denom", "fundamental_rank",
]


class PeakCluster:
    """
    Peaks of one periodicity candidate across DM trials.

    Mutable annotations set by later pipeline stages: ``rank`` (position
    in the search-wide S/N ordering) and, if harmonic flagging relates
    this cluster to a stronger one, ``parent_fundamental`` (the
    fundamental's cluster) and ``hfrac`` (the frequency ratio Fraction).
    """

    def __init__(self, peaks, rank=None, parent_fundamental=None, hfrac=None):
        self.peaks = sorted(peaks, key=attrgetter("snr"), reverse=True)
        if not self.peaks:
            raise ValueError("a PeakCluster needs at least one Peak")
        self.rank = rank
        self.parent_fundamental = parent_fundamental
        self.hfrac = hfrac

    def __iter__(self):
        return iter(self.peaks)

    def __len__(self):
        return len(self.peaks)

    def __getitem__(self, i):
        return self.peaks[i]

    @property
    def centre(self):
        """Highest-S/N member (members are kept S/N-sorted)."""
        return self.peaks[0]

    @property
    def is_harmonic(self):
        return self.parent_fundamental is not None

    def summary_dataframe(self):
        """Per-member-peak parameter table."""
        return Table.from_records([p.summary_dict() for p in self.peaks])

    def summary_dict(self):
        """One clusters.csv row: centre params, member count, rank, and
        harmonic linkage. Harmonic columns stay integer-typed by encoding
        "not a harmonic" as hfrac 0/0 with fundamental_rank = own rank."""
        num = den = 0
        fundamental = self.rank
        if self.is_harmonic:
            num, den = self.hfrac.numerator, self.hfrac.denominator
            fundamental = self.parent_fundamental.rank
        return dict(
            self.centre.summary_dict(),
            npeaks=len(self.peaks),
            rank=self.rank,
            hfrac_num=num,
            hfrac_denom=den,
            fundamental_rank=fundamental,
        )

    def __repr__(self):
        return (
            f"{type(self).__name__}(size={len(self.peaks)}, "
            f"centre={self.centre})"
        )


def clusters_to_dataframe(clusters):
    """Summary table over clusters, strongest first, in the fixed
    clusters.csv column order."""
    rows = [
        cl.summary_dict()
        for cl in sorted(clusters, key=lambda c: c.centre.snr, reverse=True)
    ]
    return Table.from_records(rows)[SUMMARY_COLUMNS]
