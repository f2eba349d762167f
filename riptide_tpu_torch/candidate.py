"""
Candidate: final data product of the pipeline — best-fit signal
parameters, folded sub-integrations, the associated periodogram peaks
and a diagnostic plot (reference contract: riptide/candidate.py). The
member peaks are a :class:`~riptide_tpu_torch.table.Table`; matplotlib
is imported only to plot.
"""
import logging

import numpy as np

log = logging.getLogger("riptide_tpu_torch.candidate")

__all__ = ["Candidate"]


class Candidate:
    """
    Attributes
    ----------
    params : dict
        Best-fit parameters: period, freq, dm, width, ducy, snr.
    tsmeta : Metadata
        Metadata of the DM trial in which the candidate peaked.
    peaks : Table
        Periodogram peaks associated with the candidate (a
        :class:`~riptide_tpu_torch.table.Table` with the columns period,
        freq, dm, width, ducy, snr).
    subints : ndarray
        (num_subints, num_bins) folded sub-integrations (or 1D profile).
    """

    def __init__(self, params, tsmeta, peaks, subints):
        self.params = params
        self.tsmeta = tsmeta
        self.peaks = peaks
        self.subints = subints

    @property
    def profile(self):
        """Folded profile (sum of sub-integrations)."""
        if self.subints.ndim == 1:
            return self.subints
        return self.subints.sum(axis=0)

    @property
    def dm_curve(self):
        """(dm trials, best S/N per trial) from the associated peaks,
        the trials in increasing order."""
        dms, inv = np.unique(self.peaks["dm"], return_inverse=True)
        snr = np.asarray(self.peaks["snr"])
        best = np.full(dms.size, -np.inf, dtype=snr.dtype)
        np.maximum.at(best, inv, snr)
        return dms, best

    @classmethod
    def from_pipeline_output(cls, ts, peak_cluster, bins, subints=1):
        """
        Fold the given TimeSeries at the cluster's centre period. If the
        requested number of sub-integrations does not fit in the data,
        fall back to one row per full period.
        """
        centre = peak_cluster.centre
        P0 = centre.period
        if subints is not None and subints * P0 >= ts.length:
            log.debug(
                f"Period ({P0:.3f}) x requested subints ({subints:d}) exceeds time "
                f"series length ({ts.length:.3f}), setting subints = full periods "
                "that fit in the data"
            )
            subints = None
        subints_array = ts.fold(centre.period, bins, subints=subints)
        return cls(
            centre.summary_dict(), ts.metadata, peak_cluster.summary_dataframe(), subints_array
        )

    def to_dict(self):
        return {
            "params": self.params,
            "tsmeta": self.tsmeta,
            "peaks": self.peaks,
            "subints": self.subints,
        }

    @classmethod
    def from_dict(cls, items):
        from .metadata import Metadata

        tsmeta = items["tsmeta"]
        if isinstance(tsmeta, dict) and not hasattr(tsmeta, "to_dict"):
            tsmeta = Metadata(tsmeta)
        return cls(items["params"], tsmeta, items["peaks"], items["subints"])

    def __str__(self):
        p = self.params
        return (
            f"Candidate(P0={p.get('period', float('nan')):.9f}, "
            f"DM={p.get('dm')}, S/N={p.get('snr', float('nan')):.1f})"
        )

    __repr__ = __str__

    def plot(self, figsize=(18, 4.5), dpi=80):
        """
        Four-panel diagnostic figure: sub-integrations image, folded
        profile, parameter table, and DM curve. Returns the figure.
        """
        import matplotlib.pyplot as plt
        from matplotlib.gridspec import GridSpec

        fig = plt.figure(figsize=figsize, dpi=dpi)
        gs = GridSpec(1, 4, figure=fig, width_ratios=[1.2, 1.5, 1.0, 1.2])

        p = self.params
        nbins = self.profile.size

        # Panel 1: sub-integrations
        ax = fig.add_subplot(gs[0])
        if self.subints.ndim == 2 and self.subints.shape[0] > 1:
            ax.imshow(self.subints, aspect="auto", origin="lower", cmap="Greys")
        else:
            ax.plot(self.profile, color="#303030")
        ax.set_xlabel("Phase bin")
        ax.set_ylabel("Sub-integration")
        ax.set_title("Sub-integrations")

        # Panel 2: folded profile (bar plot, like a pulse profile)
        ax = fig.add_subplot(gs[1])
        ax.bar(np.arange(nbins), self.profile, width=1.0, color="#305080")
        ax.set_xlim(-0.5, nbins - 0.5)
        ax.set_xlabel("Phase bin")
        ax.set_ylabel("Amplitude")
        ax.set_title(f"Profile (P0 = {p.get('period', float('nan')):.6f} s)")

        # Panel 3: parameter table
        ax = fig.add_subplot(gs[2])
        ax.axis("off")
        rows = []
        for key in ("period", "freq", "dm", "width", "ducy", "snr"):
            val = p.get(key)
            rows.append((key, f"{val:.6g}" if isinstance(val, float) else str(val)))
        meta_keys = ("source_name", "mjd", "fname")
        for key in meta_keys:
            val = self.tsmeta.get(key) if self.tsmeta is not None else None
            if val is not None:
                sval = str(val)
                rows.append((key, sval if len(sval) < 40 else "..." + sval[-37:]))
        table = ax.table(cellText=rows, loc="center", cellLoc="left")
        table.auto_set_font_size(False)
        table.set_fontsize(9)
        ax.set_title("Parameters")

        # Panel 4: DM curve
        ax = fig.add_subplot(gs[3])
        dms, snrs = self.dm_curve
        ax.plot(dms, snrs, marker="o", color="#803030")
        ax.set_xlabel(r"DM (pc cm$^{-3}$)")
        ax.set_ylabel("Best S/N")
        ax.set_title("DM curve")
        ax.grid(linestyle=":")

        fig.tight_layout()
        return fig

    def savefig(self, fname, **kwargs):
        """Render :meth:`plot` to a file and close the figure."""
        import matplotlib.pyplot as plt

        fig = self.plot(**kwargs)
        fig.savefig(fname)
        plt.close(fig)
