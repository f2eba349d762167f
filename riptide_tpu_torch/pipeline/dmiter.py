"""
DM-trial selection: choose the minimal subset of available DM trials that
still covers the requested DM range without sensitivity loss.

Semantics follow the reference (riptide/pipeline/dmiter.py:15-80): a
trial DM covers a radius in DM space within which the extra pulse
broadening from DM error stays below max(wmin, intra-channel smearing at
that DM); trials are picked greedily left to right so consecutive
coverage intervals overlap. Band parameters come from PRESTO headers
when available (riptide/pipeline/dmiter.py:84-117), otherwise they must
be user-supplied; the optional DM * |sin b| galactic cap uses the
package's internal equatorial->galactic conversion
(riptide_tpu_torch/utils/coords.py) instead of astropy.
"""
import logging
import math

import numpy as np

from ..metadata import Metadata

log = logging.getLogger("riptide_tpu_torch.pipeline.dmiter")

__all__ = ["KDM", "select_dms", "DMIterator", "get_band_params", "infer_band_params"]

# Standard rounded dispersion constant (Manchester & Taylor 1977), in
# MHz^2 pc^-1 cm^3 s — same convention as the reference (dmiter.py:12).
KDM = 1.0 / 2.41e-4


def select_dms(trial_dms, dm_start, dm_end, fmin, fmax, nchans, wmin):
    """
    Greedy minimal covering subset of ``trial_dms`` over [dm_start, dm_end].

    Each trial DM covers ``max(wmin, tsmear(dm)) / kdisp`` in DM space,
    where tsmear is the intra-channel smearing time and kdisp converts DM
    error to broadening across the band. A warning is logged when the
    available trials leave a coverage gap (riptide/pipeline/dmiter.py:73-77).
    """
    dms = np.sort(np.asarray(trial_dms, dtype=float))
    dms = dms[(dms >= dm_start) & (dms <= dm_end)]
    if dms.size == 0:
        raise ValueError(f"No trial DMs between {dm_start:.4f} and {dm_end:.4f}")

    # Broadening across the full band per unit DM error
    kdisp = KDM * (fmin**-2 - fmax**-2)
    # Intra-channel smearing per unit DM
    cw = (fmax - fmin) / nchans
    fmid = 0.5 * (fmax + fmin)
    ksmear = KDM * ((fmid - cw / 2) ** -2 - (fmid + cw / 2) ** -2)

    radii = np.maximum(wmin, ksmear * dms) / kdisp

    selected = [0]
    i = 0
    while True:
        # Furthest trial whose coverage still touches trial i's coverage
        j = i + 1
        best = None
        while j < dms.size:
            gap = (dms[j] - radii[j]) - (dms[i] + radii[i])
            if gap <= 0:
                best = j
                j += 1
            else:
                break
        if best is None:
            if i + 1 >= dms.size:
                break  # covered to the end of available trials
            nxt = i + 1
            log.warning(
                f"The step from trial DM {dms[i]:.4f} should not exceed "
                f"{2 * radii[i]:.4f}, but the next available trial DM lies "
                f"farther, at {dms[nxt]:.4f}"
            )
        else:
            nxt = best
        selected.append(nxt)
        i = nxt
    return dms[np.unique(selected)]


def get_band_params(meta, fmt="presto"):
    """(fmin, fmax, nchans) from a Metadata of the given source format
    (riptide/pipeline/dmiter.py:84-99). SIGPROC dedispersed headers carry
    no band information -> ValueError."""
    if fmt == "presto":
        fbot = meta["fbot"]
        nchans = meta["nchan"]
        ftop = fbot + nchans * meta["cbw"]
        return min(fbot, ftop), max(fbot, ftop), nchans
    if fmt == "sigproc":
        raise ValueError(
            "Cannot parse observing band parameters from data in sigproc format"
        )
    raise ValueError(f"Unknown format: {fmt}")


def infer_band_params(metadata_list, fmt="presto"):
    """Band params common to all files; RuntimeError if they disagree."""
    if not metadata_list:
        raise ValueError(
            "Cannot infer observing band parameters from an empty metadata "
            "list; no TimeSeries were passed as input."
        )
    params = [get_band_params(md, fmt=fmt) for md in metadata_list]
    if any(p != params[0] for p in params):
        raise RuntimeError(
            "Observing band parameters are NOT identical across all "
            "dedispersed time series"
        )
    return params[0]


def _common_galactic_coords(metadata_list):
    """(l, b) degrees, identical across all files or RuntimeError."""
    coords = [md["skycoord"].galactic for md in metadata_list]
    if any(c != coords[0] for c in coords):
        raise RuntimeError(
            "Coordinates are NOT identical across all dedispersed time series"
        )
    return coords[0]


class DMIterator:
    """
    Select and iterate the minimal DM-trial subset for a list of input
    files. Mirrors the reference's behaviour
    (riptide/pipeline/dmiter.py:136-252): DM range defaults to the
    available trials, optional DM |sin b| cap, band parameters inferred
    from PRESTO headers or required from the user, greedy subset
    selection via :func:`select_dms`.
    """

    METADATA_LOADERS = {
        "presto": Metadata.from_presto_inf,
        "sigproc": Metadata.from_sigproc,
    }

    def __init__(self, filenames, dm_start, dm_end, dmsinb_max=45.0,
                 fmt="presto", wmin=1.0e-3, fmin=None, fmax=None, nchans=None):
        loader = self.METADATA_LOADERS[fmt]
        self.metadata_list = [loader(f) for f in filenames]
        self.fmt = fmt
        self.wmin = float(wmin)
        self.dm_start = (
            float(dm_start) if dm_start is not None
            else min(md["dm"] for md in self.metadata_list)
        )
        self.dm_end = (
            float(dm_end) if dm_end is not None
            else max(md["dm"] for md in self.metadata_list)
        )

        gl_deg, gb_deg = _common_galactic_coords(self.metadata_list)
        if dmsinb_max is not None:
            cap = float(dmsinb_max) / abs(math.sin(math.radians(gb_deg)))
            log.info(
                f"Applying DM|sin b| cap of {float(dmsinb_max):.4f}: at "
                f"b = {gb_deg:.2f} deg this means a max DM of {cap:.4f}"
            )
            self.dm_end = min(self.dm_end, cap)

        try:
            self.fmin, self.fmax, self.nchans = infer_band_params(
                self.metadata_list, fmt=fmt
            )
            log.info(
                "Inferred observing band parameters from input files: "
                f"fmin = {self.fmin:.3f}, fmax = {self.fmax:.3f}, "
                f"nchans = {self.nchans:d}"
            )
        except (ValueError, RuntimeError) as err:
            log.info(f"Could not infer band parameters from input files: {err!s}")
            if any(v is None for v in (fmin, fmax, nchans)):
                raise ValueError("You MUST specify: fmin, fmax, nchans")
            self.fmin, self.fmax, self.nchans = fmin, fmax, nchans
            log.info(
                f"Using manually specified band parameters: fmin = {self.fmin:.3f}, "
                f"fmax = {self.fmax:.3f}, nchans = {self.nchans:d}"
            )

        self.metadata_dict = {md["dm"]: md for md in self.metadata_list}
        self.selected_dms = select_dms(
            list(self.metadata_dict.keys()),
            self.dm_start, self.dm_end,
            self.fmin, self.fmax, self.nchans, self.wmin,
        )
        log.info(
            f"Selected {len(self.selected_dms)} DM trials for processing: "
            f"{list(self.selected_dms)}"
        )

    def iterate_filenames(self, chunksize=1):
        """Yield selected filenames in chunks of ``chunksize`` (the device
        batch size in this framework, not a process count)."""
        chunk = []
        for dm in self.selected_dms:
            chunk.append(self.metadata_dict[dm]["fname"])
            if len(chunk) == chunksize:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    def get_filename(self, dm):
        return self.metadata_dict[dm]["fname"]

    def tobs_median(self):
        return float(np.median([md["tobs"] for md in self.metadata_list]))

    def tsamp_max(self):
        return max(md["tsamp"] for md in self.metadata_list)
