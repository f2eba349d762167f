"""
FFA search entry points: plan on the host, execute on the device.
:func:`ffa_search` searches one series; :func:`run_search_batch` a DM
batch, with peak detection on the device.
"""
from ..ffautils import generate_width_trials
from ..periodogram import Periodogram
from ..timing import timing
from .engine import (StagingPool, collect_search_batch, prepare_stage_data,
                     queue_search_batch, release_prepared, run_periodogram,
                     run_periodogram_batch, run_search_batch, search_snr_dev)
from .plan import (PeriodogramPlan, periodogram_plan, plan_arrays,
                   plan_from_arrays, plan_occupancy)

__all__ = [
    "ffa_search",
    "periodogram_plan",
    "PeriodogramPlan",
    "plan_arrays",
    "plan_from_arrays",
    "plan_occupancy",
    "run_periodogram",
    "run_periodogram_batch",
    "run_search_batch",
    "queue_search_batch",
    "collect_search_batch",
    "search_snr_dev",
    "prepare_stage_data",
    "release_prepared",
    "StagingPool",
]


@timing
def ffa_search(
    tseries,
    period_min=1.0,
    period_max=30.0,
    fpmin=8,
    bins_min=240,
    bins_max=260,
    ducy_max=0.20,
    wtsp=1.5,
    deredden=True,
    rmed_width=4.0,
    rmed_minpts=101,
    already_normalised=False,
    dq=True,
    max_masked_frac=0.5,
    device=None,
):
    """
    Run an FFA search of a single TimeSeries, producing its periodogram.

    Same contract and defaults as the reference's ``ffa_search``
    (riptide/search.py:11-82): de-redden then normalise (in that order),
    generate the boxcar width ladder from ``bins_min``, then search every
    trial period in [period_min, period_max].

    Parameters mirror the reference; see in particular:
    - fpmin: documented in the reference as capping period_max at
      DATA_LENGTH / fpmin, but its implementation never applies the cap;
      this is reproduced exactly for output parity.
    - bins_min/bins_max: phase bin range of the folds; the data are
      iteratively downsampled so bins stay within it as the trial period
      grows.
    - ducy_max, wtsp: boxcar width ladder parameters.
    - rmed_width, rmed_minpts: running median de-reddening parameters.
    - dq: run the data-quality scan (:mod:`riptide_tpu_torch.quality`)
      before searching: NaN/Inf, clipped and dead samples are masked,
      repaired with the local running median and excluded from the
      normalisation (with the effective-nsamp S/N correction). A series
      whose masked fraction exceeds max_masked_frac raises
      :class:`~riptide_tpu_torch.quality.QuarantinedSeries`.
    - device: where the de-reddening and the periodogram run; None means
      the card (``"cuda"``), and a host without one raises. Pass
      ``device="cpu"`` for the plain PyTorch versions.

    Returns
    -------
    ts : TimeSeries
        The de-reddened, normalised series that was actually searched.
    pgram : Periodogram
    """
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dq:
        from .. import quality

        prepared, report = quality.prepare_time_series(
            tseries,
            rmed_width=rmed_width if deredden else None,
            rmed_minpts=rmed_minpts,
            dq=quality.DQConfig(max_masked_frac=max_masked_frac),
            normalise=not already_normalised,
            device=dev,
        )
        if prepared is None:
            raise quality.QuarantinedSeries(report)
        tseries = prepared
    else:
        # Prepare data: deredden then normalise IN THAT ORDER
        if deredden:
            tseries = tseries.deredden(rmed_width, minpts=rmed_minpts,
                                       device=dev)
        if not already_normalised:
            tseries = tseries.normalise()

    widths = generate_width_trials(bins_min, ducy_max=ducy_max, wtsp=wtsp)
    plan = periodogram_plan(
        tseries.nsamp,
        tseries.tsamp,
        tuple(int(w) for w in widths),
        float(period_min),
        float(period_max),
        int(bins_min),
        int(bins_max),
    )
    periods, foldbins, snrs = run_periodogram(plan, tseries.data, device=dev)
    pgram = Periodogram(widths, periods, foldbins, snrs, metadata=tseries.metadata)
    return tseries, pgram
