"""A cell of the benchmark cut to a size the CPU tests can hold: the
real files, with a 2^16-sample series at 1 ms, P 0.5-4 s at 64-72 bins
and chunks of 4 DM trials; and a configuration of two search ranges on
the same series."""
import copy

from portbench import cell
from portbench.ranges import RANGE_KEYS


def small_cell(workload="quickstart.survey"):
    wl, cfg, mix, limits, bench = cell.load_cell(workload)
    cfg = dict(copy.deepcopy(cfg), nsamp=1 << 16, tsamp=1e-3,
               period_min=0.5, period_max=4.0, bins_min=64, bins_max=72,
               pulsar_period=1.0)
    mix = dict(copy.deepcopy(mix), dm_trials=4)
    return wl, cfg, mix, limits, bench


# Two search ranges of the series above, with limits under their names.
RANGES = [{"name": "a", "period_min": 0.5, "period_max": 2.0,
           "bins_min": 64, "bins_max": 72, "pulsar_period": 1.0},
          {"name": "b", "period_min": 2.0, "period_max": 4.0,
           "bins_min": 128, "bins_max": 136, "pulsar_period": 3.0}]


def two_range_cell():
    """The small cell with its configuration split into :data:`RANGES`,
    each with the small cell's other range keys, and each range's limits
    those of the small cell's own."""
    wl, cfg, mix, limits, bench = small_cell()
    keep = {k: v for k, v in cfg.items() if k not in RANGE_KEYS}
    cfg = dict(keep, ranges=[
        dict({k: cfg[k] for k in RANGE_KEYS if k in cfg}, fpmin=8, **r)
        for r in RANGES])
    limits = dict(limits, limits={f"{k}.{r['name']}": v for r in RANGES
                                  for k, v in limits["limits"].items()})
    return wl, cfg, mix, limits, bench
