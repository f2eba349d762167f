"""A cell of the benchmark cut to a size the CPU tests can hold: the
real files, with a 2^16-sample series at 1 ms, P 0.5-4 s at 64-72 bins
and chunks of 4 DM trials."""
import copy

from portbench import cell


def small_cell(workload="quickstart.survey"):
    wl, cfg, mix, limits, bench = cell.load_cell(workload)
    cfg = dict(copy.deepcopy(cfg), nsamp=1 << 16, tsamp=1e-3,
               period_min=0.5, period_max=4.0, bins_min=64, bins_max=72,
               pulsar_period=1.0)
    mix = dict(copy.deepcopy(mix), dm_trials=4)
    return wl, cfg, mix, limits, bench
