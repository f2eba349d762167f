"""Pull and host tail: host milliseconds a chunk of the program's
``tail`` spans (``peaks_device.collect_peaks`` after the pull: unpack,
the float64 fit, the trust proof, the overflow gather, the peak lists),
on the profiler's clock."""
from portbench.spans import tail_spans


def read(rec):
    tails = tail_spans(rec["records"], rec["span"])
    if not tails or not rec["chunks"]:
        return None
    return sum(r["dur"] for r in tails) * 1e-3 / rec["chunks"]
