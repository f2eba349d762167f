"""
The work of a search, counted from its plan (the harness's own
:func:`portbench.reference.search.cascade`), never from the launches
that carry it out, and the card's peaks to hold it against.

Operations per DM trial, for every (stage, bins) group of m rows, p
phase bins and ``re`` evaluated rows (the count of the stage kernels'
own plain arithmetic): the wire's decode, a subtract and a multiply a
sample (2 m p); one add a sample in each of the ceil(log2 m) FFA merge
levels; and per evaluated row the prefix sum (p), three operations a
phase and width (3 nw p) and five a width (5 nw). Groups with no
evaluated row are not counted.

Bytes per DM trial: the wire read once (6 bits a downsampled sample and
a float32 scale a row of the wire) and the S/N written once (4 bytes a
trial period and width). No tables, scratch or padding.

Peaks: NVIDIA's published H100 SXM figures, 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores, which counts an FMA as two
operations; the count above takes one operation an add or multiply, so
the ceiling is half of it.
"""
import math

__all__ = ["PEAK_BYTES_PER_S", "PEAK_OPS_PER_S", "num_levels", "work",
           "bound_s"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12 / 2


def num_levels(m):
    """FFA merge levels of an m-row transform: ceil(log2 m)."""
    return 0 if m <= 1 else int(math.ceil(math.log2(m)))


def trials_work(trials, D, nw, with_decode=True):
    """Operations for (m, p, evaluated rows) trials over ``D`` DM trials
    (the same count, trial for trial, as the stage kernels' work table
    the repository's chip smoke test keeps)."""
    ops = 0
    for m, p, re in trials:
        if with_decode:
            ops += 2 * m * p
        ops += num_levels(m) * m * p
        ops += re * (p + 3 * nw * p + 5 * nw)
    return D * ops


def work(stages, nw, row, D=1):
    """(operations, bytes) of a ``D``-trial search over ``stages`` (from
    :func:`~portbench.reference.search.cascade`) with ``nw`` widths and
    a wire of ``row``-sample scale rows."""
    trials = [(rows, bins, re) for st in stages
              for bins, rows, re, _ in st.trials]
    ops = trials_work(trials, D, nw)
    wire = sum(st.n * 6 / 8 + 4 * -(-st.n // row) for st in stages)
    out = 4 * nw * sum(re for _, _, re in trials)
    return ops, D * (wire + out)


def bound_s(ops, nbytes):
    """(seconds, "operations" or "bytes"): the least time the card could
    take for ``ops`` and ``nbytes``."""
    to, tb = ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S
    return (to, "operations") if to >= tb else (tb, "bytes")
