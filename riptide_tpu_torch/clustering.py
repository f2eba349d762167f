"""
1-D friends-of-friends clustering (reference: riptide/clustering.py).
"""
import numpy as np

__all__ = ["cluster1d"]


def cluster1d(x, r, assume_sorted=False):
    """
    Cluster 1-D points: two points share a cluster if they lie within
    distance ``r`` of each other (chained). Returns a list of index arrays
    into ``x``. Pass ``assume_sorted=True`` to skip the argsort when the
    input is known to be monotonically non-decreasing.
    """
    x = np.asarray(x)
    if not len(x):
        return []
    if assume_sorted:
        order = np.arange(len(x))
        steps = np.diff(x)
    else:
        order = x.argsort()
        steps = np.diff(x[order])
    gap_positions = np.flatnonzero(np.abs(steps) > r)
    if not len(gap_positions):
        return [order]
    edges = np.concatenate(([0], gap_positions + 1, [len(x)]))
    return [order[lo:hi] for lo, hi in zip(edges[:-1], edges[1:])]
