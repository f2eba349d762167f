"""
Sliding-window ("running") median, plain PyTorch.

The reference computes an exact running median with a quickselect per
pushed sample (riptide/cpp/running_median.hpp), which is inherently
serial. Here all windows of the (edge-padded) series are materialised as
an (n, width) gather and each row's median taken at once. Memory is
n*width floats, which is fine for the widths this is used with: the
de-reddening path always scrunches the series first so that
width <= ~2*min_points (riptide/running_medians.py:49-83).
"""
import numpy as np
import torch

__all__ = ["running_median_torch", "scrunch_torch", "fast_running_median_torch"]


def running_median_torch(x, width):
    """
    Exact running median of odd ``width`` with both ends padded by the edge
    values, matching riptide/cpp/running_median.hpp:100-132. x is 1D.
    """
    n = x.shape[0]
    half = width // 2
    idx = (torch.arange(n, device=x.device)[:, None]
           + torch.arange(width, device=x.device)[None, :] - half).clamp(0, n - 1)
    return x[idx].median(dim=-1).values


# Window of the two-level float32 sums of :func:`_tree_sum`.
SUM_WINDOW = 32


def _tree_sum(x):
    """Float32 sum over the last axis in the order XLA's CPU backend
    sums it (its tree reduction: a sum longer than 32 is cut into
    ceil(n / 32) windows of 32, zero-padded evenly at both ends, each
    window and then the window sums added left to right), so that the
    JAX package's running medians on the CPU are reproduced bit for bit.
    Elementwise adds only: the same bits on any device."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for j in range(n):
            acc = acc + x[..., j]
        return acc
    windows = -(-n // SUM_WINDOW)
    pad = windows * SUM_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return _tree_sum(_tree_sum(xp.reshape(*x.shape[:-1], windows,
                                          SUM_WINDOW)))


def scrunch_torch(x, factor):
    """Mean-pool by an integer factor (riptide/running_medians.py:40-46):
    each block's :func:`_tree_sum` times the float32 reciprocal of the
    factor, as the JAX package's ``mean`` computes it."""
    n = (x.shape[0] // factor) * factor
    inv = float(np.float32(1.0) / np.float32(factor))
    return _tree_sum(x[:n].reshape(-1, factor)) * inv


def _interp(x, xp, fp):
    """Linear interpolation with ``numpy.interp``'s edge clamping, in
    float32, in the operation order of ``jax.numpy.interp`` as XLA's CPU
    backend runs it: ``fp[i-1] + (delta / dx) * df`` contracted into a
    fused multiply-add. The product of two float32 values is exact in
    float64, so the sum is taken there and rounded to float32 (one
    rounding, as the fused multiply-add, but for a double rounding in
    rare ties)."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    q = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = (fp[i - 1].double() + q.double() * df.double()).float()
    f = torch.where(dx0, fp[i - 1], f)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def fast_running_median_torch(x, width, min_points=101):
    """
    Approximate running median over large windows: scrunch so that the
    window is ~min_points samples, take the exact running median at low
    resolution, and linearly interpolate back
    (riptide/running_medians.py:49-83). Sample k of the scrunched series
    sits at original coordinate k*factor + (factor-1)/2.
    """
    factor = int(max(1, width / float(min_points)))
    if factor == 1:
        return running_median_torch(x, width)
    lo = scrunch_torch(x, factor)
    rmed_lo = running_median_torch(lo, min_points)
    x_lo = (torch.arange(lo.shape[0], dtype=torch.int32, device=x.device)
            * factor + 0.5 * (factor - 1))
    return _interp(torch.arange(x.shape[0], dtype=torch.float32,
                                device=x.device), x_lo, rmed_lo)
