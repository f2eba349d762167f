"""
FFA transform, plain PyTorch.

The transform executes as ``L`` vectorised levels over an (R, P) buffer
(see :mod:`riptide_tpu_torch.ops.plan` for how the reference's recursion —
riptide/cpp/transforms.hpp:30-50 — is flattened into level tables). Each
level is a row gather, a per-row circular left-roll of the tail operand
(the ``fused_rollback_add`` of riptide/cpp/kernels.hpp:19-29, as a
modular column gather), and one add. The CUDA level kernel
(``csrc/ffa_stage.cu``) runs the same tables and the same single add per
element, so the two agree bit for bit.

Two entry points:

* :func:`ffa2` — user-facing transform of a single (m, p) array.
* :func:`ffa_levels` — the raw level executor over a padded batch
  container, used by the plain stage versions of
  :mod:`riptide_tpu_torch.ops.ffa_kernel`.
"""
import numpy as np
import torch

from ..utils.device import resolve_device
from .plan import ffa_plan

__all__ = ["ffa2", "ffa1", "ffa_levels", "ffa_transform_padded", "ffafreq",
           "ffaprd"]


def _level_step(buf, h, t, shift, p):
    """
    One FFA level over a batched container.

    buf : (..., B, R, P) float32
    h, t, shift : (B, R) integer tables of this level
    p : (B,) integer per-problem phase bin counts (columns >= p[b] are
        masked back to zero so padding stays clean)
    """
    B, R, P = buf.shape[-3:]
    dev = buf.device
    bidx = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    head = buf[..., bidx, h.long(), :]
    tail = buf[..., bidx, t.long(), :]
    cols = torch.arange(P, dtype=torch.int64, device=dev)
    pb = p.to(torch.int64)[:, None, None]
    idx = (cols + shift.to(torch.int64)[:, :, None]) % pb
    rolled = torch.gather(tail, -1, idx.expand(tail.shape))
    out = head + rolled
    return torch.where(cols < pb, out, torch.zeros((), dtype=out.dtype,
                                                    device=dev))


def ffa_levels(buf, h, t, shift, p):
    """
    Run all FFA levels over a padded batch container.

    buf : (..., B, R, P) float32 with rows >= m[b] all zero
    h, t, shift : (L, B, R) integer level tables
    p : (B,) integer

    Returns the transformed container; valid data is in
    ``out[..., b, :m[b], :p[b]]``.
    """
    for lev in range(h.shape[0]):
        buf = _level_step(buf, h[lev], t[lev], shift[lev], p)
    return buf


def ffa_transform_padded(data, m, p):
    """
    Single-problem transform body: pad an (m, p) block into the
    (1, m + 1, p) zero-row container, run :func:`ffa_levels` with the
    cached plan tables, slice back.
    """
    plan = ffa_plan(m)
    if plan.levels == 0:
        return data
    dev = data.device
    buf = torch.zeros((1, m + 1, p), dtype=torch.float32, device=dev)
    buf[0, :m, :] = data
    out = ffa_levels(
        buf,
        torch.from_numpy(plan.h[:, None, :]).to(dev),
        torch.from_numpy(plan.t[:, None, :]).to(dev),
        torch.from_numpy(plan.shift[:, None, :]).to(dev),
        torch.tensor([p], dtype=torch.int64, device=dev),
    )
    return out[0, :m, :]


def ffa2(data, device=None):
    """
    Compute the FFA transform of a 2D input of shape (m, p): m signal
    periods by p phase bins. Returns a float32 (m, p) numpy array whose
    row s is the phase-drift-s folded profile.

    Equivalent of the reference's ``libffa.ffa2`` (riptide/libffa.py:71-91),
    executed on ``device`` (the card when None).
    """
    dev = resolve_device(device)
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError("input data must be two-dimensional")
    m, p = data.shape
    if m == 1:
        return data.copy()
    out = ffa_transform_padded(torch.from_numpy(data).to(dev), m, p)
    return out.cpu().numpy()


def ffa1(data, p, device=None):
    """
    FFA transform of a 1D time series at base period ``p`` (in samples).
    The last ``N % p`` samples are ignored. Equivalent of
    riptide/libffa.py:94-126.
    """
    data = np.asarray(data)
    if data.ndim != 1:
        raise ValueError("input data must be one-dimensional")
    if not (isinstance(p, (int, np.integer)) and p > 0):
        raise ValueError("p must be an integer > 1")
    if p > data.size:
        raise ValueError("p must be smaller than the total number of samples")
    m = data.size // p
    return ffa2(data[: m * p].reshape(m, p), device=device)


def ffafreq(N, p, dt=1.0):
    """
    Trial frequencies of every folded profile in an FFA output
    (riptide/libffa.py:129-169): f(s) = (1/p - s/(m-1) * 1/p^2) / dt.
    """
    if not (isinstance(N, (int, np.integer)) and N > 0):
        raise ValueError("N must be a strictly positive integer")
    if not (isinstance(p, (int, np.integer)) and p > 1):
        raise ValueError("p must be an integer > 1")
    if not N >= p:
        raise ValueError("p must be smaller than (or equal to) N")
    if not dt > 0:
        raise ValueError("dt must be strictly positive")
    f0 = 1.0 / p
    m = N // p
    if m == 1:
        f = np.asarray([f0])
    else:
        s = np.arange(m)
        f = f0 - s / (m - 1.0) * f0**2
    return f / dt


def ffaprd(N, p, dt=1.0):
    """Trial periods of every folded profile in an FFA output: 1/ffafreq."""
    return 1.0 / ffafreq(N, p, dt=dt)
