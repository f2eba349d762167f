"""
Boxcar matched-filter S/N, plain PyTorch.

Implements the reference's profile S/N semantics
(riptide/cpp/snr.hpp:37-65): for each trial width w, slide a zero-mean,
unit-square-sum boxcar over the circularly-extended profile and take the
best phase. The circular prefix sum is one ``cumsum``; the per-width phase
maximum is a gather + subtract + masked max, unrolled over the (static,
~10-element) width ladder. This is the plain version the boxcar part of
the CUDA stage kernels (``csrc/ffa_stage.cu``) is held against, and what
runs for tensors on the CPU.

The batched entry point operates on the padded (..., B, R, P) FFA output
container of :mod:`riptide_tpu_torch.ops.ffa`, with per-problem bin counts
``p[b]`` and noise normalisations.
"""
import numpy as np
import torch

from .. import quality
from ..utils.device import resolve_device
from .reference import _boxcar_coeffs

__all__ = ["boxcar_coeffs", "snr_batched", "boxcar_snr"]


def boxcar_coeffs(nbins, widths):
    """
    Height h and (negated) baseline b of a zero-mean unit-square-sum boxcar
    of each width on an ``nbins``-bin profile (riptide/cpp/snr.hpp:45-49):
    the filter is +h over w bins and -b elsewhere, h = sqrt((n-w)/(n*w)),
    b = w/(n-w) * h. Host-side, float64.
    """
    return _boxcar_coeffs(nbins, widths)


def _snr_one_width(cs, total, p, w, P):
    """
    max over phase of the w-bin circular boxcar sum, for container cs.

    cs : (..., P) cumulative sum along phase with clean zero padding
    total : (..., 1) profile totals
    p : broadcastable int64 per-problem bin count
    """
    cols = torch.arange(P, dtype=torch.int64, device=cs.device)
    idx = cols + w  # boxcar covering phases [j+1, j+w]
    wrap = idx >= p
    idx2 = torch.where(wrap, idx - p, idx).clamp(0, P - 1)
    hi = torch.gather(cs, -1, idx2.expand(cs.shape))
    zero = torch.zeros((), dtype=cs.dtype, device=cs.device)
    d = hi + torch.where(wrap, total, zero) - cs
    d = torch.where(cols < p, d, torch.tensor(-np.inf, dtype=cs.dtype,
                                              device=cs.device))
    return d.amax(dim=-1)


def snr_batched(tbuf, p, widths, hcoef, bcoef, stdnoise):
    """
    S/N of every row of a padded FFA output container, for every width.

    tbuf : (..., B, R, P) float32, clean-padded (columns >= p[b] and rows
        >= m[b] are zero)
    p : (B,) integer per-problem phase bin counts
    widths : tuple of ints (the boxcar width ladder)
    hcoef, bcoef : (B, NW) float32 per-(problem, width) boxcar coefficients
    stdnoise : (B,) float32 noise normalisation per problem

    Returns (..., B, R, NW) float32. Rows >= rows_eval are garbage to be
    discarded by the caller.
    """
    quality.check_finite_array(tbuf, where="ops.snr.snr_batched")
    P = tbuf.shape[-1]
    cs = torch.cumsum(tbuf, dim=-1, dtype=torch.float32)
    total = cs[..., -1:]
    pb = p.to(torch.int64)[:, None, None]
    outs = []
    for iw, w in enumerate(widths):
        dmax = _snr_one_width(cs, total, pb, int(w), P)  # (..., B, R)
        h = hcoef[:, iw][:, None]
        b = bcoef[:, iw][:, None]
        outs.append(((h + b) * dmax - b * total[..., 0]) / stdnoise[:, None])
    return torch.stack(outs, dim=-1)


def boxcar_snr(data, widths, stdnoise=1.0, eff_frac=1.0, device=None):
    """
    S/N of pulse profile(s) for a range of boxcar width trials; same
    contract as the reference's ``libffa.boxcar_snr``
    (riptide/libffa.py:194-225): input of any shape with phase as the last
    axis, output gains a trailing width-trial axis.

    ``eff_frac`` is the effective-nsamp fraction of the folded series
    (``nsamp_eff / nsamp``): the S/N is scaled by ``1 / eff_frac`` so
    folds of partially-masked data stay on the clean S/N scale. Runs on
    ``device`` (the card when None).
    """
    dev = resolve_device(device)
    data = np.asarray(data, dtype=np.float32)
    quality.check_finite_array(data, where="ops.snr.boxcar_snr")
    if not 0.0 < eff_frac <= 1.0:
        raise ValueError("eff_frac must be in (0, 1]")
    # Integer widths only, like the reference's uint64 cast
    # (riptide/libffa.py:219).
    widths = np.asarray(widths).astype(np.int64)
    nbins = data.shape[-1]
    if not np.all((widths > 0) & (widths < nbins)):
        raise ValueError("trial widths must be all > 0 and < columns")
    if not stdnoise > 0:
        raise ValueError("stdnoise must be > 0")
    h, b = boxcar_coeffs(nbins, widths)
    flat = torch.from_numpy(data.reshape(1, -1, nbins)).to(dev)
    nw = widths.size
    snr = snr_batched(
        flat, torch.tensor([nbins], dtype=torch.int64, device=dev),
        tuple(int(w) for w in widths),
        torch.from_numpy(h.astype(np.float32)[None]).to(dev),
        torch.from_numpy(b.astype(np.float32)[None]).to(dev),
        torch.ones(1, dtype=torch.float32, device=dev),
    )
    snr = snr[0].cpu().numpy() / np.float32(stdnoise)
    if eff_frac != 1.0:
        snr = snr / np.float32(eff_frac)
    return snr.reshape(list(data.shape[:-1]) + [nw])
