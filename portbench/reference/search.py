"""
Plain reference of the periodogram search, in PyTorch, for the
benchmark's comparison: the downsampling cascade, the wire's
quantisation, the FFA transform and the boxcar S/N, with the semantics
of riptide's C++ core (riptide/cpp/{periodogram,downsample,transforms,
snr}.hpp). Written from those semantics, not from the program's code: no
level tables, no containers, no padding, no kernels. It runs on any
device; the benchmark runs it on the card, after the measured window,
over a few sampled DM trials at a time.

Precision: the downsampling and every sum are float64 by default; the
wire (uint6, one float32 scale per row of ``row`` samples, values
``rint(v / scale)``) is reproduced as the configuration states it, in
float32 as it is defined. ``dtype`` lowers the FFA and the S/N, and
``qmax`` the wire, for the control.
"""
import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["Stage", "cascade", "downsample", "quantise", "ffa", "snr",
           "periodogram", "wire_row"]


def downsampled_size(nsamp, f):
    return int(math.floor(nsamp / f))


def downsampled_variance(nsamp, f):
    """Variance of unit white noise downsampled by real factor ``f``
    (riptide/cpp/downsample.hpp:29-38)."""
    k = math.floor(f)
    r = f - k
    x = downsampled_size(nsamp, f) * r
    if x > 1:
        return f - 1.0 / 3.0
    return (k - 1.0) ** 2 + 2.0 / 3.0 * x ** 2 - x + 1.0


def ceilshift(rows, cols, pmax):
    """First FFA row whose trial period reaches ``pmax`` samples
    (riptide/cpp/periodogram.hpp:54-57)."""
    return int(math.ceil(cols * (rows - 1.0) * (1.0 - cols / pmax)))


class Stage:
    """One downsampling cycle: factor ``f``, ``n`` samples, and per
    phase-bin count ``bins`` its ``rows``, evaluated rows and float64
    trial periods."""

    def __init__(self, f, n, tau, var):
        self.f, self.n, self.tau, self.var = f, n, tau, var
        self.trials = []  # (bins, rows, rows_eval, periods)


def cascade(size, tsamp, period_min, period_max, bins_min, bins_max):
    """The search's stages in output order (cycle, bins, shift), as
    riptide/cpp/periodogram.hpp:117-201 loops over them."""
    ds_ini = period_min / (tsamp * bins_min)
    ds_geo = (bins_max + 1.0) / bins_min
    num_ds = int(math.ceil(math.log(period_max / period_min)
                           / math.log(ds_geo)))
    stages = []
    for ids in range(num_ds):
        f = ds_ini * ds_geo ** ids
        tau = f * tsamp
        pms = period_max / tau
        n = downsampled_size(size, f)
        st = Stage(f, n, tau, downsampled_variance(size, f))
        for bins in range(bins_min, min(bins_max, n, int(pms)) + 1):
            rows = n // bins
            rows_eval = min(rows, max(ceilshift(rows, bins,
                                                min(pms, bins + 1.0)), 0))
            if rows_eval <= 0:
                continue
            s = np.arange(rows_eval, dtype=np.float64)
            periods = tau * bins * bins / (bins - s / (rows - 1.0))
            st.trials.append((bins, rows, rows_eval, periods))
        if st.trials:
            stages.append(st)
    return stages


def wire_row(bins_max):
    """Samples per scale row of the configured wire: ``bins_max``
    rounded up to 128."""
    return -(-int(bins_max) // 128) * 128


def downsample(x64, f, n):
    """(T, N) float64 series downsampled by real factor ``f`` to ``n``
    samples: output k sums the input over [k f, (k + 1) f), the two
    boundary samples weighted by their overlap
    (riptide/cpp/downsample.hpp:44-82). Float64 throughout."""
    N = x64.shape[-1]
    dev = x64.device
    k = torch.arange(n, dtype=torch.float64, device=dev)
    start = k * f
    end = start + f
    imin = torch.floor(start).long()
    imax = torch.clamp(torch.floor(end), max=N - 1.0).long()
    wmin = imin.double() + 1.0 - start
    wmax = end - imax.double()
    cs = torch.zeros(x64.shape[:-1] + (N + 1,), dtype=torch.float64,
                     device=dev)
    torch.cumsum(x64, -1, out=cs[..., 1:])
    interior = cs[..., imax] - cs[..., imin + 1]
    return wmin * x64[..., imin] + interior + wmax * x64[..., imax]


def quantise(v32, row, qmax):
    """The wire's quantisation of (T, n) float32 samples, decoded back:
    rows of ``row`` samples (the last zero-padded), one float32 scale a
    row ``max |v| / qmax`` (1 for an all-zero row), stored value
    ``rint(v * (1 / scale))`` in float32 with ties to even, decoded as
    ``value * scale``. Returns (T, n) float32."""
    T, n = v32.shape
    r0 = -(-n // row)
    buf = torch.zeros((T, r0 * row), dtype=torch.float32, device=v32.device)
    buf[:, :n] = v32
    view = buf.view(T, r0, row)
    rmax = view.abs().amax(-1)
    one = torch.ones((), dtype=torch.float32, device=v32.device)
    scale = torch.where(rmax > 0, rmax / torch.tensor(
        float(qmax), dtype=torch.float32, device=v32.device), one)
    inv = one / scale
    q = torch.round(view * inv[..., None])
    return (q * scale[..., None]).view(T, r0 * row)[:, :n]


@lru_cache(maxsize=None)
def _merge_mapping(m):
    """Row mapping of one FFA merge of an m-row node (head: the first
    m // 2 rows, tail: the rest): output row s is head row h[s] plus
    tail row t[s] rolled left by s - t[s] phase bins, the indices
    rounded in float32 as riptide/cpp/transforms.hpp:17-24 does."""
    mh = m // 2
    mt = m - mh
    s = np.arange(m, dtype=np.float32)
    kh = np.float32(mh - 1.0) / np.float32(m - 1.0)
    kt = np.float32(mt - 1.0) / np.float32(m - 1.0)
    h = (kh * s + np.float32(0.5)).astype(np.int64)
    t = (kt * s + np.float32(0.5)).astype(np.int64)
    return h, t, np.arange(m, dtype=np.int64) - t


def _ffa_steps(m):
    """The recursion of an m-row FFA (riptide/cpp/transforms.hpp:30-50)
    flattened by node height: a node of size k is merged at height
    ceil(log2 k), after both of its halves, and the nodes of one height
    cover disjoint rows. Per height, (head row, tail row, shift, has
    tail) of every row, numpy int64/bool arrays of length m; a row in no
    node of that height keeps its value."""
    H = (m - 1).bit_length() if m > 1 else 0
    rows = np.arange(m, dtype=np.int64)
    hrow = np.tile(rows, (H + 1, 1))
    trow = np.tile(rows, (H + 1, 1))
    shift = np.zeros((H + 1, m), np.int64)
    tail = np.zeros((H + 1, m), bool)
    starts = np.zeros(1, np.int64)
    sizes = np.full(1, m, np.int64)
    while True:
        keep = sizes > 1
        starts, sizes = starts[keep], sizes[keep]
        if not len(sizes):
            break
        for k in np.unique(sizes):
            k = int(k)
            st = starts[sizes == k][:, None]
            lev = (k - 1).bit_length()
            h, t, sh = _merge_mapping(k)
            out = (st + np.arange(k)).ravel()
            hrow[lev, out] = (st + h).ravel()
            trow[lev, out] = (st + k // 2 + t).ravel()
            shift[lev, out] = np.tile(sh, len(st))
            tail[lev, out] = True
        half = sizes // 2
        starts = np.concatenate([starts, starts + half])
        sizes = np.concatenate([half, sizes - half])
    return [(hrow[lev], trow[lev], shift[lev], tail[lev])
            for lev in range(1, H + 1)]


def ffa(x):
    """FFA transform of (T, m, p): output row s of each of the T
    problems is the sum of its m rows with a phase drift of s bins
    across them (riptide/cpp/transforms.hpp)."""
    T, m, p = x.shape
    dev = x.device
    cols = torch.arange(p, dtype=torch.int64, device=dev)
    for hrow, trow, shift, tail in _ffa_steps(m):
        hrow = torch.from_numpy(hrow).to(dev)
        trow = torch.from_numpy(trow).to(dev)
        idx = (cols[None, :] + torch.from_numpy(shift).to(dev)[:, None]) % p
        rolled = torch.gather(x[:, trow], 2, idx.expand(T, m, p))
        keep = torch.from_numpy(tail).to(dev)[None, :, None]
        x = x[:, hrow] + torch.where(keep, rolled, torch.zeros_like(rolled))
    return x


def snr(prof, widths, stdnoise):
    """Boxcar matched-filter S/N of (T, rows, bins) folded profiles for
    each trial width, phase-rotation invariant: the largest sum over
    ``w`` circularly consecutive bins, with the zero-mean unit-norm
    boxcar's height and baseline (riptide/cpp/snr.hpp:37-55). Returns
    (T, rows, len(widths)) in the profiles' dtype."""
    b = prof.shape[-1]
    dev, dt = prof.device, prof.dtype
    w = torch.as_tensor(widths, dtype=torch.int64, device=dev)
    wmax = int(max(widths))
    ext = torch.cat([prof, prof[..., :wmax]], -1)
    cs = torch.cat([torch.zeros(prof.shape[:-1] + (1,), dtype=dt,
                                device=dev), torch.cumsum(ext, -1)], -1)
    j = torch.arange(b, dtype=torch.int64, device=dev)
    dmax = (cs[..., j[None, :] + w[:, None]] - cs[..., j][..., None, :]
            ).amax(-1)
    wd = w.double()
    h = torch.sqrt((b - wd) / (b * wd))
    base = wd / (b - wd) * h
    return (((h + base).to(dt) * dmax - base.to(dt) * cs[..., b:b + 1])
            / stdnoise)


def periodogram(series, stages, widths, row, qmax=31, dtype=torch.float64):
    """S/N of every trial period and width for (T, N) float32 series
    (any device): (T, n_trials, n_widths) float64, in the order of
    :func:`cascade`. Each stage's downsampled series goes through the
    wire (:func:`quantise`, ``qmax`` 31 for uint6) before the FFA and
    the S/N run in ``dtype``."""
    x64 = series.double()
    out = []
    for st in stages:
        v32 = downsample(x64, st.f, st.n).float()
        xq = quantise(v32, row, qmax).to(dtype)
        for bins, rows, rows_eval, _ in st.trials:
            fold = ffa(xq[:, :rows * bins].reshape(-1, rows, bins))
            std = math.sqrt(rows * st.var)
            out.append(snr(fold[:, :rows_eval], widths, std).double())
    return torch.cat(out, 1)
