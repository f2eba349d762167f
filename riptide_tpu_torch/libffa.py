"""
Public kernel-level API: FFA transforms, boxcar S/N, downsampling and
synthetic signal generation. The equivalent of the reference's
``riptide/libffa.py`` wrapper layer; the transforms and S/N run in
PyTorch on ``device`` (the card when None).
"""
import numpy as np

from .ffautils import generate_width_trials
from .ops import reference as _ref
from .ops.ffa import ffa1, ffa2, ffafreq, ffaprd
from .ops.snr import boxcar_snr

__all__ = [
    "ffa1",
    "ffa2",
    "ffafreq",
    "ffaprd",
    "boxcar_snr",
    "downsample",
    "generate_signal",
    "generate_width_trials",
    "benchmark_ffa2",
]


def benchmark_ffa2(rows, cols, loops=10, device=None):
    """
    Best wall-clock seconds of one (rows, cols) FFA transform
    (:func:`~riptide_tpu_torch.ops.ffa.ffa_transform_padded`) on
    ``device`` (the card when None), over ``loops`` timed calls after
    one warm-up, on a seeded float32 input; on a card each call is
    bracketed by ``torch.cuda.synchronize()``. The counterpart of the
    reference's ``libcpp.benchmark_ffa2``
    (riptide/cpp/python_bindings.cpp:87-106).
    """
    import time

    import torch

    from .ops.ffa import ffa_transform_padded
    from .utils.device import resolve_device

    dev = resolve_device(device)
    rows, cols = int(rows), int(cols)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (rows, cols)).astype(np.float32)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ffa_transform_padded(x, rows, cols)
    best = float("inf")
    for _ in range(int(loops)):
        sync()
        t0 = time.perf_counter()
        ffa_transform_padded(x, rows, cols)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def downsample(data, factor):
    """
    Downsample an array by a real-valued factor (fractional boundary
    samples split by linear weights). Host-side float64 path.
    """
    data = np.asarray(data, dtype=np.float32)
    n = data.size
    if not (factor > 1.0 and factor <= n):
        raise ValueError("Downsampling factor must verify: 1 < f <= size")
    return _ref.downsample(data, factor)


def generate_signal(nsamp, period, phi0=0.5, ducy=0.02, amplitude=10.0, stdnoise=1.0):
    """
    Generate a time series containing a periodic train of von Mises pulses
    plus white noise; useful for tests and benchmarks.

    ``amplitude`` is the true signal amplitude as defined in the FFA paper:
    the expected S/N with an exactly matched filter is
    amplitude / stdnoise. The pulse train has unit L2 norm before scaling
    (reference: riptide/libffa.py:15-68). The noise comes from
    ``numpy.random`` (seed it with ``numpy.random.seed``).

    Parameters
    ----------
    nsamp : int
        Number of samples.
    period : float
        Period in number of samples.
    phi0 : float, optional
        Initial pulse phase in periods.
    ducy : float, optional
        Duty cycle (FWHM / period) of the von Mises pulse.
    amplitude : float, optional
        L2 norm of the noiseless pulse train.
    stdnoise : float, optional
        Standard deviation of the additive Gaussian noise; 0 for a
        noiseless signal.

    Returns
    -------
    ndarray, float
    """
    # von Mises concentration giving the requested FWHM/period ratio
    kappa = np.log(2.0) / (2.0 * np.sin(np.pi * ducy / 2.0) ** 2)
    phase_radians = (np.arange(nsamp, dtype=float) / period - phi0) * (2 * np.pi)
    signal = np.exp(kappa * (np.cos(phase_radians) - 1.0))
    signal *= amplitude * (signal**2).sum() ** -0.5
    if stdnoise > 0.0:
        signal = signal + np.random.normal(size=nsamp, loc=0.0, scale=stdnoise)
    return signal
