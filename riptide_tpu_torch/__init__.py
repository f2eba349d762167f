"""
riptide_tpu_torch: the FFA pulsar search of ``riptide_tpu`` ported to
PyTorch and CUDA for an NVIDIA H100.

The periodogram search (:func:`ffa_search`, :func:`run_periodogram`,
:func:`run_periodogram_batch`) and the survey batch with device peaks
(:func:`run_search_batch`) run on the card by default: each cascade
stage goes through hand-written CUDA kernels
(``riptide_tpu_torch/csrc/ffa_stage.cu``, built with nvcc at first use).
Pass ``device="cpu"`` to run the plain PyTorch versions instead. The
host wire preparation runs in the native threaded runtime
(``riptide_tpu_torch/native``, built with g++ at first use), numpy when
it did not build. Series are loaded from PRESTO, SIGPROC, binary and
.npy files (``TimeSeries.from_presto_inf`` and friends), and data
products round-trip through JSON (:func:`save_json`,
:func:`load_json`). The multi-DM pipeline (``rffa``,
:mod:`riptide_tpu_torch.pipeline`) turns DM-trial files into
:class:`Candidate` products, and ``rseek``
(:mod:`riptide_tpu_torch.apps.rseek`) searches one series; neither needs
pandas, PyYAML or matplotlib unless asked to read a YAML file or plot.
The survey service (:mod:`riptide_tpu_torch.serve`, ``rserve``) runs
jobs submitted over HTTP in fair-share turns on the card.
The package imports neither jax nor ``riptide_tpu``.
"""
from .candidate import Candidate
from .ffautils import generate_width_trials
from .libffa import (boxcar_snr, downsample, ffa1, ffa2, ffafreq, ffaprd,
                     generate_signal)
from .metadata import Metadata
from .periodogram import Periodogram
from .peak_detection import Peak, find_peaks
from .quality import (DegradedInputWarning, DQConfig, MalformedFile,
                      QualityReport, QuarantinedSeries)
from .search import (ffa_search, periodogram_plan, plan_arrays,
                     plan_from_arrays, run_periodogram, run_periodogram_batch,
                     run_search_batch)
from .running_medians import fast_running_median, running_median
from .serialization import load_json, save_json
from .table import Table
from .time_series import TimeSeries

__version__ = "0.14.0"

__all__ = [
    "TimeSeries",
    "Periodogram",
    "Metadata",
    "ffa_search",
    "periodogram_plan",
    "plan_arrays",
    "plan_from_arrays",
    "run_periodogram",
    "run_periodogram_batch",
    "run_search_batch",
    "Peak",
    "find_peaks",
    "Candidate",
    "Table",
    "generate_width_trials",
    "generate_signal",
    "ffa1",
    "ffa2",
    "ffafreq",
    "ffaprd",
    "boxcar_snr",
    "downsample",
    "running_median",
    "fast_running_median",
    "save_json",
    "load_json",
    "DegradedInputWarning",
    "DQConfig",
    "MalformedFile",
    "QualityReport",
    "QuarantinedSeries",
]


def test():
    """Run the port's tests in-process with pytest; returns pytest's exit
    code. The suite is found by path: ``tests/`` beside the package in a
    checkout, ``riptide_tpu/tests/`` in an installed tree (never imported:
    that would import the JAX package). On a host with a CUDA card, or
    without jax, only the card's ``test_torch_*_cuda.py`` files run,
    without the suite's conftest (which imports jax): the JAX package
    never runs beside the card. On a CPU host with jax, every
    ``test_torch_*.py`` runs, each port module held against the JAX
    package."""
    import glob
    import importlib.util
    import os

    import pytest
    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in (os.path.join(root, "tests"),
                 os.path.join(root, "riptide_tpu", "tests")):
        if glob.glob(os.path.join(path, "test_torch_*.py")):
            break
    else:
        raise RuntimeError("riptide_tpu_torch.test(): no test directory "
                           "found")
    if torch.cuda.is_available() or importlib.util.find_spec("jax") is None:
        files = glob.glob(os.path.join(path, "test_torch_*_cuda.py"))
        opts = ["--noconftest"]
    else:
        files = glob.glob(os.path.join(path, "test_torch_*.py"))
        opts = []
    return pytest.main(["-q", *opts, *sorted(files)])
