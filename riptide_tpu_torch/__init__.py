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
from .libffa import boxcar_snr, ffa1, ffa2, ffafreq, ffaprd, generate_signal
from .metadata import Metadata
from .periodogram import Periodogram
from .peak_detection import Peak
from .quality import (DegradedInputWarning, DQConfig, MalformedFile,
                      QualityReport, QuarantinedSeries)
from .search import (ffa_search, periodogram_plan, plan_arrays,
                     plan_from_arrays, run_periodogram, run_periodogram_batch,
                     run_search_batch)
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
    "Candidate",
    "Table",
    "generate_width_trials",
    "generate_signal",
    "ffa1",
    "ffa2",
    "ffafreq",
    "ffaprd",
    "boxcar_snr",
    "save_json",
    "load_json",
    "DegradedInputWarning",
    "DQConfig",
    "MalformedFile",
    "QualityReport",
    "QuarantinedSeries",
]
