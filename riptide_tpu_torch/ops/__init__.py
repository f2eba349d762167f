"""
Compute ops of the PyTorch port: the numpy oracle (:mod:`.reference`),
host planning (:mod:`.plan`, :mod:`.downsample`), the plain PyTorch FFA,
S/N and running median, and the CUDA cascade-stage kernels
(:mod:`.ffa_kernel`, built at first use).
"""
from . import reference
from .downsample import (downsample_plan_padded, downsampled_size,
                         downsampled_variance)
from .ffa import ffa1, ffa2, ffa_levels, ffafreq, ffaprd
from .plan import FFABatchPlan, FFAPlan, batch_plans, ffa_plan, num_levels
from .running_median import (fast_running_median_torch, running_median_torch,
                             scrunch_torch)
from .snr import boxcar_coeffs, boxcar_snr, snr_batched

__all__ = ["ffa1", "ffa2", "ffa_levels", "ffafreq", "ffaprd",
           "FFABatchPlan", "FFAPlan", "batch_plans", "ffa_plan",
           "num_levels", "boxcar_coeffs", "boxcar_snr", "snr_batched",
           "downsample_plan_padded", "downsampled_size",
           "downsampled_variance", "running_median_torch", "scrunch_torch",
           "fast_running_median_torch"]
