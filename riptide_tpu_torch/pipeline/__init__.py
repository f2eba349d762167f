"""
Multi-DM search pipeline: DM-trial selection, device-batched search,
peak clustering, harmonic flagging, candidate building and products.
Run as ``python -m riptide_tpu_torch.pipeline.pipeline``.
"""
from .pipeline import Pipeline, run_program, get_parser, main
from .dmiter import DMIterator, select_dms
from .batcher import BatchSearcher
from .peak_cluster import PeakCluster, clusters_to_dataframe
from .harmonic_testing import hdiag, htest
from .config_validation import (
    InvalidPipelineConfig,
    InvalidSearchRange,
    validate_pipeline_config,
    validate_ranges,
)

__all__ = [
    "Pipeline",
    "run_program",
    "get_parser",
    "main",
    "DMIterator",
    "select_dms",
    "BatchSearcher",
    "PeakCluster",
    "clusters_to_dataframe",
    "hdiag",
    "htest",
    "InvalidPipelineConfig",
    "InvalidSearchRange",
    "validate_pipeline_config",
    "validate_ranges",
]
