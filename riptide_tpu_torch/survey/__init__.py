"""
The survey layer (the port's copies of the JAX package's ``survey/``
modules): the checkpointed scheduler over DM-trial chunks
(:mod:`~riptide_tpu_torch.survey.scheduler`), its journal
(:mod:`~riptide_tpu_torch.survey.journal`), the watchdog and the
classification of the card's errors
(:mod:`~riptide_tpu_torch.survey.liveness`), result integrity
(:mod:`~riptide_tpu_torch.survey.integrity`), fault injection
(:mod:`~riptide_tpu_torch.survey.faults`), incident records and the
metrics registry, and the storage-chaos campaign
(:mod:`~riptide_tpu_torch.survey.chaos`: kill-anywhere resume proved
with subprocess legs on one device).
"""

# The submodules import the engine, and the engine imports
# ``survey.metrics``: the namespace resolves its names at first use, so
# that importing the package closes no cycle.
_LAZY = {
    "SurveyJournal": "journal",
    "JournalMismatch": "journal",
    "SurveyScheduler": "scheduler",
    "RetryPolicy": "scheduler",
    "CircuitBreaker": "scheduler",
    "TransientChunkError": "scheduler",
    "FaultPlan": "faults",
    "FaultAbort": "faults",
    "ChunkWatchdog": "liveness",
    "ChunkTimeout": "liveness",
    "PeerTimeout": "liveness",
    "PeerLivenessMonitor": "liveness",
    "MetricsRegistry": "metrics",
    "get_metrics": "metrics",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
