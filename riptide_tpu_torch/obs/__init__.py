"""
Observability: the span tracer of the survey path
(:mod:`riptide_tpu_torch.obs.trace`).
"""
