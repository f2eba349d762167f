"""
The survey layer (the port's copies of the JAX package's ``survey/``
modules): the checkpointed scheduler over DM-trial chunks
(:mod:`~riptide_tpu_torch.survey.scheduler`), its journal
(:mod:`~riptide_tpu_torch.survey.journal`), the watchdog and the
classification of the card's errors
(:mod:`~riptide_tpu_torch.survey.liveness`), result integrity
(:mod:`~riptide_tpu_torch.survey.integrity`), fault injection
(:mod:`~riptide_tpu_torch.survey.faults`), incident records and the
metrics registry. The chaos campaign waits for a later slice.
"""
