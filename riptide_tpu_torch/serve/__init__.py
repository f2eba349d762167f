"""
Survey-as-a-service: a warm, multi-tenant daemon over the batch
scheduler (the port's copy of the JAX package's ``serve/``).

``python -m riptide_tpu_torch.apps.rserve`` starts a
:class:`~riptide_tpu_torch.serve.daemon.ServeDaemon` on the card; clients
submit jobs over the loopback HTTP endpoint (``POST /jobs``) or with
``rseek --submit``.
"""
from .daemon import GeometryPins, JobRegistry, ServeDaemon
from .queue import (FairShareQueue, JobCancelled, JobDeadlineExceeded,
                    JobDrained, QuotaExceeded)
from .tenants import TenantTable

__all__ = ["ServeDaemon", "JobRegistry", "GeometryPins", "FairShareQueue",
           "TenantTable", "JobCancelled", "JobDeadlineExceeded",
           "JobDrained", "QuotaExceeded"]
