"""
riplint over the port: the shared static-analysis framework of the JAX
package (``riptide_tpu/analysis/``), retargeted at
``riptide_tpu_torch/``.

A single AST walk over the package feeds the per-module analyzers, and
one shared :class:`~.core.ProjectContext` (a name-resolved
whole-program call graph: imports, self-attribute types, thread
targets) feeds the interprocedural ones. Each analyzer keeps the JAX
package's rule id and name (held equal by tests/test_torch_riplint.py):

========  ==========================  =====================================
RIP001    host-sync                   no host synchronisation (.item/.cpu/
                                      .numpy, casts of tensors, data-
                                      dependent shapes, synchronize, numpy
                                      pulls) in the queueing hot paths
RIP002    dtype-discipline            explicit dtypes (by keyword for
                                      torch) and cumsum accumulators in
                                      ops/ and the engine/peaks paths
RIP003    env-flags                   every RIPTIDE_* read routes through
                                      the port's utils/envflags.py registry
                                      (stale entries + docs drift checked)
RIP004    lock-discipline             no blocking call while holding a
                                      lock, no untimed join()/wait(),
                                      explicit Thread daemon flags
RIP005    pallas-layout               every CUDA launch after its operands'
                                      shape checks; no host nondeterminism
                                      in launch arguments
RIP006    finite-guards               data entry points route through the
                                      quality layer
RIP007    liveness-guards             torch.distributed collectives route
                                      through the bounded-wait wrappers
RIP008    obs-discipline              span() only as a context manager, no
                                      tracing in a launch sequence, every
                                      RIPTIDE_TRACE_*/RIPTIDE_PROM_* flag
                                      registered
RIP009    lock-order                  whole-program lock-order cycles and
                                      lock-free writes to guarded state
RIP010    record-schema               journal/ledger/incident keys and
                                      kinds a reader consumes are emitted
RIP011    interp-host-sync            RIP001 lifted to reachability from
                                      the stage loop and the peak program
RIP012    runctx-discipline           threads of the serve/survey planes
                                      carry a run context
RIP013    fsio-discipline             survey/obs/serve write durable bytes
                                      only through utils/fsio.py
RIP014    gate-pairing                chunk_gate begin/end, StagingPool
                                      acquire/release and integrity
                                      begin_fold/finish_fold pair on
                                      every path
========  ==========================  =====================================

Run with ``python -m riptide_tpu_torch.apps.riplint`` (GitHub-annotation
output, ``riptide_tpu_torch/analysis/riplint_baseline.json`` with a
one-line justification per entry, ``# riplint: disable=RIPxxx`` inline
suppressions). This package imports the standard library alone: the
runner loads it by file path, with neither torch nor numpy importable.
"""
from .core import (  # noqa: F401
    PACKAGE, SURFACES, Analyzer, Baseline, Finding, FunctionInfo,
    ModuleContext, ProjectContext, collect_contexts, run_analyzers,
    surface_files,
)
from . import env_flags  # noqa: F401
from .host_sync import HostSyncAnalyzer
from .dtype_discipline import DtypeDisciplineAnalyzer
from .env_flags import EnvFlagAnalyzer
from .lock_discipline import LockDisciplineAnalyzer
from .launch_layout import LaunchLayoutAnalyzer
from .finite_guards import FiniteGuardAnalyzer
from .liveness_guards import LivenessGuardAnalyzer
from .obs_discipline import ObsDisciplineAnalyzer
from .lock_order import LockOrderAnalyzer
from .record_schema import RecordSchemaAnalyzer
from .interp_host_sync import InterpHostSyncAnalyzer
from .runctx_discipline import RunctxDisciplineAnalyzer
from .fsio_discipline import FsioDisciplineAnalyzer
from .gate_pairing import GatePairingAnalyzer

ALL_ANALYZERS = (
    HostSyncAnalyzer,
    DtypeDisciplineAnalyzer,
    EnvFlagAnalyzer,
    LockDisciplineAnalyzer,
    LaunchLayoutAnalyzer,
    FiniteGuardAnalyzer,
    LivenessGuardAnalyzer,
    ObsDisciplineAnalyzer,
    LockOrderAnalyzer,
    RecordSchemaAnalyzer,
    InterpHostSyncAnalyzer,
    RunctxDisciplineAnalyzer,
    FsioDisciplineAnalyzer,
    GatePairingAnalyzer,
)

__all__ = [
    "ALL_ANALYZERS", "PACKAGE", "SURFACES", "Analyzer", "Baseline",
    "Finding", "FunctionInfo", "ModuleContext", "ProjectContext",
    "collect_contexts", "run_analyzers", "surface_files",
] + [a.__name__ for a in ALL_ANALYZERS]
