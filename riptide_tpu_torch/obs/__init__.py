"""
Observability of the survey path (the port's copies of the JAX
package's ``obs/`` modules):

* :mod:`~riptide_tpu_torch.obs.trace` — the span tracer (``with
  span("phase", chunk=3):``), near-free while disabled
  (``RIPTIDE_TRACE=1``, :func:`~riptide_tpu_torch.obs.trace.enable`
  or ``--trace`` turn it on);
* :mod:`~riptide_tpu_torch.obs.chrome` — its Chrome trace-event export
  (``trace.json`` next to the journal, Perfetto-loadable);
* :mod:`~riptide_tpu_torch.obs.schema` — the journal's per-chunk
  ``timing`` and ``integrity`` blocks;
* :mod:`~riptide_tpu_torch.obs.prom` — Prometheus text exposition of
  the metrics registry (``RIPTIDE_PROM_TEXTFILE``) and the localhost
  ``/metrics`` / ``/status`` / ``/healthz`` endpoint
  (``RIPTIDE_PROM_PORT``), which also carries the survey service's
  ``/jobs`` and ``/drain`` (:mod:`riptide_tpu_torch.serve`);
* :mod:`~riptide_tpu_torch.obs.alerts`,
  :mod:`~riptide_tpu_torch.obs.fleet` and
  :mod:`~riptide_tpu_torch.obs.ledger` — the alert rules, the
  per-process fleet sidecars and the perf ledger (``RIPTIDE_ALERTS``,
  ``RIPTIDE_FLEET``, ``RIPTIDE_LEDGER``);
* :mod:`~riptide_tpu_torch.obs.report` — the readers: the ones the
  scheduler uses (journal follower, fleet merge, the alert signal
  vector) and the post-run report with its ledger comparison, behind
  the ``rreport``, ``rtop`` and ``rwatch`` CLIs
  (``riptide_tpu_torch/apps/``), and a service directory's job table.

The card's own timeline is ``torch.profiler``'s
(:func:`riptide_tpu_torch.timing.maybe_trace`); spans cover the host.
"""
from .trace import (  # noqa: F401
    NULL_SPAN, Span, Tracer, current_span_id, disable, enable, enabled,
    get_tracer, set_tracer, span,
)
from .chrome import (  # noqa: F401
    chrome_events, export_run_trace, merge_chrome_traces,
    rotate_trace_file, write_chrome_trace,
)
from .prom import (  # noqa: F401
    health_check, maybe_serve, maybe_write_textfile, render, serve,
    set_fleet_source, set_status_provider, status_snapshot, write_prom,
)
from .ledger import (  # noqa: F401
    append_row, make_row, maybe_append, read_rows,
)
from .alerts import (  # noqa: F401
    AlertEngine, AlertRule, default_rules, get_engine, install_engine,
    rules_from_spec,
)
from .fleet import (  # noqa: F401
    FLEET_VERSION, fleet_path, write_snapshot,
)
from .report import (  # noqa: F401
    build_report, compare_to_ledger, merge_fleet, read_fleet,
    render_text, run_decomposition_from_chunks, watch_snapshot,
)
from .schema import (  # noqa: F401
    CHUNK_TIMING_KEYS, DECOMPOSITION_KEYS, LEGACY_ALIASES, PHASES,
    TIMING_VERSION, chunk_timing, classify_bound, decomposition,
)

__all__ = [
    "span", "enable", "disable", "enabled", "get_tracer", "set_tracer",
    "current_span_id", "Span", "Tracer", "NULL_SPAN",
    "chrome_events", "write_chrome_trace", "merge_chrome_traces",
    "export_run_trace", "rotate_trace_file",
    "render", "write_prom", "serve", "maybe_serve", "maybe_write_textfile",
    "set_status_provider", "set_fleet_source", "status_snapshot",
    "health_check",
    "make_row", "append_row", "maybe_append", "read_rows",
    "AlertEngine", "AlertRule", "default_rules", "rules_from_spec",
    "install_engine", "get_engine",
    "FLEET_VERSION", "fleet_path", "write_snapshot",
    "build_report", "render_text", "compare_to_ledger",
    "read_fleet", "merge_fleet", "watch_snapshot",
    "run_decomposition_from_chunks",
    "TIMING_VERSION", "PHASES", "DECOMPOSITION_KEYS", "CHUNK_TIMING_KEYS",
    "LEGACY_ALIASES", "decomposition", "chunk_timing", "classify_bound",
]
