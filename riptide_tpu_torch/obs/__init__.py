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
