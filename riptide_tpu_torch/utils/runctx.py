"""
Job-scoped run contexts (the port's copy of the JAX package's
``utils/runctx.py``).

Three run-shaped hooks are process-global: the incident sink
(``survey.incidents.set_sink``), the live status provider
(``obs.prom.set_status_provider``) and the fsio storage-fault hook
(``utils.fsio.set_storage_faults``). With several runs in one process
the last one started would own them, so a sibling's incidents could
journal into the wrong run's directory.

A :class:`RunContext` carries those three hooks for the run that owns
the *current thread*. ``SurveyScheduler.run()`` installs one for the
calling thread and threads it into its stager/loader pool and its
watchdog threads via :func:`wrap`. Resolution everywhere is *context
first, process-global second*: the process-wide setters remain the
fallback layer, so batch CLI paths behave the same with no context
installed.

The module is stdlib-only on purpose: ``utils.fsio`` (itself
stdlib-only) imports it at module scope.
"""
import contextlib
import threading

__all__ = ["RunContext", "activate", "current", "install", "wrap"]

_MISSING = object()


class RunContext:
    """The hook bundle of one run: incident sink, status provider and
    storage-fault plan, plus the run's own last-incident slot so a
    concurrent sibling can never clobber this run's ``/status`` tail.

    Every field is optional — a ``None`` hook falls through to the
    process-global layer for that hook only.
    """

    __slots__ = ("incident_sink", "status_provider", "storage_faults",
                 "label", "_last_incident", "_lock")

    def __init__(self, incident_sink=None, status_provider=None,
                 storage_faults=None, label=None):
        self.incident_sink = incident_sink
        self.status_provider = status_provider
        self.storage_faults = storage_faults
        self.label = label
        self._last_incident = None
        self._lock = threading.Lock()

    def note_incident(self, rec):
        with self._lock:
            self._last_incident = dict(rec)

    def last_incident(self):
        with self._lock:
            rec = self._last_incident
        return dict(rec) if rec is not None else None

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"RunContext(label={self.label!r})"


_tls = threading.local()


def current():
    """The :class:`RunContext` owning the calling thread, or None."""
    return getattr(_tls, "ctx", None)


def install(ctx):
    """Install ``ctx`` (or None) on the calling thread; returns the
    previously installed context so callers can restore it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


@contextlib.contextmanager
def activate(ctx):
    """``with activate(ctx): ...`` — install for the block, restore
    the previous context after (exception-safe)."""
    prev = install(ctx)
    try:
        yield ctx
    finally:
        install(prev)


def wrap(fn, ctx=_MISSING):
    """Bind a context into ``fn`` for execution on ANOTHER thread.

    Captures the *caller's* current context (or an explicit ``ctx``)
    and returns a callable that installs it around the real call —
    the inheritance shim for ``ThreadPoolExecutor.submit``/``map``
    workers, watchdog sacrificial threads and liveness beaters, whose
    thread-locals would otherwise be empty.
    """
    bound = current() if ctx is _MISSING else ctx

    def _inherit(*args, **kwargs):
        prev = install(bound)
        try:
            return fn(*args, **kwargs)
        finally:
            install(prev)

    return _inherit
