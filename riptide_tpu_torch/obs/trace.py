"""
Thread-safe span tracer for the survey path (the port's copy of the JAX
package's ``obs/trace.py``, with everything its Chrome export and the
incident records read).

``with span("phase", chunk=3):`` records one *complete* span — name,
monotonic start, duration, thread id, attributes — into a bounded ring
buffer on the process-wide :class:`Tracer`. Spans nest naturally
(per-thread span stacks), and a child span inherits its innermost
ancestor's ``chunk`` attribute so engine-level spans that cannot see
the chunk id still attribute to the right chunk in the exported trace.

The design constraint is the DISABLED cost: tracing is off by default
and every hot path calls :func:`span` unconditionally, so the disabled
path must be near-free. With no tracer installed, :func:`span` returns
a shared no-op singleton — no Span object, no ring append, nothing
retained — and the only cost is one global load, one ``is None`` test
and an (immediately-freed) empty kwargs dict.

Enable programmatically (:func:`enable`) or via the envflags registry:
``RIPTIDE_TRACE=1`` installs a tracer at import time with a
``RIPTIDE_TRACE_RING``-entry ring buffer. Clocks are monotonic
(``time.perf_counter``); the tracer also stamps one UTC wall-clock
anchor at creation so exporters can place the monotonic timeline in
absolute time without ever mixing the two clock domains.

Recording happens once per span *exit* (the span's working state lives
on the Python stack), so the per-span cost when enabled is two clock
reads, two list ops and one locked deque append — microseconds against
the millisecond-to-minute phases it instruments. Spans time *host-side*
phases; the card's timeline is ``torch.profiler``'s job
(``timing.maybe_trace``).

While ``torch.profiler`` records, each span entered also opens
a ``record_function`` named ``riptide.<span name>`` (plus the value of
the span's ``stage`` or ``range`` attribute, as in
``riptide.ffa_stage.7`` or ``riptide.range.short``), closed
when the span exits. The span then lies in the profiler's own trace as
a ``user_annotation`` on the profiler's clock, around the CUDA runtime
calls it made, whose ``correlation`` names the kernels they launched.
Whether the profiler records is read once per span entered, and only with
a tracer installed: the disabled path above gains nothing. The ring,
its ``perf_counter`` stamps and the Chrome export
(:mod:`~riptide_tpu_torch.obs.chrome`) are the same either way.
"""
import itertools
import sys
import threading
import time
from collections import deque

from ..utils import envflags

__all__ = ["Span", "Tracer", "span", "enable", "disable", "enabled",
           "get_tracer", "set_tracer", "current_span_id", "NULL_SPAN"]

# Attribute keys a nested span inherits from its innermost enclosing
# span when it does not set them itself (chunk attribution for
# engine-level spans that cannot see the scheduler's chunk id).
INHERIT_ATTRS = ("chunk",)

# Prefix of a span's name in the profiler's trace, and the attribute
# keys whose values join it there (they tell sibling spans apart:
# ``riptide.ffa_stage.7``, ``riptide.range.short``).
PROFILER_PREFIX = "riptide."
LABEL_ATTRS = ("stage", "range")


def _recording_profiler():
    """torch's ``autograd.profiler`` module while a ``torch.profiler``
    profile records, else None. A process that never imported torch
    records nothing, so this never imports it."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


class _NullSpan:
    """Shared no-op span returned while tracing is disabled. One
    instance serves every call site: entering/exiting it touches no
    shared state and allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One in-flight span; becomes a ring-buffer event on ``__exit__``.

    Use only as a context manager (``with span(...) as s:``) — manual
    ``__enter__`` without a guaranteed ``__exit__`` leaks the
    per-thread stack entry.

    Every entered span draws a process-unique ``sid`` from the tracer's
    counter; the Chrome export carries it as ``span_id`` and the
    journal's ``incident`` records reference it
    (:func:`current_span_id`), so an incident row can be correlated
    with the exact span that was open when it fired.
    """

    __slots__ = ("name", "attrs", "t0", "tid", "sid", "_tracer", "_rf")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Attach/overwrite attributes while the span is open."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        if stack and INHERIT_ATTRS:
            parent = stack[-1].attrs
            for key in INHERIT_ATTRS:
                if key in parent and key not in self.attrs:
                    self.attrs[key] = parent[key]
        stack.append(self)
        self.tid = threading.get_ident()
        self.sid = next(tr._ids)
        self._rf = None
        prof = _recording_profiler()
        if prof is not None:
            self._rf = prof.record_function(self._label())
            self._rf.__enter__()
        self.t0 = tr._clock()
        return self

    def _label(self):
        """The span's name in the profiler's trace: ``riptide.<name>``,
        then the value of each :data:`LABEL_ATTRS` key it has."""
        label = PROFILER_PREFIX + self.name
        for key in LABEL_ATTRS:
            if key in self.attrs:
                label += f".{self.attrs[key]}"
        return label

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        dur = tr._clock() - self.t0
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        stack = tr._stack()
        # Tolerate a torn stack (a span closed out of order under an
        # exception storm) rather than corrupting sibling entries.
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        tr._record(self.name, self.t0, dur, self.tid, self.attrs,
                   self.sid)
        return False


class Tracer:
    """Bounded ring buffer of completed spans.

    Parameters
    ----------
    capacity : int
        Ring size; the oldest spans fall off when a long survey
        overflows it (``dropped_events`` counts them, so a truncated
        export is detectable rather than silently partial).
    """

    def __init__(self, capacity=None, clock=time.perf_counter):
        if capacity is None:
            capacity = envflags.get("RIPTIDE_TRACE_RING")
        self.capacity = int(capacity)
        self._events = deque(maxlen=self.capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._recorded = 0
        self._thread_names = {}
        # Process-unique span ids (drawn at span __enter__; CPython's
        # itertools.count.__next__ is atomic, no lock needed). They link
        # incident records to the span open when the incident fired.
        self._ids = itertools.count(1)
        # Trace-file paths export_run_trace has already written from
        # THIS tracer: a same-run re-export overwrites in place, while
        # a fresh process (a resumed run) rotates the prior attempt's
        # file to <path>.1 instead of destroying it.
        self.exported_paths = set()
        # Paired monotonic/UTC anchors: every event timestamp is
        # monotonic-relative to t0; wall_t0 places t0 in absolute time.
        self.t0 = clock()
        self.wall_t0 = time.time()

    # -- recording ----------------------------------------------------------

    def span(self, name, **attrs):
        """An un-entered :class:`Span` bound to this tracer (the
        module-level :func:`span` is the normal entry point)."""
        return Span(self, name, attrs)

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name, t0, dur, tid, attrs, sid):
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append((name, t0 - self.t0, dur, tid, attrs, sid))
            self._recorded += 1

    # -- reading ------------------------------------------------------------

    def events(self):
        """Snapshot of the ring: ``[(name, ts_s, dur_s, tid, attrs,
        sid), ...]`` with ``ts_s`` seconds since the tracer's monotonic
        anchor, oldest first, and ``sid`` the process-unique span id."""
        with self._lock:
            return list(self._events)

    def thread_names(self):
        """``{tid: thread name}`` for every thread that recorded."""
        with self._lock:
            return dict(self._thread_names)

    @property
    def recorded(self):
        """Total spans recorded (including ones the ring has dropped)."""
        with self._lock:
            return self._recorded

    @property
    def dropped_events(self):
        """Spans pushed out of the bounded ring by newer ones."""
        with self._lock:
            return max(0, self._recorded - len(self._events))

    def phase_totals(self):
        """``{span name: total seconds}`` over the ring — a quick
        sanity cross-check against the metrics registry's timers."""
        out = {}
        for name, _, dur, _, _, _ in self.events():
            out[name] = out.get(name, 0.0) + dur
        return out

    def clear(self):
        with self._lock:
            self._events.clear()
            self._recorded = 0


# Process-wide active tracer; None = tracing disabled (the fast path).
_tracer = None


def span(name, **attrs):
    """A context manager timing the enclosed block as one span.

    Disabled (no tracer installed): returns the shared
    :data:`NULL_SPAN` singleton and records nothing. Enabled: returns
    a fresh :class:`Span` recording into the active tracer's ring.
    """
    tr = _tracer
    if tr is None:
        return NULL_SPAN
    return Span(tr, name, attrs)


def enable(capacity=None):
    """Install (and return) a fresh process-wide tracer. Idempotent in
    effect: an existing tracer is replaced, not appended to."""
    global _tracer
    _tracer = Tracer(capacity=capacity)
    return _tracer


def disable():
    """Remove the active tracer (spans become no-ops again); returns
    the removed tracer so callers can still export its ring."""
    global _tracer
    prev, _tracer = _tracer, None
    return prev


def enabled():
    return _tracer is not None


def get_tracer():
    """The active tracer, or None while tracing is disabled."""
    return _tracer


def current_span_id():
    """The ``sid`` of the calling thread's innermost OPEN span, or None
    when tracing is disabled or no span is open. Incident records
    attach it so a journal incident can be correlated with the exact
    span in the exported trace (where it appears as ``span_id``)."""
    tr = _tracer
    if tr is None:
        return None
    stack = tr._stack()
    return stack[-1].sid if stack else None


def set_tracer(tracer):
    """Install a specific tracer (tests); returns the previous one."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


# RIPTIDE_TRACE=1 turns tracing on for the whole process at import
# time — one registry read here instead of one per span() call keeps
# the disabled fast path free of environment lookups.
if envflags.get("RIPTIDE_TRACE"):
    enable()
