"""
Thread-safe span tracer for the survey path (the part of the JAX
package's ``obs/trace.py`` that the pipeline reaches; its Chrome and
Prometheus exporters come later).

``with span("phase", chunk=3):`` records one *complete* span — name,
monotonic start, duration, thread id, attributes — into a bounded ring
buffer on the process-wide :class:`Tracer`. Spans nest (per-thread span
stacks), and a child span inherits its innermost ancestor's ``chunk``
attribute.

Tracing is off until :func:`enable`, and every hot path calls
:func:`span` unconditionally, so the disabled path returns a shared
no-op singleton and retains nothing. Clocks are monotonic
(``time.perf_counter``). Spans time host-side phases; the device's
timeline is ``timing.device_trace``'s job.
"""
import itertools
import threading
import time
from collections import deque

__all__ = ["Span", "Tracer", "span", "enable", "disable", "enabled",
           "get_tracer", "current_span_id", "NULL_SPAN", "RING"]

# Spans the ring keeps: a long run drops the oldest, so memory stays flat.
RING = 65536

# Attribute keys a nested span inherits from its innermost enclosing
# span when it does not set them itself.
INHERIT_ATTRS = ("chunk",)


class _NullSpan:
    """Shared no-op span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One in-flight span; becomes a ring-buffer event on ``__exit__``.
    Use only as a context manager. Every entered span draws a
    process-unique ``sid``; incident records reference it
    (:func:`current_span_id`)."""

    __slots__ = ("name", "attrs", "t0", "tid", "sid", "_tracer")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        if stack:
            parent = stack[-1].attrs
            for key in INHERIT_ATTRS:
                if key in parent and key not in self.attrs:
                    self.attrs[key] = parent[key]
        stack.append(self)
        self.tid = threading.get_ident()
        self.sid = next(tr._ids)
        self.t0 = tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        dur = tr._clock() - self.t0
        stack = tr._stack()
        # Tolerate a torn stack (a span closed out of order under an
        # exception) rather than corrupting sibling entries.
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        tr._record(self.name, self.t0, dur, self.tid, self.attrs, self.sid)
        return False


class Tracer:
    """Bounded ring buffer of completed spans."""

    def __init__(self, capacity=RING, clock=time.perf_counter):
        self._events = deque(maxlen=int(capacity))
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        # Process-unique span ids (itertools.count.__next__ is atomic).
        self._ids = itertools.count(1)
        self.t0 = clock()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name, t0, dur, tid, attrs, sid):
        with self._lock:
            self._events.append((name, t0 - self.t0, dur, tid, attrs, sid))

    def events(self):
        """Snapshot of the ring: ``[(name, ts_s, dur_s, tid, attrs,
        sid), ...]`` with ``ts_s`` seconds since the tracer's monotonic
        anchor, oldest first."""
        with self._lock:
            return list(self._events)


# Process-wide active tracer; None = tracing disabled (the fast path).
_tracer = None


def span(name, **attrs):
    """A context manager timing the enclosed block as one span: the
    shared :data:`NULL_SPAN` while tracing is disabled, else a fresh
    :class:`Span` recording into the active tracer's ring."""
    tr = _tracer
    if tr is None:
        return NULL_SPAN
    return Span(tr, name, attrs)


def enable():
    """Install (and return) a fresh process-wide tracer."""
    global _tracer
    _tracer = Tracer()
    return _tracer


def disable():
    """Remove the active tracer; returns it so its ring can be read."""
    global _tracer
    prev, _tracer = _tracer, None
    return prev


def enabled():
    return _tracer is not None


def get_tracer():
    """The active tracer, or None while tracing is disabled."""
    return _tracer


def current_span_id():
    """The ``sid`` of the calling thread's innermost open span, or None
    when tracing is disabled or no span is open."""
    tr = _tracer
    if tr is None:
        return None
    stack = tr._stack()
    return stack[-1].sid if stack else None
