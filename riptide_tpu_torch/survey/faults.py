"""
Fault injection for the batch searcher (the part of the JAX package's
``survey/faults.py`` that fires on the pipeline's stream path).

Degraded inputs (NaN blocks from upstream excision) and device memory
exhaustion are rare and unreproducible, so the data-quality masking and
the OOM bisection are exercised through an injected :class:`FaultPlan`,
configured from a spec string (the pipeline's ``--fault-inject``).
That keeps those paths testable on the CPU.

Spec grammar: comma-separated directives, each
``kind:chunk[:arg][xN]`` —

* ``nan_inject:0``  overwrite a contiguous block of chunk 0's loaded
  samples with NaN *before* the data-quality scan (arg = block
  fraction, default 0.05; consumed once per loaded file, so ``xN``
  covers N files of the chunk);
* ``oom:4``         raise a simulated out-of-memory error whenever a
  device batch LARGER than 4 DM trials is queued (the "chunk" field is
  a batch-size floor here, not a chunk id): ``oom:0`` fails the first
  full batch once, ``oom:1x8`` keeps failing until batches bisect down
  to single trials.

The JAX package's scheduler kinds (raise, stall, abort, corrupt, hang,
straggle, the storage kinds, ...) act only on journaled runs, which the
port does not have yet: a spec that names one is refused.

Example: ``--fault-inject nan_inject:0,oom:0``.
"""
import logging
import re
import threading

import numpy as np

__all__ = ["FaultPlan", "InjectedOOM"]

log = logging.getLogger("riptide_tpu_torch.survey.faults")

_KINDS = ("nan_inject", "oom")

_TIMES_RE = re.compile(r"x(\d+)$")


class InjectedOOM(RuntimeError):
    """Simulated device memory exhaustion: the message carries the
    RESOURCE_EXHAUSTED marker, so it routes through the same
    ``search.engine.is_oom_error`` detection as a real
    ``torch.cuda.OutOfMemoryError``."""

    def __init__(self, batch_size, floor):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device OOM on a "
            f"{batch_size}-trial batch (floor {floor})"
        )


class FaultPlan:
    """Parsed fault directives, consumed as the batcher hits their
    trigger points. Trigger methods are thread-safe: the batcher's
    loader pool fires ``nan_inject`` concurrently."""

    def __init__(self, directives=()):
        # directive: dict(kind, chunk, arg, remaining)
        self._directives = [dict(d) for d in directives]
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec):
        """Build a plan from a spec string; None/empty -> inert plan."""
        directives = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            times = 1
            m = _TIMES_RE.search(part.rsplit(":", 1)[-1])
            if m:
                part = part[: -len(m.group(0))]
                times = int(m.group(1))
            bits = part.split(":")
            if len(bits) < 2 or bits[0] not in _KINDS:
                raise ValueError(
                    f"bad fault directive {part!r}: expected "
                    f"kind:chunk[:arg][xN] with kind in {_KINDS}"
                )
            directives.append({
                "kind": bits[0], "chunk": int(bits[1]),
                "arg": float(bits[2]) if len(bits) > 2 else None,
                "remaining": times,
            })
        return cls(directives)

    def _take(self, kind, chunk_id):
        with self._lock:
            for d in self._directives:
                if d["kind"] == kind and d["chunk"] == chunk_id \
                        and d["remaining"] > 0:
                    d["remaining"] -= 1
                    return d
        return None

    def nan_inject(self, chunk_id, data):
        """Called per loaded file, BEFORE the data-quality scan:
        overwrite a contiguous block of ``data`` (float array, modified
        in place) with NaN. Block length is ``arg`` (default 0.05) of
        the series; the block starts a third of the way in so it lands
        well inside any detrending window. Returns True when injected."""
        d = self._take("nan_inject", chunk_id)
        if d is None or data.size == 0:
            return False
        frac = d["arg"] if d["arg"] is not None else 0.05
        n = max(1, int(round(frac * data.size)))
        start = min(data.size // 3, data.size - n)
        data[start : start + n] = np.nan
        log.warning(
            "fault injection: NaN block of %d samples (%.1f%%) into a "
            "chunk-%d series", n, 100.0 * n / data.size, chunk_id,
        )
        return True

    def maybe_oom(self, batch_size):
        """Called before every device-batch execution attempt: raise a
        simulated out-of-memory error while an ``oom`` directive with a
        batch-size floor below ``batch_size`` has firings left."""
        with self._lock:
            for d in self._directives:
                if d["kind"] == "oom" and d["remaining"] > 0 \
                        and batch_size > d["chunk"]:
                    d["remaining"] -= 1
                    floor = d["chunk"]
                    break
            else:
                return
        log.warning("fault injection: device OOM on a %d-trial batch",
                    batch_size)
        raise InjectedOOM(batch_size, floor)
