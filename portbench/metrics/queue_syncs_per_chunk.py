"""Dispatch: the blocking CUDA calls (``portbench.spans.SYNC_CALLS``) a
chunk made inside the program's ``stages``, ``assemble`` and ``peaks``
spans. From the profiler's trace, with the program's tracer on."""
from portbench.spans import sync_calls


def read(rec):
    calls = sync_calls(rec["records"], rec["span"])
    if not calls or not rec["chunks"]:
        return None
    return len(calls) / rec["chunks"]
