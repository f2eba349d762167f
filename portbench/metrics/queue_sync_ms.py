"""Dispatch: host milliseconds a chunk of the blocking CUDA calls
(``portbench.spans.SYNC_CALLS``) made inside the program's ``stages``,
``assemble`` and ``peaks`` spans, that is inside
``queue_search_batch``. From the profiler's trace, with the program's
tracer on."""
from portbench.spans import sync_calls


def read(rec):
    calls = sync_calls(rec["records"], rec["span"])
    if not calls or not rec["chunks"]:
        return None
    return sum(r["dur"] for r, _ in calls) * 1e-3 / rec["chunks"]
