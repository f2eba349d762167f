"""Milliseconds a chunk the host spends in ``collect_search_batch`` (the wait, the pull and the host tail), the mean over
every chunk of the window (harness timer)."""


def read(rec):
    times = rec["host"]["collect_s"]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
