"""Milliseconds a chunk the host spends in ``queue_search_batch`` (the stage launches, the assembly and the peak program queued), the mean over
every chunk of the window (harness timer)."""


def read(rec):
    times = rec["host"]["queue_s"]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
