"""Milliseconds a chunk the host spends in ``ship_stage_data`` on the ship thread, the mean over
every chunk of the window (harness timer)."""


def read(rec):
    times = rec["host"]["ship_s"]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
