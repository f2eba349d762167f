"""End to end: every DM trial whose peaks reached the host in the
window, over the window's wall time from the first ship to the last
collect (host clock)."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return rec["collected_trials"] / rec["window_s"]
