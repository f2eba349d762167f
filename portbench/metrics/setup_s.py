"""End to end: seconds from the harness's first statement to the
window's first ship (host clock)."""


def read(rec):
    return rec["setup_s"]
