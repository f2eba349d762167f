"""Device: the share of the traced window in which no kernel, copy or
set ran on the card, in %."""
from portbench.trace import device_events, union_us


def read(rec):
    span = rec["span"]
    if span is None or span[1] <= span[0]:
        return None
    busy = union_us(device_events(rec["records"], span))
    if not busy:
        return None
    return 100.0 * (1.0 - busy / (span[1] - span[0]))
