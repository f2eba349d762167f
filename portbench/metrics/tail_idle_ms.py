"""Device: milliseconds a chunk in which the card runs no kernel, copy
or set while the host is inside the program's ``tail`` span."""
from portbench.spans import tail_idle_us, tail_spans


def read(rec):
    span = rec["span"]
    if span is None or not rec["chunks"]:
        return None
    if not tail_spans(rec["records"], span):
        return None
    return tail_idle_us(rec["records"], span) * 1e-3 / rec["chunks"]
