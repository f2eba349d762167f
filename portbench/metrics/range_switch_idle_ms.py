"""Device: milliseconds a chunk in which the card runs no kernel, copy
or set between the end of one search range's last kernel and the start
of the next range's first, summed over every switch of the window from
one range to the next, across chunks too (``portbench/range_blocks.py``).
None for a configuration without named ranges."""
from portbench.range_blocks import range_blocks, switch_idle_us


def read(rec):
    blocks = range_blocks(rec["records"], rec["span"])
    if not blocks or not rec["chunks"]:
        return None
    us = switch_idle_us(rec["records"], rec["span"], blocks)
    return None if us is None else us * 1e-3 / rec["chunks"]
