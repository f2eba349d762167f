"""Stage kernels and peak program, by search range: device milliseconds
a chunk of every kernel of the search range whose kernels take the most
card time (K1, the assembly and the peak program,
``portbench/range_blocks.py``): the range that sets the pace. None for
a configuration without named ranges."""
from portbench.range_blocks import range_blocks


def read(rec):
    blocks = range_blocks(rec["records"], rec["span"])
    if not blocks or not rec["chunks"]:
        return None
    us = {}
    for name, kernels in blocks:
        us[name] = us.get(name, 0.0) + sum(e["dur"] for e in kernels)
    return max(us.values()) * 1e-3 / rec["chunks"]
