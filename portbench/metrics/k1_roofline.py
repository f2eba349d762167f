"""Stage kernels K1: the least time the card could take for the
window's K1 work (the plan's operations and compulsory bytes,
``portbench/roofline.py``) as a share of the device time of K1's
kernels in the profiler's trace, in %."""
from portbench.roofline import bound_s
from portbench.trace import device_events, kernel_base


def read(rec):
    names = rec["kernels"]["k1"]
    us = sum(e["dur"] for e in device_events(rec["records"], rec["span"])
             if e["cat"] == "kernel" and kernel_base(e["name"]) in names)
    if not us or not rec["chunks"]:
        return None
    need, _ = bound_s(rec["work"]["ops"], rec["work"]["bytes"])
    return 100.0 * rec["chunks"] * need / (us * 1e-6)
