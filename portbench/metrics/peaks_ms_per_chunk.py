"""Assembly and the device peak program: device milliseconds a chunk of
every kernel that is not one of K1's (``portbench/kernels/k1.json``);
copies and sets are not kernels. From the profiler's trace."""
from portbench.trace import device_events, kernel_base


def read(rec):
    names = rec["kernels"]["k1"]
    us = sum(e["dur"] for e in device_events(rec["records"], rec["span"])
             if e["cat"] == "kernel" and kernel_base(e["name"]) not in names)
    if not us or not rec["chunks"]:
        return None
    return us * 1e-3 / rec["chunks"]
