"""Stage kernels K1: device milliseconds a chunk of the kernels named
in ``portbench/kernels/k1.json``, from the profiler's trace."""
from portbench.trace import device_events, kernel_base


def read(rec):
    names = rec["kernels"]["k1"]
    us = sum(e["dur"] for e in device_events(rec["records"], rec["span"])
             if e["cat"] == "kernel" and kernel_base(e["name"]) in names)
    if not us or not rec["chunks"]:
        return None
    return us * 1e-3 / rec["chunks"]
