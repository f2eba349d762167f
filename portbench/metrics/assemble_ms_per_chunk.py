"""Assembly: device milliseconds a chunk of the kernels launched inside
the program's ``assemble`` span (``engine._assemble_device``), tied to
their launch by the profiler's ``correlation``."""
from portbench.spans import PREFIX, kernel_ms


def read(rec):
    ms = kernel_ms(rec["records"], rec["span"], PREFIX + "assemble")
    if not ms or not rec["chunks"]:
        return None
    return ms / rec["chunks"]
