"""The device peak program: device milliseconds a chunk of the kernels
launched inside the program's ``peaks`` span
(``peaks_device.queue_find_peaks``), tied to their launch by the
profiler's ``correlation``."""
from portbench.spans import PREFIX, kernel_ms


def read(rec):
    ms = kernel_ms(rec["records"], rec["span"], PREFIX + "peaks")
    if not ms or not rec["chunks"]:
        return None
    return ms / rec["chunks"]
