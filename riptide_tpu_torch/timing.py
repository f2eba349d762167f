"""Wall-clock timing decorator logging to the 'riptide_tpu_torch.timing'
logger at DEBUG level (reference: riptide/timing.py), plus a device-side
profiler hook: ``device_trace`` captures a ``torch.profiler`` trace
(kernel-level timeline) as a Chrome trace viewable in Perfetto, and
``maybe_trace``, the same when given a directory."""
import logging
import os
import time
from contextlib import contextmanager, nullcontext
from functools import wraps

log = logging.getLogger("riptide_tpu_torch.timing")

__all__ = ["timing", "device_trace", "maybe_trace"]


@contextmanager
def device_trace(trace_dir):
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU and,
    when a card is present, CUDA activity) into
    ``trace_dir/trace.json``. The card is synchronised before the trace
    closes so queued kernels land inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    log.info(f"capturing device trace to {trace_dir}")
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(str(trace_dir), "trace.json"))
    log.info(f"device trace written to {trace_dir}")


def maybe_trace(trace_dir):
    """``device_trace(trace_dir)`` when a directory is given, else a
    no-op context."""
    return device_trace(trace_dir) if trace_dir else nullcontext()


def timing(func):
    @wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        runtime_ms = (time.time() - start) * 1000.0
        log.debug(f"{func.__name__} time: {runtime_ms:.2f} ms")
        return result

    return wrapper
