"""
Measurement on the card, shared by the chip probes and ``chip_smoke.py``:
the H100 peaks behind a kernel's bound, and timing between CUDA events.
"""
import statistics
import time

import torch

__all__ = ["PEAK_BYTES_PER_S", "PEAK_OPS_PER_S", "PEAK_TF32_FLOPS_PER_S",
           "bound_ms", "timed", "median_ms", "graph_ms"]

# Published H100 SXM peaks: the device memory rate, float32 outside the
# tensor cores, and dense TF32 on the tensor cores. The data sheet's 67
# TFLOP/s counts an FMA as two operations; the kernels count one
# operation per arithmetic instruction or select on an element and one
# per FMA, so their ceiling is half. The TF32 peak counts an FMA as two
# flops, and so does the work of a product on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12 / 2
PEAK_TF32_FLOPS_PER_S = 495e12


def bound_ms(nbytes, ops, tensor=False):
    """(ms, "bytes", "operations" or "operations (tensor cores)"): the
    least time the card could take to move ``nbytes`` compulsory bytes
    and do ``ops`` float32 operations, or with ``tensor`` ``ops`` TF32
    flops on the tensor cores."""
    tb = nbytes / PEAK_BYTES_PER_S
    to = ops / (PEAK_TF32_FLOPS_PER_S if tensor else PEAK_OPS_PER_S)
    if tb >= to:
        return tb * 1e3, "bytes"
    return to * 1e3, "operations (tensor cores)" if tensor else "operations"


def timed(fn, dev):
    """(output, milliseconds) of one call of ``fn()``: between CUDA events
    on the current stream on a card, the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def median_ms(fn, dev, reps=20):
    """Median milliseconds of ``fn()`` over ``reps`` calls (:func:`timed`)
    after one warm-up call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return statistics.median(timed(fn, dev)[1] for _ in range(reps))


def graph_ms(fn, dev, reps=20):
    """Device milliseconds of ``fn()`` (all its launches) on a card: the
    calls captured into one CUDA graph, replayed once to warm up, then
    :func:`median_ms` of ``reps`` replays. This leaves out the host's
    work per launch, which paces eager calls of short kernels."""
    fn()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = median_ms(graph.replay, dev, reps)
    del graph
    return ms
