"""
A traced run of one cell with the program's own spans: ``portbench.run
--trace 1`` with the program's tracer installed for the run, the
profiler's records read by :func:`portbench.spans.load_records`, and
the metrics of :data:`SPAN_METRICS`, which read those spans, added to
the cell's per-layer metrics.

    python3 -m portbench.spans_run --workload <name> --seed <n> \\
        --seconds <s>

Prints the result line of ``portbench.run --trace 1`` with the span
metrics among its ``metrics``; standard error carries, besides the
usual lines, the idle gaps named by the program's innermost span, the
queue's blocking calls by span and device milliseconds by ``ffa_stage``
and by peak program step (:func:`portbench.spans.report_lines`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# The span metrics, in the form of BENCHMARK.json's per-layer entries.
_DISPATCH = "dispatch (engine.queue_search_batch, ops/ffa_kernel.py wrappers)"
_PEAKS = ("assembly and device peak program (engine._assemble_device, "
          "search/peaks_device.py)")
_TAIL = ("pull and host tail (engine.collect_search_batch, "
         "peaks_device.collect_peaks)")
SPAN_METRICS = [
    {"name": name, "unit": unit, "better": "lower", "source": "program_span",
     "layer": layer, "moves": "survey_trials_per_s"}
    for name, unit, layer in (
        ("queue_sync_ms", "ms", _DISPATCH),
        ("queue_syncs_per_chunk", "syncs", _DISPATCH),
        ("assemble_ms_per_chunk", "ms", _PEAKS),
        ("peak_program_ms_per_chunk", "ms", _PEAKS),
        ("collect_tail_ms", "ms", _TAIL),
        ("tail_idle_ms", "ms", "device"))]


def run_traced(wl, cfg, mix, limits, bench, seed, seconds, device, t_start,
               log=None):
    """``cell.run_cell`` of a traced run with the program's tracer
    installed for the run, the records read by
    :func:`portbench.spans.load_records` and :data:`SPAN_METRICS` read
    too. Returns (result line, check lines)."""
    from riptide_tpu_torch.obs import trace as program_trace

    from . import cell, spans
    from .ranges import ranges
    from .trace import window_span

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    k1 = cell.kernel_sets()["k1"]
    nranges = len(ranges(cfg))

    def load(prof):
        records = spans.load_records(prof)
        win = window_span(records)
        # One tail a collected search: a chunk's collect has one a range.
        chunks = len(spans.tail_spans(records, win)) // nranges if win else 0
        for line in spans.report_lines(records, win, chunks, k1):
            log(line)
        return records

    bench = dict(bench, per_layer=bench["per_layer"] + SPAN_METRICS)
    prev = program_trace.set_tracer(program_trace.Tracer())
    saved, cell.load_chrome_trace = cell.load_chrome_trace, load
    try:
        return cell.run_cell(wl, cfg, mix, limits, bench, seed, seconds,
                             True, device, t_start, log)
    finally:
        cell.load_chrome_trace = saved
        program_trace.set_tracer(prev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from . import run
    run._cache_env(run.ROOT)

    import torch

    from . import cell, check

    wl, cfg, mix, limits, bench = cell.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: the run needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(0, device=device)
    result, lines = run_traced(wl, cfg, mix, limits, bench, args.seed,
                               args.seconds, device, T_START)
    print(f"device: {run._power_limit()}", file=sys.stderr, flush=True)
    bad = check.forbidden_modules()
    if bad:
        print(f"portbench: loaded modules the run may not hold: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
