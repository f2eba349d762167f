"""
One run of one cell: set-up, the measured window, the traced window's
per-layer numbers, and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix, kernel set
or per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives: ``configs/<config>.json`` (the file the
configuration's entry names), ``traffic/<traffic>.json``,
``limits/<config>.json``, ``kernels/<set>.json`` and
``metrics/<metric>.py``. A configuration may list several search ranges
(``portbench/ranges.py``): every chunk is then searched over each, and
each range's numbers are compared under ``<number>.<range>``.

From the program (``riptide_tpu_torch``) the harness calls only the
search's public functions: ``periodogram_plan``,
``generate_width_trials``, ``StagingPool``, ``prepare_stage_data``,
``warm_stage_kernels``, ``ship_stage_data``, ``queue_search_batch``,
``search_snr_dev`` and ``collect_search_batch``; it reads the stage
kernels' launch counters, and in a traced run the peak-memory model.
"""
import glob
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from . import check, roofline, traffic
from .loop import run_window
from .ranges import ranges
from .reference import search as ref
from .trace import (breakdown, device_events, load_chrome_trace,
                    union_us, window_span)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

__all__ = ["load_cell", "kernel_sets", "metric_reader", "plan_of",
           "setup", "measure", "window_record", "judge", "run_cell"]


def _json(path):
    with open(path) as fobj:
        return json.load(fobj)


def load_cell(workload, bench=None):
    """(workload entry, config, traffic mix, limits, benchmark) of the
    cell named ``workload``; KeyError for an unknown name."""
    bench = bench or _json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = _json(os.path.join(ROOT, conf["file"]))
    mix = _json(os.path.join(HERE, "traffic", wl["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", wl["config"] + ".json"))
    return wl, cfg, mix, limits, bench


def kernel_sets():
    """{set name: kernel names} from every ``kernels/*.json``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.json"))):
        name = os.path.splitext(os.path.basename(path))[0]
        out[name] = frozenset(_json(path)["kernels"])
    return out


def metric_reader(name):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _widths(cfg):
    from riptide_tpu_torch.ffautils import generate_width_trials

    return tuple(int(w) for w in generate_width_trials(
        cfg["bins_min"], ducy_max=cfg["ducy_max"], wtsp=cfg["wtsp"]))


def plan_of(cfg):
    """The program's plan, the width trials and the reference's own
    stages of a configuration of one range (one of
    :func:`portbench.ranges.ranges`)."""
    from riptide_tpu_torch.search.plan import periodogram_plan

    widths = _widths(cfg)
    plan = periodogram_plan(int(cfg["nsamp"]), float(cfg["tsamp"]), widths,
                            float(cfg["period_min"]),
                            float(cfg["period_max"]), int(cfg["bins_min"]),
                            int(cfg["bins_max"]))
    stages = ref.cascade(int(cfg["nsamp"]), float(cfg["tsamp"]),
                         float(cfg["period_min"]), float(cfg["period_max"]),
                         int(cfg["bins_min"]), int(cfg["bins_max"]))
    return plan, widths, stages


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cfg, mix, limits, seed, device, log=None):
    """Set-up, in order: each range's plan; each ring slot's chunk made
    on the device from ``seed`` and copied to the host, its sampled
    trials' raw series kept for the reference, every range's wire
    prepared from that one host chunk into pinned staging buffers
    (``prepare_stage_data``); then every range's launch shapes warmed
    (``warm_stage_kernels``) and one whole chunk searched, every range
    queued and then collected, so that the peak programs' plans and the
    operands exist before the window. Returns the ranges (name,
    configuration, plan, widths, stages, tobs), the ring (per slot, each
    range's wire) and what the check needs."""
    from riptide_tpu_torch.search import engine

    log = log or (lambda msg: None)
    rs = []
    for name, rcfg in ranges(cfg):
        t = time.perf_counter()
        plan, widths, stages = plan_of(rcfg)
        log(("plan" if name is None else f"plan {name}")
            + f": {len(plan.stages)} stages, {plan.length} periods x "
            f"{len(widths)} widths, {time.perf_counter() - t:.3f} s")
        rs.append({"name": name, "cfg": rcfg, "plan": plan,
                   "widths": widths, "stages": stages,
                   "tobs": plan.size * plan.tsamp})
    D, R = int(mix["dm_trials"]), int(mix["ring"])
    k = int(limits["sample_trials"])
    pool = engine.StagingPool(device)
    ring, sampled, series, prep_s = [], {}, {}, []
    for slot in range(R):
        t = time.perf_counter()
        host = traffic.make_chunk(cfg, mix, seed, slot, device).cpu().numpy()
        made = time.perf_counter() - t
        sampled[slot] = traffic.sample_trials(D, k, seed, slot)
        series[slot] = host[sampled[slot]].copy()
        t = time.perf_counter()
        ring.append([engine.prepare_stage_data(r["plan"], host,
                                               mode=cfg["wire"], pool=pool)
                     for r in rs])
        prep_s.append(time.perf_counter() - t)
        del host
        log(f"ring slot {slot}: made {made:.3f} s, prepared "
            f"{prep_s[-1]:.3f} s ("
            + "; ".join(str(p[1]["prep"]) for p in ring[-1]) + ")")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    nshapes = sum(engine.warm_stage_kernels(r["plan"], D, device=device)
                  for r in rs)
    log(f"warmed {nshapes} launch shapes: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    handles = [engine.queue_search_batch(
        r["plan"], None, r["tobs"],
        shipped=engine.ship_stage_data(wire, device),
        **r["cfg"]["find_peaks"]) for r, wire in zip(rs, ring[0])]
    for handle in handles:
        engine.collect_search_batch(handle, np.zeros(D))
    del handles, handle
    _sync(device)
    log(f"warm chunk: {time.perf_counter() - t:.3f} s")
    return {"ranges": rs, "ring": ring, "sampled": sampled,
            "series": series, "prep_s": prep_s, "D": D}


def measure(st, seconds, device, trace):
    """The window over ``st``'s ring (:func:`portbench.loop.run_window`),
    with the launch counters' change over it and, with ``trace``, the
    profiler's records. The device's peak memory counts from the
    window's start."""
    from riptide_tpu_torch.ops import ffa_kernel

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = dict(ffa_kernel.KERNEL_LAUNCHES)
    args = ([(r["plan"], r["tobs"], r["cfg"]["find_peaks"], r["name"])
             for r in st["ranges"]], st["ring"], seconds, device)
    min_chunks = max(2, len(st["ring"]))
    records = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("portbench.window"):
                win = run_window(
                    *args, min_chunks=min_chunks,
                    annotate=lambda n: record_function("portbench." + n))
        records = load_chrome_trace(prof)
    else:
        win = run_window(*args, min_chunks=min_chunks)
    win["launches"] = {k: ffa_kernel.KERNEL_LAUNCHES[k] - before.get(k, 0)
                       for k in ffa_kernel.KERNEL_LAUNCHES}
    win["records"] = records
    return win


def window_record(st, win, setup_s):
    """What the metric readers read: the set-up's seconds, the window's
    seconds, chunks and collected DM trials, the harness's host timers,
    the launch counters' change, the kernel sets, the plans' work a
    chunk (summed over the ranges) and, in a traced run, the trace's
    records and the window's span in them."""
    ops = nbytes = 0
    for r in st["ranges"]:
        o, b = roofline.work(r["stages"], len(r["widths"]),
                             ref.wire_row(r["cfg"]["bins_max"]), st["D"])
        ops, nbytes = ops + o, nbytes + b
    records = win["records"] or []
    return {"setup_s": setup_s, "records": records,
            "span": window_span(records),
            "window_s": win["t1"] - win["t0"], "chunks": win["chunks"],
            "trials_per_chunk": st["D"],
            "collected_trials": len(win["peaks"]) * st["D"],
            "host": {"ship_s": win["ship_s"], "queue_s": win["queue_s"],
                     "collect_s": win["collect_s"], "prep_s": st["prep_s"],
                     "prep_trials": st["D"] * len(st["prep_s"])},
            "launches": win["launches"], "kernels": kernel_sets(),
            "work": {"ops": ops, "bytes": nbytes}}


def judge(st, win, device):
    """The compared numbers and ``failed``: for each range, the sampled
    trials' S/N as the window wrote it against the reference's over that
    range's stages, widths and wire row, and the peaks; the numbers
    named by :func:`portbench.check.named`. ``failed`` counts a DM
    trial of a chunk once, however many of its ranges fail. The
    program's cubes are pulled and freed before the reference runs."""
    cols = {s: [c[st["sampled"][s]].float().cpu().numpy() for c in cubes]
            for s, cubes in sorted(win["snr"].items())}
    win["snr"].clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    slots = sorted(cols)
    raw = np.concatenate([st["series"][s] for s in slots])
    numbers, failed = {}, set()
    for i, r in enumerate(st["ranges"]):
        want = check.reference_snr(raw, r["stages"], r["widths"],
                                   ref.wire_row(r["cfg"]["bins_max"]),
                                   device)
        rms, mx = check.snr_gaps(
            np.concatenate([cols[s][i] for s in slots]), want)
        del want
        periods = np.concatenate([p for s in r["stages"]
                                  for *_, p in s.trials])
        bad, fails = check.judge_peaks(
            [p[i] for p in win["peaks"]], win["slots"], st["sampled"],
            {s: cols[s][i] for s in slots}, periods, r["tobs"],
            r["cfg"]["find_peaks"])
        numbers.update(check.named(
            {"snr_rms": rms, "snr_max": mx, "peaks_bad": bad}, r["name"]))
        failed |= fails
    return numbers, len(failed)


def _device_info(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def _raw_kernels(rec, top=8):
    """The ``top`` kernels by device time in the window, by raw name."""
    totals = {}
    for e in device_events(rec["records"], rec["span"]):
        if e["cat"] == "kernel":
            totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"]
    return [[n[:160], round(us * 1e-6, 6)] for n, us in
            sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def _hbm_line(plan, D):
    try:
        from riptide_tpu_torch.analysis.launch_contract import hbm_model

        return f"{hbm_model(plan).predict(D)} bytes predicted by hbm_model"
    except Exception as err:  # a report line only: never fails the run
        return f"hbm_model not available ({type(err).__name__}: {err})"


def run_cell(wl, cfg, mix, limits, bench, seed, seconds, trace, device,
             t_start, log=None):
    """One run of the cell ``wl``: returns (result line, check lines).
    ``t_start`` is the host clock at the harness's first statement."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    st = setup(cfg, mix, limits, seed, device, log)
    win = measure(st, seconds, device, trace)
    setup_s = win["t0"] - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dev_info = _device_info(device, peak)
    trials = win["chunks"] * st["D"]
    log(f"window: {win['chunks']} chunks of {st['D']} DM trials in "
        f"{win['t1'] - win['t0']:.6f} s; setup {setup_s:.6f} s")
    log(f"stage kernel launches in the window: {win['launches']}")
    log("host seconds a chunk: " + ", ".join(
        f"{k} {np.mean(win[k + '_s']):.6f} (max {np.max(win[k + '_s']):.6f})"
        for k in ("ship", "queue", "collect")))
    if trace:
        log(f"device memory peak {peak} bytes; " + "; ".join(
            ("" if r["name"] is None else f"{r['name']}: ")
            + _hbm_line(r["plan"], st["D"]) for r in st["ranges"]))
    rec = window_record(st, win, setup_s)
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and wl["name"] not in m["workloads"]:
            continue
        value = metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out_breakdown = None
    if trace and rec["span"] is not None:
        dev_info["busy_s"] = union_us(device_events(
            rec["records"], rec["span"])) * 1e-6
        dev_info["window_s"] = (rec["span"][1] - rec["span"][0]) * 1e-6
        out_breakdown = breakdown(rec["records"], rec["span"])
        log(f"kernels by raw name: {_raw_kernels(rec)}")
    del rec
    win["records"] = None
    t = time.perf_counter()
    numbers, failed = judge(st, win, device)
    log(f"comparison with the reference: {time.perf_counter() - t:.3f} s")
    checks, ok = check.numbers_line(numbers, limits["limits"])
    result = {"correct": bool(ok and failed == 0), "attempted": trials,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if out_breakdown is not None:
        result["breakdown"] = out_breakdown
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}"
             for k, v in checks.items()]
    lines.append(f"check failed_trials: {failed} limit 0")
    return result, lines
