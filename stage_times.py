#!/usr/bin/env python3
"""
Stage-loop and stage-kernel times of one checkout of the PyTorch port,
on one CUDA card:

    python3 stage_times.py [--tree DIR] [--survey] [--profile]
    python3 stage_times.py [--tree DIR] --probes
    python3 stage_times.py [--tree DIR] --wide
    python3 stage_times.py [--tree DIR] --snr

``--tree`` imports ``riptide_tpu_torch`` from DIR (default: the
directory of this script), so that two versions of the port are timed
by the same code on the same card in one call, in turns (old, new, new,
old). The configurations and data are those of this checkout's
``chip_smoke.py`` (the headline plan and series, the parity oracle, the
survey batch); the timers are this script's own, so every tree is timed
alike. Prints the card (``nvidia-smi`` name and power limit), then one
JSON object:

* ``build_s``: kernel build and load; ``cold_search_s``: the first
  headline ``ffa_search`` of the process (planning, operands and the
  kernels' first launches included);
* ``ffa_search_wall_s``: 3 warm recorded ``ffa_search`` calls, host
  wall; ``ffa_search_prep_s`` the last one's host wire prep;
  ``snr_sha256`` a digest of its S/N bits (equal digests: the trees give
  the same periodogram); ``ffa_search_stage_loop_s``: their stage loops
  (the split ``chip_smoke.py`` phase 2 prints),
  and ``stage_loop_s`` / ``stage_events_s``: median and 10th / 90th
  percentiles of 101 stage loops over the same shipped wire, host wall
  and the time between two CUDA events around the loop and its
  assembly (D = 1);
* ``launches``: wrapper calls per headline search and, where the tree
  counts them, ``cuda_launches`` by kernel and ``snr_forms``, its
  narrow S/N launches by register form;
* ``K1`` over the headline's 43 launches and ``K2`` over the parity
  oracle's 17 float32 launches: ``graph_ms``, device time from CUDA
  graph replays of all the launches (median of 20), and ``wrapper_ms``,
  CUDA events around the eager wrapper calls (median of 20);
* with ``--survey``: ``survey_prep_s``, the host wire prep of
  ``chip_smoke.py`` phase 5's D = 32 batch; ``survey_stage_loop_s``,
  the median stage loop of 3 such batches; ``K3`` over the 6 launches
  of ``chip_smoke.py`` phase 5k's D = 32 example_long batch as above;
* with ``--profile``: one D = 1 stage loop (and, with ``--survey``, the
  K3 calls) under ``torch.profiler``, device time by kernel and the
  slowest launches.

``--probes`` times the tree's chip probes instead of the search: P2's
six bodies (``ptime2.BODIES``) at the JAX tool's four shapes and NITER
(:data:`P2_SHAPES`, :data:`P2_NITER`), P1's ``matmul`` (the four
(2048, 2048) @ (2048, 384) products of ``tools/ptime.py``) beside four
``torch.matmul`` calls in full float32, P1's ten other patterns at
(2048, 384) and REPS 32 (:data:`P1_PATTERNS`) and P3's eight slot levels
of ``tools/probe1536.py`` (R 1536, P 384, NITER 32), on inputs drawn
here as the tools draw them. Each entry of ``probes`` ("p2.<body> RxC",
"p1.matmul 2048x384", "torch.matmul x4 2048x384", "p1.<pattern>
2048x384", "p3.S_d=<S> 1536x384") holds ``graph_ms`` and ``sha256``, a
digest of the output's bits (equal digests: the trees give the same
bits); the P2 and matmul entries ``graph_ms`` and ``wrapper_ms`` as
above, the P1 and P3 patterns ``graph_ms`` as the probes time them
(:data:`GRAPH_CALLS` calls captured into one CUDA graph, the median of
REPS replays over the calls: a launch of a few microseconds is not
paced by one replay's overhead). "mma.sync TF32 TFLOP/s", where the tree
has it, is the tensor cores' rate for ``mma.sync`` TF32 alone
(``probes.common.mma_tf32_tflops``).

``--wide`` times the tree's wide-phase stage kernels instead: the three
searches of ``chip_smoke.py`` phase 5w (``WIDE``: padded widths P past
14,528, 29,056 and 58,112), each on the uint6 wire (K1 ``fused_stage``)
and the float32 wire (K2 ``cascade_stage``). Each entry of ``wide``
holds the search's P, the limit it crosses, its wrapper and CUDA launch
counts, ``snr_sha256`` (a digest of the search's S/N bits: equal digests
mean the trees give the same bits), ``graph_ms`` and ``wrapper_ms`` of
all its K1 or K2 launches (as above), and ``split``: each CUDA kernel
alone (the segment kernel, each global level, the S/N kernel), device ms
summed over the launches beside its bound
(``chip_smoke.kernel_split``).

``--snr`` times the tree's narrow S/N kernel alone instead
(``ffa_kernel._snr``: ``boxcar_snr_kernel``, no level), at D = 128 on
the S/N launches of one stage loop of each of :data:`SNR_CELLS`: the
benchmark's ``quickstart`` and ``example_long`` configurations and
``example_yaml``'s ``medium`` range (``portbench/configs/``), each
launch's container (D, B, R, P) drawn once from a fixed seed. Each entry
of ``snr`` holds the launches, ``ms``: the median (and 10th / 90th
percentiles) of REPS passes over all of them between CUDA events,
``bound_ms``: the least time of the plan's S/N work
(``portbench/roofline.py``'s count a row: p + 3 nw p + 5 nw operations,
4 p bytes read and 4 nw written, over the plan's evaluated rows) and
``roofline_pct``, ``snr_sha256`` (a digest of every output's bits: equal
digests mean the trees give the same bits) and ``forms``, the launches
by register form where the tree counts them.

Imports nothing of jax and nothing of the JAX package.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 20
# D = 1 stage loops over one shipped wire: the host's clock spreads.
LOOPS = 101
# --probes: the JAX tools' shapes (tools/ptime2.py, tools/ptime.py).
P2_SHAPES = ((2048, 384), (1024, 384), (2048, 128), (256, 384))
P2_NITER = 20000
P1_ROWS, P1_COLS, P1_REPS = 2048, 384, 32
# P1's patterns at (P1_ROWS, P1_COLS) other than the matmul (ptime.py
# wrappers), and P3's shape and passes (tools/probe1536.py).
P1_PATTERNS = ("add", "roll_lanes", "roll_rows", "select", "barrel",
               "interleave", "repeat_tpu", "repeat_flat", "dynroll",
               "stride_roll")
P3_ROWS, P3_COLS, P3_DEPTH, P3_NITER = 1536, 384, 11, 32
GRAPH_CALLS = 8
# --snr: (configuration file, search range or None) and the batch.
SNR_CELLS = (("quickstart", None), ("example_long", None),
             ("example_yaml", "medium"))
SNR_D = 128


def _load_smoke():
    """This checkout's chip_smoke.py, loaded from its file (a tree on
    ``sys.path`` may hold a chip_smoke.py of its own)."""
    spec = importlib.util.spec_from_file_location(
        "stage_times_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spread(xs):
    """Median, 10th and 90th percentile."""
    q = statistics.quantiles(xs, n=10)
    return {"median": statistics.median(xs), "p10": q[0], "p90": q[-1]}


def _event_ms(fn):
    """Milliseconds of one ``fn()`` between CUDA events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _times(fn):
    """``graph_ms``: device ms of ``fn()`` (all its launches), the median
    of REPS replays of one CUDA graph of it; ``wrapper_ms``: the median of
    REPS eager calls between CUDA events. Both after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    wrapper = statistics.median(_event_ms(fn) for _ in range(REPS))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    dev_ms = statistics.median(_event_ms(graph.replay) for _ in range(REPS))
    del graph
    return {"graph_ms": dev_ms, "wrapper_ms": wrapper}


def _graph_ms(fn, calls=GRAPH_CALLS):
    """Device ms of one ``fn()``: ``calls`` calls captured into one CUDA
    graph, replayed once to warm up, then the median of REPS replays
    between CUDA events, over ``calls``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ms = statistics.median(_event_ms(graph.replay) for _ in range(REPS))
    del graph
    return ms / calls


def _profile(fn):
    """Device time of ``fn()``'s kernels under torch.profiler: by kernel
    name (launches, ms) and the 8 slowest launches (position in launch
    order, name, us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    by_name = {}
    for e in kern:
        n, us = by_name.get(e.name[:60], (0, 0.0))
        by_name[e.name[:60]] = (n + 1, us + e.time_range.elapsed_us())
    slow = sorted(((i, e.name[:40], e.time_range.elapsed_us())
                   for i, e in enumerate(kern)), key=lambda x: -x[2])[:8]
    return {"by_kernel": {k: [n, us / 1e3] for k, (n, us) in
                          sorted(by_name.items(), key=lambda kv: -kv[1][1])},
            "slowest_us": slow}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="checkout whose riptide_tpu_torch is timed")
    ap.add_argument("--survey", action="store_true",
                    help="also prepare the D = 32 survey wire and time its "
                         "stage loop and K3")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one D = 1 stage loop (and the K3 "
                         "calls) with torch.profiler")
    ap.add_argument("--probes", action="store_true",
                    help="time the tree's P1 patterns, P2 bodies and P3 "
                         "levels at the tools' shapes instead of the "
                         "search")
    ap.add_argument("--wide", action="store_true",
                    help="time the tree's K1 and K2 on phase 5w's three "
                         "wide-phase searches, kernel by kernel, instead "
                         "of the search")
    ap.add_argument("--snr", action="store_true",
                    help="time the tree's narrow S/N kernel alone on three "
                         "benchmark configurations' stage launches at "
                         "D = 128, instead of the search")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("stage_times: no CUDA device", file=sys.stderr)
        return 2
    if args.probes:
        card = _load_smoke().gpu_line()
        print(card, flush=True)
        print(json.dumps({"tree": tree, "card": card,
                          "probes": _probes(torch.device("cuda"))}),
              flush=True)
        return 0
    smoke = _load_smoke()
    if args.snr:
        card = smoke.gpu_line()
        print(card, flush=True)
        print(json.dumps({"tree": tree, "card": card,
                          "snr": _snr_alone(torch.device("cuda"))}),
              flush=True)
        return 0
    if args.wide:
        card = smoke.gpu_line()
        print(card, flush=True)
        print(json.dumps({"tree": tree, "card": card,
                          "wide": _wide(smoke, torch.device("cuda"))}),
              flush=True)
        return 0
    from riptide_tpu_torch import ffa_search
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    card = smoke.gpu_line()
    print(f"{card}; {fk.__file__}", flush=True)
    dev = torch.device("cuda")
    res = {"tree": tree, "card": card}
    t0 = time.perf_counter()
    fk._LIB.load()
    res["build_s"] = time.perf_counter() - t0

    cfg = smoke.HEADLINE
    ts = smoke.headline_series()
    kw = dict(period_min=cfg["period_min"], period_max=cfg["period_max"],
              bins_min=cfg["bins_min"], bins_max=cfg["bins_max"], device=dev)
    t0 = time.perf_counter()
    ffa_search(ts, **kw)
    res["cold_search_s"] = time.perf_counter() - t0
    loops, walls = [], []
    counted = getattr(fk, "KERNEL_LAUNCHES", None)
    for _ in range(3):
        fk.reset_launches()
        with engine.recording() as rec:
            t0 = time.perf_counter()
            _, pgram = ffa_search(ts, **kw)
            walls.append(time.perf_counter() - t0)
        loops.append(rec["stages_s"])
    res["ffa_search_wall_s"] = walls
    res["ffa_search_prep_s"] = rec["prep_s"]
    res["ffa_search_stage_loop_s"] = loops
    res["snr_sha256"] = hashlib.sha256(
        np.ascontiguousarray(pgram.snrs).tobytes()).hexdigest()[:16]
    res["launches"] = dict(fk.LAUNCHES)
    if counted is not None:
        res["cuda_launches"] = dict(counted)
    if hasattr(fk, "SNR_FORMS"):
        res["snr_forms"] = dict(fk.SNR_FORMS)

    plan = smoke.headline_plan()
    shipped = (rec["wire"], rec["meta"])
    walls, events = [], []
    for _ in range(LOOPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        with engine.recording() as r2:
            start.record()
            engine._queue_batch(plan, None, dev, shipped=shipped)
            end.record()
        end.synchronize()
        walls.append(r2["stages_s"])
        events.append(start.elapsed_time(end) / 1e3)
    res["stage_loop_s"] = _spread(walls)
    res["stage_events_s"] = _spread(events)
    if args.profile:
        res["profile_stage_loop"] = _profile(
            lambda: engine._queue_batch(plan, None, dev, shipped=shipped))

    k1 = [r["args"] for r in rec["launches"] if r["kind"] == "fused_stage"]
    res["K1"] = dict(calls=len(k1), **_times(
        lambda: [fk.fused_stage(*a) for a in k1]))
    del rec, r2

    with smoke.wire_dtype("float32"), engine.recording() as rec:
        ffa_search(smoke.oracle_series(), **smoke.ORACLE_SEARCH, device=dev)
    k2 = [r["args"] for r in rec["launches"] if r["kind"] == "cascade_stage"]
    # cascade_stage may use its container as scratch: time it on copies
    # (the work does not depend on the values).
    k2 = [(a[0].clone(),) + tuple(a[1:]) for a in k2]
    res["K2"] = dict(calls=len(k2), **_times(
        lambda: [fk.cascade_stage(*a) for a in k2]))
    del rec

    if args.survey:
        res.update(_survey(smoke, plan, dev, fk, engine, args.profile))
    print(json.dumps(res), flush=True)
    return 0


def _probes(dev):
    """Device and wrapper ms (:func:`_times`) and output digests of the
    tree's P2 bodies and P1 matmul, and of four torch.matmul calls; device
    ms (:func:`_graph_ms`) and output digests of P1's other patterns and
    P3's levels."""
    import torch
    from riptide_tpu_torch.probes import probe1536, ptime, ptime2

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    out = {}
    for name, fn in ptime2.BODIES.items():
        for shape in P2_SHAPES:
            rng = np.random.default_rng(0)
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32) * np.float32(1e-3)).to(dev)
            key = f"p2.{name} {shape[0]}x{shape[1]}"
            out[key] = dict(sha256=digest(fn(x, P2_NITER)),
                            **_times(lambda: fn(x, P2_NITER)))
            print(f"  {key}: {out[key]}", flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((P1_ROWS, P1_COLS)).astype(
        np.float32)).to(dev)
    a = torch.from_numpy(rng.standard_normal((P1_ROWS, P1_ROWS)).astype(
        np.float32)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = f"{P1_ROWS}x{P1_COLS}"
    out[f"p1.matmul {shape}"] = dict(
        sha256=digest(ptime.matmul(a, x, P1_REPS)),
        **_times(lambda: ptime.matmul(a, x, P1_REPS)))
    products = max(P1_REPS // 8, 1)
    out[f"torch.matmul x{products} {shape}"] = _times(
        lambda: [torch.matmul(a, x) for _ in range(products)])
    from riptide_tpu_torch.probes import common
    if hasattr(common, "mma_tf32_tflops"):
        out["mma.sync TF32 TFLOP/s"] = common.mma_tf32_tflops(dev)
    shifts = torch.from_numpy(np.arange(8, dtype=np.int32) * 37 + 5).to(dev)
    for name in P1_PATTERNS:
        fn = getattr(ptime, name)
        args = (shifts, x) if name == "dynroll" else (x,)
        key = f"p1.{name} {shape}"
        out[key] = dict(sha256=digest(fn(*args, P1_REPS)),
                        graph_ms=_graph_ms(lambda: fn(*args, P1_REPS)))
        print(f"  {key}: {out[key]}", flush=True)
    rng = np.random.default_rng(0)
    x3 = torch.from_numpy(rng.standard_normal((P3_ROWS, P3_COLS)).astype(
        np.float32)).to(dev)
    w3 = torch.from_numpy(rng.integers(0, 4, (P3_ROWS, P3_COLS),
                                       dtype=np.int32) << 22).to(dev)
    for _, S_d in probe1536.levels(P3_ROWS, P3_DEPTH):
        key = f"p3.S_d={S_d} {P3_ROWS}x{P3_COLS}"

        def level(S_d=S_d):
            return probe1536.slot_level(x3, w3, S_d, P3_NITER)

        out[key] = dict(sha256=digest(level()), graph_ms=_graph_ms(level))
        print(f"  {key}: {out[key]}", flush=True)
    return out


def _wide(smoke, dev):
    """One entry per phase 5w search and wire: launches, the S/N bits'
    digest, the K1 or K2 launches' times (:func:`_times`) and the split
    by CUDA kernel."""
    import torch
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    fk._LIB.load()
    out = []
    for entry in smoke.WIDE:
        plan, data = smoke.wide_search(entry)
        for mode, kind in smoke.WIDE_KINDS:
            fk.reset_launches()
            with smoke.wire_dtype(mode), engine.recording() as rec:
                _, _, snrs = engine.run_periodogram(plan, data, device=dev)
            args = [r["args"] for r in rec["launches"] if r["kind"] == kind]
            if kind == "cascade_stage":
                # The container is the call's level scratch: time it on
                # copies (the work does not depend on the values).
                args = [(a[0].clone(),) + tuple(a[1:]) for a in args]
            fn = getattr(fk, kind)
            res = {"P": plan.P, "limit": entry[0], "kind": kind,
                   "launches": dict(fk.LAUNCHES),
                   "cuda_launches": dict(fk.KERNEL_LAUNCHES),
                   "snr_sha256": hashlib.sha256(np.ascontiguousarray(
                       snrs).tobytes()).hexdigest()[:16],
                   **_times(lambda: [fn(*a) for a in args]),
                   "split": smoke.kernel_split(dev, rec, kind)}
            print(f"  {res}", flush=True)
            out.append(res)
            del rec, args
            torch.cuda.empty_cache()
    return out


def _snr_alone(dev):
    """One entry per :data:`SNR_CELLS` configuration: its S/N launches'
    times against the bound of the plan's S/N work, their outputs'
    digest and register forms. The plans and the bound come from this
    checkout's ``portbench``, whatever the tree."""
    import torch
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    sys.path.insert(0, HERE)
    try:
        from portbench import roofline
        from portbench.cell import plan_of
        from portbench.ranges import ranges
    finally:
        sys.path.remove(HERE)

    fk._LIB.load()
    rt = fk._runtime(dev)
    out = {}
    for name, want in SNR_CELLS:
        with open(os.path.join(HERE, "portbench", "configs",
                               name + ".json")) as fobj:
            cfg = dict(ranges(json.load(fobj)))[want]
        plan, widths, stages = plan_of(cfg)
        nw = len(widths)
        ops = []
        for ln in engine.launch_layout(plan, "uint6").launches:
            st = plan.stages[ln.stage]
            if ln.bucket is None:
                tables, coefs = engine._stage_operands(st, plan, dev)
            elif ln.guest is None:
                tables, coefs = engine._bucket_operands(st, plan, ln.bucket,
                                                        dev)
            else:
                tables, coefs = engine._paired_operands(
                    st, plan, ln.bucket, plan.stages[ln.guest], ln.bases,
                    dev)
            ops.append((tables, coefs, (SNR_D, int(tables.p.shape[0]),
                                        int(tables.h.shape[2]),
                                        int(tables.P))))
        gen = torch.Generator(device=dev)
        gen.manual_seed(20260)
        buf = torch.randn(max(int(np.prod(s)) for _, _, s in ops),
                          generator=gen, device=dev)

        def run():
            return [fk._snr(rt, buf[:int(np.prod(s))].view(s), t, c)
                    for t, c, s in ops]

        fk.reset_launches()
        outs = run()
        forms = dict(getattr(fk, "SNR_FORMS", {}))
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for o in outs:
            digest.update(o.cpu().numpy().tobytes())
        del outs
        ms = [_event_ms(run) for _ in range(REPS)]
        rows = [(bins, re) for s in stages for bins, _, re, _ in s.trials]
        work = sum(re * (p + 3 * nw * p + 5 * nw) for p, re in rows)
        nbytes = sum(re * 4 * (p + nw) for p, re in rows)
        bound, by = roofline.bound_s(SNR_D * work, SNR_D * nbytes)
        res = {"launches": len(ops), "D": SNR_D, "ms": _spread(ms),
               "bound_ms": bound * 1e3, "bound_by": by,
               "roofline_pct": 100 * bound * 1e3 / statistics.median(ms),
               "snr_sha256": digest.hexdigest()[:16], "forms": forms}
        print(f"  {name}{'.' + want if want else ''}: {res}", flush=True)
        out[name if want is None else f"{name}.{want}"] = res
        del ops, buf
        torch.cuda.empty_cache()
    return out


def _survey(smoke, plan, dev, fk, engine, profile=False):
    import torch

    D = 32
    tobs = smoke.HEADLINE["nsamp"] * smoke.HEADLINE["tsamp"]
    batch = smoke.survey_batch(plan, D)
    t0 = time.perf_counter()
    prepared = engine.prepare_stage_data(plan, batch)
    out = {"survey_prep_s": time.perf_counter() - t0}
    del batch
    loops = []
    for _ in range(3):
        with engine.recording() as rec:
            h = engine.queue_search_batch(plan, None, tobs,
                                          prepared=prepared, device=dev)
            engine.collect_search_batch(h, np.zeros(D))
        loops.append(rec["stages_s"])
    out["survey_stage_loop_s"] = statistics.median(loops)
    del rec, h, prepared
    torch.cuda.empty_cache()
    # K3 over the example_long plan's hosted buckets, at D = 32.
    cfg = smoke.EXAMPLE_LONG
    long_plan = smoke.headline_plan(cfg, smoke.EXAMPLE_LONG_WIDTHS)
    batch = smoke.survey_batch(long_plan, D, cfg=cfg,
                               period=smoke.EXAMPLE_LONG_PULSAR)
    with engine.recording() as rec:
        h = engine.queue_search_batch(long_plan, batch,
                                      cfg["nsamp"] * cfg["tsamp"],
                                      device=dev)
        engine.collect_search_batch(h, np.zeros(D))
    k3 = [r["args"] for r in rec["launches"] if r["kind"] == "paired_stage"]
    out["K3"] = dict(calls=len(k3), **_times(
        lambda: [fk.paired_stage(*a) for a in k3]))
    if profile:
        out["profile_K3"] = _profile(
            lambda: [fk.paired_stage(*a) for a in k3])
    del rec, h, k3
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
