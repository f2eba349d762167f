#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``riptide_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the cascade-stage kernels (``riptide_tpu_torch/csrc/ffa_stage.cu``)
and the chip probes' kernels (``riptide_tpu_torch/csrc/probes.cu``) from
this checkout with nvcc, one process each, started together, then:

0. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the kernel build time;
1. the S/N parity oracle: ``ffa_search`` of the seeded 128 s / 256 us
   pulsar must give S/N 18.5 +/- 0.15 at width 13, on the uint6 wire
   (K1) and on the float32 wire (device pack, then K2: K2's own path).
   The launch counts are set to 0 just before each search and read just
   after; the float32 search's 17 K2 launches (one per stage, each a
   segment launch from the container) are the ``kernels`` line's K2
   launches, and are recorded for phase 3;
2. the main path: ``ffa_search`` of a 2^23-sample / 64 us series with an
   injected pulsar, P 0.5-3.0 s, bins 240-260 (222,955 trials), on the
   default uint6 wire. The launch counts are set to 0 just before this
   search and read just after: one K1 per queued lane bucket
   (``engine.queued_launches``) and no K2, and by CUDA kernel one
   segment launch from the wire and one S/N launch per K1, one level
   launch per FFA level past the segment kernel's
   (``ffa_kernel.KERNEL_LAUNCHES``). The cold segment-table build
   (``ops.plan.segment_plan`` of all 43 containers) is timed. The search
   is recorded (``engine.recording``): its time split into host wire
   preparation, copies and the stage loop, and every K1 launch's output
   held against ``fused_stage_plain`` on the same operands;
3. K1 ``fused_stage`` on every launch of that search (D = 1) and K2
   ``cascade_stage`` on the oracle's 17 float32 launches and on the
   containers K1's front half builds: the container after the segment
   kernel and after every global level (``segment_levels``) against the
   plain levels (``ffa_levels`` over the same leading levels), bit for
   bit, from the wire (K1) and from the packed container (K2); K2's
   outputs against its plain version; and the time of one pass of each
   kernel over those launches (device time from CUDA graph replays, and
   through the wrappers between CUDA events) and of each plain version.
   The ``kernels`` line takes K1 over the headline's launches and K2
   over the oracle's;
4. ``run_periodogram_batch`` at the headline configuration with D = 32:
   DM-trials/s, peak device memory, the launch counts, the time split,
   and every K1 launch's output against its plain version;
5. the survey batch: ``run_search_batch`` at the headline configuration
   with D = 32 (a pulsar in series 0) from one ``prepare_stage_data``,
   under (a) the default container flags, (b) ``RIPTIDE_KERNEL_BASE3=0``,
   where the pairing map holds 10 pairs and K3 ``paired_stage`` runs, and
   (c) ``RIPTIDE_KERNEL_BASE3=0 RIPTIDE_KERNEL_ROW_PACK=0``. Each run is
   second of two, its launch counts set to 0 just before it and read
   just after; the three S/N cubes must be the same bits, the three peak
   lists identical, and series 0 must give the pulsar. Every K3 launch of
   run (b) is held against ``paired_stage_plain``, its containers after
   the segment kernel and every global level against the plain levels
   bit for bit, and K3 is timed over all of them;
6. the chip probes P1-P3 (``riptide_tpu_torch.probes``) through their
   entry points at the JAX tools' shapes: ``ptime.main(["all"])``,
   ``ptime2.main`` with all six bodies at NITER 20000 and
   ``probe1536.main([])``, their launch counts set to 0 just before and
   read just after (every probe kernel must have launched; a count holds
   the wrappers' eager launches, not the calls captured into a CUDA
   graph for timing nor the graph's replays). Each
   pattern's output is held against its plain version on the same
   inputs (the same bits; the matmul within rtol/atol
   ``PROBE_MM_RTOL``/``PROBE_MM_ATOL`` of ``torch.matmul`` in full
   float32), every P3 level against the tool's numpy sequence bit for
   bit, and each probe's kernel time printed beside its plain version's
   (P2's plain versions run once, at the full NITER) and its bound.

``--profile DIR`` adds one headline ``run_periodogram`` under
``torch.profiler``: device time by kernel and the device's busy share,
with the Chrome trace written to DIR.

Every phase raises on failure, so the script exits non-zero. The line
before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card the script
exits non-zero before printing any result. Imports nothing of jax and
nothing of the JAX package.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from riptide_tpu_torch.utils import measure

HEADLINE = dict(nsamp=2 ** 23, tsamp=64e-6, period_min=0.5, period_max=3.0,
                bins_min=240, bins_max=260)
HEADLINE_WIDTHS = (1, 2, 3, 4, 6, 9, 13, 19, 28, 42)
HEADLINE_TRIALS = 222955
PULSAR = dict(period=1.2345, amplitude=40.0)
# Phase 5's three layouts: environment flags set for each run.
LAYOUTS = (("a", {}),
           ("b", {"RIPTIDE_KERNEL_BASE3": "0"}),
           ("c", {"RIPTIDE_KERNEL_BASE3": "0", "RIPTIDE_KERNEL_ROW_PACK": "0"}))
LAYOUT_FLAGS = ("RIPTIDE_KERNEL_BASE3", "RIPTIDE_KERNEL_ROW_PACK",
                "RIPTIDE_KERNEL_LANE_SPLIT")
HEADLINE_PAIRS = 10
# Kernel vs plain S/N: the decode, pack and FFA sums are the same float
# operations in the same order, so the containers agree bit for bit; the
# S/N differs only by the summation order of the per-row prefix sum
# (a chunked warp scan against torch.cumsum), a few float32 ulps of
# values ~1e3, i.e. ~1e-5 in S/N.
RTOL, ATOL = 1e-5, 1e-4
# Timed calls of a kernel over the main path's launches (median).
REPS = 20
# Phase 6: the hand-written float32 GEMM against torch.matmul in full
# float32 (sums of 2048 products in another order, outputs ~1-4).
PROBE_MM_RTOL, PROBE_MM_ATOL = 1e-5, 1e-5


# Phase 1's parity oracle: the seeded series and its search.
ORACLE_SERIES = dict(length=128.0, tsamp=256e-6, period=1.0, amplitude=20.0,
                     ducy=0.02)
ORACLE_SEARCH = dict(period_min=0.5, period_max=2.0, bins_min=480,
                     bins_max=520, ducy_max=0.3)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def headline_plan(cfg=HEADLINE, widths=HEADLINE_WIDTHS):
    from riptide_tpu_torch.search.plan import periodogram_plan

    return periodogram_plan(cfg["nsamp"], cfg["tsamp"], tuple(widths),
                            cfg["period_min"], cfg["period_max"],
                            cfg["bins_min"], cfg["bins_max"])


def oracle_series():
    """Phase 1's seeded 128 s / 256 us series with a 1 s pulsar."""
    from riptide_tpu_torch import TimeSeries

    np.random.seed(0)
    return TimeSeries.generate(**ORACLE_SERIES)


def headline_series(cfg=HEADLINE, period=PULSAR["period"],
                    amplitude=PULSAR["amplitude"]):
    """Phase 2's seeded headline series with an injected pulsar."""
    from riptide_tpu_torch import TimeSeries

    np.random.seed(1)
    ts = TimeSeries.generate(length=cfg["nsamp"] * cfg["tsamp"],
                             tsamp=cfg["tsamp"], period=period,
                             amplitude=amplitude, ducy=0.05)
    check(ts.nsamp == cfg["nsamp"], f"generated {ts.nsamp} samples")
    return ts


@contextlib.contextmanager
def wire_dtype(mode):
    """Run the block on wire ``mode`` (``RIPTIDE_WIRE_DTYPE``)."""
    saved = os.environ.get("RIPTIDE_WIRE_DTYPE")
    os.environ["RIPTIDE_WIRE_DTYPE"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("RIPTIDE_WIRE_DTYPE", None)
        else:
            os.environ["RIPTIDE_WIRE_DTYPE"] = saved


def _trials(plan, r):
    """(m, p, evaluated rows) of every trial a recorded launch computes:
    its lane bucket's (or whole stage's) trials and, for K3, the guest
    trials it carries. Read under the flags the launch ran with."""
    st = plan.stages[r["stage"]]
    idx = (range(len(st.ms_padded)) if r["bucket"] is None
           else st.lane_buckets[r["bucket"]])

    def one(s, g):
        return (s.ms_padded[g], s.ps_padded[g],
                s.rows_eval[g] if g < len(s.rows_eval) else 0)

    out = [one(st, g) for g in idx]
    if r.get("guest") is not None:
        st2 = plan.stages[r["guest"]]
        gbase = r["args"][-2].gbase.tolist()
        out += [one(st2, g) for g, gb in zip(idx, gbase) if gb >= 0]
    return out


def trials_work(trials, D, nw, with_decode=True):
    """Operations a launch's work needs, counted from each of its
    trials' own (m, p, evaluated rows) (:func:`_trials`), not from the
    padded container: decode (sub + mul per packed sample), one add per
    sample in each of the ceil(log2 m) FFA levels, and per evaluated row
    the prefix sum plus three operations per phase and width and five
    per width."""
    from riptide_tpu_torch.ops.plan import num_levels

    ops = 0
    for m, p, re in trials:
        if with_decode:
            ops += 2 * m * p
        ops += num_levels(m) * m * p
        ops += re * (p + 3 * nw * p + 5 * nw)
    return D * ops


def _table_bytes(tables, coefs):
    return sum(x.numel() * x.element_size()
               for x in (*tables[:5], *coefs[:4], tables.gm, tables.gbase,
                         *coefs[5:]) if x is not None)


def launch_bytes(launches, view):
    """Bytes a set of recorded K1/K3 launches must move: each stage's
    wire rows and scales that any launch reads (read once, however many
    lane buckets read them), every launch's tables and coefficients, and
    its output."""
    spans = {}
    nb = 0
    for r in launches:
        geoms = [g for g in r["args"] if hasattr(g, "roff")]
        tables, coefs = r["args"][-2:]
        for g, span in zip(geoms, (tables.span, tables.gspan)):
            spans[g.roff] = max(spans.get(g.roff, 0), span)
        nb += _table_bytes(tables, coefs) + r["out"].numel() * 4
    D = launches[0]["out"].shape[0]
    PW, group, planes = view["PW"], view["group"], view["planes"]
    for span in spans.values():
        rows = -(-span // PW)
        nb += D * (planes * -(-rows // group) * PW + rows * 4)
    return nb


def compare_stages(name, got, want):
    """Each launch's kernel output against its plain version on the same
    inputs: shape, finite values and the tolerance. Prints one line and
    returns the largest absolute difference."""
    check(len(got) == len(want), f"{name}: {len(got)} outputs, want "
          f"{len(want)}")
    mx = rel = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{name}: launch {i} shape "
              f"{tuple(g.shape)} != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: launch {i} non-finite")
        err = (g - w).abs()
        smx = float(err.max())
        check(bool((err <= ATOL + RTOL * w.abs()).all()),
              f"{name}: launch {i} disagrees with its plain version "
              f"(max |err| {smx:.3e})")
        mx = max(mx, smx)
        rel = max(rel, float((err / w.abs().clamp_min(1e-30)).max()))
    print(f"  {name}: {len(got)} launches, max |kernel - plain| = {mx:.3e}, "
          f"max rel = {rel:.3e} (tolerance atol {ATOL} + rtol {RTOL} * "
          f"|plain|)", flush=True)
    return mx


def plain_launches(rec, kind):
    """The plain version of every recorded launch of ``kind``, on the
    operands that launch had."""
    from riptide_tpu_torch.ops import ffa_kernel as fk

    plain = getattr(fk, f"{kind}_plain")
    return [plain(*r["args"]) for r in rec["launches"] if r["kind"] == kind]


def kernel_outs(rec, kind):
    return [r["out"] for r in rec["launches"] if r["kind"] == kind]


def check_launches(name, launches, want):
    check(launches == want, f"{name}: launches {launches}, want {want} "
          "(quantised wire: one K1 per queued lane bucket or whole stage, "
          "one K3 per hosting bucket; float32 wire: one K2 per stage)")


def print_split(rec, D):
    """Print a recorded search's time split; returns its total seconds."""
    total = rec["prep_s"] + rec["ship_s"] + rec["stages_s"] + rec["out_s"]
    sms = rec["stage_ms"]
    top = sorted(range(len(sms)), key=lambda i: -sms[i])[:3]
    print(f"  split ({D} series): host wire prep {rec['prep_s']:.4f} s, copy "
          f"to card {rec['ship_s']:.4f} s, stage loop {rec['stages_s']:.4f} s "
          f"wall ({sum(sms) / 1e3:.4f} s between CUDA events), assemble + "
          f"copy back {rec['out_s']:.4f} s; slowest stages "
          + ", ".join(f"{i}: {sms[i]:.3f} ms" for i in top), flush=True)
    return total


def phase_oracle(dev):
    """Phase 1: the 18.5 +/- 0.15 parity oracle, on the default uint6 wire
    (K1) and on the float32 wire (device pack, then K2), the launch
    counts set to 0 just before each search and read just after. Returns
    the float32 search's recorded K2 launches, its plan and its launch
    counts (wrapper calls and CUDA launches)."""
    from riptide_tpu_torch import ffa_search, periodogram_plan
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    for mode in ("uint6", "float32"):
        ts = oracle_series()
        with wire_dtype(mode):
            fk.reset_launches()
            with engine.recording() as rec:
                _, pgram = ffa_search(ts, **ORACLE_SEARCH, device=dev)
            launches = dict(fk.LAUNCHES)
            cuda = dict(fk.KERNEL_LAUNCHES)
        ip, iw = np.unravel_index(np.argmax(pgram.snrs), pgram.snrs.shape)
        snr = float(pgram.snrs[ip, iw])
        freq = 1.0 / pgram.periods[ip]
        print(f"  {mode} wire: best S/N {snr:.4f} at width "
              f"{int(pgram.widths[iw])}, f = {freq:.6f} Hz; launches "
              f"{launches}, CUDA launches {cuda}", flush=True)
        check(abs(freq - 1.0) < 0.1 / ORACLE_SERIES["length"],
              "oracle: wrong frequency")
        check(int(pgram.widths[iw]) == 13, "oracle: wrong width")
        check(abs(snr - 18.5) < 0.15,
              f"oracle: S/N {snr} outside 18.5 +/- 0.15")
        oplan = periodogram_plan(
            ts.nsamp, ts.tsamp, tuple(int(w) for w in pgram.widths),
            ORACLE_SEARCH["period_min"], ORACLE_SEARCH["period_max"],
            ORACLE_SEARCH["bins_min"], ORACLE_SEARCH["bins_max"])
        check_launches(f"oracle, {mode} wire", launches,
                       engine.queued_launches(oplan, mode))
        check(cuda["segment_container" if mode == "float32"
                   else "segment_wire"] == sum(launches.values()),
              f"oracle, {mode} wire: CUDA launches {cuda}, want one "
              "segment launch per wrapper call")
    k2 = [r for r in rec["launches"] if r["kind"] == "cascade_stage"]
    check(len(k2) == launches["cascade_stage"] > 0,
          "oracle: K2 did not launch on the float32 wire")
    return k2, oplan, launches


def phase_headline(dev, plan, cfg=HEADLINE, period=PULSAR["period"],
                   amplitude=PULSAR["amplitude"]):
    """Phase 2, the main path: ffa_search at the headline configuration.
    Returns the launch counts of the recorded (second) search, its
    record, the K1 output's largest difference from plain, and the
    searched series."""
    from riptide_tpu_torch import ffa_search
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.ops.plan import segment_plan
    from riptide_tpu_torch.search import engine

    buckets = [st.bucket_batch(k) for st in plan.stages
               for k in range(len(st.lane_buckets))]
    t0 = time.perf_counter()
    segs = [segment_plan(b) for b in buckets]
    seg_s = time.perf_counter() - t0
    print(f"  cold segment tables (host, numpy): {seg_s:.4f} s for "
          f"{len(segs)} containers, built with their operands at a plan's "
          f"first search; {sum(b.L - g.levels for b, g in zip(buckets, segs))}"
          f" of {sum(b.L for b in buckets)} FFA levels left to the level "
          "kernel", flush=True)
    length = cfg["nsamp"] * cfg["tsamp"]
    ts = headline_series(cfg, period, amplitude)
    kw = dict(period_min=cfg["period_min"], period_max=cfg["period_max"],
              bins_min=cfg["bins_min"], bins_max=cfg["bins_max"], device=dev)
    t0 = time.perf_counter()
    ffa_search(ts, **kw)
    cold = time.perf_counter() - t0
    fk.reset_launches()
    with engine.recording() as rec:
        t0 = time.perf_counter()
        tsn, pgram = ffa_search(ts, **kw)
        warm = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    cuda = dict(fk.KERNEL_LAUNCHES)
    ntrials = pgram.periods.size
    ip, iw = np.unravel_index(np.argmax(pgram.snrs), pgram.snrs.shape)
    snr = float(pgram.snrs[ip, iw])
    dfreq = abs(1.0 / pgram.periods[ip] - 1.0 / period)
    print(f"  {ntrials} trials, {len(plan.stages)} stages, "
          f"{rec['meta']['mode']} wire; cold {cold:.3f} s, warm {warm:.3f} s "
          f"wall; launches {launches}", flush=True)
    print(f"  best S/N {snr:.3f} at P = {pgram.periods[ip]:.6f} s (injected "
          f"{period} s, |df| = {dfreq:.3e} Hz, 1/T = {1.0 / length:.3e} Hz), "
          f"width {int(pgram.widths[iw])}", flush=True)
    check(rec["meta"]["mode"] == "uint6", "the main path runs the uint6 wire")
    check(ntrials == plan.length, "trial count differs from the plan")
    check(np.isfinite(pgram.snrs).all(), "non-finite S/N")
    check(dfreq < 1.0 / length, "injected period not recovered")
    check(snr > 10.0, f"injected pulsar recovered at S/N {snr} only")
    check_launches("headline", launches, engine.queued_launches(plan))
    calls = [r["args"][-2] for r in rec["launches"]]
    old = sum(t.h.shape[0] for t in calls) + 2 * len(calls)
    print(f"  CUDA launches per headline search: {sum(cuda.values())} "
          f"{cuda} for {launches['fused_stage']} K1 wrapper calls (one "
          f"launch per FFA level took {old})", flush=True)
    check(cuda == {"segment_wire": len(calls), "segment_container": 0,
                   "ffa_level": sum(t.h.shape[0] - t.local for t in calls),
                   "boxcar_snr": len(calls)},
          f"CUDA launches {cuda}: want one segment launch from the wire and "
          "one S/N launch per K1 call, one level launch per FFA level past "
          "the tiles")
    total = print_split(rec, 1)
    print(f"  rest of the warm search (DQ scan, de-reddening, normalisation):"
          f" {warm - total:.4f} s", flush=True)
    err = compare_stages("K1 fused_stage in the search",
                         kernel_outs(rec, "fused_stage"),
                         plain_launches(rec, "fused_stage"))
    return launches, rec, err, tsn.data, seg_s


def check_levels(name, sources):
    """Each (source, tables) pair: the container after the segment kernel
    and after every global level (``segment_levels``) against the plain
    levels (``ffa_levels`` over the same leading levels of the plain
    fill), bit for bit, signs of zeros included. Prints one line."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.ops.ffa import ffa_levels

    n = 0
    for src, tables in sources:
        L, loc = tables.h.shape[0], tables.local
        want = fk.fill_plain(src, tables)
        for g in range(L - loc + 1):
            a, z = (0, loc) if g == 0 else (loc + g - 1, loc + g)
            want = ffa_levels(want, tables.h[a:z], tables.t[a:z],
                              tables.shift[a:z], tables.p)
            got = fk.segment_levels(src, tables, g)
            check(torch.equal(got, want)
                  and torch.equal(torch.signbit(got), torch.signbit(want)),
                  f"{name}: the container after the segment kernel and "
                  f"{g} global levels is not the plain levels' bits")
            n += 1
    print(f"  {name}: the containers after the segment kernel and every "
          f"global level, {n} in {len(sources)} launches, are the plain "
          "levels' bits", flush=True)


def k2_work(launches, plan, conts):
    """(bytes, operations) of K2 over recorded launches on their packed
    containers: each container read once, its tables and coefficients,
    its output written; the levels and the S/N of its trials."""
    nb = ops = 0
    nw = len(plan.widths)
    for r, x in zip(launches, conts):
        tables, coefs = r["args"][-2:]
        nb += x.numel() * 4 + _table_bytes(tables, coefs) + r["out"].numel() * 4
        ops += trials_work(_trials(plan, r), x.shape[0], nw, False)
    return nb, ops


def phase_kernels(dev, plan, rec, oracle):
    """Phase 3: K1 and K2 on every launch of the headline search, on the
    operands each launch had, and K2 on the float32 oracle's launches
    (``oracle``: the recorded launches and their plan), K2's own path.
    Returns K2's largest difference from plain there and, per kernel,
    (device ms, plain ms, bound ms, bound by) of one pass over its
    path's launches: K1 over the headline search's, K2 over the
    oracle's."""
    from riptide_tpu_torch.ops import ffa_kernel as fk

    k1 = [r for r in rec["launches"] if r["kind"] == "fused_stage"]
    D = rec["wire"].shape[0]
    nw = len(plan.widths)
    args = [r["args"] for r in k1]
    conts = [fk.decode_pack_plain(w, s, g, t, t.h.shape[2])
             for w, s, g, t, _ in args]
    tc = [a[-2:] for a in args]
    check_levels("K1 levels", [(fk.WireSource(*a[:3]), a[3]) for a in args])
    check_levels("K2 levels", [(x, t) for x, (t, _) in zip(conts, tc)])

    def k2_plain(xs=conts, tcs=tc):
        return [fk.cascade_stage_plain(x, t, c) for x, (t, c) in zip(xs, tcs)]

    # cascade_stage uses its input as level scratch: the check gets
    # fresh copies; the timed calls reuse one set (the work does not
    # depend on the values).
    compare_stages("K2 cascade_stage on K1's containers",
                   [fk.cascade_stage(x.clone(), t, c)
                    for x, (t, c) in zip(conts, tc)], k2_plain())
    scratch = [x.clone() for x in conts]

    def k2(xs=scratch, tcs=tc):
        return [fk.cascade_stage(x, t, c) for x, (t, c) in zip(xs, tcs)]

    def k1_calls():
        return [fk.fused_stage(*a) for a in args]

    ms1 = measure.graph_ms(k1_calls, dev, REPS)
    wms1 = measure.median_ms(k1_calls, dev, REPS)
    pms1 = measure.median_ms(
        lambda: [fk.fused_stage_plain(*a) for a in args], dev, reps=5)
    ms2 = measure.graph_ms(k2, dev, REPS)
    wms2 = measure.median_ms(k2, dev, REPS)
    pms2 = measure.median_ms(k2_plain, dev, reps=5)

    ops1 = design = 0
    for r, x in zip(k1, conts):
        tables = r["args"][-2]
        ops1 += trials_work(_trials(plan, r), D, nw, True)
        # The cascade's own traffic: the segment kernel's write, each
        # global level's read and write, the S/N's read.
        design += (2 * (tables.h.shape[0] - tables.local) + 2) * \
            x.numel() * 4
    b1 = measure.bound_ms(launch_bytes(k1, rec["meta"]["view"]), ops1)
    b2 = measure.bound_ms(*k2_work(k1, plan, conts))
    print(f"  K1 over the headline search's {len(k1)} launches, D = {D}: "
          f"{ms1:.4f} ms device, from CUDA graph replays ({wms1:.4f} ms "
          f"through the wrappers; plain {pms1:.4f} ms, bound {b1[0]:.4f} ms "
          f"by {b1[1]})", flush=True)
    print(f"  K2 on K1's {len(k1)} containers: {ms2:.4f} ms device "
          f"({wms2:.4f} ms through the wrappers; plain {pms2:.4f} ms, bound "
          f"{b2[0]:.4f} ms by {b2[1]})", flush=True)
    print(f"  K1's own device-memory traffic in the cascade (the segment "
          f"kernel's write, each global level's read and write, the S/N's "
          f"read; the wire aside): {design / 1e9:.4f} GB, "
          f"{design / measure.PEAK_BYTES_PER_S * 1e3:.4f} ms at the memory "
          "rate", flush=True)

    okern, oplan = oracle
    oargs = [r["args"] for r in okern]
    err2 = compare_stages("K2 cascade_stage in the float32 oracle",
                          kernel_outs({"launches": okern}, "cascade_stage"),
                          [fk.cascade_stage_plain(*a) for a in oargs])
    scratch = [a[0].clone() for a in oargs]
    ok2 = [(x,) + tuple(a[1:]) for x, a in zip(scratch, oargs)]
    check_levels("K2 levels (float32 oracle)",
                 [(a[0], a[1]) for a in oargs])

    def ok2_calls():
        return [fk.cascade_stage(*a) for a in ok2]

    oms = measure.graph_ms(ok2_calls, dev, REPS)
    owms = measure.median_ms(ok2_calls, dev, REPS)
    opms = measure.median_ms(
        lambda: [fk.cascade_stage_plain(*a) for a in oargs], dev, reps=5)
    ob = measure.bound_ms(*k2_work(okern, oplan, [a[0] for a in oargs]))
    print(f"  K2 over the oracle's {len(oargs)} float32 launches: "
          f"{oms:.4f} ms device ({owms:.4f} ms through the wrappers; plain "
          f"{opms:.4f} ms, bound {ob[0]:.4f} ms by {ob[1]})", flush=True)
    return err2, {"K1": (ms1, pms1, *b1), "K2": (oms, opms, *ob)}


def profile_search(plan, data, dev, trace_dir):
    """``--profile``: one run_periodogram of ``data`` under torch.profiler.
    Prints device time by kernel name and the device's busy share of the
    profiled window, and writes the Chrome trace to ``trace_dir``."""
    from torch.autograd import DeviceType

    from riptide_tpu_torch.search import run_periodogram
    from riptide_tpu_torch.timing import device_trace

    with device_trace(trace_dir) as prof:
        t0 = time.perf_counter()
        run_periodogram(plan, data, device=dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print("  profiler recorded no device events", flush=True)
        return
    by_name = {}
    for e in kern:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"  profiled run_periodogram: {wall_us / 1e3:.3f} ms wall, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.2f} %)",
          flush=True)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"    {us / 1e3:10.3f} ms  {n:5d} x  {name[:90]}", flush=True)


def phase_batch(dev, plan, D=32, seed=2):
    """Phase 4: run_periodogram_batch with D DM trials; the second run is
    recorded and its K1 outputs held against plain."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine, run_periodogram_batch

    batch = noise_batch(plan, D, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run_periodogram_batch(plan, batch, device=dev)
    first = time.perf_counter() - t0
    fk.reset_launches()
    with engine.recording() as rec:
        t0 = time.perf_counter()
        _, _, snrs = run_periodogram_batch(plan, batch, device=dev)
        warm = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    check(snrs.shape == (D, plan.length, len(plan.widths)),
          f"batch S/N shape {snrs.shape}")
    check(np.isfinite(snrs).all(), "non-finite batch S/N")
    check_launches(f"D = {D}", launches, engine.queued_launches(plan))
    print(f"  D = {D}: {warm:.3f} s warm wall (first {first:.3f} s), "
          f"{D / warm:.3f} DM-trials/s, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; launches {launches}", flush=True)
    print_split(rec, D)
    compare_stages(f"K1 fused_stage at D = {D}",
                   kernel_outs(rec, "fused_stage"),
                   plain_launches(rec, "fused_stage"))


@contextlib.contextmanager
def layout_flags(flags):
    """Set the container flags of one phase 5 run (the others unset)."""
    saved = {k: os.environ.get(k) for k in LAYOUT_FLAGS}
    for k in LAYOUT_FLAGS:
        os.environ.pop(k, None)
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def noise_batch(plan, D, seed):
    """D series of seeded float32 white noise, ``plan.size`` samples."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((D, plan.size), dtype=np.float32)


def survey_batch(plan, D, seed=3, cfg=HEADLINE):
    """D normalised noise series with the phase 2 pulsar in series 0."""
    from riptide_tpu_torch.libffa import generate_signal

    batch = noise_batch(plan, D, seed)
    np.random.seed(seed)
    x = generate_signal(plan.size, PULSAR["period"] / cfg["tsamp"],
                        amplitude=PULSAR["amplitude"], ducy=0.05)
    batch[0] = (x - x.mean()) / x.std()
    return batch


def phase_survey(dev, plan, D=32, cfg=HEADLINE, want_pairs=HEADLINE_PAIRS):
    """Phase 5: run_search_batch from one prepared wire under the three
    layouts (``want_pairs`` pairs in run (b)). Returns run (b)'s K3
    launch count, largest difference from plain and (ms, plain ms, bound
    ms, bound by) over its launches."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    tobs = cfg["nsamp"] * cfg["tsamp"]
    nw = len(plan.widths)
    batch = survey_batch(plan, D, cfg=cfg)
    t0 = time.perf_counter()
    prepared = engine.prepare_stage_data(plan, batch)
    prep = time.perf_counter() - t0
    view = prepared[1]["view"]
    print(f"  D = {D}: one host wire prep {prep:.3f} s", flush=True)
    runs = {}
    for name, flags in LAYOUTS:
        with layout_flags(flags):
            saved = plan.__dict__.pop("_view_layouts")
            fresh = engine._view_layout(plan, "uint6")
            plan._view_layouts = saved
            check(_same_layout(fresh, view),
                  f"run ({name}): the wire layout depends on the flags")
            rpm = engine._row_pack_map(plan, "uint6")
            pairs = sum(v[0] == "host" for v in rpm.values())
            absorbed = sum(v[0] == "guest" for v in rpm.values())
            dms = np.zeros(D)
            engine.run_search_batch(plan, None, tobs, dms=dms,
                                    prepared=prepared, device=dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            fk.reset_launches()
            with engine.recording() as rec:
                t0 = time.perf_counter()
                handle = engine.queue_search_batch(plan, None, tobs,
                                                   prepared=prepared,
                                                   device=dev)
                snr = engine.search_snr_dev(handle)
                peaks, _ = engine.collect_search_batch(handle, dms)
                wall = time.perf_counter() - t0
            launches = dict(fk.LAUNCHES)
            want = engine.queued_launches(plan)
            k3 = [r for r in rec["launches"] if r["kind"] == "paired_stage"]
            k3_trials = [_trials(plan, r) for r in k3]
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        sms = rec["stage_ms"]
        print(f"  run ({name}) {flags or 'defaults'}: {pairs} pairs, "
              f"{absorbed} absorbed buckets; launches {launches}; "
              f"{wall:.3f} s wall without the host prep, "
              f"{D / wall:.3f} DM-trials/s ({D / (wall + prep):.3f} with "
              f"it), peak device memory {peak / 2 ** 30:.3f} GiB", flush=True)
        print(f"    split: copy to card {rec['ship_s']:.4f} s, stage loop "
              f"{rec['stages_s']:.4f} s wall ({sum(sms) / 1e3:.4f} s between "
              f"CUDA events), assembly {rec['assemble_s']:.4f} s, peak program "
              f"{rec['peaks_s']:.4f} s, pull + host tail "
              f"{rec['collect_s']:.4f} s", flush=True)
        check_launches(f"run ({name})", launches, want)
        check(np.isfinite(snr.cpu().numpy()).all() and snr.shape == (
            D, plan.length, nw), f"run ({name}): S/N cube {tuple(snr.shape)}")
        runs[name] = dict(pairs=pairs, absorbed=absorbed, launches=launches,
                          snr=snr, peaks=peaks, rec=rec, k3=k3,
                          k3_trials=k3_trials)
    a, b, c = runs["a"], runs["b"], runs["c"]
    check(a["pairs"] == c["pairs"] == 0 and b["pairs"] == want_pairs,
          f"pairs {a['pairs']}, {b['pairs']}, {c['pairs']}: want 0, "
          f"{want_pairs}, 0")
    check(a["launches"]["paired_stage"] == c["launches"]["paired_stage"] == 0
          and b["launches"]["paired_stage"] == want_pairs,
          "K3 must launch once per pair in run (b) and never in (a), (c)")
    check(b["launches"]["fused_stage"] + b["launches"]["paired_stage"]
          == c["launches"]["fused_stage"] - b["absorbed"],
          "run (b) must launch one bucket fewer than (c) per absorbed bucket")
    check(torch.equal(a["snr"], b["snr"]) and torch.equal(a["snr"], c["snr"]),
          "the three layouts' S/N cubes differ")
    check(a["peaks"] == b["peaks"] == c["peaks"],
          "the three layouts' peak lists differ")
    best = b["peaks"][0][0] if b["peaks"][0] else None
    check(best is not None, "no peak in series 0")
    dfreq = abs(best.freq - 1.0 / PULSAR["period"])
    print(f"  S/N cubes bitwise equal, peak lists identical "
          f"({sum(map(len, b['peaks']))} peaks); series 0: best S/N "
          f"{best.snr:.3f} at P = {best.period:.6f} s, width {best.width} "
          f"(|df| = {dfreq:.3e} Hz, 1/T = {1.0 / tobs:.3e} Hz)", flush=True)
    check(dfreq < 1.0 / tobs, "series 0: injected pulsar not recovered")

    k3, args = b["k3"], [r["args"] for r in b["k3"]]
    check_levels("K3 levels", [(fk.WireSource(*x[:4]), x[4]) for x in args])
    err = compare_stages("K3 paired_stage in run (b)", [r["out"] for r in k3],
                         plain_launches(b["rec"], "paired_stage"))

    def k3_calls():
        return [fk.paired_stage(*x) for x in args]

    ms = measure.graph_ms(k3_calls, dev, REPS)
    wms = measure.median_ms(k3_calls, dev, REPS)
    pms = measure.median_ms(
        lambda: [fk.paired_stage_plain(*x) for x in args], dev, reps=5)
    ops = sum(trials_work(t, D, nw) for t in b["k3_trials"])
    bnd = measure.bound_ms(launch_bytes(k3, view), ops)
    print(f"  K3 over run (b)'s {len(k3)} hosted buckets, D = {D}: "
          f"{ms:.4f} ms device, from CUDA graph replays ({wms:.4f} ms "
          f"through the wrappers; plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"by {bnd[1]})", flush=True)
    return b["launches"]["paired_stage"], err, (ms, pms, *bnd)


def phase_probes(dev):
    """Phase 6: the chip probes through their entry points. Returns one
    ``kernels`` entry per probe: its launches in the run, the largest
    difference from plain, and the sums over its patterns of kernel ms
    (the entry point's device time per call, from CUDA graph replays),
    plain ms and bound ms."""
    from riptide_tpu_torch.probes import probe1536, ptime, ptime2

    probes = (("P1", "P1 ptime", ptime, ["all"], "tools/ptime.py:86"),
              ("P2", "P2 ptime2", ptime2, list(ptime2.BODIES),
               "tools/ptime2.py:28"),
              ("P3", "P3 probe1536", probe1536, [], "tools/probe1536.py:84"))
    torch.backends.cuda.matmul.allow_tf32 = False
    for _, _, mod, _, _ in probes:
        mod.reset_launches()
    results = {key: mod.main(argv) for key, _, mod, argv, _ in probes}
    launches = {key: dict(mod.LAUNCHES) for key, _, mod, _, _ in probes}
    print(f"  launches {launches}", flush=True)
    for key, counts in launches.items():
        idle = sorted(k for k, n in counts.items() if n == 0)
        check(not idle, f"{key}: kernels {idle} never launched in the run")
    entries = []
    for key, name, mod, _, replaces in probes:
        err = ms = pms = 0.0
        bounds = {"bytes": 0.0, "operations": 0.0}
        lib_ms = None
        for r in results[key]:
            plain = getattr(mod, f"{r.wrapper}_plain")
            if key == "P2":
                want, p_ms = measure.timed(lambda: plain(*r.args), dev)
            else:
                want = plain(*r.args)
                p_ms = measure.median_ms(lambda: plain(*r.args), dev, reps=5)
            check(r.out.shape == want.shape
                  and bool(torch.isfinite(r.out).all()),
                  f"{key} {r.name}: output {tuple(r.out.shape)} not finite "
                  f"or not {tuple(want.shape)}")
            e = float((r.out - want).abs().max())
            if r.wrapper == "matmul":
                check(torch.allclose(r.out, want, rtol=PROBE_MM_RTOL,
                                     atol=PROBE_MM_ATOL),
                      f"{key} {r.name}: max |kernel - plain| {e:.3e}")
                a, x, reps = r.args
                lib_ms = measure.median_ms(
                    lambda: [torch.matmul(a, x) for _ in range(r.passes)],
                    dev, REPS)
            else:
                check(torch.equal(r.out, want), f"{key} {r.name}: not the "
                      f"plain version's bits (max |err| {e:.3e})")
            check(r.ok is not False, f"{key} {r.name}: differs from the "
                  "tool's numpy sequence")
            bms, by = r.bound()
            bounds[by] += bms
            err, ms, pms = max(err, e), ms + r.ms, pms + p_ms
            print(f"  {key} {r.name}: max |kernel - plain| {e:.3e}; kernel "
                  f"{r.ms:.4f} ms, plain {p_ms:.4f} ms, bound {bms:.6f} ms by "
                  f"{by}", flush=True)
        bms = sum(bounds.values())
        by = max(bounds, key=bounds.get)
        print(f"  {key}: {len(results[key])} patterns, kernels {ms:.4f} ms "
              f"(plain {pms:.4f} ms, bound {bms:.4f} ms, mostly by {by}"
              + (f"; {r.passes} x torch.matmul {lib_ms:.4f} ms"
                 if lib_ms is not None else "") + ")", flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "riptide_tpu_torch/csrc/probes.cu",
            "replaces": replaces,
            "launches": sum(launches[key].values()), "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms,
        })
    return entries


def _same_layout(x, y):
    return x.keys() == y.keys() and all(
        np.array_equal(np.asarray(x[k]), np.asarray(y[k])) for k in x)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one headline run_periodogram with "
                         "torch.profiler; the Chrome trace goes to DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.probes import common as probes

    dev = torch.device("cuda")
    card = gpu_line()
    print(f"phase 0: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    libs = (fk._LIB, probes.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        for done in [pool.submit(lib.build) for lib in libs]:
            done.result()
    for lib in libs:
        lib.load()
    print(f"  kernel builds + loads {time.perf_counter() - t0:.2f} s, "
          "together", flush=True)
    for lib in libs:
        print(f"  {lib.source.name}: nvcc {lib.info['seconds']:.2f} s -> "
              f"{lib.info['path']}", flush=True)
        for line in lib.info["log"].splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line
                                         or "spill" in line):
                print("  " + line.strip(), flush=True)

    plan = headline_plan()
    check(plan.length == HEADLINE_TRIALS, f"plan has {plan.length} trials")
    print("phase 1: parity oracle", flush=True)
    *oracle, k2_launches = phase_oracle(dev)
    print("phase 2: headline ffa_search (main path)", flush=True)
    launches, rec, err1, data, _ = phase_headline(dev, plan)
    print("phase 3: K1 and K2 on their paths' launches", flush=True)
    err2, times = phase_kernels(dev, plan, rec, oracle)
    del rec, oracle
    print("phase 4: run_periodogram_batch, D = 32", flush=True)
    phase_batch(dev, plan)
    print("phase 5: run_search_batch, D = 32, three container layouts",
          flush=True)
    n3, err3, times["K3"] = phase_survey(dev, plan)
    print("phase 6: chip probes P1-P3 through their entry points",
          flush=True)
    t6 = time.perf_counter()
    probe_entries = phase_probes(dev)
    print(f"  phase 6: {time.perf_counter() - t6:.1f} s wall", flush=True)
    if args.profile:
        print("profile: headline run_periodogram", flush=True)
        profile_search(plan, data, dev, args.profile)

    # Each kernel's launches on its own path, counted from 0 just before
    # that path's run: K1 the headline search (phase 2), K2 the float32
    # oracle search (phase 1), K3 the survey run (b) (phase 5).
    entries = []
    launches["cascade_stage"] = k2_launches["cascade_stage"]
    launches["paired_stage"] = n3
    for key, name, fn, line, err in (
            ("K1", "K1 fused_stage", "fused_stage", 473, err1),
            ("K2", "K2 cascade_stage", "cascade_stage", 266, err2),
            ("K3", "K3 paired_stage", "paired_stage", 568, err3)):
        ms, pms, bms, by = times[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "riptide_tpu_torch/csrc/ffa_stage.cu",
            "replaces": f"riptide_tpu/ops/ffa_kernel.py:{line}",
            "launches": launches[fn], "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
        })
    entries += probe_entries
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
