#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``riptide_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the cascade-stage kernels (``riptide_tpu_torch/csrc/ffa_stage.cu``)
and the chip probes' kernels (``riptide_tpu_torch/csrc/probes.cu``) from
this checkout with nvcc, and the native host runtime
(``riptide_tpu_torch/native/src/riptide_native.cpp``) with g++, one
process each, started together, then:

0. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, the kernel build time, the native build's g++ seconds,
   the host's cores and the prep threads in use; fails unless the
   native runtime loaded (every wire the script records must be the
   native prep's, ``meta["prep"]``);
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
   held against ``fused_stage_plain`` on the same operands. The rest of
   the warm search is split into the data-quality steps
   (``quality.scan_samples``, ``fill_masked``, ``TimeSeries.deredden``,
   ``normalise``), and the wire prep is timed by the native runtime (the
   engine's) and by the numpy path (called directly) in this call, the
   two wires and scales the same bits;
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
   and every K1 launch's output against its plain version; the prep by
   both paths, twice each (wall and process CPU seconds), the wires and
   scales the same bits;
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
   bit for bit, and K3 is timed over all of them. The prep is timed by
   both paths (the same bits), and one two-chunk survey runs with the
   prep overlapped: chunk 2 is prepared on a worker thread into a pinned
   ``StagingPool`` while the card runs chunk 1, twice (the second pass
   from recycled buffers);
5f. the file entry points: the phase 2 series written by this script as
   a PRESTO .inf/.dat pair and as 32-bit and 8-bit SIGPROC files, read
   back with ``TimeSeries.from_presto_inf`` / ``from_sigproc`` and
   searched with ``ffa_search`` (counts set to 0 just before each search
   and read just after): the 32-bit reads give the in-memory search's
   S/N bits, the 8-bit read recovers the pulsar;
5w. wide phases: three searches whose padded width P crosses 14,528 (the
   S/N kernel's 4-row shared memory), 29,056 (a segment tile's row
   pair) and 58,112 (one S/N row), each on the uint6 wire (K1) and the
   float32 wire (K2), every launch held against its plain version;
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
   (P2's plain versions run once, at the full NITER) and its bound. P1's
   GEMM (four products, device time from CUDA graph replays) is printed
   beside four ``torch.matmul`` calls timed alike, and its ratio to them;
   its entry in the ``kernels`` line carries both (``gemm_ms``,
   ``library_ms``). P1's other 26 patterns are summed in three parts, each
   beside its bound: the gathering patterns (lane and row rolls, select,
   dynroll, stride roll), the loop patterns (add, barrel, the interleaves,
   the parity select) and the tile sweep (``gathering_ms``, ``loop_ms``,
   ``tile_ms`` in P1's entry). The launches of each CUDA kernel of
   ``probes.cu`` are counted too (``common.KERNEL_LAUNCHES``, set to 0
   with the others) and each must be non-zero; the launch floor, an
   empty kernel timed as the patterns are, is printed beside them.

7. the pipeline (``rffa``) at full width: 48 PRESTO DM trials of the
   headline series (2^23 samples at 64 us, 1.5 GiB, written by this
   script under the build directory and removed at the end), the phase
   2 pulsar's amplitude peaking at the middle trial, the trials 2 pc
   cm^-3 apart so that ``DMIterator`` keeps all 48 (checked), through
   ``Pipeline(config, device="cuda").process`` with ``processes: 16``
   (three chunks of 16, each prepared while the card runs the one
   before) and the headline's range, the config a dict (no YAML, no
   plots). The launch counts are set to 0 just before and read just
   after: K1 ran ``queued_launches(plan)`` times a chunk. Each trial's
   peaks must be ``run_search_batch``'s on the same chunk's loaded and
   prepared series (the same S/N bits); those reruns are recorded, and
   each of their K1 launches (D = 16, the pipeline's shapes) is held
   against its plain version as in phase 3. The top candidate must be
   the pulsar at the brightest trial's DM, and every product written
   and loaded back with ``load_json``. Prints whether pandas, PyYAML and
   matplotlib are importable, each stage's wall, the search's spans per
   chunk (stage, ship, queue, collect), DM-trials/s of the pipeline and
   of its search, and peak device memory. Then ``rseek`` on the
   headline series as a PRESTO file with ``--device cuda``: its table
   must list the pulsar.
8. the checkpointed survey path on phase 7's trials and config, through
   ``Pipeline(config, device, journal=..., resume=..., trace=...)``,
   each run's launch counts set to 0 just before and read just after:
   (a) journaled with integrity off and with ``RIPTIDE_INTEGRITY=probe``
   every chunk (each chunk dispatched twice; its two result digests
   must agree, K1 must run twice ``queued_launches`` a chunk, and the
   products must be phase 7's bytes); (b) ``abort:1``, the journal
   holding chunk 0 only, then ``resume=True``: chunk 0 replayed (K1 on
   chunks 1-2 only), the products phase 7's bytes; (c) ``bitflip:1``
   under ``probe``: exactly one ``result_mismatch``, the three-way vote
   keeps the majority, the same bytes; (d) the integrity canary twice
   on the card, the same digest, and the package's pin for this card
   (``survey/integrity_canary.json``) where it has one; (e) a real
   ``torch.cuda.OutOfMemoryError`` is an OOM and not a device error;
   (f) the probe run's ``trace.json`` holds one ``chunk`` span per chunk
   with its stage, ship, queue and collect spans. Prints each run's
   wall and DM-trials/s beside phase 7's, the resume's wall, the
   journal's bytes and fsyncs by file, and the card; K1's launches over
   phase 8 go into its ``kernels`` entry as ``journal_launches``.

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
# Phase 6: the hand-written 3xTF32 GEMM against torch.matmul in full
# float32 (sums of 2048 products in another order, each operand split
# into two TF32 parts to ~2^-22 relative; outputs ~1-4).
PROBE_MM_RTOL, PROBE_MM_ATOL = 1e-5, 1e-5


# Phase 7: the pipeline on PIPE_FILES DM trials of the headline series,
# PIPE_CHUNK trials a chunk, the trials PIPE_DM_STEP apart (DMIterator
# keeps every one: each trial's coverage radius is 1.59 pc cm^-3 at the
# headline's 2.08 ms narrowest pulse), the pulsar's amplitude a Gaussian
# of PIPE_SPREAD trials over them, peaking at the middle one.
PIPE_FILES, PIPE_CHUNK, PIPE_DM_STEP, PIPE_SPREAD = 48, 16, 2.0, 4.0
PIPE_RANGE = dict(fpmin=8, wtsp=1.5, ducy_max=0.2)
PIPE_FIND_PEAKS = dict(smin=7.0)
PRODUCTS = ("peaks.csv", "clusters.csv", "candidates.csv")
# Phase 8: the journaled runs' integrity flags (every chunk probed).
PROBE_ENV = {"RIPTIDE_INTEGRITY": "probe", "RIPTIDE_INTEGRITY_PROBE_EVERY": "1"}


# Phase 5w: searches across the kernels' wide-phase limits: (the limit
# the padded width P crosses, nsamp, tsamp, bins_min, bins_max); the
# period range is bins_max to 1.001 * bins_max samples (2-7 stages).
WIDE = ((14528, 2 ** 18, 16e-6, 16000, 16008),
        (29056, 2 ** 19, 16e-6, 30000, 30008),
        (58112, 2 ** 20, 16e-6, 60000, 60008))
WIDE_WIDTHS = (1, 2, 4, 8, 16)

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


@contextlib.contextmanager
def dq_steps():
    """Host seconds of each data-quality step in the searches run inside
    the block (``quality.prepare_time_series``' steps, wrapped for the
    block, from any thread): yields {step: [calls, seconds]}."""
    import threading

    from riptide_tpu_torch import quality
    from riptide_tpu_torch.time_series import TimeSeries

    steps = {}
    lock = threading.Lock()
    targets = [(quality, "scan_samples"), (quality, "fill_masked"),
               (TimeSeries, "deredden"), (TimeSeries, "normalise")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]

    def wrap(name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    c = steps.setdefault(name, [0, 0.0])
                    c[0] += 1
                    c[1] += time.perf_counter() - t0
        return timed

    for obj, name, fn in saved:
        setattr(obj, name, wrap(name, fn))
    try:
        yield steps
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


@contextlib.contextmanager
def gc_pauses():
    """Python's garbage-collector passes during the block: yields a list
    that gets (generation, ms, seconds since the block began) for each."""
    import gc

    pauses, t = [], {}
    t0 = time.perf_counter()

    def hook(phase, info):
        if phase == "start":
            t["start"] = time.perf_counter()
        elif "start" in t:
            now = time.perf_counter()
            pauses.append((info["generation"], (now - t.pop("start")) * 1e3,
                           now - t0))

    gc.callbacks.append(hook)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(hook)


def _prep_run(fn):
    """(output, wall s, process CPU s of all its threads) of one prep."""
    c0, t0 = time.process_time(), time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, time.process_time() - c0


def prep_both(plan, batch, name, reps=1, mode="uint6"):
    """The wire prep of ``batch`` by the native runtime (the engine's
    ``prepare_stage_data``) and by the numpy path
    (``engine._prepare_uint_numpy``, called directly), ``reps`` times
    each in turns, in this call: prints wall and process CPU seconds
    (CPU seconds that move with the wall point at the work, not at
    waiting), and checks that the two paths' wires and scales are the
    same bits.
    Returns the first native result and {path: [wall s, ...]}."""
    from riptide_tpu_torch.search import engine

    walls = {"native": [], "numpy": []}
    first = {}
    for _ in range(reps):
        for path in ("native", "numpy"):
            if path == "native":
                out, wall, cpu = _prep_run(
                    lambda: engine.prepare_stage_data(plan, batch, mode=mode))
                check(out[1]["prep"] == "native",
                      f"{name}: the engine's prep took the {out[1]['prep']} "
                      "path")
            else:
                out, wall, cpu = _prep_run(
                    lambda: engine._prepare_uint_numpy(plan, batch, mode))
            first.setdefault(path, out)
            walls[path].append(wall)
            print(f"  {name} wire prep, {path}: {wall:.4f} s wall, "
                  f"{cpu:.4f} s process CPU", flush=True)
    (nwire, nmeta), (pwire, pscales) = first["native"], first["numpy"]
    check(np.array_equal(nwire, pwire) and np.array_equal(nmeta["scales"],
                                                          pscales),
          f"{name}: the native and numpy wires or scales differ")
    print(f"  {name}: native and numpy wires ({nwire.nbytes / 2 ** 20:.1f} "
          f"MiB) and scales the same bits; native "
          f"{min(walls['native']):.4f} s against numpy "
          f"{min(walls['numpy']):.4f} s (fastest of {reps})", flush=True)
    return first["native"], walls


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
    with engine.recording() as rec, dq_steps() as steps, gc_pauses() as gcs:
        t0 = time.perf_counter()
        tsn, pgram = ffa_search(ts, **kw)
        warm = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    cuda = dict(fk.KERNEL_LAUNCHES)
    check(rec["meta"]["prep"] == "native",
          f"headline: the wire was made by the {rec['meta']['prep']} prep")
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
    dq = sum(sec for _, sec in steps.values())
    print(f"  rest of the warm search: {warm - total:.4f} s, of which "
          + ", ".join(f"{k} {sec:.4f} s ({n} calls)"
                      for k, (n, sec) in steps.items())
          + (f", fill_masked 0 calls" if "fill_masked" not in steps else "")
          + f"; other host work {warm - total - dq:.4f} s", flush=True)
    print(f"  garbage-collector passes in the warm search: {len(gcs)} "
          f"({sum(g == 2 for g, _, _ in gcs)} of generation 2), "
          f"{sum(ms for _, ms, _ in gcs):.3f} ms in all; the longest "
          + ", ".join(f"gen {g} {ms:.3f} ms ending at {at:.4f} s"
                      for g, ms, at in sorted(gcs, key=lambda x: -x[1])[:3])
          + f" (the stage loop ran from "
          f"{warm - rec['out_s'] - rec['stages_s']:.4f} to "
          f"{warm - rec['out_s']:.4f} s of the search)", flush=True)
    err = compare_stages("K1 fused_stage in the search",
                         kernel_outs(rec, "fused_stage"),
                         plain_launches(rec, "fused_stage"))
    prep_both(plan, tsn.data[None], "headline D = 1")
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
    check(rec["meta"]["prep"] == "native",
          f"D = {D}: the wire was made by the {rec['meta']['prep']} prep")
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
    del rec
    prep_both(plan, batch, f"D = {D} batch", reps=2)


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
    prepared, walls = prep_both(plan, batch, f"D = {D} survey")
    prep = walls["native"][0]
    view = prepared[1]["view"]
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
                          k3_trials=k3_trials, wall=wall)
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
    overlapped_survey(dev, plan, D, batch, a["peaks"], a["wall"],
                      walls, cfg)

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


def write_presto(path, data, tsamp, dm=0.0):
    """Write a float32 series as a PRESTO .inf/.dat pair (``path`` +
    ".inf"/".dat"): PRESTO's header lines with their '=' at column 40,
    ``tsamp`` and ``dm`` written exactly (repr). Returns the .inf path."""
    lines = (
        ("Data file name without suffix", os.path.basename(path)),
        ("Telescope used", "Parkes"), ("Instrument used", "Multibeam"),
        ("Object being observed", "Pulsar"),
        ("J2000 Right Ascension (hh:mm:ss.ssss)", "00:00:01.0000"),
        ("J2000 Declination     (dd:mm:ss.ssss)", "-00:00:01.0000"),
        ("Data observed by", "chip_smoke"),
        ("Epoch of observation (MJD)", "59000.000000"),
        ("Barycentered?           (1=yes, 0=no)", "1"),
        ("Number of bins in the time series", str(data.size)),
        ("Width of each time series bin (sec)", repr(float(tsamp))),
        ("Any breaks in the data? (1=yes, 0=no)", "0"),
        ("Type of observation (EM band)", "Radio"),
        ("Beam diameter (arcsec)", "981"),
        ("Dispersion measure (cm-3 pc)", repr(float(dm))),
        ("Central freq of low channel (Mhz)", "1182.1953125"),
        ("Total bandwidth (Mhz)", "400"), ("Number of channels", "1024"),
        ("Channel bandwidth (Mhz)", "0.390625"),
        ("Data analyzed by", "chip_smoke"))
    with open(path + ".inf", "w") as fobj:
        fobj.write("".join(f" {k}".ljust(40) + f"=  {v}\n" for k, v in lines))
    np.asarray(data, np.float32).tofile(path + ".dat")
    return path + ".inf"


def write_sigproc(path, data, tsamp, nbits):
    """Write a one-channel SIGPROC time series: float32 (nbits 32) or
    signed 8-bit samples (nbits 8, the 'signed' key set)."""
    import struct

    def key(k):
        return struct.pack("i", len(k)) + k.encode()

    hdr = key("HEADER_START") + key("source_name") + key("Pulsar")
    for k, v in (("src_raj", 1.0), ("src_dej", -1.0), ("tstart", 59000.0),
                 ("tsamp", float(tsamp)), ("refdm", 0.0)):
        hdr += key(k) + struct.pack("d", v)
    for k, v in (("nbits", nbits), ("nchans", 1), ("nifs", 1)):
        hdr += key(k) + struct.pack("i", v)
    if nbits == 8:
        hdr += key("signed") + struct.pack("B", 1)
    hdr += key("HEADER_END")
    payload = np.asarray(data, np.float32 if nbits == 32 else np.int8)
    with open(path, "wb") as fobj:
        fobj.write(hdr + payload.tobytes())
    return path


def phase_files(dev, plan, ts, cfg=HEADLINE, period=PULSAR["period"]):
    """Phase 5f: the headline series ``ts`` written as a PRESTO pair and as
    32-bit and 8-bit SIGPROC files, read back with the loaders and
    searched with ffa_search, the counts set to 0 just before each
    search and read just after. The 32-bit reads must give the in-memory
    search's S/N bits; the 8-bit read (the series at 16 steps per unit,
    clipped to int8) must recover the pulsar."""
    import tempfile

    from riptide_tpu_torch import TimeSeries, ffa_search
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine
    from riptide_tpu_torch.utils.cuda_build import BUILD_DIR

    kw = dict(period_min=cfg["period_min"], period_max=cfg["period_max"],
              bins_min=cfg["bins_min"], bins_max=cfg["bins_max"], device=dev)
    length = cfg["nsamp"] * cfg["tsamp"]
    _, want = ffa_search(ts, **kw)
    q8 = np.clip(np.rint(ts.data * 8.0), -128, 127)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        base = os.path.join(tmp, "headline")
        files = (("PRESTO .inf/.dat", TimeSeries.from_presto_inf,
                  write_presto(base, ts.data, ts.tsamp), True),
                 ("SIGPROC 32-bit", TimeSeries.from_sigproc,
                  write_sigproc(base + "_32.tim", ts.data, ts.tsamp, 32), True),
                 ("SIGPROC 8-bit", TimeSeries.from_sigproc,
                  write_sigproc(base + "_8.tim", q8, ts.tsamp, 8), False))
        for name, load, path, exact in files:
            t0 = time.perf_counter()
            tsl = load(path)
            read_s = time.perf_counter() - t0
            check(tsl.nsamp == ts.nsamp and tsl.tsamp == ts.tsamp,
                  f"{name}: read {tsl.nsamp} samples at {tsl.tsamp} s")
            fk.reset_launches()
            with engine.recording() as rec:
                _, pgram = ffa_search(tsl, **kw)
            launches = dict(fk.LAUNCHES)
            check_launches(name, launches, engine.queued_launches(plan))
            check(rec["meta"]["prep"] == "native",
                  f"{name}: the wire was made by the {rec['meta']['prep']} "
                  "prep")
            ip, iw = np.unravel_index(np.argmax(pgram.snrs), pgram.snrs.shape)
            dfreq = abs(1.0 / pgram.periods[ip] - 1.0 / period)
            same = np.array_equal(pgram.snrs, want.snrs)
            print(f"  {name}: read {read_s:.3f} s; launches {launches}; best "
                  f"S/N {pgram.snrs[ip, iw]:.3f} at P = "
                  f"{pgram.periods[ip]:.6f} s (|df| = {dfreq:.3e} Hz); S/N "
                  f"{'the same bits as' if same else 'differs from'} the "
                  "in-memory search", flush=True)
            if exact:
                check(same, f"{name}: S/N differs from the in-memory search")
            else:
                check(dfreq < 1.0 / length and pgram.snrs[ip, iw] > 10.0,
                      f"{name}: the pulsar was not recovered")


def phase_wide(dev, wide=WIDE, widths=WIDE_WIDTHS):
    """Phase 5w: a search per ``wide`` entry whose padded width P crosses
    the entry's limit, on the uint6 wire (K1) and the float32 wire (K2),
    the counts set to 0 just before each search and read just after;
    every launch held against its plain version. Seeded noise with a
    pulse every 1.0005 * bins_max samples."""
    from riptide_tpu_torch.libffa import generate_signal
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine, periodogram_plan

    for limit, nsamp, tsamp, bmin, bmax in wide:
        pmin = bmax * tsamp
        plan = periodogram_plan(nsamp, tsamp, widths, pmin, 1.001 * pmin,
                                bmin, bmax)
        check(plan.P > limit, f"P = {plan.P} does not cross {limit}")
        np.random.seed(5)
        data = generate_signal(nsamp, 1.0005 * bmax, amplitude=20.0,
                               ducy=0.01)
        data = ((data - data.mean()) / data.std()).astype(np.float32)
        for mode, kind in (("uint6", "fused_stage"), ("float32",
                                                      "cascade_stage")):
            with wire_dtype(mode):
                fk.reset_launches()
                with engine.recording() as rec:
                    _, _, snrs = engine.run_periodogram(plan, data,
                                                        device=dev)
                launches = dict(fk.LAUNCHES)
                cuda = dict(fk.KERNEL_LAUNCHES)
                check_launches(f"P > {limit}, {mode}", launches,
                               engine.queued_launches(plan, mode))
            check(launches[kind] > 0 and np.isfinite(snrs).all(),
                  f"P > {limit}, {mode}: {kind} did not run")
            locs = sorted({r["args"][-2].local for r in rec["launches"]})
            print(f"  P = {plan.P} (> {limit}), {len(plan.stages)} stages, "
                  f"{plan.length} trials, {mode} wire: launches {launches}, "
                  f"CUDA launches {cuda}; S/N launch (rows, smem, scratch) "
                  f"{fk.snr_launch(plan.P)}, tile-local levels {locs}; best "
                  f"S/N {snrs.max():.3f}", flush=True)
            compare_stages(f"{kind} at P = {plan.P}", kernel_outs(rec, kind),
                           plain_launches(rec, kind))
            del rec


def overlapped_survey(dev, plan, D, batch, want_peaks, wall, walls,
                      cfg=HEADLINE, seed=4):
    """Two survey chunks with the prep overlapped, as a survey runs them:
    chunk 1 prepared into a pinned :class:`StagingPool` and queued, chunk
    2 prepared on a worker thread into the pool while the card runs
    chunk 1, then collected and run; twice, the second pass from the
    buffers the first gave back. Chunk 1 is phase 5's batch: its peaks
    must be run (a)'s. Prints DM-trials/s beside run (a)'s without the
    prep (``wall``) and with it (``walls``, the serial prep)."""
    from concurrent.futures import ThreadPoolExecutor

    from riptide_tpu_torch.search import engine

    tobs = cfg["nsamp"] * cfg["tsamp"]
    batches = (batch, survey_batch(plan, D, seed=seed, cfg=cfg))
    dms = np.zeros(D)
    pool = engine.StagingPool(dev)
    seen = set()
    for rnd in (1, 2):
        ptrs = set()
        t0 = time.perf_counter()
        p1 = engine.prepare_stage_data(plan, batches[0], pool=pool)
        h1 = engine.queue_search_batch(plan, None, tobs, prepared=p1,
                                       device=dev, pool=pool)
        with ThreadPoolExecutor(1) as ex:
            f2 = ex.submit(engine.prepare_stage_data, plan, batches[1],
                           pool=pool)
            peaks1, _ = engine.collect_search_batch(h1, dms)
            p2 = f2.result()
        h2 = engine.queue_search_batch(plan, None, tobs, prepared=p2,
                                       device=dev, pool=pool)
        peaks2, _ = engine.collect_search_batch(h2, dms)
        wall2 = time.perf_counter() - t0
        for p in (p1, p2):
            check(p[1]["prep"] == "native" and len(p[1]["staging"]) == 2
                  and all(t.is_pinned() for t in p[1]["staging"]),
                  "overlapped survey: a chunk was not prepared natively into "
                  "pinned pool buffers")
            ptrs |= {t.data_ptr() for t in p[1]["staging"]}
        # Chunk 1 acquires its buffers before anything else of the pass:
        # on the second pass they must be buffers the first gave back.
        first = {t.data_ptr() for t in p1[1]["staging"]}
        check(peaks1 == want_peaks, "overlapped survey: chunk 1's peaks "
              "differ from run (a)'s")
        check(all(np.isfinite([pk.snr for pk in x]).all() for x in peaks2),
              "overlapped survey: chunk 2 gave non-finite peaks")
        reused = len(ptrs & seen)
        recycled_first = first <= seen
        seen |= ptrs
        print(f"  overlapped survey, pass {rnd}: 2 chunks of D = {D} in "
              f"{wall2:.3f} s, {2 * D / wall2:.3f} DM-trials/s with the prep "
              f"overlapped ({reused} of {len(ptrs)} staging buffers recycled);"
              f" run (a) {D / wall:.3f} DM-trials/s without the prep, "
              f"{D / (wall + walls['native'][0]):.3f} with the native prep and"
              f" {D / (wall + walls['numpy'][0]):.3f} with the numpy prep in "
              "series", flush=True)
        del p1, p2, h1, h2
    check(recycled_first, "overlapped survey: the second pass's chunk 1 did "
          "not run from the first pass's staging buffers")


def pipeline_config(cfg=HEADLINE, chunk=PIPE_CHUNK):
    """Phase 7's pipeline config, as a dict (no YAML): the headline's
    period and bins range, ``chunk`` trials a device batch and loader
    threads, no plots."""
    return {
        "processes": chunk,
        "data": {"format": "presto", "fmin": None, "fmax": None,
                 "nchans": None},
        "dmselect": {"min": None, "max": None, "dmsinb_max": None},
        "dereddening": {"rmed_width": 4.0, "rmed_minpts": 101},
        "ranges": [{
            "name": "headline",
            "ffa_search": dict(period_min=cfg["period_min"],
                               period_max=cfg["period_max"],
                               bins_min=cfg["bins_min"],
                               bins_max=cfg["bins_max"], **PIPE_RANGE),
            "find_peaks": dict(PIPE_FIND_PEAKS),
            "candidates": {"bins": 256, "subints": 32},
        }],
        "clustering": {"radius": 0.2},
        "harmonic_flagging": {"denom_max": 100, "phase_distance_max": 1.0,
                              "dm_distance_max": 3.0,
                              "snr_distance_max": 3.0},
        "candidate_filters": {"dm_min": None, "snr_min": 7.0,
                              "remove_harmonics": True, "max_number": 16},
        "plot_candidates": False,
    }


def write_dm_trials(root, n, cfg=HEADLINE, period=PULSAR["period"],
                    amplitude=PULSAR["amplitude"], seed=7):
    """``n`` PRESTO DM trials of the headline length at DMs 0,
    PIPE_DM_STEP, ...: one seeded noise series shared by all (as
    neighbouring DM trials share most of theirs) plus phase 2's pulse
    train at an amplitude that peaks at trial n // 2. Returns the .inf
    paths and the brightest trial's DM."""
    from riptide_tpu_torch.libffa import generate_signal

    noise = np.random.default_rng(seed).standard_normal(cfg["nsamp"])
    pulse = generate_signal(cfg["nsamp"], period / cfg["tsamp"], ducy=0.05,
                            amplitude=1.0, stdnoise=0.0)
    files = []
    for k in range(n):
        amp = amplitude * np.exp(-0.5 * ((k - n // 2) / PIPE_SPREAD) ** 2)
        dm = PIPE_DM_STEP * k
        files.append(write_presto(os.path.join(root, f"trial_DM{dm:07.2f}"),
                                  (noise + amp * pulse).astype(np.float32),
                                  cfg["tsamp"], dm=dm))
    return files, PIPE_DM_STEP * (n // 2)


def span_table(tracer):
    """{name: seconds} over the top-level spans and {(name, chunk):
    seconds} over the chunk-tagged ones."""
    stages, chunks = {}, {}
    for name, _, dur, _, attrs, _ in tracer.events():
        if "chunk" in attrs:
            key = (name, attrs["chunk"])
            chunks[key] = chunks.get(key, 0.0) + dur
        else:
            stages[name] = stages.get(name, 0.0) + dur
    return stages, chunks


def phase_pipeline(dev, tmp, cfg=HEADLINE, nfiles=PIPE_FILES,
                   chunk=PIPE_CHUNK, period=PULSAR["period"]):
    """Phase 7: ``Pipeline(config, device).process`` on ``nfiles``
    PRESTO DM trials of the headline series (written under ``tmp``),
    ``chunk`` trials a chunk, then rseek on the headline series as a
    PRESTO file. Returns what phase 8 reuses: the trial files, the
    config, the products' bytes, the wall, the chunk count and K1's
    launches a chunk. Checks that
    DMIterator keeps every trial, that each trial's peaks are
    series (the same S/N bits), that each K1 launch of those reruns
    agrees with its plain version, that the top candidate is the pulsar at
    the brightest trial's DM, that K1 ran queued_launches(plan) times a
    chunk, that every product is written and loads back, and that
    rseek's table lists the pulsar. Prints the stage walls, the search's
    per-chunk spans, DM-trials/s and peak device memory."""
    import glob
    import importlib.util
    import logging
    from concurrent.futures import ThreadPoolExecutor

    from riptide_tpu_torch import load_json
    from riptide_tpu_torch.apps import rseek
    from riptide_tpu_torch.obs import trace
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.pipeline import Pipeline
    from riptide_tpu_torch.search import engine

    logging.basicConfig(level="WARNING")
    print("  importable here: " + ", ".join(
        f"{m} {importlib.util.find_spec(m) is not None}"
        for m in ("pandas", "yaml", "matplotlib")), flush=True)
    tobs = cfg["nsamp"] * cfg["tsamp"]
    conf = pipeline_config(cfg, chunk)
    t0 = time.perf_counter()
    files, bright_dm = write_dm_trials(tmp, nfiles, cfg, period)
    print(f"  wrote {nfiles} PRESTO DM trials of {cfg['nsamp']} samples "
          f"({nfiles * cfg['nsamp'] * 4 / 2 ** 30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    outdir = os.path.join(tmp, "products")
    os.makedirs(outdir)
    pipe = Pipeline(conf, device=dev)
    tracer = trace.enable()
    fk.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with dq_steps() as steps:
        pipe.process(files, outdir)
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    trace.disable()
    stages, spans = span_table(tracer)

    ntrials = len(pipe.dmiter.selected_dms)
    check(ntrials == nfiles, f"pipeline: DMIterator kept {ntrials} of "
          f"{nfiles} trials")
    nchunks = -(-nfiles // chunk)
    searcher = pipe.searcher
    plan = searcher._plan_for(conf["ranges"][0], cfg["nsamp"],
                              cfg["tsamp"])
    per_chunk = engine.queued_launches(plan)["fused_stage"]
    print(f"  Pipeline.process: {nfiles} trials in {nchunks} chunks of "
          f"{chunk}, {wall:.3f} s wall, {nfiles / wall:.3f} DM-trials/s; "
          f"search stage {stages['search']:.3f} s, "
          f"{nfiles / stages['search']:.3f} DM-trials/s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB; launches {launches}",
          flush=True)
    print("  stage walls: " + ", ".join(
        f"{k} {stages[k]:.3f} s" for k in (
            "prepare", "search", "cluster_peaks", "flag_harmonics",
            "apply_candidate_filters", "build_candidates",
            "save_products")), flush=True)
    for c in range(nchunks):
        print(f"  search chunk {c}: " + ", ".join(
            f"{k} {spans.get((k, c), 0.0):.3f} s"
            for k in ("stage", "ship", "queue", "collect"))
            + f"; inside stage: wire prep {spans.get(('prep', c), 0.0):.3f}"
            " s, and summed over the loader threads load "
            f"{spans.get(('load', c), 0.0):.3f} s, data-quality steps "
            f"{spans.get(('dq', c), 0.0):.3f} s", flush=True)
    print("  data-quality steps summed over all threads: " +
          ", ".join(f"{k} {v[1]:.3f} s ({v[0]} calls)"
                    for k, v in sorted(steps.items())), flush=True)
    if dev.type == "cuda":
        check(launches["fused_stage"] == nchunks * per_chunk > 0,
              f"pipeline: {launches['fused_stage']} K1 launches, want "
              f"{nchunks} chunks x {per_chunk}")

    # Each chunk again through run_search_batch, on the same loaded
    # and prepared series, recorded: its K1 launches, at the
    # pipeline's shapes, are held against their plain version.
    want = []
    chunks = list(pipe.dmiter.iterate_filenames(chunksize=chunk))
    with ThreadPoolExecutor(chunk) as ex:
        for c, names in enumerate(chunks):
            series = list(ex.map(
                lambda f: searcher.load_prepared(f, search=False), names))
            batch = np.stack([ts.data for ts in series])
            with engine.recording() as rec:
                ppt, _ = engine.run_search_batch(
                    plan, batch, tobs,
                    dms=[ts.metadata["dm"] for ts in series], device=dev,
                    **PIPE_FIND_PEAKS)
            want += [p for trial in ppt for p in trial]
            compare_stages(
                f"K1 fused_stage, pipeline chunk {c} (D = {len(names)})",
                kernel_outs(rec, "fused_stage"),
                plain_launches(rec, "fused_stage"))
            del rec
    check(sorted(pipe.peaks) == sorted(want),
          f"pipeline: {len(pipe.peaks)} peaks differ from "
          f"run_search_batch's {len(want)} on the same series")
    print(f"  peaks: {len(want)} over {nfiles} trials, each trial's the "
          "same (S/N bits included) as run_search_batch on its chunk",
          flush=True)

    names = sorted(os.listdir(outdir))
    for product in ("peaks.csv", "clusters.csv", "candidates.csv"):
        check(product in names, f"pipeline: {product} not written")
    cands = [load_json(f) for f in
             sorted(glob.glob(os.path.join(outdir, "candidate_*.json")))]
    check(len(cands) == len(pipe.candidates) > 0,
          f"pipeline: {len(cands)} candidate files for "
          f"{len(pipe.candidates)} candidates")
    top = cands[0].params
    dfreq = abs(1.0 / top["period"] - 1.0 / period)
    print(f"  products: {names[:3]}... {len(cands)} candidates; top "
          f"P = {top['period']:.6f} s (|df| = {dfreq:.3e} Hz), DM "
          f"{top['dm']}, S/N {top['snr']:.3f}", flush=True)
    check(dfreq < 1.0 / tobs and top["dm"] == bright_dm,
          f"pipeline: the top candidate {top} is not the pulsar at DM "
          f"{bright_dm}")

    ts = headline_series(cfg, period)
    inf = write_presto(os.path.join(tmp, "headline"), ts.data, ts.tsamp)
    args = rseek.get_parser().parse_args(
        ["-f", "presto", "--Pmin", str(cfg["period_min"]), "--Pmax",
         str(cfg["period_max"]), "--bmin", str(cfg["bins_min"]),
         "--bmax", str(cfg["bins_max"]), "--device", dev.type, inf])
    t0 = time.perf_counter()
    table = rseek.run_program(args)
    rs = time.perf_counter() - t0
    check(table is not None, "rseek: no peaks")
    hit = [i for i in range(len(table))
           if abs(table["freq"][i] - 1.0 / period) < 1.0 / tobs]
    check(hit and table["snr"][hit[0]] > 10.0,
          "rseek: the table does not list the pulsar")
    print(f"  rseek: {len(table)} rows in {rs:.3f} s, the pulsar at row "
          f"{hit[0]} (S/N {table['snr'][hit[0]]:.3f})", flush=True)
    return {"files": files, "conf": conf, "wall": wall, "nchunks": nchunks,
            "per_chunk": per_chunk, "root": tmp,
            "products": {name: open(os.path.join(outdir, name), "rb").read()
                         for name in PRODUCTS}}


@contextlib.contextmanager
def env_flags(flags):
    """Set environment flags for a block, restoring them after."""
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def fsync_counts():
    """{file name: fsync calls} of the block, by the name the fd is open
    on (the journal's appends and the sidecars' atomic writes all fsync
    through ``os.fsync``)."""
    counts = {}
    real = os.fsync

    def counting(fd):
        try:
            path = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            path = "?"
        name = os.path.basename(path)
        if os.path.isdir(path):
            name = "(directory)"
        elif name.endswith(".tmp"):          # an atomic write's temp file
            name = name.split(".json.")[0] + ".json (atomic)"
        counts[name] = counts.get(name, 0) + 1
        return real(fd)

    os.fsync = counting
    try:
        yield counts
    finally:
        os.fsync = real


def journaled_run(dev, p7, name, flags=None, spec="", resume=False,
                  trace=False, jdir=None):
    """One journaled ``Pipeline.process`` over phase 7's trials and
    config: the launch counts set to 0 just before and read just after.
    Returns the run's wall, launches, metrics, journal, fsyncs, products
    (None when the run stopped on an injected abort) and the abort."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.pipeline import Pipeline
    from riptide_tpu_torch.survey.faults import FaultAbort
    from riptide_tpu_torch.survey.journal import SurveyJournal
    from riptide_tpu_torch.survey.metrics import get_metrics

    jdir = jdir or os.path.join(p7["root"], f"journal_{name}")
    out = os.path.join(p7["root"], f"products_{name}")
    os.makedirs(out, exist_ok=True)
    err = None
    with env_flags(flags or {}), fsync_counts() as fsyncs:
        pipe = Pipeline(p7["conf"], device=dev, journal=jdir, resume=resume,
                        fault_spec=spec, trace=trace)
        get_metrics().reset()
        fk.reset_launches()
        t0 = time.perf_counter()
        try:
            pipe.process(p7["files"], out)
        except FaultAbort as exc:
            err = exc
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        if trace:
            from riptide_tpu_torch.obs import trace as tracer

            tracer.disable()
    products = None if err else {
        n: open(os.path.join(out, n), "rb").read() for n in PRODUCTS}
    return {"wall": wall, "launches": launches,
            "metrics": get_metrics().summary(), "jdir": jdir,
            "journal": SurveyJournal(jdir), "fsyncs": fsyncs,
            "products": products, "abort": err}


def check_chunk_spans(doc, nchunks):
    """Phase 8f: the Chrome trace holds one ``chunk`` span per chunk,
    and that chunk's ``stage`` span and its ``ship``, ``queue`` and
    ``collect`` spans inside the chunk span's interval (the dispatch may
    run on a watchdog thread, so nesting is checked in time)."""
    spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    for cid in range(nchunks):
        mine = [ev for ev in spans if ev["args"].get("chunk") == cid]
        parents = [ev for ev in mine if ev["name"] == "chunk"]
        check(len(parents) == 1, f"trace: chunk {cid} has {len(parents)} "
              "chunk spans")
        top = parents[0]
        names = {ev["name"] for ev in mine}
        check({"stage", "ship", "queue", "collect"} <= names,
              f"trace: chunk {cid} lacks {names}")
        for ev in mine:
            if ev["name"] in ("ship", "queue", "collect"):
                check(top["ts"] <= ev["ts"] and ev["ts"] + ev["dur"]
                      <= top["ts"] + top["dur"] + 1.0,
                      f"trace: chunk {cid}'s {ev['name']} span lies outside "
                      "its chunk span")
    return len(spans)


def phase_journal(dev, p7, card):
    """Phase 8: the checkpointed survey path on phase 7's trials and
    config. (a) journaled runs with integrity off and under ``probe``
    (every chunk dispatched twice, both result digests equal; K1 on
    every dispatch; the products phase 7's bytes; the probe run traced,
    (f)); (b) ``abort:1`` then ``resume=True``: chunk 0 replayed, not
    searched again, the same bytes; (c) ``bitflip:1`` under ``probe``:
    one ``result_mismatch``, the vote keeps the majority, the same
    bytes; (d) the integrity canary twice on the card, the same digest,
    the card's pin where the package has one; (e) a real ``torch.cuda.OutOfMemoryError`` classified as OOM, not as
    a device error. Returns K1's launches over the phase."""
    from riptide_tpu_torch.search.engine import is_oom_error
    from riptide_tpu_torch.survey import integrity
    from riptide_tpu_torch.survey.liveness import is_device_error

    n, nchunks, per_chunk = len(p7["files"]), p7["nchunks"], p7["per_chunk"]
    k1 = 0

    def same_products(run, what):
        for name in PRODUCTS:
            check(run["products"][name] == p7["products"][name],
                  f"{what}: {name} differs from phase 7's")

    # (a) integrity off, then every chunk probed (and traced).
    off = journaled_run(dev, p7, "off")
    same_products(off, "journaled run")
    check(off["launches"]["fused_stage"] == nchunks * per_chunk,
          f"journaled run: {off['launches']['fused_stage']} K1 launches, "
          f"want {nchunks} x {per_chunk}")
    probe = journaled_run(dev, p7, "probe", PROBE_ENV, trace=True)
    same_products(probe, "probe run")
    m = probe["metrics"]
    check(probe["launches"]["fused_stage"] == 2 * nchunks * per_chunk,
          f"probe run: {probe['launches']['fused_stage']} K1 launches, "
          f"want 2 x {nchunks} x {per_chunk}")
    check(m.get("shadow_probes") == nchunks
          and m.get("integrity_mismatches") == 0,
          f"probe run: {m.get('shadow_probes')} probes, "
          f"{m.get('integrity_mismatches')} mismatches")
    recs = probe["journal"].completed_chunks()
    check(sorted(recs) == list(range(nchunks)) and all(
        rec["integrity"].get("probe") and "votes" not in rec["integrity"]
        for rec, _ in recs.values()),
        "probe run: a chunk's two dispatches gave different result digests")
    k1 += off["launches"]["fused_stage"] + probe["launches"]["fused_stage"]
    for run, what in ((off, "integrity off"), (probe, "integrity probe")):
        print(f"  (a) journaled, {what}: {run['wall']:.3f} s, "
              f"{n / run['wall']:.3f} DM-trials/s (phase 7 unjournaled "
              f"{p7['wall']:.3f} s, {n / p7['wall']:.3f}); K1 launches "
              f"{run['launches']['fused_stage']}", flush=True)
    digests = [rec["integrity"]["result"][:12] for _, (rec, _)
               in sorted(recs.items())]
    print(f"  (a) every chunk's primary and shadow result digests agree: "
          f"{digests}", flush=True)
    sizes = {f: os.path.getsize(os.path.join(off["jdir"], f))
             for f in sorted(os.listdir(off["jdir"]))}
    print(f"  (a) journal files {sizes} ({sum(sizes.values())} bytes); "
          f"fsyncs by file {off['fsyncs']} "
          f"({sum(off['fsyncs'].values())} in all)", flush=True)

    # (f) the probe run's Chrome trace.
    with open(os.path.join(probe["jdir"], "trace.json")) as fobj:
        nspans = check_chunk_spans(json.load(fobj), nchunks)
    print(f"  (f) trace.json: {nspans} spans, one chunk span per chunk "
          "with its stage, ship, queue and collect spans", flush=True)

    # (b) abort after chunk 0, then resume.
    jdir = os.path.join(p7["root"], "journal_abort")
    aborted = journaled_run(dev, p7, "abort", spec="abort:1", jdir=jdir)
    check(aborted["abort"] is not None, "abort:1 did not stop the run")
    check(sorted(aborted["journal"].completed_chunks()) == [0],
          "abort:1: the journal does not hold exactly chunk 0")
    resumed = journaled_run(dev, p7, "resume", resume=True, jdir=jdir)
    same_products(resumed, "resumed run")
    check(resumed["metrics"].get("chunks_skipped") == 1
          and resumed["launches"]["fused_stage"]
          == (nchunks - 1) * per_chunk,
          f"resume: {resumed['metrics'].get('chunks_skipped')} chunks "
          f"replayed, {resumed['launches']['fused_stage']} K1 launches")
    k1 += aborted["launches"]["fused_stage"] + \
        resumed["launches"]["fused_stage"]
    print(f"  (b) abort:1 after {aborted['wall']:.3f} s; resume "
          f"{resumed['wall']:.3f} s, chunk 0 replayed, "
          f"{resumed['launches']['fused_stage']} K1 launches, the products "
          "phase 7's bytes", flush=True)

    # (c) one flipped result byte, out-voted.
    flip = journaled_run(dev, p7, "bitflip", PROBE_ENV, spec="bitflip:1")
    same_products(flip, "bitflip run")
    kinds = [r["incident"] for r in flip["journal"].incidents()]
    votes = flip["journal"].completed_chunks()[1][0]["integrity"]
    check(kinds.count("result_mismatch") == 1 and len(votes["votes"]) == 3,
          f"bitflip: incidents {kinds}, integrity block {votes}")
    k1 += flip["launches"]["fused_stage"]
    print(f"  (c) bitflip:1: one result_mismatch, votes {votes['votes']}, "
          f"{flip['wall']:.3f} s, the products phase 7's bytes", flush=True)

    # (d) the canary, twice.
    t0 = time.perf_counter()
    d1 = integrity.compute_canary_digest(dev)
    d2 = integrity.compute_canary_digest(dev)
    check(d1 == d2, f"canary: two digests on the card differ ({d1}, {d2})")
    platform = integrity.canary_platform(dev)
    pinned = integrity._read_canary_pin(integrity.canary_pin_path()).get(
        platform)
    check(pinned in (None, d1), f"canary: {d1} on {platform}, but the "
          f"package pins {pinned} (a kernel whose bits changed needs "
          "`python -m riptide_tpu_torch.survey.integrity --repin`)")
    print(f"  (d) canary {platform}: {d1} twice "
          f"({time.perf_counter() - t0:.3f} s); "
          f"{'the pin matches' if pinned else 'no pin for this card'}",
          flush=True)

    # (e) a real out-of-memory error.
    free, total = torch.cuda.mem_get_info(dev)
    try:
        torch.empty(total + 2 ** 30, dtype=torch.uint8, device=dev)
        oom = None
    except Exception as exc:          # the classification under test
        oom = exc
    check(isinstance(oom, torch.cuda.OutOfMemoryError) and is_oom_error(oom)
          and not is_device_error(oom),
          f"OOM: {type(oom).__name__} classified oom={is_oom_error(oom)}, "
          f"device error={is_device_error(oom)}")
    torch.cuda.synchronize(dev)
    print(f"  (e) {type(oom).__name__} on {total / 2 ** 30:.1f} GiB + 1 GiB: "
          "an OOM, not a device error; the context still works", flush=True)
    print(f"  phase 8 card: {card}; K1 launches {k1}", flush=True)
    return k1


# Phase 6: P1's gathering patterns (the tool's names), and the grids
# (blocks, threads) of the empty kernel timed as the launch floor: one
# block, and the grid of an element kernel at (2048, 384).
P1_GATHERING = ("roll lanes", "roll rows", "select", "dynroll",
                "stride_roll")
PROBE_FLOOR_GRIDS = ((1, 32), (3072, 256))


def phase_probes(dev):
    """Phase 6: the chip probes through their entry points. Returns one
    ``kernels`` entry per probe: its launches in the run, the largest
    difference from plain, and the sums over its patterns of kernel ms
    (the entry point's device time per call, from CUDA graph replays),
    plain ms and bound ms. P1's entry also carries its GEMM's own device
    ms (``gemm_ms``, the matmul pattern's four products) beside
    ``library_ms``, the same four products by ``torch.matmul`` in full
    float32, timed alike (``measure.graph_ms``)."""
    from riptide_tpu_torch.probes import common, probe1536, ptime, ptime2

    probes = (("P1", "P1 ptime", ptime, ["all"], "tools/ptime.py:86"),
              ("P2", "P2 ptime2", ptime2, list(ptime2.BODIES),
               "tools/ptime2.py:28"),
              ("P3", "P3 probe1536", probe1536, [], "tools/probe1536.py:84"))
    torch.backends.cuda.matmul.allow_tf32 = False
    for _, _, mod, _, _ in probes:
        mod.reset_launches()
    common.reset_kernel_launches()
    results = {key: mod.main(argv) for key, _, mod, argv, _ in probes}
    launches = {key: dict(mod.LAUNCHES) for key, _, mod, _, _ in probes}
    kernels = dict(common.KERNEL_LAUNCHES)
    print(f"  launches {launches}", flush=True)
    print(f"  launches by CUDA kernel {kernels}", flush=True)
    for key, counts in launches.items():
        idle = sorted(k for k, n in counts.items() if n == 0)
        check(not idle, f"{key}: kernels {idle} never launched in the run")
    idle = sorted(k for k, n in kernels.items() if n == 0)
    check(not idle, f"probes.cu kernels {idle} never launched in the run")
    floors = {(b, t): common.launch_floor_ms(dev, b, t)
              for b, t in PROBE_FLOOR_GRIDS}
    print("  launch floor (an empty kernel, timed as the patterns are): "
          + ", ".join(f"{ms * 1e3:.2f} us at {b} x {t} threads"
                      for (b, t), ms in floors.items()), flush=True)
    entries = []
    for key, name, mod, _, replaces in probes:
        err = ms = pms = 0.0
        bounds = {}
        lib_ms = gemm_ms = products = None
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
                gemm_ms, products = r.ms, r.passes
                bms_mm = r.bound()[0]
                lib_ms = measure.graph_ms(
                    lambda: [torch.matmul(a, x) for _ in range(products)],
                    dev, REPS)
            else:
                check(torch.equal(r.out, want), f"{key} {r.name}: not the "
                      f"plain version's bits (max |err| {e:.3e})")
            check(r.ok is not False, f"{key} {r.name}: differs from the "
                  "tool's numpy sequence")
            bms, by = r.bound()
            bounds[by] = bounds.get(by, 0.0) + bms
            err, ms, pms = max(err, e), ms + r.ms, pms + p_ms
            print(f"  {key} {r.name}: max |kernel - plain| {e:.3e}; kernel "
                  f"{r.ms:.4f} ms, plain {p_ms:.4f} ms, bound {bms:.6f} ms by "
                  f"{by} ({bms / r.ms:.1%} of it)", flush=True)
        bms = sum(bounds.values())
        by = max(bounds, key=bounds.get)
        print(f"  {key}: {len(results[key])} patterns, kernels {ms:.4f} ms "
              f"(plain {pms:.4f} ms, bound {bms:.4f} ms, mostly by {by})",
              flush=True)
        if key == "P1":
            sums = p1_sums(results[key])
            for part, (n, k_ms, b_ms) in sums.items():
                print(f"  P1 {part}: {n} patterns, kernels {k_ms:.4f} ms, "
                      f"bound {b_ms:.4f} ms ({b_ms / k_ms:.1%} of it)",
                      flush=True)
        if gemm_ms is not None:
            rate = common.mma_tf32_tflops(dev)
            share = rate * 1e12 / measure.PEAK_TF32_FLOPS_PER_S
            print(f"  {key} GEMM: {products} products {gemm_ms:.4f} ms, "
                  f"{products} x torch.matmul (full float32) {lib_ms:.4f} "
                  f"ms, both from CUDA graph replays: {gemm_ms / lib_ms:.3f}"
                  f" x the library's time; mma.sync TF32 alone {rate:.1f} "
                  f"TFLOP/s ({share:.1%} of the dense peak), so its least "
                  f"time for the products is {bms_mm / share:.4f} ms",
                  flush=True)
        entry = {
            "name": name, "route": "cuda",
            "source": "riptide_tpu_torch/csrc/probes.cu",
            "replaces": replaces,
            "launches": sum(launches[key].values()), "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bms,
            # "operations (tensor cores)" counts as operations here
            "bound_by": by.split()[0], "library_ms": lib_ms,
        }
        if gemm_ms is not None:
            entry["gemm_ms"] = gemm_ms
        if key == "P1":
            entry.update({f"{part.split()[0]}_ms": k_ms
                          for part, (_, k_ms, _) in sums.items()})
        entries.append(entry)
    return entries


def p1_sums(results):
    """P1's patterns other than the matmul in three parts, each (patterns,
    kernel ms, bound ms): the gathering patterns (:data:`P1_GATHERING`),
    the tile sweep (``ptime.TILES``, named "add RxC" and "roll RxC") and
    the loop patterns (the other five at the tool's shape)."""
    from riptide_tpu_torch.probes import ptime

    tiles = {f"{k} {r}x{c}" for r, c in ptime.TILES for k in ("add", "roll")}
    sums = {"gathering patterns": [0, 0.0, 0.0],
            "loop patterns": [0, 0.0, 0.0], "tile sweep": [0, 0.0, 0.0]}
    for r in results:
        if r.wrapper == "matmul":
            continue
        part = ("gathering patterns" if r.name in P1_GATHERING else
                "tile sweep" if r.name in tiles else "loop patterns")
        s = sums[part]
        s[0], s[1], s[2] = s[0] + 1, s[1] + r.ms, s[2] + r.bound()[0]
    return {k: tuple(v) for k, v in sums.items()}


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
    from riptide_tpu_torch import native
    from riptide_tpu_torch.search import engine

    t0 = time.perf_counter()
    libs = (fk._LIB, probes.LIB)
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        for done in [pool.submit(lib.build) for lib in libs] + [
                pool.submit(native.build)]:
            done.result()
    for lib in libs:
        lib.load()
    check(native.available(), "the native host runtime did not load")
    print(f"  kernel and native builds + loads {time.perf_counter() - t0:.2f}"
          " s, together", flush=True)
    print(f"  native host runtime: g++ {native.BUILD_INFO['seconds']:.2f} s "
          f"-> {native.BUILD_INFO['path']}; {os.cpu_count()} host cores, "
          f"prep threads {engine._prep_nthreads() or native.default_threads()}",
          flush=True)
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
    print("phase 5f: file entry points (PRESTO, SIGPROC 32- and 8-bit)",
          flush=True)
    phase_files(dev, plan, headline_series())
    print("phase 5w: wide phase widths through K1 and K2", flush=True)
    phase_wide(dev)
    print("phase 6: chip probes P1-P3 through their entry points",
          flush=True)
    t6 = time.perf_counter()
    probe_entries = phase_probes(dev)
    print(f"  phase 6: {time.perf_counter() - t6:.1f} s wall", flush=True)
    print(f"phase 7: the pipeline (rffa) on {PIPE_FILES} DM-trial files, "
          "then rseek", flush=True)
    import shutil
    import tempfile

    from riptide_tpu_torch.utils.cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        t7 = time.perf_counter()
        p7 = phase_pipeline(dev, tmp)
        print(f"  phase 7: {time.perf_counter() - t7:.1f} s wall", flush=True)
        print("phase 8: the journaled survey (journal, resume, integrity, "
              "faults, trace) on phase 7's trials", flush=True)
        t8 = time.perf_counter()
        k1_journal = phase_journal(dev, p7, card)
        print(f"  phase 8: {time.perf_counter() - t8:.1f} s wall", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
    # K1's launches over phase 8's journaled runs, beside its main-path
    # count.
    entries[0]["journal_launches"] = k1_journal
    entries += probe_entries
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
