#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``riptide_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the cascade-stage kernels (``riptide_tpu_torch/csrc/ffa_stage.cu``),
the peak program's cluster kernel (``riptide_tpu_torch/csrc/cluster.cu``)
and the chip probes' kernels (``riptide_tpu_torch/csrc/probes.cu``) from
this checkout with nvcc, and the native host runtime
(``riptide_tpu_torch/native/src/riptide_native.cpp``) with g++, one
process each, started together, into the build cache
(``riptide_tpu_torch/utils/exec_cache.py``; ``.riptide_cache/torch_build/``
of the checkout by default), then:

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
   (``engine.queued_launches``), no K2 and no cluster kernel
   (``peaks_device.CLUSTER_LAUNCHES``: ``ffa_search`` queues no peak
   program), and by CUDA kernel one
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
   second of two runs, its launch counts set to 0 just before it and
   read just after (one cluster kernel launch, for its peak program);
   series 0 must give the pulsar. The prep is timed by both paths (the
   same bits), and one two-chunk survey runs with the prep overlapped:
   chunk 2 is prepared on a worker thread into a pinned ``StagingPool``
   while the card runs chunk 1, twice (the second pass from recycled
   buffers);
5k. K3 on the benchmark's example_long plan (riptide's example.yaml
   range long, P 2-120 s at 960-1040 bins), whose layout pairs 6 lane
   buckets: its D = 32 survey batch (a 10 s pulsar in series 0) as in
   phase 5, every K3 launch held against ``paired_stage_plain``, its
   containers after the segment kernel and every global level against
   the plain levels bit for bit, and K3 timed over all of them;
5c. the peak program's cluster kernel (``csrc/cluster.cu``) on phase 5's
   S/N cube (D = 32, 10 widths, 222,955 trials) through the survey's own
   peak plan: the program once, its cluster launches set to 0 just
   before and read just after (one); ``peaks_device.cluster_columns`` on
   the cube and the program's threshold coefficients must give the plain
   form's four outputs (``ncl``, ``marg``, ``rep_idx``, ``rep_val``;
   ``_cluster_impl`` over ``_thr_impl`` on the same card tensors) bit for
   bit, and the program's packed outputs; the kernel's time (CUDA graph
   replays, and through the wrapper between CUDA events) beside the plain
   form's and the bound of the bytes it moves. Its ``kernels`` entry
   (``CL cluster_columns``) carries these and phases 5 and 5k's launch
   counts (``survey_launches``);
5f. the file entry points: the phase 2 series written by this script as
   a PRESTO .inf/.dat pair and as 32-bit and 8-bit SIGPROC files, read
   back with ``TimeSeries.from_presto_inf`` / ``from_sigproc`` and
   searched with ``ffa_search`` (counts set to 0 just before each search
   and read just after): the 32-bit reads give the in-memory search's
   S/N bits, the 8-bit read recovers the pulsar;
5w. wide phases: three searches whose padded width P crosses 14,528
   (past it no row pair fits a segment tile, so the segment kernel takes
   its direct form and every level is a level launch, and the levels
   and the S/N take their wide forms), 29,056 (two rows' prefix sums no
   longer fit a block) and 58,112 (one S/N block's shared memory: a
   cluster of two blocks a row above), each on
   the uint6 wire (K1) and the float32 wire (K2), every launch held
   against its plain version, and each search's K1 and K2 launches
   timed as phase 3 times the headline's (device time from CUDA graph
   replays; plain; the bound from the same counts) and split by CUDA
   kernel (the segment kernel, each level, the S/N, each alone, beside
   its bound); the ``kernels`` line gives them per search under K1's and
   K2's ``wide``. A trial of p <= 14,528 alone in its container (the
   narrow S/N) and in containers widened past 14,528 and past 58,112 by
   a wider trial (the wide S/N, a block and a cluster a row) must give
   the same S/N bits: the wide form keeps the narrow order of the sums
   (K2's ``wide_bits``);
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
9. the report and watch CLIs, the chaos campaign and the build cache:
   (a) ``obs.report.build_report`` over phase 8's probed journal (no
   phase-sum violation, every chunk done, the integrity verdict ``ok``;
   each chunk's ``chunk_s`` and the ``straggler_ratio`` printed), then
   ``apps/rreport.py``, ``rtop.py --once`` and ``rwatch.py --once`` run
   by path in fresh processes, each exiting 0; (b) the chaos
   campaign's 14 builtin schedules (``survey.chaos.run_campaign(...,
   device="cuda")``, 22 legs, each a fresh process on the card: kills
   mid-write and resumes, ENOSPC and fsync faults, a corrupted cache
   library, flipped result bytes, and the survey service's daemon
   killed, drained and fed an injected device error mid-job), every
   schedule's ``peaks.csv`` the
   control run's bytes, every leg on ``cuda`` and every leg that
   searched a chunk launching K1; each schedule's legs, wall and K1
   launches printed, then ``rreport --compare`` of the control journal
   over the campaign's ledger rows, its platform scope the card's;
   (c) ``csrc/ffa_stage.cu`` built under a throwaway
   ``RIPTIDE_CACHE_ROOT`` in three fresh processes: with
   ``cache_corrupt:exec_cache_store:1`` armed (the stored copy's last
   byte flipped), then again (the digest check journals one
   ``cache_corrupt`` incident, counts one eviction and nvcc rebuilds;
   a headline search's K1 launches held against ``fused_stage_plain``),
   then once more (``loaded``, the same bytes). K1's campaign launches
   go into its ``kernels`` entry as ``chaos_launches``.
10. the survey service (``riptide_tpu_torch.serve``) on phase 7's
   trials, the job specs phase 7's range in 8-trial chunks with 16
   loader threads, each served part's launch counts set to 0 just
   before it and read just after, every fair-share turn logged with the
   K1 launches inside it (``TurnLog``): (a) ``ServeDaemon(device=
   "cuda", workers=2)`` takes two tenants' jobs over HTTP (trials 0-23
   and 24-47), held at their first gate until both wait; both must end
   ``done`` with interleaved turns, each ``peaks.csv`` the bytes of a
   direct ``SurveyScheduler`` run of the same chunks in this process,
   K1 launched in each job's turns and nowhere else, and the pair's
   peak device memory under twice the direct runs'; each job's wall,
   queue wait, device seconds and DM-trials/s are printed beside phase
   7's; (b) a warm repeat of j0001's geometry (trials 0-7):
   ``warm_start`` true, ``exec_cold_builds`` flat, K1 launched, its
   first chunk's ``queue`` beside j0001's; (c) a job (trials 24-47)
   drained after its first chunk (a priority -1 blocker gate parks it
   at its next gate): ``/status`` shows ``draining``, a submit gets 503
   with ``Retry-After``, the job has a ``job_drained`` incident and no
   terminal record; a new daemon on the same root resumes it to
   j0002's bytes; (d) ``rseek --submit`` of trial 0 from a process with
   ``CUDA_VISIBLE_DEVICES`` empty exits 0 with a direct run's peaks
   (the same bytes), and ``rreport`` and ``rtop --once`` by path print
   the serve root's job table. K1's served launches go into its
   ``kernels`` entry as ``serve_launches``.
11. the multi-GPU paths (``riptide_tpu_torch.parallel``) on the card,
   every shard a device of a ``Mesh`` (``cuda:0`` repeated on a one-card
   machine): (a) ``run_search_sharded`` of phase 5's D = 32 batch on
   ``default_mesh()`` (one shard a card), on four virtual shards and with
   30 trials over four shards (padded), and ``run_periodogram_sharded``
   on a 2 x 3 (dm, bins) mesh (the bins axis divides the plan's 21
   padded bins trials); each run timed after a warm-up (wall,
   DM-trials/s and peak device memory beside phase 5's, launch
   counts set to 0 just before and read just after: one K2
   ``cascade_stage`` per stage per shard, no K1, no plain version),
   then recorded a third time and every K2 launch held against
   ``cascade_stage_plain``; the peaks must be phase 5's (period,
   width, DM; the S/N within the bar, its largest difference and
   whether the bits are equal printed), series 0 the pulsar, the 2-D
   cube phase 5's S/N; K2 is timed over the default mesh's
   launches as in phase 3; (b) ``ffa2_seq`` of a (32768, 256) float32
   container over 2 (all-gather) and 8 (windowed) virtual shards, the
   same bits as ``ffa2`` on the card; (c) two fresh processes on the card
   joined over ``torch.distributed`` (gloo, a free localhost port),
   each making phase 5's batch from its seed and searching its half
   (process 1 the pulsar's) through ``run_search_multihost`` with a
   shared journal: both print the same gathered list, phase 5's
   peaks in process order sorted by S/N (the same bits), process 0
   journals the chunk, and K1 runs ``queued_launches(plan)`` times in
   each; (d) process 0 wedges before the gather; process 1's gather,
   bounded at 5 s, times out, it degrades to local-only mode, takes the
   journal writer's role and journals both chunks (``peer_losses`` 1,
   one ``peer_loss`` incident), then process 0 is killed. K2's sharded
   launches and times go into its ``kernels`` entry (``sharded_launches``,
   ``sharded_ms``, ``sharded_plain_ms``, ``sharded_bound_ms`` and
   ``sharded_bound_by``, ``sharded_max_abs_err``), K1's
   launches in the two processes of (c) into its own as
   ``multihost_launches``.
12. the launch contracts and the peak-memory model
   (``riptide_tpu_torch/analysis/launch_contract.py``): (a) for each
   fast contract plan, and for the headline plan at D = 1, one real
   search's ``LAUNCHES`` and ``KERNEL_LAUNCHES`` (counts set to 0 just
   before, read just after) equal the contract the CPU walk extracted
   (the pinned file; for the headline, ``engine.walk_search``), and the
   pointers its launches received (a proxy of the built library) honour
   every declared reuse; ``python -m riptide_tpu_torch.apps.rprove``
   runs on the card's machine and exits 0; (b) the model against
   ``torch.cuda.max_memory_allocated`` (above what was allocated
   before, the stage operands uploaded anew): one survey search at
   D = 1 and D = 3 of the headline plan, and at D = 32 phases 4 and
   5's peaks (phase 4's against the walk without the peak
   program), each |ratio - 1| <= 0.5 (the ``hbm_drift`` margin), with
   ``max_memory_reserved``; (c) phase 5's D = 32 survey batch through
   ``BatchSearcher._queue_range`` with and without
   ``RIPTIDE_HBM_BUDGET`` = the model's ``predict(8)``: four slices of
   8, ``oom_predicted`` 1, no bisection, the unbudgeted peaks and a lower
   measured peak, both peaks and walls printed; (d) phase 8's journaled
   pipeline under that budget: phase 7's products, an ``hbm`` block in
   every chunk record (``actual_bytes`` and ``ratio`` only where the
   high-water mark rose), ``oom_predicted`` one a chunk, ``rreport``'s
   hbm line with the median ratio, ``rwatch --once`` quiet.
13. the static rules against the card: (a) ``riptide_tpu_torch/apps/
   riplint.py --no-cache`` in a subprocess on the card's machine must
   exit 0 (its analyzers, modules, baselined findings and seconds
   printed); (b) the sync witness: under
   ``torch.cuda.set_sync_debug_mode("warn")`` (every warning shown, each
   sync's Python stack kept), outside ``engine.recording()``, phase 2's
   headline ``ffa_search`` (K1, D = 1), phase 5k's D = 32 example_long
   survey batch through ``queue_search_batch`` then
   ``collect_search_batch`` (K1 and K3) and phase 11a's
   ``run_search_sharded`` on
   ``default_mesh()`` (K2), on those phases' series, batch and plan.
   Each sync is mapped to its innermost ``riptide_tpu_torch`` frame and
   that frame's function; every sync in a function of RIP001's hot set
   (``analysis/lint/host_sync.py``) or one RIP011 reaches from its roots
   must sit on a line that the baseline or a pragma covers. The sync
   sites are printed with their counts, the outputs must be those
   phases' (the same S/N bits, the same peaks), the mode is reset in a
   ``finally``, and the phase's K1, K2 and K3 launch counts (each set to
   0 just before its run and read just after) go into their ``kernels``
   entries as ``witness_launches``.
14. the public surface the port shares with the reference: the
   top-level ``downsample``, ``running_median``, ``fast_running_median``
   and ``find_peaks`` on phase 2's series and periodogram (the exact
   running median on its first 2^20 samples), each the submodule
   function it re-exports, with its values; ``libffa.benchmark_ffa2``
   at (1024, 256) and (8192, 256) beside the card's name and power
   limit; ``search.engine.device_fingerprint()``, this card's; the
   ``obs`` and ``survey`` namespaces' names (``obs.span``,
   ``survey.SurveyScheduler``) their submodules' objects; the finite- and
   liveness-guard shims clean on this checkout.
15. the benchmark entry points the JAX package defines (root
   ``bench.py``, ``tools/stime.py``, ``etime.py``, ``warmtest.py``), each
   run in a fresh process as a user runs it, at full shape, with
   ``RIPTIDE_LEDGER`` pointed at a scratch ledger: ``python -m
   riptide_tpu_torch.bench`` (the headline: warm-up, the S/N-parity gate,
   best of up to 3 pipelined passes of 5 chunks of D = 32), ``--config 1``
   ... ``--config 5``, ``apps.stime 32 4``, ``apps.etime 23 32 3`` and
   ``apps.warmtest 32``. Each must exit 0 with a last line carrying the
   JAX line's keys and metric (etime and warmtest: their lines' fields);
   the headline ``passes`` >= 1, its gate's line on stderr (the uint6 top
   S/N within 0.15 of the float32 reference, at P = 1.0 s), K1 and the
   gate's K2 launched in that process, K1 in each config's. Its value,
   ``vs_baseline`` and decomposition, and each run's figures, are
   printed. In this process ``warm_stage_kernels(plan, 32)`` must return
   the plan's distinct launch shapes (``engine.launch_shapes``, as
   warmtest printed); the ``queue`` of a D = 32 headline search on phase
   5's batch is printed cold (operands, peak plans and the allocator's
   free blocks dropped), first after the warm-up and warm.

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
import hashlib
import json
import os
import re
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
# Phase 5's K3 plan: the benchmark's example_long configuration
# (riptide's example.yaml range long), whose layout pairs 6 lane buckets,
# with a pulsar inside its period range.
EXAMPLE_LONG = dict(nsamp=2 ** 23, tsamp=64e-6, period_min=2.0,
                    period_max=120.0, bins_min=960, bins_max=1040)
EXAMPLE_LONG_WIDTHS = (1, 2, 3, 4, 6, 9, 13, 19, 28, 42, 63, 94, 141)
EXAMPLE_LONG_PAIRS = 6
EXAMPLE_LONG_PULSAR = 10.0
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
# Each phase 5w search runs on these wires, through these wrappers.
WIDE_KINDS = (("uint6", "fused_stage"), ("float32", "cascade_stage"))

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
    its lane bucket's (or whole stage's, or a sharded launch's bins
    slice's) trials and, for K3, the guest trials it carries."""
    st = plan.stages[r["stage"]]
    idx = r.get("bins")
    if idx is None:
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
    print(f"  split ({D} series): host wire prep {rec['prep_s']:.4f} s, copy "
          f"to card {rec['ship_s']:.4f} s, stage loop {rec['stages_s']:.4f} s "
          f"wall, assemble + copy back {rec['out_s']:.4f} s", flush=True)
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
    from riptide_tpu_torch.search import engine, peaks_device

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
    peaks_device.CLUSTER_LAUNCHES = 0
    with engine.recording() as rec, dq_steps() as steps, gc_pauses() as gcs:
        t0 = time.perf_counter()
        tsn, pgram = ffa_search(ts, **kw)
        warm = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    cuda = dict(fk.KERNEL_LAUNCHES)
    clusters = peaks_device.CLUSTER_LAUNCHES
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
          f"launch per FFA level took {old}); cluster kernel {clusters}",
          flush=True)
    check(clusters == 0, f"headline: {clusters} cluster kernel launches; "
          "ffa_search queues no peak program")
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
    p2 = dict(ts=ts, kw=kw, snrs=pgram.snrs, pgram=pgram)
    return launches, rec, err, tsn.data, seg_s, p2


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
    recorded and its K1 outputs held against plain. Returns the peak
    device memory and what was allocated when the peak was reset, for
    phase 12."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine, run_periodogram_batch

    batch = noise_batch(plan, D, seed)
    base = 0
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
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
    return dict(peak=peak, base=base)


def noise_batch(plan, D, seed):
    """D series of seeded float32 white noise, ``plan.size`` samples."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((D, plan.size), dtype=np.float32)


def survey_batch(plan, D, seed=3, cfg=HEADLINE, period=PULSAR["period"]):
    """D normalised noise series with a pulsar of ``period`` seconds (the
    phase 2 pulsar's by default) in series 0."""
    from riptide_tpu_torch.libffa import generate_signal

    batch = noise_batch(plan, D, seed)
    np.random.seed(seed)
    x = generate_signal(plan.size, period / cfg["tsamp"],
                        amplitude=PULSAR["amplitude"], ducy=0.05)
    batch[0] = (x - x.mean()) / x.std()
    return batch


def _survey_run(dev, plan, prepared, D, tobs, name):
    """One recorded run_search_batch from ``prepared``, the second of two
    (its launch counts and cluster kernel launches set to 0 just before
    it and read just after), checked against the plan's layout. Returns
    what phases 5 to 13 read of it."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine, peaks_device

    nw = len(plan.widths)
    dms = np.zeros(D)
    engine.run_search_batch(plan, None, tobs, dms=dms, prepared=prepared,
                            device=dev)
    base = 0
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fk.reset_launches()
    peaks_device.CLUSTER_LAUNCHES = 0
    with engine.recording() as rec:
        t0 = time.perf_counter()
        handle = engine.queue_search_batch(plan, None, tobs,
                                           prepared=prepared, device=dev)
        snr = engine.search_snr_dev(handle)
        peaks, _ = engine.collect_search_batch(handle, dms)
        wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    clusters = peaks_device.CLUSTER_LAUNCHES
    lay = engine.launch_layout(plan, "uint6")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"  {name}: {len(lay.launches)} launches in its layout, "
          f"{len(lay.absorbed)} absorbed buckets; launches {launches}, "
          f"cluster kernel {clusters}; {wall:.3f} s wall without the host "
          f"prep, {D / wall:.3f} DM-trials/s, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"    split: copy to card {rec['ship_s']:.4f} s, stage loop "
          f"{rec['stages_s']:.4f} s wall, assembly "
          f"{rec['assemble_s']:.4f} s, peak program {rec['peaks_s']:.4f} s, "
          f"pull + host tail {rec['collect_s']:.4f} s", flush=True)
    check_launches(name, launches, engine.queued_launches(plan))
    check(clusters == int(dev.type == "cuda"), f"{name}: {clusters} "
          "cluster kernel launches; want one for its peak program")
    check(np.isfinite(snr.cpu().numpy()).all() and snr.shape == (
        D, plan.length, nw), f"{name}: S/N cube {tuple(snr.shape)}")
    return dict(launches=launches, snr=snr, peaks=peaks, rec=rec, wall=wall,
                peak=peak, base=base, clusters=clusters)


def _check_pulsar(name, peaks, period, tobs):
    best = peaks[0][0] if peaks[0] else None
    check(best is not None, f"{name}: no peak in series 0")
    dfreq = abs(best.freq - 1.0 / period)
    print(f"  {name}: {sum(map(len, peaks))} peaks; series 0: best S/N "
          f"{best.snr:.3f} at P = {best.period:.6f} s, width {best.width} "
          f"(|df| = {dfreq:.3e} Hz, 1/T = {1.0 / tobs:.3e} Hz)", flush=True)
    check(dfreq < 1.0 / tobs, f"{name}: injected pulsar not recovered")


def phase_survey(dev, plan, D=32, cfg=HEADLINE):
    """Phase 5: run_search_batch at the headline configuration from one
    prepared wire, then the overlapped two-chunk survey. Returns the run
    for phases 5c to 13: the batch, its peaks, S/N cube, wall, peak
    device memory and cluster kernel launches."""
    tobs = cfg["nsamp"] * cfg["tsamp"]
    batch = survey_batch(plan, D, cfg=cfg)
    prepared, walls = prep_both(plan, batch, f"D = {D} survey")
    prep = walls["native"][0]
    a = _survey_run(dev, plan, prepared, D, tobs, "headline survey")
    print(f"    {D / (a['wall'] + prep):.3f} DM-trials/s with the native "
          "prep in series", flush=True)
    _check_pulsar("headline survey", a["peaks"], PULSAR["period"], tobs)
    overlapped_survey(dev, plan, D, batch, a["peaks"], a["wall"],
                      walls, cfg)
    return dict(batch=batch, peaks=a["peaks"], snr=a["snr"], wall=a["wall"],
                peak=a["peak"], base=a["base"], clusters=[a["clusters"]])


def phase_k3(dev, D=32, cfg=EXAMPLE_LONG, widths=EXAMPLE_LONG_WIDTHS,
             want_pairs=EXAMPLE_LONG_PAIRS, period=EXAMPLE_LONG_PULSAR):
    """Phase 5k: K3 on the example_long plan, whose layout pairs
    ``want_pairs`` lane buckets: a D-trial run_search_batch (as
    :func:`_survey_run`), every K3 launch held against
    ``paired_stage_plain``, its containers after the segment kernel and
    every global level against the plain levels bit for bit, and K3
    timed over all of them. Returns the K3 launch count, the largest
    difference from plain, (ms, plain ms, bound ms, bound by), the run's
    cluster kernel launches and what phase 13 repeats (the plan, batch,
    tobs, peaks and the S/N cube's digest)."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    plan = headline_plan(cfg, widths)
    tobs = cfg["nsamp"] * cfg["tsamp"]
    nw = len(plan.widths)
    batch = survey_batch(plan, D, cfg=cfg, period=period)
    prepared = engine.prepare_stage_data(plan, batch)
    view = prepared[1]["view"]
    r = _survey_run(dev, plan, prepared, D, tobs, "example_long survey")
    _check_pulsar("example_long survey", r["peaks"], period, tobs)
    k3 = [x for x in r["rec"]["launches"] if x["kind"] == "paired_stage"]
    check(len(k3) == r["launches"]["paired_stage"] == want_pairs,
          f"example_long: {len(k3)} K3 launches, want {want_pairs}")
    args = [x["args"] for x in k3]
    check_levels("K3 levels", [(fk.WireSource(*x[:4]), x[4]) for x in args])
    err = compare_stages("K3 paired_stage", [x["out"] for x in k3],
                         plain_launches(r["rec"], "paired_stage"))

    def k3_calls():
        return [fk.paired_stage(*x) for x in args]

    ms = measure.graph_ms(k3_calls, dev, REPS)
    wms = measure.median_ms(k3_calls, dev, REPS)
    pms = measure.median_ms(
        lambda: [fk.paired_stage_plain(*x) for x in args], dev, reps=5)
    ops = sum(trials_work(_trials(plan, x), D, nw) for x in k3)
    bnd = measure.bound_ms(launch_bytes(k3, view), ops)
    print(f"  K3 over example_long's {len(k3)} hosted buckets, D = {D}: "
          f"{ms:.4f} ms device, from CUDA graph replays ({wms:.4f} ms "
          f"through the wrappers; plain {pms:.4f} ms, bound {bnd[0]:.4f} ms "
          f"by {bnd[1]})", flush=True)
    witness = dict(plan=plan, batch=batch, tobs=tobs, peaks=r["peaks"],
                   snr_digest=cube_digest(r["snr"]))
    return (len(k3), err, (ms, pms, *bnd), r["clusters"], witness)


def _bits(x):
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.dtype, x.shape, x.tobytes()


def phase_cluster(dev, plan, p5, cfg=HEADLINE):
    """Phase 5c: the peak program's cluster kernel (``csrc/cluster.cu``)
    on phase 5's S/N cube, through the survey's own peak plan. The
    program runs once (``CLUSTER_LAUNCHES`` set to 0 just before it and
    read just after: one launch); then ``cluster_columns`` on the
    cube and the program's threshold coefficients (from its packed
    output, float32 there) must give the plain form's four outputs
    (``_cluster_impl`` over ``_thr_impl`` on the same card tensors) bit
    for bit, and the program's packed outputs. The kernel is timed from
    CUDA graph replays and through the wrapper, the plain form alike,
    beside the bound of the bytes the kernel must move. Returns the
    ``kernels`` line's entry."""
    from riptide_tpu_torch.search import engine, peaks_device

    pp = engine._peak_plan(plan, cfg["nsamp"] * cfg["tsamp"])
    check(pp.device_cluster, "the survey's peak plan clusters on the host")
    snr = p5["snr"]                                  # (D, n, NW)
    D, n, nw = snr.shape
    peaks_device.CLUSTER_LAUNCHES = 0
    buf = pp._fused(snr)
    launches = peaks_device.CLUSTER_LAUNCHES
    check(launches == 1, f"the peak program launched the cluster kernel "
          f"{launches} times; want one")
    extra = pp._unpack(buf.cpu().numpy(), D)[4]
    s = snr.transpose(1, 2).contiguous()             # the program's cube
    coef = torch.from_numpy(np.ascontiguousarray(extra["coef"])).to(dev)
    consts = pp._device_consts(dev)

    def kernel():
        return peaks_device.cluster_columns(s, coef, consts["logf"],
                                            consts["reach"], pp.smin,
                                            pp.REP_CAP)

    def plain():
        return pp._cluster_impl(s, pp._thr_impl(coef))

    got, want = kernel(), plain()
    names = ("ncl", "marg", "rep_idx", "rep_val")
    for name, g, w in zip(names, got, want):
        check(_bits(g) == _bits(w), f"cluster kernel: {name} is not the "
              "plain form's bits")
    ncl, marg, rep_idx, rep_val = (g.cpu().numpy() for g in got)
    packed = np.where(rep_idx >= 0, rep_val, np.float32(0.0))
    check(np.array_equal(ncl, extra["ncl"]) and np.array_equal(
        marg, extra["marg"]) and np.array_equal(rep_idx, extra["rep_idx"])
        and _bits(packed) == _bits(extra["rep_val"]),
        "cluster kernel: not the peak program's packed outputs")
    ms = measure.graph_ms(kernel, dev, REPS)
    wms = measure.median_ms(kernel, dev, REPS)
    pms = measure.median_ms(plain, dev, reps=5)
    # Compulsory bytes: the cube once, the coefficients, logf and reach,
    # and the four outputs; operations: the threshold by Horner (a
    # multiply and an add a coefficient) and four comparisons a cell.
    cap = pp.REP_CAP
    nbytes = (s.numel() * 4 + coef.numel() * 4 + n * 8
              + D * nw * (4 + 1 + cap * (8 + 4)))
    bms, by = measure.bound_ms(nbytes, s.numel() * (2 * coef.shape[-1] + 4))
    print(f"  {D} x {nw} x {n} cube ({s.numel() * 4 / 1e9:.3f} GB), "
          f"{int(ncl.sum())} clusters, {int(marg.sum())} marginal columns: "
          f"the four outputs the plain form's bits and the program's; "
          f"cluster kernel {ms:.4f} ms device, from CUDA graph replays "
          f"({wms:.4f} ms through the wrapper; plain {pms:.4f} ms, "
          f"{pms / ms:.1f}x; bound {bms:.4f} ms by {by}, "
          f"{100 * bms / ms:.1f} %); launches in phase 5's runs "
          f"{p5['clusters']}", flush=True)
    return {"name": "CL cluster_columns", "route": "cuda",
            "source": "riptide_tpu_torch/csrc/cluster.cu",
            "replaces": None, "launches": launches,
            "survey_launches": p5["clusters"], "max_abs_err": 0.0,
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def write_presto(path, data, tsamp, dm=0.0):
    """Write a float32 series as a PRESTO .inf/.dat pair (``path`` +
    ".inf"/".dat") with the port's writer. Returns the .inf path."""
    from riptide_tpu_torch.reading.presto import write_presto as write

    return write(path, data, tsamp, dm=dm, observer="chip_smoke")


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


def wide_timing(dev, plan, rec, kind):
    """(device ms, plain ms, bound ms, bound by) of one pass of a
    recorded wide search's ``kind`` launches on the operands each had:
    device time from CUDA graph replays, as phase 3 times the
    headline's, the bound from the same counts (K1: :func:`launch_bytes`
    and :func:`trials_work`; K2: :func:`k2_work`)."""
    from riptide_tpu_torch.ops import ffa_kernel as fk

    launches = [r for r in rec["launches"] if r["kind"] == kind]
    args = [r["args"] for r in launches]
    if kind == "fused_stage":
        nw = len(plan.widths)
        ops = sum(trials_work(_trials(plan, r), rec["wire"].shape[0], nw)
                  for r in launches)
        bound = measure.bound_ms(launch_bytes(launches, rec["meta"]["view"]),
                                 ops)

        def calls():
            return [fk.fused_stage(*a) for a in args]
    else:
        bound = measure.bound_ms(*k2_work(launches, plan,
                                          [a[0] for a in args]))
        # cascade_stage uses its input as level scratch: the timed calls
        # reuse one set of copies (the work does not depend on the
        # values).
        scratch = [(a[0].clone(),) + tuple(a[1:]) for a in args]

        def calls():
            return [fk.cascade_stage(*a) for a in scratch]
    ms = measure.graph_ms(calls, dev, REPS)
    pms = measure.median_ms(lambda: plain_launches(rec, kind), dev, reps=3)
    return ms, pms, *bound


def _split_entry(ms, nbytes, ops):
    bms, by = measure.bound_ms(nbytes, ops)
    return {"ms": ms, "bound_ms": bms, "bound_by": by}


def kernel_split(dev, rec, kind):
    """Device ms of each CUDA kernel of a recorded search's ``kind``
    launches alone, summed over the launches (CUDA graph replays, as
    :func:`wide_timing`), each beside its bound: ``segment`` (the
    segment kernel), ``levels`` (one entry per global level, in order)
    and ``snr`` (the S/N kernel). The bound counts each input byte once
    (the stage's wire rows and scales, or the container's live rows; a
    level's distinct source rows; the S/N's evaluated rows), each output
    byte once (the container; the S/N's output) and the operations of
    each (decode, one add per phase a level, the S/N's prefix and
    windows). Calls the kernel library's launchers directly, so that
    one kernel runs alone."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.utils.cuda_build import stream

    lib = fk._library()
    stages = []
    for r in (r for r in rec["launches"] if r["kind"] == kind):
        a = r["args"]
        tables, coefs = a[-2:]
        src = a[0] if kind == "cascade_stage" else fk.WireSource(*a[:-2])
        x0 = fk.segment_levels(src, tables, 0)
        stages.append((src, tables, coefs, x0, torch.empty_like(x0),
                       fk.segment_levels(src, tables)))
    torch.cuda.synchronize(dev)

    def row_work(tables, D):
        p = tables.p.tolist()
        B, R, P = len(p), tables.h.shape[2], tables.P
        return p, D * B * R * P * 4

    seg_b = seg_ops = 0
    for src, tables, coefs, x0, _, _ in stages:
        p, cont = row_work(tables, x0.shape[0])
        m = tables.m.tolist()
        live = sum(mi * pi for mi, pi in zip(m, p))
        if kind == "cascade_stage":
            seg_b += cont + x0.shape[0] * live * 4
        else:
            for g, span in ((src.geom, tables.span),
                            (src.guest, tables.gspan)):
                if g is None:
                    continue
                group, planes = fk.WIRE_MODES[g.mode]
                PW = src.wire.shape[2]
                rows = -(-span // PW)
                seg_b += x0.shape[0] * (planes * -(-rows // group) * PW
                                        + rows * 4)
            seg_b += cont
            seg_ops += 2 * x0.shape[0] * live
    out = {"segment": _split_entry(measure.graph_ms(
        lambda: [fk.segment_levels(s[0], s[1], 0) for s in stages], dev,
        REPS), seg_b, seg_ops), "levels": []}
    first = {s[1].local for s in stages}
    L = {s[1].h.shape[0] for s in stages}
    check(len(first) == 1 and len(L) == 1, "launches of one search with "
          "different level splits")
    first, L = first.pop(), L.pop()
    for lev in range(first, L):
        nb = ops = 0
        for _, tables, _, x0, _, _ in stages:
            D = x0.shape[0]
            p, cont = row_work(tables, D)
            Z = tables.h.shape[2] - 1
            h, t = tables.h[lev].cpu(), tables.t[lev].cpu()
            for b, pb in enumerate(p):
                srcs = set(h[b].tolist()) | set(t[b].tolist())
                nb += D * len(srcs - {Z}) * pb * 4
                ops += D * int((h[b] != Z).sum() + (t[b] != Z).sum()) * pb
            nb += cont

        def level(lev=lev):
            for _, tables, _, x0, x1, _ in stages:
                D, B, R, P = x0.shape
                fk._check(lib, "ffa_levels", lib.rt_ffa_levels(
                    x0.data_ptr(), x1.data_ptr(), tables.h.data_ptr(),
                    tables.t.data_ptr(), tables.shift.data_ptr(),
                    tables.p.data_ptr(), lev, lev + 1, D, B, R, P,
                    stream(dev)))
        out["levels"].append(_split_entry(measure.graph_ms(level, dev, REPS),
                                          nb, ops))
    nb = ops = 0
    for _, tables, coefs, x0, _, _ in stages:
        D, RE, NW = x0.shape[0], coefs.rows, coefs.widths.shape[0]
        p, _ = row_work(tables, D)
        nb += D * RE * sum(p) * 4 + D * len(p) * RE * NW * 4
        ops += D * RE * sum(pb + 3 * NW * pb + 5 * NW for pb in p)
    out["snr"] = _split_entry(measure.graph_ms(
        lambda: [fk._snr(fk._runtime(dev), s[5], s[1], s[2])
                 for s in stages], dev, REPS), nb, ops)
    return out


def print_split_kernels(name, split):
    """One line of :func:`kernel_split`: each kernel's ms, its bound and
    its share of the bound."""
    parts = [("segment", split["segment"])] + [
        (f"level {i}", e) for i, e in enumerate(split["levels"])] + [
        ("S/N", split["snr"])]
    print(f"  {name} by CUDA kernel: " + "; ".join(
        f"{n} {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} by "
        f"{e['bound_by']}, {100 * e['bound_ms'] / e['ms']:.1f} %)"
        for n, e in parts), flush=True)


def wide_search(entry, widths=WIDE_WIDTHS):
    """(plan, data) of one phase 5w search: the plan of ``entry`` (a
    :data:`WIDE` row), checked to cross its limit, and seeded noise with
    a pulse every 1.0005 * bins_max samples."""
    from riptide_tpu_torch.libffa import generate_signal
    from riptide_tpu_torch.search import periodogram_plan

    limit, nsamp, tsamp, bmin, bmax = entry
    pmin = bmax * tsamp
    plan = periodogram_plan(nsamp, tsamp, widths, pmin, 1.001 * pmin, bmin,
                            bmax)
    check(plan.P > limit, f"P = {plan.P} does not cross {limit}")
    np.random.seed(5)
    data = generate_signal(nsamp, 1.0005 * bmax, amplitude=20.0, ducy=0.01)
    return plan, ((data - data.mean()) / data.std()).astype(np.float32)


# Phase 5w's bit check: a narrow trial (m, p), and the wider trials
# whose containers take the wide S/N in a block and in a cluster a row.
WIDE_BITS_TRIAL, WIDE_BITS_P = (23, 14013), (14531, 60001)


def wide_snr_bits(dev, trial=WIDE_BITS_TRIAL, wide_ps=WIDE_BITS_P,
                  widths=WIDE_WIDTHS, seed=7):
    """K2 on a seeded trial of p <= 14,528 alone in its container (the
    narrow S/N kernel) and beside a wider trial in a container past
    14,528 (the wide S/N kernel); the trial's S/N must be the same bits.
    Returns one entry per wider trial: its p, the container's width and
    S/N launch, and whether the bits were equal."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.ops.plan import FFABatchPlan
    from riptide_tpu_torch.ops.snr import boxcar_coeffs
    from riptide_tpu_torch.search import engine

    m, p = trial
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, m, p)).astype(np.float32)

    def snr(ps, extra=None):
        b = FFABatchPlan([m] * len(ps), ps, R=m + 1)
        hb = [boxcar_coeffs(q, widths) for q in ps]
        tables, coefs = engine._operands(
            b, widths, np.array([h for h, _ in hb], np.float32),
            np.array([c for _, c in hb], np.float32),
            np.full(len(ps), np.sqrt(m), np.float32), m, dev)
        cont = np.zeros((2, len(ps), m + 1, b.P), np.float32)
        cont[:, 0, :m, :p] = x
        if extra is not None:
            cont[:, 1, :m, : ps[1]] = extra
        out = fk.cascade_stage(torch.from_numpy(cont).to(dev), tables, coefs)
        return b.P, out[:, 0].cpu()

    P0, narrow = snr([p])
    check(P0 <= fk.NARROW_P, f"narrow container P = {P0}")
    out = []
    for q in wide_ps:
        P, wide = snr([p, q], rng.standard_normal((2, m, q)))
        same = torch.equal(wide, narrow)
        launch = fk.snr_launch(P)
        print(f"  S/N bits of a p = {p} trial: alone (P = {P0}, narrow) and "
              f"beside p = {q} (P = {P}, {launch}): "
              f"{'equal' if same else 'DIFFERENT'}", flush=True)
        check(same, f"the wide S/N at P = {P} changed a p = {p} trial's bits")
        out.append({"p": p, "wide_p": q, "P": P, "cluster": launch.cluster,
                    "equal": same})
    return out


def phase_wide(dev, wide=WIDE, widths=WIDE_WIDTHS):
    """Phase 5w: a search per ``wide`` entry whose padded width P crosses
    the entry's limit, on the uint6 wire (K1) and the float32 wire (K2),
    the counts set to 0 just before each search and read just after;
    every launch held against its plain version, and each search's K1
    or K2 launches timed (:func:`wide_timing`) and split by CUDA kernel
    (:func:`kernel_split`); then the narrow-against-wide S/N bit check
    (:func:`wide_snr_bits`). Returns, per kernel, one entry a search:
    its P, the limit it crosses, launches (by wrapper and by CUDA
    kernel), device and plain ms, bound and what bounds it, the largest
    difference from plain and the split; and the bit check's entries."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    out = {"fused_stage": [], "cascade_stage": []}
    for entry in wide:
        limit = entry[0]
        plan, data = wide_search(entry, widths)
        for mode, kind in WIDE_KINDS:
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
                  f"CUDA launches {cuda}; {fk.snr_launch(plan.P)}, level "
                  f"grid (blocks, threads) {fk.level_grid(1, 1, 1, plan.P)} "
                  f"a row, tile-local levels {locs}; best S/N "
                  f"{snrs.max():.3f}", flush=True)
            err = compare_stages(f"{kind} at P = {plan.P}",
                                 kernel_outs(rec, kind),
                                 plain_launches(rec, kind))
            ms, pms, bms, by = wide_timing(dev, plan, rec, kind)
            print(f"  {kind} over the {launches[kind]} launches at P = "
                  f"{plan.P}: {ms:.4f} ms device, from CUDA graph replays "
                  f"(plain {pms:.4f} ms, bound {bms:.4f} ms by {by}, "
                  f"{100 * bms / ms:.1f} % of it)", flush=True)
            split = kernel_split(dev, rec, kind)
            print_split_kernels(f"{kind} at P = {plan.P}", split)
            out[kind].append({"P": plan.P, "limit": limit,
                              "launches": launches[kind], "ms": ms,
                              "plain_ms": pms, "bound_ms": bms,
                              "bound_by": by, "max_abs_err": err,
                              "cuda_launches": cuda, "split": split})
            del rec
    return out, wide_snr_bits(dev)


def overlapped_survey(dev, plan, D, batch, want_peaks, wall, walls,
                      cfg=HEADLINE, seed=4):
    """Two survey chunks with the prep overlapped, as a survey runs them:
    chunk 1 prepared into a pinned :class:`StagingPool` and queued, chunk
    2 prepared on a worker thread into the pool while the card runs
    chunk 1, then collected and run; twice, the second pass from the
    buffers the first gave back. Chunk 1 is phase 5's batch: its peaks
    must be phase 5's. Prints DM-trials/s beside phase 5's without the
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
              "differ from phase 5's")
        check(all(np.isfinite([pk.snr for pk in x]).all() for x in peaks2),
              "overlapped survey: chunk 2 gave non-finite peaks")
        reused = len(ptrs & seen)
        recycled_first = first <= seen
        seen |= ptrs
        print(f"  overlapped survey, pass {rnd}: 2 chunks of D = {D} in "
              f"{wall2:.3f} s, {2 * D / wall2:.3f} DM-trials/s with the prep "
              f"overlapped ({reused} of {len(ptrs)} staging buffers recycled);"
              f" phase 5 {D / wall:.3f} DM-trials/s without the prep, "
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
    a device error. Returns K1's launches over the phase and the probe
    run's journal directory (phase 9 reads it)."""
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
    return k1, probe["jdir"]


def run_app(app, args):
    """One of the port's report/watch CLIs run by path in a fresh
    process, as on a login node: (exit code, stdout, stderr)."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "riptide_tpu_torch", "apps", f"{app}.py")
    proc = subprocess.run([sys.executable, script, *args],
                          capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout, proc.stderr


def phase_readers(jdir, nchunks):
    """Phase 9a: the readers over phase 8's probed journal:
    ``build_report`` (no phase-sum violation, every chunk done, the
    integrity verdict ``ok``), then ``rreport``, ``rtop --once`` and
    ``rwatch --once`` by path, each exiting 0."""
    from riptide_tpu_torch.obs import report

    rep = report.build_report(jdir)
    check(not rep["phase_sum_violations"] and rep["chunks_done"] == nchunks
          and rep["integrity"]["device_verdict"] == "ok",
          f"report of phase 8's journal: {rep['chunks_done']} chunks, "
          f"violations {rep['phase_sum_violations']}, integrity "
          f"{rep['integrity']}")
    print(f"  (a) build_report: {rep['chunks_done']} chunks done, no "
          f"phase-sum violation, integrity {rep['integrity']['chunks_probed']}"
          f" chunks probed, device verdict "
          f"{rep['integrity']['device_verdict']}; mean chunk_s "
          f"{rep['run']['chunk_s']:.3f} s, device_s {rep['run']['device_s']:.3f}"
          f" s", flush=True)
    state = report.JournalFollower(jdir).poll()
    walls = [state["chunks"][cid]["timings"]["chunk_s"]
             for cid in sorted(state["chunks"])]
    print(f"  (a) chunk_s by chunk {walls} s, straggler_ratio "
          f"{report.watch_snapshot(state)['straggler_ratio']} (rwatch's "
          "alert limit 3.0)", flush=True)
    for app, args in (("rreport", [jdir]), ("rtop", [jdir, "--once"]),
                      ("rwatch", [jdir, "--once"])):
        t0 = time.perf_counter()
        rc, out, err = run_app(app, args)
        check(rc == 0, f"{app} on phase 8's journal exited {rc}:\n{out}\n"
              f"{err[-2000:]}")
        lines = out.strip().splitlines()
        print(f"  (a) {app} by path: exit 0 in "
              f"{time.perf_counter() - t0:.2f} s, {len(lines)} lines; "
              f"{lines[-1 if app == 'rwatch' else 1].strip()}", flush=True)


def phase_campaign(root, card):
    """Phase 9b: the chaos campaign's builtin schedules, every leg a
    fresh process on the card. Returns the summary."""
    from riptide_tpu_torch.survey import chaos

    files = chaos.write_trials(os.path.join(root, "data"))
    t0 = time.perf_counter()
    summary = chaos.run_campaign(files, os.path.join(root, "w"),
                                 schedules=chaos.builtin_schedules(),
                                 device="cuda")
    wall = time.perf_counter() - t0
    for s in summary["per_schedule"]:
        check(all(r["device"] == "cuda" for r in s["reports"]),
              f"chaos {s['name']}: a leg ran off the card")
        print(f"  (b) {s['name']:<26} {s['legs']} leg(s) {s['wall_s']:6.2f} s,"
              " K1 launches by leg "
              + ", ".join(f"{r['k1_launches']}"
                          + (" (killed)" if r["killed"] else "")
                          + ("" if r["chunks_done"] else " (replayed all)")
                          for r in s["reports"]), flush=True)
    k1 = sum(s["k1_launches"] for s in summary["per_schedule"])
    legs = [r for s in summary["per_schedule"] for r in s["reports"]]
    ran = [r for r in legs if r["run_s"] is not None]
    print("  (b) a leg's wall: interpreter, imports and exit "
          f"{np.mean([r['wall_s'] - r['leg_s'] for r in legs]):.2f} s, "
          "fault plan, journal and searcher "
          f"{np.mean([r['leg_s'] - (r['run_s'] or 0.0) for r in legs]):.2f} s,"
          " the scheduler's run (CUDA context and library loads included) "
          f"{np.mean([r['run_s'] for r in ran]):.2f} s, on average over "
          f"{len(legs)} legs", flush=True)
    print(f"  (b) campaign on {card}: {summary['schedules']} schedules, "
          f"{summary['legs']} legs in {wall:.1f} s "
          f"({wall / summary['legs']:.2f} s a leg), every schedule's "
          f"peaks.csv the control run's {summary['peaks_csv_bytes']} bytes; "
          f"K1 launches {k1}", flush=True)
    return summary, k1


def phase_compare(root, summary):
    """Phase 9a's comparison: ``rreport --compare`` of the control
    schedule's journal over a ledger of every schedule's rows; its
    platform scope must be the card's."""
    ledger = os.path.join(root, "ledger.jsonl")
    with open(ledger, "wb") as out:
        for s in summary["per_schedule"]:
            with open(os.path.join(root, "w", s["name"], "ledger.jsonl"),
                      "rb") as fobj:
                out.write(fobj.read())
    doc = os.path.join(root, "compare.json")
    rc, out, err = run_app("rreport", [
        os.path.join(root, "w", "control", "j"), "--compare", ledger,
        "--quiet", "--json", doc])
    check(rc in (0, 1), f"rreport --compare exited {rc}:\n{err[-2000:]}")
    with open(doc) as fobj:
        verdict = json.load(fobj)["compare"]
    want = {"backend": "cuda", "device_kind": torch.cuda.get_device_name(0)}
    check(verdict.get("platform") == want,
          f"rreport --compare scoped to {verdict.get('platform')}, want {want}")
    print(f"  (a) rreport --compare (control journal, {verdict['baseline_n']}"
          f" baseline rows of the campaign's ledger): exit {rc}, verdict "
          f"{verdict['verdict']}, device {verdict['current']} s/chunk against "
          f"median {verdict.get('baseline_median')} (threshold "
          f"{verdict.get('threshold')}); platform scope {verdict['platform']}",
          flush=True)


def cache_step(step, jdir):
    """Phase 9c's fresh process ``step``: 1 builds and loads
    ``ffa_stage.cu`` with ``cache_corrupt:exec_cache_store:1`` armed; 2
    loads it again (the digest check must evict and rebuild) and runs a
    headline search, every K1 launch held against ``fused_stage_plain``;
    3 loads it once more. Incidents go to the journal at ``jdir``.
    Prints one JSON line."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine, run_periodogram
    from riptide_tpu_torch.survey import incidents
    from riptide_tpu_torch.survey.faults import FaultPlan
    from riptide_tpu_torch.survey.journal import SurveyJournal
    from riptide_tpu_torch.survey.metrics import get_metrics
    from riptide_tpu_torch.utils import fsio
    from riptide_tpu_torch.utils.exec_cache import file_digest

    journal = SurveyJournal(jdir)
    incidents.set_sink(journal.record_incident)
    if step == 1:
        fsio.set_storage_faults(
            FaultPlan.parse("cache_corrupt:exec_cache_store:1").storage_op)
    t0 = time.perf_counter()
    fk._LIB.load()
    info = fk._LIB.info
    out = {"action": info["action"], "load_s": time.perf_counter() - t0,
           "nvcc_s": info["seconds"], "verify_s": info["verify_s"],
           "digest": info["digest"], "path": info["path"],
           "stored": file_digest(info["path"]),
           "evictions": get_metrics().counter("cache_evictions"),
           "incidents": [r["incident"] for r in journal.incidents()]}
    if step == 2:
        dev = torch.device("cuda")
        plan = headline_plan()
        fk.reset_launches()
        with engine.recording() as rec:
            run_periodogram(plan, headline_series().data, device=dev)
        out["k1_launches"] = fk.LAUNCHES["fused_stage"]
        out["max_abs_err"] = compare_stages(
            "K1 on the rebuilt library", kernel_outs(rec, "fused_stage"),
            plain_launches(rec, "fused_stage"))
    print(json.dumps(out), flush=True)


def phase_cache(root):
    """Phase 9c: the real kernel library corrupted and rebuilt, under a
    throwaway ``RIPTIDE_CACHE_ROOT``, in three fresh processes
    (``ctypes`` hands back a library already loaded from a path, so
    recovery is shown across processes, as the chaos legs show it)."""
    env = dict(os.environ, RIPTIDE_CACHE_ROOT=os.path.join(root, "cache"))
    jdir = os.path.join(root, "journal")
    here = os.path.dirname(os.path.abspath(__file__))
    steps = []
    for step in (1, 2, 3):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.cache_step({step}, {jdir!r})"],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"cache step {step} exited "
              f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        doc = json.loads(proc.stdout.strip().splitlines()[-1])
        doc["wall"] = time.perf_counter() - t0
        steps.append(doc)
    one, two, three = steps
    check(one["action"] == "compiled" and one["stored"] != one["digest"]
          and not one["incidents"],
          f"cache step 1: {one} (want a build whose stored copy is "
          "corrupted)")
    check(two["action"] == "compiled" and two["evictions"] == 1
          and two["incidents"] == ["cache_corrupt"]
          and two["stored"] == two["digest"] and two["k1_launches"] > 0,
          f"cache step 2: {two} (want one cache_corrupt incident, one "
          "eviction, an nvcc rebuild, K1 launches)")
    check(three["action"] == "loaded" and three["digest"] == two["digest"]
          and three["evictions"] == 0
          and three["incidents"] == ["cache_corrupt"],
          f"cache step 3: {three} (want a clean load of step 2's bytes)")
    print(f"  (c) step 1: nvcc {one['nvcc_s']:.2f} s, compiled and loaded; "
          f"the stored copy's last byte flipped (digest {one['stored'][:12]}"
          f" != {one['digest'][:12]}); {one['wall']:.1f} s", flush=True)
    print(f"  (c) step 2: digest mismatch -> one cache_corrupt incident, "
          f"cache_evictions {two['evictions']}, nvcc rebuild "
          f"{two['nvcc_s']:.2f} s; {two['k1_launches']} K1 launches of a "
          f"headline search within tolerance (max |kernel - plain| "
          f"{two['max_abs_err']:.3e}); {two['wall']:.1f} s", flush=True)
    print(f"  (c) step 3: loaded, the same bytes ({three['digest'][:12]}), "
          f"digest check {1e3 * three['verify_s']:.2f} ms, load "
          f"{three['load_s']:.3f} s; {three['wall']:.1f} s", flush=True)


def phase_chaos(jdir, nchunks, card):
    """Phase 9: the readers over phase 8's probed journal (a), the chaos
    campaign on the card with ``rreport --compare`` over its ledger (b),
    the kernel library corrupted and rebuilt (c). Returns K1's launches
    over the campaign's legs."""
    import shutil
    import tempfile

    from riptide_tpu_torch.utils.cuda_build import BUILD_DIR

    phase_readers(jdir, nchunks)
    root = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        summary, k1 = phase_campaign(root, card)
        phase_compare(root, summary)
        phase_cache(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return k1


# Phase 10: the served survey's job specs take phase 7's range and
# de-reddening with SERVE_CHUNK trials a chunk and SERVE_IO_THREADS
# loader threads (one thread would take ~45 s a chunk at full width).
SERVE_CHUNK, SERVE_IO_THREADS = 8, 16
# rseek --submit searches trial 0, where the pulsar is all but absent:
# a lower threshold than rseek's 7 keeps some noise peaks to compare.
SERVE_RSEEK_SMIN = 5.0


def http_json(base, path, method="GET", body=None, headers=None):
    """One loopback request: (status, parsed JSON or raw bytes,
    response headers)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"} if data else {}
    hdrs.update(headers or {})
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            code, raw, got = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as err:
        code, raw, got = err.code, err.read(), dict(err.headers)
    try:
        return code, json.loads(raw), got
    except ValueError:
        return code, raw, got


def wait_for(pred, what, timeout=600.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise RuntimeError(f"timed out waiting for {what}")


class TurnLog:
    """The fair-share queue's turns, instrumented: each turn's job, chunk
    and K1 launches (``ffa_kernel.LAUNCHES["fused_stage"]`` read as the
    turn begins and ends; turns never overlap, so the difference is that
    job's)."""

    def __init__(self, queue):
        from riptide_tpu_torch.ops import ffa_kernel as fk

        self.turns = []
        self._open = {}
        begin, end = queue.begin, queue.end

        def logged_begin(job_id, chunk_id):
            begin(job_id, chunk_id)
            self._open[job_id] = (chunk_id, fk.LAUNCHES["fused_stage"],
                                  time.perf_counter())

        def logged_end(job_id, chunk_id):
            opened = self._open.pop(job_id, None)
            if opened is not None:
                cid, k0, t0 = opened
                self.turns.append((job_id, cid,
                                   fk.LAUNCHES["fused_stage"] - k0,
                                   time.perf_counter() - t0))
            end(job_id, chunk_id)

        queue.begin, queue.end = logged_begin, logged_end

    def k1(self, job_id):
        return sum(k for j, _, k, _ in self.turns if j == job_id)


def serve_spec(p7, files, tenant, **extra):
    """A phase 10 job spec over ``files``: phase 7's range and
    de-reddening."""
    return dict({"files": list(files), "fmt": "presto", "tenant": tenant,
                 "chunk_files": SERVE_CHUNK, "io_threads": SERVE_IO_THREADS,
                 "deredden": p7["conf"]["dereddening"],
                 "search": p7["conf"]["ranges"]}, **extra)


def direct_csv(dev, spec, path):
    """``spec``'s chunks through a ``SurveyScheduler`` in this process,
    as the daemon builds them but with no journal and no gate; writes
    ``peaks.csv`` to ``path`` and returns its bytes and the peaks."""
    from riptide_tpu_torch.pipeline.batcher import BatchSearcher
    from riptide_tpu_torch.serve.daemon import write_peaks_csv
    from riptide_tpu_torch.survey.scheduler import SurveyScheduler

    files, per = spec["files"], spec.get("chunk_files") or 1
    searcher = BatchSearcher(spec["deredden"], spec["search"],
                             fmt=spec["fmt"],
                             io_threads=spec.get("io_threads") or 1,
                             device=dev)
    peaks = SurveyScheduler(searcher, [files[i:i + per] for i in
                                       range(0, len(files), per)]).run()
    write_peaks_csv(peaks, path)
    with open(path, "rb") as fobj:
        return fobj.read(), peaks


def job_wall(doc):
    from riptide_tpu_torch.serve.daemon import parse_utc

    return parse_utc(doc["finished_utc"]) - parse_utc(doc["started_utc"])


def chunk0_queue_s(doc):
    from riptide_tpu_torch.survey.journal import SurveyJournal

    recs = SurveyJournal(doc["directory"]).completed_chunks()
    return recs[0][0]["timings"]["queue_s"]


def read_bytes(doc, name="peaks.csv"):
    with open(os.path.join(doc["directory"], name), "rb") as fobj:
        return fobj.read()


def phase_serve(dev, p7, card):
    """Phase 10: the survey service on phase 7's trials, its jobs on
    ``dev``. (a) two tenants' jobs at once over HTTP (the two halves of
    the trials): both done, their turns interleaved, each ``peaks.csv``
    the bytes of a direct ``SurveyScheduler`` run of the same chunks, K1
    launched in each job's turns, the pair's peak device memory under
    twice the direct runs'; (b) a warm repeat of the first job's
    geometry: ``warm_start`` and ``exec_cold_builds`` flat; (c) a job
    drained after its first chunk (a priority -1 blocker parks it at its
    next gate), a new daemon on the same root resuming it to the second
    job's bytes; (d) ``rreport`` and ``rtop --once`` by path on the
    serve root print its job table, and ``rseek --submit`` (a process
    that sees no card) gets a direct run's peak count. The launch counts
    are set to 0 just before each served part and read just after.
    Returns K1's launches in the served jobs' turns."""
    import threading

    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.serve import JobDrained, ServeDaemon
    from riptide_tpu_torch.survey.journal import SurveyJournal
    from riptide_tpu_torch.survey.metrics import get_metrics

    files, n7 = p7["files"], len(p7["files"])
    half = n7 // 2
    root = os.path.join(p7["root"], "serve")
    cuda = dev.type == "cuda"
    specs = {"j0001": serve_spec(p7, files[:half], "a"),
             "j0002": serve_spec(p7, files[half:], "b")}

    def peak_mem():
        return torch.cuda.max_memory_allocated(dev) if cuda else 0

    # The direct runs: the bytes each served job must give.
    want, direct_mem = {}, 0
    for jid, spec in specs.items():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        want[jid], _ = direct_csv(dev, spec, os.path.join(
            p7["root"], f"direct_{jid}.csv"))
        direct_mem = max(direct_mem, peak_mem())
        print(f"  direct run of {jid}'s {len(spec['files'])} trials: "
              f"{time.perf_counter() - t0:.3f} s, {len(want[jid])} bytes of "
              f"peaks.csv", flush=True)

    # (a) two tenants at once.
    d = ServeDaemon(root, port=0, workers=2, device=dev).start()
    base = f"http://127.0.0.1:{d.port}"
    log = TurnLog(d.queue)
    blocker = d.queue.register("blocker", priority=-1)
    blocker.begin(0)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    fk.reset_launches()
    cold0 = get_metrics().counter("exec_cold_builds")
    for jid, spec in specs.items():
        code, doc, _ = http_json(base, "/jobs", "POST", spec)
        check(code == 202 and doc["job_id"] == jid,
              f"(a) submit of {jid}: {code} {doc}")
    # Both jobs wait at their first gate before either takes a turn.
    wait_for(lambda: all(d.queue.snapshot()["jobs"].get(j, {})
                         .get("waiting") for j in specs), "both jobs' gates")
    blocker.end(0)
    d.queue.unregister("blocker")
    wait_for(lambda: all(d.get(j)[1]["status"] in ("done", "failed")
                         for j in specs), "j0001 and j0002")
    launches_a = dict(fk.LAUNCHES)
    served_mem = peak_mem()
    docs = {j: d.get(j)[1] for j in specs}
    for jid, doc in docs.items():
        check(doc["status"] == "done", f"{jid}: {doc.get('status')} "
              f"({doc.get('error')})")
        check(read_bytes(doc) == want[jid],
              f"{jid}: peaks.csv differs from the direct run's")
    order = [j for j, _, _, _ in log.turns if j in specs]
    switches = sum(1 for a, b in zip(order, order[1:]) if a != b)
    check(switches >= 2, f"(a) the jobs' turns do not interleave: {order}")
    k1 = {j: log.k1(j) for j in specs}
    if cuda:
        check(all(k1.values()) and sum(k1.values())
              == launches_a["fused_stage"],
              f"(a) K1 launches in the jobs' turns {k1}, in all "
              f"{launches_a['fused_stage']}")
        check(served_mem < 2 * direct_mem,
              f"(a) the served pair peaked at {served_mem} bytes, over "
              f"twice the direct runs' {direct_mem}")
    print(f"  (a) turns in order: {' '.join(order)} ({switches} switches)",
          flush=True)
    for jid, doc in docs.items():
        wall = job_wall(doc)
        print(f"  (a) {jid} (tenant {doc['tenant']}, "
              f"{len(specs[jid]['files'])} trials, {doc['chunks_total']} "
              f"chunks): wall {wall:.3f} s, "
              f"{len(specs[jid]['files']) / wall:.3f} DM-trials/s, "
              f"queue_wait_s {doc['queue_wait_s']}, device_s "
              f"{doc['device_s']}, K1 launches in its turns {k1[jid]}, "
              "peaks.csv the direct run's bytes", flush=True)
    print(f"  (a) phase 7 (unserved, {n7} trials): {p7['wall']:.3f} s, "
          f"{n7 / p7['wall']:.3f} DM-trials/s; exec_cold_builds over the "
          f"pair {get_metrics().counter('exec_cold_builds') - cold0}",
          flush=True)
    print(f"  (a) peak device memory: served pair "
          f"{served_mem / 2 ** 30:.3f} GiB, direct run "
          f"{direct_mem / 2 ** 30:.3f} GiB", flush=True)
    serve_k1 = launches_a["fused_stage"]

    # (b) a warm repeat of j0001's geometry.
    spec3 = serve_spec(p7, files[:SERVE_CHUNK], "a")
    fk.reset_launches()
    cold0 = get_metrics().counter("exec_cold_builds")
    warm0 = get_metrics().counter("exec_warm_hits")
    code, doc, _ = http_json(base, "/jobs", "POST", spec3)
    check(code == 202, f"(b) submit: {code} {doc}")
    j3 = doc["job_id"]
    wait_for(lambda: d.get(j3)[1]["status"] in ("done", "failed"), j3)
    doc3 = d.get(j3)[1]
    cold = get_metrics().counter("exec_cold_builds") - cold0
    warm = get_metrics().counter("exec_warm_hits") - warm0
    check(doc3["status"] == "done" and doc3["warm_start"] is True
          and cold == 0 and warm > 0,
          f"(b) {j3}: {doc3.get('status')}, warm_start "
          f"{doc3.get('warm_start')}, exec_cold_builds +{cold}, "
          f"exec_warm_hits +{warm}")
    if cuda:
        check(log.k1(j3) > 0 and log.k1(j3) == fk.LAUNCHES["fused_stage"],
              f"(b) {j3}: K1 launches {log.k1(j3)} in its turns, "
              f"{fk.LAUNCHES['fused_stage']} in all")
    serve_k1 += fk.LAUNCHES["fused_stage"]
    print(f"  (b) {j3} ({len(spec3['files'])} trials, j0001's geometry): "
          f"warm_start True, exec_cold_builds +0, exec_warm_hits +{warm}, "
          f"wall {job_wall(doc3):.3f} s, K1 launches {log.k1(j3)}; first "
          f"chunk's queue {chunk0_queue_s(doc3):.3f} s against j0001's "
          f"{chunk0_queue_s(docs['j0001']):.3f} s (the daemon's first job)",
          flush=True)

    # (c) drained after one chunk, then resumed by a new daemon.
    fk.reset_launches()
    blocker = d.queue.register("blocker", priority=-1)
    blocker.begin(0)
    code, doc, _ = http_json(base, "/jobs", "POST",
                             serve_spec(p7, files[half:], "b"))
    check(code == 202, f"(c) submit: {code} {doc}")
    j4 = doc["job_id"]
    jdir4 = os.path.join(root, "jobs", j4)

    def parked():
        return d.queue.snapshot()["jobs"].get(j4, {}).get("waiting")

    def reblock():
        try:
            blocker.begin(1)
        except JobDrained:
            pass

    wait_for(parked, f"{j4} at its first gate")
    blocker.end(0)
    # The blocker queues for the next turn only once the job holds this
    # one (else it could win this one back by its priority).
    wait_for(lambda: d.queue.snapshot()["active"] == j4, f"{j4}'s turn")
    threading.Thread(target=reblock, daemon=True).start()
    wait_for(lambda: len(SurveyJournal(jdir4).completed_chunks()) >= 1
             and parked(), f"{j4}'s first chunk and its next gate")
    code, doc, _ = http_json(base, "/drain", "POST", {})
    check(code == 202 and doc.get("draining"), f"(c) drain: {code} {doc}")
    _, status, _ = http_json(base, "/status")
    code, refused, hdrs = http_json(base, "/jobs", "POST", spec3)
    check(status.get("draining") is True and code == 503
          and hdrs.get("Retry-After"),
          f"(c) while draining: /status {status}, submit {code} {refused}")
    check(d.wait_drained(timeout=120), "(c) the workers did not park")
    doc4 = d.get(j4)[1]
    parks = [r["incident"] for r in SurveyJournal(jdir4).incidents()]
    done4 = sorted(SurveyJournal(jdir4).completed_chunks())
    check(doc4["status"] in ("pending", "running") and "job_drained" in parks
          and done4 == [0],
          f"(c) {j4} after the drain: {doc4['status']}, incidents {parks}, "
          f"chunks journaled {done4}")
    d.stop()
    k1_first = fk.LAUNCHES["fused_stage"]
    d = ServeDaemon(root, port=0, workers=2, device=dev).start()
    base = f"http://127.0.0.1:{d.port}"
    log = TurnLog(d.queue)
    fk.reset_launches()
    wait_for(lambda: d.get(j4)[1]["status"] in ("done", "failed"), j4)
    doc4 = d.get(j4)[1]
    check(doc4["status"] == "done" and doc4.get("resumed") is True
          and read_bytes(doc4) == want["j0002"],
          f"(c) {j4} after the restart: {doc4.get('status')}, resumed "
          f"{doc4.get('resumed')}, peaks.csv the uninterrupted job's bytes "
          f"{read_bytes(doc4) == want['j0002']}")
    if cuda:
        check(log.k1(j4) > 0, f"(c) {j4}: no K1 launch after the restart")
    serve_k1 += k1_first + fk.LAUNCHES["fused_stage"]
    print(f"  (c) {j4}: drained after chunk 0 (/status draining, a submit "
          f"answered 503 with Retry-After {hdrs.get('Retry-After')}, a "
          "job_drained incident, no terminal record); a new daemon resumed "
          f"it in {job_wall(doc4):.3f} s (resumed True, {k1_first} + "
          f"{log.k1(j4)} K1 launches), peaks.csv j0002's bytes", flush=True)

    # (d) the clients.
    fk.reset_launches()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cfg = p7["conf"]["ranges"][0]["ffa_search"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "riptide_tpu_torch.apps.rseek", "-f",
         "presto", "--Pmin", str(cfg["period_min"]), "--Pmax",
         str(cfg["period_max"]), "--bmin", str(cfg["bins_min"]), "--bmax",
         str(cfg["bins_max"]), "--smin", str(SERVE_RSEEK_SMIN), "--submit",
         base, files[0]],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"(d) rseek --submit exited "
          f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    head = proc.stdout.splitlines()[0]
    j5 = head.split()[2]
    doc5 = d.get(j5)[1]
    want5, direct = direct_csv(dev, doc5["spec"], os.path.join(
        p7["root"], "direct_rseek.csv"))
    check(doc5["status"] == "done" and doc5["npeaks"] == len(direct)
          and read_bytes(doc5) == want5,
          f"(d) rseek --submit: {head}; a direct run gives {len(direct)} "
          "peaks")
    if cuda:
        check(log.k1(j5) > 0, f"(d) {j5}: no K1 launch in its turns")
    serve_k1 += log.k1(j5)
    print(f"  (d) rseek --submit (CUDA_VISIBLE_DEVICES empty) exit 0 in "
          f"{time.perf_counter() - t0:.2f} s: {head}; a direct run gives "
          f"{len(direct)} peaks, the same peaks.csv bytes", flush=True)
    for app, args in (("rreport", [root]), ("rtop", [root, "--once"])):
        rc, out, err = run_app(app, args)
        check(rc == 0 and "service jobs:" in out and all(
            j in out for j in ("j0001", "j0002", j3, j4, j5)),
            f"(d) {app} on the serve root exited {rc}:\n{out}\n"
            f"{err[-2000:]}")
        print(f"  (d) {app} by path on the serve root: exit 0, "
              f"{len(out.strip().splitlines())} lines", flush=True)
    print("\n".join("      " + line
                    for line in out.strip().splitlines()), flush=True)
    d.stop()
    print(f"  phase 10 card: {card}; K1 launches in served turns "
          f"{serve_k1}", flush=True)
    return serve_k1


# Phase 6: P1's gathering patterns (the tool's names), and the grids
# (blocks, threads) of the empty kernel timed as the launch floor: one
# block, and the grid of an element kernel at (2048, 384).
P1_GATHERING = ("roll lanes", "roll rows", "select", "dynroll",
                "stride_roll")
# Phase 11: the multi-GPU paths on one card. (a) the sharded survey on
# phase 5's batch over these meshes (name, dm shards, bins shards, trials):
# the cards present, four virtual shards, 30 trials over four (padded),
# and a 2-D mesh whose bins axis must divide the plan's 21 padded bins
# trials; (b) ffa2_seq of a SEQ_SHAPE container over SEQ_SHARDS shards;
# (c, d) two processes on the card over gloo, each searching half of the
# batch, the survivor's bounded gather PEER_TIMEOUT_S.
SHARDED_RUNS = (("default_mesh", None, 1, 32), ("4 virtual shards", 4, 1, 32),
                ("30 trials over 4 shards", 4, 1, 30))
BINS_MESH = (2, 3)
SEQ_SHAPE = (32768, 256)
SEQ_SHARDS = (2, 8)
PEER_TIMEOUT_S = 5.0
PEER_MAX_AGE_S = 1.0

# The worker of phases 11c and 11d: ``python worker.py REPO PID PORT JDIR
# MODE CFG DEVICE``; MODE ``search`` (both processes gather) or
# ``peerloss`` (process 0 wedges before the gather, process 1 survives
# it); CFG the headline configuration as JSON; DEVICE ``cuda`` for this
# process's card (``local_device``), else the device named.
MULTI_WORKER = r'''
import json, os, sys, time
repo, pid, port, jdir, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4], sys.argv[5]
cfg, device = json.loads(sys.argv[6]), sys.argv[7]
sys.path.insert(0, repo)
import numpy as np
import torch
import chip_smoke as cs
from riptide_tpu_torch.ops import ffa_kernel as fk
from riptide_tpu_torch.parallel import run_search_multihost
from riptide_tpu_torch.parallel import multihost as mh
from riptide_tpu_torch.parallel.distributed import (init_distributed,
                                                    local_device)
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.survey import incidents
from riptide_tpu_torch.survey.journal import SurveyJournal
from riptide_tpu_torch.survey.liveness import PeerLivenessMonitor
from riptide_tpu_torch.survey.metrics import get_metrics

assert init_distributed(f"localhost:{port}", num_processes=2,
                        process_id=pid, initialization_timeout=120) == 2
plan = cs.headline_plan(cfg)
batch = cs.survey_batch(plan, 32, cfg=cfg)
half = 16
# Process 1 holds the pulsar series (trials 0-15), process 0 trials 16-31.
mine = batch[half:] if pid == 0 else batch[:half]
tobs = cfg["nsamp"] * cfg["tsamp"]
journal = SurveyJournal(jdir)
incidents.set_sink(journal.record_incident)
dev = local_device() if device == "cuda" else torch.device(device)
if dev.type == "cuda":
    fk._LIB.load()
out = {"pid": pid, "device": str(dev)}
if mode == "search":
    if pid == 0:
        journal.write_header("phase11c", 1)
    fk.reset_launches()
    t0 = time.perf_counter()
    peaks, _ = run_search_multihost(plan, mine, tobs, dms_local=np.zeros(half),
                                    journal=journal, gather_timeout_s=120,
                                    device=dev)
    out.update(wall=time.perf_counter() - t0, launches=dict(fk.LAUNCHES),
               want=engine.queued_launches(plan),
               peaks=[list(p) for p in peaks])
    print("RESULT " + json.dumps(out), flush=True)
    sys.exit(0)
monitor = PeerLivenessMonitor(journal, process_index=pid, process_count=2,
                              max_age_s=cs.PEER_MAX_AGE_S)
if pid == 0:
    # The lost process: one heartbeat, then wedged before the gather
    # (never searches, never beats again) until it is killed.
    monitor.beat()
    print("RESULT " + json.dumps(out), flush=True)
    time.sleep(600)
    os._exit(3)
monitor.start_beating(interval_s=cs.PEER_MAX_AGE_S / 10)
time.sleep(1.5 * cs.PEER_MAX_AGE_S)
journal.write_header("phase11d", 2)
t0 = time.perf_counter()
fk.reset_launches()
peaks, _ = run_search_multihost(plan, mine, tobs, dms_local=np.zeros(half),
                                journal=journal, chunk_id=1,
                                gather_timeout_s=cs.PEER_TIMEOUT_S,
                                monitor=monitor, device=dev)
t_loss = time.perf_counter() - t0
assert mh.is_degraded() and monitor.lost() == [0], monitor.lost()
assert monitor.journal_writer() == 1
lost = monitor.unfinished_chunks(2)
for cid in lost:
    run_search_multihost(plan, batch[half:], tobs, dms_local=np.zeros(half),
                         journal=journal, chunk_id=cid, monitor=monitor,
                         device=dev)
out.update(wall=time.perf_counter() - t0, degraded_s=t_loss, lost=lost,
           launches=dict(fk.LAUNCHES), want=engine.queued_launches(plan),
           peer_losses=get_metrics().counter("peer_losses"),
           done=sorted(journal.completed_chunks()))
print("RESULT " + json.dumps(out), flush=True)
os._exit(0)
'''


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_workers(tmp, jdir, mode, cfg, dev):
    """Start the two processes of phase 11c or 11d (fresh interpreters,
    ``MULTI_WORKER`` written under ``tmp``) at the configuration ``cfg``
    on ``dev`` (on a card, each process's ``local_device``)."""
    script = os.path.join(tmp, "multi_worker.py")
    with open(script, "w") as fobj:
        fobj.write(MULTI_WORKER)
    repo = os.path.dirname(os.path.abspath(__file__))
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, script, repo, str(pid), port,
                              jdir, mode, json.dumps(cfg), dev.type],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]


def worker_result(proc, timeout=300):
    """Wait for a worker; its RESULT line as a dict (raises on a failed
    worker, with the end of its output)."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise RuntimeError(f"worker timed out:\n{out[-3000:]}")
    lines = [x for x in out.splitlines() if x.startswith("RESULT ")]
    check(proc.returncode == 0 and lines,
          f"worker exited {proc.returncode}:\n{out[-3000:]}")
    return json.loads(lines[-1][7:])


def _peak_key(peaks):
    return [(p.period, p.width, p.dm) for p in peaks]


def phase_sharded(dev, plan, p5, cfg=HEADLINE):
    """Phase 11a: ``run_search_sharded`` of phase 5's batch on each mesh
    of ``SHARDED_RUNS`` and ``run_periodogram_sharded`` on the 2-D mesh
    ``BINS_MESH``, each timed (wall, peak device memory, launch counts
    set to 0 just before and read just after) after a warm-up run, then
    run a third time, recorded. Every K2 launch of that run is held
    against ``cascade_stage_plain``; the peaks must be phase 5's
    (period, width, DM; S/N within the bar, the largest difference
    printed), series 0 the pulsar, the 2-D cube phase 5's S/N.
    Returns (K2 launches over the phase, its largest difference from
    plain, (device ms, plain ms, bound ms, bound by) over the default
    mesh's launches)."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.parallel import (Mesh, default_mesh, mesh_2d,
                                            run_periodogram_sharded,
                                            run_search_sharded)
    from riptide_tpu_torch.search import engine

    tobs = cfg["nsamp"] * cfg["tsamp"]
    S = len(plan.stages)
    B = len(plan.stages[0].ps_padded)
    check(B == cfg["bins_max"] - cfg["bins_min"] + 1 and B % BINS_MESH[1] == 0,
          f"padded bins trials {B}: the 2-D mesh's bins axis "
          f"{BINS_MESH[1]} must divide it")
    total, err, timing = 0, 0.0, None
    runs = [(name, default_mesh() if n is None else Mesh([dev] * n), D)
            for name, n, _, D in SHARDED_RUNS]
    runs.append((f"2-D mesh {BINS_MESH[0]} dm x {BINS_MESH[1]} bins",
                 mesh_2d([dev] * (BINS_MESH[0] * BINS_MESH[1]),
                         bins_shards=BINS_MESH[1]), 32))
    for k, (name, mesh, D) in enumerate(runs):
        batch = p5["batch"][:D]
        two_d = "bins" in mesh.axis_names
        shards = mesh.size

        def run():
            if two_d:
                return run_periodogram_sharded(plan, batch, mesh=mesh)[2]
            return run_search_sharded(plan, batch, tobs, dms=np.zeros(D),
                                      mesh=mesh)[0]

        run()
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        fk.reset_launches()
        t0 = time.perf_counter()
        got = run()
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        # A third run, recorded (each K2 input kept as a copy), for the
        # plain versions' operands.
        with engine.recording() as rec:
            run()
        k2 = [r for r in rec["launches"] if r["kind"] == "cascade_stage"]
        per = {}
        for r in k2:
            per[r["shard"]] = per.get(r["shard"], 0) + 1
        check(launches == {"fused_stage": 0, "cascade_stage": S * shards,
                           "paired_stage": 0} and len(k2) == S * shards
              and set(per.values()) == {S},
              f"{name}: launches {launches}, per shard {per}: want one K2 "
              f"per stage ({S}) per shard ({shards}) and nothing else")
        total += launches["cascade_stage"]
        err = max(err, compare_stages(
            f"K2 cascade_stage on the sharded path, {name}",
            [r["out"] for r in k2], plain_launches(rec, "cascade_stage")))
        print(f"  {name}: {shards} shard(s), K2 {S} launches per shard "
              f"({launches['cascade_stage']} in all); {wall:.3f} s wall, "
              f"{D / wall:.3f} DM-trials/s, peak device memory "
              f"{peak / 2 ** 30:.3f} GiB (phase 5: {p5['wall']:.3f} s, "
              f"{32 / p5['wall']:.3f} DM-trials/s, {p5['peak'] / 2 ** 30:.3f} "
              "GiB)", flush=True)
        if two_d:
            want = p5["snr"].cpu().numpy()
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"{name}: S/N cube {got.shape}")
            d = np.abs(got - want)
            check(bool((d <= ATOL + RTOL * np.abs(want)).all()),
                  f"{name}: S/N differs from phase 5 (max {d.max():.3e})")
            print(f"  {name}: S/N cube against phase 5's: max |diff| "
                  f"{d.max():.3e}, bitwise equal {np.array_equal(got, want)}",
                  flush=True)
            continue
        want = p5["peaks"][:D]
        check(len(got) == D and [_peak_key(g) for g in got]
              == [_peak_key(w) for w in want],
              f"{name}: peaks (period, width, DM) differ from phase 5")
        gs = np.array([p.snr for g in got for p in g])
        ws = np.array([p.snr for w in want for p in w])
        d = np.abs(gs - ws)
        check(bool((d <= ATOL + RTOL * np.abs(ws)).all()),
              f"{name}: peak S/N differs from phase 5 (max {d.max():.3e})")
        best = got[0][0]
        check(abs(best.freq - 1.0 / PULSAR["period"]) < 1.0 / tobs,
              f"{name}: series 0 lost the pulsar")
        print(f"  {name}: {len(gs)} peaks, phase 5's (period, width, DM); "
              f"S/N max |diff| {d.max():.3e}, same bits {np.array_equal(gs, ws)}"
              f"; series 0: S/N {best.snr:.3f} at P = {best.period:.6f} s",
              flush=True)
        if k == 0:
            timing = k2_timing(dev, plan, rec, k2)
            # Phase 13's sync witness repeats this run.
            p5["sharded_peaks"] = got
        del rec, k2
    return total, err, timing


def k2_timing(dev, plan, rec, k2):
    """Device time of one pass of K2 over a sharded run's launches, from
    CUDA graph replays (and through the wrappers), beside its plain
    version and its bound."""
    from riptide_tpu_torch.ops import ffa_kernel as fk

    args = [r["args"] for r in k2]
    scratch = [(a[0].clone(),) + tuple(a[1:]) for a in args]

    def calls():
        return [fk.cascade_stage(*a) for a in scratch]

    ms = measure.graph_ms(calls, dev, REPS)
    wms = measure.median_ms(calls, dev, REPS)
    pms = measure.median_ms(
        lambda: [fk.cascade_stage_plain(*a) for a in args], dev, reps=5)
    b = measure.bound_ms(*k2_work(k2, plan, [a[0] for a in args]))
    print(f"  K2 over the default mesh's {len(k2)} sharded launches, D = "
          f"{args[0][0].shape[0]}: {ms:.4f} ms device, from CUDA graph "
          f"replays ({wms:.4f} ms through the wrappers; plain {pms:.4f} ms, "
          f"bound {b[0]:.4f} ms by {b[1]})", flush=True)
    return ms, pms, *b


def phase_seq(dev):
    """Phase 11b: ffa2_seq of a SEQ_SHAPE float32 container on
    ``SEQ_SHARDS`` virtual shards of the card (all-gather and windowed
    exchanges): the same bits as ``ffa2`` on the card. Each wall is a
    second call's."""
    from riptide_tpu_torch.ops.ffa import ffa2
    from riptide_tpu_torch.parallel import ffa2_seq, seq_mesh
    from riptide_tpu_torch.parallel.seqffa import _window_plan

    data = np.random.default_rng(11).standard_normal(SEQ_SHAPE,
                                                     dtype=np.float32)
    ffa2(data, device=dev)
    t0 = time.perf_counter()
    want = ffa2(data, device=dev)
    print(f"  ffa2 on {dev}: {time.perf_counter() - t0:.3f} s", flush=True)
    for S in SEQ_SHARDS:
        form = ("windowed" if S >= 8 and _window_plan(SEQ_SHAPE[0], S)
                is not None else "all-gather")
        mesh = seq_mesh([dev] * S)
        ffa2_seq(data, mesh=mesh)
        t0 = time.perf_counter()
        got = ffa2_seq(data, mesh=mesh)
        wall = time.perf_counter() - t0
        check(np.array_equal(got, want) and np.array_equal(
            np.signbit(got), np.signbit(want)),
            f"ffa2_seq over {S} shards is not ffa2's bits")
        print(f"  ffa2_seq {SEQ_SHAPE} over {S} shards ({form}): "
              f"{wall:.3f} s, ffa2's bits", flush=True)


def phase_processes(dev, tmp, p5, cfg=HEADLINE):
    """Phases 11c-d: two fresh processes on the card over gloo. (c) each
    searches half of phase 5's batch through ``run_search_multihost``:
    both print the same gathered list, phase 5's peaks in process
    order sorted by S/N (the same bits), process 0 journals it, K1 runs
    ``queued_launches(plan)`` times in each. (d) process 0 wedges before
    the gather; process 1's bounded gather times out, it degrades, takes
    the writer role and journals both chunks (``peer_losses`` 1, one
    ``peer_loss`` incident); then process 0 is killed. Returns K1's
    launches over both processes of (c)."""
    from riptide_tpu_torch.peak_detection import Peak
    from riptide_tpu_torch.survey.journal import SurveyJournal

    jdir = os.path.join(tmp, "multi_journal")
    t0 = time.perf_counter()
    procs = start_workers(tmp, jdir, "search", cfg, dev)
    res = [worker_result(p) for p in procs]
    wall = time.perf_counter() - t0
    half = [p5["peaks"][16:], p5["peaks"][:16]]  # process 0, process 1
    want = sorted([p for h in half for t in h for p in t],
                  key=lambda p: p.snr, reverse=True)
    for r in res:
        got = [Peak(*row) for row in r["peaks"]]
        check(got == want, f"process {r['pid']}: the gathered peaks are not "
              "phase 5's sorted by S/N")
    done = SurveyJournal(jdir).completed_chunks()
    check(list(done) == [0] and done[0][1] == want,
          "process 0 did not journal the gathered chunk")
    k1 = 0
    for r in res:
        check(r["device"] == f"{dev.type}:0" or r["device"] == str(dev),
              f"process {r['pid']} on {r['device']}")
        check(r["launches"]["fused_stage"] == r["want"]["fused_stage"]
              and r["launches"]["cascade_stage"] == 0,
              f"process {r['pid']}: launches {r['launches']}, want "
              f"{r['want']}")
        k1 += r["launches"]["fused_stage"]
    print(f"  two processes on {res[0]['device']} (gloo): both gathered "
          f"{len(want)} "
          f"peaks, phase 5's bits; searches {res[0]['wall']:.3f} / "
          f"{res[1]['wall']:.3f} s in fresh processes, {wall:.1f} s wall "
          f"with start-up; K1 {res[0]['launches']['fused_stage']} + "
          f"{res[1]['launches']['fused_stage']}", flush=True)

    jdir = os.path.join(tmp, "peer_journal")
    t0 = time.perf_counter()
    procs = start_workers(tmp, jdir, "peerloss", cfg, dev)
    try:
        surv = worker_result(procs[1])
        wall = time.perf_counter() - t0
        check(procs[0].poll() is None, "the wedged process 0 exited early")
    finally:
        procs[0].kill()
        procs[0].communicate()
    journal = SurveyJournal(jdir)
    kinds = [r.get("incident") for r in journal.incidents()]
    check(surv["done"] == [0, 1] and sorted(journal.completed_chunks())
          == [0, 1] and surv["peer_losses"] == 1
          and kinds.count("peer_loss") == 1 and surv["lost"] == [0],
          f"peer loss: chunks {surv['done']}, peer_losses "
          f"{surv['peer_losses']}, incidents {kinds}")
    check(surv["launches"]["fused_stage"] == 2 * surv["want"]["fused_stage"],
          f"survivor launches {surv['launches']}")
    check(surv["degraded_s"] >= PEER_TIMEOUT_S,
          "the survivor's gather did not wait out its timeout")
    print(f"  peer loss: the survivor degraded after its {PEER_TIMEOUT_S} s "
          f"bounded gather ({surv['degraded_s']:.3f} s for chunk 1), "
          f"journaled chunks {surv['done']} as writer in {surv['wall']:.3f} "
          f"s ({wall:.1f} s with start-up); peer_losses 1, one peer_loss "
          "incident; process 0 killed", flush=True)
    return k1


def phase_multi(dev, plan, p5, tmp, cfg=HEADLINE):
    """Phase 11: the multi-GPU paths on the card (a)-(d). Returns K2's
    launches on the sharded path, its largest difference from plain and
    its times there, and K1's launches in phase 11c's two processes."""
    out = phase_sharded(dev, plan, p5, cfg)
    phase_seq(dev)
    return (*out, phase_processes(dev, tmp, p5, cfg))


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


HBM_MARGIN = 0.5       # |ratio - 1| of the hbm_drift alert rule
SEEDED_SLICE = 8       # phase 12 (c): the budget's batch


@contextlib.contextmanager
def card_calls():
    """The card's kernel library calls of the block, as (name, args)
    with ``rt_`` stripped (the shape-only library's record on the meta
    device), through a proxy of the built library: the pointers the
    launches really received."""
    from riptide_tpu_torch.ops import ffa_kernel as fk

    real = fk._library
    calls = []

    class Proxy:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            fn = getattr(self._lib, name)
            if not name.startswith("rt_"):
                return fn

            def call(*args):
                calls.append((name[3:], args))
                return fn(*args)
            return call

    fk._library = lambda: Proxy(real())
    try:
        yield calls
    finally:
        fk._library = real


def _nonzero(d):
    return {k: int(v) for k, v in sorted(d.items()) if v}


def counted_search(dev, plan, batch, mode="uint6"):
    """One survey search of ``batch`` on the card with the launch counts
    set to 0 just before and read just after, and its library calls."""
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.search import engine

    prepared = engine.prepare_stage_data(plan, batch, mode=mode)
    tobs = plan.size * plan.tsamp
    fk.reset_launches()
    with card_calls() as calls:
        engine.run_search_batch(plan, None, tobs, prepared=prepared,
                                device=dev)
    return _nonzero(fk.LAUNCHES), _nonzero(fk.KERNEL_LAUNCHES), calls


def operand_bytes(plan, dev):
    """Bytes of the stage operands cached on ``plan`` for ``dev``."""
    from riptide_tpu_torch.search import engine

    key = engine._device_key(dev)
    total = 0
    for st in plan.stages:
        for k, ops in (getattr(st, "_device_operands", None) or {}).items():
            if k[0] != key:
                continue
            for part in ops:
                for t in part:
                    if isinstance(t, torch.Tensor):
                        total += t.nbytes
    return total


def measured_search(dev, plan, fn):
    """Peak device bytes of ``fn()`` above what was allocated before it,
    with the plan's stage operands uploaded anew (as the model counts
    them), and the caching allocator's reserved peak."""
    from riptide_tpu_torch.search import engine

    engine.drop_device_operands(plan, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return (out, torch.cuda.max_memory_allocated(dev) - base,
            torch.cuda.max_memory_reserved(dev), wall)


def _ratio_line(name, predicted, measured, reserved=None):
    ratio = measured / predicted
    extra = (f", reserved {reserved / 2 ** 30:.4f} GiB" if reserved
             is not None else "")
    print(f"  (b) {name}: predicted {predicted} B ({predicted / 2 ** 30:.4f}"
          f" GiB), measured {measured} B ({measured / 2 ** 30:.4f} GiB), "
          f"ratio {ratio:.4f}{extra}", flush=True)
    check(abs(ratio - 1.0) <= HBM_MARGIN,
          f"{name}: the model's ratio {ratio:.4f} is outside 1 +- "
          f"{HBM_MARGIN}")
    return ratio


def phase_prove(dev, plan, p4, p5, p7, cfg=HEADLINE):
    """Phase 12: the launch contracts and the peak-memory model on the
    card. (a) for each fast contract plan, and for the headline plan at
    D = 1, one real search's LAUNCHES and KERNEL_LAUNCHES equal what the
    CPU walk extracted (the pinned contract), and the pointers its
    launches received honour every declared reuse; then ``apps.rprove``
    runs here and exits 0. (b) the model against the allocator: at
    D = 1 and 3 on the headline plan (max_memory_allocated above what
    was allocated before, the stage operands uploaded anew), and at
    D = 32 from phase 4's (periodogram path: the walk without the peak
    program) and phase 5's peaks. (c) the D = 32 survey batch under
    RIPTIDE_HBM_BUDGET = predict(8): four slices, oom_predicted 1, no
    bisection, the unbudgeted peaks, a lower measured peak. (d) a
    journaled pipeline run at phase 8's shape under that budget: hbm
    blocks in the chunk records (actual and ratio only where the mark
    rose), rreport's hbm line, rwatch quiet. Returns the readings."""
    import types

    from riptide_tpu_torch.analysis import launch_contract as lc
    from riptide_tpu_torch.ops.plan import contract_plan_params
    from riptide_tpu_torch.pipeline.batcher import BatchSearcher
    from riptide_tpu_torch.search import engine
    from riptide_tpu_torch.survey.metrics import get_metrics

    out = {}
    tobs = cfg["nsamp"] * cfg["tsamp"]
    pinned = lc.load_contracts()
    check(pinned is not None, "no pinned launch contracts")
    dropped = {k: os.environ.pop(k) for k in lc.CONTRACT_FLAGS
               if k in os.environ}
    try:
        # (a) the contracts, counted on the card.
        for spec in contract_plan_params():
            cplan = lc.build_contract_plan(spec)
            pin = pinned["plans"][spec["name"]]
            got, kern, calls = counted_search(
                dev, cplan, noise_batch(cplan, lc.PROBE_D, 5), spec["wire"])
            reuse = lc.reuse_report(calls)
            declared = sum(len(r["declared"]) for r in reuse)
            lost = sum(len(r["dropped"]) for r in reuse)
            print(f"  (a) {spec['name']} at D = {lc.PROBE_D}: launches {got},"
                  f" kernels {kern}; pinned {pin['dispatch_total']}, "
                  f"{pin['kernel_total']}; reuses declared {declared}, "
                  f"dropped {lost}", flush=True)
            check(got == pin["dispatch_total"] and kern == pin["kernel_total"],
                  f"{spec['name']}: the card's launches differ from the "
                  "pinned contract")
            check(lost == 0 and declared == pin["reuse"]["declared"],
                  f"{spec['name']}: reuses {reuse}")
        walk = engine.walk_search(plan, 1)
        got, kern, calls = counted_search(dev, plan, noise_batch(plan, 1, 6))
        reuse = lc.reuse_report(calls)
        declared = sum(len(r["declared"]) for r in reuse)
        lost = sum(len(r["dropped"]) for r in reuse)
        wreuse = lc.reuse_report([c for ln in walk["launches"]
                                  for c in ln["calls"]])
        print(f"  (a) headline at D = 1: launches {got}, kernels {kern}; the "
              f"walk's {_nonzero(walk['launch_counts'])}, "
              f"{_nonzero(walk['kernel_counts'])}; reuses declared "
              f"{declared} (walk {sum(len(r['declared']) for r in wreuse)}),"
              f" dropped {lost}", flush=True)
        check(got == _nonzero(walk["launch_counts"])
              and kern == _nonzero(walk["kernel_counts"]),
              "headline: the card's launches differ from the walk's")
        check(lost == 0 and declared == sum(len(r["declared"])
                                            for r in wreuse) > 0,
              f"headline: reuses {declared} declared, {lost} dropped")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "riptide_tpu_torch.apps.rprove"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        print(f"  (a) python -m riptide_tpu_torch.apps.rprove: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; "
              f"{proc.stderr.strip().splitlines()[-1:]}", flush=True)
        check(proc.returncode == 0, f"rprove exited {proc.returncode}:\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")

        # (b) the model against the allocator.
        model = lc.hbm_model(plan)
        out["model"] = model.to_dict()
        print(f"  (b) headline model: {model.to_dict()}", flush=True)
        for D in (1, 3):
            prepared = engine.prepare_stage_data(plan, noise_batch(plan, D, 7))
            _, meas, res, _ = measured_search(
                dev, plan, lambda: engine.run_search_batch(
                    plan, None, tobs, prepared=prepared, device=dev))
            out[f"D{D}"] = dict(predicted=model.predict(D), measured=meas,
                                reserved=res, ratio=_ratio_line(
                                    f"D = {D} survey search",
                                    model.predict(D), meas, res))
        ops = operand_bytes(plan, dev)
        want4 = engine.walk_search(plan, 32, survey=False)["peak_bytes"]
        meas4 = p4["peak"] - p4["base"] + ops
        meas5 = p5["peak"] - p5["base"] + ops
        print(f"  (b) D = 32: phases 4 and 5 (a) measured above "
              f"{p4['base']} / {p5['base']} B allocated at their reset, "
              f"plus the {ops} B of stage operands cached then", flush=True)
        out["D32"] = dict(
            periodogram=dict(predicted=want4, measured=meas4, ratio=_ratio_line(
                "D = 32 periodogram batch (phase 4; the walk without the "
                "peak program)", want4, meas4)),
            survey=dict(predicted=model.predict(32), measured=meas5,
                        ratio=_ratio_line("D = 32 survey batch (phase 5)",
                                          model.predict(32), meas5)))

        # (c) a seeded split of the D = 32 survey batch.
        budget = model.predict(SEEDED_SLICE)
        check(model.max_batch(budget) == SEEDED_SLICE,
              f"max_batch({budget}) = {model.max_batch(budget)}")
        batch = p5["batch"]
        D = batch.shape[0]
        conf = {"name": "headline", "ffa_search": {}, "find_peaks": {}}
        members = [types.SimpleNamespace(metadata={"dm": float(i)},
                                         tsamp=cfg["tsamp"])
                   for i in range(D)]
        runs = {}
        for name, flags in (("unbudgeted", {}),
                            ("budgeted", {"RIPTIDE_HBM_BUDGET": str(budget)})):
            searcher = BatchSearcher({"rmed_width": 4.0, "rmed_minpts": 101},
                                     [conf], device=dev)
            slices = []
            inner = searcher._search_slice

            def counting(*a, inner=inner, slices=slices):
                slices.append(a[-1] - a[-2])
                return inner(*a)

            searcher._search_slice = counting
            get_metrics().reset()
            with env_flags(flags):
                peaks, meas, res, wall = measured_search(
                    dev, plan, lambda: searcher._queue_range(
                        conf, members, batch, plan, None)())
            m = get_metrics()
            runs[name] = dict(peaks=peaks, peak=meas, reserved=res, wall=wall,
                              slices=slices,
                              oom_predicted=m.counter("oom_predicted"),
                              oom_bisections=m.counter("oom_bisections"))
            print(f"  (c) {name}: {len(slices)} slice(s) {slices}, "
                  f"oom_predicted {runs[name]['oom_predicted']}, "
                  f"oom_bisections {runs[name]['oom_bisections']}, peak "
                  f"{meas / 2 ** 30:.4f} GiB (reserved {res / 2 ** 30:.4f} "
                  f"GiB), {wall:.3f} s wall with the host prep, "
                  f"{len(peaks)} peaks", flush=True)
        u, b = runs["unbudgeted"], runs["budgeted"]
        check(b["slices"] == [SEEDED_SLICE] * (D // SEEDED_SLICE)
              and b["oom_predicted"] == 1 and b["oom_bisections"] == 0
              and u["oom_predicted"] == 0 and not u["slices"],
              f"seeded split: {b['slices']}, oom_predicted "
              f"{b['oom_predicted']}, oom_bisections {b['oom_bisections']}")
        check(b["peaks"] == u["peaks"],
              "the seeded split's peaks differ from the unbudgeted batch's")
        check(b["peak"] < u["peak"], "the seeded split's measured peak is "
              "not below the unbudgeted run's")
        out["seeded"] = {k: {f: v[f] for f in ("peak", "reserved", "wall",
                                                "slices")}
                         for k, v in runs.items()}

        # (d) a journaled pipeline run under that budget.
        torch.cuda.reset_peak_memory_stats(dev)
        r = journaled_run(dev, p7, "hbm",
                          flags={"RIPTIDE_HBM_BUDGET": str(budget)})
        check(r["products"] == p7["products"],
              "the budgeted journaled run's products differ from phase 7's")
        recs = [rec for _, (rec, _) in sorted(
            r["journal"].completed_chunks().items())]
        blocks = [rec.get("hbm") or {} for rec in recs]
        marks = [h["actual_bytes"] for h in blocks if "actual_bytes" in h]
        for cid, h in enumerate(blocks):
            print(f"  (d) chunk {cid}: hbm {h}", flush=True)
        check(len(blocks) == p7["nchunks"] and all(
            h.get("predicted_bytes", 0) > 0 and h.get("budget_bytes") == budget
            and ("actual_bytes" in h) == ("ratio" in h) for h in blocks)
            and marks and marks == sorted(set(marks)),
            "the chunk records' hbm blocks")
        check(r["metrics"].get("oom_predicted", 0) == p7["nchunks"]
              and not r["metrics"].get("oom_bisections"),
              f"journaled run: oom_predicted "
              f"{r['metrics'].get('oom_predicted')}, oom_bisections "
              f"{r['metrics'].get('oom_bisections')}")
        rc, text, err = run_app("rreport", [r["jdir"]])
        line = [ln for ln in text.splitlines() if "hbm model:" in ln]
        check(rc == 0 and line and "actual/predicted median" in line[0],
              f"rreport: exit {rc}, hbm line {line}\n{err[-2000:]}")
        print(f"  (d) rreport: {line[0].strip()}", flush=True)
        rc, text, err = run_app("rwatch", [r["jdir"], "--once"])
        check(rc == 0 and "hbm_drift" not in text,
              f"rwatch: exit {rc}\n{text[-2000:]}\n{err[-2000:]}")
        print(f"  (d) rwatch --once: exit 0, hbm_drift quiet; "
              f"{text.strip().splitlines()[-1].strip()}", flush=True)
        ratios = sorted(h["ratio"] for h in blocks if "ratio" in h)
        out["pipeline"] = dict(ratios=ratios, wall=r["wall"], blocks=blocks)
    finally:
        os.environ.update(dropped)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the static rules against the card
# ---------------------------------------------------------------------------

SYNC_WARNING = "synchronizing CUDA operation"
SYNC_RULES = ("RIP001", "RIP011")


def cube_digest(t):
    """sha256 of a tensor's bytes on the host."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def phase_lint():
    """Phase 13 (a): the port's riplint, by path, in a subprocess."""
    import re

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.join("riptide_tpu_torch", "apps",
                                      "riplint.py"), "--no-cache"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    tail = (out.stdout + out.stderr).strip()
    check(out.returncode == 0, f"riplint exited {out.returncode}:\n{tail}")
    m = re.search(r"riplint OK: (\d+) analyzers over (\d+) modules, 0 new "
                  r"findings \((\d+) baselined\)", out.stderr)
    check(m is not None, f"riplint's summary line is missing:\n{tail}")
    print(f"  riplint: {m.group(1)} analyzers over {m.group(2)} modules, 0 "
          f"new findings, {m.group(3)} baselined; {secs:.2f} s wall, exit 0",
          flush=True)


class SyncWitness:
    """``torch.cuda.set_sync_debug_mode("warn")`` for the block, every
    warning shown: the Python stack of each sync the card reports is kept
    in ``stacks`` (other warnings go to the usual handler). The mode is
    reset on the way out, whatever happens."""

    def __init__(self):
        self.stacks = []

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        import traceback

        if SYNC_WARNING in str(message):
            self.stacks.append(traceback.extract_stack())
        else:
            self._show(message, category, filename, lineno, file, line)

    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        try:
            torch.cuda.set_sync_debug_mode("default")
        finally:
            self._catch.__exit__(*exc)
        return False


class SyncScope:
    """The rules' view of the port for the witness: RIP001's hot set,
    the functions RIP011 reaches from its roots, the baseline and the
    pragmas, from the lint package loaded by path."""

    def __init__(self, repo):
        import re

        from riptide_tpu_torch.apps import riplint as rl

        lint = rl.load_lint()
        hs = sys.modules[f"{lint.__name__}.host_sync"]
        ih = sys.modules[f"{lint.__name__}.interp_host_sync"]
        core = sys.modules[f"{lint.__name__}.core"]
        self.repo = repo
        self.contexts = {c.relpath: c for c in lint.collect_contexts(repo)}
        project = lint.ProjectContext(repo, list(self.contexts.values()))
        self.hot = {f"{rel}::{q}" for rel, qs in hs.HOT_FUNCTIONS.items()
                    for q in qs}
        self.reached = set(ih._reachable(project, ih.ROOTS))
        self.baseline = [e for e in lint.Baseline.load(
            rl.DEFAULT_BASELINE).entries if e["rule"] in SYNC_RULES]
        self.near = core.BASELINE_NEARBY_LINES
        self.pragma = re.compile(r"#\s*riplint:\s*disable=([A-Za-z0-9_,\s]*)")
        self.spans = {rel: sorted(
            ((fn.lineno, fn.end_lineno, q) for q, fn in
             core.walk_functions(c.tree)), key=lambda x: -x[0])
            for rel, c in self.contexts.items()}

    def site(self, stack):
        """(relpath, line, function qual) of the innermost frame of the
        port in ``stack``, or None."""
        pkg = os.path.join(self.repo, "riptide_tpu_torch") + os.sep
        for fr in reversed(stack):
            path = os.path.abspath(fr.filename)
            if path.startswith(pkg):
                rel = os.path.relpath(path, self.repo).replace(os.sep, "/")
                qual = next((q for a, b, q in self.spans.get(rel, ())
                             if a <= fr.lineno <= b), "<module>")
                return rel, fr.lineno, qual
        return None

    def scope(self, rel, qual):
        fqn = f"{rel}::{qual}"
        return ("RIP001 hot" if fqn in self.hot else
                "RIP011 reached" if fqn in self.reached else "")

    def covered(self, rel, line):
        """"baseline" or "pragma" when the line is covered, else ""."""
        ctx = self.contexts[rel]
        text = ctx.line_text(line).strip()
        m = self.pragma.search(ctx.line_text(line))
        if m and ({r.strip() for r in m.group(1).split(",")}
                  & (set(SYNC_RULES) | {"all"})):
            return "pragma"
        for e in self.baseline:
            if e["path"] != rel:
                continue
            et = e["line_text"].strip()
            if et == text or (et and text and (et in text or text in et)
                              and any(ctx.line_text(n).strip() == et
                                      for n in range(line - self.near,
                                                     line + self.near + 1))):
                return "baseline"
        return ""


def phase_witness(dev, plan, p2, p5, cfg=HEADLINE):
    """Phase 13 (b): phases 2, 5k (example_long's survey batch, K1 and
    K3) and 11a's default-mesh run again under the sync debug mode; every
    sync inside the rules' scope must be covered. Returns the K1, K2 and
    K3 launches of the phase."""
    from riptide_tpu_torch import ffa_search
    from riptide_tpu_torch.ops import ffa_kernel as fk
    from riptide_tpu_torch.parallel import default_mesh, run_search_sharded
    from riptide_tpu_torch.search import engine

    scope = SyncScope(os.path.dirname(os.path.abspath(__file__)))
    tobs = cfg["nsamp"] * cfg["tsamp"]
    batch, k3 = p5["batch"], p5["k3"]
    D = batch.shape[0]
    counts = dict.fromkeys(fk.LAUNCHES, 0)
    runs = []
    check(engine._RECORD is None, "phase 13 must run outside a recording")
    with SyncWitness() as w:
        n0 = len(w.stacks)
        fk.reset_launches()
        _, pgram = ffa_search(p2["ts"], **p2["kw"])
        torch.cuda.synchronize(dev)
        launches = dict(fk.LAUNCHES)
        runs.append(("phase 2 ffa_search", launches, len(w.stacks) - n0))
        n0 = len(w.stacks)
        fk.reset_launches()
        handle = engine.queue_search_batch(k3["plan"], k3["batch"],
                                           k3["tobs"], device=dev)
        snr = engine.search_snr_dev(handle)
        peaks, _ = engine.collect_search_batch(
            handle, np.zeros(len(k3["batch"])))
        torch.cuda.synchronize(dev)
        runs.append(("phase 5k example_long survey batch", dict(fk.LAUNCHES),
                     len(w.stacks) - n0))
        n0 = len(w.stacks)
        fk.reset_launches()
        got = run_search_sharded(plan, batch, tobs, dms=np.zeros(D),
                                 mesh=default_mesh())[0]
        torch.cuda.synchronize(dev)
        runs.append(("phase 11a default mesh", dict(fk.LAUNCHES),
                     len(w.stacks) - n0))
    check(torch.cuda.get_sync_debug_mode() == 0,
          "the sync debug mode was not reset")
    for name, launches, nsync in runs:
        for k, v in launches.items():
            counts[k] += v
        print(f"  {name}: launches {launches}, {nsync} syncs reported",
              flush=True)
    # The outputs are the earlier phases' (the debug mode only watches).
    check(np.array_equal(pgram.snrs, p2["snrs"]),
          "phase 13: the headline S/N differs from phase 2's")
    check(cube_digest(snr) == k3["snr_digest"],
          "phase 13: the example_long S/N cube differs from phase 5k's")
    check(peaks == k3["peaks"], "phase 13: the example_long peaks differ "
          "from phase 5k's")
    check(got == p5["sharded_peaks"], "phase 13: the sharded peaks differ "
          "from phase 11a's")
    del snr, handle
    check(counts["fused_stage"] > 0 and counts["paired_stage"] > 0
          and counts["cascade_stage"] > 0,
          f"phase 13 launched {counts}: K1, K2 and K3 must each run")
    sites, outside = {}, 0
    for stack in w.stacks:
        at = scope.site(stack)
        if at is None:
            outside += 1
            continue
        sites[at] = sites.get(at, 0) + 1
    bad = []
    print(f"  {len(w.stacks)} syncs in all, {outside} with no frame of the "
          f"port; {len(sites)} sites:", flush=True)
    print(f"    {'count':>5}  {'site':<46} {'function':<34} {'scope':<15} "
          "covered by", flush=True)
    for (rel, line, qual), n in sorted(sites.items(),
                                       key=lambda kv: (-kv[1], kv[0])):
        where = scope.scope(rel, qual)
        cov = scope.covered(rel, line) if where else ""
        short = rel.replace("riptide_tpu_torch/", "")
        print(f"    {n:5d}  {short + ':' + str(line):<46} {qual:<34} "
              f"{where or '-':<15} {cov or '-'}", flush=True)
        if where and not cov:
            bad.append(f"{rel}:{line} ({qual}, {where})")
    check(not bad, "syncs the rules' scope holds but no baseline entry or "
          "pragma covers: " + "; ".join(bad))
    print("  outputs: the headline S/N phase 2's bits, the example_long cube "
          "phase 5k's bits and its peaks, the sharded peaks phase 11a's",
          flush=True)
    return counts


# Phase 14: benchmark_ffa2's (rows, cols); the exact running median's
# window and the samples of the headline series it runs on (its gather
# holds width int64 indices a sample); the fast running median's window
# (4 s of the headline's 64 us samples, the pipeline's de-reddening
# width) and the downsampling factor.
SURFACE_FFA2 = ((1024, 256), (8192, 256))
SURFACE_RMED = (101, 2 ** 20)
SURFACE_FAST_RMED = 62501
SURFACE_FACTOR = 3.7


def phase_surface(dev, card, data, pgram):
    """Phase 14: the public surface the port shares with the reference.
    The four top-level functions on the headline series (``data``, phase
    2's normalised series; ``pgram``, its periodogram), each the
    submodule function it re-exports and giving its bits;
    ``libffa.benchmark_ffa2`` on the card; ``device_fingerprint()``; the
    ``obs`` and ``survey`` namespaces' names; the finite- and
    liveness-guard shims on this checkout."""
    import riptide_tpu_torch as rt
    from riptide_tpu_torch import libffa, obs, peak_detection, running_medians
    from riptide_tpu_torch import survey
    from riptide_tpu_torch.analysis.lint import finite_guards, liveness_guards
    from riptide_tpu_torch.obs import trace
    from riptide_tpu_torch.search import engine
    from riptide_tpu_torch.survey import metrics, scheduler

    for top, sub, name in (
            (rt.downsample, libffa.downsample, "downsample"),
            (rt.running_median, running_medians.running_median,
             "running_median"),
            (rt.fast_running_median, running_medians.fast_running_median,
             "fast_running_median"),
            (rt.find_peaks, peak_detection.find_peaks, "find_peaks"),
            (obs.span, trace.span, "obs.span"),
            (survey.SurveyScheduler, scheduler.SurveyScheduler,
             "survey.SurveyScheduler"),
            (survey.get_metrics, metrics.get_metrics, "survey.get_metrics")):
        check(top is sub, f"riptide_tpu_torch.{name} is not the submodule's")
    width, n = SURFACE_RMED
    calls = (
        ("downsample", lambda f: f(data, SURFACE_FACTOR),
         rt.downsample, libffa.downsample),
        (f"running_median (width {width}, first {n} samples)",
         lambda f: f(data[:n], width, device=dev),
         rt.running_median, running_medians.running_median),
        (f"fast_running_median (width {SURFACE_FAST_RMED})",
         lambda f: f(data, SURFACE_FAST_RMED, device=dev),
         rt.fast_running_median, running_medians.fast_running_median),
        ("find_peaks", lambda f: f(pgram)[0],
         rt.find_peaks, peak_detection.find_peaks))
    for name, call, top, sub in calls:
        t0 = time.perf_counter()
        got = call(top)
        wall = time.perf_counter() - t0
        want = call(sub)
        if name == "find_peaks":
            same = [p.summary_dict() for p in got] == \
                [p.summary_dict() for p in want]
            check(same and got, "find_peaks: no peaks, or not the same")
            what = f"{len(got)} peaks"
        else:
            check(np.isfinite(got).all() and np.array_equal(got, want),
                  f"{name}: not the submodule function's values")
            what = f"{got.size} {got.dtype} values"
        print(f"  riptide_tpu_torch.{name}: {what}, the submodule's, "
              f"{wall:.4f} s", flush=True)
    for rows, cols in SURFACE_FFA2:
        best = libffa.benchmark_ffa2(rows, cols, device=dev)
        check(np.isfinite(best) and best > 0,
              f"benchmark_ffa2({rows}, {cols}) gave {best}")
        print(f"  benchmark_ffa2({rows}, {cols}): {best:.6f} s, the best of "
              f"10 ({card})", flush=True)
    fp = engine.device_fingerprint()
    print(f"  device_fingerprint(): {fp}", flush=True)
    check(fp == {"backend": "cuda",
                 "device_kind": torch.cuda.get_device_name(0),
                 "device_count": torch.cuda.device_count(),
                 "process_count": 1}, "device_fingerprint: not this card")
    repo = os.path.dirname(os.path.abspath(__file__))
    guards = finite_guards.check(repo) + liveness_guards.check(repo)
    check(guards == [], f"guard shims: {guards}")
    print(f"  obs: {len(obs.__all__)} names, survey: {len(survey.__all__)} "
          "names, each its submodule's; the finite- and liveness-guard "
          "shims clean", flush=True)


# Phase 15: the JAX package's benchmark entry points, each run in a fresh
# process as a user runs it, at full shape: (name, arguments after the
# interpreter, seconds allowed). The headline takes one to three passes
# (its budget), configuration 5 32 chunks.
BENCH_RUNS = (
    ("bench", ["-m", "riptide_tpu_torch.bench"], 600),
    ("config 1", ["-m", "riptide_tpu_torch.bench", "--config", "1"], 300),
    ("config 2", ["-m", "riptide_tpu_torch.bench", "--config", "2"], 300),
    ("config 3", ["-m", "riptide_tpu_torch.bench", "--config", "3"], 300),
    ("config 4", ["-m", "riptide_tpu_torch.bench", "--config", "4"], 300),
    ("config 5", ["-m", "riptide_tpu_torch.bench", "--config", "5"], 600),
    ("stime", ["-m", "riptide_tpu_torch.apps.stime", "32", "4"], 300),
    ("etime", ["-m", "riptide_tpu_torch.apps.etime", "23", "32", "3"], 300),
    ("warmtest", ["-m", "riptide_tpu_torch.apps.warmtest", "32"], 300),
)
# The JAX bench's metric of each run, and the keys of its line beyond the
# decomposition (obs/schema.py::DECOMPOSITION_KEYS, which the headline,
# configs 4 and 5 and stime add).
BENCH_METRICS = {
    "bench": ("dm_trials_per_sec_2p23_samples",
              ("metric", "value", "unit", "vs_baseline", "passes",
               "occupancy")),
    "config 1": ("ffa_search_2p20_seconds",
                 ("metric", "value", "unit", "vs_baseline")),
    "config 2": ("rseek_sigproc_seconds",
                 ("metric", "value", "unit", "vs_baseline")),
    "config 3": ("width_sweep_2p22_seconds",
                 ("metric", "value", "unit", "vs_baseline")),
    "config 4": ("rffa_256trials_2p21_trials_per_sec",
                 ("metric", "value", "unit", "vs_baseline", "total_seconds",
                  "passes")),
    "config 5": ("survey_1024trials_2p23_trials_per_sec",
                 ("metric", "value", "unit", "vs_baseline", "total_seconds",
                  "passes")),
    "stime": ("stime_decomposition", ("metric", "trials_per_sec")),
}
ETIME_LINE = re.compile(
    r"^N=2\^(\d+) D=(\d+): ([\d.]+) s/batch = ([\d.]+) DM-trials/s "
    r"\(vs_baseline x0\.2511 = ([\d.]+)\)$")
SNR_LINE = re.compile(r"^snr stats: ([\d.eE+-]+) \((\d+), (\d+), (\d+)\)$")
WARM_LINE = re.compile(
    r"^warmed (\d+) launch shapes \(parallel=(True|False)\) in ([\d.]+)s$")
GATE_LINE = re.compile(
    r"parity gate: (\d+) peaks, top S/N ([\d.]+) \(float32 reference "
    r"([\d.]+)\) at P = ([\d.]+) s \(device == host; wire=(\w+)")
LAUNCH_LINE = re.compile(r"^kernel launches: (\{.*\})$", re.M)


def run_entry(name, argv, timeout, env):
    """One entry point in a fresh process from this checkout: (stdout
    lines, stderr, wall); fails unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=timeout, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{name}: exit {proc.returncode}; stderr "
          f"ends {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    check(lines, f"{name}: printed nothing")
    return lines, proc.stderr, wall


def entry_launches(name, err):
    """The process's kernel launch counts, from the bench's stderr."""
    m = LAUNCH_LINE.search(err)
    check(m is not None, f"{name}: no kernel launch line on stderr")
    return json.loads(m.group(1).replace("'", '"'))


def check_bench_line(name, lines):
    """The last line of a bench or stime run: JSON with the JAX line's
    keys and metric, finite numbers."""
    from riptide_tpu_torch.obs.schema import DECOMPOSITION_KEYS

    line = json.loads(lines[-1])
    metric, keys = BENCH_METRICS[name]
    want = set(keys)
    if name in ("bench", "config 4", "config 5", "stime"):
        want |= set(DECOMPOSITION_KEYS)
    got = set(line) if name != "stime" else {
        k for k in line if not k.startswith("dispatch_")}
    check(got == want, f"{name}: keys {sorted(got)}, want {sorted(want)}")
    check(line["metric"] == metric, f"{name}: metric {line['metric']}")
    value = line.get("value", line.get("trials_per_sec"))
    check(np.isfinite(value) and value > 0, f"{name}: value {value}")
    return line


def phase_bench(dev, plan, p5, card, runs=BENCH_RUNS, D=32):
    """Phase 15: the benchmark entry points the JAX package defines, run as
    a user runs them, each in a fresh process (``BENCH_RUNS``), with
    ``RIPTIDE_LEDGER`` pointed at a scratch ledger: every run must exit 0
    with a last line carrying the JAX line's keys (the headline:
    ``passes`` >= 1, its parity gate's line on stderr, K1 and the gate's
    K2 launched; configs 1-5 their metric and K1 launched; stime its
    decomposition block; etime its S/N line; warmtest the plan's distinct
    launch shapes). In this process, ``warm_stage_kernels`` must return
    ``len(engine.launch_shapes(plan, D))``; then the ``queue`` of a
    headline survey search at D on phase 5's batch is timed three times,
    each after the plan's operands, its peak plans and the allocator's
    free blocks were dropped, or not: with no warm-up, first after
    ``warm_stage_kernels``, and warm (a figure to record; the peaks must
    agree). Returns the headline's line."""
    import shutil
    import tempfile

    from riptide_tpu_torch import bench
    from riptide_tpu_torch.search import engine
    from riptide_tpu_torch.utils.cuda_build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    env = dict(os.environ, RIPTIDE_LEDGER=os.path.join(tmp, "ledger.jsonl"))
    out = {}
    try:
        for name, argv, timeout in runs:
            lines, err, wall = run_entry(name, argv, timeout, env)
            if name in BENCH_METRICS:
                line = out[name] = check_bench_line(name, lines)
            if name == "bench":
                check(line["passes"] >= 1, "bench: no timed pass")
                gate = GATE_LINE.search(err)
                check(gate is not None, "bench: no parity gate line on stderr")
                top, ref = float(gate.group(2)), float(gate.group(3))
                gate_line = err[gate.start():].splitlines()[0]
                check(abs(top - ref) < 0.15 and abs(float(gate.group(4))
                                                    - 1.0) < 1e-4,
                      f"bench: gate line {gate_line}")
                n = entry_launches(name, err)
                check(n["fused_stage"] > 0 and n["cascade_stage"] > 0,
                      f"bench: launches {n}")
                sub = {k: line[k] for k in line
                       if k not in BENCH_METRICS[name][1]}
                bound = bench.pass_bound(line)
                print(f"  bench: {line['value']} DM-trials/s, vs_baseline "
                      f"{line['vs_baseline']}, best of {line['passes']} "
                      f"passes of 5 chunks of D = 32 ({wall:.1f} s wall); "
                      f"{sub}; bound {bound}; {gate_line}; "
                      f"launches {n} ({card})", flush=True)
            elif name.startswith("config"):
                n = entry_launches(name, err)
                check(n["fused_stage"] > 0, f"{name}: launches {n}")
                print(f"  {name}: {line['metric']} = {line['value']} "
                      f"{line['unit']} ({wall:.1f} s wall; launches {n}"
                      + (f"; {line['total_seconds']} s timed, chunk_s "
                         f"{line['chunk_s']}, prep_s {line['prep_s']}, "
                         f"device_s {line['device_s']}"
                         if "total_seconds" in line else "") + f"; {card})",
                      flush=True)
            elif name == "stime":
                iters = [x for x in lines if x.startswith("iter ")]
                check(len(iters) == 4, f"stime: {len(iters)} iterations")
                print(f"  stime ({wall:.1f} s wall): "
                      + "; ".join(x.strip() for x in lines
                                  if x.lstrip().startswith(("copy", "rtt")))
                      + "; " + "; ".join(iters)
                      + f"; {lines[-1]} ({card})", flush=True)
            elif name == "etime":
                snr, res = SNR_LINE.match(lines[-1]), ETIME_LINE.match(
                    lines[-2])
                check(snr is not None and res is not None
                      and np.isfinite(float(snr.group(1)))
                      and tuple(int(x) for x in snr.group(2, 3, 4))
                      == (D, HEADLINE_TRIALS, len(HEADLINE_WIDTHS)),
                      f"etime: last lines {lines[-2:]}")
                print(f"  etime ({wall:.1f} s wall): {lines[-2]}; "
                      f"{lines[-1]} ({card})", flush=True)
            else:
                m = WARM_LINE.match(lines[-1])
                check(m is not None, f"warmtest: last line {lines[-1]}")
                out["warmtest"] = int(m.group(1))
                print(f"  warmtest ({wall:.1f} s wall, the process): "
                      f"{lines[-1]}", flush=True)
        with open(env["RIPTIDE_LEDGER"]) as fobj:
            rows = [json.loads(x) for x in fobj]
        kinds = sorted(f"{r['kind']}:{r.get('metric')}" for r in rows)
        print(f"  ledger rows: {kinds}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want = len(engine.launch_shapes(plan, D))
    tobs = plan.size * plan.tsamp
    dms = np.zeros(D)
    prepared = engine.prepare_stage_data(plan, p5["batch"][:D])

    def timed_queue():
        shipped = engine.ship_stage_data(prepared, dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        handle = engine.queue_search_batch(plan, None, tobs, shipped=shipped,
                                           **bench.PKW)
        queue_s = time.perf_counter() - t0
        return queue_s, engine.collect_search_batch(handle, dms)[0]

    def cold():
        engine.drop_device_operands(plan, dev)
        plan.__dict__.pop("_peak_plans", None)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    cold()
    t_cold, peaks = timed_queue()
    cold()
    t0 = time.perf_counter()
    n = engine.warm_stage_kernels(plan, D, device=dev)
    t_warmup = time.perf_counter() - t0
    check(n == want and out.get("warmtest", want) == want,
          f"warm_stage_kernels warmed {n} shapes, warmtest "
          f"{out.get('warmtest')}; the plan has {want}")
    t_first, first = timed_queue()
    t_warm, again = timed_queue()
    check(first == peaks and again == peaks,
          "the warmed searches' peaks differ from the cold one's")
    print(f"  warm_stage_kernels(plan, {D}): {n} launch shapes, the plan's "
          f"distinct {want}, in {t_warmup:.3f} s; queue_search_batch of a "
          f"D = {D} headline search: {t_cold:.4f} s cold (no warm-up), "
          f"{t_first:.4f} s first after the warm-up, {t_warm:.4f} s warm "
          f"({card})", flush=True)
    return out.get("bench")


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
    from riptide_tpu_torch.search import peaks_device

    libs = (fk._LIB, peaks_device._CLUSTER_LIB, probes.LIB)
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
    launches, rec, err1, data, _, p2 = phase_headline(dev, plan)
    print("phase 3: K1 and K2 on their paths' launches", flush=True)
    err2, times = phase_kernels(dev, plan, rec, oracle)
    del rec, oracle
    print("phase 4: run_periodogram_batch, D = 32", flush=True)
    p4 = phase_batch(dev, plan)
    print("phase 5: run_search_batch, D = 32", flush=True)
    p5 = phase_survey(dev, plan)
    print("phase 5k: K3 on example_long's survey batch, D = 32", flush=True)
    n3, err3, times["K3"], k3_clusters, p5["k3"] = phase_k3(dev)
    p5["clusters"].append(k3_clusters)
    print("phase 5c: the peak program's cluster kernel on phase 5's cube",
          flush=True)
    cluster_entry = phase_cluster(dev, plan, p5)
    print("phase 5f: file entry points (PRESTO, SIGPROC 32- and 8-bit)",
          flush=True)
    phase_files(dev, plan, headline_series())
    print("phase 5w: wide phase widths through K1 and K2", flush=True)
    wide, wide_bits = phase_wide(dev)
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
        k1_journal, probed = phase_journal(dev, p7, card)
        print(f"  phase 8: {time.perf_counter() - t8:.1f} s wall", flush=True)
        print("phase 9: the report and watch CLIs on phase 8's journal, the "
              "chaos campaign on the card, the kernel library corrupted and "
              "rebuilt", flush=True)
        t9 = time.perf_counter()
        k1_chaos = phase_chaos(probed, p7["nchunks"], card)
        print(f"  phase 9: {time.perf_counter() - t9:.1f} s wall", flush=True)
        print("phase 10: the survey service on phase 7's trials (two "
              "tenants, a warm repeat, drain and restart, the clients)",
              flush=True)
        t10 = time.perf_counter()
        k1_serve = phase_serve(dev, p7, card)
        print(f"  phase 10: {time.perf_counter() - t10:.1f} s wall",
              flush=True)
        print("phase 11: the multi-GPU paths on the card (the sharded "
              "survey through K2, ffa2_seq, two processes over gloo, a "
              "peer loss)", flush=True)
        t11 = time.perf_counter()
        k2_sharded, err_sh, sh_times, k1_multi = phase_multi(dev, plan, p5,
                                                             tmp)
        print(f"  phase 11: {time.perf_counter() - t11:.1f} s wall",
              flush=True)
        # Phase 11 was the last to read phase 5's cube on the card; phase
        # 13 holds its repeat to the cube's digest.
        p5["snr_digest"] = cube_digest(p5["snr"])
        p5["snr"] = None
        print("phase 12: the launch contracts and the peak-memory model "
              "(the card's launches against the CPU walk, the model against "
              "the allocator, a seeded split, a journaled run under the "
              "budget)", flush=True)
        t12 = time.perf_counter()
        phase_prove(dev, plan, p4, p5, p7)
        print(f"  phase 12: {time.perf_counter() - t12:.1f} s wall",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 13: the static rules against the card (riplint on the "
          "card's machine; the sync witness over phases 2, 5 and 11a)",
          flush=True)
    t13 = time.perf_counter()
    phase_lint()
    witness = phase_witness(dev, plan, p2, p5)
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s wall", flush=True)
    print("phase 14: the public surface (the top-level functions, "
          "benchmark_ffa2, device_fingerprint, the obs and survey names)",
          flush=True)
    t14 = time.perf_counter()
    phase_surface(dev, card, data, p2["pgram"])
    print(f"  phase 14: {time.perf_counter() - t14:.1f} s wall", flush=True)
    print("phase 15: the benchmark entry points (bench headline and configs "
          "1-5, stime, etime, warmtest), each a fresh process; "
          "warm_stage_kernels and the first queue", flush=True)
    t15 = time.perf_counter()
    phase_bench(dev, plan, p5, card)
    print(f"  phase 15: {time.perf_counter() - t15:.1f} s wall", flush=True)
    if args.profile:
        print("profile: headline run_periodogram", flush=True)
        profile_search(plan, data, dev, args.profile)

    # Each kernel's launches on its own path, counted from 0 just before
    # that path's run: K1 the headline search (phase 2), K2 the float32
    # oracle search (phase 1), K3 example_long's survey batch (phase 5k).
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
    # count ...
    entries[0]["journal_launches"] = k1_journal
    # ... over phase 9's chaos legs (each a fresh process) ...
    entries[0]["chaos_launches"] = k1_chaos
    # ... in the turns of phase 10's served jobs ...
    entries[0]["serve_launches"] = k1_serve
    # ... and in phase 11's two processes; K2 on phase 11's sharded path,
    # its time over the default mesh's launches.
    entries[0]["multihost_launches"] = k1_multi
    ms, pms, bms, by = sh_times
    # The launches of phase 13's sync witness.
    for entry, fn in zip(entries, ("fused_stage", "cascade_stage",
                                   "paired_stage")):
        entry["witness_launches"] = witness[fn]
    entries[1].update(sharded_launches=k2_sharded, sharded_ms=ms,
                      sharded_plain_ms=pms, sharded_bound_ms=bms,
                      sharded_bound_by=by, sharded_max_abs_err=err_sh)
    # Each wide-phase search's K1 and K2 launches, timed (phase 5w).
    entries[0]["wide"] = wide["fused_stage"]
    entries[1]["wide"] = wide["cascade_stage"]
    entries[1]["wide_bits"] = wide_bits
    entries.append(cluster_entry)
    entries += probe_entries
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
