"""
Seeded storage-chaos campaign: prove kill-anywhere resume, end to end
(the port's copy of the JAX package's ``survey/chaos.py``).

Each *schedule* runs a tiny deterministic survey as a sequence of
subprocess *legs* on a named device, with storage faults
(:mod:`riptide_tpu_torch.survey.faults` storage kinds, injected through
the :mod:`riptide_tpu_torch.utils.fsio` layer) arming mid-write kills,
torn writes, ENOSPC, fsync failures and build-cache corruption, then
restarts with ``resume`` and asserts the end state:

* ``peaks.csv`` is **byte-identical** to the fault-free control run's
  (the port's own control run: the port prints float32 S/N, so its
  bytes are not the JAX package's);
* the resumed journal is consistent: exactly one chunk record per
  chunk, no torn/corrupt lines left, phase timings summing within the
  report tolerance, and a peak store with no orphaned rows;
* the perf ledger holds a valid row for the completed run;
* every injected fault left an **incident record** in the journal
  (``storage_recovered``, ``obs_write_failed``, ``cache_corrupt``,
  the integrity kinds);
* no leg printed a traceback: expected kills exit ``fsio.KILL_EXIT``,
  everything else exits 0;
* every leg ran on the device the campaign asked for (``cuda`` unless
  asked for ``cpu``; no fallback), and on ``cuda`` a leg that searched
  a chunk launched K1 (``ffa_kernel.LAUNCHES["fused_stage"]``). A leg
  reports both in ``leg<i>.out.json``, also when an injected kill ends
  it (the fault plan's exit hook writes the report first). A resume leg
  whose journal holds every chunk replays them all and searches none.

The control schedule additionally asserts the hardening is
byte-transparent for healthy runs: re-running recovery and the report
readers over its artifacts leaves journal, peak store and ledger
byte-for-byte unchanged, and ledger rows remain plain JSON lines.

:func:`builtin_schedules` is the fixed set (the JAX package's, its
three service schedules included: there the survey runs as an HTTP job
of the service daemon inside the leg process, on the leg's device);
:func:`seeded_schedules` derives arbitrarily many extra
(``rchaos --sweep N``, or the slow-marked test). Legs re-enter this
module via ``python -m riptide_tpu_torch.survey.chaos --leg cfg.json``.
"""
import json
import logging
import os
import random
import shutil
import subprocess
import sys
import time

from ..utils import envflags, fsio

log = logging.getLogger("riptide_tpu_torch.survey.chaos")

__all__ = ["builtin_schedules", "seeded_schedules", "run_campaign",
           "ChaosFailure", "SEARCH_CONF", "TOBS", "TSAMP", "PERIOD", "DMS",
           "AMPLITUDE", "write_trials"]

# The tiny deterministic survey every schedule runs: three single-file
# DM-trial chunks, small enough that a whole multi-leg schedule stays
# in test time on the CPU.
TOBS, TSAMP, PERIOD = 12.0, 1e-3, 0.5
DMS = (0.0, 5.0, 10.0)
AMPLITUDE = 30.0
DUCY = 0.05
DERED = {"rmed_width": 4.0, "rmed_minpts": 101}

SEARCH_CONF = [{
    "ffa_search": {"period_min": 0.3, "period_max": 1.2,
                   "bins_min": 64, "bins_max": 71},
    "find_peaks": {"smin": 6.0},
}]

# g++ flags of the cache probe's library.
PROBE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


class ChaosFailure(AssertionError):
    """A chaos schedule violated one of the campaign's invariants."""


def default_workdir():
    """Campaign working directory: ``RIPTIDE_CHAOS_DIR`` or a fixed
    tempdir (kept on failure for post-mortems; see ``rchaos --keep``)."""
    import tempfile

    return envflags.get("RIPTIDE_CHAOS_DIR") or os.path.join(
        tempfile.gettempdir(), "riptide_tpu_torch_chaos")


def default_keep():
    """Whether to keep the working directory after a PASSING campaign
    (``RIPTIDE_CHAOS_KEEP``; failures always keep it)."""
    return bool(envflags.get("RIPTIDE_CHAOS_KEEP"))


def write_trials(datadir, seed=0):
    """The campaign's three PRESTO DM trials under ``datadir``: a 12 s
    series at 1 ms with a 0.5 s pulsar of amplitude 30 (duty cycle
    0.05), DMs 0, 5 and 10, each from ``np.random.seed(seed)`` (the
    same series the JAX package's test fixture writes). Returns the .inf
    paths."""
    import numpy as np

    from ..reading.presto import write_presto
    from ..time_series import TimeSeries

    os.makedirs(datadir, exist_ok=True)
    out = []
    for dm in DMS:
        np.random.seed(seed)
        ts = TimeSeries.generate(TOBS, TSAMP, PERIOD, amplitude=AMPLITUDE,
                                 ducy=DUCY, stdnoise=1.0)
        out.append(write_presto(os.path.join(datadir, f"chaos_DM{dm:.2f}"),
                                ts.data, TSAMP, dm=dm))
    return out


# --------------------------------------------------------------- schedules

def builtin_schedules():
    """The fixed schedule set. ``control`` must (and does) come first:
    it produces the reference ``peaks.csv`` bytes and the
    byte-transparency assertions. Journal-append operation indices on
    the clean path: 1 = header, 2-4 = chunk records, 5 = metrics."""
    return [
        {"name": "control", "legs": [{"faults": ""}], "incidents": []},
        {"name": "kill-journal-append",
         "legs": [{"faults": "kill_at:journal_append:3", "expect": "kill"},
                  {"faults": "", "resume": True}],
         "incidents": ["storage_recovered"]},
        {"name": "torn-journal-tail",
         "legs": [{"faults": "kill_at:journal_append:5", "expect": "kill"},
                  {"faults": "", "resume": True}],
         "incidents": ["storage_recovered"]},
        {"name": "kill-peaks-append",
         "legs": [{"faults": "kill_at:peaks_append:2", "expect": "kill"},
                  {"faults": "", "resume": True}],
         "incidents": ["storage_recovered"]},
        {"name": "kill-ledger-append",
         "legs": [{"faults": "kill_at:ledger_append:1", "expect": "kill"},
                  {"faults": "", "resume": True}],
         "incidents": ["storage_recovered"]},
        {"name": "enospc-trace-export",
         "legs": [{"faults": "enospc:trace_export", "trace": True}],
         "incidents": ["obs_write_failed"]},
        {"name": "fsync-fail-heartbeat",
         "legs": [{"faults": "fsync_fail:heartbeat_append"}],
         "incidents": ["obs_write_failed"]},
        {"name": "enospc-prom-textfile",
         "legs": [{"faults": "enospc:prom_textfile", "prom": True}],
         "incidents": ["obs_write_failed"]},
        {"name": "cache-corrupt",
         "legs": [{"faults": "cache_corrupt:exec_cache_store:1",
                   "cache_probe": True, "cache_expect": "compiled"},
                  {"faults": "", "resume": True, "cache_probe": True,
                   "cache_expect": "compiled", "cache_reload": True}],
         "incidents": ["cache_corrupt"]},
        # The survey service: the daemon runs in the leg process with
        # the same survey submitted as an HTTP job; the armed kill drops
        # the whole daemon mid-job, and the restart leg must replay
        # jobs.jsonl, resume the job from its own journal and serve a
        # byte-identical peaks.csv.
        {"name": "serve-kill-mid-job", "serve": True,
         "legs": [{"faults": "kill_at:journal_append:3", "expect": "kill"},
                  {"faults": "", "resume": True}],
         "incidents": ["storage_recovered"]},
        # Graceful drain: leg 0 drains the daemon mid-job (after exactly
        # one chunk — a low-priority blocker steps the queue
        # deterministically) and must exit 0 with the job parked
        # non-terminally; the restart leg re-queues it and serves a
        # byte-identical peaks.csv.
        {"name": "serve-drain-mid-job", "serve": True,
         "legs": [{"faults": "", "serve_drain": True},
                  {"faults": "", "resume": True}],
         "incidents": []},
        # Device-error containment: two jobs share the daemon; the
        # second carries a spec-level device_error fault that outlasts
        # the retry budget (the CUDA context stays usable) and must fail
        # ALONE while the clean sibling (j0001, the directory the
        # campaign checks) completes normally.
        {"name": "serve-device-error", "serve": True,
         "legs": [{"faults": "", "serve_device_error": True}],
         "incidents": []},
        # A TRANSIENT in-flight bitflip on chunk 1's primary dispatch:
        # the shadow probe detects the digest divergence and the third
        # dispatch out-votes the corrupted primary 2:1 — one leg, no
        # quarantine, peaks.csv byte-identical to the control run's.
        {"name": "bitflip-detect-revote",
         "legs": [{"faults": "bitflip:1", "integrity": "probe",
                   "probe_every": 1}],
         "incidents": ["result_mismatch"]},
        # PERSISTENT corruption: all three of chunk 1's dispatches flip
        # (a different byte each), so the vote cannot resolve. The device
        # quarantines: chunk 1 parks, the latch parks chunk 2 behind it,
        # and the leg exits 0 degraded. The clean resume leg replays
        # chunk 0 and re-dispatches the parked chunks.
        {"name": "bitflip-quarantine-resume",
         "legs": [{"faults": "bitflip:1x3", "integrity": "probe",
                   "probe_every": 1},
                  {"faults": "", "resume": True, "integrity": "probe",
                   "probe_every": 1}],
         "incidents": ["result_mismatch", "integrity_quarantine",
                       "chunk_parked"]},
    ]


def seeded_schedules(seed, count):
    """``count`` extra schedules derived deterministically from
    ``seed``: a mid-write kill at a random journal/peaks/ledger
    boundary, then a resume leg carrying a random observability-write
    degradation — every combination must still end byte-identical with
    its incidents recorded. Same seed, same schedules (the JAX
    package's), so a failing sweep entry reproduces by name."""
    rng = random.Random(int(seed))
    kills = [("journal_append", 1, 5), ("peaks_append", 1, 3),
             ("ledger_append", 1, 1)]
    degradations = [
        ("enospc", "trace_export", {"trace": True}),
        ("fsync_fail", "trace_export", {"trace": True}),
        ("enospc", "prom_textfile", {"prom": True}),
        ("fsync_fail", "prom_textfile", {"prom": True}),
        ("torn_write", "ledger_append", {}),
        ("enospc", "heartbeat_append", {}),
        ("fsync_fail", "heartbeat_append", {}),
    ]
    out = []
    for i in range(int(count)):
        site, lo, hi = rng.choice(kills)
        nth = rng.randint(lo, hi)
        # A kill at/after the last journal record leaves no pending
        # chunks, so the resume leg replays everything and never
        # heartbeats — heartbeat degradations would go unfired there.
        replays_all = site == "ledger_append" or \
            (site == "journal_append" and nth == 5)
        pool = [d for d in degradations
                if not (replays_all and d[1] == "heartbeat_append")]
        kind2, site2, legopts = rng.choice(pool)
        resume_leg = dict({"faults": f"{kind2}:{site2}", "resume": True},
                          **legopts)
        legs = [{"faults": f"kill_at:{site}:{nth}", "expect": "kill"},
                resume_leg]
        if site2 == "ledger_append":
            # The degradation destroyed the completing leg's ONLY
            # ledger append (the kill already ate leg 1's); a final
            # clean resume must recover the row from the journaled
            # timings — exactly the replay-derived-row path.
            legs.append({"faults": "", "resume": True})
        out.append({
            "name": f"seeded-{int(seed)}-{i:02d}",
            "legs": legs,
            "incidents": ["storage_recovered", "obs_write_failed"],
        })
    return out


# ------------------------------------------------------------ the campaign

def _repo_root():
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _run_leg(schedule, i, leg, paths, python, timeout_s, device):
    """Run one leg in a fresh process; returns its report
    (``leg<i>.out.json``) with the process's wall seconds (``wall_s``)."""
    out_path = os.path.join(paths["sdir"], f"leg{i}.out.json")
    cfg = {
        "journal": paths["jdir"],
        "files": paths["files"],
        "device": device,
        "out": out_path,
        "faults": leg.get("faults", ""),
        "resume": bool(leg.get("resume", False)),
        "peaks_csv": paths["peaks_csv"],
        "trace": bool(leg.get("trace", False)),
        "cache_probe": bool(leg.get("cache_probe", False)),
        "cache_dir": paths["cache_dir"],
        "cache_expect": leg.get("cache_expect"),
        "cache_reload": bool(leg.get("cache_reload", False)),
        "integrity": leg.get("integrity"),
        "probe_every": leg.get("probe_every"),
        "serve": bool(schedule.get("serve", False)),
        "serve_root": paths.get("serve_root"),
        "serve_drain": bool(leg.get("serve_drain", False)),
        "serve_device_error": bool(leg.get("serve_device_error", False)),
    }
    cfg_path = os.path.join(paths["sdir"], f"leg{i}.json")
    with open(cfg_path, "w") as fobj:
        json.dump(cfg, fobj, indent=1)
    env = dict(os.environ)
    for name in ("PYTHONPATH", "RIPTIDE_FAULT_INJECT", "RIPTIDE_TRACE",
                 "RIPTIDE_PROM_TEXTFILE", "RIPTIDE_PROM_PORT",
                 "RIPTIDE_INTEGRITY", "RIPTIDE_INTEGRITY_PROBE_EVERY"):
        env.pop(name, None)
    env["RIPTIDE_LEDGER"] = paths["ledger"]
    if leg.get("prom"):
        env["RIPTIDE_PROM_TEXTFILE"] = os.path.join(paths["sdir"],
                                                    "metrics.prom")
    if cfg["integrity"]:
        # The leg's scheduler resolves its integrity config from the
        # environment (legs construct it without an integrity kwarg).
        env["RIPTIDE_INTEGRITY"] = str(cfg["integrity"])
        if cfg["probe_every"]:
            env["RIPTIDE_INTEGRITY_PROBE_EVERY"] = str(cfg["probe_every"])
    if cfg["serve"] and cfg["faults"]:
        # Serve legs inject through the daemon's environment (the
        # scheduler installs its own storage-fault hook per run, so a
        # process-level hook can't reach it; and a fault spec in the
        # job SPEC would persist in the registry and re-arm on the
        # restart leg).
        env["RIPTIDE_FAULT_INJECT"] = cfg["faults"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [python, "-m", "riptide_tpu_torch.survey.chaos", "--leg", cfg_path],
        env=env, cwd=_repo_root(), capture_output=True, text=True,
        timeout=float(timeout_s),
    )
    wall = time.perf_counter() - t0
    expect = leg.get("expect", "ok")
    want_rc = fsio.KILL_EXIT if expect == "kill" else 0
    tail = "\n".join(proc.stderr.splitlines()[-15:])
    where = (f"schedule {schedule['name']!r} leg {i} "
             f"(faults={leg.get('faults', '')!r})")
    if proc.returncode != want_rc:
        raise ChaosFailure(f"{where} exited {proc.returncode}, expected "
                           f"{want_rc}:\n{tail}")
    if "Traceback (most recent call last)" in proc.stderr:
        raise ChaosFailure(f"{where} raised an uncaught exception:\n{tail}")
    try:
        with open(out_path) as fobj:
            report = json.load(fobj)
    except (OSError, ValueError) as err:
        raise ChaosFailure(f"{where} left no report ({err})") from None
    if report.get("device") != device:
        raise ChaosFailure(f"{where} ran on {report.get('device')!r}, "
                           f"asked for {device!r}")
    if device == "cuda" and report["chunks_done"] and \
            not report["k1_launches"]:
        raise ChaosFailure(f"{where} searched {report['chunks_done']} "
                           "chunk(s) on cuda but launched no K1")
    report["wall_s"] = wall
    return report


def _valid_records(path):
    """Parsed records of every good line; raises on torn/corrupt lines
    (a FINAL journal must be fully valid — the last leg completed)."""
    entries, _ = fsio.scan_jsonl(path)
    bad = [status for obj, status, _ in entries if obj is None]
    if bad:
        raise ChaosFailure(f"{path}: {len(bad)} invalid line(s) "
                           f"({bad}) in a completed run's file")
    return [obj for obj, _, _ in entries]


def _check_schedule(schedule, paths):
    """The post-schedule invariants (see the module docstring)."""
    from ..obs import report

    name = schedule["name"]
    recs = _valid_records(os.path.join(paths["jdir"], "journal.jsonl"))
    chunk_ids = [int(r["chunk_id"]) for r in recs
                 if r.get("kind") == "chunk"]
    nchunks = len(paths["files"])
    if sorted(set(chunk_ids)) != list(range(nchunks)):
        raise ChaosFailure(f"{name}: journal completed chunks "
                           f"{sorted(set(chunk_ids))}, expected "
                           f"{list(range(nchunks))}")
    if len(chunk_ids) != len(set(chunk_ids)):
        raise ChaosFailure(f"{name}: duplicate chunk records after "
                           f"resume: {sorted(chunk_ids)}")
    last = {int(r["chunk_id"]): r for r in recs
            if r.get("kind") == "chunk"}
    _, violations = report.phase_attribution(last)
    if violations:
        raise ChaosFailure(f"{name}: phase-sum violations {violations}")
    rows = _valid_records(os.path.join(paths["jdir"], "peaks.jsonl"))
    claimed = sum(int(r.get("peaks_count", 0)) for r in last.values())
    if len(rows) != claimed:
        raise ChaosFailure(
            f"{name}: peak store holds {len(rows)} rows but chunk "
            f"records claim {claimed} (orphaned or missing rows)")
    survey_id = next((r.get("survey_id") for r in recs
                      if r.get("kind") == "header"), None)
    ledger_rows = [r for r in report.read_ledger(paths["ledger"])
                   if r.get("kind") == "survey"
                   and r.get("survey_id") == survey_id]
    if not ledger_rows:
        raise ChaosFailure(f"{name}: no ledger row for the completed "
                           f"run (survey {survey_id})")
    seen = {r.get("incident") for r in recs if r.get("kind") == "incident"}
    missing = [k for k in schedule.get("incidents", ()) if k not in seen]
    if missing:
        raise ChaosFailure(f"{name}: expected incident kind(s) "
                           f"{missing} not recorded (saw {sorted(seen)})")
    with open(paths["peaks_csv"], "rb") as fobj:
        return fobj.read(), len(recs)


def _check_control_stability(paths):
    """The hardening is byte-transparent for healthy runs: recovery
    plus a full report pass over the control run's artifacts changes
    nothing, and ledger rows are plain (checksum-less) JSON lines."""
    from ..obs import report
    from .journal import SurveyJournal

    targets = [os.path.join(paths["jdir"], "journal.jsonl"),
               os.path.join(paths["jdir"], "peaks.jsonl"),
               paths["ledger"]]
    before = {}
    for path in targets:
        with open(path, "rb") as fobj:
            before[path] = fobj.read()
    for line in before[paths["ledger"]].splitlines():
        if line.strip():
            json.loads(line)  # raw-parseable: no suffix, no framing
    journal = SurveyJournal(paths["jdir"])
    journal.recover()
    report.build_report(paths["jdir"])
    journal.completed_chunks()
    for path in targets:
        with open(path, "rb") as fobj:
            if fobj.read() != before[path]:
                raise ChaosFailure(
                    f"control: {path} bytes changed by a recovery/"
                    "report pass over a healthy run")


def run_campaign(files, workdir, schedules=None, python=None,
                 timeout_s=300.0, device="cuda"):
    """Run every schedule (default: :func:`builtin_schedules` plus
    ``RIPTIDE_CHAOS_SWEEP`` seeded ones under ``RIPTIDE_CHAOS_SEED``)
    against the pre-generated survey ``files``, each leg on ``device``
    (``cuda`` or ``cpu``), asserting the campaign's invariants; raises
    :class:`ChaosFailure` on the first violation. Returns a summary
    dict: the counts, the control run's ``peaks.csv`` size and, per
    schedule, its legs, wall seconds, K1 launches and each leg's
    report."""
    python = python or sys.executable
    if schedules is None:
        schedules = builtin_schedules() + seeded_schedules(
            envflags.get("RIPTIDE_CHAOS_SEED"),
            envflags.get("RIPTIDE_CHAOS_SWEEP"))
    schedules = list(schedules)
    if not schedules or schedules[0]["name"] != "control":
        schedules.insert(0, builtin_schedules()[0])
    ref_bytes = None
    legs_run = 0
    per_schedule = []
    for schedule in schedules:
        sdir = os.path.join(workdir, schedule["name"])
        shutil.rmtree(sdir, ignore_errors=True)
        os.makedirs(sdir)
        paths = {
            "sdir": sdir,
            "jdir": os.path.join(sdir, "j"),
            "ledger": os.path.join(sdir, "ledger.jsonl"),
            "peaks_csv": os.path.join(sdir, "peaks.csv"),
            "cache_dir": os.path.join(sdir, "cache"),
            "files": [os.path.abspath(f) for f in files],
        }
        if schedule.get("serve"):
            paths["serve_root"] = os.path.join(sdir, "serve")
            # A fresh registry's first job is deterministically j0001;
            # its per-job journal directory is what the campaign's
            # journal/ledger/incident invariants check.
            paths["jdir"] = os.path.join(paths["serve_root"], "jobs",
                                         "j0001")
        t0 = time.perf_counter()
        reports = []
        for i, leg in enumerate(schedule["legs"]):
            reports.append(_run_leg(schedule, i, leg, paths, python,
                                    timeout_s, device))
            legs_run += 1
        wall = time.perf_counter() - t0
        peaks_bytes, nrecords = _check_schedule(schedule, paths)
        if schedule["name"] == "control":
            ref_bytes = peaks_bytes
            _check_control_stability(paths)
        elif peaks_bytes != ref_bytes:
            raise ChaosFailure(
                f"{schedule['name']}: peaks.csv differs from the "
                f"fault-free control run ({len(peaks_bytes)} vs "
                f"{len(ref_bytes)} bytes)")
        per_schedule.append({
            "name": schedule["name"], "legs": len(reports), "wall_s": wall,
            "k1_launches": sum(r["k1_launches"] for r in reports),
            "reports": reports})
        log.info("chaos schedule %-24s OK (%d leg(s), %d journal "
                 "records, %.1f s)", schedule["name"],
                 len(schedule["legs"]), nrecords, wall)
    return {"schedules": len(schedules), "legs": legs_run,
            "peaks_csv_bytes": len(ref_bytes or b""),
            "per_schedule": per_schedule}


# ------------------------------------------------------------ the leg side

def _cache_probe(cache_dir, expect=None, reload_check=False):
    """Exercise the build cache's corruption recovery inside a leg: a
    tiny C++ library (``chaos_probe.cpp``) built with g++ through
    ``exec_cache.obtain`` into the schedule's own cache directory. A
    ``cache_corrupt`` storage fault flips the last byte of the stored
    library; the NEXT leg's probe must detect the digest mismatch, emit
    the incident (journaled — the leg installs the journal sink first),
    evict, rebuild, and still compute the right values.
    ``reload_check`` (the recovery leg only) additionally asserts the
    rebuilt library loads back cleanly."""
    import ctypes
    from pathlib import Path

    import numpy as np

    from ..utils import exec_cache

    source = Path(__file__).with_name("chaos_probe.cpp")

    def compile_fn(out):
        proc = subprocess.run(["g++", *PROBE_FLAGS, str(source), "-o", out],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source.name}: "
                               f"{proc.stderr.strip()}")
        return proc.stdout + proc.stderr

    x = np.arange(8.0)
    want = x * 2.0 + 1.0

    def probe():
        info = {}
        lib = exec_cache.obtain(source, PROBE_FLAGS,
                                ("g++", "-dumpfullversion"), compile_fn,
                                load=True, directory=cache_dir, info=info)
        fn = lib.chaos_probe
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        y = np.empty_like(x)
        fn(x.ctypes.data, y.ctypes.data, x.size)
        if not np.array_equal(y, want):
            raise ChaosFailure("cache probe produced wrong results")
        return info["action"]

    action = probe()
    if expect is not None and action != expect:
        raise ChaosFailure(f"cache probe action {action!r}, "
                           f"expected {expect!r}")
    if reload_check:
        action = probe()
        if action != "loaded":
            raise ChaosFailure(f"cache probe re-load after rebuild: action "
                               f"{action!r}")


class _LegReport:
    """A leg's report (``leg<i>.out.json``): the device it ran on, K1
    launches, chunks searched and replayed, whether an injected kill
    ended it, and its seconds."""

    def __init__(self, path):
        self.path = path
        self.device = None
        self.t0 = time.perf_counter()
        self.run_t0 = None

    def write(self, killed):
        from ..ops import ffa_kernel
        from .metrics import get_metrics

        m = get_metrics()
        now = time.perf_counter()
        doc = {"device": self.device,
               "k1_launches": int(ffa_kernel.LAUNCHES["fused_stage"]),
               "chunks_done": int(m.counter("chunks_done")),
               "chunks_skipped": int(m.counter("chunks_skipped")),
               "killed": killed,
               # Seconds from the leg's entry (the package already
               # imported), and of the survey's run (CUDA context and
               # library loads included).
               "leg_s": now - self.t0,
               "run_s": (None if self.run_t0 is None
                         else now - self.run_t0)}
        fsio.atomic_write_text(self.path, json.dumps(doc) + "\n")

    def die(self, code):
        """The fault plan's hard exit: write the report first."""
        self.write(killed=True)
        os._exit(code)


def _serve_job_spec(cfg, **extra):
    """The standard serve-leg job spec (same survey as the batch legs)."""
    return dict({"files": cfg["files"], "fmt": "presto",
                 "deredden": dict(DERED), "search": SEARCH_CONF}, **extra)


def _serve_post_job(base, spec):
    import urllib.request

    req = urllib.request.Request(
        base + "/jobs", data=json.dumps(spec).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10.0) as resp:
        return json.loads(resp.read())["job_id"]


def _journal_incidents(serve_root, jid):
    """Incident kinds journaled in one job's own journal.jsonl."""
    path = os.path.join(serve_root, "jobs", jid, "journal.jsonl")
    if not os.path.exists(path):
        return set()
    entries, _ = fsio.scan_jsonl(path)
    return {obj.get("incident") for obj, _status, _off in entries
            if obj and obj.get("kind") == "incident"}


def _serve_daemon(cfg, rep, workers):
    """The leg's service daemon on the leg's device, its injected kills
    writing the leg's report first."""
    from ..ops import ffa_kernel
    from ..serve import ServeDaemon

    daemon = ServeDaemon(cfg["serve_root"], port=0, workers=workers,
                         device=cfg["device"], fault_exit=rep.die)
    rep.device = daemon.device.type
    ffa_kernel.reset_launches()
    rep.run_t0 = time.perf_counter()
    return daemon.start(), f"http://127.0.0.1:{daemon.port}"


def _serve_fetch_peaks(base, jid, path):
    import urllib.request

    with urllib.request.urlopen(f"{base}/jobs/{jid}/peaks",
                                timeout=10.0) as resp:
        payload = resp.read()
    with open(path, "wb") as fobj:
        fobj.write(payload)


def _serve_leg_main(cfg, rep):
    """One SERVE-mode leg: the survey service daemon runs in this leg
    process and the survey goes through it as a real HTTP job. The
    leg's faults are armed through ``RIPTIDE_FAULT_INJECT``, set in
    this leg's environment by the parent's :func:`_run_leg` (the
    daemon passes the flag into each job's scheduler), so a ``kill_at``
    drops the WHOLE daemon mid-job; the next leg's restart replays
    ``jobs.jsonl``, resumes the job from its own journal, and must
    serve a peaks.csv byte-identical to the control run's."""
    import urllib.request

    daemon, base = _serve_daemon(cfg, rep, workers=1)
    unfinished = [d for d in daemon.list()["jobs"]
                  if d.get("status") in ("pending", "running")]
    if unfinished:
        # Restart leg: start() already re-queued the interrupted job.
        jid = unfinished[0]["job_id"]
    else:
        jid = _serve_post_job(base, _serve_job_spec(cfg))
    deadline = time.monotonic() + 240.0
    status = None
    while time.monotonic() < deadline:
        with urllib.request.urlopen(f"{base}/jobs/{jid}",
                                    timeout=10.0) as resp:
            status = json.loads(resp.read()).get("status")
        if status in ("done", "failed", "cancelled"):
            break
        time.sleep(0.1)
    if status != "done":
        raise ChaosFailure(f"serve leg: job {jid} ended {status!r}")
    _serve_fetch_peaks(base, jid, cfg["peaks_csv"])
    daemon.stop()
    return 0


def _serve_drain_leg_main(cfg, rep):
    """Drain leg of ``serve-drain-mid-job``: submit the survey as a
    job, let it finish EXACTLY one chunk (a priority ``-1`` blocker
    gate steps the fair-share queue deterministically), then
    :meth:`ServeDaemon.drain` mid-job. Admission must answer 503 with a
    ``Retry-After`` hint, the workers must park within the drain
    budget, and the job must end the leg WITHOUT a terminal registry
    record — the restart leg re-queues it (``resumed``) and must serve
    a peaks.csv byte-identical to the control run's."""
    import threading
    import urllib.error

    from ..serve import JobDrained

    daemon, base = _serve_daemon(cfg, rep, workers=1)
    # The blocker holds the turn so the job parks at begin(0) while the
    # leg lines up the stepping.
    blocker = daemon.queue.register("blocker", priority=-1)
    blocker.begin(0)
    jid = _serve_post_job(base, _serve_job_spec(cfg))

    def _wait(pred, what, timeout=180.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.05)
        raise ChaosFailure(f"drain leg: timed out waiting for {what}")

    def _parked():
        return bool(daemon.queue.snapshot()["jobs"]
                    .get(jid, {}).get("waiting"))

    jpath = os.path.join(cfg["serve_root"], "jobs", jid, "journal.jsonl")

    def _chunks_done():
        if not os.path.exists(jpath):
            return 0
        entries, _ = fsio.scan_jsonl(jpath)
        return sum(1 for obj, _status, _off in entries
                   if obj and obj.get("kind") == "chunk")

    _wait(_parked, f"{jid} to park at its chunk gate")

    def _reblock():
        # Re-queue for the turn AFTER chunk 0's: at priority -1 the
        # blocker wins the next pick, so the job parks again at
        # begin(1) instead of running to completion. The drain below
        # unparks US too — swallow it.
        try:
            blocker.begin(1)
        except JobDrained:
            pass

    blocker.end(0)  # job takes the turn: chunk 0 dispatches
    # Queue the blocker again only once the job holds the turn (else
    # its priority could win this turn back before the job wakes).
    _wait(lambda: daemon.queue.snapshot()["active"] == jid,
          f"{jid} to take its turn")
    threading.Thread(target=_reblock, daemon=True,
                     name="chaos-drain-blocker").start()
    _wait(lambda: _chunks_done() >= 1, "chunk 0's journal record")
    _wait(_parked, f"{jid} to park mid-job")
    done = _chunks_done()
    if not 1 <= done < len(cfg["files"]):
        raise ChaosFailure(f"drain leg: {done} chunk(s) journaled "
                           "before the drain; wanted a mid-job park")

    daemon.drain()
    # Admission is closed the moment drain() returns.
    try:
        _serve_post_job(base, _serve_job_spec(cfg))
        raise ChaosFailure("drain leg: admission still open after drain")
    except urllib.error.HTTPError as err:
        if err.code != 503 or not err.headers.get("Retry-After"):
            raise ChaosFailure(
                f"drain leg: submit during drain answered {err.code} "
                f"(Retry-After {err.headers.get('Retry-After')!r}); "
                "expected 503 with a Retry-After hint")
    if not daemon.wait_drained(timeout=60.0):
        raise ChaosFailure("drain leg: workers did not park within the "
                           "drain budget")
    docs = {d["job_id"]: d for d in daemon.list()["jobs"]}
    status = docs.get(jid, {}).get("status")
    if status not in ("pending", "running"):
        raise ChaosFailure(
            f"drain leg: job {jid} ended the leg with terminal status "
            f"{status!r}; a drained job must stay resumable")
    daemon.stop()
    return 0


def _serve_device_error_leg_main(cfg, rep):
    """``serve-device-error``: two jobs share the warm daemon; the
    second carries a ``device_error:0x9`` spec fault — more firings
    than the per-job retry budget, so its chunk 0 exhausts the retry
    path (each retry finds the CUDA context usable) and the job fails.
    The failure must be CONTAINED: a ``device_error`` incident in the
    faulted job's own journal only, the clean sibling (j0001, the
    directory the campaign's invariants check) done, and the daemon
    still serving its peaks afterwards."""
    daemon, base = _serve_daemon(cfg, rep, workers=2)
    clean = _serve_post_job(base, _serve_job_spec(cfg))
    faulted = _serve_post_job(
        base, _serve_job_spec(cfg, fault_inject="device_error:0x9"))

    deadline = time.monotonic() + 240.0
    status = {}
    while time.monotonic() < deadline:
        docs = {d["job_id"]: d for d in daemon.list()["jobs"]}
        status = {jid: docs.get(jid, {}).get("status")
                  for jid in (clean, faulted)}
        if all(s in ("done", "failed", "cancelled")
               for s in status.values()):
            break
        time.sleep(0.1)
    if status.get(clean) != "done" or status.get(faulted) != "failed":
        raise ChaosFailure(
            "serve-device-error: wanted the clean job done and the "
            f"faulted job failed, got {status}")
    if daemon.device_lost:
        raise ChaosFailure("serve-device-error: an injected device error "
                           "was taken for a lost CUDA context")
    if "device_error" not in _journal_incidents(cfg["serve_root"],
                                                faulted):
        raise ChaosFailure(
            "serve-device-error: no device_error incident in the "
            "faulted job's journal")
    if "device_error" in _journal_incidents(cfg["serve_root"], clean):
        raise ChaosFailure(
            "serve-device-error: a device_error incident leaked into "
            "the clean job's journal")
    _serve_fetch_peaks(base, clean, cfg["peaks_csv"])
    daemon.stop()
    return 0


def _batch_leg_main(cfg, rep):
    """One batch leg: install the leg's fault plan into fsio and the
    journal as the incident sink, optionally probe the build cache, run
    the tiny survey through the checkpointed scheduler on the leg's
    device and write peaks.csv."""
    from ..obs import trace
    from ..ops import ffa_kernel
    from ..pipeline.batcher import BatchSearcher
    from ..serve.daemon import write_peaks_csv
    from . import incidents
    from .faults import FaultPlan
    from .journal import SurveyJournal
    from .scheduler import RetryPolicy, SurveyScheduler

    if cfg.get("trace"):
        trace.enable()
    faults = FaultPlan.parse(cfg.get("faults") or "", exit=rep.die)
    prev_hook = fsio.set_storage_faults(faults.storage_op)
    journal = SurveyJournal(cfg["journal"])
    prev_sink = incidents.set_sink(journal.record_incident)
    try:
        if cfg.get("cache_probe"):
            os.makedirs(cfg["cache_dir"], exist_ok=True)
            _cache_probe(cfg["cache_dir"], expect=cfg.get("cache_expect"),
                         reload_check=bool(cfg.get("cache_reload")))
        searcher = BatchSearcher(DERED, SEARCH_CONF, fmt="presto",
                                 io_threads=1, device=cfg["device"])
        rep.device = searcher.device.type
        ffa_kernel.reset_launches()
        scheduler = SurveyScheduler(
            searcher, [[f] for f in cfg["files"]], journal=journal,
            resume=bool(cfg.get("resume")), faults=faults,
            retry=RetryPolicy(max_retries=2, base_s=0.01, cap_s=0.05),
        )
        rep.run_t0 = time.perf_counter()
        peaks = scheduler.run()
        write_peaks_csv(peaks, cfg["peaks_csv"])
    finally:
        incidents.set_sink(prev_sink)
        fsio.set_storage_faults(prev_hook)
    return 0


def _leg_main(cfg_path):
    """One subprocess leg on the leg's device: a batch leg
    (:func:`_batch_leg_main`) or, for a serve schedule, the survey as a
    job of the service daemon (:func:`_serve_leg_main` and the drain
    and device-error variants). Writes the leg's report and returns 0 —
    unless an armed ``kill_at`` hard-exits mid-write first, which is
    the point (the plan's exit hook writes the report before it)."""
    with open(cfg_path) as fobj:
        cfg = json.load(fobj)
    logging.basicConfig(level="INFO")
    rep = _LegReport(cfg["out"])
    if not cfg.get("serve"):
        leg = _batch_leg_main
    elif cfg.get("serve_drain"):
        leg = _serve_drain_leg_main
    elif cfg.get("serve_device_error"):
        leg = _serve_device_error_leg_main
    else:
        leg = _serve_leg_main
    rc = leg(cfg, rep)
    rep.write(killed=False)
    return rc


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="chaos-campaign subprocess leg runner (drive whole "
                    "campaigns with python -m "
                    "riptide_tpu_torch.apps.rchaos)")
    parser.add_argument("--leg", required=True,
                        help="Path of the leg-config JSON written by "
                             "run_campaign")
    args = parser.parse_args(argv)
    return _leg_main(args.leg)


if __name__ == "__main__":
    sys.exit(main())
