"""
riplint over the port (``riptide_tpu_torch/analysis/lint/``, run by
``riptide_tpu_torch/apps/riplint.py``), on the CPU:

* the rules that need no torch form (RIP003, 004, 006, 009, 010, 012,
  013, 014) give the JAX package's findings (rule, line, column) on the
  JAX package's own fixtures, each placed under its package's prefix;
* the rules in torch form (RIP001, 002, 005, 007, 008, 011) each fail a
  bad fixture and pass a good one, and where a construct exists in both
  frameworks (``.item()``, ``.tolist()``, a numpy pull) give the JAX
  rule's findings;
* the port is clean against its own baseline (one full run for the
  whole file), every entry justified, the flag reference in sync;
* the runner behaves like ``tools/riplint.py``: exit codes, baseline
  absorption, stale entries, ``--prune-baseline``, the pragma, the
  nearby-line reflow, SARIF, ``--rule``, ``--list-rules``, stale scope
  lists failing loudly, and the rule ids and names of the JAX package;
* seeded regressions on copies of real port modules are each caught:
  a ``.cpu()`` one call below ``_queue_stages``, a raw
  ``dist.all_gather`` outside ``liveness.py``, a renamed journal key, a
  dropped ``chunk_gate.end``; and the repairs the rules forced (the
  walk's recording suspension) hold.
"""
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import threading

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "analysis_fixtures")
RUNNER = os.path.join(REPO, "riptide_tpu_torch", "apps", "riplint.py")
J, T = "riptide_tpu", "riptide_tpu_torch"


def _load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rl = _load_file("torch_riplint_under_test", RUNNER)
lint = rl.load_lint()
jax_analysis = _load_file(
    "jax_riplint_for_parity",
    os.path.join(REPO, "tools", "riplint.py")).load_analysis(REPO)
host_sync = sys.modules[f"{lint.__name__}.host_sync"]
interp = sys.modules[f"{lint.__name__}.interp_host_sync"]


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fobj:
        fobj.write(text)
    return path


def _copy(root, rel, src_rel=None):
    dest = os.path.join(root, rel)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    shutil.copy(os.path.join(REPO, src_rel or rel), dest)


def _fixture(name):
    with open(os.path.join(FIXTURES, name)) as fobj:
        return fobj.read()


def _keys(findings):
    return sorted((f.rule, f.line, f.col) for f in findings)


def _run(analysis, repo, analyzers):
    new, _, _ = analysis.run_analyzers(repo, analyzers,
                                       baseline=analysis.Baseline())
    return new


def _one(analysis, repo, analyzer, rel):
    return analyzer.run(analysis.ModuleContext(repo, rel))


# -- the neutral rules: the JAX package's findings ---------------------------

# (rule, destination under the package, bad, good, minimum bad findings,
#  factory(analysis, pkg), project-level)
NEUTRAL = [
    ("RIP003", "pipeline/fixture.py", "rip003_envflags_bad.py",
     "rip003_envflags_good.py", 4,
     lambda a, p: a.EnvFlagAnalyzer(), False),
    ("RIP004", "survey/liveness.py", "rip004_locks_bad.py",
     "rip004_locks_good.py", 5,
     lambda a, p: a.LockDisciplineAnalyzer(
         modules={f"{p}/survey/liveness.py"}), False),
    ("RIP006", "ops/snr.py", "rip006_finite_bad.py", "rip006_finite_good.py",
     1, lambda a, p: a.FiniteGuardAnalyzer(entry_points={
         f"{p}/ops/snr.py": ["boxcar_snr", "snr_batched"]}), False),
    ("RIP009", "survey/pairmod.py", "rip009_lockorder_bad.py",
     "rip009_lockorder_good.py", 3,
     lambda a, p: a.LockOrderAnalyzer(), True),
    ("RIP010", "survey/recmod.py", "rip010_schema_bad.py",
     "rip010_schema_good.py", 3,
     lambda a, p: a.RecordSchemaAnalyzer(
         writers=[(f"{p}/survey/recmod.py", "write_chunk", None),
                  (f"{p}/survey/recmod.py", "write_row", "ledger")],
         readers=[(f"{p}/survey/recmod.py", "read_chunks")]), True),
    ("RIP012", "serve/spawnmod.py", "rip012_runctx_bad.py",
     "rip012_runctx_good.py", 3,
     lambda a, p: a.RunctxDisciplineAnalyzer(), True),
    ("RIP013", "obs/writer.py", "rip013_fsio_bad.py", "rip013_fsio_good.py",
     4, lambda a, p: a.FsioDisciplineAnalyzer(), False),
    ("RIP014", "survey/gatemod.py", "rip014_gate_bad.py",
     "rip014_gate_good.py", 3,
     lambda a, p: a.GatePairingAnalyzer(), False),
]


def _neutral_repo(root, pkg, rel, fixture):
    """A throwaway repo holding ``fixture`` at ``pkg/rel`` and the
    package's anchors: its obs/schema.py, utils/runctx.py and
    survey/incidents.py, and the JAX package's flag registry at the
    package's registry path (one registry for both rules, so that the
    fixtures' flag names mean the same)."""
    _write(root, f"{pkg}/{rel}", _fixture(fixture))
    for anchor in ("obs/schema.py", "utils/runctx.py",
                   "survey/incidents.py"):
        _copy(root, f"{pkg}/{anchor}")
    _copy(root, f"{pkg}/utils/envflags.py", f"{J}/utils/envflags.py")
    return root


@pytest.mark.parametrize("rule,rel,bad,good,min_bad,factory,project",
                         NEUTRAL, ids=[c[0] for c in NEUTRAL])
def test_neutral_rule_matches_the_jax_rule(tmp_path, rule, rel, bad, good,
                                           min_bad, factory, project):
    for which, fixture in (("bad", bad), ("good", good)):
        got = {}
        for analysis, pkg in ((jax_analysis, J), (lint, T)):
            repo = _neutral_repo(str(tmp_path / which / pkg), pkg, rel,
                                 fixture)
            inst = factory(analysis, pkg)
            found = (_run(analysis, repo, [inst]) if project
                     else _one(analysis, repo, inst, f"{pkg}/{rel}"))
            assert all(f.rule == rule and f.path == f"{pkg}/{rel}"
                       for f in found), [f.gh() for f in found]
            got[pkg] = _keys(found)
        assert got[T] == got[J], (which, got)
        if which == "bad":
            assert len(got[T]) >= min_bad, got[T]
        else:
            assert got[T] == [], got[T]


# -- the rules in torch form: bad and good fixtures --------------------------

HOT_REL = f"{T}/search/engine.py"

RIP001_BAD = '''\
import numpy as np
import torch


def _queue_stages(plan, parts, flags):
    out = []
    for p in parts:
        n = p.sum().item()                 # scalar pull
        host = p.cpu()                     # copy to the host
        arr = p.numpy()                    # host view of a device tensor
        back = p.to("cpu")                 # copy to the host
        idx = torch.nonzero(p)             # data-dependent shape
        keep = p.masked_select(flags)      # data-dependent shape
        rep = torch.repeat_interleave(p, flags)  # sized from the device
        if torch.any(p > 0):               # a tensor as the condition
            out.append(int(p[0]))          # int() of a tensor
        torch.cuda.synchronize()           # waits for the card
        out.append(np.asarray(p))          # numpy pull
        out.append((n, host, arr, back, idx, keep, rep))
    return out
'''

RIP001_GOOD = '''\
import torch


def _queue_stages(plan, parts, flags):
    out = []
    for p in parts:
        rows = int(p.shape[0])             # host metadata
        k = int(len(parts)) + int(p.numel())
        rep = torch.repeat_interleave(p, flags, output_size=rows)
        twice = torch.repeat_interleave(p, 2)
        out.append(torch.where(p > 0, p, twice[:rows]) + rep + k)
    return out
'''

RIP002_BAD = '''\
import numpy as np
import torch


def prefix(data, pad, n):
    cs = torch.cumsum(data, dim=-1)      # accumulator dtype unstated
    cs2 = data.cumsum(-1)                # method form, no dtype
    buf = np.zeros(pad)                  # silent float64
    idx = torch.arange(n)                # index dtype unstated
    z = torch.zeros(3, 4)                # positional sizes, no dtype
    t = torch.tensor([1.0, 2.0])         # default dtype decides
    return cs, cs2, buf, idx, z, t
'''

RIP002_GOOD = '''\
import numpy as np
import torch


def prefix(data, pad, n):
    cs = torch.cumsum(data, dim=-1, dtype=torch.float64)
    cs2 = data.cumsum(-1, dtype=torch.float32)
    buf = np.zeros(pad, np.float32)
    idx = torch.arange(n, dtype=torch.int64)
    z = torch.zeros(3, 4, dtype=torch.float32)
    t = torch.tensor([1.0, 2.0], dtype=torch.float32)
    return cs, cs2, buf, idx, z, t
'''

RIP005_BAD = '''\
import os
import random
import time


def _check_x(x):
    if x.dim() != 2:
        raise ValueError("x")


def _launch(fn, dev, *args):
    return getattr(LIB, fn)(*args, stream(dev))


def unchecked(x):
    return _launch("rt_a", x.device, x.data_ptr())


def late(x):
    _launch("rt_a", x.device, x.data_ptr())
    _check_x(x)


def helper(lib, x, stream):
    return lib.rt_b(x.data_ptr(), stream)


def unchecked_caller(lib, x, stream):
    return helper(lib, x, stream)


def noisy(lib, x, stream):
    _check_x(x)
    grid = int(time.time()) % 7
    return lib.rt_b(x.data_ptr(), grid, random.random(), stream)


def env_smem(lib, x, stream):
    _check_x(x)
    return lib.rt_c(x.data_ptr(), int(os.environ["SMEM"]),
                    *{1, 2}, stream)
'''

RIP005_GOOD = '''\
import torch


def _check_x(x):
    if x.dim() != 2:
        raise ValueError("x")


def _launch(fn, dev, *args):
    return getattr(LIB, fn)(*args, stream(dev))


def checked(x):
    _check_x(x)
    out = torch.empty_like(x)
    _launch("rt_a", x.device, x.data_ptr(), out.data_ptr(), x.shape[0])
    return out


def helper(lib, x, stream):
    return lib.rt_b(x.data_ptr(), stream)


def checked_caller(lib, x, stream):
    _check_x(x)
    return helper(lib, x, stream)


def own_buffer(dev):
    out = torch.empty(64, dtype=torch.float32, device=dev)
    _launch("rt_a", dev, out.data_ptr(), 64)
    return out


def query(lib):
    return lib.rt_probe_code(b"add")
'''

RIP007_BAD = '''\
import torch
import torch.distributed as dist
from torch import distributed as tdist
from torch.distributed import all_reduce


def gather(x, outs):
    dist.all_gather(outs, x)                  # raw collective


def later(x):
    return bounded_wait(tdist.barrier, 5.0)   # a collective as a callable


def dotted(x):
    torch.distributed.broadcast(x, 0)         # the dotted form


def ok(x, outs):
    # The allowed wrapper (tests allowlist this function name).
    def inner():
        dist.all_gather(outs, x)
    return bounded_wait(inner, 5.0)
'''

RIP007_GOOD = '''\
import torch.distributed as dist


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def ok(x, outs):
    def inner():
        dist.all_gather(outs, x)
    return bounded_wait(inner, 5.0), bounded_wait(dist.barrier, 5.0)
'''

RIP008_BAD = '''\
from riptide_tpu_torch.obs.trace import span
from riptide_tpu_torch.utils import envflags


def leaky(x):
    s = span("phase", chunk=1)
    s.__enter__()
    return x


def _launch(fn, dev, *args):
    with span("launch"):
        return _raw(fn, args)


def _raw(fn, args):
    with span("raw"):
        return fn(*args)


RING = envflags.get("RIPTIDE_TRACE_BOGUS")
'''

RIP008_GOOD = '''\
from riptide_tpu_torch.obs.trace import span
from riptide_tpu_torch.utils import envflags


def traced(x):
    with span("phase", chunk=1):
        return _launch("rt_a", x)


def _launch(fn, *args):
    return fn(*args)


RING = envflags.get("RIPTIDE_TRACE")
'''

RIP011_BAD = '''\
import numpy as np
import torch


def _deep(x):
    return np.asarray(x).sum()


def _peak_value(x):
    return x.max().item() + _deep(x)


def _wait(x):
    torch.cuda.synchronize()
    return torch.unique(x)


def _queue_stages(plan, x):
    _launch(_wait, x)
    return _peak_value(x)


def _launch(fn, x):
    return fn(x)
'''

RIP011_GOOD = '''\
import torch


def _scale(x):
    return x * float(2)


def _queue_stages(plan, x):
    return _scale(torch.where(x > 0, x, 0))
'''

_SYNC_ROOTS = {f"{HOT_REL}::_queue_stages": "the stage loop"}

# (rule, relpath, bad, good, minimum bad findings, factory, project)
TORCH_FORM = [
    ("RIP001", HOT_REL, RIP001_BAD, RIP001_GOOD, 11,
     lambda: lint.HostSyncAnalyzer(
         hot_functions={HOT_REL: {"_queue_stages"}}), False),
    ("RIP002", f"{T}/ops/fixture.py", RIP002_BAD, RIP002_GOOD, 6,
     lambda: lint.DtypeDisciplineAnalyzer(scope=set()), False),
    ("RIP005", f"{T}/probes/kern.py", RIP005_BAD, RIP005_GOOD, 5,
     lambda: lint.LaunchLayoutAnalyzer(
         gateways={f"{T}/probes/kern.py::_launch"}), True),
    ("RIP007", f"{T}/parallel/mh.py", RIP007_BAD, RIP007_GOOD, 4,
     lambda: lint.LivenessGuardAnalyzer(
         allowed={f"{T}/parallel/mh.py": {"ok"}}), False),
    ("RIP008", f"{T}/probes/common.py", RIP008_BAD, RIP008_GOOD, 4,
     lambda: lint.ObsDisciplineAnalyzer(), False),
    ("RIP011", HOT_REL, RIP011_BAD, RIP011_GOOD, 4,
     lambda: lint.InterpHostSyncAnalyzer(
         roots=_SYNC_ROOTS, hot_functions={HOT_REL: {"_queue_stages"}}),
     True),
]


def _torch_repo(root, rel, text):
    _write(root, rel, text)
    _copy(root, f"{T}/utils/envflags.py")
    return root


@pytest.mark.parametrize("rule,rel,bad,good,min_bad,factory,project",
                         TORCH_FORM, ids=[c[0] for c in TORCH_FORM])
def test_torch_form_fails_bad_and_passes_good(tmp_path, rule, rel, bad,
                                              good, min_bad, factory,
                                              project):
    for which, text in (("bad", bad), ("good", good)):
        repo = _torch_repo(str(tmp_path / which), rel, text)
        inst = factory()
        found = (_run(lint, repo, [inst]) if project
                 else _one(lint, repo, inst, rel))
        found = [f for f in found if f.path == rel]
        assert all(f.rule == rule and f.line >= 1 for f in found)
        if which == "bad":
            assert len(found) >= min_bad, [f.gh() for f in found]
        else:
            assert found == [], "\n".join(f.gh() for f in found)


SHARED_HOT = '''\
import numpy as np


def _queue_stages(plan, parts):
    out = []
    for p in parts:
        out.append(p.sum().item())
        out.append(p.tolist())
        out.append(np.asarray(p))
        out.append(np.ascontiguousarray(p, dtype=np.float32))
    return out
'''

SHARED_DEEP = '''\
import jax
import numpy as np


def _deep(x):
    return np.array(x).sum() + x.tolist()[0]


def _peak(x):
    return x.max().item() + _deep(x)


@jax.jit
def _queue_stages(x):
    return _peak(x)
'''


def test_shared_constructs_give_the_jax_findings(tmp_path):
    """``.item()``, ``.tolist()`` and the numpy pulls exist in both
    frameworks: RIP001 on a hot body and RIP011 one and two calls below
    a root give the JAX rules' (rule, line, column) findings."""
    got = {}
    for analysis, pkg in ((jax_analysis, J), (lint, T)):
        rel = f"{pkg}/search/engine.py"
        repo = str(tmp_path / pkg / "hot")
        _write(repo, rel, SHARED_HOT)
        hot = analysis.HostSyncAnalyzer(hot_functions={rel: {"_queue_stages"}})
        got[pkg, "hot"] = _keys(_one(analysis, repo, hot, rel))
        repo = str(tmp_path / pkg / "deep")
        _write(repo, rel, SHARED_DEEP)
        deep = (analysis.InterpHostSyncAnalyzer() if pkg == J else
                analysis.InterpHostSyncAnalyzer(
                    roots={f"{rel}::_queue_stages": "the stage loop"},
                    hot_functions={}))
        got[pkg, "deep"] = _keys(_run(analysis, repo, [deep]))
    assert got[T, "hot"] == got[J, "hot"] and len(got[T, "hot"]) == 4
    assert got[T, "deep"] == got[J, "deep"] and len(got[T, "deep"]) == 3


def test_blocking_host_copies_are_syncs(tmp_path):
    """A copy of a host tensor to the card without ``non_blocking`` waits
    for the copy (PyTorch synchronises a pageable copy): the torch form
    flags ``torch.from_numpy(a).to(dev)``, ``torch.tensor(x, device=)``
    and ``torch.as_tensor(x, device=)``, not the non-blocking copy."""
    rel = HOT_REL
    repo = str(tmp_path)
    _write(repo, rel, '''\
import torch


def _queue_stages(a, dev, x):
    w = torch.from_numpy(a).to(dev)
    s = torch.tensor([3], dtype=torch.int64, device=dev)
    t = torch.as_tensor(a, dtype=torch.float32, device=dev)
    ok = torch.from_numpy(a).to(dev, non_blocking=True)
    same = x.to(dev)
    return w, s, t, ok, same
''')
    found = _one(lint, repo, lint.HostSyncAnalyzer(
        hot_functions={rel: {"_queue_stages"}}), rel)
    assert [f.line for f in found] == [5, 6, 7], [f.gh() for f in found]


def test_interp_reaches_what_the_card_reported(tmp_path):
    """The two false negatives the card's sync report showed (the peak
    program's and the stage operands' blocking copies): RIP011 reaches a
    private method that one class alone defines, called on an untyped
    parameter (``peak_plan._fused``), and a function nested in its
    caller (``_operands``'s ``dev``)."""
    repo = str(tmp_path)
    _write(repo, HOT_REL, '''\
import numpy as np
import torch


class PeakPlan:
    def _fused(self, snr):
        return snr * torch.from_numpy(self.fitmat).to(snr.device)


def _upload(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _operands(b, device):
    def dev(a):
        return _upload(a, device)
    return dev(b)


def _queue_stages(peak_plan, snr, b):
    return peak_plan._fused(snr), _operands(b, snr.device)
''')
    found = _run(lint, repo, [lint.InterpHostSyncAnalyzer(
        roots=_SYNC_ROOTS, hot_functions={})])
    where = {(f.line, f.message.split("inside `")[1].split("`")[0])
             for f in found}
    assert where == {(7, "PeakPlan._fused"), (11, "_upload")}, \
        [f.gh() for f in found]


# -- the port against its baseline -------------------------------------------

@pytest.fixture(scope="module")
def full_run():
    """One full run of the port's lint (about 10 s), shared by the
    file; it primes the result cache the later runs replay."""
    out, err = io.StringIO(), io.StringIO()
    code = rl.run(out=out, err=err, use_cache=False)
    rl.run(out=io.StringIO(), err=io.StringIO())
    return code, out.getvalue(), err.getvalue()


def test_port_is_clean_against_its_baseline(full_run):
    code, out, err = full_run
    assert code == 0, out + err
    assert "riplint OK: 14 analyzers" in err and "0 new findings" in err


def test_baseline_entries_are_justified():
    with open(rl.DEFAULT_BASELINE) as fobj:
        entries = json.load(fobj)["entries"]
    assert entries
    for e in entries:
        assert e["path"].startswith(f"{T}/"), e
        assert e["why"] and "TODO" not in e["why"], e


def test_runner_by_path_with_torch_numpy_jax_blocked(tmp_path, full_run):
    """The runner runs by path from any directory with neither torch,
    numpy nor jax importable, exit 0 on the clean port (a replay of the
    primed cache), and names the same rules with --list-rules."""
    code = ("import runpy, sys\n"
            "for name in ('torch', 'numpy', 'jax', 'jaxlib'):\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = [{RUNNER!r}] + sys.argv[1:]\n"
            f"runpy.run_path({RUNNER!r}, run_name='__main__')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "riplint OK" in proc.stderr
    proc = subprocess.run([sys.executable, "-c", code, "--list-rules"],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=120)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert [ln.split()[0] for ln in lines] == \
        [f"RIP{n:03d}" for n in range(1, 15)]


def test_rule_ids_and_names_are_the_jax_packages():
    mine = [(a.rule, a.name) for a in lint.ALL_ANALYZERS]
    theirs = [(a.rule, a.name) for a in jax_analysis.ALL_ANALYZERS]
    assert mine == theirs and len(mine) == 14


def test_sarif_output(full_run):
    out = io.StringIO()
    assert rl.run(out=out, err=io.StringIO(), fmt="sarif") == 0
    doc = json.loads(out.getvalue())
    run = doc["runs"][0]
    assert doc["version"] == "2.1.0"
    assert run["tool"]["driver"]["name"] == "riplint"
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == \
        [f"RIP{n:03d}" for n in range(1, 15)]
    assert run["results"] == []


def test_env_docs_in_sync_with_the_registry():
    registry = lint.env_flags.load_registry(REPO)
    with open(os.path.join(REPO, lint.env_flags.DOCS_REL)) as fobj:
        assert fobj.read() == registry.render_markdown()
    assert lint.env_flags.DOCS_REL.startswith(f"{T}/")


def test_rule_option_runs_one_rule_and_keeps_other_entries(tmp_path):
    """``--rule RIP006`` and ``--rule RIP007`` stand in for the JAX
    package's two guard scripts: the one rule runs, the other rules'
    baseline entries are neither stale nor dropped by a prune."""
    for rule in ("RIP006", "RIP007"):
        err = io.StringIO()
        code = rl.run(analyzers=rl.select(lint, [rule]), out=io.StringIO(),
                      err=err)
        assert code == 0 and "1 analyzers" in err.getvalue(), err.getvalue()
    bl = tmp_path / "bl.json"
    shutil.copy(rl.DEFAULT_BASELINE, bl)
    n = len(json.loads(bl.read_text())["entries"])
    assert rl.run(baseline_path=str(bl), analyzers=rl.select(lint, ["RIP013"]),
                  prune_baseline=True, out=io.StringIO(),
                  err=io.StringIO()) == 0
    assert len(json.loads(bl.read_text())["entries"]) == n
    with pytest.raises(ValueError, match="RIP099"):
        rl.select(lint, ["RIP099"])


def _fsio_repo(tmp_path):
    rel = f"{T}/obs/writer.py"
    repo = str(tmp_path)
    _write(repo, rel, _fixture("rip013_fsio_bad.py"))
    return repo, rel


def test_baseline_absorbs_stale_and_prune(tmp_path):
    """--update-baseline absorbs every finding, an entry matching
    nothing reads as stale (exit 1), --prune-baseline drops it alone and
    the plain rerun is clean; a prune with new findings still fails."""
    repo, rel = _fsio_repo(tmp_path)
    analyzers = [lint.FsioDisciplineAnalyzer]
    bl = tmp_path / "baseline.json"
    out = io.StringIO()
    assert rl.run(repo=repo, baseline_path=str(bl), analyzers=analyzers,
                  out=out, err=io.StringIO()) == 1
    assert f"{rel}:" in out.getvalue() and " RIP013 " in out.getvalue()
    assert rl.run(repo=repo, baseline_path=str(bl), analyzers=analyzers,
                  update_baseline=True, out=io.StringIO(),
                  err=io.StringIO()) == 0
    entries = json.loads(bl.read_text())["entries"]
    assert len(entries) >= 4
    bogus = {"rule": "RIP013", "path": rel,
             "line_text": "this_line_does_not_exist()", "why": "gone"}
    bl.write_text(json.dumps({"entries": entries + [bogus]}))
    out = io.StringIO()
    assert rl.run(repo=repo, baseline_path=str(bl), analyzers=analyzers,
                  out=out, err=io.StringIO()) == 1
    assert "STALE" in out.getvalue()
    err = io.StringIO()
    assert rl.run(repo=repo, baseline_path=str(bl), analyzers=analyzers,
                  prune_baseline=True, out=io.StringIO(), err=err) == 0
    assert "baseline pruned" in err.getvalue()
    assert json.loads(bl.read_text())["entries"] == entries
    assert rl.run(repo=repo, baseline_path=str(bl), analyzers=analyzers,
                  out=io.StringIO(), err=io.StringIO()) == 0
    bl.write_text(json.dumps({"entries": [bogus]}))
    assert rl.run(repo=repo, baseline_path=str(bl), analyzers=analyzers,
                  prune_baseline=True, out=io.StringIO(),
                  err=io.StringIO()) == 1
    assert json.loads(bl.read_text())["entries"] == []


def test_pragma_and_nearby_reflow(tmp_path):
    rel = f"{T}/survey/liveness.py"
    repo = str(tmp_path)
    _write(repo, rel, "def shutdown(done, worker):\n"
                      "    done.wait()  # riplint: disable=RIP004\n"
                      "    worker.join()\n")
    inst = [lint.LockDisciplineAnalyzer(modules={rel})]
    new, _, _ = lint.run_analyzers(repo, inst, baseline=lint.Baseline())
    assert len(new) == 1 and "join" in new[0].message
    # An entry whose text survives within three lines of a finding whose
    # own text is a fragment of it absorbs the finding, not stale ...
    _write(repo, rel, "def drain(worker):\n"
                      "    worker.join()  # riplint: disable=RIP004\n"
                      "    worker.join()\n")
    nearby = [{"rule": "RIP004", "path": rel,
               "line_text": "worker.join()  # riplint: disable=RIP004",
               "why": "reflow"}]
    new, baselined, stale = lint.run_analyzers(
        repo, inst, baseline=lint.Baseline(nearby))
    assert new == [] and len(baselined) == 1 and stale == []
    # ... and an unrelated neighbour is not swallowed.
    _write(repo, rel, "def drain(worker, other):\n"
                      "    worker.join()  # riplint: disable=RIP004\n"
                      "    other.join()\n")
    new, baselined, stale = lint.run_analyzers(
        repo, inst, baseline=lint.Baseline(nearby))
    assert len(new) == 1 and new[0].line == 3 and stale == nearby


def test_scope_lists_fail_loudly_when_stale(tmp_path):
    """A renamed module or function of a scope list is a finding, not a
    silently unscoped rule: RIP001's hot set, RIP002's and RIP004's
    modules, RIP005's gateway, RIP008's launch sequence and RIP011's
    roots."""
    repo = str(tmp_path)
    _write(repo, HOT_REL, "def renamed_queue_stages():\n    pass\n")
    _write(repo, f"{T}/probes/common.py", "def renamed_launch():\n"
                                           "    pass\n")
    new = _run(lint, repo, [lint.HostSyncAnalyzer,
                            lint.DtypeDisciplineAnalyzer,
                            lint.LockDisciplineAnalyzer,
                            lint.LaunchLayoutAnalyzer,
                            lint.ObsDisciplineAnalyzer,
                            lint.InterpHostSyncAnalyzer])
    msgs = [f.gh() for f in new]
    for rule, what in (("RIP001", "_queue_stages"), ("RIP001", "batcher.py"),
                       ("RIP002", "peaks_device.py"),
                       ("RIP004", "liveness.py"), ("RIP005", "_launch"),
                       ("RIP005", "ffa_kernel.py"), ("RIP008", "_launch"),
                       ("RIP011", "queue_find_peaks")):
        assert any(rule in m and what in m and "stale" in m for m in msgs), \
            (rule, what, msgs)


def test_liveness_vacuity_and_reset(tmp_path):
    """No collective inside the wrappers means the rule has gone
    vacuous; a reused instance does not carry the count over."""
    rel = f"{T}/parallel/mh.py"
    good = str(tmp_path / "a")
    _write(good, rel, RIP007_GOOD)
    empty = str(tmp_path / "b")
    _write(empty, f"{T}/empty.py", "x = 1\n")
    inst = lint.LivenessGuardAnalyzer(allowed={rel: {"ok"}})
    assert _run(lint, good, [inst]) == []
    new = _run(lint, empty, [inst])
    assert len(new) == 1 and "vacuous" in new[0].message


# -- seeded regressions on copies of real port modules -----------------------

def _patched(path, old, new):
    with open(path) as fobj:
        src = fobj.read()
    assert old in src, f"patch anchor missing from {path}: {old!r}"
    with open(path, "w") as fobj:
        fobj.write(src.replace(old, new))


def test_cpu_pull_one_call_below_the_stage_loop(tmp_path):
    """A ``.cpu()`` moved into a helper of ``_queue_stages`` passes
    RIP001's body scan and is caught by RIP011, the chain named."""
    repo = str(tmp_path)
    _copy(repo, HOT_REL)
    analyzers = [lint.HostSyncAnalyzer(hot_functions={
        HOT_REL: set(host_sync.HOT_FUNCTIONS[HOT_REL])}),
        lint.InterpHostSyncAnalyzer(roots={
            k: v for k, v in interp.ROOTS.items() if k.startswith(HOT_REL)})]
    before = _run(lint, repo, analyzers)
    _patched(os.path.join(repo, HOT_REL),
             "    lay = launch_layout(plan, meta[\"mode\"])\n",
             "    _peek(wire)\n"
             "    lay = launch_layout(plan, meta[\"mode\"])\n")
    with open(os.path.join(repo, HOT_REL), "a") as fobj:
        fobj.write("\n\ndef _peek(wire):\n    return wire.cpu()\n")
    after = _run(lint, repo, analyzers)
    new = [f for f in after if "_peek" in f.message]
    assert len(after) == len(before) + 1
    assert len(new) == 1 and new[0].rule == "RIP011", [f.gh() for f in new]
    assert "_queue_stages -> _peek" in new[0].message


def test_raw_all_gather_outside_liveness(tmp_path):
    rels = [f"{T}/survey/liveness.py", f"{T}/parallel/multihost.py"]
    repo = str(tmp_path)
    for rel in rels:
        _copy(repo, rel)
    assert _run(lint, repo, [lint.LivenessGuardAnalyzer]) == []
    with open(os.path.join(repo, rels[1]), "a") as fobj:
        fobj.write("\n\ndef _raw_gather(outs, src):\n"
                   "    import torch.distributed as dist\n"
                   "    dist.all_gather(outs, src)\n")
    new = _run(lint, repo, [lint.LivenessGuardAnalyzer])
    assert len(new) == 1 and new[0].path == rels[1], [f.gh() for f in new]
    assert "all_gather" in new[0].message


def test_renamed_journal_key(tmp_path):
    rel = f"{T}/survey/journal.py"
    repo = str(tmp_path)
    _copy(repo, rel)
    writers = [(rel, q, f) for q, f in [
        ("SurveyJournal.write_header", None),
        ("SurveyJournal.record_chunk", None),
        ("SurveyJournal.record_parked", None),
        ("SurveyJournal.record_metrics", None),
        ("SurveyJournal.record_incident", "incident"),
        ("SurveyJournal.heartbeat", "heartbeat"),
    ]]

    def run_schema():
        return _run(lint, repo, [lint.RecordSchemaAnalyzer(
            writers=writers, readers=[(rel, None)])])

    assert run_schema() == [], [f.gh() for f in run_schema()]
    _patched(os.path.join(repo, rel), '"peaks_offset": offset,',
             '"peak_off": offset,')
    new = run_schema()
    assert any("'peaks_offset'" in f.message and f.rule == "RIP010"
               for f in new), [f.gh() for f in new]


def test_dropped_chunk_gate_end(tmp_path):
    rel = f"{T}/survey/scheduler.py"
    repo = str(tmp_path)
    _copy(repo, rel)
    assert _one(lint, repo, lint.GatePairingAnalyzer(), rel) == []
    _patched(os.path.join(repo, rel), "self.chunk_gate.end(cid)", "pass")
    new = _one(lint, repo, lint.GatePairingAnalyzer(), rel)
    assert len(new) == 1 and new[0].rule == "RIP014", [f.gh() for f in new]
    assert "begin" in new[0].message


# -- the repairs the rules forced --------------------------------------------

def test_walk_hides_a_recording_from_its_own_thread_only():
    """RIP009 found ``_RECORD`` written lock-free by ``recording()`` and
    under the walk's lock by ``walk_search``. The walk now hides the
    recording from its own thread alone: a recording on another thread
    goes on through the walk, and one that closes during the walk stays
    closed (the walk used to restore it)."""
    import numpy as np
    import torch  # noqa: F401

    from riptide_tpu_torch.search import engine, periodogram_plan

    plan = periodogram_plan(2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)
    inside, resume, seen = threading.Event(), threading.Event(), []
    real = engine._queue_batch

    def paused(*a, **k):
        seen.append(engine._recorder())
        inside.set()
        assert resume.wait(60)
        return real(*a, **k)

    engine._queue_batch = paused
    try:
        with engine.recording() as rec:
            walker = threading.Thread(target=engine.walk_search,
                                      args=(plan, 2), kwargs={"survey": False},
                                      daemon=True)
            walker.start()
            assert inside.wait(60)
            assert engine._recorder() is rec and seen == [None]
        resume.set()
        walker.join(60)
        assert not walker.is_alive()
    finally:
        engine._queue_batch = real
    assert engine._RECORD is None and engine._recorder() is None
    with engine.recording() as rec:
        engine.walk_search(plan, 1, survey=False)
        engine.run_periodogram(plan, np.zeros(plan.size, np.float32),
                               device="cpu")
    assert "stages_s" in rec and engine._RECORD is None


def test_analyze_merges_runs_and_takes_the_worst_exit(tmp_path, full_run):
    """``apps/analyze.py`` merges each tool's SARIF run into one
    document; a tool that dies without SARIF adds no run, and the exit
    code is the worst of them."""
    analyze = _load_file("torch_analyze_under_test",
                         os.path.join(REPO, T, "apps", "analyze.py"))
    out = tmp_path / "merged.sarif"
    tools = (("riplint", [RUNNER, "--format", "sarif"]),
             ("broken", ["-c", "import sys; sys.exit(2)"]))
    assert analyze.main(str(out), tools=tools) == 2
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0" and len(doc["runs"]) == 1
    assert doc["runs"][0]["tool"]["driver"]["name"] == "riplint"
    assert analyze.main(str(out), tools=tools[:1]) == 0
