"""
The port's schedule-exploration model checker
(``riptide_tpu_torch/analysis/sched.py``, ``python -m
riptide_tpu_torch.apps.ripsched``) on the CPU: the JAX package's cases
(``tests/test_ripsched.py``) over the port's protocols, plus its two
models of protocol the port added, and the JAX package's explorer beside
it.

* The four shared models (fairshare, staging, runctx, quarantine) run
  protocol code whose decision points are the JAX package's: the port's
  ``FairShareQueue.begin``/``end`` take the same locks and waits (its
  stop checks moved into ``_check_stop``, no new decision point), its
  ``StagingPool.acquire``/``release`` take the lock once each as the JAX
  ``_StagingPool``'s do (the port's pool releases with a copy event,
  None in this model), and ``utils/runctx.py`` is the JAX file's code.
  So each explores the same number of schedules and decisions, and each
  JAX mutation's first violating schedule ID is the same.
* ``devicelost`` (``FairShareQueue.lose_device``) and ``staging_events``
  (``StagingPool.acquire``'s event-gated reuse; ``event.query()`` is a
  decision point and a copy stream is a fourth task) have no JAX
  counterpart; their mutations ``lost_no_notify`` and ``ignore_event``
  must be found.
"""
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from riptide_tpu_torch.analysis import sched
from riptide_tpu_torch.apps import ripsched

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SPECS = os.path.join(REPO, "riptide_tpu_torch", "analysis",
                     "ripsched_invariants.json")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("ref_sched_for_port_tests",
            os.path.join(REPO, "riptide_tpu", "analysis", "sched.py"))

SHARED = ("fairshare", "quarantine", "runctx", "staging")
NEW = {"devicelost": "lost_no_notify", "staging_events": "ignore_event"}


# -- registry + spec pin ----------------------------------------------------

def test_model_registry_shape():
    """The JAX package's 4 models, 18 invariants and 8 mutations, plus
    the port's two models (8 invariants, 2 mutations)."""
    assert sorted(sched.MODELS) == sorted(SHARED + tuple(NEW))
    n_inv = sum(len(m.invariants) for m in sched.MODELS.values())
    n_mut = sum(len(m.mutations) for m in sched.MODELS.values())
    assert n_inv == 26 and n_mut == 10
    for name in SHARED:
        assert sched.MODELS[name].invariants == ref.MODELS[name].invariants
        assert sched.MODELS[name].mutations == ref.MODELS[name].mutations
    for spec_ in sched.MODELS.values():
        assert all(t.startswith("riptide_tpu_torch/")
                   for t in spec_.targets)
        for inv, desc in spec_.invariants:
            assert inv in sched._INV and desc
            assert sched.sarif_rule_of(inv).startswith("RIPS")
    assert sched.SARIF_RULES == ref.SARIF_RULES


def test_spec_doc_matches_pinned_file():
    with open(SPECS) as fobj:
        assert json.load(fobj) == sched.spec_doc()


def test_spec_drift_refused_with_repin_instruction(tmp_path):
    doc = sched.spec_doc()
    doc["models"]["fairshare"]["invariants"].pop()
    drifted = tmp_path / "specs.json"
    drifted.write_text(json.dumps(doc))
    err = io.StringIO()
    assert ripsched.run(models=["staging"], specs_path=str(drifted),
                        out=io.StringIO(), err=err) == 2
    assert "--write-specs" in err.getvalue()
    err2 = io.StringIO()
    assert ripsched.run(models=["staging"],
                        specs_path=str(tmp_path / "absent.json"),
                        out=io.StringIO(), err=err2) == 2
    assert "--write-specs" in err2.getvalue()
    err3 = io.StringIO()
    assert ripsched.run(do_write_specs=True, specs_path=str(drifted),
                        err=err3) == 0
    assert "pinned 6 model(s) / 26 invariant(s)" in err3.getvalue()
    assert json.loads(drifted.read_text()) == sched.spec_doc()


# -- the shared models against the JAX package's explorer -------------------

@pytest.mark.parametrize("model,bound", [("fairshare", 0), ("runctx", 1),
                                         ("staging", 1), ("quarantine", 1)])
def test_shared_models_explore_as_the_reference(model, bound):
    """Exhaustive at the bound (no cap reached): the same schedules and
    decisions as the JAX package's explorer, and no violation."""
    port = sched.explore_model(model, bound=bound, max_schedules=0)
    want = ref.explore_model(model, bound=bound, max_schedules=0)
    assert not port.capped and not want.capped
    assert (port.schedules, port.decisions) == \
        (want.schedules, want.decisions)
    assert port.violation is None and want.violation is None


REF_MUTATIONS = [(name, mut) for name in SHARED
                 for mut in sorted(ref.MODELS[name].mutations)]


@pytest.mark.parametrize("model,mut", REF_MUTATIONS,
                         ids=[f"{m}+{u}" for m, u in REF_MUTATIONS])
def test_reference_mutations_found_at_the_same_schedule(model, mut):
    port = sched.explore_model(model, mutation=mut)
    want = ref.explore_model(model, mutation=mut)
    assert port.violation is not None, f"{model}+{mut} not found"
    assert port.violation.invariant == want.violation.invariant
    assert port.violation.schedule_id == want.violation.schedule_id
    assert port.schedules == want.schedules


# -- the port's own protocols -----------------------------------------------

@pytest.mark.parametrize("model", sorted(NEW))
def test_new_mutation_is_found(model):
    mut = NEW[model]
    res = sched.explore_model(model, mutation=mut)
    vio = res.violation
    assert vio is not None, f"{model}+{mut}: {res.schedules} schedules " \
        "explored without a violation — the checker is vacuous for it"
    assert vio.invariant in [i for i, _ in sched.MODELS[model].invariants]
    assert sched.parse_schedule_id(vio.schedule_id)[:2] == (model, mut)
    rep = sched.replay(vio.schedule_id)
    assert rep.violation is not None and rep.diverged is None


@pytest.mark.parametrize("model", sorted(NEW))
def test_new_model_explores_clean(model):
    res = sched.explore_model(model, max_schedules=150)
    assert res.violation is None, res.violation.render()
    assert res.schedules >= 1 and res.decisions >= 1


def test_lost_no_notify_is_a_lost_wakeup():
    vio = sched.explore_model("devicelost",
                              mutation="lost_no_notify").violation
    assert vio.invariant == "no-lost-wakeup"


def test_ignore_event_hands_out_a_buffer_in_copy():
    vio = sched.explore_model("staging_events",
                              mutation="ignore_event").violation
    assert vio.invariant == "staging-copy-complete"
    assert "has not completed" in vio.message


# -- determinism ------------------------------------------------------------

def test_replay_is_byte_identical_across_runs():
    sid = sched.explore_model("fairshare",
                              mutation="drop_notify").violation.schedule_id
    first, second = sched.replay(sid).render(), sched.replay(sid).render()
    assert first == second and sid in first


def test_malformed_schedule_id_rejected():
    with pytest.raises(ValueError, match="malformed schedule id"):
        sched.parse_schedule_id("bogus")
    with pytest.raises(ValueError, match="unknown model"):
        sched.parse_schedule_id("nosuchmodel:000")
    with pytest.raises(ValueError, match="unknown mutation"):
        sched.parse_schedule_id("fairshare+nosuch:000")
    with pytest.raises(ValueError, match="malformed schedule digits"):
        sched.parse_schedule_id("fairshare:12a")
    with pytest.raises(ValueError, match="unknown model"):
        sched.explore_model("nosuchmodel")
    with pytest.raises(ValueError, match="unknown mutation"):
        sched.explore_model("fairshare", mutation="nosuchmutation")


def test_env_defaults_come_from_the_registry():
    assert int(sched.env_default("RIPTIDE_SCHED_BOUND")) == 2
    assert int(sched.env_default("RIPTIDE_SCHED_SEED")) == 0
    assert sched.env_default("RIPTIDE_SCHED_REPLAY") == ""


# -- CLI contract -----------------------------------------------------------

def test_cli_clean_mutation_replay_and_usage():
    out, err = io.StringIO(), io.StringIO()
    assert ripsched.run(models=["staging", "quarantine"], out=out,
                        err=err) == 0, out.getvalue() + err.getvalue()
    assert "ripsched OK" in err.getvalue()
    out, err = io.StringIO(), io.StringIO()
    assert ripsched.run(models=["staging_events"], mutation="ignore_event",
                        out=out, err=err) == 1
    assert "--replay" in out.getvalue()
    assert "staging_events+ignore_event:" in out.getvalue()
    sid = sched.explore_model("staging",
                              mutation="early_release").violation.schedule_id
    out = io.StringIO()
    assert ripsched.run(replay_id=sid, out=out, err=io.StringIO()) == 1
    assert sid in out.getvalue()
    for kw in ({"models": ["nosuchmodel"]},
               {"models": ["staging", "fairshare"],
                "mutation": "double_release"},
               {"replay_id": "bogus"}):
        assert ripsched.run(out=io.StringIO(), err=io.StringIO(),
                            **kw) == 2


def test_cli_list_and_sarif():
    out = io.StringIO()
    assert ripsched.run(list_only=True, out=out) == 0
    for name in sched.MODELS:
        assert f"{name}:" in out.getvalue()
    out = io.StringIO()
    assert ripsched.run(models=["runctx"], mutation="unwrapped_worker",
                        fmt="sarif", out=out, err=io.StringIO()) == 1
    doc = json.loads(out.getvalue())
    assert doc["version"] == "2.1.0"
    drv = doc["runs"][0]["tool"]["driver"]
    assert drv["name"] == "ripsched"
    assert [r["id"] for r in drv["rules"]] == \
        sorted(r[0] for r in sched.SARIF_RULES)
    (result,) = doc["runs"][0]["results"]
    assert result["ruleId"].startswith("RIPS")
    assert "--replay" in result["message"]["text"]


def test_cli_subprocess_smoke():
    proc = subprocess.run(
        [sys.executable, "-m", "riptide_tpu_torch.apps.ripsched", "--model",
         "quarantine", "--model", "devicelost", "--max-schedules", "60"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ripsched OK" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "riptide_tpu_torch.apps.ripsched", "--model",
         "devicelost", "--mutate", "lost_no_notify"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 1 and "devicelost+lost_no_notify:" in \
        proc.stdout
