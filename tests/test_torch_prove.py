"""
The port's launch contracts and peak-memory model
(``riptide_tpu_torch/analysis/launch_contract.py``,
``python -m riptide_tpu_torch.apps.rprove``) against the JAX package's
semantic pass on the CPU:

* the contract plans and the wire's transfer contract equal the JAX
  package's live outputs;
* the per-stage K1 + K3 launches of ``tiny-fused`` equal the JAX
  package's ``fused`` dispatches per stage;
* ``HBMModel`` is the JAX class on a grid of edge cases;
* the shape-only walk allocates, launch by launch, the buffers a
  recorded CPU search's wrappers work with (outputs exact, the card's
  container, ping-pong and S/N scratch from the recorded operands), so
  its per-DM and constant bytes are the recording's;
* each seeded regression (an extra launch, a float64 promotion, a
  dropped reuse, an unplanned transfer) makes rprove exit 1; the clean
  tree exits 0, ``--update`` re-pins, a missing file exits 2, and the
  SARIF output has the JAX package's shape;
* an injected model seeds both packages' batchers alike: the same
  slices, peaks, ``oom_predicted`` and incident, and the same journal
  ``hbm`` blocks (no ``actual`` on the CPU); no block without a budget;
* a journal doctored to ratio 2.0 fires ``hbm_drift`` in both packages.
"""
import io
import json

import numpy as np
import pytest
import torch

import riptide_tpu.analysis.jaxpr_contract as jc
import riptide_tpu.ops.plan as ref_plan
import riptide_tpu.search.engine as ref_engine
from riptide_tpu_torch.analysis import launch_contract as lc
from riptide_tpu_torch.apps import rprove
from riptide_tpu_torch.ops import ffa_kernel as fk
from riptide_tpu_torch.ops.plan import CONTRACT_PLANS, contract_plan_params
from riptide_tpu_torch.search import engine, periodogram_plan

from test_torch_survey import (_port_searcher, _ref_searcher,  # noqa: F401
                               trials)

torch.set_num_threads(1)

FAST = [s["name"] for s in contract_plan_params()]
ALL_NAMES = [s["name"] for s in CONTRACT_PLANS]


@pytest.fixture(autouse=True)
def _default_flags(monkeypatch):
    for key in lc.CONTRACT_FLAGS:
        monkeypatch.delenv(key, raising=False)


def _plan(name):
    return lc.build_contract_plan(contract_plan_params([name])[0])


# ------------------------------------------------ plans and the wire

def test_contract_plans_are_the_reference_set():
    assert CONTRACT_PLANS == ref_plan.CONTRACT_PLANS
    for tiers in (("fast",), ("slow",), ("fast", "slow")):
        assert contract_plan_params(tiers=tiers) == \
            ref_plan.contract_plan_params(tiers=tiers)
    assert contract_plan_params(["tiny-fused"]) == \
        ref_plan.contract_plan_params(["tiny-fused"])
    with pytest.raises(KeyError, match="unknown contract plan"):
        contract_plan_params(["renamed-away"])


@pytest.mark.parametrize("name", FAST)
def test_wire_transfer_contract_is_the_reference(name):
    spec = contract_plan_params([name])[0]
    want = ref_engine.wire_transfer_contract(jc.build_contract_plan(spec),
                                             spec["wire"])
    assert engine.wire_transfer_contract(_plan(name), spec["wire"]) == want


def test_fused_launches_per_stage_are_the_reference_dispatches():
    """K1 + K3 launches of each tiny-fused stage (the walk) equal the
    JAX package's fused programs of that stage (its dispatch counters
    around the stage's trace)."""
    import jax

    spec = contract_plan_params(["tiny-fused"])[0]
    ref = jc.build_contract_plan(spec)
    jc._warm_staged(ref, "kernel", "uint6")
    want = []
    for r in ref_engine.staged_stage_programs(ref, jc.PROBE_D, path="kernel",
                                              mode="uint6"):
        _, d = jc._dispatch_delta(
            lambda r=r: jax.make_jaxpr(r["fn"])(*r["args"]))
        want.append(d.get("fused", 0))
    walk = engine.walk_search(_plan("tiny-fused"), lc.PROBE_D, mode="uint6")
    got = [sum(ln["kind"] in ("fused_stage", "paired_stage")
               for ln in walk["launches"] if ln["stage"] == i)
           for i in range(len(want))]
    assert got == want and sum(want) > 0


@pytest.mark.parametrize("const", [0, 1000, 10 ** 9])
@pytest.mark.parametrize("per_dm", [0, 1, 777, 10 ** 6])
def test_hbm_model_is_the_reference_class(const, per_dm):
    port, ref = lc.HBMModel(const, per_dm), jc.HBMModel(const, per_dm)
    assert port.to_dict() == ref.to_dict()
    for D in (0, 1, 3, 32):
        assert port.predict(D) == ref.predict(D)
    for budget in (0, 500, const - 1, const, const + per_dm, 10 ** 12):
        assert port.max_batch(budget) == ref.max_batch(budget)
    assert lc.PROBE_D == jc.PROBE_D and lc.HBM_PROBES == jc.HBM_PROBES
    assert [r[0] for r in lc.RULES] == [r[0] for r in jc.RULES]


# ------------------------------------------- the walk against a recording

# Phase 5w's widest geometry (P past the S/N kernel's shared memory, so
# each launch takes a scratch row per evaluated row) at 2^18 samples.
WIDE = dict(nsamp=2 ** 18, tsamp=16e-6, bmin=60000, bmax=60008,
            widths=(1, 2, 4, 8, 16))


def _wide_plan():
    pmin = WIDE["bmax"] * WIDE["tsamp"]
    return periodogram_plan(WIDE["nsamp"], WIDE["tsamp"], WIDE["widths"],
                            pmin, 1.001 * pmin, WIDE["bmin"], WIDE["bmax"])


def _recorded(plan, D, mode, survey, monkeypatch):
    batch = np.random.default_rng(D).standard_normal((D, plan.size),
                                                     dtype=np.float32)
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", mode)
    with engine.recording() as rec:
        if survey:
            engine.run_search_batch(plan, batch, plan.size * plan.tsamp,
                                    device="cpu")
        else:
            engine.run_periodogram_batch(plan, batch, device="cpu")
    return rec["launches"]


def _buffers(rec_launch, walk_launch):
    """The device buffers the card's wrapper takes for a recorded
    launch, from the recorded operands: container a (D, B, R, P); the
    ping-pong's second buffer when levels run past the segment kernel
    (K2 reuses its container instead); the output as recorded; the S/N
    scratch (D, B, RE, P) past the shared memory."""
    tables, coefs = rec_launch["args"][-2:]
    out = rec_launch["out"]
    D, B, RE = out.shape[:3]
    R, P, L = tables.h.shape[2], tables.P, tables.h.shape[0]
    local = dict(walk_launch["calls"])["segment_cascade"][17]
    a = D * B * R * P * 4
    bufs = [a]
    if local < L and rec_launch["kind"] != "cascade_stage":
        bufs.append(a)
    bufs.append(out.nbytes)
    if fk.snr_launch(P)[2]:
        bufs.append(D * B * RE * P * 4)
    return bufs


def _fit(points):
    (d0, b0), (d1, b1) = points
    per_dm = (b1 - b0) // (d1 - d0)
    return b0 - per_dm * d0, per_dm


@pytest.mark.parametrize("case", ["tiny-fused", "tiny-gather", "wide"])
def test_walk_bytes_are_a_recorded_search(case, monkeypatch):
    if case == "wide":
        plan, mode, survey, probes = _wide_plan(), "uint6", False, (1, 2)
        assert fk.snr_launch(plan.P)[2]
    else:
        spec = contract_plan_params([case])[0]
        plan, mode, survey, probes = _plan(case), spec["wire"], True, \
            lc.HBM_PROBES
    walked, recorded = [], []
    for D in probes:
        walk = engine.walk_search(plan, D, mode=mode, survey=survey)
        rec = _recorded(plan, D, mode, survey, monkeypatch)
        assert [(w["kind"], w["stage"], w["bucket"], w.get("guest"))
                for w in walk["launches"]] == \
            [(r["kind"], r["stage"], r["bucket"], r.get("guest"))
             for r in rec]
        for w, r in zip(walk["launches"], rec):
            assert w["out"] == (tuple(r["out"].shape), "float32")
            assert sorted(b for _, _, b in w["allocs"]) == \
                sorted(_buffers(r, w))
        walked.append((D, sum(b for w in walk["launches"]
                              for _, _, b in w["allocs"])))
        recorded.append((D, sum(sum(_buffers(r, w)) for r, w in
                                zip(rec, walk["launches"]))))
    assert _fit(walked) == _fit(recorded)
    assert _fit(walked)[1] > 0


def test_hbm_model_fits_the_walk_peaks():
    plan = _plan("tiny-fused")
    model = lc.hbm_model(plan, "uint6")
    peaks = [engine.walk_search(plan, D, mode="uint6")["peak_bytes"]
             for D in lc.HBM_PROBES]
    assert [model.predict(D) for D in lc.HBM_PROBES] == peaks
    assert model.max_batch(model.predict(3)) == 3
    assert model.max_batch(0) == 1


def test_reuse_report_reads_pointer_ranges():
    """K2's second level buffer inside its container is honoured; a
    fresh buffer is a dropped reuse, as is an S/N read of neither
    ping-pong buffer."""
    seg = [4096, 0, 0] + [0] * 9 + [8192, 1, 1, 2, 8]   # src, ..., a, D..P
    good = [("segment_cascade", tuple(seg)),
            ("ffa_levels", (8192, 4096)), ("boxcar_snr", (4096,))]
    assert lc.reuse_report(good) == [{"declared": ["pingpong", "container"],
                                      "dropped": []}]
    bad = [("segment_cascade", tuple(seg)),
           ("ffa_levels", (8192, 1 << 20)), ("boxcar_snr", (1 << 21,))]
    assert lc.reuse_report(bad)[0]["dropped"] == ["pingpong", "container"]
    assert lc.reuse_report([("segment_cascade", tuple(seg)),
                            ("boxcar_snr", (8192,))]) == \
        [{"declared": [], "dropped": []}]


# ---------------------------------------------------------- rprove

def _run(names=("tiny-gather",), **kw):
    out, err = io.StringIO(), io.StringIO()
    code = rprove.run(names=list(names), out=out, err=err, **kw)
    return code, out.getvalue(), err.getvalue()


def test_rprove_clean_tree_exits_0():
    code, out, err = _run(FAST)
    assert code == 0, out + err
    assert "rprove OK" in err


def test_seeded_extra_launch_exits_1(monkeypatch):
    orig = engine._launch

    def doubled(kind, fn, args, **where):
        if where.get("stage") == 0:
            orig(kind, fn, args, **where)
        return orig(kind, fn, args, **where)

    monkeypatch.setattr(engine, "_launch", doubled)
    code, out, _ = _run(["tiny-fused"])
    assert code == 1
    assert "RPV001" in out and "tiny-fused" in out
    assert "stage 0" in out and "launch drift" in out


def test_seeded_f64_promotion_exits_1(monkeypatch):
    orig = engine._run_stage

    def promoted(st, plan, i, wire, meta):
        return orig(st, plan, i, wire, meta).double().float()

    monkeypatch.setattr(engine, "_run_stage", promoted)
    code, out, _ = _run(["tiny-gather"])
    assert code == 1
    assert "RPV002" in out and "stage 0" in out and "float64" in out


def _levels_outside_tiles(monkeypatch):
    """Every level as a level launch (no tile-local level), so that the
    tiny plans' launches reach the ping-pong and K2's container reuse."""
    orig = engine._operands

    def no_local(*a, **k):
        tables, coefs = orig(*a, **k)
        return tables._replace(local=0), coefs

    monkeypatch.setattr(engine, "_operands", no_local)


def test_seeded_dropped_reuse_exits_1(monkeypatch):
    _levels_outside_tiles(monkeypatch)
    code, out, _ = _run(["tiny-gather"])
    # The levels moved (launch drift), and the reuses they declare hold.
    assert code == 1 and "reuse(s) dropped" not in out
    orig = fk._levels

    def fresh_scratch(rt, source, tables, D, levels=None, scratch=None):
        return orig(rt, source, tables, D, levels)

    monkeypatch.setattr(fk, "_levels", fresh_scratch)
    code, out, _ = _run(["tiny-gather"])
    assert code == 1
    assert "RPV003" in out and "stage 0" in out
    assert "declared storage reuse(s) dropped" in out


def test_seeded_unplanned_transfer_exits_1(monkeypatch):
    orig = engine._run_stage
    stowaway = np.ones(7, np.float32)

    def smuggling(st, plan, i, wire, meta):
        torch.from_numpy(stowaway).to(wire.device)
        return orig(st, plan, i, wire, meta)

    monkeypatch.setattr(engine, "_run_stage", smuggling)
    code, out, _ = _run(["tiny-gather"])
    assert code == 1
    assert "RPV004" in out and "stage 0" in out and "operand upload" in out


def test_rprove_update_clean_missing(tmp_path):
    path = str(tmp_path / "contracts.json")
    assert _run(contracts_path=path)[0] == 2
    assert _run(contracts_path=path, update=True)[0] == 0
    with open(path) as fobj:
        assert set(json.load(fobj)["plans"]) == {"tiny-gather"}
    code, _, err = _run(contracts_path=path)
    assert code == 0 and "rprove OK" in err
    findings = lc.check_contracts({"plans": {"gone": {}}}, {}, ALL_NAMES)
    assert [f["rule"] for f in findings] == ["RPV006"]


def test_rprove_sarif_has_the_reference_shape():
    code, out, _ = _run(fmt="sarif")
    assert code == 0
    doc = json.loads(out)
    assert doc["version"] == "2.1.0" and "$schema" in doc
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "rprove"
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == \
        [f"RPV{n:03d}" for n in range(1, 7)]
    assert run["results"] == []
    # A finding renders as the JAX writer renders it.
    from riptide_tpu_torch.analysis.sarif import sarif_doc

    res = sarif_doc([{"path": "p", "line": 1, "col": 0, "rule": "RPV001",
                      "message": "m"}], lc.RULES, "rprove")
    assert res["runs"][0]["results"][0] == {
        "ruleId": "RPV001", "level": "error", "message": {"text": "m"},
        "locations": [{"physicalLocation": {
            "artifactLocation": {"uri": "p"},
            "region": {"startLine": 1, "startColumn": 1}}}]}


def test_pinned_contracts_hold_on_the_walk():
    current = rprove.build_current(FAST)
    pinned = lc.load_contracts()
    assert lc.check_contracts(pinned, current, ALL_NAMES) == []
    assert set(pinned["plans"]) == set(ALL_NAMES)
    for c in current.values():
        assert c["dtypes"] and "float64" not in c["dtypes"]
        assert c["shipped"]["bytes_per_dm"] == \
            c["transfers"]["h2d_bytes_per_dm"]


# ----------------------------------------------- seeding in the batchers

WIRE_ENV = {"RIPTIDE_WIRE_DTYPE": "uint6", "RIPTIDE_FFA_PATH": "gather"}
MODEL = (1000, 5000)     # const, per_dm: a 3-trial chunk splits 2 + 1


def _seeded_run(pkg, files, jdir, budget, monkeypatch):
    from riptide_tpu.survey import scheduler as ref_sched
    from riptide_tpu.survey.journal import SurveyJournal as RefJournal
    from riptide_tpu.survey.metrics import get_metrics as ref_metrics
    from riptide_tpu_torch.survey import scheduler
    from riptide_tpu_torch.survey.journal import SurveyJournal
    from riptide_tpu_torch.survey.metrics import get_metrics

    port = pkg == "port"
    searcher = _port_searcher() if port else _ref_searcher()
    cls = (lc if port else jc).HBMModel
    monkeypatch.setattr(searcher, "_hbm_model",
                        lambda plan: cls(*MODEL))
    slices = []
    inner = searcher._search_slice

    def counting(*a):
        slices.append(a[-1] - a[-2])
        return inner(*a)

    monkeypatch.setattr(searcher, "_search_slice", counting)
    if budget:
        monkeypatch.setenv("RIPTIDE_HBM_BUDGET", str(budget))
    else:
        monkeypatch.delenv("RIPTIDE_HBM_BUDGET", raising=False)
    metrics = get_metrics() if port else ref_metrics()
    metrics.reset()
    journal = (SurveyJournal if port else RefJournal)(jdir)
    peaks = (scheduler if port else ref_sched).SurveyScheduler(
        searcher, [list(files)], journal=journal).run()
    (rec, _), = journal.completed_chunks().values()
    kinds = [r["incident"] for r in journal.incidents()]
    return dict(peaks=peaks, slices=slices, hbm=rec["hbm"],
                oom_predicted=metrics.counter("oom_predicted"),
                oom_bisections=metrics.counter("oom_bisections"),
                incidents=kinds.count("oom_predicted"))


def test_seeded_batches_match_reference(trials, tmp_path, monkeypatch):
    for k, v in WIRE_ENV.items():
        monkeypatch.setenv(k, v)
    budget = MODEL[0] + 2 * MODEL[1]
    runs = {(pkg, b): _seeded_run(pkg, trials, tmp_path / f"{pkg}{b}", b,
                                  monkeypatch)
            for pkg in ("port", "ref") for b in (budget, 0)}
    port, ref = runs[("port", budget)], runs[("ref", budget)]
    assert port["slices"] == ref["slices"] == [2, 1]
    assert port["oom_predicted"] == ref["oom_predicted"] == 1
    assert port["incidents"] == ref["incidents"] == 1
    assert port["oom_bisections"] == ref["oom_bisections"] == 0
    # The CPU has no device memory stats: no actual on either side.
    assert port["hbm"] == ref["hbm"] == {
        "predicted_bytes": MODEL[0] + 2 * MODEL[1], "budget_bytes": budget}
    # The split gives each package's unbudgeted peaks, and the
    # packages' peaks agree (the S/N to rtol 1e-5, as their surveys do).
    for pkg in ("port", "ref"):
        assert runs[(pkg, budget)]["peaks"] == runs[(pkg, 0)]["peaks"]
        assert runs[(pkg, 0)]["hbm"] == {} and not runs[(pkg, 0)]["slices"]
    assert len(port["peaks"]) == len(ref["peaks"]) > 0
    for p, r in zip(port["peaks"], ref["peaks"]):
        p, r = p._asdict(), r._asdict()
        assert p.pop("snr") == pytest.approx(r.pop("snr"), rel=1e-5)
        assert p == r


def test_no_budget_no_block(monkeypatch):
    monkeypatch.delenv("RIPTIDE_HBM_BUDGET", raising=False)
    searcher = _port_searcher()
    assert searcher.chunk_hbm_block([]) is None
    assert searcher._seed_batch_limit(_plan("tiny-gather"), 1024) is None


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_doctored_ratio_fires_hbm_drift(pkg, tmp_path):
    """A journal whose chunks carry ratio 2.0 fires hbm_drift in both
    packages' alert engines (their journals share one format)."""
    if pkg == "port":
        from riptide_tpu_torch.obs import alerts, report
        from riptide_tpu_torch.survey.journal import SurveyJournal
    else:
        from riptide_tpu.obs import alerts, report
        from riptide_tpu.survey.journal import SurveyJournal
    journal = SurveyJournal(tmp_path)
    journal.write_header("doctored", 2)
    for cid in range(2):
        journal.record_chunk(cid, [f"f{cid}.inf"], [float(cid)], [],
                             hbm={"predicted_bytes": 100,
                                  "budget_bytes": 1000,
                                  "actual_bytes": 200, "ratio": 2.0})
    snap = report.watch_snapshot(report.read_journal(str(tmp_path)))
    assert snap["hbm_ratio_median"] == 2.0
    fired = [e["rule"] for e in
             alerts.AlertEngine(alerts.default_rules()).evaluate(snap)
             if e["event"] == "fired"]
    assert "hbm_drift" in fired
