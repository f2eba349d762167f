"""
Launch contracts of the search plans: the port's semantic pass (rprove),
the counterpart of the JAX package's ``analysis/jaxpr_contract.py``.

Where the JAX package traced XLA programs, the port reads launches: the
shape-only walk of the stage loop
(:func:`riptide_tpu_torch.search.engine.walk_search`) runs the real
queue path on the ``meta`` device, with each stage wrapper taking its
shape-only form (:class:`~riptide_tpu_torch.ops.ffa_kernel.ShapeOnlyLibrary`),
so every launch, every CUDA kernel under it and every device buffer is
listed without a card. One **launch contract** per representative plan
(:data:`~riptide_tpu_torch.ops.plan.CONTRACT_PLANS`) condenses it, with
the rule ids of the JAX pass, read for launches:

* RPV001 (dispatch drift): the per-stage launch counts by wrapper
  (``fused_stage``/``paired_stage``/``cascade_stage``) and by CUDA
  kernel (``segment_wire``, ``segment_container``, ``ffa_level``,
  ``boxcar_snr``); on a quantised wire K2 must not run, and the walk
  must agree with ``engine.queued_launches``.
* RPV002 (dtype flow): no float64/complex128 tensor on the device side
  of the search, in the walk (the card's path) and in the same walk over
  the plain path on the CPU; the assembled S/N cube and the peak
  program's pulled buffer are float32. Host float64 (the prefix sums)
  is numpy, outside both.
* RPV003 (declared reuse, the port's counterpart of a donation): a
  wrapper that declares it reuses storage does so, read from the
  pointers its launches receive (:func:`reuse_report`): K2 runs its
  levels in its own container (the ping-pong's second buffer), and
  every launch's S/N kernel reads one of the two ping-pong buffers. A
  dropped reuse doubles that buffer.
* RPV004 (transfer drift): the wire's transfer shape
  (``engine.wire_transfer_contract``), the copies and bytes the walk
  saw the wire ship (which must be the contract's bytes), and each
  stage's operand uploads.
* RPV005 (peak-memory model drift): :class:`HBMModel` fitted from the
  walk's peak live bytes at :data:`HBM_PROBES`.
* RPV006 (contract set): every contract plan is pinned and every
  pinned plan still exists.

Contracts are pinned in ``riptide_tpu_torch/analysis/plan_contracts.json``
(``python -m riptide_tpu_torch.apps.rprove --update``) under the
default flags. On the card, ``chip_smoke.py`` holds the launches one
real search counts against the contract, the pointers its launches
receive against :func:`reuse_report`, and the model against
``torch.cuda.max_memory_allocated``.
"""
import json
import os

import numpy as np

__all__ = [
    "PROBE_D", "HBM_PROBES", "RULES", "CONTRACTS_PATH", "CONTRACT_REL",
    "CONTRACT_FLAGS", "HBMModel", "build_contract_plan", "reuse_report",
    "hbm_model", "extract_contract", "check_contracts", "load_contracts",
]

# DM batch the contracts are taken at (per-DM bytes divide exactly),
# and the two probes the linear peak-memory model is fitted from: the
# JAX package's.
PROBE_D = 2
HBM_PROBES = (1, 3)

RULES = (
    ("RPV001", "dispatch-drift",
     "per-stage launch counts by wrapper and CUDA kernel match the pinned "
     "contract; a quantised wire launches no K2"),
    ("RPV002", "dtype-flow",
     "no float64/complex128 tensor on the device side and the assembled "
     "S/N output dtype is pinned"),
    ("RPV003", "reuse",
     "declared storage reuses (K2's container, the level ping-pong) are "
     "honoured by the pointers the launches receive"),
    ("RPV004", "transfer-drift",
     "host->device transfer counts/bytes and per-stage operand uploads "
     "match the pinned contract"),
    ("RPV005", "hbm-model-drift",
     "the walk's peak-memory model (const + per_dm * D) matches the "
     "pinned contract"),
    ("RPV006", "contract-set",
     "every contract plan is pinned and every pinned plan still exists"),
)

_HERE = os.path.dirname(os.path.abspath(__file__))
CONTRACTS_PATH = os.path.join(_HERE, "plan_contracts.json")
CONTRACT_REL = "riptide_tpu_torch/analysis/plan_contracts.json"

# Flags that change launches: contracts describe the defaults, so
# rprove drops them first.
CONTRACT_FLAGS = ("RIPTIDE_WIRE_DTYPE",)


class HBMModel:
    """Linear peak-memory model ``bytes(D) = const + per_dm * D`` fitted
    from the walk's peak live bytes at two DM-batch probes (the JAX
    package's class)."""

    def __init__(self, const_bytes, per_dm_bytes):
        self.const_bytes = int(const_bytes)
        self.per_dm_bytes = int(per_dm_bytes)

    def predict(self, D):
        """Modelled peak bytes of a D-trial search."""
        return self.const_bytes + self.per_dm_bytes * int(D)

    def max_batch(self, budget_bytes):
        """Largest DM batch the model predicts fits ``budget_bytes``,
        never below 1 (a single trial is always attempted; OOM bisection
        owns the impossible case). A D-independent footprint
        (``per_dm_bytes`` 0) fits at any batch size or at none, so the
        model reports unbounded rather than forcing maximal
        splitting."""
        if self.per_dm_bytes <= 0:
            return 1 << 62
        return max(1, (int(budget_bytes) - self.const_bytes)
                   // self.per_dm_bytes)

    def to_dict(self):
        return {"const_bytes": self.const_bytes,
                "per_dm_bytes": self.per_dm_bytes}


def build_contract_plan(spec):
    """The (cached) PeriodogramPlan of one ``CONTRACT_PLANS`` spec."""
    from ..search.plan import periodogram_plan

    return periodogram_plan(
        spec["size"], spec["tsamp"], tuple(spec["widths"]),
        spec["period_min"], spec["period_max"], spec["bins_min"],
        spec["bins_max"],
    )


def _fit(walks):
    (d0, w0), (d1, w1) = walks
    per_dm = max(0, (w1["peak_bytes"] - w0["peak_bytes"]) // (d1 - d0))
    const = max(0, w0["peak_bytes"] - per_dm * d0)
    return HBMModel(const, per_dm)


def hbm_model(plan, mode=None):
    """The plan's peak-memory model from the walk at :data:`HBM_PROBES`
    on ``mode``'s wire (default the live wire), cached on the plan per
    wire mode (plans are cached, so a survey walks once per search
    configuration)."""
    from ..search import engine

    mode = mode or engine._wire_mode()
    cache = plan.__dict__.setdefault("_hbm_models", {})
    model = cache.get(mode)
    if model is None:
        model = cache[mode] = _fit(
            [(D, engine.walk_search(plan, D, mode=mode))
             for D in HBM_PROBES])
    return model


# ------------------------------------------------------------- the reuses

def _groups(calls):
    """The library calls of a launch sequence, one group per stage
    launch (each starts at its segment kernel)."""
    out = []
    for name, args in calls:
        if name == "segment_cascade":
            out.append({})
        if out:
            out[-1][name] = args
    return out


def reuse_report(calls):
    """Per stage launch, its declared storage reuses and which were
    dropped, read from the pointers in ``calls`` ((name, args) of the
    kernel library's launchers, ``rt_`` stripped, as the shape-only
    library records them or a proxy of the built one sees them).

    Declared: where the levels run past the segment kernel, the S/N
    kernel reads one of the two ping-pong buffers the levels wrote
    (``pingpong``), and K2 (the segment kernel reads a packed container,
    ``src`` non-null) runs its second level buffer in that container
    (``container``: the level launcher's second buffer lies inside the
    container's [src, src + D*B*R*P*4) range). Returns [{"declared":
    [names], "dropped": [names]}, ...]."""
    out = []
    for g in _groups(calls):
        seg, lev, snr = (g.get("segment_cascade"), g.get("ffa_levels"),
                         g.get("boxcar_snr"))
        declared, dropped = [], []
        if seg is not None and lev is not None:
            a_seg, src = seg[12], seg[0]
            a, b = lev[0], lev[1]
            declared.append("pingpong")
            if a != a_seg or snr is None or snr[0] not in (a, b):
                dropped.append("pingpong")
            if src:
                D, B, R, P = (int(x) for x in seg[13:17])
                declared.append("container")
                if not src <= b < src + D * B * R * P * 4:
                    dropped.append("container")
        out.append({"declared": declared, "dropped": dropped})
    return out


# -------------------------------------------------------------- extraction

def _stage_kind(launches):
    """A stage's part of the launch layout: ``whole`` (one container),
    ``buckets`` (its lane buckets) or ``absorbed`` (every bucket rides
    an earlier host's dead rows)."""
    if not launches:
        return "absorbed"
    return "whole" if launches[0].bucket is None else "buckets"


def _nonzero(d):
    return {k: int(v) for k, v in sorted(d.items()) if v}


def extract_contract(plan, mode, seed=0):
    """One plan's launch contract on ``mode``'s wire (see the module
    doc for its fields): the walk at
    :data:`PROBE_D`, the plain path's walk on seeded data, and the model
    from :func:`hbm_model`."""
    from ..search import engine

    walk = engine.walk_search(plan, PROBE_D, mode=mode)
    data = np.random.default_rng(seed).normal(
        size=(PROBE_D, plan.size)).astype(np.float32)
    plain = engine.walk_search(plan, PROBE_D, mode=mode, data=data)
    wire = engine.wire_transfer_contract(plan, mode)
    per_wire = wire.pop("per_stage_wire_bytes_per_dm")
    lay = engine.launch_layout(plan, mode)
    reuses = reuse_report([c for ln in walk["launches"]
                           for c in ln["calls"]])

    stages = []
    for i, stage_launches in enumerate(lay.stages):
        lns = [(j, ln) for j, ln in enumerate(walk["launches"])
               if ln["stage"] == i]
        dispatch, kernels = {}, {}
        out_bytes = 0
        declared = dropped = 0
        for j, ln in lns:
            dispatch[ln["kind"]] = dispatch.get(ln["kind"], 0) + 1
            for k, v in ln["kernels"].items():
                kernels[k] = kernels.get(k, 0) + v
            shape, dtype = ln["out"]
            out_bytes += int(np.prod(shape)) * np.dtype(dtype).itemsize
            declared += len(reuses[j]["declared"])
            dropped += len(reuses[j]["dropped"])
        n_up, up = walk["h2d"].get(i, (0, 0))
        stages.append({
            "stage": i,
            "kind": _stage_kind(stage_launches),
            "dispatch": _nonzero(dispatch),
            "kernels": _nonzero(kernels),
            "operand_transfers": int(n_up),
            "operand_bytes": int(up),
            "out_bytes_per_dm": int(out_bytes // PROBE_D),
            "wire_bytes_per_dm": int(per_wire[i]),
            "f64_ops": int(walk["f64"].get(i, 0) + plain["f64"].get(i, 0)),
            "reuse": {"declared": declared, "dropped": dropped},
        })

    n_ship, ship_bytes = walk["h2d"].get("ship", (0, 0))
    f64_other = sum(v for k, v in list(walk["f64"].items())
                    + list(plain["f64"].items())
                    if k in ("ship", "assemble"))
    peaks = dict(walk["peaks"])
    peaks["out_bytes_per_dm"] = int(peaks.pop("out_bytes") // PROBE_D)
    peaks["f64_ops"] = int(walk["f64"].get("peaks", 0)
                           + plain["f64"].get("peaks", 0))
    return {
        "wire_mode": mode,
        "n_stages": len(plan.stages),
        "stages": stages,
        "dispatch_total": _nonzero(walk["launch_counts"]),
        "kernel_total": _nonzero(walk["kernel_counts"]),
        "queued_launches": _nonzero(engine.queued_launches(plan, mode)),
        "transfers": wire,
        "shipped": {"copies": int(n_ship),
                    "bytes_per_dm": int(ship_bytes // PROBE_D)},
        "reuse": {"declared": sum(s["reuse"]["declared"] for s in stages),
                  "dropped": sum(s["reuse"]["dropped"] for s in stages)},
        "f64_other": int(f64_other),
        "dtypes": sorted(set(walk["dtypes"]) | set(plain["dtypes"])),
        "out_dtype": walk["out_dtype"],
        "plain_out_dtype": plain["out_dtype"],
        "peaks": peaks,
        "hbm": hbm_model(plan, mode).to_dict(),
    }


# -------------------------------------------------------------- the check

def _finding(rel, rule, message):
    return {"path": rel, "line": 1, "col": 0, "rule": rule,
            "message": message}


def _absolute(name, cur, rel):
    """Findings on the current tree alone (pinning them would bless a
    defect)."""
    out = []
    quantised = cur["wire_mode"] in ("uint6", "uint8", "uint12")
    for st in cur["stages"]:
        i = st["stage"]
        if st["f64_ops"]:
            out.append(_finding(rel, "RPV002", (
                f"plan {name!r} stage {i}: {st['f64_ops']} float64/"
                "complex128 tensor(s) made on the device side — the "
                "dtype-flow audit forbids them (fix the promotion; "
                "--update cannot bless it)")))
        if quantised and st["dispatch"].get("cascade_stage"):
            out.append(_finding(rel, "RPV001", (
                f"plan {name!r} stage {i}: {st['dispatch']['cascade_stage']}"
                " K2 (cascade_stage) launch(es) on a quantised wire — K1/K3 "
                "decode the wire themselves; a float container is an extra "
                "pass")))
        if st["reuse"]["dropped"]:
            out.append(_finding(rel, "RPV003", (
                f"plan {name!r} stage {i}: {st['reuse']['dropped']} "
                "declared storage reuse(s) dropped — the launch received a "
                "buffer outside the reused operand's range, so that buffer "
                "is allocated twice")))
    if cur["dispatch_total"] != cur["queued_launches"]:
        out.append(_finding(rel, "RPV001", (
            f"plan {name!r}: the walk launched {cur['dispatch_total']} but "
            f"engine.queued_launches says {cur['queued_launches']}")))
    if cur["shipped"]["bytes_per_dm"] != cur["transfers"]["h2d_bytes_per_dm"]:
        out.append(_finding(rel, "RPV004", (
            f"plan {name!r}: the wire shipped "
            f"{cur['shipped']['bytes_per_dm']} bytes per DM, the transfer "
            f"contract says {cur['transfers']['h2d_bytes_per_dm']} — an "
            "unplanned transfer rides with the wire")))
    pk = cur["peaks"]
    if pk["f64_ops"] or cur["f64_other"]:
        out.append(_finding(rel, "RPV002", (
            f"plan {name!r}: {pk['f64_ops'] + cur['f64_other']} float64/"
            "complex128 tensor(s) made on the device side outside the "
            "stages (wire, assembly or the peak program)")))
    for key in ("out_dtype", "plain_out_dtype"):
        if cur[key] != "float32":
            out.append(_finding(rel, "RPV002", (
                f"plan {name!r}: assembled S/N cube is {cur[key]} "
                f"({key}) — the float32 accumulator contract of the S/N "
                "error budget")))
    if pk["out_dtype"] != "float32":
        out.append(_finding(rel, "RPV002", (
            f"plan {name!r}: the peak program's pulled buffer is "
            f"{pk['out_dtype']}, not float32")))
    return out


_STAGE_FIELDS = (
    (("kind", "dispatch", "kernels"), "RPV001", "launch drift"),
    (("operand_transfers", "operand_bytes"), "RPV004",
     "operand upload drift (an unplanned host->device transfer rides with "
     "this stage)"),
    (("wire_bytes_per_dm",), "RPV004", "wire bytes per DM drift"),
    (("out_bytes_per_dm",), "RPV004", "output bytes per DM drift"),
    (("reuse",), "RPV003", "reuse drift"),
)

_PLAN_FIELDS = (
    ("transfers", "RPV004", "transfer contract drift"),
    ("shipped", "RPV004", "shipped wire drift"),
    ("out_dtype", "RPV002", "assembled S/N dtype drift"),
    ("reuse", "RPV003", "reuse contract drift"),
    ("peaks", "RPV001", "peak-program contract drift"),
    ("hbm", "RPV005", "peak-memory model drift (the batcher's seeded "
                      "DM-batch pick reads this model; re-pin with "
                      "--update after a deliberate footprint change)"),
)


def check_contracts(pinned_doc, current, all_names, contract_rel=CONTRACT_REL):
    """Compare freshly extracted contracts (``current``: plan name ->
    contract) with the pinned document. ``all_names`` is the whole
    contract plan set, so stale pinned entries are found even when only
    the fast tier was extracted. Returns finding dicts (path, line, col,
    rule, message); empty means no drift."""
    pinned = (pinned_doc or {}).get("plans", {})
    rel = contract_rel
    findings = []
    for stale in sorted(set(pinned) - set(all_names)):
        findings.append(_finding(rel, "RPV006", (
            f"plan {stale!r}: pinned contract has no matching entry in "
            "ops.plan.CONTRACT_PLANS — delete it (rprove --update) or "
            "restore the plan spec")))
    for name in sorted(current):
        cur = current[name]
        findings += _absolute(name, cur, rel)
        pin = pinned.get(name)
        if pin is None:
            findings.append(_finding(rel, "RPV006", (
                f"plan {name!r}: no pinned contract — run `python -m "
                "riptide_tpu_torch.apps.rprove --update` and commit the "
                "result")))
            continue
        pin_stages = {s["stage"]: s for s in pin.get("stages", ())}
        for st in cur["stages"]:
            i = st["stage"]
            ps = pin_stages.get(i)
            if ps is None:
                findings.append(_finding(rel, "RPV001", (
                    f"plan {name!r} stage {i}: not in the pinned contract "
                    "(stage set changed) — re-pin with --update if "
                    "intentional")))
                continue
            for keys, rule, what in _STAGE_FIELDS:
                was = {k: ps.get(k) for k in keys}
                now = {k: st[k] for k in keys}
                if was != now:
                    findings.append(_finding(rel, rule, (
                        f"plan {name!r} stage {i}: {what} — pinned {was} "
                        f"!= walked {now} (re-pin with --update only if "
                        "intentional)")))
        for missing in sorted(set(pin_stages)
                              - {s["stage"] for s in cur["stages"]}):
            findings.append(_finding(rel, "RPV001", (
                f"plan {name!r} stage {missing}: pinned but no longer "
                "walked (stage set changed) — re-pin with --update if "
                "intentional")))
        for key, rule, what in _PLAN_FIELDS:
            if cur[key] != pin.get(key):
                findings.append(_finding(rel, rule, (
                    f"plan {name!r}: {what} — pinned {pin.get(key)} != "
                    f"walked {cur[key]}")))
    return findings


def load_contracts(path=CONTRACTS_PATH):
    """The pinned contract document, or None when absent."""
    try:
        with open(path) as fobj:
            return json.load(fobj)
    except OSError:
        return None
