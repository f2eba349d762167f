"""
Lane buckets, row-packed containers, the launch layout and K3 of the
port against the JAX package's, on the CPU.

* Layout decisions: the port's lane buckets, container heights, guest
  bases, pairing map and occupancy equal the JAX package's at its
  defaults, at the row-pack e2e configuration of tests/test_row_pack.py,
  a lane-split plan, a small plan that pairs, the headline plan of
  BASELINE.md (no pair) and the benchmark's riptide example.yaml ranges
  (``long`` pairs 6 buckets; ``short`` and ``medium`` none).
* The launch layout (``engine.launch_layout``) is built once per plan
  and wire mode, and its launches are those a search records.
* ``paired_stage_plain`` (K3's plain version) matches the JAX package's
  paired ``CycleKernel`` in interpret mode on the ``_paired_case``
  geometry of tests/test_row_pack.py, within rtol 1e-5, atol 1e-4 (the
  S/N's summation order, tests/test_torch_ffa_stage.py), and its host
  and guest rows are bitwise those of the unpaired ``fused_stage_plain``.
* Per-trial results do not depend on the layout: every launch's rows are
  bitwise those of the trial's whole stage in one container, and
  ``run_periodogram`` matches the JAX package's kernel path under each
  of its container layouts.
"""
import json
import os

import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.ops.ffa_kernel import CycleKernel
from riptide_tpu.ops.plan import pair_bucket_bases as ref_pair_bases
from riptide_tpu.ops.slottables import guest_base as ref_guest_base
from riptide_tpu.search import run_periodogram as ref_run_periodogram
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu.search.plan import plan_occupancy as ref_occupancy
from riptide_tpu_torch.ffautils import generate_width_trials
from riptide_tpu_torch.ops import ffa_kernel as fk
from riptide_tpu_torch.ops.plan import (FFABatchPlan, num_levels,
                                        pair_bucket_bases)
from riptide_tpu_torch.ops.slottables import guest_base
from riptide_tpu_torch.ops.snr import boxcar_coeffs
from riptide_tpu_torch.search import engine, run_periodogram
from riptide_tpu_torch.search.plan import periodogram_plan, plan_occupancy

RTOL, ATOL = 1e-5, 1e-4
E2E = (1200, 1e-3, (1, 2, 3), 32e-3, 0.11, 32, 40)
HEADLINE = (2 ** 23, 64e-6, (1, 2, 3, 4, 6, 9, 13, 19, 28, 42), 0.5, 3.0,
            240, 260)
# Bins across p = 128: the lane split gives two buckets per stage.
SPLIT = (8192, 1e-3, (1, 2, 3), 0.125, 0.3, 120, 136)
# SPLIT's bins in 4 stages: the JAX package's interpret-mode kernel path
# runs it in seconds.
SPLIT4 = (4096, 1e-3, (1, 2, 3), 0.125, 0.2, 120, 136)
# A small plan whose stage 6 hosts stage 12's one bucket.
PAIRED = (16384, 1e-3, (1, 2, 3), 0.032, 4.0, 32, 40)


def _example_yaml(name):
    """The plan arguments of one range of the benchmark's riptide
    example.yaml configuration (2^23 samples of 64 us)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           "example_yaml.json")) as fobj:
        cfg = json.load(fobj)
    r = next(r for r in cfg["ranges"] if r["name"] == name)
    widths = tuple(int(w) for w in generate_width_trials(
        r["bins_min"], ducy_max=r["ducy_max"], wtsp=r["wtsp"]))
    return (cfg["nsamp"], cfg["tsamp"], widths, r["period_min"],
            r["period_max"], r["bins_min"], r["bins_max"])


# example.yaml's range long is the benchmark's example_long configuration.
CONFIGS = {"e2e": E2E, "headline": HEADLINE, "split": SPLIT,
           "split4": SPLIT4, "paired": PAIRED,
           "example_long": _example_yaml("long"),
           "example_yaml_short": _example_yaml("short"),
           "example_yaml_medium": _example_yaml("medium")}
REF_FLAGS = ("RIPTIDE_KERNEL_BASE3", "RIPTIDE_KERNEL_ROW_PACK",
             "RIPTIDE_KERNEL_LANE_SPLIT")


def _ref_layout(monkeypatch, **flags):
    """Set the JAX package's container layout (its defaults, with
    ``flags`` over them)."""
    for name in REF_FLAGS:
        monkeypatch.delenv(name, raising=False)
    for name, value in flags.items():
        monkeypatch.setenv(f"RIPTIDE_KERNEL_{name}", value)


@pytest.mark.parametrize("cfg,pairs", [
    ("e2e", 0), ("split", 0), ("paired", 1), ("headline", 0),
    ("example_long", 6), ("example_yaml_short", 0),
    ("example_yaml_medium", 0),
])
def test_layout_decisions_match_reference(monkeypatch, cfg, pairs):
    _ref_layout(monkeypatch)
    plan, ref = periodogram_plan(*CONFIGS[cfg]), ref_plan(*CONFIGS[cfg])
    for st, rst in zip(plan.stages, ref.stages):
        assert st.lane_buckets == rst.lane_buckets
        assert (engine._fused_eligible(st, plan, "uint6")
                == ref_engine._fused_eligible(rst, ref, "uint6"))
        for k, idx in enumerate(st.lane_buckets):
            L, rows, P = engine._bucket_shape(st, idx)
            ref_L, _, ref_rows, ref_P = ref_engine._bucket_shape(rst, idx)
            assert (L, rows, P) == (ref_L, ref_rows, ref_P)
            b = st.bucket_batch(k)
            assert b.R == rows + 1 and b.L == L
            assert b.P == max(st.ps_padded[i] for i in idx)
    rpm = engine._row_pack_map(plan, "uint6")
    assert rpm == ref_engine._row_pack_map(ref, "uint6")
    assert sum(v[0] == "host" for v in rpm.values()) == pairs
    lay = engine.launch_layout(plan, "uint6")
    assert [(ln.stage, ln.bucket, ln.guest, list(ln.bases))
            for ln in lay.launches if ln.kind == "paired_stage"] == [
        (s, k, e[1], list(e[2])) for (s, k), e in sorted(rpm.items())
        if e[0] == "host"]
    assert sorted((s, k) for s, k, _ in lay.absorbed) == sorted(
        key for key, e in rpm.items() if e[0] == "guest")
    for (s, k), entry in rpm.items():
        if entry[0] != "host":
            continue
        st, st2 = plan.stages[s], plan.stages[entry[1]]
        idx = st.lane_buckets[k]
        L, rows, _ = engine._bucket_shape(st, idx)
        ms = [st.ms_padded[i] for i in idx]
        gms = [st2.ms_padded[i] for i in idx]
        for mh, mg in zip(ms, gms):
            assert guest_base(mh, mg, L, rows) == ref_guest_base(mh, mg, L,
                                                                 rows)
        skip = tuple(j for j, b in enumerate(entry[2]) if b is None)
        assert (pair_bucket_bases(ms, gms, L, rows, skip)
                == ref_pair_bases(ms, gms, L, rows, skip) == entry[2])
    assert plan_occupancy(plan) == ref_occupancy(ref)


def test_float32_wire_pairs_nothing():
    """The float32 wire runs every stage whole through K2: no lane
    bucket, no pair, though the quantised wires pair."""
    plan = periodogram_plan(*PAIRED)
    assert engine._row_pack_map(plan, "uint6")
    assert engine._row_pack_map(plan, "float32") == {}
    lay = engine.launch_layout(plan, "float32")
    assert lay.absorbed == ()
    assert [(ln.kind, ln.stage, ln.bucket) for ln in lay.launches] == [
        ("cascade_stage", s, None) for s in range(len(plan.stages))]
    assert plan_occupancy(plan, "float32")["pairs"] == 0


@pytest.mark.parametrize("mode", ["uint6", "float32"])
def test_layout_built_once_per_plan_and_mode(monkeypatch, mode):
    """The layout is built at the first call for a (plan, wire mode) and
    every later call, the stage loop's included, returns that object."""
    builds = []
    build = engine._build_layout
    monkeypatch.setattr(engine, "_build_layout",
                        lambda *a: builds.append(a[1]) or build(*a))
    plan = periodogram_plan(*PAIRED)
    plan.__dict__.pop("_layouts", None)
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", mode)
    lay = engine.launch_layout(plan, mode)
    assert engine.launch_layout(plan, mode) is lay
    data = np.random.default_rng(3).standard_normal(plan.size).astype(
        np.float32)
    with engine.recording() as rec:
        run_periodogram(plan, data, device="cpu")
        run_periodogram(plan, data, device="cpu")
    assert rec["layout"] is lay
    assert engine.queued_launches(plan, mode) == engine.queued_launches(
        plan, mode)
    assert builds == [mode]
    other = "float32" if mode == "uint6" else "uint6"
    assert engine.launch_layout(plan, other) is not lay
    assert builds == [mode, other]


@pytest.mark.parametrize("cfg", ["e2e", "split", "example_long"])
def test_layout_launches_are_the_recorded_launches(cfg):
    """The layout's launch list is the launches a search queues, in
    order, with their kind, stage, lane bucket and guest stage, and its
    pieces assemble the search's S/N."""
    plan = periodogram_plan(*CONFIGS[cfg])
    data = np.random.default_rng(11).standard_normal(plan.size).astype(
        np.float32)
    with engine.recording() as rec:
        _, _, snrs = run_periodogram(plan, data, device="cpu")
    lay = engine.launch_layout(plan, "uint6")
    assert rec["layout"] is lay
    assert [(r["kind"], r["stage"], r["bucket"], r.get("guest"))
            for r in rec["launches"]] == [
        (ln.kind, ln.stage, ln.bucket, ln.guest) for ln in lay.launches]
    assert len(lay.pieces) == sum(re > 0 for st in plan.stages
                                  for re in st.rows_eval)
    if cfg == "example_long":
        assert sum(ln.kind == "paired_stage" for ln in lay.launches) == 6
    np.testing.assert_array_equal(engine._assemble_device(
        plan, lay.pieces, rec["outs"])[0].numpy(), snrs)


@pytest.mark.parametrize("cfg", ["paired", "split"])
def test_layout_rows_bitwise_whole_stage(cfg):
    """Every trial's S/N rows, in its lane bucket's container or riding
    a host's dead rows, are bitwise those of its whole stage in one
    container (the whole-stage K1 that stages too shallow for lane
    buckets run)."""
    plan = periodogram_plan(*CONFIGS[cfg])
    data = np.random.default_rng(5).standard_normal((2, plan.size)).astype(
        np.float32)
    with engine.recording() as rec:
        engine.run_periodogram_batch(plan, data, device="cpu")
    wire, meta = rec["wire"], rec["meta"]
    cpu = torch.device("cpu")
    whole = {}

    def stage_rows(s):
        if s not in whole:
            st = plan.stages[s]
            tables, coefs = engine._stage_operands(st, plan, cpu)
            whole[s] = fk.fused_stage_plain(
                wire, meta["scales_dev"], engine.stage_geom(meta, s, st.n),
                tables, coefs)
        return whole[s]

    kinds = set()
    for r in rec["launches"]:
        if r["bucket"] is None:
            continue
        kinds.add(r["kind"])
        st = plan.stages[r["stage"]]
        idx = st.lane_buckets[r["bucket"]]
        want = stage_rows(r["stage"])
        for j, g in enumerate(idx):
            re = st.rows_eval[g] if g < len(st.rows_eval) else 0
            assert torch.equal(r["out"][:, j, :re], want[:, g, :re])
        if r.get("guest") is not None:
            st2 = plan.stages[r["guest"]]
            gwant = stage_rows(r["guest"])
            for j, (g, base) in enumerate(zip(idx,
                                              r["args"][-2].gbase.tolist())):
                re = st2.rows_eval[g] if g < len(st2.rows_eval) else 0
                if base >= 0:
                    assert torch.equal(r["out"][:, j, base : base + re],
                                       gwant[:, g, :re])
    assert kinds == ({"fused_stage", "paired_stage"} if cfg == "paired"
                     else {"fused_stage"})


def _uint8_wire(ns, PW=128, seed=3):
    """A hand-made uint8 byte-plane wire of one series per stage:
    (1, rows, PW) bytes, (1, rows) scales, and each stage's geometry."""
    rng = np.random.default_rng(seed)
    geoms, roff = [], 0
    for n in ns:
        r0 = -(-n // PW)
        geoms.append(fk.StageGeom("uint8", roff, r0, roff, r0, n))
        roff += r0
    wire = rng.integers(1, 256, size=(1, roff, PW), dtype=np.uint8)
    scales = rng.uniform(0.05, 0.2, size=(1, roff)).astype(np.float32)
    return torch.from_numpy(wire), torch.from_numpy(scales), geoms


def _paired_case():
    """The tests/test_row_pack.py ``_paired_case`` geometry (a lone
    trial without a guest, an m = 1 padding host) on a uint8 wire, in a
    2^L-row container (the JAX test's ``RIPTIDE_KERNEL_BASE3=0``
    height): the port's paired and unpaired operands, and the wire."""
    ms, ps, gms = [200, 190, 1], [33, 40, 33], [24, 30, 1]
    widths = (1, 2, 3)
    L = max(num_levels(m) for m in ms)
    rows = 1 << L
    bases = [guest_base(m, gm, L, rows) for m, gm in zip(ms, gms)]
    bases[1] = None
    B, nw = len(ms), len(widths)
    h = np.zeros((B, nw), np.float32)
    b = np.zeros_like(h)
    for i, p in enumerate(ps):
        h[i], b[i] = boxcar_coeffs(p, widths)
    std = np.linspace(1.0, 2.0, B).astype(np.float32)
    gstd = np.linspace(1.5, 2.5, B).astype(np.float32)
    R, P = rows + 1, max(ps)
    pair = FFABatchPlan(ms, ps, R=R, P=P, L=L, guests=[
        None if bb is None else (gm, bb) for gm, bb in zip(gms, bases)])
    alone = FFABatchPlan(ms, ps, R=R, P=P, L=L)
    RE = max(ms + [bb + gm for gm, bb in zip(gms, bases) if bb is not None])
    cpu = torch.device("cpu")
    tables, coefs = engine._operands(pair, widths, h, b, std, RE, cpu,
                                     guest=(h, b, gstd))
    t0, c0 = engine._operands(alone, widths, h, b, std, RE, cpu)
    wire, scales, (geom, ggeom) = _uint8_wire(
        [max(m * p for m, p in zip(ms, ps)),
         max(m * p for m, p in zip(gms, ps))])
    return dict(ms=ms, ps=ps, gms=gms, bases=bases, widths=widths, h=h,
                b=b, std=std, gstd=gstd, tables=tables, coefs=coefs, t0=t0,
                c0=c0, wire=wire, scales=scales, geom=geom, ggeom=ggeom,
                rows=rows)


def test_paired_stage_plain_matches_pallas_k3(monkeypatch):
    # The JAX kernel's container height is 2^L under its BASE3=0.
    _ref_layout(monkeypatch, BASE3="0")
    c = _paired_case()
    got = fk.paired_stage(c["wire"], c["scales"], c["geom"], c["ggeom"],
                          c["tables"], c["coefs"])[0].numpy()
    # The same decoded samples, packed as the JAX kernel's container.
    xh = fk._decode(c["wire"], c["scales"], c["geom"])[0].numpy()
    xg = fk._decode(c["wire"], c["scales"], c["ggeom"])[0].numpy()
    kern = CycleKernel(c["ms"], c["ps"], c["widths"], c["h"], c["b"],
                       c["std"], interpret=True,
                       guests=dict(ms=c["gms"], bases=c["bases"],
                                   hcoef=c["h"], bcoef=c["b"],
                                   stdnoise=c["gstd"]))
    assert kern.rows == c["rows"]
    x = np.zeros((len(c["ms"]), kern.rows, kern.P), np.float32)
    for i, (m, p, gm, bb) in enumerate(zip(c["ms"], c["ps"], c["gms"],
                                           c["bases"])):
        x[i, :m, :p] = xh[: m * p].reshape(m, p)
        if bb is not None:
            x[i, bb : bb + gm, :p] = xg[: gm * p].reshape(gm, p)
    want = np.asarray(kern(x))[..., : len(c["widths"])]
    for i, (m, gm, bb) in enumerate(zip(c["ms"], c["gms"], c["bases"])):
        np.testing.assert_allclose(got[i, :m], want[i, :m], rtol=RTOL,
                                   atol=ATOL)
        if bb is not None:
            np.testing.assert_allclose(got[i, bb : bb + gm],
                                       want[i, bb : bb + gm], rtol=RTOL,
                                       atol=ATOL)


def test_paired_rows_bitwise_unpaired():
    """Host rows equal the unpaired K1 on the host alone, guest rows the
    unpaired K1 on the guest stage alone (its own container), bit for
    bit: the guest rides only in dead rows, with its own tree and
    coefficients."""
    c = _paired_case()
    got = fk.paired_stage_plain(c["wire"], c["scales"], c["geom"],
                                c["ggeom"], c["tables"], c["coefs"])
    host = fk.fused_stage_plain(c["wire"], c["scales"], c["geom"], c["t0"],
                                c["c0"])
    ms, ps, gms = c["ms"], c["ps"], c["gms"]
    gplan = FFABatchPlan(gms, ps)
    gt, gc = engine._operands(gplan, c["widths"], c["h"], c["b"], c["gstd"],
                              max(gms), torch.device("cpu"))
    guest = fk.fused_stage_plain(c["wire"], c["scales"], c["ggeom"], gt, gc)
    for i, (m, gm, bb) in enumerate(zip(ms, gms, c["bases"])):
        assert torch.equal(got[:, i, :m], host[:, i, :m])
        if bb is not None:
            assert torch.equal(got[:, i, bb : bb + gm], guest[:, i, :gm])


@pytest.mark.parametrize("cfg,flags", [
    ("e2e", {}),
    ("e2e", {"BASE3": "0"}),
    ("split4", {"LANE_SPLIT": "0"}),
    ("split4", {"BASE3": "0", "ROW_PACK": "0"}),
], ids=["e2e-defaults", "e2e-pow2", "split-one-bucket", "split-no-pack"])
def test_run_periodogram_layout_invariant(monkeypatch, cfg, flags):
    """The port's one layout gives the S/N of the JAX package's kernel
    path under each of its container layouts (its lane split, base-3
    heights and row packing on or off), within the S/N's summation
    order; the port's recorded launches are its layout's."""
    plan = periodogram_plan(*CONFIGS[cfg])
    data = np.random.default_rng(17).standard_normal(plan.size).astype(
        np.float32)
    with engine.recording() as rec:
        _, _, snrs = run_periodogram(plan, data, device="cpu")
    kinds = [r["kind"] for r in rec["launches"]]
    want = engine.queued_launches(plan)
    assert kinds.count("fused_stage") == want["fused_stage"] > 0
    assert kinds.count("paired_stage") == want["paired_stage"]
    _ref_layout(monkeypatch, **flags)
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "kernel")
    _, _, ref = ref_run_periodogram(ref_plan(*CONFIGS[cfg]), data)
    np.testing.assert_allclose(snrs, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("guest", [(24, 199), (24, 233), (1, 256)],
                         ids=["over-host", "over-zero-row", "at-zero-row"])
def test_paired_plan_refuses_a_misfit_guest(guest):
    """A guest must lie between its host's rows and the zero row."""
    with pytest.raises(ValueError, match="does not fit"):
        FFABatchPlan([200], [33], R=257, P=33, L=8, guests=[guest])
