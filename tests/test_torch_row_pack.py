"""
Lane buckets, row-packed containers and K3 of the port against the JAX
package's, on the CPU.

* Layout decisions: the port's lane buckets, container heights, guest
  bases, pairing map and occupancy equal the JAX package's, at the
  row-pack e2e configuration of tests/test_row_pack.py (5 stages, stage
  0 hosts stage 2 under ``RIPTIDE_KERNEL_BASE3=0``) and at the headline
  plan of BASELINE.md (10 pairs under BASE3=0, none by default).
* ``paired_stage_plain`` (K3's plain version) matches the JAX package's
  paired ``CycleKernel`` in interpret mode on the ``_paired_case``
  geometry of tests/test_row_pack.py, within rtol 1e-5, atol 1e-4 (the
  S/N's summation order, tests/test_torch_ffa_stage.py), and its host
  and guest rows are bitwise those of the unpaired ``fused_stage_plain``.
* Per-trial results do not depend on the layout: ``run_periodogram``
  gives bitwise the same S/N with row packing, the lane split and the
  base-3 containers on and off.
"""
import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.ops.ffa_kernel import CycleKernel
from riptide_tpu.ops.plan import pair_bucket_bases as ref_pair_bases
from riptide_tpu.ops.slottables import guest_base as ref_guest_base
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu.search.plan import plan_occupancy as ref_occupancy
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
CONFIGS = {"e2e": E2E, "headline": HEADLINE, "split": SPLIT}
FLAGS = ("RIPTIDE_KERNEL_BASE3", "RIPTIDE_KERNEL_ROW_PACK",
         "RIPTIDE_KERNEL_LANE_SPLIT")


def _set_flags(monkeypatch, **flags):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    for name, value in flags.items():
        monkeypatch.setenv(f"RIPTIDE_KERNEL_{name}", value)


@pytest.mark.parametrize("cfg,flags,pairs", [
    ("e2e", {"BASE3": "0"}, 1),
    ("e2e", {}, None),
    ("headline", {"BASE3": "0"}, 10),
    ("headline", {}, 0),
    ("split", {"BASE3": "0"}, None),
    ("split", {"LANE_SPLIT": "0", "BASE3": "0"}, None),
])
def test_layout_decisions_match_reference(monkeypatch, cfg, flags, pairs):
    _set_flags(monkeypatch, **flags)
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
    if pairs is not None:
        assert sum(v[0] == "host" for v in rpm.values()) == pairs
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


def test_row_pack_off_empties_the_map(monkeypatch):
    _set_flags(monkeypatch, BASE3="0", ROW_PACK="0")
    plan = periodogram_plan(*E2E)
    assert engine._row_pack_map(plan, "uint6") == {}
    assert engine._row_pack_map(plan, "float32") == {}
    assert plan_occupancy(plan)["pairs"] == 0


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


def _paired_case(monkeypatch):
    """The tests/test_row_pack.py ``_paired_case`` geometry (a lone
    trial without a guest, an m = 1 padding host) on a uint8 wire: the
    port's paired and unpaired operands, and the wire."""
    _set_flags(monkeypatch, BASE3="0")
    ms, ps, gms = [200, 190, 1], [33, 40, 33], [24, 30, 1]
    widths = (1, 2, 3)
    L = max(num_levels(m) for m in ms)
    rows = fk.bucket_rows(ms, L)
    assert rows == 1 << L
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
    c = _paired_case(monkeypatch)
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


def test_paired_rows_bitwise_unpaired(monkeypatch):
    """Host rows equal the unpaired K1 on the host alone, guest rows the
    unpaired K1 on the guest stage alone (its own container), bit for
    bit: the guest rides only in dead rows, with its own tree and
    coefficients."""
    c = _paired_case(monkeypatch)
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


@pytest.mark.parametrize("cfg,flag,base", [
    ("e2e", "ROW_PACK", {"BASE3": "0"}),
    ("e2e", "BASE3", {}),
    ("split", "LANE_SPLIT", {}),
    ("split", "ROW_PACK", {"BASE3": "0"}),
])
def test_run_periodogram_layout_invariant(monkeypatch, cfg, flag, base):
    """The S/N cube is the same bits with the flag on and off; the
    recorded launches show the layouts really differ."""
    plan = periodogram_plan(*CONFIGS[cfg])
    data = np.random.default_rng(17).standard_normal(plan.size).astype(
        np.float32)
    runs = {}
    for value in ("1", "0"):
        _set_flags(monkeypatch, **base, **{flag: value})
        with engine.recording() as rec:
            _, _, snrs = run_periodogram(plan, data, device="cpu")
        kinds = [r["kind"] for r in rec["launches"]]
        want = engine.queued_launches(plan)
        assert kinds.count("fused_stage") == want["fused_stage"]
        assert kinds.count("paired_stage") == want["paired_stage"]
        runs[value] = snrs, kinds
    np.testing.assert_array_equal(runs["1"][0], runs["0"][0])
    assert runs["1"][1] != runs["0"][1] or flag == "BASE3"
    if flag == "ROW_PACK":
        assert "paired_stage" in runs["1"][1]
        assert "paired_stage" not in runs["0"][1]
    if flag == "LANE_SPLIT":
        assert len(runs["1"][1]) > len(runs["0"][1])


@pytest.mark.parametrize("guest", [(24, 199), (24, 233), (1, 256)],
                         ids=["over-host", "over-zero-row", "at-zero-row"])
def test_paired_plan_refuses_a_misfit_guest(guest):
    """A guest must lie between its host's rows and the zero row."""
    with pytest.raises(ValueError, match="does not fit"):
        FFABatchPlan([200], [33], R=257, P=33, L=8, guests=[guest])
