"""
The CUDA stage kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: skipped on a host without one (the default CPU suite);
run on a card with ``python -m pytest tests/test_torch_kernels_cuda.py``.
Tolerance as in chip_smoke.py: the decoded and FFA-summed containers are
bit-identical, and the S/N differs only by the prefix sum's summation
order (rtol 1e-5, atol 1e-4).
"""
import numpy as np
import pytest
import torch

from riptide_tpu_torch.ops import ffa_kernel as fk
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.search.plan import periodogram_plan

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4
CFG = (2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case():
    plan = periodogram_plan(*CFG)
    rng = np.random.default_rng(21)
    return plan, rng.standard_normal((3, CFG[0])).astype(np.float32)


@pytest.mark.parametrize("mode", ["uint6", "uint8", "uint12"])
def test_fused_stage_matches_plain(dev, case, mode):
    plan, batch = case
    wire, meta = engine.ship_stage_data(
        engine.prepare_stage_data(plan, batch, mode=mode), dev)
    vl = meta["view"]
    for i, st in enumerate(plan.stages):
        tables, coefs = engine._stage_operands(st, plan, dev)
        geom = fk.StageGeom(mode, int(vl["roffs"][i]), int(vl["prs"][i]),
                            int(vl["soffs"][i]), int(vl["r0s"][i]), st.n)
        before = dict(fk.LAUNCHES)
        got = fk.fused_stage(wire, meta["scales_dev"], geom, tables, coefs)
        assert fk.LAUNCHES["fused_stage"] == before["fused_stage"] + 1
        want = fk.fused_stage_plain(wire, meta["scales_dev"], geom, tables,
                                    coefs)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_cascade_stage_matches_plain(dev, case):
    plan, batch = case
    flat, meta = engine.ship_stage_data(
        engine.prepare_stage_data(plan, batch, mode="float32"), dev)
    for i, st in enumerate(plan.stages):
        tables, coefs = engine._stage_operands(st, plan, dev)
        off = int(meta["offs"][i])
        container = engine._pack(flat[:, off : off + st.n], tables.p,
                                 tables.m, st.batch.R, tables.P)
        want = fk.cascade_stage_plain(container, tables, coefs)
        got = fk.cascade_stage(container.clone(), tables, coefs)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_run_periodogram_card_matches_cpu(dev, case):
    plan, batch = case
    _, _, cpu = engine.run_periodogram_batch(plan, batch, device="cpu")
    _, _, gpu = engine.run_periodogram_batch(plan, batch, device=dev)
    np.testing.assert_allclose(gpu, cpu, rtol=RTOL, atol=ATOL)


# A plan whose layout pairs one lane bucket (stage 6 hosts stage 12).
PAIRED = (16384, 1e-3, (1, 2, 3), 0.032, 4.0, 32, 40)


@pytest.fixture()
def paired():
    """The PAIRED plan (one K3 launch a search) and a D = 2 batch."""
    plan = periodogram_plan(*PAIRED)
    assert engine.queued_launches(plan)["paired_stage"] == 1
    rng = np.random.default_rng(4)
    return plan, rng.standard_normal((2, PAIRED[0])).astype(np.float32)


def test_paired_stage_matches_plain(dev, paired):
    plan, batch = paired
    with engine.recording() as rec:
        engine.run_periodogram_batch(plan, batch, device=dev)
    calls = [r for r in rec["launches"] if r["kind"] == "paired_stage"]
    assert len(calls) == 1
    for r in calls:
        before = fk.LAUNCHES["paired_stage"]
        again = fk.paired_stage(*r["args"])
        assert fk.LAUNCHES["paired_stage"] == before + 1
        want = fk.paired_stage_plain(*r["args"])
        torch.testing.assert_close(r["out"], want, rtol=RTOL, atol=ATOL)
        assert torch.equal(again, r["out"])


def test_run_search_batch_card_matches_cpu(dev, paired):
    plan, batch = paired
    tobs = PAIRED[0] * PAIRED[1]
    kw = dict(smin=6.0, segwidth=0.2, nstd=6.0, minseg=10)
    cpu_h = engine.queue_search_batch(plan, batch, tobs, device="cpu", **kw)
    gpu_h = engine.queue_search_batch(plan, batch, tobs, device=dev, **kw)
    np.testing.assert_allclose(engine.search_snr_dev(gpu_h).cpu().numpy(),
                               engine.search_snr_dev(cpu_h).numpy(),
                               rtol=RTOL, atol=ATOL)
    cpu, _ = engine.collect_search_batch(cpu_h, np.zeros(2))
    gpu, _ = engine.collect_search_batch(gpu_h, np.zeros(2))
    for c, g in zip(cpu, gpu):
        assert [(p.iw, p.ip) for p in c] == [(p.iw, p.ip) for p in g]
        np.testing.assert_allclose([p.snr for p in g], [p.snr for p in c],
                                   rtol=RTOL, atol=ATOL)


SPLIT = (8192, 1e-3, (1, 2, 3), 0.125, 0.3, 120, 136)


@pytest.mark.parametrize("cfg", [PAIRED, SPLIT], ids=["row-pack",
                                                      "lane-split"])
def test_layouts_bitwise_on_card(dev, cfg):
    """On the card too, a trial's S/N is the same bits in its lane
    bucket's container, riding a host's dead rows (K3) and in its whole
    stage's one container (the K1 that shallow stages run): the S/N
    kernel's scan order depends on p alone."""
    plan = periodogram_plan(*cfg)
    batch = np.random.default_rng(6).standard_normal((2, cfg[0])).astype(
        np.float32)
    with engine.recording() as rec:
        engine.run_periodogram_batch(plan, batch, device=dev)
    wire, meta = rec["wire"], rec["meta"]
    whole = {}

    def stage_rows(s):
        if s not in whole:
            st = plan.stages[s]
            tables, coefs = engine._stage_operands(st, plan, dev)
            whole[s] = fk.fused_stage(wire, meta["scales_dev"],
                                      engine.stage_geom(meta, s, st.n),
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
    assert kinds == ({"fused_stage", "paired_stage"} if cfg is PAIRED
                     else {"fused_stage"})


def test_wrapper_refuses_bad_input(dev, case):
    plan, _ = case
    st = plan.stages[0]
    tables, coefs = engine._stage_operands(st, plan, dev)
    bad = torch.zeros((1, st.batch.B, st.batch.R, tables.P), device=dev,
                      dtype=torch.float64)
    with pytest.raises(ValueError):
        fk.cascade_stage(bad, tables, coefs)


# Tile-edge containers of the segment kernel: (ms, ps, guests). A plane
# of width p fits tiles of MAX_DYNAMIC_SMEM // (8 p) rows: 113 at p =
# 256, 2 at the widest p the S/N kernel takes, 3632 at p = 8.
P_WIDE = fk.MAX_DYNAMIC_SMEM // (4 * fk.SNR_WARPS)
EDGES = {
    "cap113": ([113, 114, 226, 227, 1], [256, 255, 256, 250, 256], None),
    "cap2": ([1, 2, 3, 5, 8], [P_WIDE] * 5, None),
    "cap3632": ([3632, 3633, 7], [8, 8, 5], None),
    "paired": ([200, 190, 1], [33, 40, 33], [(24, 208), None, (1, 2)]),
    "paired-cap113": ([113, 100], [256, 256], [(114, 120), (56, 128)]),
    # Guests right above their hosts: one tile holds host and guest rows.
    "paired-adjacent": ([100, 60], [64, 61], [(50, 100), (30, 60)]),
    # No row pair fits a tile (p > 14,528): one-row tiles written
    # straight to the container, no tile-local level; the wide level and
    # S/N forms (P > 14,528), one S/N block a row up to 58,112, a cluster
    # of two above. P just past each limit, p not a multiple of 4, P a
    # multiple of 4 (the float4 paths) or not.
    "direct": ([3, 1, 5], [30000, 14529, 60001], None),
    "direct-paired": ([3, 2], [20000, 20001], [(2, 4), None]),
    "wide-ragged": ([3, 2, 5], [14529, 14531, 14530], None),
    "wide-vec": ([5, 3], [30001, 30004], None),
    "wide-cluster": ([2, 3], [58113, 58115], None),
    "wide-cluster-vec": ([3, 2], [58117, 58120], None),
    "wide-paired": ([3, 2], [29057, 29059], [(2, 3), None]),
    # S/N clusters of four and eight blocks.
    "wide-cluster4": ([3], [116229], None),
    "wide-cluster8": ([2], [232451], None),
}
WIDE_EDGES = ("direct", "direct-paired", "wide-ragged", "wide-vec",
              "wide-cluster", "wide-cluster-vec", "wide-paired",
              "wide-cluster4", "wide-cluster8")
# The S/N clusters' sizes (one block a row for the others).
CLUSTERS = {"direct": 2, "wide-cluster": 2, "wide-cluster-vec": 2,
            "wide-cluster4": 4, "wide-cluster8": 8}
# S/N widths of the wide stage checks: a window that wraps at every p.
WIDTHS = (1, 3, 17, 200, 4096)


def _edge_case(name, mode, dev, D=2, PW=64, seed=5, widths=(1,),
               centered=False):
    """The container's plan, Tables on ``dev``, and its three sources: a
    hand-made byte-plane wire of mode ``mode`` holding the host stage
    (and the guest stage), and a packed float container of the same
    samples. The wire is random bytes or, with ``centered`` (uint6),
    6-bit values drawn around the quantiser's zero, 32, as a search's
    normalised series gives them. The S/N coefficients are each trial's
    boxcar coefficients of ``widths`` (every row evaluated; guest trials
    take a noise level 1.25 times the host's, so that their rows
    differ)."""
    from riptide_tpu_torch.ops.plan import FFABatchPlan
    from riptide_tpu_torch.ops.snr import boxcar_coeffs

    ms, ps, guests = EDGES[name]
    R = max([m + 1 for m in ms] + [g[0] + g[1] + 1 for g in guests or ()
                                   if g])
    b = FFABatchPlan(ms, ps, R=R, guests=guests)
    B = b.B

    def coefs(noise):
        hb = [boxcar_coeffs(int(p), widths) for p in b.p]
        return (np.array([h for h, _ in hb], np.float32),
                np.array([c for _, c in hb], np.float32),
                np.full(B, noise, np.float32))

    tables, snr_coefs = engine._operands(
        b, widths, *coefs(2.5), R, dev,
        guest=None if guests is None else coefs(3.125))
    group, planes = fk.WIRE_MODES[mode]
    rng = np.random.default_rng(seed)
    geoms, roff, soff = [], 0, 0
    for span in (tables.span, tables.gspan if guests else 0):
        if not span:
            continue
        r0 = -(-span // PW)
        pr = -(-r0 // group)
        geoms.append(fk.StageGeom(mode, roff, pr, soff, r0, span))
        roff, soff = roff + planes * pr, soff + r0
    wire = rng.integers(0, 256, (D, roff, PW), dtype=np.uint8)
    if centered:
        assert mode == "uint6"
        for g in geoms:
            v = np.clip(np.rint(rng.normal(32.0, 8.0, (D, g.pr, 4, PW))), 0,
                        63).astype(np.int64)
            word = v[:, :, 0] | v[:, :, 1] << 6 | v[:, :, 2] << 12 | \
                v[:, :, 3] << 18
            for k in range(3):
                wire[:, g.roff + k * g.pr: g.roff + (k + 1) * g.pr] = \
                    word >> (8 * k) & 255
    wire = torch.from_numpy(wire).to(dev)
    scales = torch.from_numpy(rng.uniform(0.05, 0.2, (D, soff)).astype(
        np.float32)).to(dev)
    src = fk.WireSource(wire, scales, *geoms)
    return b, tables, src, fk.fill_plain(src, tables), snr_coefs


@pytest.mark.parametrize("name", sorted(EDGES))
@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_segment_kernel_bitwise_at_tile_edges(dev, name, kind):
    """The container after the segment kernel and after each global
    level is segment_levels_plain's, bit for bit (signs of zeros
    included): from the wire (K1; K3 where the container carries
    guests) and from the packed float container (K2)."""
    b, tables, wsrc, packed, _ = _edge_case(name, "uint6", dev)
    src = wsrc if kind == "K1" else packed.clone()
    L = tables.h.shape[0]
    for g in range(L - tables.local + 1):
        before = dict(fk.KERNEL_LAUNCHES)
        got = fk.segment_levels(src, tables, g)
        form = "segment_wire" if kind == "K1" else "segment_container"
        assert fk.KERNEL_LAUNCHES[form] == before[form] + 1
        assert fk.KERNEL_LAUNCHES["ffa_level"] == before["ffa_level"] + g
        want = fk.segment_levels_plain(src, tables, g)
        assert torch.equal(got, want), (name, kind, g)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
    if kind == "K2":
        assert torch.equal(src, packed)


@pytest.mark.parametrize("mode", ["uint8", "uint12"])
def test_segment_kernel_decodes_every_wire_mode(dev, mode):
    for name in ("cap113", "paired"):
        _, tables, src, _, _ = _edge_case(name, mode, dev)
        assert torch.equal(fk.segment_levels(src, tables, 0),
                           fk.segment_levels_plain(src, tables, 0))


@pytest.mark.parametrize("name", WIDE_EDGES)
@pytest.mark.parametrize("kind", ["K1", "K2"])
def test_wide_stage_matches_plain(dev, name, kind):
    """Whole stages past P = 14,528 (the column-split levels, the S/N a
    block or a cluster a row): K1 (K3 where the container carries
    guests, each guest row with its own coefficients) from the wire and
    K2 from the packed container, against the plain versions, with
    windows that wrap; one launch of each CUDA kernel a level. The
    wire's values are zero-mean, as a search's are: on uniform bytes
    (mean -0.5 a quantum) a row's prefix sums reach 10^4, and the
    kernel's and the plain version's summation orders (the narrow
    kernel's and torch.cumsum's) then differ by more than atol."""
    b, tables, wsrc, packed, coefs = _edge_case(name, "uint6", dev,
                                                widths=WIDTHS, centered=True)
    assert tables.P > fk.NARROW_P and tables.local == 0
    assert fk.snr_launch(tables.P).cluster == CLUSTERS.get(name, 1)
    before = dict(fk.KERNEL_LAUNCHES)
    if kind == "K2":
        want = fk.cascade_stage_plain(packed, tables, coefs)
        got = fk.cascade_stage(packed.clone(), tables, coefs)
    elif wsrc.guest is None:
        want = fk.fused_stage_plain(*wsrc[:3], tables, coefs)
        got = fk.fused_stage(*wsrc[:3], tables, coefs)
    else:
        want = fk.paired_stage_plain(*wsrc, tables, coefs)
        got = fk.paired_stage(*wsrc, tables, coefs)
    L = tables.h.shape[0]
    assert fk.KERNEL_LAUNCHES["ffa_level"] == before["ffa_level"] + L
    assert fk.KERNEL_LAUNCHES["boxcar_snr"] == before["boxcar_snr"] + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if wsrc.guest is not None:
        # The guest rows took the guest's coefficients.
        host = fk.cascade_stage_plain(packed, tables._replace(
            gm=None, gbase=None), coefs)
        assert not torch.allclose(host, want)


@pytest.mark.parametrize("wide_p", [14531, 30004, 58113, 60001, 120001])
def test_wide_snr_has_the_narrow_bits(dev, wide_p):
    """A trial of p <= 14,528 gives the same S/N bits in a narrow
    container (P = its p: four rows a block) and in a container widened
    past 14,528 by a wider trial (the wide S/N kernel: a block, or a
    cluster past 58,112, a row): the wide form keeps the order of the
    sums."""
    from riptide_tpu_torch.ops.plan import FFABatchPlan

    m, p = 23, 14013
    rng = np.random.default_rng(wide_p)
    x = rng.standard_normal((2, m, p)).astype(np.float32)
    x[:, :, ::7] *= 40.0
    outs = []
    for ms, ps in (([m], [p]), ([m, 9], [p, wide_p])):
        b = FFABatchPlan(ms, ps, R=m + 1)
        B = b.B
        coef = np.tile(np.float32([1.25, 0.75, 2.0, 1.5, 0.5]), (B, 1))
        tables, coefs = engine._operands(
            b, WIDTHS, coef, -0.1 * coef, np.full(B, 2.5, np.float32),
            m, dev)
        cont = np.zeros((2, B, m + 1, b.P), np.float32)
        cont[:, 0, :m, :p] = x
        if B > 1:
            cont[:, 1, :9, :wide_p] = rng.standard_normal((2, 9, wide_p))
        assert (b.P > fk.NARROW_P) == (B > 1)
        outs.append(fk.cascade_stage(torch.from_numpy(cont).to(dev), tables,
                                     coefs)[:, 0])
    assert torch.equal(outs[0], outs[1])


def test_stage_counts_cuda_launches(dev, case):
    """A K1 call is one segment launch from the wire, one level launch
    per level past the tiles and one S/N launch, counted as a K1 call
    only; a K2 call the same with the segment kernel's container form."""
    plan, batch = case
    wire, meta = engine.ship_stage_data(
        engine.prepare_stage_data(plan, batch, mode="uint6"), dev)
    st = plan.stages[0]
    tables, coefs = engine._stage_operands(st, plan, dev)
    fk.reset_launches()
    fk.fused_stage(wire, meta["scales_dev"], engine.stage_geom(meta, 0, st.n),
                   tables, coefs)
    levels = tables.h.shape[0] - tables.local
    assert fk.LAUNCHES == {"fused_stage": 1, "cascade_stage": 0,
                           "paired_stage": 0}
    assert fk.KERNEL_LAUNCHES == {"segment_wire": 1, "segment_container": 0,
                                  "ffa_level": levels, "boxcar_snr": 1}
    fk.reset_launches()
    fk.cascade_stage(fk.fill_plain(fk.WireSource(
        wire, meta["scales_dev"], engine.stage_geom(meta, 0, st.n)), tables),
        tables, coefs)
    assert fk.LAUNCHES == {"fused_stage": 0, "cascade_stage": 1,
                           "paired_stage": 0}
    assert fk.KERNEL_LAUNCHES == {"segment_wire": 0, "segment_container": 1,
                                  "ffa_level": levels, "boxcar_snr": 1}


def test_cuda_operands_ship_the_segment_plan(dev, case):
    """The CUDA operands carry the container's segment plan, built once
    and cached with them."""
    plan, _ = case
    st = plan.stages[0]
    t1, _ = engine._stage_operands(st, plan, dev)
    t2, _ = engine._stage_operands(st, plan, dev)
    assert t1 is t2
    seg = st.batch.segments
    assert t1.tiles.device.type == "cuda"
    np.testing.assert_array_equal(t1.tiles.cpu().numpy(), seg.tiles)
    assert (t1.local, t1.smem) == (seg.levels, seg.smem)


# Searches across the kernels' wide-phase limits (as chip_smoke.py's
# phase 5w, shorter): the limit the padded width P crosses, nsamp,
# tsamp, bins_min, bins_max.
WIDE = ((14528, 2 ** 17, 16e-6, 16000, 16004),
        (29056, 2 ** 18, 16e-6, 30000, 30004),
        (58112, 2 ** 19, 16e-6, 60000, 60004))


@pytest.mark.parametrize("wide", WIDE, ids=[str(w[0]) for w in WIDE])
@pytest.mark.parametrize("mode,kind", [("uint6", "fused_stage"),
                                       ("float32", "cascade_stage")])
def test_wide_phase_matches_plain(dev, monkeypatch, wide, mode, kind):
    """A plan whose padded P crosses each limit runs through K1 (uint6)
    and K2 (float32) on the card, no ValueError, every launch within
    the tolerance of its plain version."""
    limit, nsamp, tsamp, bmin, bmax = wide
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", mode)
    plan = periodogram_plan(nsamp, tsamp, (1, 2, 4, 8), bmax * tsamp,
                            1.001 * bmax * tsamp, bmin, bmax)
    assert plan.P > limit
    data = np.random.default_rng(8).standard_normal(nsamp).astype(np.float32)
    fk.reset_launches()
    with engine.recording() as rec:
        _, _, snrs = engine.run_periodogram(plan, data, device=dev)
    assert fk.LAUNCHES[kind] == engine.queued_launches(plan)[kind] > 0
    assert np.isfinite(snrs).all()
    calls = [r for r in rec["launches"] if r["kind"] == kind]
    plain = getattr(fk, f"{kind}_plain")
    for r in calls:
        torch.testing.assert_close(r["out"], plain(*r["args"]), rtol=RTOL,
                                   atol=ATOL)
    # Past 14,528 no row pair fits a segment tile: no tile-local level.
    assert {r["args"][-2].local for r in calls} == {0}


def test_native_pinned_copy_stream_matches_numpy_plain_ship(dev, case,
                                                            monkeypatch):
    """The native prep into pinned pool buffers, shipped on the copy
    stream, gives the S/N bits of a search whose wire the numpy path
    made and a plain .to(device) shipped."""
    from riptide_tpu_torch import native

    if not native.available():
        pytest.skip("the native runtime did not build")
    plan, batch = case
    pool = engine.StagingPool(dev)
    prepared = engine.prepare_stage_data(plan, batch, mode="uint6", pool=pool)
    assert prepared[1]["prep"] == "native"
    assert all(t.is_pinned() for t in prepared[1]["staging"])
    shipped = engine.ship_stage_data(prepared, dev)
    got = engine._queue_batch(plan, None, dev, shipped=shipped)[0]
    monkeypatch.setattr(engine, "_native", lambda: None)
    flat, meta = engine.prepare_stage_data(plan, batch, mode="uint6")
    assert meta["prep"] == "numpy"
    meta = dict(meta, scales_dev=torch.from_numpy(meta["scales"]).to(dev))
    want = engine._queue_batch(plan, None, dev, shipped=(
        torch.from_numpy(flat).to(dev), meta))[0]
    assert torch.equal(got, want)
    engine.release_prepared(pool, prepared)


def test_pool_buffer_not_reused_before_its_copy_completes(dev):
    """A released buffer whose copy event has not completed is not
    handed out; once it has, the pool hands it out again."""
    pool = engine.StagingPool(dev)
    buf = pool.acquire((4, 1024), torch.uint8)
    assert buf.is_pinned()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)
        event = torch.cuda.Event()
        event.record(side)
    pool.release(buf, event)
    other = pool.acquire((4, 1024), torch.uint8)
    assert other.data_ptr() != buf.data_ptr()
    event.synchronize()
    assert pool.acquire((4, 1024), torch.uint8).data_ptr() == buf.data_ptr()
