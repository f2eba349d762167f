"""
The segment plan (``ops/plan.py::segment_plan``) and the plain segment
levels (``ops/ffa_kernel.py::segment_levels_plain``) against the plain
levels and the JAX package, on the CPU.

The CUDA path splits a container's levels: the segment kernel runs the
leading ``Tables.local`` levels tile by tile in shared memory, the level
kernel runs the rest over the whole container. ``segment_levels_plain``
runs the same split in torch (each tile gathered into a block of its
own, its tables rebased to the tile). Its containers, after the tiles
and after every remaining level, must be bitwise those of
``ops/ffa.py::ffa_levels`` over the same levels, and of the JAX
package's ``ffa_levels``: one float add per element in the same tree,
whatever the split. Covered: every lane-bucket container of the
headline plan (``BASELINE.md``), the row-packed containers (K3) of the
benchmark's example_long plan (riptide's example.yaml range long, 6
pairs) and of two small plans (2 pairs each), small m from 1 to 300, and
phase widths that
put the tile height at both ends of its range. The S/N of the split
levels matches the JAX package's K1 in interpret mode within rtol 1e-5,
atol 1e-4 (the prefix sum's summation order; tests/test_torch_ffa_stage.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.ops.ffa import ffa_levels as ref_ffa_levels
from riptide_tpu.ops.plan import FFABatchPlan as RefBatchPlan
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch.ops import ffa_kernel as fk
from riptide_tpu_torch.ops.ffa import ffa_levels
from riptide_tpu_torch.ops.plan import FFABatchPlan, segment_plan
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.search.plan import periodogram_plan
from riptide_tpu_torch.utils.limits import MAX_DYNAMIC_SMEM

RTOL, ATOL = 1e-5, 1e-4
CPU = torch.device("cpu")
HEADLINE = (2 ** 23, 64e-6, (1, 2, 3, 4, 6, 9, 13, 19, 28, 42), 0.5, 3.0,
            240, 260)
CFG = (2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)
# Plans whose layout pairs lane buckets: example_long (P 2-120 s at
# 960-1040 bins, 6 pairs) and two small ones (2 pairs each).
EXAMPLE_LONG = (2 ** 23, 64e-6, (1, 2, 3, 4, 6, 9, 13, 19, 28, 42, 63, 94,
                                 141), 2.0, 120.0, 960, 1040)
PAIRED = ((16384, 1e-3, (1, 2, 3), 0.12, 4.0, 120, 136),
          (16384, 1e-3, (1, 2, 3), 0.064, 4.0, 64, 72))
# Phase widths at both ends of the tile height's range: two float32
# buffers of cap rows x p in MAX_DYNAMIC_SMEM bytes.
P_WIDE = MAX_DYNAMIC_SMEM // (4 * fk.SNR_WARPS)    # cap 2 (the S/N limit)
P_NARROW = 8                                       # cap 3632


def _cap(p):
    return MAX_DYNAMIC_SMEM // (8 * p)


def _operands(b, device=CPU):
    """The container's (Tables, Coefs) as the engine builds them."""
    one = np.ones((b.B, 1), np.float32)
    guest = None if b.gbase is None else (one, one, one[:, 0])
    return engine._operands(b, (1,), one, one, one[:, 0], 1, device,
                            guest=guest)


def _with_segments(tables, b):
    """CPU ``tables`` of container ``b`` with the segment plan that the
    engine ships to a CUDA device."""
    seg = b.segments
    return tables._replace(tiles=torch.from_numpy(seg.tiles),
                           local=seg.levels, smem=seg.smem)


def _tables(b):
    return _with_segments(_operands(b)[0], b)


def _filled(b, seed, D=1):
    """A (D, B, R, P) container with random samples in every trial's
    rows (the host's and the guest's) and zeros elsewhere."""
    rng = np.random.default_rng(seed)
    x = np.zeros((D, b.B, b.R, b.P), np.float32)
    for j in range(b.B):
        m, p = int(b.m[j]), int(b.p[j])
        x[:, j, :m, :p] = rng.standard_normal((D, m, p))
        if b.gbase is not None and b.gbase[j] >= 0:
            g0, gm = int(b.gbase[j]), int(b.gm[j])
            x[:, j, g0 : g0 + gm, :p] = rng.standard_normal((D, gm, p))
    # A negative zero in each trial's first row: a level adds +0.0 to
    # it, so a skipped level would show.
    x[:, :, 0, 0] = -0.0
    return torch.from_numpy(x)


def _check_split(b, x, every=True):
    """segment_levels_plain after the tiles and after each remaining
    level (or only the first and the last) equals ffa_levels over the
    same levels, bit for bit. Returns the tables."""
    t = _tables(b)
    L, loc = b.L, t.local
    want, done = x, 0
    for g in (range(L - loc + 1) if every else sorted({0, L - loc})):
        got = fk.segment_levels_plain(x, t, g)
        want = ffa_levels(want, t.h[done : loc + g], t.t[done : loc + g],
                          t.shift[done : loc + g], t.p)
        done = loc + g
        assert torch.equal(got, want), (loc, g)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
    return t


def _check_jax(b, x):
    """The split levels equal the JAX package's ffa_levels on the same
    tables, bit for bit."""
    t = _tables(b)
    got = fk.segment_levels_plain(x, t)[0].numpy()
    want = np.asarray(ref_ffa_levels(jnp.asarray(x[0].numpy()),
                                     jnp.asarray(b.h), jnp.asarray(b.t),
                                     jnp.asarray(b.shift), jnp.asarray(b.p)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def _check_invariants(b, seg):
    """The tiles cover each plane's rows once, in order; live tiles hold
    exactly the trial's rows, at most the plane's cap of them; every
    local level reads inside its tile; the shared memory fits a block."""
    L, B, R = b.h.shape
    Z = R - 1
    live = np.zeros((B, R), bool)
    live[:, :] = np.arange(R) < b.m[:, None]
    if b.gbase is not None:
        for j in range(B):
            if b.gbase[j] >= 0:
                live[j, b.gbase[j] : b.gbase[j] + b.gm[j]] = True
    assert seg.tiles.dtype == np.int32 and seg.tiles.shape[1] == 4
    assert 0 <= seg.levels <= L
    assert 0 < seg.smem <= MAX_DYNAMIC_SMEM
    for j in range(B):
        mine = seg.tiles[seg.tiles[:, 0] == j]
        starts = np.concatenate(([0], np.cumsum(mine[:, 2])))
        np.testing.assert_array_equal(mine[:, 1], starts[:-1])
        assert starts[-1] == R and (mine[:, 2] > 0).all()
        p, cap = int(b.p[j]), _cap(int(b.p[j]))
        for _, r0, n, lv in mine:
            assert (live[j, r0 : r0 + n] == bool(lv)).all()
            if not lv:
                continue
            assert n <= cap and 8 * n * p <= seg.smem
            for l in range(seg.levels):
                for tab in (b.h[l, j, r0 : r0 + n], b.t[l, j, r0 : r0 + n]):
                    inside = (tab >= r0) & (tab < r0 + n)
                    assert (inside | (tab == Z)).all(), (j, r0, n, l)
    assert seg.smem == max(8 * int(n) * int(b.p[j])
                           for j, _, n, lv in seg.tiles if lv)


def segment_plan_level_fits(b, levels):
    """Whether every node merged by the first ``levels`` levels fits its
    plane's cap, from the tree (an independent count): a node of an
    m-row trial at level l has at most ceil(m / 2**(L_m - l)) rows."""
    from riptide_tpu_torch.ops.plan import num_levels

    sizes = []
    for j in range(b.B):
        trials = [int(b.m[j])]
        if b.gbase is not None and b.gbase[j] >= 0:
            trials.append(int(b.gm[j]))
        for m in trials:
            Lm = num_levels(m)
            size = m if levels >= Lm else -(-m // 2 ** (Lm - levels))
            sizes.append(size <= _cap(int(b.p[j])))
    return all(sizes)


@pytest.fixture(scope="module")
def headline():
    return periodogram_plan(*HEADLINE)


@pytest.mark.parametrize("stage", range(22))
def test_headline_bucket_containers_bitwise(headline, stage):
    """Every lane-bucket container of the headline plan (43 in 22
    stages): the split levels are the plain levels' bits."""
    assert len(headline.stages) == 22
    st = headline.stages[stage]
    for k in range(len(st.lane_buckets)):
        b = st.bucket_batch(k)
        x = _filled(b, seed=100 + 2 * stage + k)
        t = _check_split(b, x, every=stage in (0, 21))
        assert 1 <= t.local <= b.L
        _check_invariants(b, b.segments)
        assert segment_plan_level_fits(b, t.local)
        assert t.local == b.L or not segment_plan_level_fits(b, t.local + 1)


@pytest.mark.parametrize("stage", [0, 21])
def test_headline_split_matches_jax_ffa_levels(headline, stage):
    b = headline.stages[stage].bucket_batch(0)
    rb = RefBatchPlan(b.m, b.p, R=b.R, P=b.P, L=b.L)
    np.testing.assert_array_equal(b.h, rb.h)
    np.testing.assert_array_equal(b.shift, rb.shift)
    _check_jax(b, _filled(b, seed=7))


def _paired_containers(plan):
    """The K3 containers of the plan's layout, in launch order."""
    return [plan.stages[ln.stage].paired_batch(
        ln.bucket, plan.stages[ln.guest], ln.bases)
        for ln in engine.launch_layout(plan, "uint6").launches
        if ln.kind == "paired_stage"]


@pytest.fixture(scope="module")
def paired():
    out = _paired_containers(periodogram_plan(*EXAMPLE_LONG))
    assert len(out) == 6
    for cfg in PAIRED:
        more = _paired_containers(periodogram_plan(*cfg))
        assert len(more) == 2
        out += more
    return out


@pytest.mark.parametrize("i", range(10))
def test_headline_paired_containers_bitwise(paired, i):
    """The row-packed containers (K3) of the default layout: example_long's
    6 (0-5) and two small plans' 2 each (6-9). Host and guest rows
    through the split levels are the plain levels' bits, and the JAX
    package's."""
    b = paired[i]
    assert (b.gbase >= 0).any()
    x = _filled(b, seed=200 + i)
    _check_split(b, x, every=i in (5, 9))
    _check_invariants(b, b.segments)
    if i in (0, 5, 9):
        _check_jax(b, x)


@pytest.mark.parametrize("lo", [1, 51, 101, 151, 201, 251])
def test_small_m_bitwise(lo):
    """Trials of m = 1..300 rows, 50 to a container, at three widths."""
    ms = list(range(lo, lo + 50))
    for p in (7, 64, 509):
        ps = [p - (j % 3) if p > 8 else p for j in range(len(ms))]
        b = FFABatchPlan(ms, ps)
        x = _filled(b, seed=lo + p, D=2 if p == 64 else 1)
        _check_split(b, x, every=p == 64)
        _check_invariants(b, b.segments)
        if p == 509:
            rb = RefBatchPlan(ms, ps)
            np.testing.assert_array_equal(b.t, rb.t)
            _check_jax(b, x)


@pytest.mark.parametrize("p,ms,local", [
    # cap 2: only nodes of two rows fit; an m = 1 trial needs no level.
    (P_WIDE, [1, 2, 3, 5, 8], 1),
    (P_WIDE, [1], 0),
    # cap 3632: whole trials fit, up to m = cap; one row more costs the
    # root level.
    (P_NARROW, [3632, 17, 1], 12),
    (P_NARROW, [3633, 5], 11),
])
def test_tile_height_at_both_ends(p, ms, local):
    b = FFABatchPlan(ms, [p] * len(ms))
    seg = b.segments
    assert seg.levels == local
    _check_invariants(b, seg)
    if p == P_WIDE:
        assert _cap(p) == 2
        assert int(seg.tiles[seg.tiles[:, 3] == 1][:, 2].max()) <= 2
    else:
        assert _cap(p) == 3632
    x = _filled(b, seed=len(ms))
    _check_split(b, x)


@pytest.mark.parametrize("guests,shared", [([(50, 100), (30, 60)], True),
                                           ([(50, 120), None], False)],
                         ids=["adjacent", "gap"])
def test_paired_tiles_hold_host_and_guest_rows(guests, shared):
    """A guest right above its host makes one run of live rows, and a
    tile may then hold host and guest rows; with a gap, the dead rows
    between them go to a zero tile."""
    b = FFABatchPlan([100, 60], [64, 61], R=171, guests=guests)
    seg = b.segments
    _check_invariants(b, seg)
    live = seg.tiles[(seg.tiles[:, 0] == 0) & (seg.tiles[:, 3] == 1)]
    spans = [(int(r0), int(r0 + n)) for _, r0, n, _ in live]
    straddle = any(r0 < 100 < r1 for r0, r1 in spans)
    assert straddle == shared
    _check_split(b, _filled(b, seed=3, D=2))


def test_segment_plan_refuses_a_phase_width_without_room():
    """A phase width with no room for a tile row gets a plan instead of
    an error: no tile-local level, every row a tile of its own filled
    straight into the container (no shared memory), and the plain split
    gives ``ffa_levels``' bits."""
    b = FFABatchPlan([4], [MAX_DYNAMIC_SMEM // 8 + 1])
    seg = segment_plan(b)
    assert seg.levels == 0 and seg.smem == 0
    np.testing.assert_array_equal(seg.tiles[:, 2], 1)
    np.testing.assert_array_equal(seg.tiles[:, 3], [1, 1, 1, 1, 0])
    _check_split(b, _filled(b, seed=4))


def test_segment_tables_built_once_and_shipped_with_the_operands(headline):
    """The segment plan is built at a container's first use and kept;
    the operands are cached, so a second search builds and ships
    nothing. The CPU's operands carry no segment plan and build none
    (the CUDA operands' tiles: tests/test_torch_kernels_cuda.py)."""
    st = headline.stages[3]
    t1, _ = engine._bucket_operands(st, headline, 0, CPU)
    t2, _ = engine._bucket_operands(st, headline, 0, CPU)
    assert t1 is t2
    assert (t1.tiles, t1.local, t1.smem) == (None, 0, 0)
    fresh_b = FFABatchPlan([9, 5], [12, 11])
    _operands(fresh_b)
    assert getattr(fresh_b, "_segments", None) is None
    b = st.bucket_batch(0)
    assert b.segments is b.segments
    fresh = segment_plan(b)
    np.testing.assert_array_equal(fresh.tiles, b.segments.tiles)
    assert (fresh.levels, fresh.smem) == (b.segments.levels,
                                          b.segments.smem)


def test_cpu_operands_take_a_phase_width_past_the_tiles():
    """A phase width with no room for a tile row builds its CPU operands
    and runs the plain levels: the segment plan is the CUDA path's."""
    b = FFABatchPlan([4, 3], [MAX_DYNAMIC_SMEM // 8 + 1] * 2)
    tables, coefs = _operands(b)
    assert tables.tiles is None and tables.local == 0
    x = _filled(b, seed=5)
    np.testing.assert_array_equal(
        fk.segment_levels_plain(x, tables).numpy(),
        ffa_levels(x, tables.h, tables.t, tables.shift, tables.p).numpy())
    out = fk.cascade_stage(x.clone(), tables, coefs)
    assert out.shape == (1, 2, 1, 1) and torch.isfinite(out).all()


@pytest.fixture(scope="module")
def stage_case():
    """The tiny two-stage plan with a uint6 wire of a D = 2 batch."""
    ref, plan = ref_plan(*CFG), periodogram_plan(*CFG)
    rng = np.random.default_rng(11)
    batch = rng.standard_normal((2, CFG[0])).astype(np.float32)
    wire, scales = engine._prepare_uint(plan, batch, "uint6")
    return ref, plan, wire, scales


def test_split_levels_snr_matches_pallas_k1(stage_case):
    """The split levels from the wire, then the S/N: the JAX package's
    K1 in interpret mode within rtol 1e-5, atol 1e-4; and the container
    is the plain K1 front half's levels, bit for bit."""
    ref, plan, wire, scales = stage_case
    vl = engine._view_layout(plan, "uint6")
    wire_t, scales_t = torch.from_numpy(wire), torch.from_numpy(scales)
    wire_j, scales_j = jnp.asarray(wire), jnp.asarray(scales[..., None])
    nw = len(plan.widths)
    for i, (st, rst) in enumerate(zip(plan.stages, ref.stages)):
        tables, coefs = engine._stage_operands(st, plan, CPU)
        tables = _with_segments(tables, st.batch)
        geom = engine.stage_geom({"view": vl, "mode": "uint6"}, i, st.n)
        src = fk.WireSource(wire_t, scales_t, geom)
        x = fk.segment_levels(src, tables)
        full = fk.decode_pack_plain(wire_t, scales_t, geom, tables,
                                    tables.h.shape[2])
        assert torch.equal(x, ffa_levels(full, tables.h, tables.t,
                                          tables.shift, tables.p))
        got = fk._snr_plain(x, tables, coefs).numpy()
        kern = rst.cycle_kernel(interpret=True)
        sv = ref_engine._stagevec(rst, ref_engine._view_layout(ref, "uint6"),
                                  i, int(vl["roffs"][i]), "uint6")
        want = np.asarray(kern.run_fused(sv, wire_j, scales_j, "uint6"))
        want = want[..., : st.rows_eval_max, :nw]
        for j, re in enumerate(st.rows_eval):
            np.testing.assert_allclose(got[:, j, :re], want[:, j, :re],
                                       rtol=RTOL, atol=ATOL)


def test_cpu_counts_no_cuda_launch(stage_case):
    _, plan, _, _ = stage_case
    fk.reset_launches()
    engine.run_periodogram_batch(plan, np.zeros((1, CFG[0]), np.float32),
                                 device="cpu")
    assert fk.KERNEL_LAUNCHES == {"segment_wire": 0, "segment_container": 0,
                                  "ffa_level": 0, "boxcar_snr": 0}
    assert fk.LAUNCHES == {"fused_stage": 0, "cascade_stage": 0,
                           "paired_stage": 0}
