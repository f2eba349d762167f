"""
The host side of the kernels' wide phase widths, on the CPU (the
kernels themselves: tests/test_torch_kernels_cuda.py).

* ``segment_plan`` of a container whose row pair does not fit a segment
  tile (p > 14,528; p = 30,000 and 60,001 here) returns a plan with no
  tile-local level, one-row tiles and no shared memory instead of
  raising, and the plain split of that plan gives ``ffa_levels``' bits.
* The S/N kernel's launch shape (``ffa_kernel.snr_launch``) fits a
  block's shared memory for every P from 128 to 464,896 and allocates
  no device scratch: 4 rows a block up to P = 14,528, one row a block
  up to 58,112, a row a cluster of 2, 4 or 8 blocks above; past that it
  raises. The wide level launch (``ffa_kernel.level_grid``) cuts every
  row into 1024-column blocks past 14,528. The narrow S/N kernel's
  register form (``ffa_kernel.snr_regs``) holds each lane's ceil(P / 32)
  phases, up to 2,048 phases, and leaves the launch shape as it is.
* Plans whose padded P crosses 14,528 and 29,056 search on the CPU as
  the JAX package searches them (its gather path: the float32 wire and
  the uint6 wire), within rtol 1e-5, atol 1e-4, and the stage
  eligibility of the headline-sized widths is unchanged.
"""
import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch.ops import ffa_kernel as fk
from riptide_tpu_torch.ops.ffa import ffa_levels
from riptide_tpu_torch.ops.plan import FFABatchPlan, segment_plan
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.search.plan import periodogram_plan
from riptide_tpu_torch.utils.limits import MAX_DYNAMIC_SMEM

RTOL, ATOL = 1e-5, 1e-4
CPU = torch.device("cpu")


def _wide(bmin, nsamp, tsamp=16e-6, nb=4):
    bmax = bmin + nb
    return (nsamp, tsamp, (1, 2, 4), bmax * tsamp, 1.001 * bmax * tsamp,
            bmin, bmax)


WIDE = {"16k": _wide(16000, 2 ** 16), "30k": _wide(30000, 2 ** 17)}


def _cuda_tables(b):
    """The CPU tables of ``b`` with its segment plan attached, as the
    CUDA operands carry it."""
    one = np.ones((b.B, 1), np.float32)
    tables = engine._operands(b, (1,), one, one, one[:, 0], 1, CPU)[0]
    seg = b.segments
    return tables._replace(tiles=torch.from_numpy(seg.tiles),
                           local=seg.levels, smem=seg.smem)


@pytest.mark.parametrize("ms,ps", [([17, 9], [30000, 30001]),
                                   ([5, 1, 3], [60001, 14529, 20000])])
def test_segment_plan_without_a_row_pair(ms, ps):
    b = FFABatchPlan(ms, ps)
    seg = segment_plan(b)
    assert seg.levels == 0 and seg.smem == 0
    assert seg.tiles.shape == (b.B * b.R, 4)
    np.testing.assert_array_equal(seg.tiles[:, 2], 1)
    for j, m in enumerate(ms):
        mine = seg.tiles[seg.tiles[:, 0] == j]
        np.testing.assert_array_equal(mine[:, 1], np.arange(b.R))
        np.testing.assert_array_equal(mine[:, 3], np.arange(b.R) < m)
    rng = np.random.default_rng(3)
    x = np.zeros((2, b.B, b.R, b.P), np.float32)
    for j, (m, p) in enumerate(zip(ms, ps)):
        x[:, j, :m, :p] = rng.standard_normal((2, m, p))
    x = torch.from_numpy(x)
    t = _cuda_tables(b)
    got = fk.segment_levels_plain(x, t)
    want = ffa_levels(x, t.h, t.t, t.shift, t.p)
    assert torch.equal(got, want)


def test_segment_plans_with_a_row_pair_keep_their_tiles():
    """At p <= 14,528 a tile holds two rows or more and the leading
    levels stay in shared memory."""
    for p in (256, 8000, MAX_DYNAMIC_SMEM // 16):
        seg = segment_plan(FFABatchPlan([40, 33], [p, p - 1]))
        assert seg.levels >= 1 and 0 < seg.smem <= MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("P", [128, 256, 1000, 14528, 14529, 19370, 19371,
                               29056, 29057, 58112, 58113, 60008, 70000])
def test_snr_launch_fits_shared_memory(P):
    rows, threads, cluster, smem = fk.snr_launch(P)
    assert smem <= MAX_DYNAMIC_SMEM
    if P <= 14528:
        assert (rows, threads, cluster) == (fk.SNR_WARPS, 128, 1)
        assert smem == rows * P * 4
    else:
        # One row a block (or cluster) of 1024 threads; each block holds
        # its share of the row's 32 chunks of ceil(P / 32) phases.
        assert (rows, threads) == (1, 1024)
        held = min(P, 32 // cluster * -(-P // 32))
        assert smem == held * 4
        assert cluster == (1 if P <= 58112 else 2)
        # ... and the cluster is the smallest that holds it.
        assert cluster == 1 or 4 * min(
            P, 32 // (cluster // 2) * -(-P // 32)) > MAX_DYNAMIC_SMEM


def test_snr_launch_every_width():
    for P in range(128, 470001, 97):
        if P > fk.MAX_P:
            with pytest.raises(ValueError):
                fk.snr_launch(P)
            continue
        rows, _, cluster, smem = fk.snr_launch(P)
        assert 0 < smem <= MAX_DYNAMIC_SMEM
        assert (rows == 4) == (P <= 14528)
        assert cluster == (1 if P <= 58112 else 2 if P <= 116224
                           else 4 if P <= 232448 else 8)
        # The cluster's blocks hold the whole row.
        assert cluster * smem >= 4 * P


@pytest.mark.parametrize("P,cluster", [(14528, 1), (14529, 1), (29056, 1),
                                       (58112, 1), (58113, 2), (70000, 2)])
def test_wide_launch_grids(P, cluster):
    """The column grid of a level launch and the S/N kernel's cluster
    choice on each side of the forms' limits (D = 2, B = 9, R = 24)."""
    blocks, threads = fk.level_grid(2, 9, 24, P)
    if P <= 14528:
        assert (blocks, threads) == (2 * 9 * 3, 256)
        assert fk.snr_launch(P).rows == 4
    else:
        assert threads == 256
        assert blocks == 2 * 9 * 24 * -(-P // 1024)
        # Several waves of blocks on the card's 132 SMs.
        assert blocks >= 8 * 132
        assert fk.snr_launch(P).rows == 1
    assert fk.snr_launch(P).cluster == cluster


@pytest.mark.parametrize("P,form", [(1, 4), (128, 4), (129, 8), (256, 8),
                                    (257, 12), (260, 12), (520, 20),
                                    (1024, 32), (1040, 36), (2048, 64),
                                    (2049, 0), (14528, 0), (14529, None),
                                    (58113, None)])
def test_snr_register_form_edges(P, form):
    """The narrow S/N kernel's register form on each side of its bounds
    (the widths of the three benchmark cells' containers among them):
    ceil(P / 32) rounded up to a multiple of 4, 0 past 2,048 phases, none
    for the wide kernel; the launch shape is the same in every form."""
    assert fk.snr_regs(P) == form
    if form is not None:
        assert fk.snr_launch(P) == (fk.SNR_WARPS, 128, 1,
                                    fk.SNR_WARPS * P * 4)


def test_snr_register_forms_every_width():
    """Every narrow width takes the smallest bound of its step that holds
    a lane's ceil(P / 32) phases, up to SNR_REGS_MAX of them."""
    forms = set()
    for P in range(1, fk.NARROW_P + 1):
        n = -(-P // 32)
        form = fk.snr_regs(P)
        forms.add(form)
        if n > fk.SNR_REGS_MAX:
            assert form == 0
        else:
            assert form % fk.SNR_REGS_STEP == 0
            assert n <= form < n + fk.SNR_REGS_STEP
    assert forms == {0, *range(4, fk.SNR_REGS_MAX + 1, fk.SNR_REGS_STEP)}
    assert fk.snr_regs(fk.NARROW_P + 1) is None


def test_shape_only_walk_counts_no_register_form():
    """A shape-only walk (the meta device) counts its S/N launches under
    KERNEL_LAUNCHES' name in the walk's own counters, and none in the
    card's SNR_FORMS."""
    plan = periodogram_plan(2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)
    fk.reset_launches()
    walk = engine.walk_search(plan, 2, mode="uint6", survey=False)
    assert walk["kernel_counts"]["boxcar_snr"] > 0
    assert fk.SNR_FORMS == {}


@pytest.mark.parametrize("name", sorted(WIDE))
@pytest.mark.parametrize("path,wire", [("gather", "float32"),
                                       ("kernel", "uint6")])
def test_wide_plan_matches_reference(monkeypatch, name, path, wire):
    cfg = WIDE[name]
    monkeypatch.setenv("RIPTIDE_FFA_PATH", path)
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", wire)
    plan = periodogram_plan(*cfg)
    assert plan.P > (14528 if name == "16k" else 29056)
    assert not any(engine._kernel_eligible(st, plan) for st in plan.stages)
    data = np.random.default_rng(9).standard_normal(cfg[0]).astype(
        np.float32)
    P1, F1, S1 = ref_engine.run_periodogram(ref_plan(*cfg), data)
    P2, F2, S2 = engine.run_periodogram(plan, data, device="cpu")
    np.testing.assert_array_equal(P2, P1)
    np.testing.assert_array_equal(F2, F1)
    np.testing.assert_allclose(S2, S1, rtol=RTOL, atol=ATOL)


def test_headline_eligibility_unchanged():
    """Every stage of the headline plan is still lane-bucketed (its
    widths are far below 14,528)."""
    plan = periodogram_plan(2 ** 23, 64e-6, (1, 2, 3, 4, 6, 9, 13, 19, 28,
                                              42), 0.5, 3.0, 240, 260)
    elig = [engine._fused_eligible(st, plan, "uint6") for st in plan.stages]
    assert all(elig) and len(elig) == 22
