"""
The host side of the kernels' wide phase widths, on the CPU (the
kernels themselves: tests/test_torch_kernels_cuda.py).

* ``segment_plan`` of a container whose row pair does not fit a segment
  tile (p > 14,528; p = 30,000 and 60,001 here) returns a plan with no
  tile-local level, one-row tiles and no shared memory instead of
  raising, and the plain split of that plan gives ``ffa_levels``' bits.
* The S/N kernel's launch shape (``ffa_kernel.snr_launch``) fits a
  block's shared memory for every P from 128 to 70,000: 4 rows up to
  P = 14,528, 1 row up to 58,112, device scratch above.
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
    rows, smem, scratch = fk.snr_launch(P)
    assert 1 <= rows <= fk.SNR_WARPS
    assert smem <= MAX_DYNAMIC_SMEM
    if scratch:
        assert P > MAX_DYNAMIC_SMEM // 4 and smem == 0
        assert rows == fk.SNR_WARPS
    else:
        assert smem == rows * P * 4
        assert rows == min(fk.SNR_WARPS, MAX_DYNAMIC_SMEM // (4 * P))
    if P <= 14528:
        assert (rows, scratch) == (4, False)
    elif P <= 58112:
        assert not scratch
    else:
        assert scratch


def test_snr_launch_every_width():
    for P in range(128, 70001, 97):
        rows, smem, scratch = fk.snr_launch(P)
        assert smem <= MAX_DYNAMIC_SMEM
        assert scratch == (P > 58112)
        assert (rows == 4) == (P <= 14528 or scratch)


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
