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


E2E = (1200, 1e-3, (1, 2, 3), 32e-3, 0.11, 32, 40)


@pytest.fixture()
def paired(monkeypatch):
    """The row-pack e2e plan (stage 0 hosts stage 2 under
    RIPTIDE_KERNEL_BASE3=0) and a D = 2 batch."""
    monkeypatch.setenv("RIPTIDE_KERNEL_BASE3", "0")
    monkeypatch.delenv("RIPTIDE_KERNEL_ROW_PACK", raising=False)
    plan = periodogram_plan(*E2E)
    assert engine.queued_launches(plan)["paired_stage"] == 1
    rng = np.random.default_rng(4)
    return plan, rng.standard_normal((2, E2E[0])).astype(np.float32)


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
    tobs = E2E[0] * E2E[1]
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
LAYOUTS = ({}, {"RIPTIDE_KERNEL_BASE3": "0"},
           {"RIPTIDE_KERNEL_BASE3": "0", "RIPTIDE_KERNEL_ROW_PACK": "0"},
           {"RIPTIDE_KERNEL_LANE_SPLIT": "0"})


@pytest.mark.parametrize("cfg", [E2E, SPLIT], ids=["row-pack", "lane-split"])
def test_layouts_bitwise_on_card(dev, monkeypatch, cfg):
    """On the card too, a trial's S/N is the same bits whatever the
    lane split, the container family and the pairing: the S/N kernel's
    scan order depends on p alone."""
    plan = periodogram_plan(*cfg)
    batch = np.random.default_rng(6).standard_normal((2, cfg[0])).astype(
        np.float32)
    outs = []
    for flags in LAYOUTS:
        for name in ("RIPTIDE_KERNEL_BASE3", "RIPTIDE_KERNEL_ROW_PACK",
                     "RIPTIDE_KERNEL_LANE_SPLIT"):
            monkeypatch.delenv(name, raising=False)
        for name, value in flags.items():
            monkeypatch.setenv(name, value)
        outs.append(engine.run_periodogram_batch(plan, batch, device=dev)[2])
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


def test_wrapper_refuses_bad_input(dev, case):
    plan, _ = case
    st = plan.stages[0]
    tables, coefs = engine._stage_operands(st, plan, dev)
    bad = torch.zeros((1, st.batch.B, st.batch.R, tables.P), device=dev,
                      dtype=torch.float64)
    with pytest.raises(ValueError):
        fk.cascade_stage(bad, tables, coefs)
