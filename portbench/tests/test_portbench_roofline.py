"""The plan-based work count (``portbench/roofline.py``): it follows the
plan, not the launches that carry it out."""
import os

import pytest

from portbench import cell, roofline
from portbench.reference import search as ref


def _walk_work(plan, nw):
    """The frozen per-trial count summed over every trial a D = 1 walk
    of the program's stage loop launches (a row-packed launch carries
    its guest trials), leaving out the padding trials and those with no
    evaluated row."""
    import chip_smoke
    from riptide_tpu_torch.search import engine

    rpm = engine._row_pack_map(plan, "uint6")
    walk = engine.walk_search(plan, 1, mode="uint6", survey=False)
    trials = []
    for ln in walk["launches"]:
        st = plan.stages[ln["stage"]]
        idx = (range(len(st.ms_padded)) if ln["bucket"] is None
               else st.lane_buckets[ln["bucket"]])
        own = [(st, g) for g in idx]
        if ln.get("guest") is not None:
            st2 = plan.stages[ln["guest"]]
            bases = rpm[(ln["stage"], ln["bucket"])][2]
            own += [(st2, g) for g, b in zip(idx, bases) if b is not None]
        for s, g in own:
            if g < len(s.rows_eval) and s.rows_eval[g] > 0:
                trials.append((s.ms_padded[g], s.ps_padded[g],
                               s.rows_eval[g]))
    return chip_smoke.trials_work(trials, 1, nw)


@pytest.mark.parametrize("workload", ["quickstart.survey",
                                      "example_long.survey"])
@pytest.mark.parametrize("split", ["0", "1"])
def test_count_is_the_walks_and_ignores_the_lane_split(workload, split,
                                                       monkeypatch):
    """The plan's count equals the frozen per-trial count over a D = 1
    walk of the configuration's plan, whichever lane-bucket split the
    program runs."""
    monkeypatch.setenv("RIPTIDE_KERNEL_LANE_SPLIT", split)
    _, cfg, _, _, _ = cell.load_cell(workload)
    plan, widths, stages = cell.plan_of(cfg)
    ops, _ = roofline.work(stages, len(widths), ref.wire_row(cfg["bins_max"]))
    assert ops == _walk_work(plan, len(widths))


def test_bytes_are_the_wire_and_the_snr():
    _, cfg, _, _, _ = cell.load_cell("quickstart.survey")
    plan, widths, stages = cell.plan_of(cfg)
    row = ref.wire_row(cfg["bins_max"])
    assert row == 384
    _, one = roofline.work(stages, len(widths), row)
    wire = sum(st.n * 0.75 + 4 * -(-st.n // row) for st in plan.stages)
    assert one == wire + 4 * len(widths) * plan.length
    ops, nb = roofline.work(stages, len(widths), row, D=128)
    assert nb == 128 * one
    # The bound is the operations', about 10 ms a 128-trial chunk.
    sec, by = roofline.bound_s(ops, nb)
    assert by == "operations" and 5e-3 < sec < 2e-2


def test_levels():
    assert [roofline.num_levels(m) for m in (1, 2, 3, 4, 5, 1024, 1025)] == [
        0, 1, 2, 2, 3, 10, 11]
    assert os.path.isfile(os.path.join(cell.ROOT, "chip_smoke.py"))
