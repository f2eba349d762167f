"""
The PyTorch port's host wire preparation and its device-side decode +
pack against the JAX package's.

* Wire bytes, scales and layout bookkeeping must be BIT-identical to
  ``riptide_tpu.search.engine._prepare_uint`` for every quantised mode,
  on a plan whose stages end in odd tails (the pattern of
  tests/test_wire.py::test_native_matches_numpy_fallback); the float32
  wire likewise.
* The port's decode (``_udecode_view``) and pack (``_pack``) must give a
  container bitwise equal to the JAX package's ``_udecode_view`` +
  ``_pack``: the same integer bit operations, one float subtract and one
  float multiply per sample, then pure data movement.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch.ops.ffa_kernel import StageGeom, decode_pack_plain
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.search.plan import periodogram_plan

CFG = (2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)
QUANTISED = ("uint6", "uint8", "uint12")


@pytest.fixture(scope="module")
def plans():
    return ref_plan(*CFG), periodogram_plan(*CFG)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    b = rng.standard_normal((2, CFG[0])).astype(np.float32)
    b[1, 100:140] *= 40.0  # a bright block: rows with coarse scales
    return b


def test_plan_has_odd_tails(plans):
    _, plan = plans
    PW = engine._view_width(plan)
    assert len(plan.stages) >= 2
    assert any(st.n % PW for st in plan.stages)


@pytest.mark.parametrize("mode", QUANTISED)
def test_wire_bytes_bit_identical(plans, batch, mode):
    ref, plan = plans
    want_wire, want_scales = ref_engine._prepare_uint(ref, batch, mode)
    got_wire, got_scales = engine._prepare_uint(plan, batch, mode)
    assert got_wire.dtype == want_wire.dtype == np.uint8
    np.testing.assert_array_equal(got_scales, want_scales)
    np.testing.assert_array_equal(got_wire, want_wire)
    want_vl = ref_engine._view_layout(ref, mode)
    got_vl = engine._view_layout(plan, mode)
    for key in ("PW", "group", "planes", "r0s", "prs", "wrows", "roffs",
                "tot_rows", "soffs", "stot"):
        np.testing.assert_array_equal(np.asarray(got_vl[key]),
                                      np.asarray(want_vl[key]), err_msg=key)


def test_float_wire_identical(plans, batch, monkeypatch):
    ref, plan = plans
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")
    want, wmeta = ref_engine.prepare_stage_data(ref, batch, mode="float32")
    got, gmeta = engine.prepare_stage_data(plan, batch, mode="float32")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmeta["offs"], wmeta["offs"])


@pytest.mark.parametrize("raw,mode", [(None, "uint6"), ("", "uint6"),
                                      ("uint8", "uint8"),
                                      ("uint12", "uint12"),
                                      ("float32", "float32"),
                                      ("float16", "float16"),
                                      ("bfloat16", None), ("u6", None)])
def test_wire_mode_from_environment(monkeypatch, raw, mode):
    """``RIPTIDE_WIRE_DTYPE`` picks the wire (``uint6`` when unset or
    empty); a value the engine has no wire for raises."""
    if raw is None:
        monkeypatch.delenv("RIPTIDE_WIRE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", raw)
    if mode is None:
        with pytest.raises(ValueError, match="RIPTIDE_WIRE_DTYPE"):
            engine._wire_mode()
    else:
        assert engine._wire_mode() == mode


@pytest.mark.parametrize("mode", QUANTISED)
def test_decode_pack_bitwise(plans, batch, mode):
    _, plan = plans
    wire, scales = engine._prepare_uint(plan, batch, mode)
    vl = engine._view_layout(plan, mode)
    wire_t, scales_t = torch.from_numpy(wire), torch.from_numpy(scales)
    for i, st in enumerate(plan.stages):
        roff, pr = int(vl["roffs"][i]), int(vl["prs"][i])
        soff, r0 = int(vl["soffs"][i]), int(vl["r0s"][i])
        tables, _ = engine._stage_operands(st, plan, torch.device("cpu"))
        geom = StageGeom(mode, roff, pr, soff, r0, st.n)
        got = decode_pack_plain(wire_t, scales_t, geom, tables, st.batch.R)
        xd = ref_engine._decode_stage_rows(
            mode, jnp.asarray(wire), jnp.asarray(scales[..., None]), roff,
            int(vl["wrows"][i]), soff, r0, st.n)
        b = st.batch
        for d in range(batch.shape[0]):
            want = ref_engine._pack(xd[d], jnp.asarray(b.p), jnp.asarray(b.m),
                                    b.R, b.P)
            np.testing.assert_array_equal(got[d].numpy(), np.asarray(want))


def test_decoded_samples_bitwise(plans, batch):
    """The sample view alone, for the uint12 wire's two-word split and
    the bright rows' coarse scales."""
    _, plan = plans
    wire, scales = engine._prepare_uint(plan, batch, "uint12")
    vl = engine._view_layout(plan, "uint12")
    for i, st in enumerate(plan.stages):
        args = ("uint12", int(vl["roffs"][i]), int(vl["wrows"][i]),
                int(vl["soffs"][i]), int(vl["r0s"][i]), st.n)
        got = engine._decode_stage_rows(args[0], torch.from_numpy(wire),
                                        torch.from_numpy(scales), *args[1:])
        want = ref_engine._decode_stage_rows(
            args[0], jnp.asarray(wire), jnp.asarray(scales[..., None]),
            *args[1:])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
