"""
The port's native host runtime, staging pool and float16 wire against
the JAX package's, on the CPU.

* ``riptide_tpu_torch.native.prepare_wire_view`` gives the bytes and
  scales of ``riptide_tpu.native.prepare_wire_view`` and of the port's
  numpy path, for uint6, uint8 and uint12, at 1 and at 4 threads
  (the pattern of tests/test_wire.py::test_native_matches_numpy_fallback);
  ``downsample_stages`` the reference's float32 and float16 arrays.
* A :class:`~riptide_tpu_torch.search.engine.StagingPool` buffer
  recycled from an earlier chunk gives the bytes of a fresh one, and a
  buffer held by a chunk that is not collected yet is not handed out.
* The float16 wire: bytes equal to the JAX package's, and its
  periodogram within rtol 1e-5, atol 1e-4 of the JAX package's float16
  search on its gather path (the S/N's prefix-sum summation order, as
  tests/test_torch_search.py).
"""
import logging

import numpy as np
import pytest
import torch

import riptide_tpu.native as ref_native
import riptide_tpu.search.engine as ref_engine
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch import native
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.search.plan import periodogram_plan
from riptide_tpu_torch.utils import envflags

CFG = (2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)
QUANTISED = ("uint6", "uint8", "uint12")
RTOL, ATOL = 1e-5, 1e-4
CPU = torch.device("cpu")
# The survey batch's plan of tests/test_torch_peaks.py.
SURVEY = (1200, 1e-3, (1, 2, 3), 32e-3, 0.11, 32, 40)
PKW = dict(smin=6.0, segwidth=0.2, nstd=6.0, minseg=10, polydeg=2,
           clrad=0.1)


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.fail("the port's native runtime did not build with g++")
    if not ref_native.available():
        pytest.fail("the JAX package's native runtime did not build")


@pytest.fixture(scope="module")
def plans():
    return ref_plan(*CFG), periodogram_plan(*CFG)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    b = rng.standard_normal((3, CFG[0])).astype(np.float32)
    b[1, 100:140] *= 40.0  # a bright block: rows with coarse scales
    return b


def _wire_args(plan, mode):
    vl = engine._view_layout(plan, mode)
    imin, imax, wmin, wmax, wint = engine._ds_pack(plan)
    nouts = np.asarray([st.n for st in plan.stages], np.int32)
    return ((imin, imax, wmin, wmax, wint, nouts, mode, vl["PW"],
             vl["roffs"], vl["tot_rows"], vl["soffs"], vl["stot"]))


@pytest.mark.parametrize("mode", QUANTISED)
def test_prepare_wire_view_matches_reference_and_numpy(plans, batch, mode):
    ref, plan = plans
    got = native.prepare_wire_view(batch, *_wire_args(plan, mode))
    want = ref_native.prepare_wire_view(batch, *_wire_args(plan, mode))
    numpy_path = engine._prepare_uint_numpy(plan, batch, mode)
    for other in (want, numpy_path):
        np.testing.assert_array_equal(got[1], other[1])
        np.testing.assert_array_equal(got[0], other[0])
    # The engine's own prep takes the native path and says so.
    flat, meta = engine.prepare_stage_data(plan, batch, mode=mode)
    assert meta["prep"] == "native"
    np.testing.assert_array_equal(flat, got[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_downsample_stages_matches_reference(plans, batch, dtype):
    _, plan = plans
    pk = engine._ds_pack(plan)
    got = native.downsample_stages(batch, *pk, dtype=dtype)
    want = ref_native.downsample_stages(batch, *pk, dtype=dtype)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    # The numpy fallback of the engine gives the same bits.
    d64, c32, anchors = engine._prefix_anchored(batch)
    for i, st in enumerate(plan.stages):
        np.testing.assert_array_equal(
            got[i], engine._stage_downsample(st, d64, c32,
                                             anchors).astype(dtype))


@pytest.mark.parametrize("mode", QUANTISED)
def test_bytes_do_not_depend_on_threads(plans, batch, mode, monkeypatch):
    _, plan = plans
    outs = []
    for n in ("1", "4"):
        monkeypatch.setenv("RIPTIDE_PREP_THREADS", n)
        assert engine._prep_nthreads() == int(n)
        outs.append(engine.prepare_stage_data(plan, batch, mode=mode))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1]["scales"], outs[1][1]["scales"])
    for n in (1, 4):
        w, s = native.prepare_wire_view(batch, *_wire_args(plan, mode),
                                        nthreads=n)
        np.testing.assert_array_equal(w, outs[0][0])
        np.testing.assert_array_equal(s, outs[0][1]["scales"])


def test_prep_threads_flag(monkeypatch):
    monkeypatch.delenv("RIPTIDE_PREP_THREADS", raising=False)
    assert engine._prep_nthreads() is None
    monkeypatch.setenv("RIPTIDE_PREP_THREADS", "0")
    assert engine._prep_nthreads() is None
    monkeypatch.setenv("RIPTIDE_PREP_THREADS", "many")
    with pytest.raises(ValueError, match="RIPTIDE_PREP_THREADS"):
        envflags.get("RIPTIDE_PREP_THREADS")


@pytest.mark.parametrize("mode", ["uint6", "uint12", "float32", "float16"])
def test_recycled_pool_buffer_gives_fresh_bytes(plans, batch, mode):
    """A buffer that held an earlier chunk's wire gives, recycled, the
    bytes a fresh buffer gives (the slack is reset before the prep)."""
    _, plan = plans
    pool = engine.StagingPool(CPU)
    first = engine.prepare_stage_data(plan, batch[::-1] * 3.0, mode=mode,
                                      pool=pool)
    ptrs = {t.data_ptr() for t in first[1]["staging"]}
    assert ptrs and not any(t.is_pinned() for t in first[1]["staging"])
    engine.release_prepared(pool, first)
    again = engine.prepare_stage_data(plan, batch, mode=mode, pool=pool)
    assert {t.data_ptr() for t in again[1]["staging"]} == ptrs
    fresh = engine.prepare_stage_data(plan, batch, mode=mode)
    np.testing.assert_array_equal(again[0], fresh[0])
    if mode in QUANTISED:
        np.testing.assert_array_equal(again[1]["scales"], fresh[1]["scales"])


def test_uncollected_chunk_keeps_its_buffers():
    """Buffers a queued chunk holds are not handed out to the next
    chunk's prep; collecting the chunk gives them back."""
    plan = periodogram_plan(*SURVEY)
    rng = np.random.default_rng(3)
    batches = rng.standard_normal((2, 2, SURVEY[0])).astype(np.float32)
    tobs = SURVEY[0] * SURVEY[1]
    pool = engine.StagingPool(CPU)
    h1 = engine.queue_search_batch(plan, batches[0], tobs, device="cpu",
                                   pool=pool, **PKW)
    held = {t.data_ptr() for t in h1[2][1][1]["staging"]}
    assert len(held) == 2
    p2 = engine.prepare_stage_data(plan, batches[1], pool=pool)
    assert held.isdisjoint(t.data_ptr() for t in p2[1]["staging"])
    peaks, _ = engine.collect_search_batch(h1, np.zeros(2))
    direct, _ = engine.run_search_batch(plan, batches[0], tobs,
                                        device="cpu", **PKW)
    assert peaks == direct
    p3 = engine.prepare_stage_data(plan, batches[1], pool=pool)
    assert {t.data_ptr() for t in p3[1]["staging"]} == held
    np.testing.assert_array_equal(p3[0], p2[0])


def test_pool_drops_buffers_past_its_cap():
    pool = engine.StagingPool(CPU, max_per_key=1)
    a = pool.acquire((2, 8), torch.uint8)
    b = pool.acquire((2, 8), torch.uint8)
    assert a.data_ptr() != b.data_ptr()
    pool.release(a)
    pool.release(b)
    assert pool.acquire((2, 8), torch.uint8).data_ptr() == a.data_ptr()
    assert pool.acquire((2, 8), torch.uint8).data_ptr() not in (
        a.data_ptr(), b.data_ptr())


def test_numpy_path_serves_when_the_build_fails(plans, batch, monkeypatch,
                                                caplog):
    """A failed build logs a warning; the engine then prepares the same
    wire with numpy and records it."""
    _, plan = plans
    want = engine.prepare_stage_data(plan, batch, mode="uint6")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)

    def fail():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "build", fail)
    with caplog.at_level(logging.WARNING, logger="riptide_tpu_torch.native"):
        assert not native.available()
    assert "numpy" in caplog.text
    flat, meta = engine.prepare_stage_data(plan, batch, mode="uint6",
                                           pool=engine.StagingPool(CPU))
    assert meta["prep"] == "numpy" and meta["staging"] == ()
    np.testing.assert_array_equal(flat, want[0])
    np.testing.assert_array_equal(meta["scales"], want[1]["scales"])


def test_float16_wire_bytes_match_reference(plans, batch, monkeypatch):
    ref, plan = plans
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")
    want, wmeta = ref_engine.prepare_stage_data(ref, batch, mode="float16")
    got, gmeta = engine.prepare_stage_data(plan, batch, mode="float16")
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmeta["offs"], wmeta["offs"])


@pytest.mark.parametrize("cfg", [CFG, SURVEY], ids=["tiny", "survey"])
def test_float16_periodogram_matches_reference(monkeypatch, cfg):
    """The JAX package's float16 search runs on its gather path on the
    CPU, as its own tests run it."""
    monkeypatch.setenv("RIPTIDE_FFA_PATH", "gather")
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "float16")
    data = np.random.default_rng(5).standard_normal(cfg[0]).astype(
        np.float32)
    P1, F1, S1 = ref_engine.run_periodogram(ref_plan(*cfg), data)
    with engine.recording() as rec:
        P2, F2, S2 = engine.run_periodogram(periodogram_plan(*cfg), data,
                                            device="cpu")
    assert rec["meta"]["mode"] == "float16"
    assert {r["kind"] for r in rec["launches"]} == {"cascade_stage"}
    np.testing.assert_array_equal(P2, P1)
    np.testing.assert_array_equal(F2, F1)
    np.testing.assert_allclose(S2, S1, rtol=RTOL, atol=ATOL)
