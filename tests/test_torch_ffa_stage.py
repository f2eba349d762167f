"""
The port's stage functions against the JAX package's, on the CPU.

* Plain ``ffa_levels`` is bitwise equal to the JAX ``ffa_levels``: the
  same tables, one float add per element in the same tree.
* Plain ``snr_batched`` matches the JAX ``snr_batched`` within rtol 1e-5,
  atol 1e-4: only the prefix sum's summation order differs (torch's CPU
  cumsum accumulates sequentially, XLA's is a log-depth scan), a few
  float32 ulps of prefix values, far inside that tolerance.
* ``fused_stage_plain`` (K1) matches the JAX package's fused Pallas
  kernel ``_fused_kernel``, and ``cascade_stage_plain`` (K2) its
  ``_kernel``, both run in interpret mode as the JAX package's own tests
  run them, within the same tolerance: the Pallas kernels compute the
  S/N as ``coef[w] * dmax - coef[16 + w] * total`` from a log-step
  prefix scan (ffa_kernel.py:421), a different operation order from
  ``snr_batched``'s ``((h + b) * dmax - b * total) / std``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riptide_tpu.search.engine as ref_engine
from riptide_tpu.ops.ffa import ffa_levels as ref_ffa_levels
from riptide_tpu.ops.plan import FFABatchPlan as RefBatchPlan
from riptide_tpu.ops.snr import snr_batched as ref_snr_batched
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch.ops import ffa_kernel as fk
from riptide_tpu_torch.ops.ffa import ffa_levels
from riptide_tpu_torch.ops.plan import FFABatchPlan
from riptide_tpu_torch.ops.snr import boxcar_coeffs, snr_batched
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.search.plan import periodogram_plan
from riptide_tpu_torch.utils import cuda_build

RTOL, ATOL = 1e-5, 1e-4
CFG = (2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)
CPU = torch.device("cpu")

BATCHES = {
    "mixed": ([37, 29, 1], [33, 40, 33], 48, 40),
    "tiny-stage": None,  # the tiny plan's first stage
    "deep": ([250, 240, 230, 1], [240, 250, 260, 240], 384, 260),
}


def _batch(name):
    if BATCHES[name] is None:
        b = periodogram_plan(*CFG).stages[0].batch
        return b.m.tolist(), b.p.tolist(), b.R, b.P
    return BATCHES[name]


def _container(ms, ps, R, P, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(ms), R, P), np.float32)
    for i, (m, p) in enumerate(zip(ms, ps)):
        x[i, :m, :p] = rng.standard_normal((m, p))
    return x


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_ffa_levels_bitwise(name):
    ms, ps, R, P = _batch(name)
    b = FFABatchPlan(ms, ps, R=R, P=P)
    rb = RefBatchPlan(ms, ps, R=R, P=P)
    np.testing.assert_array_equal(b.h, rb.h)
    x = _container(ms, ps, R, P, seed=len(name))
    want = ref_ffa_levels(jnp.asarray(x), jnp.asarray(rb.h), jnp.asarray(rb.t),
                          jnp.asarray(rb.shift), jnp.asarray(rb.p))
    got = ffa_levels(torch.from_numpy(x), torch.from_numpy(b.h),
                     torch.from_numpy(b.t), torch.from_numpy(b.shift),
                     torch.from_numpy(b.p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_snr_matches_reference(name):
    ms, ps, R, P = _batch(name)
    widths = tuple(w for w in (1, 2, 3, 4, 6, 9, 13) if w < min(ps))
    b = FFABatchPlan(ms, ps, R=R, P=P)
    x = ffa_levels(torch.from_numpy(_container(ms, ps, R, P, seed=7)),
                   torch.from_numpy(b.h), torch.from_numpy(b.t),
                   torch.from_numpy(b.shift), torch.from_numpy(b.p))
    hc = np.zeros((len(ms), len(widths)), np.float32)
    bc = np.zeros_like(hc)
    for i, p in enumerate(ps):
        hc[i], bc[i] = boxcar_coeffs(p, widths)
    std = np.linspace(1.0, 3.0, len(ms)).astype(np.float32)
    want = ref_snr_batched(jnp.asarray(x.numpy()), jnp.asarray(b.p), widths,
                           jnp.asarray(hc), jnp.asarray(bc), jnp.asarray(std))
    got = snr_batched(x, torch.from_numpy(b.p), widths, torch.from_numpy(hc),
                      torch.from_numpy(bc), torch.from_numpy(std))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def stage_case():
    """The tiny two-stage plan with a uint6 wire and a float32 wire of
    the same D = 2 batch, in both packages' forms."""
    ref, plan = ref_plan(*CFG), periodogram_plan(*CFG)
    rng = np.random.default_rng(11)
    batch = rng.standard_normal((2, CFG[0])).astype(np.float32)
    wire, scales = engine._prepare_uint(plan, batch, "uint6")
    flat, meta = engine.prepare_stage_data(plan, batch, mode="float32")
    return ref, plan, batch, wire, scales, flat, meta


def _assert_stage_close(st, got, want):
    """Compare the evaluated rows of every real trial of a stage."""
    for i, re in enumerate(st.rows_eval):
        np.testing.assert_allclose(got[:, i, :re], want[:, i, :re],
                                   rtol=RTOL, atol=ATOL)


def test_fused_stage_plain_matches_pallas_k1(stage_case):
    ref, plan, _, wire, scales, _, _ = stage_case
    vl = engine._view_layout(plan, "uint6")
    nw = len(plan.widths)
    wire_j, scales_j = jnp.asarray(wire), jnp.asarray(scales[..., None])
    for i, (st, rst) in enumerate(zip(plan.stages, ref.stages)):
        tables, coefs = engine._stage_operands(st, plan, CPU)
        geom = fk.StageGeom("uint6", int(vl["roffs"][i]), int(vl["prs"][i]),
                            int(vl["soffs"][i]), int(vl["r0s"][i]), st.n)
        got = fk.fused_stage(torch.from_numpy(wire), torch.from_numpy(scales),
                             geom, tables, coefs).numpy()
        kern = rst.cycle_kernel(interpret=True)
        sv = ref_engine._stagevec(rst, ref_engine._view_layout(ref, "uint6"),
                                  i, int(vl["roffs"][i]), "uint6")
        want = np.asarray(kern.run_fused(sv, wire_j, scales_j, "uint6"))
        assert got.shape == (2, len(st.ms_padded), st.rows_eval_max, nw)
        _assert_stage_close(st, got, want[..., : st.rows_eval_max, :nw])


def test_cascade_stage_plain_matches_pallas_k2(stage_case):
    ref, plan, _, _, _, flat, meta = stage_case
    nw = len(plan.widths)
    for i, (st, rst) in enumerate(zip(plan.stages, ref.stages)):
        off = int(meta["offs"][i])
        xd = flat[:, off : off + st.n]
        tables, coefs = engine._stage_operands(st, plan, CPU)
        container = engine._pack(torch.from_numpy(xd), tables.p, tables.m,
                                 st.batch.R, tables.P)
        got = fk.cascade_stage(container, tables, coefs).numpy()
        kern = rst.cycle_kernel(interpret=True)
        shapes = tuple(zip(rst.ms_padded, rst.ps_padded))
        x = ref_engine._pack_container(jnp.asarray(xd), shapes, kern.rows,
                                       kern.P)
        want = np.asarray(kern(x))
        _assert_stage_close(st, got, want[..., : st.rows_eval_max, :nw])


def test_stage_checks_refuse_bad_operands(stage_case):
    """The checks a CUDA wrapper makes before launching: operand dtypes
    and shapes. The container width P is no limit: the S/N kernel takes
    every width (fewer rows a block past the 4-row shared-memory width,
    a device scratch row past one row's)."""
    _, plan, _, _, _, _, _ = stage_case
    st = plan.stages[0]
    tables, coefs = engine._stage_operands(st, plan, CPU)
    B, R, P = st.batch.B, st.batch.R, st.batch.P
    fk._check_stage(tables, coefs, 2, B, R, P, CPU)
    pmax = fk.MAX_DYNAMIC_SMEM // (4 * fk.SNR_WARPS)
    for wide in (pmax, pmax + 1, 4 * pmax + 1, 70000):
        fk._check_stage(tables, coefs, 2, B, R, wide, CPU)
    with pytest.raises(ValueError, match="tables.h"):
        fk._check_stage(tables._replace(h=tables.h.long()), coefs, 2, B, R,
                        P, CPU)
    with pytest.raises(ValueError, match="coefs.rows"):
        fk._check_stage(tables, coefs._replace(rows=R + 1), 2, B, R, P, CPU)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A kernel build that fails raises; nothing falls back, and the
    build cache holds no library."""
    monkeypatch.setenv("RIPTIDE_CACHE_ROOT", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fk.build()
    assert not list(tmp_path.rglob("*.so")) + list(tmp_path.rglob("*.sha256"))


def test_cpu_wrappers_launch_nothing(stage_case):
    """On CPU tensors the wrappers run their plain versions: no kernel
    launch is counted."""
    _, plan, batch, _, _, _, _ = stage_case
    fk.reset_launches()
    engine.run_periodogram_batch(plan, batch, device="cpu")
    assert fk.LAUNCHES == {"fused_stage": 0, "cascade_stage": 0,
                           "paired_stage": 0}


def test_snr_batched_refuses_non_finite_host_input():
    """Both packages' ``snr_batched`` route a host array through the
    data-quality guard first: a NaN raises the same ValueError, naming
    the entry point."""
    x = np.zeros((2, 4, 8), np.float32)
    x[0, 1, 2] = np.nan
    p = np.full(2, 8, np.int32)
    coef = np.ones((2, 2), np.float32)
    std = np.ones(2, np.float32)
    for fn in (ref_snr_batched, snr_batched):
        with pytest.raises(ValueError, match=r"^ops\.snr\.snr_batched: input "
                                             r"contains non-finite samples"):
            fn(x, p, (1, 2), coef, coef, std)
