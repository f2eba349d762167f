"""
The port's chip probes (``riptide_tpu_torch.probes``) against the JAX
tools they replace, on the CPU.

Every P1 pattern, P2 body and P3 slot level runs the same numpy input
through the tool's own Pallas kernel body (``tools/ptime.py``,
``tools/ptime2.py``, ``tools/probe1536.py``, loaded by path, in
interpret mode with the tool's block specs, at small sizes set on the
module globals the bodies read) and through the port's plain PyTorch
version. Exact, except where XLA on the CPU contracts ``acc * 1.0001 +
x`` (P1 add and tile add) or ``acc * 1.0001 + 0.5`` (P2 add) into one
fused multiply-add that PyTorch rounds twice (one rounding of relative
size 2**-24 a pass: rtol 1e-6 at these pass counts), and the matmul
(sums of 64 products in another order: rtol 1e-5, atol 1e-6).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from riptide_tpu_torch.probes import common, probe1536, ptime, ptime2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_VARS = ("JAX_COMPILATION_CACHE_DIR",
               "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
FMA_RTOL = 1e-6
MM_RTOL, MM_ATOL = 1e-5, 1e-6


def _load_tool(name):
    """tools/<name>.py as a module, with the two JAX cache variables it
    sets by default restored afterwards."""
    saved = {k: os.environ.get(k) for k in _CACHE_VARS}
    try:
        spec = importlib.util.spec_from_file_location(
            f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mod


@pytest.fixture(scope="module")
def tools():
    return {n: _load_tool(n) for n in ("ptime", "ptime2", "probe1536")}


def _interpret(kern, args, shape, smem_first=False):
    """The tool's kernel body as a pallas_call in interpret mode, every
    operand in VMEM (the first in SMEM when ``smem_first``)."""
    in_specs = [pl.BlockSpec(memory_space=pltpu.VMEM) for _ in args]
    if smem_first:
        in_specs[0] = pl.BlockSpec(memory_space=pltpu.SMEM)
    call = pl.pallas_call(
        kern, in_specs=in_specs,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32), interpret=True)
    return np.asarray(call(*[jnp.asarray(a) for a in args]))


def _assert_match(got, want, rtol=0.0, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    if rtol == 0.0 and atol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# P1: tools/ptime.py
# ---------------------------------------------------------------------------

ROWS, P = 64, 128
# pattern -> (tool body, REPS, tolerance); stride_roll at REPS 8 keeps
# interpret mode to seconds.
P1_CASES = {
    "add": ("kern_add", 16, FMA_RTOL),
    "roll_lanes": ("kern_roll", 16, 0.0),
    "roll_rows": ("kern_roll_rows", 16, 0.0),
    "select": ("kern_select", 16, 0.0),
    "barrel": ("kern_barrel", 16, 0.0),
    "interleave": ("kern_interleave", 16, 0.0),
    "repeat_tpu": ("kern_repeat_tpu", 16, 0.0),
    "repeat_flat": ("kern_repeat_flat", 16, 0.0),
    "dynroll": ("kern_dynroll", 16, 0.0),
    "stride_roll": ("kern_stride_roll", 8, 0.0),
    "matmul": ("kern_matmul", 16, MM_RTOL),
}


def _p1_inputs(name):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROWS, P)).astype(np.float32)
    if name == "dynroll":
        return (np.arange(8, dtype=np.int32) * 37 + 5, x)
    if name == "matmul":
        return (rng.standard_normal((ROWS, ROWS)).astype(np.float32), x)
    return (x,)


@pytest.mark.parametrize("name", list(P1_CASES))
def test_p1_pattern_matches_tool(tools, monkeypatch, name):
    tool = tools["ptime"]
    body, reps, rtol = P1_CASES[name]
    monkeypatch.setattr(tool, "ROWS", ROWS)
    monkeypatch.setattr(tool, "P", P)
    monkeypatch.setattr(tool, "REPS", reps)
    args = _p1_inputs(name)
    want = _interpret(getattr(tool, body), args, (ROWS, P),
                      smem_first=name == "dynroll")
    got = getattr(ptime, f"{name}_plain")(
        *[torch.from_numpy(a) for a in args], reps)
    _assert_match(got, want, rtol, MM_ATOL if name == "matmul" else 0.0)


@pytest.mark.parametrize("kind", ["add", "roll"])
@pytest.mark.parametrize("shape", [(8, 128), (16, 384)])
def test_p1_tile_sweep_matches_tool(tools, monkeypatch, kind, shape):
    tool = tools["ptime"]
    monkeypatch.setattr(tool, "REPS", 16)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    make = tool.make_tile_add if kind == "add" else tool.make_tile_roll
    want = _interpret(make(*shape), (x,), shape)
    port = ptime.add_plain if kind == "add" else ptime.roll_lanes_plain
    _assert_match(port(torch.from_numpy(x), 16), want,
                  FMA_RTOL if kind == "add" else 0.0)


def test_pltpu_repeat_is_a_tile():
    """``pltpu.repeat(v, 2, axis=0)`` tiles v, unlike ``jnp.repeat``: so
    ``repeat_tpu`` reads row s mod S_c of each half where ``interleave``
    reads row s // 2, and the two patterns differ."""
    v = np.random.default_rng(2).standard_normal((8, 128)).astype(np.float32)

    def kern(v_ref, o_ref):
        o_ref[:] = pltpu.repeat(v_ref[:], 2, axis=0)

    np.testing.assert_array_equal(_interpret(kern, (v,), (16, 128)),
                                  np.tile(v, (2, 1)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (ROWS, P)).astype(np.float32))
    S_c = ROWS // ptime.G // 2
    once = ptime.repeat_tpu_plain(x, 8)
    half0, half1 = x[:S_c], x[S_c: 2 * S_c]
    s = torch.arange(2 * S_c)
    torch.testing.assert_close(once[: 2 * S_c],
                               half0[s % S_c] + half1[s % S_c], rtol=0, atol=0)
    assert not torch.equal(once, ptime.interleave_plain(x, 8))


def test_stride_roll_rolls_row_r_by_shift_plus_r():
    """``pltpu.roll(x, shift, 1, stride=1, stride_axis=0)`` rolls row r by
    shift + r, as np.roll would; the port's plain version follows it."""
    x = np.random.default_rng(4).standard_normal((16, 128)).astype(np.float32)

    def kern(x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], 5, axis=1, stride=1, stride_axis=0)

    want = np.stack([np.roll(x[r], 5 + r) for r in range(16)])
    np.testing.assert_array_equal(_interpret(kern, (x,), x.shape), want)
    xt = torch.from_numpy(x)
    # One repetition: acc = x + (x with row r rolled by 0 + r).
    ref = x + np.stack([np.roll(x[r], r) for r in range(16)])
    np.testing.assert_array_equal(ptime.stride_roll_plain(xt, 1).numpy(), ref)


# ---------------------------------------------------------------------------
# P2: tools/ptime2.py
# ---------------------------------------------------------------------------

P2_SHAPE, P2_NITER = (16, 32), 50
P2_RTOL = {"add": FMA_RTOL, "roll1": 0.0, "rollrow": 0.0, "dynroll": 0.0,
           "select": 0.0, "barrelbit": 0.0}


@pytest.mark.parametrize("name", list(ptime2.BODIES))
def test_p2_body_matches_tool(tools, name):
    tool = tools["ptime2"]
    body = tool.BODIES[name]

    def kern(x_ref, o_ref):
        o_ref[:] = jax.lax.fori_loop(
            0, P2_NITER, lambda i, acc: body(i, acc, P2_SHAPE), x_ref[:])

    x = (np.random.default_rng(0).standard_normal(P2_SHAPE).astype(np.float32)
         * np.float32(1e-3))
    want = _interpret(kern, (x,), P2_SHAPE)
    got = getattr(ptime2, f"{name}_plain")(torch.from_numpy(x), P2_NITER)
    _assert_match(got, want, P2_RTOL[name])


def test_p2_bodies_are_the_tools():
    assert set(ptime2.BODIES) == set(_load_tool("ptime2").BODIES)


# ---------------------------------------------------------------------------
# P3: tools/probe1536.py
# ---------------------------------------------------------------------------

P3_R, P3_P, P3_L, P3_NITER = 96, 128, 7, 4


def _p3_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((P3_R, P3_P)).astype(np.float32)
    w = rng.integers(0, 4, (P3_R, P3_P), dtype=np.int32) << 22
    return x, w


@pytest.fixture()
def p3_tool(tools, monkeypatch):
    tool = tools["probe1536"]
    for name, value in (("R", P3_R), ("P", P3_P), ("L", P3_L),
                        ("NITER", P3_NITER)):
        monkeypatch.setattr(tool, name, value)
    return tool


@pytest.mark.parametrize("level", [4, 5, 6, 7])
def test_p3_slot_level_matches_tool(p3_tool, level):
    """S_d = 12, 24, 48, 96 (S_c = 6 is the base-3 case the tool probes):
    the tool's kernel, its numpy sequence and the port's plain version
    give the same bits."""
    S_d = P3_R >> (P3_L - level)
    x, w = _p3_inputs()
    want = _interpret(functools.partial(p3_tool.slot_level_kernel, S_d=S_d),
                      (x, w), (P3_R, P3_P))
    ref = x
    for _ in range(P3_NITER):
        ref = p3_tool.numpy_ref(ref, w, S_d)
    np.testing.assert_array_equal(want, ref)
    got = probe1536.slot_level_plain(torch.from_numpy(x), torch.from_numpy(w),
                                     S_d, P3_NITER)
    _assert_match(got, want)


def test_p3_numpy_ref_is_the_tools(p3_tool):
    x, w = _p3_inputs()
    for _, S_d in probe1536.levels(P3_R, P3_L):
        np.testing.assert_array_equal(probe1536.numpy_ref(x, w, S_d),
                                      p3_tool.numpy_ref(x, w, S_d))


def test_p3_levels_are_the_tools():
    """At the tool's own R, L and NL: S_d = 12 ... 1536."""
    assert [s for _, s in probe1536.levels()] == [
        probe1536.R >> (probe1536.L - lv)
        for lv in range(probe1536.NL + 1, probe1536.L + 1)]
    assert probe1536.levels()[0] == (4, 12)
    assert probe1536.levels()[-1] == (11, 1536)


# ---------------------------------------------------------------------------
# Wrappers, entry points, tiles and bounds
# ---------------------------------------------------------------------------

def _wrapper_calls():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (32, 128)).astype(np.float32))
    sh = torch.from_numpy(np.arange(8, dtype=np.int32) * 37 + 5)
    a = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (32, 32)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, (32, 128), dtype=np.int32) << 22)
    calls = [(ptime, n, (x, 8)) for n in (
        "add", "roll_lanes", "roll_rows", "select", "barrel", "interleave",
        "repeat_tpu", "repeat_flat", "stride_roll")]
    calls += [(ptime, "dynroll", (sh, x, 8)), (ptime, "matmul", (a, x, 8))]
    calls += [(ptime2, n, (x, 20)) for n in ptime2.BODIES]
    calls += [(probe1536, "slot_level", (x, w, 16, 3))]
    return calls


def test_cpu_wrappers_run_plain_and_count_nothing():
    """On CPU tensors every wrapper is its plain version, launches
    nothing, and every kernel of a probe has its count."""
    for mod in (ptime, ptime2, probe1536):
        mod.reset_launches()
    calls = _wrapper_calls()
    for mod, name, args in calls:
        got = getattr(mod, name)(*args)
        want = getattr(mod, f"{name}_plain")(*args)
        assert torch.equal(got, want), (mod.__name__, name)
    counted = {(m.__name__, k) for m in (ptime, ptime2, probe1536)
               for k in m.LAUNCHES}
    assert counted == {(m.__name__, n) for m, n, _ in calls}
    assert all(v == 0 for m in (ptime, ptime2, probe1536)
               for v in m.LAUNCHES.values())
    assert not any(common.KERNEL_LAUNCHES.values())


def test_entry_points_run_on_cpu(capsys):
    """``--device cpu`` runs each probe's plain versions end to end (P3
    checks every level against numpy). Without it the probes need a card
    (``tests/test_torch_isolation.py``)."""
    res1 = ptime.main(["--device", "cpu", "--rows", "32", "--cols", "128",
                       "--reps", "8", "inter", "mm"])
    assert [r.name for r in res1] == ["interleave", "repeat_tpu",
                                      "parity_sel", "matmul"]
    res2 = ptime2.main(["--device", "cpu", "--niter", "10", "--shape", "8x32",
                        "rollrow", "barrelbit"])
    assert [(r.name, tuple(r.out.shape)) for r in res2] == [
        ("rollrow", (8, 32)), ("barrelbit", (8, 32))]
    res3 = probe1536.main(["--device", "cpu", "--rows", "48", "--cols", "128",
                           "--depth", "5", "--niter", "3"])
    assert [r.name for r in res3] == ["l=4 S_d=24", "l=5 S_d=48"]
    assert all(r.ok for r in res3)
    out = capsys.readouterr().out
    assert "sync RT" in out and "Gelem/s" in out and "ok=True" in out
    for mod, res in ((ptime, res1), (ptime2, res2), (probe1536, res3)):
        for r in res:
            assert torch.equal(r.out, getattr(mod, f"{r.wrapper}_plain")(
                *r.args))


def test_tile_choices_and_refusals():
    """The tiles the launchers choose at the tools' shapes, and the shapes
    that no tile fits (ValueError before any launch): ``lane_row_kernel``
    one row a warp in shared memory, cols / 32 values a lane rounded up
    to a built width; ``row_window_kernel`` a window of 64 + smax rows (the
    largest roll_rows shift: 156 at 2048 rows and 32 repetitions);
    ``strip_kernel`` strips narrowed to two blocks an SM, at most 4
    elements a thread (P1's interleave 8 columns of a 256-row group, P3's
    S_d = 96 16 columns); a strip of one column runs in
    ``strip_cluster_kernel`` (P3's S_d = 1536), 8 columns a cluster, at
    most 8 elements a thread."""
    assert [common.lane_values(c) for c in (8, 33, 128, 384, 1000)] == [
        1, 2, 4, 12, 32]
    assert common.window_shift(2048, 32) == 156
    assert common.window_shift(64, 32) == 62       # the shifts wrap
    assert common.window_shift(2048, 0) == 0
    assert common.strip_tile(2048, 384, 256) == (3, 512, False)  # interleave
    assert common.strip_tile(1536, 384, 96) == (4, 384, False)   # P3
    assert common.strip_tile(1536, 384, 192) == (3, 384, False)
    assert common.strip_tile(1536, 384, 384) == (2, 384, False)
    assert common.strip_tile(1536, 384, 768) == (1, 384, False)
    assert common.strip_tile(1536, 384, 1536) == (0, 192, True)
    assert common.strip_tile(4096, 384, 4096) == (0, 512, True)
    assert common.strip_tile(32, 128, 4) == (1, 32, False)
    assert common.strip_tile(32, 128, 32) == (0, 32, True)
    with pytest.raises(ValueError, match="shared memory"):
        common.lane_values(1025)
    with pytest.raises(ValueError, match="shared memory"):
        common.window_shift(40000, 400)
    with pytest.raises(ValueError, match="at most 8192"):
        common.strip_tile(40000, 8, 10000)
    with pytest.raises(ValueError):
        common.check_matrix(torch.zeros((4, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        common.check_matrix(torch.zeros(16))
    with pytest.raises(ValueError, match="divisible"):
        ptime.interleave_plain(torch.zeros((24, 8)))
    with pytest.raises(ValueError, match="even S_d"):
        probe1536.slot_level_plain(torch.zeros((24, 8)),
                                   torch.zeros((24, 8), dtype=torch.int32), 9)
    for S in (0, 3, 5):
        with pytest.raises(ValueError, match="even S"):
            common.strip("p1.interleave", torch.zeros((30, 4)), S, 1)


def test_register_layouts_and_refusals():
    """The register layouts of P2's kernels, P1's select and parity select
    and P3's small slot levels, and the GEMM's grid at the tools' shapes,
    and the shapes they refuse (ValueError before any launch): ``select``
    (P1 and P2) K rows of one column a thread, two warps per scheduler
    where the shape allows; P1's parity select whole row pairs (K even);
    P3's levels of 12, 24 and 48 rows one group column a thread;
    ``roll1``/``dynroll``/``barrelbit`` one row a warp, cols / 32 values a
    lane; ``rollrow`` R rows a thread of one column a block; the GEMM 64
    x 96 output tiles, one launch a product, 128 blocks at (2048, 384):
    one for each of 128 of the H100's 132 SMs."""
    assert [common.select_rows(*s) for s in ptime2.SHAPES] == [8, 8, 4, 2]
    assert common.select_rows(15, 32) == 1
    assert common.select_rows(ptime.ROWS, ptime.P) == 8
    assert [common.pair_rows(r, c) for r, c in ((2048, 384), (256, 384),
                                                (15, 32))] == [8, 2, 2]
    assert common.SLOT_REG_LEVELS == (12, 24, 48)
    assert [S in common.SLOT_REG_LEVELS
            for _, S in probe1536.levels()] == [True] * 3 + [False] * 5
    assert [common.row_values(c) for c in (32, 128, 384)] == [1, 4, 12]
    for cols in (40, 96, 512, 40000):
        with pytest.raises(ValueError, match="one row a warp"):
            common.row_values(cols)
    assert [common.column_rows(r) for r in (2048, 1024, 256, 15, 16)] == [
        (16, 4), (16, 2), (16, 1), (1, 1), (16, 1)]
    assert common.column_rows(16384) == (16, 32)
    for rows in (40000, 16400, 1025):
        with pytest.raises(ValueError, match="threads a column"):
            common.column_rows(rows)
    assert common.GEMM_TILE == (64, 96, 64)
    assert common.gemm_grid(2048, 384) == (4, 32)
    assert common.gemm_grid(100, 70) == (1, 2)
    assert common.gemm_grid(129, 65) == (1, 3)


def _tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on
    the 13 low mantissa bits, ties away from zero."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, x, terms):
    """a @ x from TF32 parts, the products summed in float64: ``terms`` 1
    is one TF32 product, 3 the 3xTF32 split (big = tf32(v), small =
    tf32(v - big); big * big + big * small + small * big)."""
    ab, xb = _tf32(a), _tf32(x)
    parts = [(ab, xb)]
    if terms == 3:
        parts += [(ab, _tf32(x - xb)), (_tf32(a - ab), xb)]
    return sum(u.astype(np.float64) @ v.astype(np.float64)
               for u, v in parts).astype(np.float32)


def test_3xtf32_split_holds_the_matmul_tolerance():
    """P1's chain of four products (a @ acc) * 0.001 + i, emulated with
    3xTF32 products, stays within the card's GEMM tolerance
    (``PROBE_MM_RTOL``/``ATOL`` 1e-5, tests/test_torch_probes_cuda.py) of
    the float32 chain, at under 1 % of it; one TF32 product a step does
    not (the tensor cores alone at TF32 cannot be the port's GEMM)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 128)).astype(np.float32)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    ref = t3 = t1 = x
    for i in range(4):
        ref = (a @ ref) * np.float32(0.001) + np.float32(i)
        t3 = _tf32_product(a, t3, 3) * np.float32(0.001) + np.float32(i)
        t1 = _tf32_product(a, t1, 1) * np.float32(0.001) + np.float32(i)
    limit = 1e-5 + 1e-5 * np.abs(ref)
    assert (np.abs(t3 - ref) / limit).max() < 0.01
    np.testing.assert_allclose(t3, ref, rtol=1e-5, atol=1e-5)
    assert (np.abs(t1 - ref) / limit).max() > 1.0
    # The split itself: big + small keeps all but ~2 of float32's bits.
    v = rng.standard_normal(4096).astype(np.float32)
    big = _tf32(v)
    assert not np.array_equal(big, v)
    err = np.abs(v.astype(np.float64) - big - _tf32(v - big)) / np.abs(v)
    assert err.max() < 2.0 ** -21


def test_bounds_at_the_tools_shapes():
    """The bounds the chip smoke test prints, from the work counts: a P1
    pattern at (2048, 384) moves 6.29 MB (~1.9 us, bound by bytes); the
    matmul's 4 products are 3.87e10 TF32 flops in 3xTF32 (three TF32
    products each) at the tensor cores' 495 TFLOP/s (~0.078 ms); a P2
    launch is bound by operations; a P3 launch moves 7.1 MB."""
    def bound(nbytes, ops, tensor=False):
        return common.Result("", "", (), torch.zeros(1, 1), 1.0, 1.0, 1,
                             nbytes, ops, tensor=tensor).bound()

    passes, nbytes, ops = ptime.work("roll_lanes", 2048, 384, 32)
    assert (passes, nbytes) == (32, 6291456)
    ms, by = bound(nbytes, ops)
    assert by == "bytes" and abs(ms - 1.878e-3) < 1e-5
    passes, nbytes, ops = ptime.work("matmul", 2048, 384, 32)
    assert ops == 4 * 3 * 2 * 2048 * 384 * 2048
    ms, by = bound(nbytes, ops, tensor=True)
    assert passes == 4 and by == "operations (tensor cores)"
    assert abs(ms - 0.07809) < 1e-4
    nbytes, ops = ptime2.work("add", 2048, 384, 20000)
    ms, by = bound(nbytes, ops)
    assert by == "operations" and abs(ms / 20000 * 1e3 - 0.0470) < 1e-3
    r = probe1536.run(rows=96, cols=128, depth=6, niter=2, device="cpu")[0]
    assert r.nbytes == 12 * 96 * 128 and r.ok
