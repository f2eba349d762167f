"""
The chip probes' CUDA kernels against their plain PyTorch versions, on a
card.

Marked ``cuda``: skipped on a host without one (the default CPU suite);
run on a card with ``python -m pytest --noconftest
tests/test_torch_probes_cuda.py``. Every kernel but the matmul is the
same float32 operations in the same order as its plain version
(``--fmad=false``), so the outputs are the same bits; the matmul's sums
of K products run in another order than cuBLAS's, each operand split
into two TF32 parts on the tensor cores (3xTF32: rtol 1e-5, atol 1e-5 on
outputs of magnitude ~1-4).
"""
import numpy as np
import pytest
import torch

from riptide_tpu_torch.probes import common, probe1536, ptime, ptime2

pytestmark = pytest.mark.cuda

MM_RTOL, MM_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev)


P1_NAMES = ("add", "roll_lanes", "roll_rows", "select", "barrel",
            "interleave", "repeat_tpu", "repeat_flat", "dynroll",
            "stride_roll", "matmul")
# The tool's shape and the tile sweep's (2048, 384) and (64, 128); 2044
# rows (not a multiple of a lane_row block's 8 rows, of
# row_window_kernel's 64 or of the 8 rows a thread of the select and
# pair kernels); 112 x 33 and 48 x 1000 (widths that are not a multiple of
# 32: one and 32 values a lane of lane_row_kernel, a ragged column strip
# of row_window_kernel and strip_kernel); 8 x 8. The interleave patterns
# take rows divisible by 16 and refuse the others.
P1_SHAPES = [(2048, 384), (64, 128), (2044, 384), (112, 33), (48, 1000),
             (8, 8)]


@pytest.mark.parametrize("reps", [1, 7, 32, 33])
@pytest.mark.parametrize("shape", P1_SHAPES)
@pytest.mark.parametrize("name", P1_NAMES)
def test_p1_kernel_matches_plain(dev, name, shape, reps):
    """Each P1 pattern's kernel against its plain version, bit for bit but
    the matmul, at REPS 1, 7, 32 and 33 (dynroll's loop of 8 and its
    tail; the barrel's 9 steps and fewer; one and four products)."""
    rng = np.random.default_rng(0)
    x = _randn(rng, shape, dev)
    if name == "dynroll":
        args = (torch.from_numpy(np.arange(8, dtype=np.int32) * 37 + 5).to(
            dev), x)
    elif name == "matmul":
        args = (_randn(rng, (shape[0], shape[0]), dev), x)
    else:
        args = (x,)
    before = ptime.LAUNCHES[name]
    if name in ("interleave", "repeat_tpu") and shape[0] % 16:
        with pytest.raises(ValueError, match="divisible"):
            getattr(ptime, name)(*args, reps)
        assert ptime.LAUNCHES[name] == before
        return
    got = getattr(ptime, name)(*args, reps)
    # One launch a call; the matmul launches its GEMM once a product.
    calls = ptime._passes(name, reps) if name == "matmul" else 1
    assert ptime.LAUNCHES[name] == before + calls
    want = getattr(ptime, f"{name}_plain")(*args, reps)
    if name == "matmul":
        torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("niter", [300, 389])
@pytest.mark.parametrize("shape", [(16, 32), (15, 32), (2048, 384),
                                   (256, 384), (15, 384), (2048, 128),
                                   (15, 128), (2048, 32)])
@pytest.mark.parametrize("name", list(ptime2.BODIES))
def test_p2_kernel_matches_plain(dev, name, shape, niter):
    """At 384, 128 and 32 columns, 15 to 2048 rows, and at an NITER that
    is not a multiple of 4 (nor of 12, dynroll's group at 384 columns)
    and is above the width (select's runs of cols passes)."""
    x = _randn(np.random.default_rng(0), shape, dev) * 1e-3
    before = ptime2.LAUNCHES[name]
    got = ptime2.BODIES[name](x, niter)
    assert ptime2.LAUNCHES[name] == before + 1
    assert torch.equal(got, getattr(ptime2, f"{name}_plain")(x, niter))


@pytest.mark.parametrize("M,N,K", [(100, 70, 37), (129, 65, 1000),
                                   (2048, 384, 2048), (64, 64, 64),
                                   (1, 1, 1), (65, 8, 4)])
def test_gemm_matches_matmul(dev, M, N, K):
    """The 3xTF32 GEMM at ragged shapes (edges masked; 4-byte copies
    where K or N is not a multiple of 4) and at the tool's shape, with
    the (* alpha) + beta epilogue, within 1e-5 of torch.matmul in full
    float32."""
    rng = np.random.default_rng(1)
    a, b = _randn(rng, (M, K), dev), _randn(rng, (K, N), dev)
    got = common.tf32x3_gemm(a, b, 0.001, 2.0)
    want = torch.matmul(a, b) * 0.001 + 2.0
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
    got = common.tf32x3_gemm(a, b, 1.0, 0.0)
    torch.testing.assert_close(got, torch.matmul(a, b), rtol=MM_RTOL,
                               atol=MM_ATOL * K ** 0.5)


@pytest.mark.parametrize("rows,cols,depth", [(96, 128, 7), (1536, 384, 11),
                                             (192, 40, 8)])
def test_p3_kernel_matches_plain_and_numpy(dev, rows, cols, depth):
    """Every slot level bit for bit against the plain version and the
    tool's numpy sequence, at 8 and 5 passes: S_d = 12, 24 and 48 in
    registers (``slot_regs_kernel``), the larger levels in shared memory
    (``strip_kernel``, or ``strip_cluster_kernel`` where a strip would be
    under 8 columns), also at a width that is not a multiple of 32."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    w = rng.integers(0, 4, (rows, cols), dtype=np.int32) << 22
    xd, wd = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    for _, S_d in probe1536.levels(rows, depth):
        kern = ("slot_regs_kernel" if S_d in common.SLOT_REG_LEVELS else
                "strip_cluster_kernel" if common.strip_tile(rows, cols, S_d)[2]
                else "strip_kernel")
        for niter in (8, 5):
            before = common.KERNEL_LAUNCHES[kern]
            got = probe1536.slot_level(xd, wd, S_d, niter)
            assert common.KERNEL_LAUNCHES[kern] == before + 1
            assert torch.equal(got, probe1536.slot_level_plain(xd, wd, S_d,
                                                               niter))
            want = x
            for _ in range(niter):
                want = probe1536.numpy_ref(want, w, S_d)
            np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_time_call_counts_eager_launches_only(dev):
    """A timed pattern counts its eager launches (two warm-ups and the
    CALLS calls between CUDA events), not the calls captured into its
    CUDA graph nor the graph's replays."""
    x = _randn(np.random.default_rng(0), (64, 128), dev)
    before = ptime.LAUNCHES["add"]
    out, ms, call_ms = common.time_call(lambda: ptime.add(x, 32), dev)
    assert ptime.LAUNCHES["add"] == before + 2 + common.CALLS
    assert torch.equal(out, ptime.add_plain(x, 32))
    assert ms > 0 and call_ms > 0


def test_wrappers_refuse_bad_input(dev):
    """A wrong dtype, a shape whose tile exceeds shared memory (a row of
    more than 1024 columns a warp, a roll_rows window, a slot group past
    8192 rows), a width that one row a warp in registers does not take,
    or a column too tall for one block, raises ValueError before any
    launch."""
    x64 = torch.zeros((64, 128), dtype=torch.float64, device=dev)
    wide = torch.zeros((2, 40000), device=dev)
    tall = torch.zeros((40000, 2), device=dev)
    for call in (lambda: ptime.add(x64), lambda: ptime2.roll1(x64),
                 lambda: ptime2.roll1(wide), lambda: ptime.barrel(wide),
                 lambda: ptime2.rollrow(tall),
                 lambda: ptime.roll_lanes(torch.zeros((2, 1025), device=dev)),
                 lambda: ptime.roll_rows(torch.zeros((40000, 2),
                                                     device=dev), 400),
                 lambda: ptime.interleave(torch.zeros((24, 8), device=dev)),
                 lambda: probe1536.slot_level(
                     torch.zeros((40000, 2), device=dev),
                     torch.zeros((40000, 2), dtype=torch.int32, device=dev),
                     40000)):
        with pytest.raises(ValueError):
            call()
    before = dict(ptime2.LAUNCHES)
    kernels = dict(common.KERNEL_LAUNCHES)
    for cols in (40, 96, 512):
        x = torch.zeros((8, cols), device=dev)
        for name in ("roll1", "dynroll", "barrelbit"):
            with pytest.raises(ValueError, match="one row a warp"):
                ptime2.BODIES[name](x, 4)
    for rows in (16400, 1025):
        with pytest.raises(ValueError, match="threads a column"):
            ptime2.rollrow(torch.zeros((rows, 4), device=dev), 4)
    assert ptime2.LAUNCHES == before
    assert common.KERNEL_LAUNCHES == kernels
