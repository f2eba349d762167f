"""
The port's sequence-parallel FFA (``riptide_tpu_torch.parallel.seqffa``)
against the JAX package's on the CPU: the JAX package on its virtual
CPU devices (tests/conftest.py), the port on ``["cpu"] * S`` shards. The
row-sharded transform must be the port's ``ffa2`` bit for bit, and the
JAX package's ``ffa2_seq`` up to the sign of a zero (the JAX package
sums partial permutes, ``array_equal`` treats -0.0 and 0.0 as equal).
"""
import numpy as np
import pytest
import torch

import jax

from riptide_tpu.parallel import seqffa as ref_seqffa
from riptide_tpu_torch.ops.ffa import ffa2
from riptide_tpu_torch.parallel import seqffa
from riptide_tpu_torch.parallel.mesh import Mesh


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small per-shard ops:
    torch's pool spins between ops, which costs ~30x when the suite's
    parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(data, S):
    got = seqffa.ffa2_seq(data, mesh=seqffa.seq_mesh(["cpu"] * S))
    ref = ref_seqffa.ffa2_seq(data,
                              mesh=ref_seqffa.seq_mesh(jax.devices()[:S]))
    return got, ref


def _check(data, S):
    got, ref = _both(data, S)
    want = ffa2(data, device="cpu")
    assert got.shape == data.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("m_local", [1, 3, 4, 6])
def test_seq_matches_ffa2_and_reference(S, m_local):
    m = S * m_local
    data = np.random.RandomState(m).normal(size=(m, 40)).astype(np.float32)
    _check(data, S)


@pytest.mark.parametrize("m_local", [8, 12, 13, 128])
def test_seq_windowed_matches_ffa2_and_reference(m_local):
    """The S >= 8 windowed exchange (each shard receives at most four
    buffers a level), power-of-2 and other local row counts."""
    S = 8
    m = S * m_local
    assert seqffa._window_plan(m, S) is not None, "expected the windowed path"
    data = np.random.RandomState(m).normal(size=(m, 33)).astype(np.float32)
    _check(data, S)


@pytest.mark.parametrize("m,S", [(64, 8), (96, 8), (1024, 8), (104, 8),
                                 (16, 8)])
def test_window_plan_equals_reference(m, S):
    """The window tables (or their absence, when a window spans more
    than two shards) are the JAX package's."""
    got = seqffa._window_plan(m, S)
    want = ref_seqffa._window_plan(m, S)
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(seqffa._cross_tables(m, S),
                    ref_seqffa._cross_tables(m, S)):
        np.testing.assert_array_equal(x, y)


def test_single_shard_and_single_row_take_ffa2():
    data = np.random.RandomState(0).normal(size=(8, 16)).astype(np.float32)
    got = seqffa.ffa2_seq(data, mesh=seqffa.seq_mesh(["cpu"]))
    np.testing.assert_array_equal(got, ffa2(data, device="cpu"))
    row = data[:1]
    np.testing.assert_array_equal(
        seqffa.ffa2_seq(row, mesh=seqffa.seq_mesh(["cpu"])), row)


def test_pulse_recovery_across_eight_shards():
    """A pulse train drifting one bin a period, folded across 8 shards,
    peaks on the shift-(m-1) row, as in the JAX package's test."""
    m, p = 64, 128
    data = np.zeros((m, p), np.float32)
    for i in range(m):
        data[i, (3 + i) % p] = 1.0
    out = seqffa.ffa2_seq(data, mesh=seqffa.seq_mesh(["cpu"] * 8))
    assert out[m - 1].max() == pytest.approx(m)


def test_errors_match_reference():
    bad = np.zeros((10, 8), np.float32)
    for fn, mk in ((seqffa.ffa2_seq, lambda n: seqffa.seq_mesh(["cpu"] * n)),
                   (ref_seqffa.ffa2_seq,
                    lambda n: ref_seqffa.seq_mesh(jax.devices()[:n]))):
        with pytest.raises(ValueError, match="divisible"):
            fn(bad, mesh=mk(4))
        with pytest.raises(ValueError, match="two-dimensional"):
            fn(np.zeros(8, np.float32), mesh=mk(2))
        with pytest.raises(ValueError, match="power of two"):
            fn(np.zeros((12, 8), np.float32), mesh=mk(3))


def test_seq_mesh_axis_of_a_2d_mesh():
    """On a 2-D mesh the transform shards over the named axis."""
    data = np.random.RandomState(3).normal(size=(24, 20)).astype(np.float32)
    m = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(4, 2),
             ("seq", "other"))
    np.testing.assert_array_equal(seqffa.ffa2_seq(data, mesh=m),
                                  ffa2(data, device="cpu"))
