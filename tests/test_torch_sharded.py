"""
The port's mesh-sharded search (``riptide_tpu_torch.parallel.sharded``)
against the JAX package's on the CPU: the JAX package on its 8 virtual
CPU devices (tests/conftest.py), the port on ``Mesh(["cpu"] * 8)``, where
K2 runs its plain version. The plan and batch are the JAX package's own
sharded tests' (tests/test_sharded.py: N = 32768, bins 64-71, D = 5, so
the dm axis pads), on the uint6 wire in both packages.
"""
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from riptide_tpu.libffa import generate_signal
from riptide_tpu.parallel import mesh as ref_mesh
from riptide_tpu.parallel import sharded as ref_sharded
from riptide_tpu.search.plan import periodogram_plan as ref_plan
from riptide_tpu_torch.parallel import mesh, sharded
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.search.plan import periodogram_plan

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from synth import generate_data_presto  # noqa: E402

TSAMP = 1e-3
N = 32768
PLAN = (N, TSAMP, (1, 2, 3, 4), 64 * TSAMP, 0.3, 64, 71)
PKW = dict(smin=6.0, segwidth=5.0, nstd=6.0, minseg=10, polydeg=2, clrad=0.1)
DMS = [0.0, 5.0, 10.0, 15.0, 20.0]
SNR_RTOL, SNR_ATOL = 1e-5, 1e-4
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small per-shard ops:
    torch's pool spins between ops, which costs ~30x when the suite's
    parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Both plans, the batch (the pulsar in trial 2) and the JAX
    package's sharded periodogram and peaks on its 8 devices, on the
    uint6 wire."""
    rng = np.random.RandomState(7)
    batch = rng.normal(size=(5, N)).astype(np.float32)
    np.random.seed(5)
    batch[2] = generate_signal(N, 0.1 / TSAMP, amplitude=16.0, ducy=0.05)
    batch -= batch.mean(axis=1, keepdims=True)
    batch /= batch.std(axis=1, keepdims=True)
    rplan = ref_plan(*PLAN)
    saved = os.environ.get("RIPTIDE_WIRE_DTYPE")
    os.environ["RIPTIDE_WIRE_DTYPE"] = "uint6"
    try:
        _, _, ref_snrs = ref_sharded.run_periodogram_sharded(
            rplan, batch, mesh=ref_mesh.default_mesh())
        ref_peaks, _ = ref_sharded.run_search_sharded(
            rplan, batch, tobs=N * TSAMP, dms=DMS,
            mesh=ref_mesh.default_mesh(), mode="uint6", **PKW)
    finally:
        if saved is None:
            os.environ.pop("RIPTIDE_WIRE_DTYPE")
        else:
            os.environ["RIPTIDE_WIRE_DTYPE"] = saved
    return dict(plan=periodogram_plan(*PLAN), rplan=rplan, batch=batch,
                ref_snrs=ref_snrs, ref_peaks=ref_peaks)


@pytest.fixture
def uint6(monkeypatch):
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "uint6")


def _same_peaks(got, want):
    assert len(got) == len(want)
    for d, (g, w) in enumerate(zip(got, want)):
        assert [(p.ip, p.iw, p.dm) for p in g] == \
            [(p.ip, p.iw, p.dm) for p in w], f"trial {d}"
        np.testing.assert_allclose([p.snr for p in g], [p.snr for p in w],
                                   rtol=SNR_RTOL)


@pytest.mark.parametrize("mode", ["uint6", "uint8", "float16"])
def test_sharded_wire_is_the_reference_bytes(setup, mode):
    """The dm-padded wire and scales are the JAX package's
    prepare_stage_data_sharded bytes, and each shard ships its slice."""
    (flat, meta), D = sharded.prepare_stage_data_sharded(
        setup["plan"], setup["batch"], mesh.Mesh(CPU8), mode=mode)
    (rflat, rmeta), rD = ref_sharded.prepare_stage_data_sharded(
        setup["rplan"], setup["batch"], ref_mesh.default_mesh(), mode=mode)
    assert D == rD == 5 and meta["D_original"] == rmeta["D_original"] == 5
    assert flat.shape[0] == 8
    np.testing.assert_array_equal(flat, rflat)
    if rmeta["scales"] is None:
        assert meta["scales"] is None
    else:
        np.testing.assert_array_equal(meta["scales"], rmeta["scales"])
    shards, smeta = sharded.ship_stage_data_sharded(
        setup["plan"], (flat, meta), mesh.Mesh(["cpu"] * 4))
    assert smeta["D_original"] == 5 and len(shards) == 4
    for i, ((wire, m),) in enumerate(shards):
        np.testing.assert_array_equal(wire.numpy(), flat[2 * i : 2 * i + 2])


@pytest.mark.parametrize("grid", [(8, 1), (4, 2), (5, 1)],
                         ids=["dm8", "dm4xbins2", "dm5"])
def test_periodogram_sharded_matches_reference(setup, uint6, grid):
    """1-D meshes (8 shards, D padded; 5 shards) and a 2-D (dm, bins)
    mesh, where each bins shard runs K2 on its slice of every stage's
    bins trials (the JAX package takes its gather path there): the S/N
    cube within the parity bars of the JAX package's 8-device run."""
    n_dm, nb = grid
    devs = ["cpu"] * (n_dm * nb)
    m = mesh.mesh_2d(devs, bins_shards=nb) if nb > 1 else mesh.Mesh(devs)
    periods, foldbins, snrs = sharded.run_periodogram_sharded(
        setup["plan"], setup["batch"], mesh=m)
    assert snrs.shape == setup["ref_snrs"].shape and snrs.dtype == np.float32
    np.testing.assert_allclose(snrs, setup["ref_snrs"], rtol=SNR_RTOL,
                               atol=SNR_ATOL)
    np.testing.assert_array_equal(periods, setup["rplan"].all_periods)
    np.testing.assert_array_equal(foldbins, setup["rplan"].all_foldbins)


def test_every_stage_of_every_shard_runs_k2(setup, uint6):
    """One K2 call per stage per shard, through ``engine._launch`` with
    its shard and bins slice (what chip_smoke.py holds against plain)."""
    plan = setup["plan"]
    with engine.recording() as rec:
        sharded.run_periodogram_sharded(
            plan, setup["batch"], mesh=mesh.mesh_2d(["cpu"] * 4,
                                                    bins_shards=2))
    got = sorted((r["stage"], r["shard"], r["bins"])
                 for r in rec["launches"])
    want = sorted((s, (i, j), tuple(range(4 * j, 4 * j + 4)))
                  for s in range(len(plan.stages)) for i in range(2)
                  for j in range(2))
    assert got == want
    assert {r["kind"] for r in rec["launches"]} == {"cascade_stage"}
    assert all(r["out"].shape[:2] == (3, 4) for r in rec["launches"])


def test_search_sharded_matches_reference(setup, uint6):
    got, polycos = sharded.run_search_sharded(
        setup["plan"], setup["batch"], tobs=N * TSAMP, dms=DMS,
        mesh=mesh.Mesh(CPU8), mode="uint6", **PKW)
    _same_peaks(got, setup["ref_peaks"])
    assert len(polycos) == 5
    # the injected pulsar is recovered through the sharded path
    assert got[2] and abs(got[2][0].period - 0.1) < 1e-3


@pytest.mark.parametrize("mode", ["uint6", "float16"])
def test_search_sharded_equals_the_unsharded_batch(setup, monkeypatch, mode):
    """Sharding only routes the work: the peaks of a 2-shard run equal
    run_search_batch's on the same wire, S/N within the parity bar (K2's
    whole-stage container against the lane buckets on the quantised
    wire; the float16 wire takes the shards' float branch)."""
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", mode)
    plan = setup["plan"]
    want, _ = engine.run_search_batch(plan, setup["batch"], tobs=N * TSAMP,
                                      dms=DMS, device="cpu", **PKW)
    got, _ = sharded.run_search_sharded(plan, setup["batch"], tobs=N * TSAMP,
                                        dms=DMS, mesh=mesh.Mesh(["cpu"] * 2),
                                        mode=mode, **PKW)
    _same_peaks(got, want)
    assert got[2] and abs(got[2][0].period - 0.1) < 1e-3


def test_bad_bins_axis_raises_as_the_reference(setup, uint6):
    m = mesh.mesh_2d(["cpu"] * 6, bins_shards=3)  # 3 does not divide 8
    with pytest.raises(ValueError, match="does not divide"):
        sharded.run_periodogram_sharded(setup["plan"], setup["batch"], mesh=m)
    with pytest.raises(ValueError, match="does not divide"):
        ref_sharded.run_periodogram_sharded(
            setup["rplan"], setup["batch"],
            mesh=ref_mesh.mesh_2d(jax.devices()[:6], bins_shards=3))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.mesh_2d(["cpu"] * 5, bins_shards=2)


def test_mesh_shapes_follow_the_reference():
    m2 = mesh.mesh_2d(CPU8, bins_shards=2)
    r2 = ref_mesh.mesh_2d(jax.devices(), bins_shards=2)
    assert m2.shape == dict(r2.shape) and m2.axis_names == r2.axis_names
    assert m2.devices.shape == r2.devices.shape
    assert mesh.Mesh(CPU8).shape == dict(ref_mesh.default_mesh().shape)
    with pytest.raises(ValueError, match="one name per axis"):
        mesh.Mesh(CPU8, ("dm", "bins"))


def test_default_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        m = mesh.default_mesh()
        assert all(d.type == "cuda" for d in m.flat)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.mesh_2d(bins_shards=1)


def test_d_below_the_dm_axis_pads_as_the_reference(setup, uint6):
    """Two trials over 8 shards: six padded shards, the two real trials'
    S/N the JAX package's."""
    _, _, snrs = sharded.run_periodogram_sharded(
        setup["plan"], setup["batch"][:2], mesh=mesh.Mesh(CPU8))
    np.testing.assert_allclose(snrs, setup["ref_snrs"][:2], rtol=SNR_RTOL,
                               atol=SNR_ATOL)


def _pipeline_config():
    with open(os.path.join(HERE, "pipeline_config_A.yml")) as fobj:
        conf = yaml.safe_load(fobj)
    conf["ranges"][0]["ffa_search"].update(period_min=0.3, period_max=1.2,
                                           bins_min=64, bins_max=71)
    conf["ranges"][0]["candidates"].update(bins=64, subints=8)
    return conf


def test_pipeline_with_mesh(tmp_path, uint6):
    """Pipeline(config, mesh=...) gives the peaks of the unsharded
    pipeline on the same small trials (16 s at 1 ms, a 0.5 s pulsar),
    journaled too (the survey scheduler drives the mesh path): the same
    peaks.csv bytes."""
    from riptide_tpu_torch.pipeline.pipeline import Pipeline

    files = [generate_data_presto(str(tmp_path), f"s{i}_DM{dm:.2f}",
                                  tobs=16.0, tsamp=1e-3, period=0.5, dm=dm,
                                  amplitude=amp)
             for i, (dm, amp) in enumerate([(0.0, 20.0), (5.0, 12.0),
                                            (10.0, 8.0)])]
    conf = _pipeline_config()
    runs, csv = {}, {}
    two = mesh.Mesh(["cpu"] * 2)
    for name, m, journal in (("plain", None, None), ("mesh", two, None),
                             ("journaled", two, tmp_path / "journal")):
        pipe = Pipeline(conf, mesh=m, device="cpu", journal=journal)
        assert pipe.mesh is m
        out = tmp_path / name
        out.mkdir()
        pipe.process([str(f) for f in files], str(out))
        runs[name] = pipe
        csv[name] = (out / "peaks.csv").read_bytes()
    assert csv["mesh"] == csv["plain"] == csv["journaled"]
    key = [(p.dm, p.ip, p.iw) for p in runs["plain"].peaks]
    assert key and key == [(p.dm, p.ip, p.iw) for p in runs["mesh"].peaks]
    np.testing.assert_allclose([p.snr for p in runs["mesh"].peaks],
                               [p.snr for p in runs["plain"].peaks],
                               rtol=SNR_RTOL)
    best = runs["mesh"].candidates[0]
    assert abs(best.params["period"] - 0.5) < 1e-3
