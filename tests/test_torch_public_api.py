"""
The public names the port gained to match the reference's surface
(``tests/test_torch_api_parity.py`` checks that they exist), each held to
the JAX package's function on the CPU where that one runs there: the
top-level re-exports, ``benchmark_ffa2``, ``batch_plans``,
``device_fingerprint``, ``envflags.get(env=)``, the finite- and
liveness-guard shims, and ``riptide_tpu_torch.test()``'s pytest
arguments with jax importable and without it.
"""
import importlib.util
import os

import numpy as np
import pytest

import riptide_tpu
import riptide_tpu_torch
from riptide_tpu.analysis import finite_guards as ref_fg
from riptide_tpu.analysis import liveness_guards as ref_lg
from riptide_tpu.ops import plan as ref_plan
from riptide_tpu.search import engine as ref_engine
from riptide_tpu.utils import envflags as ref_envflags
from riptide_tpu_torch import libffa, peak_detection, running_medians
from riptide_tpu_torch.analysis.lint import finite_guards, liveness_guards
from riptide_tpu_torch.ops import plan
from riptide_tpu_torch.search import engine
from riptide_tpu_torch.utils import envflags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def series():
    return np.random.default_rng(7).standard_normal(4000).astype(np.float32)


def test_top_level_names_are_the_submodules_functions():
    assert riptide_tpu_torch.downsample is libffa.downsample
    assert riptide_tpu_torch.running_median is running_medians.running_median
    assert riptide_tpu_torch.fast_running_median is \
        running_medians.fast_running_median
    assert riptide_tpu_torch.find_peaks is peak_detection.find_peaks
    for name in ("downsample", "running_median", "fast_running_median",
                 "find_peaks"):
        assert name in riptide_tpu_torch.__all__


def test_top_level_running_medians_and_downsample_match_the_reference(series):
    np.testing.assert_array_equal(
        riptide_tpu_torch.running_median(series, 11, device="cpu"),
        np.asarray(riptide_tpu.running_median(series, 11)))
    np.testing.assert_array_equal(
        riptide_tpu_torch.fast_running_median(series, 1001, device="cpu"),
        np.asarray(riptide_tpu.fast_running_median(series, 1001)))
    np.testing.assert_array_equal(riptide_tpu_torch.downsample(series, 3.7),
                                  riptide_tpu.downsample(series, 3.7))


def test_top_level_find_peaks_matches_the_reference():
    np.random.seed(3)
    ts = riptide_tpu_torch.TimeSeries.generate(length=20.0, tsamp=1e-3,
                                               period=0.5, amplitude=20.0)
    _, pgram = riptide_tpu_torch.ffa_search(
        ts, period_min=0.3, period_max=1.2, bins_min=64, bins_max=71,
        device="cpu")
    got, got_poly = riptide_tpu_torch.find_peaks(pgram)
    ref = riptide_tpu.Periodogram(pgram.widths, pgram.periods,
                                  pgram.foldbins, pgram.snrs, pgram.metadata)
    want, want_poly = riptide_tpu.find_peaks(ref)
    assert got and [p.summary_dict() for p in got] == \
        [p.summary_dict() for p in want]
    assert sorted(got_poly) == sorted(want_poly)
    for k in want_poly:
        np.testing.assert_array_equal(got_poly[k], want_poly[k])


def test_benchmark_ffa2_times_the_transform():
    best = libffa.benchmark_ffa2(64, 32, loops=3, device="cpu")
    assert np.isfinite(best) and 0.0 < best < 10.0
    assert libffa.benchmark_ffa2(8, 4, loops=0, device="cpu") == float("inf")


@pytest.mark.parametrize("R,P", [(None, None), (40, 64)])
def test_batch_plans_matches_the_reference(R, P):
    ms, ps = [5, 17, 32, 3], [7, 20, 13, 9]
    got = plan.batch_plans(ms, ps, R=R, P=P)
    want = ref_plan.batch_plans(ms, ps, R=R, P=P)
    assert isinstance(got, plan.FFABatchPlan)
    assert (got.L, got.R, got.P) == (want.L, want.R, want.P)
    for name in ("h", "t", "shift", "m", "p"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))


def test_device_fingerprint_has_the_reference_keys():
    got = engine.device_fingerprint("cpu")
    want = ref_engine.device_fingerprint()
    assert sorted(got) == sorted(want)
    assert got == {"backend": "cpu", "device_kind": "cpu",
                   "device_count": 1, "process_count": 1}
    assert got["backend"] == want["backend"]
    assert got["process_count"] == want["process_count"]


def _sample(flag):
    if flag.type == "bool":
        return "0"
    if flag.type == "int":
        return "3"
    if flag.type == "float":
        return "2.5"
    if flag.type == "str":
        return "x"
    return flag.choices[-1]


def test_envflags_get_reads_a_given_mapping(monkeypatch):
    """``get(name, env)`` reads ``env`` and not the environment, and
    parses every flag of the port as the JAX package's ``get`` does."""
    monkeypatch.setenv("RIPTIDE_WIRE_DTYPE", "float32")
    assert envflags.get("RIPTIDE_WIRE_DTYPE") == "float32"
    assert envflags.get("RIPTIDE_WIRE_DTYPE", {}) == \
        envflags.FLAGS["RIPTIDE_WIRE_DTYPE"].default
    for name, flag in envflags.FLAGS.items():
        env = {name: _sample(flag)}
        assert envflags.get(name, env) == ref_envflags.get(name, env), name
        assert envflags.get(name, {}) == ref_envflags.get(name, {}), name
    with pytest.raises(ValueError):
        envflags.get("RIPTIDE_WIRE_DTYPE", {"RIPTIDE_WIRE_DTYPE": "int4"})


@pytest.mark.parametrize("name", ["RIPTIDE_BENCH_BUDGET",
                                  "RIPTIDE_BENCH_DEBUG"])
def test_bench_flags_have_the_reference_type_and_default(name):
    """The bench's two flags, registered with the JAX registry's type and
    default (the port reads ``RIPTIDE_BENCH_DEBUG`` through the registry,
    where the JAX bench reads it raw)."""
    got, want = envflags.FLAGS[name], ref_envflags.FLAGS[name]
    assert (got.type, got.default) == (want.type, want.default)
    assert envflags.get(name, {}) == ref_envflags.get(name, {})
    assert envflags.get(name, {name: "2.5"}) == \
        ref_envflags.get(name, {name: "2.5"})


def test_finite_guard_shims_report_as_the_reference(tmp_path):
    assert finite_guards.check(REPO) == [] == ref_fg.check(REPO)
    bad = tmp_path / "bad_snr.py"
    bad.write_text(
        "from .. import quality\n"
        "def helper(x):\n"
        "    return quality.check_finite_array(x)\n"
        "def guarded(x):\n"
        "    return helper(x)\n"
        "def unguarded(x):\n"
        "    return x.sum()\n")
    for required in (["guarded", "unguarded"], ["guarded"], ["missing"]):
        got = finite_guards.check_module(str(bad), required)
        want = ref_fg.check_module(str(bad), required)
        assert [v.split(": ", 1)[0] for v in got] == \
            [v.split(": ", 1)[0] for v in want]
    assert "'unguarded'" in finite_guards.check_module(
        str(bad), ["unguarded"])[0]


def test_liveness_guard_shims_report_as_the_reference(tmp_path):
    assert liveness_guards.check(REPO) == [] == ref_lg.check(REPO)
    port_bad = tmp_path / "port_bad.py"
    port_bad.write_text("import torch.distributed as dist\n"
                        "def gather(x):\n"
                        "    return dist.all_gather(x)\n")
    ref_bad = tmp_path / "ref_bad.py"
    ref_bad.write_text("from jax.experimental import multihost_utils\n"
                       "def gather(x):\n"
                       "    return multihost_utils.process_allgather(x)\n")
    got, gw = liveness_guards.check_file(str(port_bad), "m.py",
                                         liveness_guards.ALLOWED)
    want, ww = ref_lg.check_file(str(ref_bad), "m.py", ref_lg.ALLOWED)
    assert (len(got), gw) == (len(want), ww) == (1, 0)
    assert got[0].startswith("m.py:3: ") and want[0].startswith("m.py:3: ")
    (tmp_path / "riptide_tpu_torch").mkdir()
    assert liveness_guards.check(str(tmp_path)) == \
        [liveness_guards.VACUOUS_MESSAGE]


@pytest.mark.parametrize("have_jax,have_card", [(True, False), (False, False),
                                                (True, True)])
def test_test_runs_the_port_suite_by_path(monkeypatch, have_jax, have_card):
    """``riptide_tpu_torch.test()`` hands pytest the port's test files,
    found by path: every ``test_torch_*.py`` on a CPU host with jax; only
    the card's files, with ``--noconftest`` (the suite's conftest imports
    jax), without jax or beside a card."""
    import pytest as pytest_module
    import torch

    calls = []
    monkeypatch.setattr(pytest_module, "main",
                        lambda args: calls.append(list(args)) or 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: have_card)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "jax"
                        and not have_jax else real(name, *a))
    assert riptide_tpu_torch.test() == 0
    (args,) = calls
    files = [a for a in args if a.endswith(".py")]
    names = sorted(os.path.basename(f) for f in files)
    assert all(os.path.dirname(f) == os.path.join(REPO, "tests")
               for f in files)
    cuda = sorted(f for f in os.listdir(os.path.join(REPO, "tests"))
                  if f.startswith("test_torch_") and f.endswith("_cuda.py"))
    if have_jax and not have_card:
        assert "--noconftest" not in args
        assert set(cuda) < set(names)
        assert "test_torch_api_parity.py" in names
        assert all(n.startswith("test_torch_") for n in names)
    else:
        assert "--noconftest" in args
        assert names == cuda and len(cuda) == 4
