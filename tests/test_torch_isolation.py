"""
The PyTorch port stands alone: it imports neither jax nor anything of
the JAX package, and its entry points run on the card unless the caller
asks for the CPU.
"""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import riptide_tpu_torch
from riptide_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "riptide_tpu_torch")
# `import jax...`, `from jax...`, `import riptide_tpu...`,
# `from riptide_tpu...` or the JAX package's `tools` — but not the
# port's own `riptide_tpu_torch`.
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|riptide_tpu|tools)(?![\w])", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        riptide_tpu_torch.__path__, "riptide_tpu_torch."))


def test_every_module_imports_without_jax():
    """Import every module of the package in a fresh interpreter where
    ``import jax`` fails; no ``riptide_tpu`` module may get loaded."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'riptide_tpu'\n"
        "             or m.startswith('riptide_tpu.')\n"
        "             or m.split('.')[0] in ('jax', 'jaxlib')\n"
        "             and sys.modules[m] is not None)\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_public_names_import_without_jax():
    """The reference's public names that the port re-exports, imported in
    a fresh interpreter where ``import jax`` fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "from riptide_tpu_torch import (downsample, fast_running_median,\n"
        "                               find_peaks, running_median, test)\n"
        "from riptide_tpu_torch.obs import Tracer, build_report, span\n"
        "from riptide_tpu_torch.survey import SurveyScheduler, get_metrics\n"
        "from riptide_tpu_torch.obs import trace\n"
        "from riptide_tpu_torch.survey import metrics, scheduler\n"
        "assert span is trace.span and get_metrics is metrics.get_metrics\n"
        "assert SurveyScheduler is scheduler.SurveyScheduler\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'riptide_tpu'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax_or_reference():
    files = [os.path.join(REPO, n) for n in
             ("chip_smoke.py", "stage_times.py", "loader_streams.py",
              "loader_threads.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as fobj:
            src = fobj.read()
        offenders += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                      for m in _FORBIDDEN.finditer(src)]
    assert offenders == []


def test_survey_modules_are_covered():
    """The survey path's modules are among those imported above."""
    mods = _modules()
    for name in ("search.peaks_device", "peak_detection", "clustering",
                 "utils.envflags", "ops.slottables", "utils.cuda_build",
                 "utils.measure", "probes.common", "probes.ptime", "probes.ptime2",
                 "probes.probe1536", "utils.runctx", "utils.fsio",
                 "survey.metrics", "survey.incidents", "survey.journal",
                 "survey.faults", "survey.liveness", "survey.integrity",
                 "survey.scheduler", "obs.trace", "obs.schema", "obs.chrome",
                 "obs.prom", "obs.alerts", "obs.fleet", "obs.ledger",
                 "obs.report", "utils.exec_cache", "survey.chaos",
                 "apps.rreport", "apps.rtop", "apps.rwatch", "apps.rchaos",
                 "serve", "serve.tenants", "serve.queue", "serve.daemon",
                 "apps.rserve", "apps.rseek", "parallel", "parallel.mesh",
                 "parallel.sharded", "parallel.seqffa",
                 "parallel.distributed", "parallel.multihost", "analysis",
                 "analysis.launch_contract", "analysis.sched",
                 "analysis.sarif", "apps.rprove", "apps.ripsched",
                 "analysis.lint", "analysis.lint.core",
                 "analysis.lint.host_sync", "analysis.lint.dtype_discipline",
                 "analysis.lint.env_flags", "analysis.lint.lock_discipline",
                 "analysis.lint.launch_layout",
                 "analysis.lint.finite_guards",
                 "analysis.lint.liveness_guards",
                 "analysis.lint.obs_discipline", "analysis.lint.lock_order",
                 "analysis.lint.record_schema",
                 "analysis.lint.interp_host_sync",
                 "analysis.lint.runctx_discipline",
                 "analysis.lint.fsio_discipline",
                 "analysis.lint.gate_pairing", "apps.riplint",
                 "apps.analyze", "bench", "apps.stime", "apps.etime",
                 "apps.warmtest"):
        assert f"riptide_tpu_torch.{name}" in mods


@pytest.mark.parametrize("app,blocked,args", [
    ("rreport", ("torch", "numpy", "jax", "jaxlib"), ["--help"]),
    ("rtop", ("torch", "numpy", "jax", "jaxlib"), ["--help"]),
    ("rwatch", ("torch", "numpy", "jax", "jaxlib"), ["--help"]),
    ("rchaos", ("jax", "jaxlib"), ["--list"]),
    ("rserve", ("jax", "jaxlib"), ["--help"]),
    ("riplint", ("torch", "numpy", "jax", "jaxlib"), ["--list-rules"]),
    ("analyze", ("torch", "numpy", "jax", "jaxlib"), ["--help"]),
])
def test_apps_run_by_path(app, blocked, args, tmp_path):
    """The apps run by path from any directory; the readers with neither
    torch nor numpy importable (a login node holding only the journal),
    and none of them imports jax or the JAX package."""
    script = os.path.join(PKG, "apps", f"{app}.py")
    code = ("import runpy, sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = [{script!r}] + {args!r}\n"
            "try:\n"
            f"    runpy.run_path({script!r}, run_name='__main__')\n"
            "finally:\n"
            "    print(sorted(m for m in sys.modules\n"
            "                 if m.split('.')[0] == 'riptide_tpu'))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert ("usage:" in out.stdout) == (args == ["--help"])


def test_kernel_source_ships_with_the_package():
    """Both CUDA sources sit in the package's csrc/, build for sm_90a, and
    the packaging lists the probes and ships csrc/*.cu."""
    import tomllib

    from riptide_tpu_torch.ops import ffa_kernel
    from riptide_tpu_torch.probes import common

    assert ffa_kernel.SOURCE.is_file()
    assert "sm_90a" in " ".join(ffa_kernel.NVCC_FLAGS)
    assert common.SOURCE.is_file() and common.SOURCE.parent == ffa_kernel.SOURCE.parent
    assert "sm_90a" in " ".join(common.LIB.flags)
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fobj:
        tool = tomllib.load(fobj)["tool"]["setuptools"]
    assert "riptide_tpu_torch.probes" in tool["packages"]
    assert "riptide_tpu_torch.serve" in tool["packages"]
    assert "riptide_tpu_torch.parallel" in tool["packages"]
    assert "csrc/*.cu" in tool["package-data"]["riptide_tpu_torch"]


def test_entry_points_default_to_the_card(tmp_path):
    """``device=None`` means CUDA. Without a usable card every entry point
    raises instead of carrying on quietly on the CPU."""
    from riptide_tpu_torch import (TimeSeries, fast_running_median,
                                   ffa_search, running_median)
    from riptide_tpu_torch import bench
    from riptide_tpu_torch.libffa import benchmark_ffa2
    from riptide_tpu_torch.apps import etime, rserve, stime, warmtest
    from riptide_tpu_torch.serve import ServeDaemon
    from riptide_tpu_torch.probes import probe1536, ptime, ptime2
    from riptide_tpu_torch.survey import integrity
    from riptide_tpu_torch.search.engine import (device_fingerprint,
                                                 warm_stage_kernels)
    from riptide_tpu_torch.search import (periodogram_plan, queue_search_batch,
                                          run_periodogram,
                                          run_periodogram_batch,
                                          run_search_batch)

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    plan = periodogram_plan(2500, 1e-3, (1, 2, 3), 64e-3, 0.072, 64, 67)
    data = np.zeros(plan.size, np.float32)
    ts = TimeSeries.generate(length=2.5, tsamp=1e-3, period=0.07)
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: run_periodogram(plan, data),
        lambda: run_periodogram_batch(plan, data[None]),
        lambda: run_search_batch(plan, data[None], 2.5),
        lambda: queue_search_batch(plan, data[None], 2.5),
        lambda: ffa_search(ts, period_min=64e-3, period_max=0.072,
                           bins_min=64, bins_max=67),
        lambda: running_median(data, 11),
        lambda: fast_running_median(data, 101),
        lambda: benchmark_ffa2(64, 32),
        lambda: device_fingerprint(),
        lambda: ptime.main([]),
        lambda: ptime2.main([]),
        lambda: probe1536.main([]),
        lambda: integrity.compute_canary_digest(),
        lambda: integrity.main([]),
        lambda: ServeDaemon(str(tmp_path / "serve")),
        lambda: rserve.main(["--root", str(tmp_path / "serve")]),
        lambda: warm_stage_kernels(plan, 1),
        lambda: bench.main([]),
        lambda: bench.main(["--config", "5"]),
        lambda: bench.bench_headline(),
        lambda: stime.main([]),
        lambda: etime.main([]),
        lambda: warmtest.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
