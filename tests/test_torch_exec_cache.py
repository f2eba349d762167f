"""
The port's build cache (``riptide_tpu_torch/utils/exec_cache.py``) on
the CPU, with g++ only: a store then a load; a flipped last byte of the
stored library detected in a fresh process (the ``cache_corrupt``
incident, one eviction, a rebuild, then a clean load of the same
bytes); a missing digest treated as corrupt; the LRU byte cap; the
trust check of a cache directory against the JAX package's; the key
following the compiler's version; four processes racing on one key;
and no module of the port importing ``pickle``.
"""
import ctypes
import json
import os
import re
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from riptide_tpu.utils import exec_cache as ref_cache
from riptide_tpu_torch.survey import chaos, incidents
from riptide_tpu_torch.survey.metrics import get_metrics
from riptide_tpu_torch.utils import exec_cache, fsio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "riptide_tpu_torch")
SOURCE = Path(PKG) / "survey" / "chaos_probe.cpp"
GXX = ("g++", "-dumpfullversion")


def _compile(out):
    proc = subprocess.run(["g++", *chaos.PROBE_FLAGS, str(SOURCE), "-o", out],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return proc.stdout + proc.stderr


def _obtain(d, load=True, info=None):
    return exec_cache.obtain(SOURCE, chaos.PROBE_FLAGS, GXX, _compile,
                             load=load, directory=d, info=info)


def _call(lib):
    fn = lib.chaos_probe
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    x = np.arange(5.0)
    y = np.empty_like(x)
    fn(x.ctypes.data, y.ctypes.data, x.size)
    return y


@pytest.fixture(autouse=True)
def _clean_globals():
    def clear():
        incidents.set_sink(None)
        fsio.set_storage_faults(None)
    clear()
    yield
    clear()


def test_store_then_load(tmp_path):
    first, second, third = {}, {}, {}
    lib = _obtain(tmp_path, info=first)
    assert first["action"] == "compiled" and first["seconds"] > 0
    np.testing.assert_array_equal(_call(lib), np.arange(5.0) * 2 + 1)
    path = Path(first["path"])
    assert path.parent == tmp_path and path.name.startswith("libchaos_probe_")
    digest = (tmp_path / (path.name + ".sha256")).read_text().strip()
    assert digest == exec_cache.file_digest(path) == first["digest"]
    assert not list(tmp_path.glob("*.build"))        # the compiler's file
    np.testing.assert_array_equal(_call(_obtain(tmp_path, info=second)),
                                  np.arange(5.0) * 2 + 1)
    assert second["action"] == "loaded" and second["seconds"] == 0.0
    assert _obtain(tmp_path, load=False, info=third) == path
    assert third["action"] == "cached"
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert list(manifest) == [path.name]


_LEG = """
import json, sys
from riptide_tpu_torch.survey import incidents
from riptide_tpu_torch.survey.faults import FaultPlan
from riptide_tpu_torch.survey.metrics import get_metrics
from riptide_tpu_torch.utils import fsio
sys.path.insert(0, {tests!r})
from test_torch_exec_cache import _call, _obtain
seen = []
incidents.set_sink(seen.append)
fsio.set_storage_faults(FaultPlan.parse({spec!r}).storage_op)
info = {{}}
out = _call(_obtain({d!r}, info=info)).tolist()
print(json.dumps({{"action": info["action"], "out": out,
                  "digest": info["digest"],
                  "evictions": get_metrics().counter("cache_evictions"),
                  "incidents": [r["incident"] for r in seen],
                  "detail": [r.get("detail") for r in seen]}}))
"""


def _leg(d, spec=""):
    """One fresh process that obtains and loads the probe library from
    ``d`` under the fault spec; its report."""
    code = _LEG.format(tests=os.path.join(REPO, "tests"), spec=spec, d=str(d))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_flipped_byte_is_detected_evicted_and_rebuilt(tmp_path):
    want = (np.arange(5.0) * 2 + 1).tolist()
    first = _leg(tmp_path, "cache_corrupt:exec_cache_store:1")
    assert first["action"] == "compiled" and first["out"] == want
    assert first["incidents"] == [] and first["evictions"] == 0
    (lib,) = tmp_path.glob("*.so")
    # The stored bytes are not the ones compiled: the last byte flipped.
    assert exec_cache.file_digest(lib) != first["digest"]
    second = _leg(tmp_path)
    assert second["action"] == "compiled" and second["out"] == want
    assert second["incidents"] == ["cache_corrupt"]
    assert second["evictions"] == 1
    detail = second["detail"][0]
    assert detail["path"] == str(lib) and "digest mismatch" in \
        detail["reason"] and detail["name"] == "chaos_probe.cpp"
    third = _leg(tmp_path)
    assert third["action"] == "loaded" and third["out"] == want
    assert third["incidents"] == [] and third["evictions"] == 0
    assert third["digest"] == second["digest"] == exec_cache.file_digest(lib)


@pytest.mark.parametrize("damage", ["missing", "garbled", "empty_library"])
def test_missing_or_bad_digest_is_corrupt(tmp_path, damage):
    """Never loaded in this process before the damage, so the check, not
    ctypes' handle cache, decides."""
    info = {}
    _obtain(tmp_path, load=False, info=info)
    path = Path(info["path"])
    if damage == "missing":
        os.remove(str(path) + ".sha256")
    elif damage == "garbled":
        Path(str(path) + ".sha256").write_text("not a digest\n")
    else:
        path.write_bytes(b"")
    seen = []
    incidents.set_sink(seen.append)
    get_metrics().reset()
    again = {}
    lib = _obtain(tmp_path, info=again)
    assert again["action"] == "compiled"
    assert [r["incident"] for r in seen] == ["cache_corrupt"]
    assert get_metrics().counter("cache_evictions") == 1
    reason = seen[0]["detail"]["reason"]
    assert ("missing digest" in reason) == (damage == "missing")
    np.testing.assert_array_equal(_call(lib), np.arange(5.0) * 2 + 1)
    assert exec_cache.file_digest(path) == again["digest"]


def _put(d, name, nbytes, last_used=None):
    path = d / name
    path.write_bytes(b"\0" * nbytes)
    Path(str(path) + ".sha256").write_text(
        exec_cache.file_digest(path) + "\n")
    if last_used is not None:
        os.utime(path, (last_used, last_used))
    return path


def test_lru_cap_evicts_the_oldest(tmp_path, monkeypatch):
    monkeypatch.setenv("RIPTIDE_EXEC_CACHE_MAX_BYTES", "2500")
    old = _put(tmp_path, "libold_0.so", 1000, last_used=1000.0)
    mid = _put(tmp_path, "libmid_0.so", 1000, last_used=2000.0)
    exec_cache._lru_note(mid, inserted=False)          # a load refreshes it
    new = _put(tmp_path, "libnew_0.so", 1000)
    exec_cache._lru_note(new, inserted=True)
    assert not old.exists() and not Path(str(old) + ".sha256").exists()
    assert mid.exists() and new.exists()
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert sorted(manifest) == ["libmid_0.so", "libnew_0.so"]
    # The newest library is never evicted, even alone over the cap.
    monkeypatch.setenv("RIPTIDE_EXEC_CACHE_MAX_BYTES", "10")
    big = _put(tmp_path, "libbig_0.so", 4000)
    exec_cache._lru_note(big, inserted=True)
    assert big.exists() and not mid.exists() and not new.exists()
    # A library whose key lock another holder has is not evicted: the
    # next oldest goes instead.
    monkeypatch.setenv("RIPTIDE_EXEC_CACHE_MAX_BYTES", "4500")
    younger = _put(tmp_path, "libyounger_0.so", 1000)
    exec_cache._lru_note(younger, inserted=False)
    with exec_cache._flock(str(big) + ".lock"):
        newest = _put(tmp_path, "libnewest_0.so", 1000)
        exec_cache._lru_note(newest, inserted=True)
    assert big.exists() and not younger.exists() and newest.exists()


def _trust_cases(tmp_path):
    base = tmp_path / "cases"
    base.mkdir()
    own = base / "own"
    own.mkdir(mode=0o700)
    group = base / "group"
    group.mkdir()
    os.chmod(group, 0o770)
    link = base / "link"
    os.symlink(own, link)
    plain_file = base / "file"
    plain_file.write_text("")
    sticky_parent = tmp_path / "sticky"
    sticky_parent.mkdir()
    os.chmod(sticky_parent, 0o1777)
    in_sticky = sticky_parent / "c"
    in_sticky.mkdir(mode=0o700)
    open_parent = tmp_path / "open"
    open_parent.mkdir()
    os.chmod(open_parent, 0o777)
    in_open = open_parent / "c"
    in_open.mkdir(mode=0o700)
    return {"own": (own, True), "group": (group, False),
            "symlink": (link, False), "file": (plain_file, False),
            "missing": (base / "nope", False),
            "sticky world-writable parent": (in_sticky, True),
            "world-writable parent": (in_open, False)}


def test_dir_trusted_gives_the_reference_verdicts(tmp_path):
    for name, (path, want) in _trust_cases(tmp_path).items():
        assert exec_cache._dir_trusted(str(path)) == \
            ref_cache._dir_trusted(str(path)) == want, name


def test_cache_root_precedence(tmp_path, monkeypatch):
    monkeypatch.setenv("RIPTIDE_CACHE_ROOT", str(tmp_path / "explicit"))
    assert exec_cache.cache_root() == str(tmp_path / "explicit")
    assert exec_cache.cache_dir() == tmp_path / "explicit" / "torch_build"
    monkeypatch.setenv("RIPTIDE_EXEC_CACHE", str(tmp_path / "lib"))
    assert exec_cache.cache_dir() == tmp_path / "lib"
    monkeypatch.delenv("RIPTIDE_EXEC_CACHE")
    monkeypatch.delenv("RIPTIDE_CACHE_ROOT")
    checkout = tmp_path / "checkout"
    checkout.mkdir(mode=0o755)
    assert exec_cache.cache_root(checkout) == str(checkout / ".riptide_cache")
    (checkout / ".riptide_cache").mkdir()
    os.chmod(checkout / ".riptide_cache", 0o777)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    fallback = exec_cache.cache_root(checkout)
    assert fallback == str(tmp_path / "tmp" /
                           f"riptide_tpu_torch_cache_{os.getuid()}")
    assert os.path.basename(fallback) != os.path.basename(
        ref_cache._user_tmp_cache())
    assert stat.S_IMODE(os.stat(fallback).st_mode) == 0o700


def test_key_follows_the_compiler_version(tmp_path, monkeypatch):
    paths = {}
    for version in ("g++ 12.2.0", "g++ 13.1.0", "g++ 12.2.0"):
        monkeypatch.setitem(exec_cache._versions, GXX, version)
        info = {}
        paths.setdefault(version, []).append(
            _obtain(tmp_path, load=False, info=info))
        paths[version].append(info["action"])
    assert paths["g++ 12.2.0"][0] == paths["g++ 12.2.0"][2]
    assert paths["g++ 12.2.0"][1:4:2] == ["compiled", "cached"]
    assert paths["g++ 13.1.0"][0] != paths["g++ 12.2.0"][0]
    assert len(list(tmp_path.glob("*.so"))) == 2
    a = exec_cache.library_key(b"src", ("-O2",), "nvcc 12.8")
    assert a != exec_cache.library_key(b"src", ("-O2",), "nvcc 12.9")
    assert a != exec_cache.library_key(b"src", ("-O3",), "nvcc 12.8")
    assert a != exec_cache.library_key(b"src2", ("-O2",), "nvcc 12.8")


_RACER = """
import json, sys, time
from riptide_tpu_torch.survey import incidents
sys.path.insert(0, {tests!r})
from test_torch_exec_cache import _call, _obtain
seen = []
incidents.set_sink(seen.append)
while time.time() < {start!r}:
    time.sleep(0.005)
info = {{}}
out = _call(_obtain({d!r}, info=info)).tolist()
print(json.dumps({{"action": info["action"], "digest": info["digest"],
                  "incidents": len(seen), "out": out}}))
"""


def test_four_racing_processes_build_once(tmp_path):
    import time

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _RACER.format(tests=os.path.join(REPO, "tests"), d=str(tmp_path),
                         start=time.time() + 6.0)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(o["action"] for o in outs) == \
        ["compiled", "loaded", "loaded", "loaded"]
    assert {o["digest"] for o in outs} == {
        exec_cache.file_digest(p) for p in tmp_path.glob("*.so")}
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert all(o["incidents"] == 0 for o in outs)
    assert all(o["out"] == (np.arange(5.0) * 2 + 1).tolist() for o in outs)


def test_the_libraries_build_through_the_cache(tmp_path, monkeypatch):
    """The native runtime builds into the cache directory, never into
    the package."""
    from riptide_tpu_torch import native

    monkeypatch.setenv("RIPTIDE_EXEC_CACHE", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_INFO", {})
    path = native.build()
    assert path.parent == tmp_path and path.name.startswith(
        "libriptide_native_")
    assert native.BUILD_INFO["action"] == "compiled"
    assert exec_cache.file_digest(path) == \
        (tmp_path / (path.name + ".sha256")).read_text().strip()
    assert native.build() == path and native.BUILD_INFO["action"] == "cached"


_PICKLE = re.compile(r"^\s*(?:import|from)\s+(?:c?[pP]ickle|dill|shelve)\b",
                     re.M)


def test_no_module_of_the_port_imports_pickle():
    offenders = []
    for dirpath, _, names in os.walk(PKG):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as fobj:
                    if _PICKLE.search(fobj.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
