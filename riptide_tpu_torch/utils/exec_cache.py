"""
The port's cache of built libraries: the counterpart of the JAX
package's ``utils/exec_cache.py``, with a shared library built by
``nvcc`` or ``g++`` in place of a pickled XLA executable.

* **Where.** :func:`cache_dir`: ``RIPTIDE_EXEC_CACHE``, else
  ``<cache_root()>/torch_build``. :func:`cache_root` has the JAX
  package's precedence: ``RIPTIDE_CACHE_ROOT``; a trusted
  ``.riptide_cache`` at the checkout root; a per-user 0700 tempdir
  (named apart from the JAX package's). A library is code run at load,
  so a pre-existing ``.riptide_cache`` is used only when
  :func:`_dir_trusted` passes it: a shared checkout's cache another
  user could write into is never loaded from.
* **The key** hashes the source, the flags and the compiler's own
  version text (``nvcc --version``, ``g++ -dumpfullversion``): a library
  built by one toolkit is never loaded under another.
* **Storing.** The compiler writes a private temporary file in the
  cache directory; its bytes are placed with
  ``fsio.atomic_write_bytes(..., site="exec_cache_store")`` (the storage
  fault hooks see the store) and their SHA-256 digest beside them
  (``lib<name>_<key>.so.sha256``), also atomically. The process that
  compiled loads its own compiler output, whose bytes the digest was
  taken from.
* **Loading.** The stored library's digest is checked before
  ``ctypes.CDLL``: a corrupted library often loads, so its load is never
  the check. A mismatch, a missing digest or an unreadable file is
  evicted as the JAX package's ``_evict_corrupt`` does (logged, removed
  with its digest, counted as ``cache_evictions``, a ``cache_corrupt``
  incident) and the library is rebuilt. The digest guards against
  corruption, not against a writer who could also rewrite it: that is
  the directory check's job. ``ctypes`` hands back the handle already
  loaded from a path, so a process checks a library before its first
  load, and recovery is checked in fresh processes.
* **Concurrency.** Verify-and-load and build-and-store of one key run
  under one ``fcntl.flock`` on ``<library>.lock``: test workers or
  parallel builds never see one build's library beside another's
  digest, nor evict each other's good library.
* **Size cap.** An LRU manifest over the ``.so`` entries and a byte cap
  (``RIPTIDE_EXEC_CACHE_MAX_BYTES``, 2 GiB), as the JAX package's.

Nothing here pickles: the JAX package's ``cached_jit`` wraps ``jax.jit``
programs, which the port does not have, so it has no counterpart.
"""
import contextlib
import ctypes
import fcntl
import hashlib
import json
import logging
import os
import stat
import subprocess
import tempfile
import time
from pathlib import Path

from . import envflags, fsio

log = logging.getLogger("riptide_tpu_torch.utils.exec_cache")

__all__ = ["cache_root", "cache_dir", "compiler_version", "library_key",
           "obtain", "file_digest", "DIGEST_SUFFIX"]

# The checkout holding this package.
_CHECKOUT = Path(__file__).resolve().parents[2]
DIGEST_SUFFIX = ".sha256"
_MANIFEST = "manifest.json"


# -------------------------------------------------------------- where

def _dir_trusted(path):
    """Whether a pre-existing cache directory is safe to load libraries
    from: a real directory (not a symlink), owned by us, with no
    group/other write bits, whose parent cannot be used to replace the
    directory wholesale — i.e. the parent is not world-writable, unless
    it has the sticky bit set (/tmp's 1777: others can neither delete
    nor rename our entry there)."""
    try:
        st = os.lstat(path)
        parent_st = os.lstat(os.path.dirname(path) or ".")
    except OSError:
        return False
    if not stat.S_ISDIR(st.st_mode):
        return False
    if st.st_uid != os.getuid():
        return False
    if st.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
        return False
    if (parent_st.st_mode & stat.S_IWOTH
            and not parent_st.st_mode & stat.S_ISVTX):
        return False
    return True


def _user_tmp_cache():
    """Per-user 0700 tempdir fallback (the directory must not be
    writable — or squattable — by other users). If the canonical
    per-uid name was squatted by someone else, use a fresh ``mkdtemp``
    instead (safe, at the price of a cold cache for this process)."""
    path = os.path.join(tempfile.gettempdir(),
                        f"riptide_tpu_torch_cache_{os.getuid()}")
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
    except OSError as err:
        log.warning("could not create tempdir cache %r (%s)", path, err)
    if _dir_trusted(path):
        return path
    try:
        fallback = tempfile.mkdtemp(prefix="riptide_tpu_torch_cache_")
        log.warning(
            "tempdir cache %r failed the ownership/permission check "
            "(squatted or over-permissioned); using fresh %r instead",
            path, fallback,
        )
        return fallback
    except OSError as err:
        log.warning("could not create fallback cache dir (%s)", err)
        return path


def cache_root(checkout_dir=None):
    """Root directory of the on-disk caches: ``RIPTIDE_CACHE_ROOT`` (used
    as given); a ``.riptide_cache`` directory at the checkout root (it
    survives into every later process run from the same checkout) when
    it passes :func:`_dir_trusted`, or when it does not exist yet and the
    checkout is ours to write; else a per-user 0700 tempdir."""
    env = envflags.get("RIPTIDE_CACHE_ROOT")
    if env:
        return env
    repo = str(checkout_dir or _CHECKOUT)
    cand = os.path.join(repo, ".riptide_cache")
    if os.path.lexists(cand):
        if _dir_trusted(cand):
            return cand
        log.warning(
            "%r exists but is not a directory owned by uid %d with "
            "group/other write bits clear (or its parent is "
            "world-writable); falling back to the per-user tempdir cache",
            cand, os.getuid(),
        )
        return _user_tmp_cache()
    try:
        repo_st = os.lstat(repo)
    except OSError:
        return _user_tmp_cache()
    if os.access(repo, os.W_OK) and not (repo_st.st_mode & stat.S_IWOTH):
        return cand
    return _user_tmp_cache()


def cache_dir():
    """The directory of the built libraries, read from the environment
    now: ``RIPTIDE_EXEC_CACHE``, else ``<cache_root()>/torch_build``."""
    return Path(envflags.get("RIPTIDE_EXEC_CACHE")
                or os.path.join(cache_root(), "torch_build"))


# ---------------------------------------------------------------- key

_versions = {}


def compiler_version(argv):
    """The output of a compiler's version query (``argv``, for example
    ``("nvcc", "--version")``), once per process. A query that fails
    gives text naming the failure: such a compiler's libraries key apart
    from a working one's, and its build then reports its own error."""
    key = tuple(str(a) for a in argv)
    if key not in _versions:
        try:
            proc = subprocess.run(key, capture_output=True, text=True,
                                  timeout=120)
            text = (proc.stdout + proc.stderr).strip()
            if proc.returncode:
                text += f" (exit {proc.returncode})"
        except (OSError, subprocess.SubprocessError) as err:
            text = f"unavailable: {err}"
        _versions[key] = text
    return _versions[key]


def library_key(source_bytes, flags, version):
    """16 hex digits of SHA-256 over the source, the flags and the
    compiler's version text."""
    h = hashlib.sha256(source_bytes)
    for part in (" ".join(flags), version):
        h.update(b"\0" + part.encode())
    return h.hexdigest()[:16]


def file_digest(path):
    """SHA-256 hex digest of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as fobj:
        for block in iter(lambda: fobj.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


# ---------------------------------------------------- verify, evict, store

@contextlib.contextmanager
def _flock(path, blocking=True):
    """An exclusive ``flock`` on ``path`` (created 0600) for the block;
    yields False without waiting when ``blocking`` is off and another
    holder has it."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | (0 if blocking
                                             else fcntl.LOCK_NB))
        except BlockingIOError:
            yield False
            return
        yield True
    finally:
        os.close(fd)


def _remove(path):
    for p in (path, str(path) + DIGEST_SUFFIX):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def _evict_corrupt(path, name, reason):
    """A stored library failed its check: log it, remove it and its
    digest, count the eviction and record a ``cache_corrupt`` incident
    naming the path; the caller rebuilds. Corruption must never crash a
    run nor be loaded into it."""
    log.warning("built library %s is corrupt (%s); evicting %s and "
                "rebuilding", name, reason, path)
    try:
        _remove(path)
    except OSError as err:
        log.warning("could not evict corrupt library %s: %s", path, err)
    try:
        from ..survey.incidents import emit
        from ..survey.metrics import get_metrics

        get_metrics().add("cache_evictions")
        emit("cache_corrupt", path=str(path), name=str(name),
             reason=str(reason))
    except Exception as err:  # pragma: no cover - advisory path
        log.warning("cache_corrupt incident emission failed: %s", err)


def _verify(path, name):
    """The stored library's digest when its bytes match the digest
    beside it; None when no library is stored, or after evicting one
    that fails the check (a missing or unreadable digest, unreadable
    bytes, a mismatch)."""
    if not os.path.exists(path):
        _remove(path)                  # a digest left without its library
        return None
    try:
        with open(str(path) + DIGEST_SUFFIX) as fobj:
            want = fobj.read().strip()
    except FileNotFoundError:
        _evict_corrupt(path, name, "missing digest")
        return None
    except (OSError, UnicodeDecodeError) as err:
        _evict_corrupt(path, name, f"unreadable digest: {err}")
        return None
    try:
        got = file_digest(path)
    except OSError as err:
        _evict_corrupt(path, name, f"unreadable library: {err}")
        return None
    if got != want:
        _evict_corrupt(path, name, f"digest mismatch (stored {want[:16]}, "
                                   f"computed {got[:16]})")
        return None
    return got


def _build(path, compile_fn, name, info):
    """Compile into a private temporary file beside ``path`` and store
    its bytes and digest. Returns (the temporary file, the digest); the
    caller loads and removes the temporary file. A failed store is
    logged and leaves nothing stored."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.",
                               suffix=".build")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        info["log"] = compile_fn(tmp)
        info["seconds"] = time.perf_counter() - t0
        with open(tmp, "rb") as fobj:
            data = fobj.read()
    except BaseException:
        os.remove(tmp)
        raise
    digest = hashlib.sha256(data).hexdigest()
    try:
        fsio.atomic_write_bytes(str(path), data, site="exec_cache_store")
        fsio.atomic_write_bytes(str(path) + DIGEST_SUFFIX,
                                (digest + "\n").encode())
    except OSError as err:
        log.warning("could not store built library %s (%s)", name, err)
        _remove(path)
        info["store_error"] = str(err)
    return tmp, digest


def count_warmth(fresh):
    """Count one reusable build of this process as cold (``fresh``: built
    or loaded now, ``exec_cold_builds``) or warm (an earlier build reused,
    ``exec_warm_hits``): the JAX package's two warmth counters, which the
    serve daemon reads to show that a job of an already-served geometry
    built nothing."""
    from ..survey.metrics import get_metrics

    get_metrics().add("exec_cold_builds" if fresh else "exec_warm_hits")


def obtain(source, flags, compiler, compile_fn, load=False, directory=None,
           info=None):
    """The library built from ``source`` with ``flags`` by the compiler
    whose version query is ``compiler``: the stored library's path, or
    with ``load`` the loaded ``ctypes.CDLL``.

    A stored library is used when its digest checks (``action``
    ``loaded``, or ``cached`` without ``load``); otherwise
    ``compile_fn(out_path)`` builds it (it returns the compiler's output
    and raises RuntimeError on failure), it is stored, and with ``load``
    this process loads its own compiler output (``compiled``). ``info``
    (a dict) receives ``path``, ``action``, ``seconds`` and ``log`` (of
    the last compile into it; 0 and empty when none), ``verify_s`` (the
    digest check) and ``digest``."""
    source = Path(source)
    info = {} if info is None else info
    directory = Path(directory) if directory else cache_dir()
    directory.mkdir(parents=True, exist_ok=True, mode=0o700)
    key = library_key(source.read_bytes(), flags,
                      compiler_version(compiler))
    path = directory / f"lib{source.stem}_{key}.so"
    name = source.name
    # A load after this process's own build keeps the build's seconds
    # and compiler output.
    info.update(path=str(path), key=key)
    info.setdefault("seconds", 0.0)
    info.setdefault("log", "")
    lib = None
    with _flock(str(path) + ".lock"):
        t0 = time.perf_counter()
        digest = _verify(path, name)
        info["verify_s"] = time.perf_counter() - t0
        if digest is not None:
            info["action"] = "loaded" if load else "cached"
            if load:
                lib = ctypes.CDLL(str(path))
        else:
            info["action"] = "compiled"
            tmp, digest = _build(path, compile_fn, name, info)
            try:
                if load:
                    lib = ctypes.CDLL(tmp)
                elif "store_error" in info:
                    raise RuntimeError(f"built {name} but could not store "
                                       f"it: {info['store_error']}")
            finally:
                os.remove(tmp)
        info["digest"] = digest
    if "store_error" not in info:
        _lru_note(path, inserted=info["action"] == "compiled")
    count_warmth(True)
    return lib if load else path


# ---------------------------------------------------------- size cap (LRU)
#
# Each cache directory keeps a manifest of {library: {bytes, last_used}};
# a store evicts the least recently used libraries until the directory
# fits the byte cap, and a load refreshes last_used. The manifest is
# advisory: at worst a library is evicted early and rebuilt. A library
# whose key lock another process holds is never evicted.

def _cache_cap_bytes():
    """Byte cap per cache directory (default 2 GiB); <= 0 disables
    eviction."""
    return envflags.get("RIPTIDE_EXEC_CACHE_MAX_BYTES")


def _manifest_scan(d):
    """Manifest state rebuilt from the directory (mtime as the initial
    last-used order)."""
    entries = {}
    try:
        names = os.listdir(d)
    except OSError:
        return entries
    for name in names:
        if not name.endswith(".so"):
            continue
        try:
            st = os.stat(os.path.join(d, name))
        except OSError:
            continue
        entries[name] = {"bytes": int(st.st_size),
                         "last_used": float(st.st_mtime)}
    return entries


def _manifest_load(d):
    try:
        with open(os.path.join(d, _MANIFEST)) as f:
            m = json.load(f)
        if isinstance(m, dict) and all(
            isinstance(v, dict) and "bytes" in v and "last_used" in v
            for v in m.values()
        ):
            return m
    except (OSError, ValueError):
        pass
    return _manifest_scan(d)


def _manifest_write(d, m):
    try:
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(m, f)
        os.replace(tmp, os.path.join(d, _MANIFEST))
    except OSError as err:
        log.debug("manifest write failed in %s (%s)", d, err)


def _lru_note(path, inserted):
    """Record a load (``inserted=False``: refresh last_used) or a new
    library (``inserted=True``: register it, then evict the oldest past
    the byte cap, never the one just stored)."""
    d, name = os.path.split(str(path))
    with _flock(os.path.join(d, _MANIFEST + ".lock")):
        m = _manifest_load(d)
        try:
            size = int(os.stat(path).st_size)
        except OSError:
            return
        m[name] = {"bytes": size, "last_used": time.time()}
        if inserted:
            cap = _cache_cap_bytes()
            if cap > 0:
                victims = sorted((k for k in m if k != name),
                                 key=lambda k: m[k]["last_used"])
                total = sum(v["bytes"] for v in m.values())
                for k in victims:
                    if total <= cap:
                        break
                    victim = os.path.join(d, k)
                    with _flock(victim + ".lock", blocking=False) as held:
                        if not held:
                            continue
                        _remove(victim)
                    total -= m.pop(k)["bytes"]
                    log.info("evicted LRU built library %s", k)
        _manifest_write(d, m)
