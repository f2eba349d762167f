#!/usr/bin/env python
"""
riplint: run every static analyzer of the port over
``riptide_tpu_torch/`` (the port's counterpart of the JAX package's
``tools/riplint.py``; the same flags, output lines and exit codes).

The analyzers live in ``riptide_tpu_torch/analysis/lint/`` and load
standalone by file path: no torch, no numpy, not the package
``__init__``, so the lint runs on any machine with a Python. Output is
GitHub-annotation format, one finding per line::

    riptide_tpu_torch/search/engine.py:921:10: RIP001 `int(...)` ...

Exit status 0 when the port is clean against its baseline
(``riptide_tpu_torch/analysis/riplint_baseline.json``); 1 when there are
new findings OR stale baseline entries (an entry whose code is gone must
be deleted — a baseline only stays honest if it cannot accumulate dead
weight).

Suppression, in reviewability order:

* fix the finding;
* ``# riplint: disable=RIPxxx`` on the flagged line (visible in the
  diff it suppresses);
* a baseline entry with a one-line ``why`` (for intentional,
  long-lived exceptions: documented sync points, build-serialisation
  locks). ``--update-baseline`` rewrites the file, keeping the
  justifications of surviving entries; new entries get a TODO you must
  edit before committing. ``--prune-baseline`` keeps ONLY the entries
  that matched a finding this run, so a pruned baseline followed by a
  plain run is clean by construction.

``--rule RIPxxx`` (repeatable, or comma-separated) runs those analyzers
alone: ``--rule RIP006`` is the finite-guard check and ``--rule
RIP007`` the liveness-guard check that the JAX package keeps as the
scripts ``tools/check_finite_guards.py`` / ``check_liveness_guards.py``.

``--write-env-docs`` regenerates ``riptide_tpu_torch/analysis/
env_flags.md`` from the ``utils/envflags.py`` registry (RIP003 fails on
drift). ``--format sarif`` emits one SARIF 2.1.0 run
(``analysis/sarif.py``) instead of the one-line format; the exit codes
are the same.

Runs are cached in ``riptide_tpu_torch/_build/riplint_cache.json``
(git-ignored): the (mtime, size) of every file the analyzers can
observe plus a digest of the analyzer sources, all or nothing (the
whole-program rules make per-file reuse unsound). ``--no-cache``
forces a full run.

    python -m riptide_tpu_torch.apps.riplint [--no-cache] [--rule R]
    python riptide_tpu_torch/apps/riplint.py ...
"""
import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG_DIR = os.path.dirname(HERE)
REPO = os.path.dirname(PKG_DIR)
LINT_DIR = os.path.join(PKG_DIR, "analysis", "lint")
DEFAULT_BASELINE = os.path.join(PKG_DIR, "analysis",
                                "riplint_baseline.json")
CACHE_REL = "riptide_tpu_torch/_build/riplint_cache.json"
CACHE_VERSION = 1


def _load(name, path, package_dir=None):
    """A stdlib-only module of the port loaded by file path (a package
    when ``package_dir`` is given)."""
    if name in sys.modules:
        return sys.modules[name]
    kw = ({"submodule_search_locations": [package_dir]}
          if package_dir else {})
    spec = importlib.util.spec_from_file_location(name, path, **kw)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def load_lint():
    """The ``riptide_tpu_torch.analysis.lint`` package, loaded
    standalone."""
    return _load("riptide_tpu_torch_lint_standalone",
                 os.path.join(LINT_DIR, "__init__.py"), LINT_DIR)


def load_sarif():
    """``riptide_tpu_torch.analysis.sarif``, loaded standalone."""
    return _load("riptide_tpu_torch_sarif_standalone",
                 os.path.join(PKG_DIR, "analysis", "sarif.py"))


def select(analysis, rules):
    """The analyzer classes of ``rules`` (ids, any case), in
    ``ALL_ANALYZERS`` order; ValueError for an unknown id."""
    want = {r.strip().upper() for spec in rules for r in spec.split(",")
            if r.strip()}
    known = {a.rule for a in analysis.ALL_ANALYZERS}
    if want - known:
        raise ValueError(f"unknown rule(s) {sorted(want - known)}; "
                         f"known: {sorted(known)}")
    return [a for a in analysis.ALL_ANALYZERS if a.rule in want]


# -- result cache ------------------------------------------------------------

def _tracked_files(repo, analysis):
    """Repo-relative paths of every file whose content can change an
    analyzer's output: the package's sources and data files (the flag
    reference included) and its out-of-package surfaces."""
    out = []
    top = os.path.join(repo, analysis.PACKAGE)
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fname in sorted(filenames):
            if fname.endswith((".py", ".json", ".md")):
                out.append(os.path.relpath(os.path.join(dirpath, fname),
                                           repo))
    out += analysis.surface_files(repo)
    return [p.replace(os.sep, "/") for p in out]


def _file_state(repo, analysis):
    state = {}
    for rel in _tracked_files(repo, analysis):
        try:
            st = os.stat(os.path.join(repo, rel))
        except OSError:
            continue
        state[rel] = [st.st_mtime_ns, st.st_size]
    return state


def _analyzer_digest():
    """Digest over the analyzer sources and this runner: any edit to
    the rules invalidates every cached result."""
    h = hashlib.sha1()
    for name in sorted(os.listdir(LINT_DIR)):
        if name.endswith(".py"):
            h.update(name.encode())
            with open(os.path.join(LINT_DIR, name), "rb") as fobj:
                h.update(fobj.read())
    with open(os.path.abspath(__file__), "rb") as fobj:
        h.update(fobj.read())
    return h.hexdigest()


def _cache_key(repo, baseline_path, analysis):
    """The invalidation key, computed ONCE per run and shared by the
    load comparison and the post-run save."""
    try:
        st = os.stat(baseline_path)
        bstate = [st.st_mtime_ns, st.st_size]
    except OSError:
        bstate = None
    return {
        "version": CACHE_VERSION,
        "analyzer_digest": _analyzer_digest(),
        "baseline_path": os.path.abspath(baseline_path),
        "baseline_state": bstate,
        "files": _file_state(repo, analysis),
    }


def _load_cached_result(repo, key):
    try:
        with open(os.path.join(repo, CACHE_REL)) as fobj:
            doc = json.load(fobj)
    except (OSError, ValueError):
        return None
    if any(doc.get(k) != v for k, v in key.items()):
        return None
    return doc.get("result")


def _save_cached_result(repo, key, result):
    path = os.path.join(repo, CACHE_REL)
    tmp = f"{path}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as fobj:
            json.dump(dict(key, result=result), fobj, indent=1)
            fobj.write("\n")
        os.replace(tmp, path)
    except OSError:
        pass  # best-effort: a read-only tree just runs uncached


# -- output ------------------------------------------------------------------

def _emit(result, analyzers, fmt, out, err, cached=False):
    """Render one (possibly replayed) result; returns the exit code."""
    n_new, n_stale = len(result["new"]), len(result["stale"])
    if fmt == "sarif":
        rules = [(a.rule, a.name, a.description) for a in analyzers]
        doc = load_sarif().sarif_doc(result["new"], rules, "riplint",
                                     stale=result["stale"])
        json.dump(doc, out, indent=2)
        out.write("\n")
    else:
        for f in result["new"]:
            print(f"{f['path']}:{f['line']}:{f['col']}: {f['rule']} "
                  f"{f['message']}", file=out)
        for e in result["stale"]:
            print(
                f"{e['path']}:1:0: {e['rule']} STALE baseline entry "
                f"(line_text={e['line_text']!r}) — the code it justified "
                "is gone; delete the entry or run --update-baseline",
                file=out,
            )
    tag = " [cached]" if cached else ""
    if n_new or n_stale:
        print(
            f"riplint: {n_new} new finding(s), {n_stale} stale "
            f"baseline entr(y/ies) ({result['baselined']} baselined, "
            f"{result['n_rules']} analyzers over {result['n_modules']} "
            f"modules){tag}",
            file=err,
        )
        return 1
    print(
        f"riplint OK: {result['n_rules']} analyzers over "
        f"{result['n_modules']} modules, 0 new findings "
        f"({result['baselined']} baselined){tag}", file=err,
    )
    return 0


def run(repo=REPO, baseline_path=DEFAULT_BASELINE, analyzers=None,
        update_baseline=False, prune_baseline=False, out=None, err=None,
        fmt="text", use_cache=True):
    """Run the analyzers; returns the process exit code."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    analysis = load_lint()
    # Only runs of the full default analyzer set over this checkout are
    # cacheable; baseline-rewriting runs need the real match
    # bookkeeping, so they are never served from (or saved to) cache.
    cacheable = (analyzers is None and not update_baseline
                 and not prune_baseline and use_cache)
    analyzers = analyzers or analysis.ALL_ANALYZERS
    instances = [a() if isinstance(a, type) else a for a in analyzers]

    cache_key = None
    if cacheable:
        cache_key = _cache_key(repo, baseline_path, analysis)
        result = _load_cached_result(repo, cache_key)
        if result is not None:
            return _emit(result, instances, fmt, out, err, cached=True)

    baseline = analysis.Baseline.load(baseline_path)
    contexts = analysis.collect_contexts(repo)
    new, baselined, stale = analysis.run_analyzers(
        repo, instances, baseline=baseline, contexts=contexts)
    # The entries of rules this run left out are neither stale nor
    # dropped by a rewrite.
    ran = {i.rule for i in instances}
    stale = [e for e in stale if e["rule"] in ran]

    if update_baseline:
        by_rel = {c.relpath: c for c in contexts}
        kept = [e for e in baseline.entries if e not in stale]
        seen = {(e["rule"], e["path"], e["line_text"].strip())
                for e in kept}
        added = []
        for f in new:
            ctx = by_rel.get(f.path)
            if ctx is not None:
                entry = analysis.Baseline.entry_for(f, ctx)
            else:
                # A finding outside the package: the path-only entry
                # form that Baseline.matches_pathonly absorbs.
                entry = {"rule": f.rule, "path": f.path,
                         "line_text": "", "why": "TODO: justify"}
            key = (entry["rule"], entry["path"],
                   entry["line_text"].strip())
            if key in seen:
                continue
            seen.add(key)
            added.append(entry)
        analysis.Baseline(kept + added, path=baseline_path).dump()
        print(
            f"baseline updated: {len(kept)} kept, {len(added)} added "
            f"(edit their TODO justifications), {len(stale)} stale "
            "dropped", file=err,
        )
        return 0

    if prune_baseline:
        # Keep exactly the entries that absorbed a finding this run.
        # New findings still fail the run below.
        kept = [e for e in baseline.entries if e not in stale]
        analysis.Baseline(kept, path=baseline_path).dump()
        print(f"baseline pruned: {len(kept)} entr(y/ies) kept, "
              f"{len(stale)} unmatched dropped", file=err)
        stale = []

    result = {
        "new": [{"path": f.path, "line": f.line, "col": f.col,
                 "rule": f.rule, "message": f.message} for f in new],
        "stale": list(stale),
        "baselined": len(baselined),
        "n_rules": len({i.rule for i in instances}),
        "n_modules": len(contexts),
    }
    if cacheable:
        _save_cached_result(repo, cache_key, result)
    return _emit(result, instances, fmt, out, err)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="riplint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default riptide_tpu_torch/"
                         "analysis/riplint_baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to absorb current "
                         "findings (justifications of surviving entries "
                         "are kept; new entries get a TODO)")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="rewrite the baseline keeping only entries "
                         "that matched a finding this run (new findings "
                         "still fail)")
    ap.add_argument("--format", choices=("text", "sarif"),
                    default="text", dest="fmt",
                    help="output format: GitHub-annotation text "
                         "(default) or one SARIF 2.1.0 run")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the result cache")
    ap.add_argument("--rule", action="append", default=[],
                    metavar="RIPxxx",
                    help="run only these analyzers (repeatable, or "
                         "comma-separated)")
    ap.add_argument("--write-env-docs", action="store_true",
                    help="regenerate riptide_tpu_torch/analysis/"
                         "env_flags.md from the utils/envflags.py "
                         "registry and exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the analyzer set (rule id, name, "
                         "description) and exit")
    args = ap.parse_args(argv)

    analysis = load_lint()
    if args.list_rules:
        for cls in analysis.ALL_ANALYZERS:
            print(f"{cls.rule}  {cls.name}: {cls.description}")
        return 0
    if args.write_env_docs:
        registry = analysis.env_flags.load_registry(REPO)
        path = os.path.join(REPO, analysis.env_flags.DOCS_REL)
        with open(path, "w") as fobj:
            fobj.write(registry.render_markdown())
        print(f"wrote {os.path.relpath(path, REPO)}", file=sys.stderr)
        return 0
    try:
        analyzers = select(analysis, args.rule) if args.rule else None
    except ValueError as e:
        ap.error(str(e))
    return run(baseline_path=args.baseline, analyzers=analyzers,
               update_baseline=args.update_baseline,
               prune_baseline=args.prune_baseline,
               fmt=args.fmt, use_cache=not args.no_cache)


if __name__ == "__main__":
    sys.exit(main())
