"""
RIP004 — lock and thread discipline in the threading modules.

The survey's liveness machinery exists because *unbounded waits kill
long campaigns* (Parent et al. 2018's pipeline-reliability posture):
a blocking call made while holding a lock turns every other thread
needing that lock into a hostage of the slow operation; an untimed
``join()`` / ``Event.wait()`` blocks forever on a wedged thread; a
thread without an explicit daemon flag inherits whatever the default
is, which decides whether a hung worker can block interpreter exit.

Scoped to the port's modules that own threads or locks:
``survey/liveness.py``, ``survey/faults.py``, ``survey/metrics.py``,
``utils/exec_cache.py``, ``utils/cuda_build.py``, ``native/__init__.py``,
``ops/ffa_kernel.py`` and the survey service (``serve/``).

Checks:

* **no blocking call under a lock** — inside a ``with <lock>:`` body:
  ``time.sleep``, ``subprocess.*``, untimed ``join()`` / ``wait()``,
  ``.acquire()`` of another lock, and the known-blocking local helpers
  (``_build``, ``load_or_compile_exec`` — the native/kernel build
  paths). Intentional build-serialisation locks go in the baseline
  with their justification;
* **untimed join** — ``.join()`` with no arguments anywhere in scope
  (a zero-argument join cannot be ``str.join``; ``Thread.join()``
  without a timeout waits forever);
* **untimed wait** — ``.wait()`` with no arguments (``Event.wait()``
  / ``Condition.wait()`` without a timeout);
* **implicit daemon flag** — ``threading.Thread(...)`` without an
  explicit ``daemon=`` keyword.
"""
import ast

from .core import Analyzer, Finding, dotted

__all__ = ["LockDisciplineAnalyzer", "MODULES", "SCOPE_PREFIXES"]

MODULES = {
    "riptide_tpu_torch/survey/liveness.py",
    "riptide_tpu_torch/survey/faults.py",
    "riptide_tpu_torch/survey/metrics.py",
    "riptide_tpu_torch/utils/exec_cache.py",
    "riptide_tpu_torch/utils/cuda_build.py",
    "riptide_tpu_torch/native/__init__.py",
    "riptide_tpu_torch/ops/ffa_kernel.py",
}
# Whole directories in scope (their modules come and go on their own).
SCOPE_PREFIXES = ("riptide_tpu_torch/serve/",)

# Local helpers known to block for seconds-to-minutes (compiler runs).
_BLOCKING_HELPERS = {"_build", "load_or_compile_exec"}


def _is_lockish(node):
    """True for a with-item context that names a lock (`self._lock`,
    `_lru_lock`, ...)."""
    name = dotted(node)
    return name is not None and "lock" in name.split(".")[-1].lower()


def _blocking_reason(node):
    """Why a call inside a lock-held region is considered blocking, or
    None."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted(node.func) or ""
    leaf = name.split(".")[-1]
    if name.endswith("time.sleep") or name == "sleep" \
            or leaf == "_sleep":
        return "sleeps"
    if name.startswith("subprocess."):
        return "runs a subprocess"
    if leaf in _BLOCKING_HELPERS:
        return "invokes a known-blocking build/compile helper"
    if isinstance(node.func, ast.Attribute) and not node.args \
            and not node.keywords:
        if node.func.attr == "join":
            return "joins a thread without a timeout"
        if node.func.attr == "wait":
            return "waits without a timeout"
        if node.func.attr == "acquire":
            return "acquires another lock (ordering deadlock risk)"
    return None


class LockDisciplineAnalyzer(Analyzer):
    rule = "RIP004"
    name = "lock-discipline"
    description = ("no blocking call while holding a lock, no untimed "
                   "join()/wait(), explicit Thread daemon flags in the "
                   "threading modules")

    def __init__(self, modules=None, scope_prefixes=None):
        self.modules = MODULES if modules is None else modules
        # An explicit module set alone (the fixtures) scopes to exactly
        # those modules.
        if scope_prefixes is None:
            scope_prefixes = SCOPE_PREFIXES if modules is None else ()
        self.scope_prefixes = tuple(scope_prefixes)
        self._seen_modules = set()

    def begin(self, repo):
        self._seen_modules = set()

    def finalize(self, repo, contexts):
        """Staleness guard: a scoped threading module that vanished
        (moved/renamed) must fail loudly, not silently unscope the
        lint."""
        return [
            Finding(rel, 1, 0, self.rule,
                    "threading module missing from the package — the "
                    "lock-discipline scope list (analysis/"
                    "lock_discipline.py MODULES) is stale; update it")
            for rel in sorted(set(self.modules) - self._seen_modules)
        ]

    def run(self, ctx):
        if ctx.relpath not in self.modules \
                and not ctx.relpath.startswith(self.scope_prefixes):
            return []
        self._seen_modules.add(ctx.relpath)
        findings = []

        # Blocking calls under a held lock.
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(_is_lockish(item.context_expr)
                       or (isinstance(item.context_expr, ast.Call)
                           and _is_lockish(item.context_expr.func))
                       for item in node.items):
                continue
            for inner in node.body:
                for sub in ast.walk(inner):
                    reason = _blocking_reason(sub)
                    if reason is not None:
                        findings.append(Finding.at(
                            ctx, sub, self.rule,
                            f"call {reason} while a lock is held — every "
                            "other thread needing the lock stalls behind "
                            "it; move the blocking work outside the "
                            "critical section",
                        ))

        # Untimed join()/wait() and implicit daemon flags, module-wide.
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and not node.args \
                    and not node.keywords:
                if f.attr == "join":
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        "`.join()` without a timeout waits forever on a "
                        "wedged thread — pass a timeout and handle the "
                        "still-alive case",
                    ))
                elif f.attr == "wait":
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        "`.wait()` without a timeout waits forever — "
                        "pass a timeout (the liveness layer exists to "
                        "bound every wait)",
                    ))
            name = dotted(f) or ""
            if name in ("threading.Thread", "Thread"):
                if not any(kw.arg == "daemon" for kw in node.keywords):
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        "`threading.Thread` without an explicit "
                        "`daemon=` — whether a hung worker can block "
                        "interpreter exit must be a decision, not a "
                        "default",
                    ))
        # One finding per site: an untimed join/wait inside a lock-held
        # region would otherwise be reported by both walks (and nested
        # lock-withs re-scan inner bodies). First wins — the under-lock
        # message is the more specific one.
        seen, out = set(), []
        for f in findings:
            key = (f.line, f.col)
            if key not in seen:
                seen.add(key)
                out.append(f)
        return out
