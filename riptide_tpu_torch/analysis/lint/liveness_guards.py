"""
RIP007 — bounded-collective discipline, in its torch form (``python -m
riptide_tpu_torch.apps.riplint --rule RIP007`` runs it alone).

Every ``torch.distributed`` collective in ``riptide_tpu_torch/`` goes
through the liveness layer's bounded-wait wrappers
(``survey/liveness.py``: ``bounded_allgather`` / ``barrier_with_timeout``,
:data:`ALLOWED`), so a dead peer cannot deadlock the run. A collective
counts where it is called and also where it is referenced as a callable
(``bounded_wait(dist.barrier, ...)`` hands the barrier to a watchdog
thread), through any binding of the module: ``import
torch.distributed as dist``, ``from torch import distributed``, the
dotted ``torch.distributed.*``, or ``from torch.distributed import
...``. A ``from torch.distributed import <collective>`` outside the
wrappers is a violation at the import itself, as the JAX rule's
``multihost_utils`` imports are. ZERO collective uses inside the
wrappers means they were refactored away and the lint has gone
vacuous: also a failure.
"""
import ast
import os

from .core import Analyzer, Finding

__all__ = ["LivenessGuardAnalyzer", "ALLOWED", "COLLECTIVES", "check_file",
           "check"]

# relpath -> function names allowed to enter a collective
ALLOWED = {
    "riptide_tpu_torch/survey/liveness.py":
        {"bounded_allgather", "barrier_with_timeout"},
}

_WRAPPER_HOME = "riptide_tpu_torch/survey/liveness.py"

COLLECTIVES = frozenset({
    "all_gather", "all_gather_object", "all_reduce", "broadcast",
    "gather", "scatter", "barrier", "monitored_barrier", "send", "recv",
    "reduce_scatter",
})


def _dist_bindings(tree):
    """(module aliases, {local name: collective}, [(import node,
    collective)]) of the module's torch.distributed bindings."""
    aliases, bare, imports = {"torch.distributed"}, {}, []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    aliases.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    aliases.add(a.asname or a.name)
                elif node.module == "torch.distributed" \
                        and a.name in COLLECTIVES:
                    bare[a.asname or a.name] = a.name
                    imports.append((node, a.name))
    return aliases, bare, imports


def _uses(tree):
    """``(lineno, enclosing functions innermost last, collective,
    kind)`` of every collective the module reaches: ``kind`` "use" for
    a call or reference, "import" for a bare-name import."""
    aliases, bare, imports = _dist_bindings(tree)
    import_ids = {id(n): c for n, c in imports}
    sites = []

    def dotted_name(node):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    def visit(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = fn + (node.name,)
        if isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and node.attr in COLLECTIVES:
            base = dotted_name(node.value)
            if base in aliases:
                sites.append((node.lineno, fn, node.attr, "use"))
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in bare:
            sites.append((node.lineno, fn, bare[node.id], "use"))
        elif id(node) in import_ids:
            sites.append((node.lineno, fn, import_ids[id(node)], "import"))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(tree, ())
    return sites


def check_tree(tree, rel, allowed):
    """``(violations, wrapped)``: violations as ``(lineno, message)``,
    ``wrapped`` the collective uses inside allowed wrappers. A closure
    defined inside a wrapper (the collective the wrapper hands to
    ``bounded_wait``) is inside it."""
    violations, wrapped = [], 0
    for lineno, fns, coll, kind in _uses(tree):
        if set(fns) & set(allowed.get(rel, ())):
            wrapped += kind == "use"
            continue
        fn = fns[-1] if fns else None
        what = (f"raw torch.distributed collective `{coll}`"
                if kind == "use" else
                f"`from torch.distributed import {coll}` that evades the "
                "attribute check")
        violations.append((
            lineno,
            f"{what} {'in ' + fn + '()' if fn else 'at module level'} — "
            "route it through riptide_tpu_torch.survey.liveness "
            "(bounded_allgather / barrier_with_timeout) so a dead peer "
            "cannot deadlock the run",
        ))
    return violations, wrapped


VACUOUS_MESSAGE = (
    "no torch.distributed collective found inside the allowed liveness "
    "wrappers — the lint has gone vacuous (were "
    "bounded_allgather/barrier_with_timeout refactored away? update "
    "the liveness-guard allowlist)"
)


def check_file(path, rel, allowed):
    """The rule on one file as strings, the JAX package's shim:
    ``(["rel:lineno: message", ...], collective uses inside the allowed
    wrappers)``."""
    with open(path) as fobj:
        tree = ast.parse(fobj.read(), filename=path)
    violations, wrapped = check_tree(tree, rel, allowed)
    return [f"{rel}:{lineno}: {msg}" for lineno, msg in violations], wrapped


def check(repo, allowed=None):
    """Every violation (strings) across ``riptide_tpu_torch/`` under
    ``repo``, the vacuous-lint message included; empty when the tree is
    clean."""
    allowed = ALLOWED if allowed is None else allowed
    allowed = {k.replace(os.sep, "/"): v for k, v in allowed.items()}
    package = os.path.join(repo, "riptide_tpu_torch")
    violations, wrapped_total = [], 0
    for dirpath, dirnames, filenames in os.walk(package):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, repo).replace(os.sep, "/")
            found, wrapped = check_file(path, rel, allowed)
            violations.extend(found)
            wrapped_total += wrapped
    if wrapped_total == 0:
        violations.append(VACUOUS_MESSAGE)
    return violations


class LivenessGuardAnalyzer(Analyzer):
    rule = "RIP007"
    name = "liveness-guards"
    description = ("torch.distributed collectives (called or passed as "
                   "callables) route through the liveness layer's "
                   "bounded-wait wrappers")

    def __init__(self, allowed=None):
        self.allowed = ALLOWED if allowed is None else allowed
        self._wrapped = 0

    def begin(self, repo):
        self._wrapped = 0

    def run(self, ctx):
        violations, wrapped = check_tree(ctx.tree, ctx.relpath,
                                         self.allowed)
        self._wrapped += wrapped
        return [Finding(ctx.relpath, lineno, 0, self.rule, msg)
                for lineno, msg in violations]

    def finalize(self, repo, contexts):
        if self._wrapped == 0:
            home = next(iter(sorted(self.allowed)), _WRAPPER_HOME)
            return [Finding(home, 1, 0, self.rule, VACUOUS_MESSAGE)]
        return []
