"""
RIP006 — finite-guard discipline (the port's copy of the JAX
package's rule; ``python -m riptide_tpu_torch.apps.riplint --rule
RIP006`` runs it alone).

Every public data entry point routes through the data-quality layer
(``riptide_tpu_torch.quality``): a single NaN reaching the compute path
silently poisons a whole periodogram, so the guard is structural —
each checked function must (directly, or through one local helper)
invoke something from the quality module.
"""
import ast
import os

from .core import Analyzer, Finding

__all__ = ["FiniteGuardAnalyzer", "ENTRY_POINTS", "check_tree",
           "check_module", "check"]

# relpath (as stored, OS-independent forward slashes) -> required
# guarded function/method names
ENTRY_POINTS = {
    "riptide_tpu_torch/ops/snr.py": [
        "boxcar_snr", "snr_batched",
    ],
    "riptide_tpu_torch/time_series.py": [
        "from_binary", "from_npy_file", "from_presto_inf", "from_sigproc",
        "from_numpy_array", "generate", "normalise",
    ],
}


def _quality_aliases(tree):
    """Names bound (anywhere in the module, including inside function
    bodies) by ``from ...quality import X [as Y]``."""
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[-1] == "quality":
            for a in node.names:
                aliases.add(a.asname or a.name)
    return aliases


def _called_names(fn_node):
    """Names invoked inside a function body: bare calls by name,
    attribute calls by attribute name (covers self.x / cls.x /
    quality.x)."""
    direct_quality = False
    names = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            names.add(f.id)
        elif isinstance(f, ast.Attribute):
            names.add(f.attr)
            if isinstance(f.value, ast.Name) and f.value.id == "quality":
                direct_quality = True
    return names, direct_quality


def _functions(tree):
    """{name: node} over every (async) function/method in the module.
    Later definitions win, matching runtime shadowing."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def check_tree(tree, path, required):
    """Structured violations for one parsed module: list of
    ``(lineno, message)`` (lineno 1 for a missing entry point)."""
    aliases = _quality_aliases(tree)
    functions = _functions(tree)

    def guarded_directly(name):
        node = functions.get(name)
        if node is None:
            return False
        called, direct = _called_names(node)
        return direct or bool(called & aliases)

    violations = []
    for name in required:
        node = functions.get(name)
        if node is None:
            violations.append((1, f"entry point {name!r} not found "
                                  "(update the finite-guard entry-point "
                                  "list)"))
            continue
        if guarded_directly(name):
            continue
        # One level of indirection: a local helper that is itself guarded.
        called, _ = _called_names(node)
        if any(guarded_directly(h) for h in called if h in functions):
            continue
        violations.append((
            node.lineno,
            f"{name!r} does not route through the data-quality layer "
            "(riptide_tpu_torch.quality)",
        ))
    return violations


def check_module(path, required):
    """The rule on one file as strings, the JAX package's shim: one
    violation a line, ``path:lineno: message`` (``path: message`` for a
    missing entry point)."""
    with open(path) as fobj:
        tree = ast.parse(fobj.read(), filename=path)
    out = []
    for lineno, msg in check_tree(tree, path, required):
        if "not found" in msg:
            out.append(f"{path}: {msg}")
        else:
            out.append(f"{path}:{lineno}: {msg}")
    return out


def check(repo):
    """Every violation (strings) across :data:`ENTRY_POINTS` of the
    port's tree under ``repo``; empty when the tree is clean."""
    violations = []
    for rel, required in ENTRY_POINTS.items():
        violations.extend(
            check_module(os.path.join(repo, *rel.split("/")), required)
        )
    return violations


class FiniteGuardAnalyzer(Analyzer):
    rule = "RIP006"
    name = "finite-guards"
    description = ("public data entry points route through the "
                   "data-quality layer (riptide_tpu_torch.quality)")

    def __init__(self, entry_points=None):
        self.entry_points = (ENTRY_POINTS if entry_points is None
                             else entry_points)
        self._seen = set()

    def begin(self, repo):
        self._seen = set()

    def run(self, ctx):
        required = self.entry_points.get(ctx.relpath)
        if required is None:
            return []
        self._seen.add(ctx.relpath)
        return [
            Finding(ctx.relpath, lineno, 0, self.rule, msg)
            for lineno, msg in check_tree(ctx.tree, ctx.path, required)
        ]

    def finalize(self, repo, contexts):
        # A configured module that never appeared means the lint went
        # vacuous (file moved/renamed without updating the config).
        return [
            Finding(rel, 1, 0, self.rule,
                    "configured finite-guard module missing from the "
                    "package — update the entry-point list")
            for rel in self.entry_points if rel not in self._seen
        ]
