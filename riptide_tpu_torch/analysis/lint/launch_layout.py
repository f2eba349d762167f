"""
RIP005 — kernel launch discipline (the torch form of the JAX package's
``pallas-layout`` rule; the id and name stay).

On the card a kernel runs whatever the host hands it: a launch of
``ffa_stage.cu`` or ``probes.cu`` through ctypes has no shape checks of
its own, so an operand of the wrong shape, dtype or device reads and
writes out of bounds instead of raising. And what the host computes
into a launch (its grid, its shared memory, its stream) must be a pure
function of the operands: host nondeterminism there makes a run
unrepeatable. Scoped to the modules that launch (:data:`SCOPE`,
:data:`SCOPE_PREFIXES`), this rule checks:

* **checks before every launch** — a launch is a call into the bound
  library that passes a stream (``lib.rt_*(..., stream)``, or
  ``getattr(lib, fn)(...)``), or a call of a launch gateway
  (:data:`GATEWAYS`, ``probes/common.py::_launch``, whose own raw call
  is represented by its call sites). When the launch takes a tensor its
  caller supplied (a parameter behind ``.data_ptr()`` / ``_ptr()``, or
  ``*args``), a shape check (a call named ``check_*`` / ``_check_*`` /
  ``require``) must come before it in the same function, or before the
  call in every caller on the project call graph (``_stage`` checks
  before ``_levels`` and ``_snr``; ``segment_levels`` before
  ``_levels``). A launch whose tensors it allocated itself needs none;
* **no host nondeterminism in a launch's arguments** — ``time.*``,
  ``random.*``, ``np.random.*``, ``datetime.*``, ``os.environ`` /
  ``os.getenv`` / ``os.getpid``, ``hash()``, ``id()`` or iteration
  over a ``set``, in the argument expressions or in a local they read.
"""
import ast
import re

from .core import Analyzer, Finding, dotted, walk_functions, walk_own

__all__ = ["LaunchLayoutAnalyzer", "SCOPE", "SCOPE_PREFIXES", "GATEWAYS"]

SCOPE = {"riptide_tpu_torch/ops/ffa_kernel.py"}
SCOPE_PREFIXES = ("riptide_tpu_torch/probes/",)
GATEWAYS = {"riptide_tpu_torch/probes/common.py::_launch"}

_CHECK = re.compile(r"^_?(check_\w+|require)$")
_NONDET_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.",
                    "datetime.", "os.environ", "os.getenv", "os.getpid")
_NONDET_BARE = {"hash", "id", "getenv", "getpid"}
_MAX_DEPTH = 6


def _stream_arg(node):
    """True when an argument expression is a stream (``stream``, a
    ``.stream`` attribute or a ``stream(...)`` call)."""
    if isinstance(node, ast.Call):
        node = node.func
    name = dotted(node) or ""
    return "stream" in name.split(".")[-1]


def _raw_launch(node):
    """True for a call into the bound library that passes a stream."""
    f = node.func
    into_lib = (isinstance(f, ast.Attribute) and f.attr.startswith("rt_")) \
        or (isinstance(f, ast.Call) and dotted(f.func) == "getattr")
    return into_lib and bool(node.args) and _stream_arg(node.args[-1])


def _params(fn):
    a = fn.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    for extra in (a.vararg, a.kwarg):
        if extra is not None:
            names.add(extra.arg)
    return names


def _root(node):
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _tensor_operands(call):
    """Root names of the tensors an expression passes: receivers of
    ``.data_ptr()``, arguments of ``_ptr()`` and starred names."""
    names = set()
    for sub in ast.walk(call):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr == "data_ptr":
                names.add(_root(f.value))
            elif (dotted(f) or "").split(".")[-1] == "_ptr" and sub.args:
                names.add(_root(sub.args[0]))
        elif isinstance(sub, ast.Starred):
            names.add(_root(sub.value))
    names.discard(None)
    return names


def _set_iteration(node):
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return isinstance(node, ast.Call) \
        and dotted(node.func) in ("set", "frozenset")


def _nondeterminism(exprs):
    """(node, what) of the first host-nondeterministic read in
    ``exprs``, or None."""
    for expr in exprs:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                name = dotted(sub.func) or ""
                if name.startswith(_NONDET_PREFIXES) \
                        or name in _NONDET_BARE:
                    return sub, f"`{name}()`"
            elif isinstance(sub, ast.Attribute):
                name = dotted(sub) or ""
                if name.startswith("os.environ"):
                    return sub, f"`{name}`"
            elif isinstance(sub, ast.comprehension) \
                    and _set_iteration(sub.iter):
                return sub.iter, "iteration over a set"
            elif isinstance(sub, ast.Starred) \
                    and _set_iteration(sub.value):
                return sub.value, "iteration over a set"
    return None


class LaunchLayoutAnalyzer(Analyzer):
    rule = "RIP005"
    name = "pallas-layout"
    description = ("every CUDA launch runs after the shape checks of its "
                   "operands (in its function or in every caller), and "
                   "its arguments carry no host nondeterminism")
    needs_project = True

    def __init__(self, scope=None, scope_prefixes=None, gateways=None):
        self.scope = SCOPE if scope is None else set(scope)
        self.scope_prefixes = (SCOPE_PREFIXES if scope_prefixes is None
                               else tuple(scope_prefixes))
        self.gateways = GATEWAYS if gateways is None else set(gateways)

    def _in_scope(self, rel):
        return rel in self.scope or rel.startswith(self.scope_prefixes)

    def run_project(self, project):
        callers = {}
        for info in project.functions.values():
            for node, callee, kind in info.calls:
                if kind == "call":
                    callers.setdefault(callee, []).append((info.fqn, node))
        memo = {}

        def checked_before(fqn, site, depth=0):
            """A shape check precedes ``site`` in ``fqn``, or precedes
            the call of ``fqn`` in every one of its callers."""
            key = (fqn, id(site))
            if key in memo:
                return memo[key]
            memo[key] = False  # a cycle proves nothing
            fn = project.functions[fqn].node
            inside = {id(n) for n in ast.walk(site)}
            ok = any(
                isinstance(sub, ast.Call) and id(sub) not in inside
                and _CHECK.match((dotted(sub.func) or "").split(".")[-1])
                and (sub.lineno, sub.col_offset)
                < (site.lineno, site.col_offset)
                for sub in walk_own(fn))
            if not ok and depth < _MAX_DEPTH:
                ups = callers.get(fqn, [])
                ok = bool(ups) and all(checked_before(c, n, depth + 1)
                                       for c, n in ups)
            memo[key] = ok
            return ok

        findings = []
        for fqn, info in sorted(project.functions.items()):
            if not self._in_scope(info.relpath) or fqn in self.gateways:
                continue
            ctx = project.context_of(fqn)
            params = _params(info.node)
            own = list(walk_own(info.node))
            for node in own:
                if not isinstance(node, ast.Call):
                    continue
                if not (_raw_launch(node)
                        or project.callee(node) in self.gateways):
                    continue
                where = f"`{info.qual}`"
                operands = _tensor_operands(node)
                # One step through a local (`ptrs = (x.data_ptr(), ...)`
                # then `*ptrs`).
                for sub in own:
                    if isinstance(sub, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id in operands
                            for t in sub.targets):
                        operands |= _tensor_operands(sub.value)
                if operands & params \
                        and not checked_before(fqn, node):
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"launch in {where} takes caller-supplied "
                        "tensors with no shape check before it (here or "
                        "in every caller) — a kernel reads whatever it "
                        "is handed; call the operands' check_*/require "
                        "first"))
                reads = {sub.id for sub in ast.walk(node)
                         if isinstance(sub, ast.Name)}
                exprs = list(node.args) + [kw.value for kw in node.keywords]
                exprs += [sub.value for sub in own
                          if isinstance(sub, ast.Assign)
                          and any(isinstance(t, ast.Name) and t.id in reads
                                  for t in sub.targets)]
                hit = _nondeterminism(exprs)
                if hit is not None:
                    bad, what = hit
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"host nondeterminism ({what}, line "
                        f"{bad.lineno}) reaches the launch in {where} — "
                        "grid, shared memory, stream and operands must "
                        "be pure functions of the inputs"))
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings

    def finalize(self, repo, contexts):
        """Staleness guard: a launching module or gateway that vanished
        must fail loudly, not silently unscope the rule."""
        rels = {c.relpath for c in contexts}
        out = [Finding(rel, 1, 0, self.rule,
                       "launching module missing from the package — the "
                       "launch-layout scope list (analysis/lint/"
                       "launch_layout.py SCOPE) is stale; update it")
               for rel in sorted(self.scope - rels)]
        by_rel = {c.relpath: c for c in contexts}
        for fqn in sorted(self.gateways):
            rel, _, qual = fqn.partition("::")
            ctx = by_rel.get(rel)
            if ctx is None or qual not in dict(walk_functions(ctx.tree)):
                out.append(Finding(
                    rel, 1, 0, self.rule,
                    f"launch gateway {qual!r} not found — the "
                    "launch-layout GATEWAYS list is stale; update it"))
        return out
