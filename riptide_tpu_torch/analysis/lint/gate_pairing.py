"""
RIP014 — gate/resource begin-end pairing on every path (the port's
copy of the JAX package's rule).

Three protocols in the survey/serve planes hand out a resource whose
release MUST happen on every control-flow path, or the system leaks
capacity until a hang (ripsched's ``fairshare``/``staging`` models
show the dynamic failure; this rule pins the static shape):

* ``chunk_gate.begin(cid)`` / ``.end(cid)`` — the fair-share queue's
  device turn. A missed ``end`` keeps the turn forever: every other
  job's ``begin`` parks until its deadline (the exact hang the
  drain-termination invariant guards).
* ``pool.acquire(...)`` / ``pool.release(buf)`` — the staging arena.
  A buffer that never returns shrinks the arena until prep stalls.
* ``integrity.begin_fold(...)`` / ``finish_fold(acc)`` — the
  integrity accumulator (matched by method name: its receiver
  varies).

A ``begin``/``acquire`` is compliant when a ``try`` whose
``finally`` holds the matching ``end``/``release`` (same pair, same
receiver name) covers it — including the repo's
begin-immediately-before-``try`` idiom — or, for ``acquire`` only,
when the result **escapes** the function (returned, or stored into an
attribute/subscript, directly or through local-name propagation):
ownership moved to the caller, release is its job. Receiver-name
sets keep unrelated ``begin``/``acquire`` protocols (chaos blockers,
HTTP handlers) out; like every riplint rule, a shape the resolver
cannot see contributes no finding.
"""
import ast

from .core import Analyzer, Finding, dotted, walk_functions, walk_own

__all__ = ["GatePairingAnalyzer", "PAIRS"]

# (open method, close method, receiver leaf-name set or None for
# match-by-method-name, result-escape exemption)
PAIRS = (
    ("begin", "end", frozenset({"chunk_gate", "gate"}), False),
    ("acquire", "release",
     frozenset({"pool", "_pool", "staging", "_staging", "staging_pool",
                "_staging_pool"}), True),
    ("begin_fold", "finish_fold", None, False),
)


def _receiver_leaf(func):
    """Leaf name of a method call's receiver: ``self.chunk_gate.begin``
    -> "chunk_gate", ``pool.acquire`` -> "pool"."""
    if not isinstance(func, ast.Attribute):
        return None
    recv = func.value
    if isinstance(recv, ast.Attribute):
        return recv.attr
    if isinstance(recv, ast.Name):
        return recv.id
    return None


def _method_calls(fn_node, method, receivers):
    """Call nodes of ``<recv>.<method>(...)`` in a function's own body
    (any receiver when ``receivers`` is None)."""
    for node in walk_own(fn_node):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == method:
            leaf = _receiver_leaf(node.func)
            if leaf is None:
                continue
            if receivers is None or leaf in receivers:
                yield node, leaf


def _flat_targets(targets):
    """Assignment target nodes with tuple/list structure flattened
    (``flat, scales = ...`` stores two Names)."""
    out = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        else:
            out.append(t)
    return out


def _escaped_names(fn_node):
    """Local names whose value escapes the function: returned, stored
    into an attribute/subscript, or assigned onward (including through
    a container literal or a call whose result is so stored — the
    ``out=`` buffer-filling idiom) to a name that escapes. Two
    propagation passes cover the repo's depth."""
    escaped = set()
    for _ in range(2):
        for node in walk_own(fn_node):
            value = None
            if isinstance(node, ast.Return) and node.value is not None:
                value = node.value
            elif isinstance(node, ast.Assign):
                targets = _flat_targets(node.targets)
                if any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in targets) \
                        or any(isinstance(t, ast.Name)
                               and t.id in escaped for t in targets):
                    value = node.value
            if value is not None:
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Name) \
                            and isinstance(sub.ctx, ast.Load):
                        escaped.add(sub.id)
    return escaped


def _escapes(fn_node, call, escaped):
    """True when ``call``'s result leaves the function: it sits in a
    return/attribute/subscript store directly, or is bound to an
    escaped local name."""
    for node in walk_own(fn_node):
        if isinstance(node, ast.Return) and node.value is not None \
                and any(sub is call for sub in ast.walk(node.value)):
            return True
        if isinstance(node, ast.Assign) \
                and any(sub is call for sub in ast.walk(node.value)):
            targets = _flat_targets(node.targets)
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in targets):
                return True
            if any(isinstance(t, ast.Name) and t.id in escaped
                   for t in targets):
                return True
    return False


def _covered_by_finally(fn_node, open_call, close_method, leaf,
                        receivers):
    """True when some ``try`` in the function closes the resource in
    its ``finally`` and its extent covers the open call — the repo's
    idiom places ``begin`` either inside the try or on the line(s)
    immediately before it, so the predicate is by line range:
    open strictly before the finally suite, try block not ended
    before the open."""
    for node in walk_own(fn_node):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        if not (open_call.lineno < node.finalbody[0].lineno
                and node.end_lineno >= open_call.lineno):
            continue
        for stmt in node.finalbody:
            for close, close_leaf in _method_calls(
                    stmt, close_method, receivers):
                if receivers is None or close_leaf == leaf:
                    return True
    return False


def _in_with_item(fn_node, open_call):
    """True when the open call IS a ``with`` item's context expression
    (the context-manager form pairs by construction)."""
    for node in walk_own(fn_node):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if any(sub is open_call
                       for sub in ast.walk(item.context_expr)):
                    return True
    return False


class GatePairingAnalyzer(Analyzer):
    rule = "RIP014"
    name = "gate-pairing"
    description = ("chunk_gate begin/end, StagingPool acquire/release "
                   "and integrity begin_fold/finish_fold pair on every "
                   "path: try/finally, with, or (acquire only) "
                   "ownership escape")

    def run(self, ctx):
        if not ctx.relpath.startswith("riptide_tpu_torch/"):
            return []
        findings = []
        for qual, fn in walk_functions(ctx.tree):
            escaped = None
            for open_m, close_m, receivers, may_escape in PAIRS:
                for call, leaf in _method_calls(fn, open_m, receivers):
                    if _covered_by_finally(fn, call, close_m, leaf,
                                           receivers):
                        continue
                    if _in_with_item(fn, call):
                        continue
                    if may_escape:
                        if escaped is None:
                            escaped = _escaped_names(fn)
                        if _escapes(fn, call, escaped):
                            continue
                    findings.append(Finding.at(
                        ctx, call, self.rule,
                        f"{leaf}.{open_m}(...) in {qual!r} has no "
                        f"matching {leaf}.{close_m}() in a covering "
                        "finally (and the result does not leave the "
                        "function) — a path that raises between them "
                        "leaks the resource; wrap in try/finally"))
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings
