"""
RIP011 — interprocedural host-sync: RIP001 lifted to call-graph
reachability, in its torch form.

RIP001 scans the *bodies* of an explicit hot-path list; a ``.cpu()``
moved one helper call deep passes it clean while still stalling the
card's queue the same way. This analyzer walks the
:class:`~.core.ProjectContext` call graph from the two roots of the
port's queue path (:data:`ROOTS`) —

* the stage loop: ``engine._queue_stages`` and ``engine._queue_batch``
  (the wire's prep and copy, every stage launch, the assembly);
* the peak program: ``peaks_device.queue_find_peaks``;

— over plain calls, over callables handed to a call as an argument
(``engine._launch("fused_stage", fused_stage, args)`` calls the stage
wrapper it is given), over calls of a function defined inside the
caller (``engine._operands``'s ``dev``, which uploads the stage
operands) and over calls of a private method that one class alone
defines on a receiver the graph cannot type (``peak_plan._fused(snr)``
in ``queue_find_peaks``) — and flags the unambiguous sync pulls (``.item()`` / ``.tolist()`` /
``.cpu()`` / ``.numpy()`` / ``.to("cpu")``, ``synchronize``, the
data-dependent shapes, ``repeat_interleave`` without ``output_size``
and the numpy pulls; :func:`.host_sync.sync_reason`) in every
*reachable* helper, naming the root and the call chain so the finding
is actionable from the message alone. Functions that RIP001 scans
already (the roots and the rest of its hot set) are skipped — one
defect, one rule — as are ``"thread"``-kind edges (a spawned thread is
a new host context, not the queue).

``bool()``/``int()``/``float()`` of non-literals are deliberately NOT
lifted, as in the JAX rule: helpers shared with host code do
legitimate host arithmetic. A root the graph no longer holds fails
loudly (the scope-list discipline of RIP001).
"""
import ast

from .core import Analyzer, Finding, walk_own
from .host_sync import HOT_FUNCTIONS, sync_reason

__all__ = ["InterpHostSyncAnalyzer", "ROOTS"]

ROOTS = {
    "riptide_tpu_torch/search/engine.py::_queue_stages": "the stage loop",
    "riptide_tpu_torch/search/engine.py::_queue_batch": "the stage loop",
    "riptide_tpu_torch/search/peaks_device.py::queue_find_peaks":
        "the peak program",
}


def _reachable(project, roots):
    """:meth:`~.core.ProjectContext.reachable` over ``"call"`` edges,
    over function references passed as call arguments, over calls of a
    function nested in the caller, and over unresolved ``x._name(...)``
    calls of a private method that exactly one class of the project
    defines."""
    private = {}
    for fqn, info in project.functions.items():
        leaf = info.qual.rsplit(".", 1)[-1]
        if "." in info.qual and leaf.startswith("_") \
                and not leaf.startswith("__"):
            private.setdefault(leaf, []).append(fqn)
    parents = {r: None for r in roots if r in project.functions}
    frontier = list(parents)
    while frontier:
        cur = frontier.pop()
        info = project.functions[cur]
        owner = info.qual.split(".")[0] if "." in info.qual else None
        nxt = [c for _, c, k in info.calls if k == "call"]
        for node in walk_own(info.node):
            if isinstance(node, ast.Call):
                f = node.func
                nested = (f"{info.relpath}::{info.qual}.{f.id}"
                          if isinstance(f, ast.Name) else None)
                if nested in project.functions:
                    nxt.append(nested)
                elif isinstance(f, ast.Attribute) \
                        and project.callee(node) is None \
                        and len(private.get(f.attr, ())) == 1:
                    nxt.append(private[f.attr][0])
                for arg in node.args:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        ref = project._resolve_callable_ref(
                            info.relpath, owner, {}, arg)
                        if ref is not None:
                            nxt.append(ref)
        for callee in nxt:
            if callee not in parents:
                parents[callee] = cur
                frontier.append(callee)
    return parents


class InterpHostSyncAnalyzer(Analyzer):
    rule = "RIP011"
    name = "interp-host-sync"
    description = ("no host synchronisation anywhere reachable from the "
                   "stage loop or the peak program through the project "
                   "call graph")
    needs_project = True

    def __init__(self, roots=None, hot_functions=None):
        self.roots = ROOTS if roots is None else roots
        self.hot_functions = (HOT_FUNCTIONS if hot_functions is None
                              else hot_functions)

    def run_project(self, project):
        findings = []
        for fqn in sorted(self.roots):
            if fqn not in project.functions:
                rel, _, qual = fqn.partition("::")
                findings.append(Finding(
                    rel, 1, 0, self.rule,
                    f"queue-path root {qual!r} not found — the "
                    "interp-host-sync root list (analysis/lint/"
                    "interp_host_sync.py ROOTS) is stale; update it or "
                    "the queue path goes unchecked"))
        owned = {f"{rel}::{q}" for rel, quals in self.hot_functions.items()
                 for q in quals}
        parents = _reachable(project, self.roots)
        for fqn in sorted(parents):
            if fqn in self.roots or fqn in owned:
                continue
            info = project.functions[fqn]
            ctx = project.context_of(fqn)
            chain = project.witness_path(parents, fqn)
            root_fqn = fqn
            while parents.get(root_fqn) is not None:
                root_fqn = parents[root_fqn]
            where = (f"`{info.qual}`, reachable from "
                     f"{self.roots[root_fqn]} `"
                     f"{project.functions[root_fqn].qual}` via "
                     + " -> ".join(chain))
            # walk_own: a nested def inside a reachable helper is its
            # own FunctionInfo, flagged only if itself reachable.
            for node in walk_own(info.node):
                if not isinstance(node, ast.Call):
                    continue
                reason = sync_reason(node, casts=False)
                if reason is not None:
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"{reason} inside {where} — the pull is "
                        "invisible to RIP001's body scan but still "
                        "stalls the queue; hoist it to the collect side"))
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings
