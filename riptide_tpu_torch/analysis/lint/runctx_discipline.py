"""
RIP012 — runctx thread discipline over the whole-program call graph
(the port's copy of the JAX package's rule).

The run-context layer (``utils/runctx.py``) carries a job's incident
sink, status provider and storage-fault flags in a thread-local; every
incident is context-routed so a multi-tenant daemon never mixes two
jobs' journals. That property dies silently the moment a
thread is started whose target neither went through ``runctx.wrap``
(which captures the spawning thread's context and re-installs it in
the child) nor establishes its own context via ``install``/
``activate`` — every ``incidents.emit`` under that thread falls back
to the process-global sink. ripsched's ``runctx`` model demonstrates
the failure dynamically (mutation ``unwrapped_worker``); this rule
pins the code shape statically:

* **prong 1 (scheduler/serve scope)**: a ``Thread(target=...)`` /
  ``executor.submit(fn, ...)`` site inside — or reachable from — the
  serve/survey planes whose resolved target is neither wrapped nor a
  context-establishing function;
* **prong 2 (anywhere)**: same shape, when the unwrapped target can
  additionally reach ``incidents.emit`` over plain call edges — the
  exact route by which a record escapes its job's journal.

Resolution is conservative (the :class:`ProjectContext` contract):
an unresolvable target contributes no finding. Alias forms are
understood per function — ``h = runctx.wrap(fn)`` marks ``h``
compliant, ``h = self._stage`` makes ``submit(h, ...)`` a finding
exactly like ``submit(self._stage, ...)``.
"""
import ast

from .core import Analyzer, Finding, dotted, walk_own

__all__ = ["RunctxDisciplineAnalyzer", "SCOPE_PREFIXES", "WRAP_FQN",
           "ESTABLISH_FQNS", "EMIT_FQN"]

# The planes whose thread spawns must carry a job context (prong 1):
# everything the daemon multiplexes between tenants.
SCOPE_PREFIXES = ("riptide_tpu_torch/serve/", "riptide_tpu_torch/survey/")

WRAP_FQN = "riptide_tpu_torch/utils/runctx.py::wrap"
# A target that (transitively) installs/activates its OWN context is
# compliant without wrap() — the daemon's per-job worker idiom.
ESTABLISH_FQNS = (
    "riptide_tpu_torch/utils/runctx.py::install",
    "riptide_tpu_torch/utils/runctx.py::activate",
)
EMIT_FQN = "riptide_tpu_torch/survey/incidents.py::emit"


def _reverse_reachable(project, roots, kinds=("call",)):
    """Every fqn from which one of ``roots`` is reachable over edges of
    the given kinds (roots included when defined)."""
    rev = {}
    for info in project.functions.values():
        for _, callee, kind in info.calls:
            if kind in kinds:
                rev.setdefault(callee, set()).add(info.fqn)
    seen = {r for r in roots if r in project.functions}
    frontier = list(seen)
    while frontier:
        cur = frontier.pop()
        for caller in rev.get(cur, ()):
            if caller not in seen:
                seen.add(caller)
                frontier.append(caller)
    return seen


def _spawn_sites(fn_node):
    """``(call_node, target_expr)`` for every thread-of-execution
    handoff in a function's own body — the same leaf-name shapes the
    call-graph builder turns into "thread" edges."""
    for node in walk_own(fn_node):
        if not isinstance(node, ast.Call):
            continue
        leaf = (dotted(node.func) or "").split(".")[-1]
        if leaf == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    yield node, kw.value
        elif leaf == "submit" and node.args:
            yield node, node.args[0]


class RunctxDisciplineAnalyzer(Analyzer):
    rule = "RIP012"
    name = "runctx-discipline"
    description = ("threads spawned from the serve/survey planes carry "
                   "a run context (runctx.wrap-ed target or a target "
                   "that installs its own), and no thread without a "
                   "context route can reach incidents.emit")
    needs_project = True

    def run_project(self, project):
        findings = []
        establish = _reverse_reachable(project, ESTABLISH_FQNS)
        emits = _reverse_reachable(project, (EMIT_FQN,))
        scope_roots = [fqn for fqn, info in project.functions.items()
                       if info.relpath.startswith(SCOPE_PREFIXES)]
        in_scope = set(project.reachable(scope_roots,
                                         kinds=("call", "thread")))

        for info in project.functions.values():
            owner = (info.qual.split(".")[0] if "." in info.qual
                     else None)
            # Per-function alias tables: handles bound by a SINGLE
            # plain assignment (`h = runctx.wrap(fn)` / `h = fn` /
            # `h = self._meth`) — the shapes the repo actually spawns.
            wrap_aliases = set()
            plain_aliases = {}
            for sub in walk_own(info.node):
                if not (isinstance(sub, ast.Assign)
                        and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Name)):
                    continue
                tgt = sub.targets[0].id
                if isinstance(sub.value, ast.Call) \
                        and project.callee(sub.value) == WRAP_FQN:
                    wrap_aliases.add(tgt)
                    plain_aliases.pop(tgt, None)
                    continue
                ref = project._resolve_callable_ref(
                    info.relpath, owner, {}, sub.value)
                if ref is not None:
                    plain_aliases[tgt] = ref
                    wrap_aliases.discard(tgt)

            for call, target in _spawn_sites(info.node):
                # Wrapped forms are compliant: a direct
                # runctx.wrap(...) argument, or a wrap-alias name.
                if isinstance(target, ast.Call) \
                        and project.callee(target) == WRAP_FQN:
                    continue
                if isinstance(target, ast.Name) \
                        and target.id in wrap_aliases:
                    continue
                if isinstance(target, ast.Name) \
                        and target.id in plain_aliases:
                    tgt_fqn = plain_aliases[target.id]
                else:
                    tgt_fqn = project._resolve_callable_ref(
                        info.relpath, owner, {}, target)
                if tgt_fqn is None or tgt_fqn in establish:
                    continue
                tgt_qual = project.functions[tgt_fqn].qual
                ctx = project.by_rel[info.relpath]
                if tgt_fqn in emits:
                    findings.append(Finding.at(
                        ctx, call, self.rule,
                        f"thread target {tgt_qual!r} is not "
                        "runctx.wrap-ed yet reaches incidents.emit "
                        "(via "
                        + " -> ".join(project.witness_path(
                            project.reachable([tgt_fqn]), EMIT_FQN))
                        + ") — its incidents land in the "
                        "process-global sink, not the job's journal"))
                elif info.fqn in in_scope:
                    findings.append(Finding.at(
                        ctx, call, self.rule,
                        f"thread target {tgt_qual!r} spawned from the "
                        "serve/survey plane without runctx.wrap (and "
                        "it does not install/activate its own "
                        "context) — wrap it or establish a context "
                        "inside it"))
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings
