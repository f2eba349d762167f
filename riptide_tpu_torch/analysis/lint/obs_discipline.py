"""
RIP008 — obs (tracing) discipline, in its torch form.

The span tracer is threaded through every hot path of the survey
pipeline, so its misuse modes are throughput or correctness bugs:

* **span() only as a context manager** — a ``span(...)`` call that is
  not the context expression of a ``with`` statement risks a manual
  ``__enter__`` without a guaranteed ``__exit__``, which leaks the
  per-thread span stack entry and corrupts nesting for every later
  span on that thread;
* **no tracing inside a wrapper's launch sequence** — the functions
  that go from a wrapper's checks to its kernel launches
  (:data:`LAUNCH_SEQUENCE`: ``ops/ffa_kernel.py``'s ``_stage``,
  ``_levels`` and ``_snr``, ``probes/common.py::_launch``, and the
  module functions they call). A span there times the ctypes call, not
  the kernel, and adds host work between launches that the card's
  queue waits on; device time is the CUDA events' and the profiler's;
* **every observability flag is registered** — ``RIPTIDE_TRACE_*`` /
  ``RIPTIDE_PROM_*``-family tokens in package sources must name
  entries of the port's typed ``utils/envflags.py`` registry (RIP003
  polices reads; this closes the gap for names that only appear in
  docs strings or are read through indirection).

``riptide_tpu_torch/obs/trace.py`` itself is exempt: it *implements*
the span protocol (``Span.__enter__``/``__exit__`` live there by
definition).
"""
import ast
import re

from .core import Analyzer, Finding, dotted, walk_functions
from .env_flags import REGISTRY_REL, load_registry

__all__ = ["ObsDisciplineAnalyzer", "LAUNCH_SEQUENCE"]

# The module that implements the span protocol (and may therefore
# mention manual enter/exit) — everything else must follow the rules.
_EXEMPT = ("riptide_tpu_torch/obs/trace.py",)

# relpath -> the functions of a wrapper's launch sequence.
LAUNCH_SEQUENCE = {
    "riptide_tpu_torch/ops/ffa_kernel.py": ("_stage", "_levels", "_snr"),
    "riptide_tpu_torch/probes/common.py": ("_launch",),
}

# Tracing entry points that must never run inside a launch sequence.
_TRACE_CALLS = {"span", "get_tracer", "enable", "disable"}

# A token ending in "_" is a docs-string wildcard ("RIPTIDE_TRACE_*"),
# not a flag name.
_OBS_TOKEN = re.compile(r"RIPTIDE_(?:TRACE|PROM)[A-Z0-9_]*")


def _span_calls(tree):
    """Every Call node whose callee leaf-name is ``span``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            if name.split(".")[-1] == "span":
                yield node


def _with_context_exprs(tree):
    """ids of every ``with``-item context expression in the module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                out.add(id(item.context_expr))
    return out


def _launch_sequence_functions(ctx, roots):
    """{qual: FunctionDef} of the launch-sequence ``roots`` of one
    module and every module function reachable from them by name."""
    by_leaf = {}
    for qual, fn in walk_functions(ctx.tree):
        by_leaf.setdefault(qual.split(".")[-1], (qual, fn))
    reach = {}
    frontier = [r for r in roots if r in by_leaf]
    while frontier:
        qual, fn = by_leaf[frontier.pop()]
        if qual in reach:
            continue
        reach[qual] = fn
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = (dotted(node.func) or "").split(".")[-1]
                if callee in by_leaf and by_leaf[callee][0] not in reach:
                    frontier.append(callee)
    return reach


class ObsDisciplineAnalyzer(Analyzer):
    rule = "RIP008"
    name = "obs-discipline"
    description = ("span() only as a context manager, no tracing calls "
                   "inside a wrapper's launch sequence, every "
                   "RIPTIDE_TRACE_*/RIPTIDE_PROM_* flag registered")

    def __init__(self, launch_sequence=None):
        self.launch_sequence = (LAUNCH_SEQUENCE if launch_sequence is None
                                else launch_sequence)
        self._registry_flags = None
        self._seen = {}

    def begin(self, repo):
        self._registry_flags = None
        self._seen = {}

    def finalize(self, repo, contexts):
        """Staleness guard on the launch-sequence list: a renamed
        wrapper function must fail loudly, not silently unscope it."""
        out = []
        for rel, names in sorted(self.launch_sequence.items()):
            seen = self._seen.get(rel, set())
            for name in sorted(set(names) - seen):
                out.append(Finding(
                    rel, 1, 0, self.rule,
                    f"launch-sequence function {name!r} not found — the "
                    "obs-discipline scope list (analysis/lint/"
                    "obs_discipline.py LAUNCH_SEQUENCE) is stale; "
                    "update it"))
        return out

    def _flags(self, repo):
        if self._registry_flags is None:
            try:
                self._registry_flags = set(load_registry(repo).FLAGS)
            except Exception:
                # RIP003 reports a broken registry; don't double up.
                self._registry_flags = frozenset()
        return self._registry_flags

    def run(self, ctx):
        if ctx.relpath in self.launch_sequence:
            self._seen[ctx.relpath] = {q.split(".")[-1] for q, _
                                       in walk_functions(ctx.tree)}
        if ctx.relpath in _EXEMPT:
            return []
        findings = []

        # -- span() must be a with-item ---------------------------------
        as_context = _with_context_exprs(ctx.tree)
        flagged = set()
        for call in _span_calls(ctx.tree):
            if id(call) not in as_context:
                flagged.add(id(call))
                findings.append(Finding.at(
                    ctx, call, self.rule,
                    "`span(...)` used outside a `with` statement — a "
                    "manual __enter__ without a guaranteed __exit__ "
                    "leaks the per-thread span stack; write "
                    "`with span(...):`",
                ))

        # -- no tracing inside a wrapper's launch sequence --------------
        for qual, fn in sorted(_launch_sequence_functions(
                ctx, self.launch_sequence.get(ctx.relpath, ())).items()):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in flagged:
                    continue
                name = dotted(node.func) or ""
                if name.split(".")[-1] in _TRACE_CALLS:
                    flagged.add(id(node))
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"tracing call `{name}` inside the launch "
                        f"sequence `{qual}` — spans time host-side "
                        "phases only; between a wrapper's checks and "
                        "its launches a span times the ctypes call, "
                        "not the kernel (device time is the CUDA "
                        "events' and the profiler's job)",
                    ))

        # -- observability flag tokens must be registered ----------------
        if ctx.relpath != REGISTRY_REL:
            flags = self._flags(ctx.repo)
            seen_lines = set()
            for m in _OBS_TOKEN.finditer(ctx.source):
                token = m.group(0)
                if token.endswith("_") or token in flags:
                    continue
                line = ctx.source.count("\n", 0, m.start()) + 1
                if (token, line) in seen_lines:
                    continue
                seen_lines.add((token, line))
                findings.append(Finding(
                    ctx.relpath, line, 0, self.rule,
                    f"observability flag {token!r} is not in the "
                    "port's utils/envflags.py registry — declare it "
                    "(type, default, help) so the tracing/exposition "
                    "surface stays enumerable",
                ))
        return findings
