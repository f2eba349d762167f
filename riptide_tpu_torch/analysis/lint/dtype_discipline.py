"""
RIP002 — dtype discipline in the numeric core, in its torch form.

The port's numerics rest on the JAX package's two dtype rules: sample
data is float32, accumulators (prefix sums, downsample reductions) are
named explicitly, and nothing may silently promote through numpy's
float64 default or torch's default dtype. The checks are scoped to the
numeric core (``ops/`` and the engine/peaks device paths, :data:`SCOPE`)
where a silent dtype change is a *wrong numbers* bug, not a style issue:

* tensor creation (``torch.zeros`` / ``ones`` / ``empty`` / ``full`` /
  ``arange`` / ``tensor`` / ``as_tensor``) must pass ``dtype=`` (or
  ``out=``). In torch ``dtype`` is keyword-only and the sizes are
  positional, so the JAX rule's positional count would pass
  ``torch.zeros(3, 4)``: the torch form wants the keyword;
* numpy creation (``zeros`` / ``ones`` / ``empty`` / ``full``) must
  name its dtype, positionally or by keyword, as in the JAX rule;
* ``cumsum`` (the accumulator primitive: ``torch.cumsum``,
  ``np.cumsum`` or a tensor's ``.cumsum``) must pass ``dtype=`` or
  ``out=`` — the accumulator rule made explicit at every site.
"""
import ast

from .core import Analyzer, Finding

__all__ = ["DtypeDisciplineAnalyzer", "SCOPE", "SCOPE_PREFIXES"]

SCOPE_PREFIXES = ("riptide_tpu_torch/ops/",)
SCOPE = {
    "riptide_tpu_torch/search/engine.py",
    "riptide_tpu_torch/search/peaks_device.py",
}

_TORCH_CREATE = {"zeros", "ones", "empty", "full", "arange", "tensor",
                 "as_tensor"}
# numpy: the positional argument count that reaches the dtype.
_NP_CREATE_MIN_ARGS = {"zeros": 2, "ones": 2, "empty": 2, "full": 3}
_NP_NAMES = {"np", "numpy"}


def _has_kw(node, names=("dtype", "out")):
    return any(kw.arg in names for kw in node.keywords)


class DtypeDisciplineAnalyzer(Analyzer):
    rule = "RIP002"
    name = "dtype-discipline"
    description = ("float64 accumulator rule and explicit dtypes in the "
                   "numeric core (ops/ and the engine/peaks paths): "
                   "torch creators and cumsum name dtype= by keyword")

    def __init__(self, scope=None, scope_prefixes=None):
        self.scope = SCOPE if scope is None else scope
        self.scope_prefixes = (SCOPE_PREFIXES if scope_prefixes is None
                               else scope_prefixes)
        self._seen_modules = set()

    def begin(self, repo):
        self._seen_modules = set()

    def finalize(self, repo, contexts):
        """Staleness guard on the explicitly-listed scope modules (the
        prefix scopes track directory moves on their own)."""
        return [
            Finding(rel, 1, 0, self.rule,
                    "scoped numeric-core module missing from the "
                    "package — the dtype-discipline scope list "
                    "(analysis/lint/dtype_discipline.py SCOPE) is stale; "
                    "update it")
            for rel in sorted(set(self.scope) - self._seen_modules)
        ]

    def _in_scope(self, relpath):
        return relpath in self.scope or any(
            relpath.startswith(p) for p in self.scope_prefixes
        )

    def run(self, ctx):
        if not self._in_scope(ctx.relpath):
            return []
        if ctx.relpath in self.scope:
            self._seen_modules.add(ctx.relpath)
        findings = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            f = node.func
            attr = f.attr
            mod = f.value.id if isinstance(f.value, ast.Name) else None
            if mod == "torch" and attr in _TORCH_CREATE:
                if not _has_kw(node):
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"`torch.{attr}` without `dtype=` in the numeric "
                        "core — torch's default dtype decides otherwise; "
                        "name the dtype (keyword-only in torch) so the "
                        "float32-data/accumulator split is visible at "
                        "the call site"))
            elif mod in _NP_NAMES and attr in _NP_CREATE_MIN_ARGS:
                if len(node.args) < _NP_CREATE_MIN_ARGS[attr] \
                        and not _has_kw(node):
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"`{mod}.{attr}` without an explicit dtype in the "
                        "numeric core — numpy defaults to float64; name "
                        "the dtype"))
            elif attr == "cumsum":
                if not _has_kw(node):
                    what = f"{mod}.cumsum" if mod in _NP_NAMES | {"torch"} \
                        else ".cumsum"
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"`{what}` without `dtype=`/`out=` — the "
                        "accumulator rule must be explicit at every "
                        "reduction site"))
        return findings
