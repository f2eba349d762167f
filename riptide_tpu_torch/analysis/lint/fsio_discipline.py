"""
RIP013 — fsio write discipline in the persistence-bearing planes (the
port's copy of the JAX package's rule).

The port routes every durable artifact (journal, peaks, ledger,
heartbeats, status sidecars) through ``utils/fsio.py`` — fsync'd
atomic replace, CRC framing, torn-tail healing — and the chaos
campaign proves byte-identical recovery through kills at every
persistence site. A direct ``open(..., "w")``/``os.replace``/
``os.write`` added later to survey/obs/serve quietly re-opens the
torn-write window the whole layer exists to close, and nothing fails
until a kill lands in it. This rule pins the discipline: inside
``riptide_tpu_torch/{survey,obs,serve}/`` every raw write-mode ``open``
(mode literal containing ``w``/``a``/``x``), ``os.replace`` and
``os.write`` is a finding. ``utils/fsio.py`` itself lives outside
the scoped planes; ``survey/chaos.py`` is exempt by construction —
the fault-injection harness deliberately writes raw and torn bytes
to prove the readers heal them.
"""
import ast

from .core import Analyzer, Finding, dotted

__all__ = ["FsioDisciplineAnalyzer", "SCOPE_PREFIXES", "EXEMPT"]

SCOPE_PREFIXES = ("riptide_tpu_torch/survey/", "riptide_tpu_torch/obs/",
                  "riptide_tpu_torch/serve/")
# The chaos harness writes raw/truncated/corrupt bytes ON PURPOSE —
# its whole job is producing the torn artifacts fsio must survive.
EXEMPT = ("riptide_tpu_torch/survey/chaos.py",)

_WRITE_MODES = frozenset("wax")


def _write_mode_literal(call):
    """The mode string of an ``open``/``io.open`` call when it is a
    literal selecting a write mode, else None (a non-literal mode is
    not flagged — conservative, like the rest of the framework)."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and (_WRITE_MODES & set(mode.value)):
        return mode.value
    return None


class FsioDisciplineAnalyzer(Analyzer):
    rule = "RIP013"
    name = "fsio-discipline"
    description = ("survey/obs/serve write durable bytes only through "
                   "utils/fsio.py — no raw write-mode open(), "
                   "os.replace or os.write in the persistence planes")

    def run(self, ctx):
        if not ctx.relpath.startswith(SCOPE_PREFIXES) \
                or ctx.relpath in EXEMPT:
            return []
        findings = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name in ("open", "io.open"):
                mode = _write_mode_literal(node)
                if mode is not None:
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"raw open(..., {mode!r}) in the persistence "
                        "plane — route through utils/fsio.py "
                        "(atomic_write_text/atomic_write_bytes/"
                        "append_framed) so a kill cannot tear the "
                        "artifact"))
            elif name in ("os.replace", "os.write"):
                findings.append(Finding.at(
                    ctx, node, self.rule,
                    f"raw {name}() in the persistence plane — "
                    "utils/fsio.py owns replace/fd writes (fsync "
                    "ordering, CRC framing); call its helpers "
                    "instead"))
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings
