"""
RIP003 — env-flag hygiene (the port's copy of the JAX package's rule).

Every ``RIPTIDE_*`` environment read inside the port must resolve
through its typed registry (``riptide_tpu_torch/utils/envflags.py``):
one place declares the name, type, default and documentation, so a
typo'd flag raises instead of silently doing nothing and the operator
surface is enumerable. The analyzer enforces three properties:

* **no raw reads** — ``os.environ`` / ``os.getenv`` access with a
  ``RIPTIDE_*`` key anywhere in ``riptide_tpu_torch/`` except
  envflags.py itself;
* **no unknown flags** — every ``envflags.get(...)`` of a flag-name
  literal in package code must name a registered flag;
* **no stale entries** — every registry entry must still be read
  somewhere: in the package or on its out-of-package surfaces
  (``core.SURFACES``: ``chip_smoke.py`` and ``tests/test_torch_*.py``);
  a flag nothing reads is dead configuration surface.

It also fails when the port's flag reference
(``riptide_tpu_torch/analysis/env_flags.md``) drifts from the
registry's ``render_markdown()`` (regenerate with ``python -m
riptide_tpu_torch.apps.riplint --write-env-docs``).
"""
import ast
import importlib.util
import os
import re

from .core import Analyzer, Finding, dotted, surface_files

__all__ = ["EnvFlagAnalyzer", "load_registry"]

REGISTRY_REL = "riptide_tpu_torch/utils/envflags.py"
DOCS_REL = "riptide_tpu_torch/analysis/env_flags.md"

_TOKEN = re.compile(r"RIPTIDE_[A-Z0-9_]+")


def load_registry(repo):
    """The port's envflags module, loaded standalone by file path (no
    torch, no riptide_tpu_torch/__init__)."""
    path = os.path.join(repo, REGISTRY_REL)
    spec = importlib.util.spec_from_file_location(
        "riptide_tpu_torch_envflags_standalone", path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env_read_key(node):
    """The RIPTIDE_* key of a raw environment read, or None.

    Matches ``os.environ.get(K, ...)``, ``os.environ[K]``,
    ``os.environ.pop(K, ...)``, ``os.getenv(K, ...)`` and the same via
    ``environ`` imported bare."""
    key_node = None
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        if name in ("os.environ.get", "environ.get", "os.environ.pop",
                    "environ.pop", "os.environ.setdefault",
                    "environ.setdefault", "os.getenv", "getenv"):
            if node.args:
                key_node = node.args[0]
    elif isinstance(node, ast.Subscript):
        base = dotted(node.value) or ""
        if base in ("os.environ", "environ"):
            key_node = node.slice
            if isinstance(key_node, ast.Index):  # py3.8 compat
                key_node = key_node.value
    if isinstance(key_node, ast.Constant) and isinstance(key_node.value,
                                                         str):
        if key_node.value.startswith("RIPTIDE_"):
            return key_node.value
    return None


class EnvFlagAnalyzer(Analyzer):
    rule = "RIP003"
    name = "env-flags"
    description = ("every RIPTIDE_* read routes through the typed "
                   "utils/envflags.py registry; stale entries and docs "
                   "drift are errors")

    def run(self, ctx):
        if ctx.relpath == REGISTRY_REL:
            return []
        findings = []
        known = None
        for node in ast.walk(ctx.tree):
            key = _env_read_key(node)
            if key is not None:
                findings.append(Finding.at(
                    ctx, node, self.rule,
                    f"raw environment read of {key!r} — route it through "
                    "riptide_tpu_torch.utils.envflags.get() so the flag "
                    "is "
                    "typed, documented and enumerable",
                ))
                continue
            # envflags.get with an unregistered flag name.
            if isinstance(node, ast.Call):
                name = dotted(node.func) or ""
                if name.split(".")[-1] == "get" \
                        and "envflags" in name and node.args:
                    a = node.args[0]
                    if isinstance(a, ast.Constant) \
                            and isinstance(a.value, str) \
                            and a.value.startswith("RIPTIDE_"):
                        if known is None:
                            known = set(
                                load_registry(ctx.repo).FLAGS
                            )
                        if a.value not in known:
                            findings.append(Finding.at(
                                ctx, node, self.rule,
                                f"unregistered flag {a.value!r} — declare "
                                "it in riptide_tpu_torch/utils/envflags.py "
                                "(envflags.get would raise KeyError at "
                                "runtime)",
                            ))
        return findings

    def finalize(self, repo, contexts):
        findings = []
        try:
            registry = load_registry(repo)
        except Exception as err:  # registry must always import clean
            return [Finding(REGISTRY_REL, 1, 0, self.rule,
                            f"failed to load the flag registry: {err}")]

        # -- stale-entry detection ------------------------------------
        usage = set()
        for ctx in contexts:
            if ctx.relpath != REGISTRY_REL:
                usage.update(_TOKEN.findall(ctx.source))
        for rel in surface_files(repo):
            try:
                with open(os.path.join(repo, rel), errors="replace") as fobj:
                    usage.update(_TOKEN.findall(fobj.read()))
            except OSError:
                continue
        with open(os.path.join(repo, REGISTRY_REL)) as fobj:
            reg_src = fobj.read().splitlines()
        for name in registry.FLAGS:
            if name not in usage:
                line = next(
                    (i + 1 for i, t in enumerate(reg_src) if name in t), 1
                )
                findings.append(Finding(
                    REGISTRY_REL, line, 0, self.rule,
                    f"stale registry entry {name!r}: no read anywhere in "
                    "the port, chip_smoke.py or its tests — delete the "
                    "entry or the dead flag's documentation lies",
                ))

        # -- docs drift ------------------------------------------------
        docs_path = os.path.join(repo, DOCS_REL)
        want = registry.render_markdown()
        have = None
        if os.path.exists(docs_path):
            with open(docs_path) as fobj:
                have = fobj.read()
        if have != want:
            findings.append(Finding(
                DOCS_REL, 1, 0, self.rule,
                f"{DOCS_REL} is out of sync with the envflags.py "
                "registry — regenerate with `python -m "
                "riptide_tpu_torch.apps.riplint --write-env-docs`",
            ))
        return findings
