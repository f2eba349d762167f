"""
riplint framework core (the port's copy of the JAX package's
``riptide_tpu/analysis/core.py``): module contexts, findings,
suppressions, baseline handling and the runner loop shared by every
analyzer.

Design constraints:

* importable with the standard library alone: no torch, no numpy and
  not the ``riptide_tpu_torch`` package ``__init__`` (the runner loads
  this package standalone by file path, so the lint runs on a machine
  with neither);
* one ``ast.parse`` per module, shared by all analyzers;
* suppression is explicit and reviewable — either an inline
  ``# riplint: disable=RIPxxx`` pragma on the flagged line, or a
  baseline entry in ``riptide_tpu_torch/analysis/riplint_baseline.json``
  carrying a one-line justification. Baseline entries match on (rule,
  path, stripped source-line text), so they survive unrelated line
  moves but die with the code they describe — a stale entry fails the
  run.
"""
import ast
import fnmatch
import json
import os
import re
from dataclasses import dataclass, field

__all__ = [
    "Analyzer", "Baseline", "Finding", "FunctionInfo", "ModuleContext",
    "PACKAGE", "ProjectContext", "SURFACES", "collect_contexts",
    "run_analyzers", "surface_files",
]

# The package the rules walk, and the files outside it that they read
# as well (RIP003's flag usage): the smoke script of the card and the
# port's own tests. The JAX package's tools/ are never part of it.
PACKAGE = "riptide_tpu_torch"
SURFACES = ("chip_smoke.py", "tests/test_torch_*.py")

# How far the baseline's staleness check looks around a finding for an
# entry's line text (see Baseline.matches): an unrelated same-file edit
# that reflows a wrapped statement moves the flagged line a little
# without changing the code the entry justified.
BASELINE_NEARBY_LINES = 3


@dataclass
class Finding:
    """One rule violation at a source location (1-based line, 0-based
    column, GitHub-annotation rendering)."""

    path: str      # repo-relative, forward slashes
    line: int
    col: int
    rule: str
    message: str

    def gh(self):
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    @classmethod
    def at(cls, ctx, node, rule, message):
        return cls(ctx.relpath, getattr(node, "lineno", 1),
                   getattr(node, "col_offset", 0), rule, message)


class ModuleContext:
    """One parsed module: path, source, lines and AST, shared by every
    analyzer (parse once)."""

    def __init__(self, repo, relpath):
        self.repo = repo
        self.relpath = relpath.replace(os.sep, "/")
        self.path = os.path.join(repo, relpath)
        with open(self.path) as fobj:
            self.source = fobj.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.path)

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class Analyzer:
    """Base analyzer: subclass, set ``rule``/``name``/``description``,
    implement :meth:`run` (per module) and optionally :meth:`finalize`
    (whole-package checks, after every module ran). Analyzers that set
    ``needs_project = True`` additionally receive the shared
    :class:`ProjectContext` (name-resolved call graph) through
    :meth:`run_project` — built once per run, lazily, so per-file
    analyzers never pay for it."""

    rule = None
    name = None
    description = ""
    needs_project = False

    def begin(self, repo):
        """Reset per-run state. Called by :func:`run_analyzers` before
        the module sweep so a reused *instance* (tests pass instances
        to inject config) cannot leak accumulated state — e.g. a
        wrapped-call counter — from a previous run into a later one."""

    def run(self, ctx):
        """Findings for one :class:`ModuleContext`."""
        return []

    def run_project(self, project):
        """Findings from the whole-program view (only called when
        ``needs_project`` is set)."""
        return []

    def finalize(self, repo, contexts):
        """Findings that need the whole package (vacuous-lint guards,
        registry staleness, docs drift)."""
        return []


_PRAGMA = re.compile(r"#\s*riplint:\s*disable=([A-Za-z0-9_,\s]*)")


def is_suppressed(finding, ctx):
    """True when the flagged line carries an inline
    ``# riplint: disable=RIPxxx[,RIPyyy]`` (or ``disable=all``)
    pragma."""
    m = _PRAGMA.search(ctx.line_text(finding.line))
    if not m:
        return False
    rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return "all" in rules or finding.rule in rules


class Baseline:
    """Checked-in allowlist of intentional findings.

    JSON schema: ``{"entries": [{"rule", "path", "line_text", "why"},
    ...]}``. A finding is baselined when an entry's (rule, path,
    stripped line_text) matches it; entries that match nothing are
    STALE and fail the run (the code they justified is gone — delete
    or update them)."""

    def __init__(self, entries=(), path=None):
        self.entries = [dict(e) for e in entries]
        self.path = path
        self._used = [False] * len(self.entries)

    @classmethod
    def load(cls, path):
        if not os.path.exists(path):
            return cls(path=path)
        with open(path) as fobj:
            data = json.load(fobj)
        entries = data.get("entries", [])
        for e in entries:
            for k in ("rule", "path", "line_text", "why"):
                if k not in e:
                    raise ValueError(
                        f"{path}: baseline entry missing {k!r}: {e}"
                    )
        return cls(entries, path=path)

    def matches(self, finding, ctx):
        """True when an entry exactly matches ``finding``'s (rule,
        path, stripped line text at the finding's line)."""
        text = ctx.line_text(finding.line).strip()
        hit = False
        for i, e in enumerate(self.entries):
            if (e["rule"] == finding.rule and e["path"] == finding.path
                    and e["line_text"].strip() == text):
                self._used[i] = True
                hit = True
        return hit

    def matches_nearby(self, finding, ctx):
        """Reflow fallback, tried only AFTER every finding had its
        exact-match chance: an otherwise-UNUSED entry absorbs the
        finding when (a) its text survives within
        ``BASELINE_NEARBY_LINES`` of it (same rule + path) AND (b) the
        finding's own line text is a fragment of the entry's (or vice
        versa) — a wrapped statement's flagged line shifts a little
        under an unrelated reflow, but the flagged fragment still
        belongs to the justified statement. Both restrictions exist to
        keep the fuzz from swallowing a genuinely NEW violation that
        merely lands near a baselined one (its text is unrelated to
        the entry's, and the baselined line's own exact match marks
        the entry used)."""
        ftext = ctx.line_text(finding.line).strip()
        hit = False
        for i, e in enumerate(self.entries):
            if self._used[i] or e["rule"] != finding.rule \
                    or e["path"] != finding.path:
                continue
            etext = e["line_text"].strip()
            if not etext or not ftext:
                continue
            if ftext not in etext and etext not in ftext:
                continue
            if any(
                ctx.line_text(n).strip() == etext
                for n in range(finding.line - BASELINE_NEARBY_LINES,
                               finding.line + BASELINE_NEARBY_LINES + 1)
            ):
                self._used[i] = True
                hit = True
                break
        return hit

    def matches_pathonly(self, finding):
        """Match for findings outside the package (no ModuleContext,
        e.g. docs drift): an entry with an empty line_text on the same
        (rule, path). Marks the entry used so it does not read as
        stale."""
        hit = False
        for i, e in enumerate(self.entries):
            if (e["rule"] == finding.rule and e["path"] == finding.path
                    and e["line_text"].strip() == ""):
                self._used[i] = True
                hit = True
        return hit

    def stale_entries(self):
        return [e for i, e in enumerate(self.entries) if not self._used[i]]

    @staticmethod
    def entry_for(finding, ctx, why="TODO: justify"):
        return {
            "rule": finding.rule,
            "path": finding.path,
            "line_text": ctx.line_text(finding.line).strip(),
            "why": why,
        }

    def dump(self, path=None):
        path = path or self.path
        with open(path, "w") as fobj:
            json.dump({"entries": self.entries}, fobj, indent=2,
                      sort_keys=False)
            fobj.write("\n")


def surface_files(repo):
    """Repo-relative paths of the out-of-package :data:`SURFACES` that
    exist in ``repo``, sorted."""
    out = set()
    for pattern in SURFACES:
        head, _, name = pattern.rpartition("/")
        directory = os.path.join(repo, head)
        if not os.path.isdir(directory):
            continue
        for fname in os.listdir(directory):
            if fnmatch.fnmatch(fname, name) \
                    and os.path.isfile(os.path.join(directory, fname)):
                out.add(f"{head}/{fname}" if head else fname)
    return sorted(out)


def collect_contexts(repo, package=PACKAGE):
    """Parsed :class:`ModuleContext` for every ``.py`` module under
    ``repo/package``, in stable path order. ``_build/`` is the port's
    git-ignored scratch space (scripts a run writes there are not the
    package's sources)."""
    contexts = []
    root = os.path.join(repo, package)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fname), repo)
                contexts.append(ModuleContext(repo, rel))
    return contexts


def run_analyzers(repo, analyzers, baseline=None, contexts=None):
    """Run every analyzer over the package.

    Returns ``(new, baselined, stale)``: findings not covered by pragma
    or baseline, findings absorbed by the baseline, and stale baseline
    entries. ``analyzers`` holds classes or instances."""
    if contexts is None:
        contexts = collect_contexts(repo)
    baseline = baseline or Baseline()
    instances = [a() if isinstance(a, type) else a for a in analyzers]
    by_rel = {c.relpath: c for c in contexts}

    # The whole-program view is shared (and lazy): one call-graph build
    # feeds every project-level analyzer of the run.
    project = None

    pending = []
    for inst in instances:
        inst.begin(repo)
        found = []
        for ctx in contexts:
            found.extend(inst.run(ctx))
        if getattr(inst, "needs_project", False):
            if project is None:
                project = ProjectContext(repo, contexts)
            found.extend(inst.run_project(project))
        found.extend(inst.finalize(repo, contexts))
        for f in found:
            ctx = by_rel.get(f.path)
            if ctx is None or not is_suppressed(f, ctx):
                pending.append((f, ctx))

    # Exact baseline matching first for EVERY finding, then the
    # nearby-lines reflow fallback for the leftovers — the order is
    # what lets matches_nearby restrict itself to unused entries.
    new, baselined, leftover = [], [], []
    for f, ctx in pending:
        if ctx is not None and baseline.matches(f, ctx):
            baselined.append(f)
        # Findings outside the package (e.g. docs drift) can only be
        # baselined with an empty line_text match.
        elif ctx is None and baseline.matches_pathonly(f):
            baselined.append(f)
        else:
            leftover.append((f, ctx))
    for f, ctx in leftover:
        if ctx is not None and baseline.matches_nearby(f, ctx):
            baselined.append(f)
        else:
            new.append(f)
    new.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return new, baselined, baseline.stale_entries()


# -- small shared AST helpers -----------------------------------------------

def dotted(node):
    """Dotted-name string of a Name/Attribute chain (``torch.cuda.
    synchronize`` -> "torch.cuda.synchronize"), or None for anything
    else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node):
    """Dotted name of a call's callee, or None."""
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return None


def walk_functions(tree):
    """Yield every (async) function/method node with its qualified
    name ("Class.method" for methods)."""

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


def walk_own(fn):
    """Walk a function's body WITHOUT descending into nested (async)
    def bodies: those are separate :func:`walk_functions` entries (and
    separate :class:`FunctionInfo` nodes) whose code is deferred — a
    call made inside a nested def must not be attributed to the
    enclosing function's own execution. Lambda bodies ARE descended
    into: they have no FunctionInfo of their own, and the package's
    lambdas are invoked by the callee they are handed to in the same
    dynamic context (a timing helper, executor.map)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# -- whole-program call graph ------------------------------------------------

@dataclass
class FunctionInfo:
    """One function in the project call graph.

    ``fqn`` is ``"<relpath>::<qualname>"`` ("Class.method" quals for
    methods); ``calls`` holds ``(call_node, callee_fqn, kind)`` for
    every resolved outgoing edge, where ``kind`` is ``"call"`` for a
    plain invocation and ``"thread"`` for a target handed to another
    thread of execution (``Thread(target=...)``, ``executor.submit``) —
    thread edges transfer *reachability* but not held locks or an
    enclosing trace context."""

    fqn: str
    relpath: str
    qual: str
    node: object
    calls: list = field(default_factory=list)


def _module_name(relpath):
    """Dotted module name of a package-relative path
    ("riptide_tpu_torch/survey/journal.py" ->
    "riptide_tpu_torch.survey.journal")."""
    rel = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = rel.split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ProjectContext:
    """Whole-program view over one run's :class:`ModuleContext` set: a
    **name-resolved call graph** built from one extra pass, shared by
    every project-level analyzer.

    Resolution is deliberately conservative — an edge exists only when
    the callee is identified through an explicit binding, never by
    leaf-name coincidence:

    * module-level functions, by definition or ``import``/
      ``from ... import`` binding (relative imports resolved against
      the importing module's package position);
    * methods via ``self`` — ``self.meth()`` resolves within the
      enclosing class, and ``self.attr.meth()`` through the class's
      **self-attribute types** (``self.attr = SomeClass(...)``
      assignments anywhere in the class);
    * constructor calls (``SomeClass(...)`` -> ``SomeClass.__init__``),
      including through module-level instances (``_default =
      Registry()`` makes ``_default.add()`` resolve) and single-step
      local bindings (``x = SomeClass(...)`` then ``x.meth()``);
    * one level of **return-type inference**: a function whose returns
      are all a known class's constructor call (or a module variable of
      known class) types its call results, so ``get_metrics().add()``
      resolves to ``MetricsRegistry.add``;
    * thread targets: ``threading.Thread(target=f)`` and
      ``executor.submit(f, ...)`` add a ``"thread"``-kind edge to the
      resolved target.

    Unresolvable calls (dynamic dispatch, parameters of unknown type,
    stdlib/third-party callees) simply contribute no edge — analyzers
    on top of this graph trade recall for zero-alias precision.
    """

    def __init__(self, repo, contexts):
        self.repo = repo
        self.contexts = list(contexts)
        self.by_rel = {c.relpath: c for c in self.contexts}
        self.functions = {}      # fqn -> FunctionInfo
        self.classes = {}        # (relpath, class) -> {method names}
        self.attr_types = {}     # (relpath, class, attr) -> (relpath2, class2)
        self.var_types = {}      # (relpath, module var) -> (relpath2, class2)
        self.return_types = {}   # fqn -> (relpath2, class2)
        self._imports = {}       # relpath -> {local name: binding}
        self._modnames = {_module_name(c.relpath): c.relpath
                          for c in self.contexts}
        self._callee_by_node = {}
        self._collect_definitions()
        self._collect_imports()
        self._collect_types()
        self._resolve_calls()

    # -- construction passes ------------------------------------------------

    def _collect_definitions(self):
        for ctx in self.contexts:
            for qual, fn in walk_functions(ctx.tree):
                fqn = f"{ctx.relpath}::{qual}"
                self.functions[fqn] = FunctionInfo(fqn, ctx.relpath, qual,
                                                   fn)
                if "." in qual:
                    cls, meth = qual.rsplit(".", 1)
                    if "." not in cls:  # only top-level classes
                        self.classes.setdefault(
                            (ctx.relpath, cls), set()).add(meth)
            for node in ctx.tree.body:
                if isinstance(node, ast.ClassDef):
                    self.classes.setdefault((ctx.relpath, node.name), set())

    def _collect_imports(self):
        """Per-module binding table: local name -> ("module", relpath)
        or ("symbol", relpath, original name). Function-local imports
        (the deferred cycle-breaking idiom) are folded into the same
        table — a per-function table isn't worth its weight — but
        module-level (tree.body) imports are applied LAST so they win
        any name conflict: a deferred import may add bindings, never
        shadow the module's own."""
        for ctx in self.contexts:
            table = self._imports.setdefault(ctx.relpath, {})
            own_mod = _module_name(ctx.relpath)
            top = set(map(id, ctx.tree.body))
            nodes = sorted(
                (n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.Import, ast.ImportFrom))),
                key=lambda n: id(n) in top,
            )
            for node in nodes:
                if isinstance(node, ast.Import):
                    for a in node.names:
                        rel = self._modnames.get(a.name)
                        # `import a.b.c` (no asname) binds only the
                        # top-level name `a` in Python — binding it to
                        # the deepest module would resolve `a.<sym>`
                        # against the wrong namespace, so only the
                        # asname and single-component forms enter the
                        # table.
                        if rel and (a.asname or "." not in a.name):
                            table[a.asname or a.name] = ("module", rel)
                elif isinstance(node, ast.ImportFrom):
                    base = node.module or ""
                    if node.level:
                        parts = own_mod.split(".")
                        # level 1 = the containing package. For a
                        # plain module file that strips its own name;
                        # an __init__.py's dotted name already IS the
                        # package, so it strips one component fewer.
                        strip = node.level
                        if ctx.relpath.endswith("__init__.py"):
                            strip -= 1
                        if strip:
                            parts = parts[: len(parts) - strip]
                        base = ".".join(parts + ([base] if base else []))
                    for a in node.names:
                        local = a.asname or a.name
                        as_mod = self._modnames.get(
                            f"{base}.{a.name}" if base else a.name)
                        if as_mod:
                            table[local] = ("module", as_mod)
                            continue
                        rel = self._modnames.get(base)
                        if rel:
                            table[local] = ("symbol", rel, a.name)

    def _class_of_value(self, relpath, value):
        """(relpath, class) a value expression constructs, or None.
        Follows ``A or B`` to its last operand (the ``metrics or
        get_metrics()`` default idiom) and call results through
        :attr:`return_types`."""
        if isinstance(value, ast.BoolOp) and value.values:
            return self._class_of_value(relpath, value.values[-1])
        if not isinstance(value, ast.Call):
            return None
        name = dotted(value.func)
        if name is None:
            return None
        target = self._lookup(relpath, name)
        if target is None:
            return None
        kind, payload = target
        if kind == "class":
            return payload
        if kind == "function":
            return self.return_types.get(payload)
        return None

    def _collect_types(self):
        """Self-attribute, module-variable and return types (fixpoint:
        return types can depend on module-variable types and vice
        versa; two passes reach the repo's depth-one idioms)."""
        for _ in range(2):
            for ctx in self.contexts:
                # Module-level instances.
                for node in ctx.tree.body:
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Name):
                        typ = self._class_of_value(ctx.relpath, node.value)
                        if typ:
                            self.var_types[
                                (ctx.relpath, node.targets[0].id)] = typ
                for qual, fn in walk_functions(ctx.tree):
                    if "." in qual:
                        cls = qual.split(".")[0]
                        for sub in ast.walk(fn):
                            if isinstance(sub, ast.Assign) \
                                    and len(sub.targets) == 1:
                                t = sub.targets[0]
                                if isinstance(t, ast.Attribute) \
                                        and isinstance(t.value, ast.Name) \
                                        and t.value.id == "self":
                                    typ = self._class_of_value(ctx.relpath,
                                                               sub.value)
                                    if typ:
                                        self.attr_types[
                                            (ctx.relpath, cls, t.attr)] = typ
                    # Return type: every return returns the same class.
                    types = set()
                    opaque = False
                    for sub in ast.walk(fn):
                        if isinstance(sub, ast.Return) \
                                and sub.value is not None:
                            typ = None
                            if isinstance(sub.value, ast.Name):
                                typ = self.var_types.get(
                                    (ctx.relpath, sub.value.id))
                            else:
                                typ = self._class_of_value(ctx.relpath,
                                                           sub.value)
                            if typ is None:
                                opaque = True
                            else:
                                types.add(typ)
                    if not opaque and len(types) == 1:
                        self.return_types[f"{ctx.relpath}::{qual}"] = \
                            types.pop()

    def _lookup(self, relpath, name):
        """Resolve a dotted name in a module's namespace to
        ``("function", fqn)`` or ``("class", (relpath, class))``."""
        parts = name.split(".")
        table = self._imports.get(relpath, {})
        head, rest = parts[0], parts[1:]

        def in_module(rel, sym_parts):
            qual = ".".join(sym_parts)
            if f"{rel}::{qual}" in self.functions:
                return ("function", f"{rel}::{qual}")
            if len(sym_parts) == 1 and (rel, sym_parts[0]) in self.classes:
                return ("class", (rel, sym_parts[0]))
            if len(sym_parts) >= 1:
                typ = self.var_types.get((rel, sym_parts[0]))
                if typ and len(sym_parts) == 2:
                    trel, tcls = typ
                    if f"{trel}::{tcls}.{sym_parts[1]}" in self.functions:
                        return ("function",
                                f"{trel}::{tcls}.{sym_parts[1]}")
            return None

        binding = table.get(head)
        if binding is not None:
            if binding[0] == "module":
                return in_module(binding[1], rest) if rest else None
            _, rel, orig = binding
            return in_module(rel, [orig] + rest)
        return in_module(relpath, parts)

    def _resolve_callable_ref(self, relpath, owner_class, local_types,
                              node):
        """Resolve a *reference* expression (a thread target, a submit
        argument) to a function fqn, or None."""
        name = dotted(node)
        if name is None:
            return None
        return self._resolve_name(relpath, owner_class, local_types,
                                  name, as_ref=True,
                                  lineno=getattr(node, "lineno", None))

    def _resolve_name(self, relpath, owner_class, local_types, name,
                      as_ref=False, lineno=None):
        """Resolve a dotted callee name to a function fqn (constructor
        calls land on ``__init__`` unless ``as_ref``)."""
        parts = name.split(".")

        def method_of(typ, meth):
            if typ is None:
                return None
            trel, tcls = typ
            fqn = f"{trel}::{tcls}.{meth}"
            return fqn if fqn in self.functions else None

        if parts[0] == "self" and owner_class is not None:
            if len(parts) == 2:
                return method_of((relpath, owner_class), parts[1])
            if len(parts) == 3:
                typ = self.attr_types.get(
                    (relpath, owner_class, parts[1]))
                return method_of(typ, parts[2])
            return None
        if parts[0] in local_types:
            typ, bind_line = local_types[parts[0]]
            # A local binding only types uses at or after it.
            if lineno is not None and lineno < bind_line:
                return None
            if len(parts) == 2:
                return method_of(typ, parts[1])
            return None
        resolved = self._lookup(relpath, name)
        if resolved is None:
            # A method on a module-level instance of another module
            # (`journal._default.heartbeat()`), already covered by
            # _lookup's var_types branch; nothing more to try.
            return None
        kind, payload = resolved
        if kind == "function":
            return payload
        if kind == "class" and not as_ref:
            return method_of(payload, "__init__")
        return None

    def _resolve_calls(self):
        for info in self.functions.values():
            owner = info.qual.split(".")[0] if "." in info.qual else None
            ctx_rel = info.relpath
            # Single-step local constructor bindings (x = SomeClass()):
            # only names bound EXACTLY once in the function (any other
            # store — rebinding, loop target, unpacking — disqualifies)
            # and never parameters, so a binding cannot type a use it
            # does not dominate; uses before the binding line are
            # additionally rejected at resolution time.
            params = {a.arg for a in ast.walk(info.node.args)
                      if isinstance(a, ast.arg)}
            store_counts = {}
            for sub in walk_own(info.node):
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Store):
                    store_counts[sub.id] = store_counts.get(sub.id,
                                                            0) + 1
            local_types = {}   # name -> ((relpath, class), bind line)
            for sub in walk_own(info.node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name):
                    name = sub.targets[0].id
                    if store_counts.get(name) != 1 or name in params:
                        continue
                    typ = self._class_of_value(ctx_rel, sub.value)
                    if typ:
                        local_types[name] = (typ, sub.lineno)
            for sub in walk_own(info.node):
                if not isinstance(sub, ast.Call):
                    continue
                callee = None
                name = dotted(sub.func)
                if name is not None:
                    callee = self._resolve_name(
                        ctx_rel, owner, local_types, name,
                        lineno=sub.lineno)
                elif isinstance(sub.func, ast.Attribute) \
                        and isinstance(sub.func.value, ast.Call):
                    # f(...).meth(): type the inner call's result.
                    typ = self._class_of_value(ctx_rel, sub.func.value)
                    if typ:
                        trel, tcls = typ
                        fqn = f"{trel}::{tcls}.{sub.func.attr}"
                        callee = fqn if fqn in self.functions else None
                if callee is not None:
                    info.calls.append((sub, callee, "call"))
                    self._callee_by_node[id(sub)] = callee
                # Thread-of-execution handoffs.
                leaf = (name or "").split(".")[-1]
                target = None
                if leaf == "Thread":
                    for kw in sub.keywords:
                        if kw.arg == "target":
                            target = kw.value
                elif leaf == "submit" and sub.args:
                    target = sub.args[0]
                if target is not None:
                    tgt = self._resolve_callable_ref(ctx_rel, owner,
                                                     local_types, target)
                    if tgt is not None:
                        info.calls.append((sub, tgt, "thread"))

    # -- queries ------------------------------------------------------------

    def callee(self, node):
        """The resolved ``"call"``-kind callee fqn of a Call node seen
        during graph construction, or None."""
        return self._callee_by_node.get(id(node))

    def context_of(self, fqn):
        """The :class:`ModuleContext` holding ``fqn``."""
        return self.by_rel[self.functions[fqn].relpath]

    def reachable(self, roots, kinds=("call",)):
        """``{fqn: (parent fqn or None)}`` for every function reachable
        from ``roots`` over edges of the given kinds — the parent map
        doubles as the witness path for diagnostics."""
        parents = {}
        frontier = []
        for r in roots:
            if r in self.functions and r not in parents:
                parents[r] = None
                frontier.append(r)
        while frontier:
            cur = frontier.pop()
            for _, callee, kind in self.functions[cur].calls:
                if kind in kinds and callee not in parents:
                    parents[callee] = cur
                    frontier.append(callee)
        return parents

    def witness_path(self, parents, fqn):
        """Root-to-``fqn`` chain of quals through a :meth:`reachable`
        parent map (for "reachable via ..." messages)."""
        chain = []
        cur = fqn
        while cur is not None:
            chain.append(self.functions[cur].qual)
            cur = parents.get(cur)
        return list(reversed(chain))
