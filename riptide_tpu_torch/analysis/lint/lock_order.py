"""
RIP009 — interprocedural lock-order and lock-coverage analysis (the
port's copy of the JAX package's rule).

RIP004 polices what happens *lexically inside* one module's critical
sections; it cannot see the cross-module surface where the survey's
deadlocks would actually form — the scheduler holding one subsystem's
lock while a call two modules away acquires another's (the watchdog /
status-provider / incident-sink web all run on different threads of
the same process). This analyzer lifts lock discipline to the
:class:`~.core.ProjectContext` call graph:

* **lock discovery** — module-level ``X = threading.Lock()`` /
  ``RLock()`` objects and ``self.x = threading.Lock()`` instance locks
  (identified per class: the analysis treats all instances of a class
  as one lock, the standard static approximation);
* **held-set propagation** — every ``with <lock>:`` body (and explicit
  ``.acquire()`` of a known lock) records which locks are held;
  resolved calls made under a held lock propagate the held set into
  the callee, transitively, so an acquisition N calls away still
  yields an ordering edge. ``Thread(target=...)``/``submit`` handoffs
  deliberately do NOT propagate held locks — the child thread starts
  lock-free;
* **RIP009a: acquisition-order cycles** — an edge A->B means "B was
  acquired while A was held" somewhere in the program; any cycle in
  that global digraph is a deadlock-capable ordering inversion and is
  reported at each participating acquisition site. Module-level locks
  are singletons, so a self-edge on one (re-acquiring it beneath
  itself) is reported too; instance locks skip self-edges (two
  *instances* of a class may legitimately nest);
* **RIP009b: lock-free writes to guarded attributes** — an instance
  attribute (or module global) written under the class's (module's)
  own lock in one method but assigned on a lock-free path in another
  is a data race in waiting. ``__init__`` (module top level) is
  exempt — construction happens before publication — and so is a
  method whose every resolved call site in the project holds the lock
  (the ``_foo_locked`` helper pattern).

Intentional exceptions (build-serialisation locks that exist to block)
carry baseline entries, same as every other rule.
"""
import ast

from .core import Analyzer, Finding, dotted, walk_functions, walk_own

__all__ = ["LockOrderAnalyzer"]

_LOCK_CTORS = {"Lock", "RLock"}


def _is_lock_ctor(value):
    if not isinstance(value, ast.Call):
        return False
    name = dotted(value.func) or ""
    return name.split(".")[-1] in _LOCK_CTORS


def _ctor_kind(value):
    return (dotted(value.func) or "").split(".")[-1]


class _LockModel:
    """Discovered locks of one project: stable string ids
    (``relpath::NAME`` for module-level locks, ``relpath::Class.attr``
    for instance locks) plus enough structure to resolve an
    acquisition expression to one of them."""

    def __init__(self, project):
        self.project = project
        self.module_locks = {}    # (relpath, name) -> lock id
        self.class_locks = {}     # (relpath, class, attr) -> lock id
        self.kinds = {}           # lock id -> "Lock" | "RLock"
        for ctx in project.contexts:
            for node in ctx.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and _is_lock_ctor(node.value):
                    name = node.targets[0].id
                    lock_id = f"{ctx.relpath}::{name}"
                    self.module_locks[(ctx.relpath, name)] = lock_id
                    self.kinds[lock_id] = _ctor_kind(node.value)
            for qual, fn in walk_functions(ctx.tree):
                if "." not in qual:
                    continue
                cls = qual.split(".")[0]
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Assign) \
                            and len(sub.targets) == 1 \
                            and isinstance(sub.targets[0], ast.Attribute) \
                            and isinstance(sub.targets[0].value, ast.Name) \
                            and sub.targets[0].value.id == "self" \
                            and _is_lock_ctor(sub.value):
                        attr = sub.targets[0].attr
                        lock_id = f"{ctx.relpath}::{cls}.{attr}"
                        self.class_locks[(ctx.relpath, cls, attr)] = \
                            lock_id
                        self.kinds[lock_id] = _ctor_kind(sub.value)

    def is_module_level(self, lock_id):
        return lock_id in self.module_locks.values()

    def is_reentrant(self, lock_id):
        return self.kinds.get(lock_id) == "RLock"

    def resolve(self, relpath, owner_class, expr):
        """Lock id acquired by a with-item context expression (or the
        receiver of an ``.acquire()``), or None."""
        name = dotted(expr)
        if name is None:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            local = self.module_locks.get((relpath, parts[0]))
            if local:
                return local
            binding = self.project._imports.get(relpath, {}).get(parts[0])
            if binding and binding[0] == "symbol":
                return self.module_locks.get((binding[1], binding[2]))
            return None
        if parts[0] == "self" and owner_class is not None:
            if len(parts) == 2:
                return self.class_locks.get(
                    (relpath, owner_class, parts[1]))
            if len(parts) == 3:
                typ = self.project.attr_types.get(
                    (relpath, owner_class, parts[1]))
                if typ:
                    return self.class_locks.get(
                        (typ[0], typ[1], parts[2]))
            return None
        # mod._lock through an import binding, or instance._lock
        # through a typed module variable / local.
        binding = self.project._imports.get(relpath, {}).get(parts[0])
        if binding and binding[0] == "module" and len(parts) == 2:
            return self.module_locks.get((binding[1], parts[1]))
        typ = self.project.var_types.get((relpath, parts[0]))
        if typ and len(parts) == 2:
            return self.class_locks.get((typ[0], typ[1], parts[1]))
        return None


class LockOrderAnalyzer(Analyzer):
    rule = "RIP009"
    name = "lock-order"
    description = ("no acquisition-order cycles across the whole "
                   "program (held-lock sets propagated through the "
                   "call graph) and no lock-free writes to attributes "
                   "guarded elsewhere")
    needs_project = True

    def begin(self, repo):
        self._fn_nodes = {}

    def run_project(self, project):
        self._fn_nodes = {fqn: info.node
                          for fqn, info in project.functions.items()}
        model = _LockModel(project)
        # Per function: direct acquisitions, calls made per held set,
        # write sites, and the held set active at each resolved call.
        acquires = {}        # fqn -> {lock id}
        order_edges = {}     # (A, B) -> witness (ctx, node, fqn)
        calls_under = []     # (caller fqn, callee fqn, frozenset(held))
        held_at_call = {}    # (callee fqn) -> list of held frozensets
        writes = []          # (fqn, ctx, node, target key, guarded locks)

        for fqn, info in project.functions.items():
            ctx = project.context_of(fqn)
            owner = info.qual.split(".")[0] if "." in info.qual else None
            acquires[fqn] = set()

            def explicit_ops(stmt):
                """(lock, "acquire"|"release") effects of one
                statement, any depth (nested defs excluded), in SOURCE
                order — walk_own's own order is stack-driven, and a
                self-contained ``try: A.acquire() ... finally:
                A.release()`` must net to nothing, which only holds
                when the acquire is applied before the release. Feeds
                the sequential held-set tracking so manual acquire
                regions hold their lock for the statements between."""
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # walk_own skips nested defs it ENCOUNTERS but
                    # walks a root it is GIVEN: a statement that is
                    # itself a def is wholly deferred code.
                    return []
                ops = []
                for sub in walk_own(stmt):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr in ("acquire", "release"):
                        lock = model.resolve(ctx.relpath, owner,
                                             sub.func.value)
                        if lock is not None:
                            ops.append((sub.lineno, sub.col_offset,
                                        lock, sub.func.attr))
                return [(lock, op) for _, _, lock, op in sorted(ops)]

            def visit_block(stmts, held):
                cur = set(held)
                for stmt in stmts:
                    visit(stmt, frozenset(cur))
                    for lock, op in explicit_ops(stmt):
                        if op == "acquire":
                            cur.add(lock)
                        else:
                            cur.discard(lock)

            def visit(node, held):
                if node is not info.node and isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # A nested def is a separate FunctionInfo whose
                    # code is deferred: its calls/acquisitions belong
                    # to IT, and merely defining it under a lock holds
                    # nothing.
                    return
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    held_now = set(held)
                    for item in node.items:
                        # Calls in the with-item position run before
                        # (or between) the acquisitions and must be
                        # seen under whatever is held so far.
                        visit(item.context_expr, frozenset(held_now))
                        lock = model.resolve(ctx.relpath, owner,
                                             item.context_expr)
                        if lock is not None:
                            acquires[fqn].add(lock)
                            for h in held_now:
                                order_edges.setdefault(
                                    (h, lock),
                                    (ctx, item.context_expr, fqn))
                            held_now.add(lock)
                    visit_block(node.body, frozenset(held_now))
                    return
                if isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute) and \
                            f.attr == "acquire":
                        lock = model.resolve(ctx.relpath, owner, f.value)
                        if lock is not None:
                            acquires[fqn].add(lock)
                            for h in held:
                                order_edges.setdefault(
                                    (h, lock), (ctx, node, fqn))
                    callee = project.callee(node)
                    if callee is not None:
                        frozen = frozenset(held)
                        calls_under.append((fqn, callee, frozen))
                        held_at_call.setdefault(callee, []).append(frozen)
                self._record_writes(ctx, fqn, owner, node, held, model,
                                    writes)
                # Statement lists recurse through visit_block so a
                # manual acquire's effect reaches its later siblings.
                for _field, value in ast.iter_fields(node):
                    if isinstance(value, list):
                        if value and isinstance(value[0], ast.stmt):
                            visit_block(value, held)
                        else:
                            for v in value:
                                if isinstance(v, ast.AST):
                                    visit(v, held)
                    elif isinstance(value, ast.AST):
                        visit(value, held)

            visit(info.node, frozenset())

        # Transitive closure: every lock a function may acquire through
        # plain calls (thread handoffs start lock-free).
        closure = {fqn: set(locks) for fqn, locks in acquires.items()}
        changed = True
        while changed:
            changed = False
            for fqn, info in project.functions.items():
                mine = closure[fqn]
                before = len(mine)
                for _, callee, kind in info.calls:
                    if kind == "call" and callee in closure:
                        mine |= closure[callee]
                if len(mine) != before:
                    changed = True

        for caller, callee, held in calls_under:
            if not held:
                continue
            witness = None
            for h in held:
                for lock in closure.get(callee, ()):
                    key = (h, lock)
                    if key not in order_edges:
                        # Witness at the call site that carries the
                        # held lock into the acquiring callee.
                        if witness is None:
                            witness = self._call_witness(
                                project, caller, callee)
                        order_edges[key] = witness

        findings = self._cycle_findings(project, model, order_edges)
        findings.extend(self._write_findings(project, model, writes,
                                             held_at_call))
        return findings

    # -- RIP009a: ordering cycles -------------------------------------------

    def _call_witness(self, project, caller, callee):
        info = project.functions[caller]
        for node, c, kind in info.calls:
            if c == callee and kind == "call":
                return (project.context_of(caller), node, caller)
        return (project.context_of(caller), info.node, caller)

    def _cycle_findings(self, project, model, order_edges):
        graph = {}
        for (a, b), _ in order_edges.items():
            if a == b:
                continue
            graph.setdefault(a, set()).add(b)
        # Nodes sharing a strongly connected component participate in
        # at least one cycle; iterative Tarjan keeps deep graphs safe.
        index = {}
        low = {}
        stack, on_stack = [], set()
        sccs = {}
        counter = [0]

        def strongconnect(root):
            work = [(root, iter(sorted(graph.get(root, ()))))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append((nxt, iter(sorted(graph.get(nxt,
                                                                ())))))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if low[node] == index[node]:
                    comp = set()
                    while True:
                        top = stack.pop()
                        on_stack.discard(top)
                        comp.add(top)
                        if top == node:
                            break
                    for member in comp:
                        sccs[member] = frozenset(comp)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        for node in sorted(set(graph) | {b for bs in graph.values()
                                         for b in bs}):
            if node not in index:
                strongconnect(node)

        findings = []
        for (a, b), (ctx, node, fqn) in sorted(
                order_edges.items(), key=lambda kv: kv[0]):
            if a == b:
                # Module-level locks are singletons, so re-acquisition
                # beneath itself is a certain self-deadlock — unless
                # the lock is an RLock, whose whole point is reentrant
                # acquisition. Instance locks skip self-edges entirely
                # (two instances of a class may legitimately nest).
                if model.is_module_level(a) and not model.is_reentrant(a):
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"lock `{a}` is re-acquired on a path that "
                        f"already holds it (via `{fqn.split('::')[-1]}`)"
                        " — a non-reentrant Lock self-deadlocks here",
                    ))
                continue
            comp = sccs.get(a)
            if comp and b in comp and len(comp) > 1:
                cycle = " -> ".join(sorted(comp) + [sorted(comp)[0]])
                findings.append(Finding.at(
                    ctx, node, self.rule,
                    f"lock-order inversion: `{b}` is acquired while "
                    f"`{a}` is held (in `{fqn.split('::')[-1]}`), but "
                    f"the global acquisition graph also orders them the "
                    f"other way — cycle {cycle}; pick ONE order and "
                    "move the offending acquisition outside the "
                    "critical section",
                ))
        return findings

    # -- RIP009b: lock-free writes to guarded attributes --------------------

    def _record_writes(self, ctx, fqn, owner, node, held, model, writes):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        # `prev, _sink = _sink, sink` writes _sink just as surely.
        targets = [e for t in targets
                   for e in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                             else (t,))]
        for t in targets:
            key = None
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self" \
                    and owner is not None:
                if (ctx.relpath, owner, t.attr) in model.class_locks:
                    continue  # the lock object itself
                key = ("attr", ctx.relpath, owner, t.attr)
            elif isinstance(t, ast.Name) and "." not in fqn.split("::")[1] \
                    and self._is_global_write(fqn, t.id):
                key = ("global", ctx.relpath, t.id)
            if key is not None:
                writes.append((fqn, ctx, node, key, frozenset(held)))

    def _is_global_write(self, fqn, name):
        # Only writes declared `global NAME` in the function count as
        # module-state writes; plain locals are invisible elsewhere.
        fn = self._fn_nodes.get(fqn)
        if fn is None:
            return False
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Global) and name in sub.names:
                return True
        return False

    def _write_findings(self, project, model, writes, held_at_call):
        # Relevant guard lock per write scope: the owning class's own
        # locks (module's own locks for globals).
        def own_locks(key):
            if key[0] == "attr":
                _, rel, cls, _ = key
                return {lock for (r, c, _a), lock
                        in model.class_locks.items()
                        if r == rel and c == cls}
            _, rel, _ = key
            return {lock for (r, _n), lock in model.module_locks.items()
                    if r == rel}

        by_key = {}
        for fqn, ctx, node, key, held in writes:
            by_key.setdefault(key[1:] + (key[0],), []).append(
                (fqn, ctx, node, key, held))

        findings = []
        for sites in by_key.values():
            locks = own_locks(sites[0][3])
            if not locks:
                continue
            guarded = [s for s in sites if s[4] & locks
                       and not s[0].endswith(("__init__",))]
            if not guarded:
                continue
            for fqn, ctx, node, key, held in sites:
                if held & locks:
                    continue
                qual = fqn.split("::")[1]
                if qual.endswith("__init__") or qual == "<module>":
                    continue
                # Caller mitigation: every resolved project call site
                # of this function holds one of the guarding locks
                # (the `_foo_locked` helper pattern).
                callers = held_at_call.get(fqn)
                if callers and all(h & locks for h in callers):
                    continue
                what = (f"self.{key[3]}" if key[0] == "attr"
                        else key[2])
                lock_names = ", ".join(sorted(locks))
                findings.append(Finding.at(
                    ctx, node, self.rule,
                    f"`{what}` is written under {lock_names} elsewhere "
                    f"but assigned lock-free in `{qual}` — either take "
                    "the lock here or document the field as "
                    "single-threaded",
                ))
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings
