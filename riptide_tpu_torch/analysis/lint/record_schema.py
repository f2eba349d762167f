"""
RIP010 — record-schema conformance across the append-only formats (the
port's copy of the JAX package's rule, its specs rebuilt from the
port's files).

The port has three JSONL record families — the survey journal
(header / chunk / parked / metrics / incident records plus heartbeat
sidecars), the perf ledger and the per-chunk timing blocks — whose
*writers* and *readers* live in different packages (journal.py and
incidents.py write what report.py, apps/rtop.py and the scheduler's
resume path read). Nothing ties the two halves together at runtime: a renamed
writer key silently turns every reader of it into a ``.get()`` default,
and a reader expecting a kind no writer emits filters forever on
nothing. This analyzer closes the loop statically:

* **writer extraction** — for each configured writer function, the
  string keys of every dict literal it builds (plus ``var["k"] = ...``
  subscript-assign and ``var.setdefault("k", ...)`` adds on the same
  names), grouped into a record *family*: the literal ``"kind"`` value
  when present, else the family the spec declares (``heartbeat``,
  ``ledger``, ``timing``);
* **reader extraction** — for each configured reader function, every
  ``X.get("k")`` / ``X["k"]`` string-key access, and every *kind
  consumption*: a literal compared against ``.get("kind")`` /
  ``["kind"]`` (directly or through a one-step local binding);
* **checks** — a key read but written by no writer (and absent from
  the readers' own locally-built dict vocabulary and the versioned
  :data:`RECORD_ALLOWLIST`) is an error at the read site; a kind
  consumed but never emitted is an error at the comparison; a writer
  whose record dict is later merged with a run decomposition
  (``row.update(decomposition ...)``) must not literally name any
  ``DECOMPOSITION_KEYS`` (extracted from ``obs/schema.py``) — the
  merge would silently clobber one side.

The allowlist is **versioned**: each entry documents a backward-compat
read (a key old journals carry that no current writer emits) with the
reason it must stay readable. Bump ``version`` when an entry set
changes so reviews see allowlist growth explicitly.

A reader spec may name a file outside the package; this analyzer then
parses it directly, and its findings baseline via the path-only entry
form. The port's readers all live in the package.
"""
import ast
import os

from .core import Analyzer, Finding, ModuleContext, walk_functions

__all__ = ["RecordSchemaAnalyzer", "WRITER_SPECS", "READER_SPECS",
           "RECORD_ALLOWLIST"]

SCHEMA_REL = "riptide_tpu_torch/obs/schema.py"

_P = "riptide_tpu_torch/"

# (relpath, function qual, declared family or None = take the literal
# "kind" value of each dict).  These are the record EMISSION points —
# every fsync'd append traces back to one of them.
WRITER_SPECS = (
    (_P + "survey/journal.py", "SurveyJournal.write_header", None),
    (_P + "survey/journal.py", "SurveyJournal.record_chunk", None),
    (_P + "survey/journal.py", "SurveyJournal.record_parked", None),
    (_P + "survey/journal.py", "SurveyJournal.record_metrics", None),
    (_P + "survey/journal.py", "SurveyJournal.record_incident",
     "incident"),
    (_P + "survey/journal.py", "SurveyJournal.record_alert", "alert"),
    (_P + "survey/journal.py", "SurveyJournal.heartbeat", "heartbeat"),
    (_P + "survey/incidents.py", "emit", "incident"),
    (_P + "obs/ledger.py", "make_row", "ledger"),
    # The alert engine's fire/resolve record: journaled verbatim by
    # record_alert and consumed by report/rtop/rwatch.
    (_P + "obs/alerts.py", "AlertEngine._event", "alert"),
    # The per-process fleet snapshot sidecar, merged by
    # report.read_fleet/merge_fleet.
    (_P + "obs/fleet.py", "snapshot", "fleet"),
    # The live signal vector the alert rules evaluate: built by the
    # reader side but CONSUMED as a record by the rule engine and
    # rwatch, so its keys are part of the checked schema.
    (_P + "obs/report.py", "watch_snapshot", "watch"),
    (_P + "obs/schema.py", "chunk_timing", "timing"),
    (_P + "obs/schema.py", "decomposition", "ledger"),
    # The chunk record's predicted-vs-actual peak device-memory block.
    (_P + "obs/schema.py", "hbm_block", "hbm"),
    # The chunk record's result-integrity block (digests + shadow-probe
    # provenance), merged via `extra=`.
    (_P + "obs/schema.py", "integrity_block", "integrity"),
    # Provenance merged in through `extra=` at the call sites.
    (_P + "survey/scheduler.py", "SurveyScheduler._run", "ledger"),
    (_P + "parallel/multihost.py", "run_search_multihost", "chunk"),
    # Chrome trace / platform blocks the report side parses back.
    (_P + "obs/chrome.py", "chrome_events", "trace"),
    (_P + "obs/chrome.py", "write_chrome_trace", "trace"),
    (_P + "obs/chrome.py", "merge_chrome_traces", "trace"),
    # The ledger row's device block (the JAX package's
    # engine.device_fingerprint): backend, card name, power limit.
    (_P + "obs/ledger.py", "platform_info", "platform"),
    # The survey service's job-registry event: the ONE builder of
    # jobs.jsonl records, consumed by report.py's job table, rtop's
    # serve view and the daemon's own restart replay.
    (_P + "serve/daemon.py", "job_record", "job"),
)

# (relpath, function qual or None = whole module) of the CONSUMPTION
# points: resume, post-run reporting, live monitoring.
READER_SPECS = (
    (_P + "survey/journal.py", None),
    (_P + "survey/scheduler.py", "SurveyScheduler._run"),
    (_P + "survey/liveness.py", "PeerLivenessMonitor.partial_chunks"),
    (_P + "obs/report.py", None),
    (_P + "apps/rtop.py", None),
    (_P + "apps/rwatch.py", None),
)

# Versioned backward-compat allowlist: keys readers must keep accepting
# although no current writer emits them (or the writer is outside the
# statically extractable surface). Each entry carries its why; bump the
# version whenever the set changes so the diff is a deliberate act.
RECORD_ALLOWLIST = {
    "version": 2,
    "keys": {
        # Not a record key: TimeSeries.metadata field read while the
        # scheduler BUILDS the chunk record's dms list (the reader
        # scope covers _run whole for its resume reads).
        "dm": "TimeSeries.metadata field, not a journal record key",
    },
    "kinds": {
        # Ledger rows' kind is the make_row(kind=...) ARGUMENT, set at
        # each call site ("survey"/"rseek"/...) rather than a dict
        # literal the writer extraction can see. The scheduler's
        # full-replay resume filters ledger rows on it (append the row
        # a killed predecessor never managed, exactly once).
        "survey": "ledger row kind passed dynamically via "
                  "ledger.maybe_append('survey', ...)",
    },
}


def _str_keys(dict_node):
    return [k.value for k in dict_node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


def _literal_kind(dict_node):
    for k, v in zip(dict_node.keys, dict_node.values):
        if isinstance(k, ast.Constant) and k.value == "kind" \
                and isinstance(v, ast.Constant) \
                and isinstance(v.value, str):
            return v.value
    return None


def _mentions_decomposition(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "decomposition" in sub.id:
            return True
        if isinstance(sub, ast.Attribute) \
                and "decomposition" in sub.attr:
            return True
    return False


class RecordSchemaAnalyzer(Analyzer):
    rule = "RIP010"
    name = "record-schema"
    description = ("every record key a reader consumes is emitted by a "
                   "writer, every consumed kind is emitted, and "
                   "decomposition-merged rows don't shadow "
                   "DECOMPOSITION_KEYS")

    def __init__(self, writers=None, readers=None, allowlist=None,
                 schema_rel=None):
        self.writers = WRITER_SPECS if writers is None else tuple(writers)
        self.readers = READER_SPECS if readers is None else tuple(readers)
        self.allowlist = (RECORD_ALLOWLIST if allowlist is None
                          else allowlist)
        self.schema_rel = SCHEMA_REL if schema_rel is None else schema_rel
        self._reset()

    def _reset(self):
        self._written = {}        # key -> {family}
        self._emitted_kinds = set()
        self._reads = []          # (ctx-like, node, key)
        self._kind_uses = []      # (ctx-like, node, kind literal)
        self._local_vocab = set()  # dict-literal keys inside reader funcs
        self._seen_writer = set()
        self._seen_reader = set()
        self._decomp_keys = None
        self._collision_findings = []

    def begin(self, repo):
        self._reset()

    # -- per-module extraction ----------------------------------------------

    def run(self, ctx):
        for rel, qual, family in self.writers:
            if rel == ctx.relpath:
                self._seen_writer.add((rel, qual))
                fn = self._function(ctx, qual)
                if fn is not None:
                    self._extract_writer(ctx, fn, family)
        for rel, qual in self.readers:
            if rel == ctx.relpath:
                self._seen_reader.add((rel, qual))
                self._extract_reader(ctx, qual)
        if ctx.relpath == self.schema_rel:
            self._decomp_keys = self._extract_decomp_keys(ctx)
        return []

    @staticmethod
    def _function(ctx, qual):
        for q, fn in walk_functions(ctx.tree):
            if q == qual:
                return fn
        return None

    def _extract_writer(self, ctx, fn, family):
        # Dict literals (by var when assigned), then subscript/
        # setdefault adds on the same vars.
        var_family = {}
        merged_decomp = set()
        literal_keys_of = {}   # var -> [first dict node, {literal keys}]

        def note(keys, fam, kind_literal):
            fam = kind_literal or fam
            if kind_literal:
                self._emitted_kinds.add(kind_literal)
            for k in keys:
                self._written.setdefault(k, set()).add(fam or "?")

        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name) \
                    and isinstance(sub.value, ast.Dict):
                var = sub.targets[0].id
                kind = _literal_kind(sub.value)
                var_family[var] = kind or family
                keys = _str_keys(sub.value)
                literal_keys_of.setdefault(var, [sub.value, set()])[1] \
                    .update(keys)
                note(keys, family, kind)
            elif isinstance(sub, ast.Dict) and _str_keys(sub):
                note(_str_keys(sub), family, _literal_kind(sub))
            elif isinstance(sub, ast.Assign) \
                    and isinstance(sub.targets[0], ast.Subscript) \
                    and isinstance(sub.targets[0].value, ast.Name):
                var = sub.targets[0].value.id
                key = sub.targets[0].slice
                if isinstance(key, ast.Constant) \
                        and isinstance(key.value, str):
                    note([key.value], var_family.get(var, family), None)
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name):
                var = sub.func.value.id
                if sub.func.attr == "setdefault" and sub.args \
                        and isinstance(sub.args[0], ast.Constant) \
                        and isinstance(sub.args[0].value, str):
                    key = sub.args[0].value
                    kind = None
                    if key == "kind" and len(sub.args) > 1 \
                            and isinstance(sub.args[1], ast.Constant):
                        kind = sub.args[1].value
                        self._emitted_kinds.add(kind)
                    note([key], var_family.get(var, family), None)
                elif sub.func.attr == "update" and sub.args:
                    if isinstance(sub.args[0], ast.Dict):
                        note(_str_keys(sub.args[0]),
                             var_family.get(var, family),
                             _literal_kind(sub.args[0]))
                    elif _mentions_decomposition(sub.args[0]):
                        merged_decomp.add(var)

        # Collision check: a record merged with the run decomposition
        # must not literally name the decomposition's own keys.
        for var in sorted(merged_decomp):
            if var in literal_keys_of:
                node, keys = literal_keys_of[var]
                self._collision_findings.append((ctx, node, var,
                                                 set(keys)))

    def _extract_reader(self, ctx, qual):
        scopes = []
        if qual is None:
            scopes = [ctx.tree]
        else:
            fn = self._function(ctx, qual)
            if fn is not None:
                scopes = [fn]
        for scope in scopes:
            kind_vars = set()
            for sub in ast.walk(scope):
                # kind = rec.get("kind") one-step bindings.
                if isinstance(sub, ast.Assign) \
                        and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name) \
                        and self._is_kind_access(sub.value):
                    kind_vars.add(sub.targets[0].id)
            for sub in ast.walk(scope):
                if isinstance(sub, ast.Dict):
                    self._local_vocab.update(_str_keys(sub))
                elif isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in ("get", "setdefault") \
                        and sub.args \
                        and isinstance(sub.args[0], ast.Constant) \
                        and isinstance(sub.args[0].value, str):
                    self._reads.append((ctx, sub, sub.args[0].value))
                elif isinstance(sub, ast.Subscript) \
                        and isinstance(sub.slice, ast.Constant) \
                        and isinstance(sub.slice.value, str):
                    if isinstance(sub.ctx, ast.Load):
                        self._reads.append((ctx, sub, sub.slice.value))
                    else:
                        # A reader assembling its own structure
                        # (`report["trace"] = ...`) defines vocabulary,
                        # it does not consume a record key.
                        self._local_vocab.add(sub.slice.value)
                elif isinstance(sub, ast.Compare):
                    self._note_kind_compare(ctx, sub, kind_vars)

    @staticmethod
    def _is_kind_access(node):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "kind":
            return True
        if isinstance(node, ast.Subscript) \
                and isinstance(node.slice, ast.Constant) \
                and node.slice.value == "kind":
            return True
        return False

    def _note_kind_compare(self, ctx, node, kind_vars):
        sides = [node.left] + list(node.comparators)
        is_kind = any(
            self._is_kind_access(s)
            or (isinstance(s, ast.Name) and s.id in kind_vars)
            for s in sides
        )
        if not is_kind:
            return
        for s in sides:
            if isinstance(s, ast.Constant) and isinstance(s.value, str):
                self._kind_uses.append((ctx, node, s.value))

    def _extract_decomp_keys(self, ctx):
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "DECOMPOSITION_KEYS" \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                return {e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)}
        return None

    # -- the comparison -----------------------------------------------------

    def finalize(self, repo, contexts):
        findings = []

        # Spec staleness fails loudly (the HOT_FUNCTIONS discipline): a
        # renamed writer/reader must not silently unscope the check.
        known = {c.relpath for c in contexts}
        for rel, qual, _fam in self.writers:
            # Writers must live in the package: extraction only runs
            # over package contexts, so an out-of-package (or
            # vanished) writer spec covers nothing and must fail
            # loudly rather than quietly pass.
            if (rel, qual) in self._seen_writer \
                    and self._function_exists(contexts, rel, qual):
                continue
            findings.append(Finding(
                rel, 1, 0, self.rule,
                f"record writer {qual!r} not found in the package — "
                "the WRITER_SPECS list (analysis/record_schema.py) is "
                "stale; update it or the emission surface goes "
                "unchecked",
            ))
        for rel, qual in self.readers:
            if rel in known:
                if qual is None or self._function_exists(contexts, rel,
                                                         qual):
                    continue
            else:
                extra = self._load_extra(repo, rel)
                if extra is not None and (
                        qual is None
                        or any(q == qual
                               for q, _ in walk_functions(extra.tree))):
                    self._extract_reader(extra, qual)
                    continue
            findings.append(Finding(
                rel, 1, 0, self.rule,
                f"record reader {qual or '<module>'!r} not found — the "
                "READER_SPECS list (analysis/record_schema.py) is "
                "stale; update it or the consumption surface goes "
                "unchecked",
            ))

        written = set(self._written)
        allow_keys = set(self.allowlist.get("keys", ()))
        allow_kinds = set(self.allowlist.get("kinds", ()))
        seen = set()
        for ctx, node, key in self._reads:
            if key in written or key in self._local_vocab \
                    or key in allow_keys:
                continue
            loc = (ctx.relpath, getattr(node, "lineno", 1), key)
            if loc in seen:
                continue
            seen.add(loc)
            findings.append(Finding.at(
                ctx, node, self.rule,
                f"record key {key!r} is read here but no writer emits "
                "it — a renamed or dropped writer key turns this read "
                "into its .get() default forever (fix the writer, or "
                "allowlist the documented backward-compat read in "
                "analysis/record_schema.py RECORD_ALLOWLIST)",
            ))
        for ctx, node, kind in self._kind_uses:
            if kind in self._emitted_kinds or kind in allow_kinds:
                continue
            loc = (ctx.relpath, getattr(node, "lineno", 1), kind)
            if loc in seen:
                continue
            seen.add(loc)
            findings.append(Finding.at(
                ctx, node, self.rule,
                f"record kind {kind!r} is consumed here but no writer "
                "emits it — this filter matches nothing (fix the kind "
                "string, or allowlist it in RECORD_ALLOWLIST)",
            ))
        if self._decomp_keys:
            for ctx, node, var, keys in self._collision_findings:
                clash = sorted(keys & self._decomp_keys)
                if clash:
                    findings.append(Finding.at(
                        ctx, node, self.rule,
                        f"record dict `{var}` names decomposition "
                        f"key(s) {clash} AND merges the run "
                        "decomposition over itself — one side silently "
                        "clobbers the other; drop the literal key(s)",
                    ))
        findings.sort(key=lambda f: (f.path, f.line, f.col))
        return findings

    @staticmethod
    def _function_exists(contexts, rel, qual):
        for c in contexts:
            if c.relpath == rel:
                return any(q == qual for q, _ in walk_functions(c.tree))
        return False

    def _load_extra(self, repo, rel):
        """Parse a spec'd file outside the package; writer extraction
        from it is not supported — readers only."""
        path = os.path.join(repo, rel)
        if not os.path.exists(path):
            return None
        try:
            return ModuleContext(repo, rel)
        except (OSError, SyntaxError):
            return None
