"""
RIP001 — host-sync detector, in its torch form.

A single stray host synchronisation in the queue path silently
serialises the whole search: the stage loop queues every kernel of a
batch on the card's stream and only the collect side waits, so a pull
between two launches stalls the card until the host has caught up
(the queue-ahead design of ``search/engine.py``).

PyTorch synchronises in more places than JAX: besides ``.item()`` and
``.tolist()``, a tensor's ``.cpu()`` / ``.numpy()`` / ``.to("cpu")``,
``bool()`` / ``int()`` / ``float()`` of a tensor (and an ``if`` on
one), ``.nonzero()``, ``torch.unique``, ``masked_select`` (the shapes
of their results live on the device), ``repeat_interleave`` without
``output_size``, ``torch.cuda.synchronize`` / ``Event`` /
``Stream.synchronize()``, and a blocking copy of host memory to the
card (``torch.from_numpy(a).to(dev)``, ``torch.tensor(x,
device=dev)``: PyTorch waits for a copy from pageable memory). Inside the explicitly-listed queue-side
functions (:data:`HOT_FUNCTIONS`; the collect side — ``_search``,
``collect_search_batch``, ``collect_peaks`` — is deliberately NOT
listed: pulling is its job) this rule flags each of them, and the
numpy pulls (``np.asarray`` / ``np.array`` / ``np.ascontiguousarray``)
that JAX's rule flags too.

``bool()`` / ``int()`` / ``float()`` are exempt where the AST can tell
the argument is host metadata: a literal, ``len(...)``, a tensor's
``.shape`` / ``.ndim`` / ``.nbytes`` / ``.itemsize`` or ``.numel()`` /
``.dim()`` / ``.element_size()``, and arithmetic over those.

Intentional sync points (the one documented device pull of
``run_periodogram``, host-side input coercion) live in the baseline
with a justification. ``chip_smoke.py``'s sync witness holds the rule
to the card: every sync the card reports inside this scope must sit
on a line that the baseline or a pragma covers.
"""
import ast

from .core import Analyzer, Finding, dotted, walk_functions

__all__ = ["HostSyncAnalyzer", "HOT_FUNCTIONS", "sync_reason"]

_E = "riptide_tpu_torch/search/engine.py"

# Queue-side hot functions per module: these run between batches while
# the card's stream must stay fed, so a device->host pull here is a
# throughput bug even when it is semantically harmless.
HOT_FUNCTIONS = {
    _E: {
        "_queue_stages", "_queue_batch", "_run_stage", "_run_launch",
        "_launch", "ship_stage_data", "_ship", "queue_search_batch",
        "run_periodogram", "run_periodogram_batch",
    },
    "riptide_tpu_torch/pipeline/batcher.py": {
        "BatchSearcher.process_stream", "BatchSearcher._queue_chunk",
        "BatchSearcher._queue_range", "BatchSearcher._queue_spanned",
        "BatchSearcher._ship_chunk",
        "BatchSearcher._ship_spanned",
    },
    "riptide_tpu_torch/ops/ffa_kernel.py": {
        "fused_stage", "paired_stage", "cascade_stage", "_stage",
        "_levels", "_snr",
    },
    "riptide_tpu_torch/search/peaks_device.py": {"queue_find_peaks"},
}

# Method calls (no arguments) that pull a tensor to the host.
_PULL_ATTRS = {"item", "tolist", "cpu", "numpy"}
# Calls whose result's shape is data-dependent: the host waits for it.
_SHAPE_SYNCS = {"nonzero", "unique", "unique_consecutive", "masked_select"}
_NP_PULLS = {"asarray", "array", "ascontiguousarray"}
_NP_NAMES = {"np", "numpy"}
_CASTS = {"bool", "int", "float"}
# Host metadata of a tensor (or an array): reading it never syncs.
_META_ATTRS = {"shape", "ndim", "nbytes", "itemsize", "dtype"}
_META_CALLS = {"numel", "dim", "element_size", "size", "len"}
# Reductions whose tensor result is what an `if` on it would pull.
_TENSOR_PREDICATES = {"any", "all", "equal", "allclose", "isclose",
                      "isnan", "isinf", "isfinite", "count_nonzero"}


def _np_pull(node):
    """True for np.asarray/np.array/np.ascontiguousarray calls."""
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr in _NP_PULLS
            and isinstance(f.value, ast.Name) and f.value.id in _NP_NAMES)


def _literal(node):
    if isinstance(node, ast.Constant):
        return True
    return isinstance(node, ast.UnaryOp) \
        and isinstance(node.operand, ast.Constant)


def _host_metadata(node):
    """True when the AST can tell ``node`` is host data: literals,
    ``len(...)``, tensor shapes and sizes, and arithmetic over them."""
    if _literal(node):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in _META_ATTRS
    if isinstance(node, ast.Subscript):
        return _host_metadata(node.value)
    if isinstance(node, ast.Call):
        leaf = (dotted(node.func) or "").split(".")[-1]
        return leaf in _META_CALLS
    if isinstance(node, ast.BinOp):
        return _host_metadata(node.left) and _host_metadata(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_metadata(node.operand)
    return False


def _cpu_target(node):
    """True for ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and (dotted(node.func) or "").endswith(
            "device") and node.args:
        return _cpu_target(node.args[0])
    return False


_HOST_TENSORS = {"torch.from_numpy", "torch.tensor", "torch.as_tensor"}


def _device_arg(node):
    """The device a call names (first positional or ``device=``), or
    None."""
    for kw in node.keywords:
        if kw.arg == "device":
            return kw.value
    return node.args[0] if node.args else None


def _blocking_host_copy(node):
    """True for a copy of host data to a device without
    ``non_blocking=True``: ``torch.from_numpy(a).to(dev)`` (also of
    ``torch.tensor``/``as_tensor`` made on the host), ``.cuda()`` of
    one, and ``torch.tensor``/``torch.as_tensor`` with a ``device=``.
    PyTorch waits for a copy from pageable host memory."""
    f = node.func
    name = dotted(f) or ""
    if name in ("torch.tensor", "torch.as_tensor"):
        dev = next((kw.value for kw in node.keywords if kw.arg == "device"),
                   None)
        return dev is not None and not _cpu_target(dev)
    if not (isinstance(f, ast.Attribute) and f.attr in ("to", "cuda")
            and isinstance(f.value, ast.Call)
            and dotted(f.value.func) in _HOST_TENSORS
            and not any(kw.arg == "device" for kw in f.value.keywords)):
        return False
    if any(kw.arg == "non_blocking" and not (
            isinstance(kw.value, ast.Constant) and not kw.value.value)
           for kw in node.keywords):
        return False
    if f.attr == "cuda":
        return True
    dev = _device_arg(node)
    return dev is not None and not _cpu_target(dev) and not (
        isinstance(dev, ast.Attribute) and dev.attr.startswith("float"))


def _tensor_condition(node):
    """True when an ``if``/``while`` test is a tensor the AST can tell:
    a ``torch.*`` predicate call or a ``.any()``/``.all()``-style
    reduction, possibly under ``not``/``and``/``or``."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _tensor_condition(node.operand)
    if isinstance(node, ast.BoolOp):
        return any(_tensor_condition(v) for v in node.values)
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func) or ""
    leaf = name.split(".")[-1]
    if name.startswith("torch.") and leaf in _TENSOR_PREDICATES:
        return True
    return isinstance(node.func, ast.Attribute) and not node.args \
        and leaf in ("any", "all")


def sync_reason(node, casts=True):
    """Why ``node`` (a Call) synchronises the host with the card, or
    None. ``casts`` adds ``bool()``/``int()``/``float()`` of anything
    the AST cannot tell is host metadata (RIP001's hot bodies; RIP011
    leaves them out, as the JAX rule does)."""
    f = node.func
    name = dotted(f) or ""
    leaf = name.split(".")[-1] if name else (
        f.attr if isinstance(f, ast.Attribute) else "")
    if isinstance(f, ast.Attribute):
        if leaf in _PULL_ATTRS and not node.args:
            return f"`.{leaf}()` pulls the tensor to the host"
        if leaf == "to" and (any(_cpu_target(a) for a in node.args[:1])
                             or any(kw.arg == "device"
                                    and _cpu_target(kw.value)
                                    for kw in node.keywords)):
            return "`.to(\"cpu\")` pulls the tensor to the host"
        if leaf == "synchronize":
            return f"`{name or '.synchronize'}()` waits for the card"
    if leaf in _SHAPE_SYNCS and (name.startswith("torch.")
                                 or isinstance(f, ast.Attribute)):
        return (f"`{leaf}` has a data-dependent result shape: the host "
                "waits for the card to size it")
    if leaf == "repeat_interleave" and (name.startswith("torch.")
                                        or isinstance(f, ast.Attribute)):
        repeats = node.args[1:2] if name.startswith("torch.") \
            else node.args[:1]
        repeats += [kw.value for kw in node.keywords if kw.arg == "repeats"]
        if not any(kw.arg == "output_size" for kw in node.keywords) \
                and not (repeats
                         and all(_host_metadata(a) for a in repeats)):
            return ("`repeat_interleave` without `output_size=` sizes "
                    "its result from the device")
    if _blocking_host_copy(node):
        return ("a blocking copy of host memory to the card (no "
                "`non_blocking=True` from pinned memory) waits for the "
                "copy")
    if _np_pull(node):
        return (f"`{name}` materialises its argument on the host (a "
                "silent device sync when fed a CUDA tensor)")
    if casts and isinstance(f, ast.Name) and f.id in _CASTS \
            and len(node.args) == 1 and not _host_metadata(node.args[0]):
        return (f"`{f.id}(...)` of a value the AST cannot tell is host "
                "data (of a tensor, a device sync)")
    return None


class HostSyncAnalyzer(Analyzer):
    rule = "RIP001"
    name = "host-sync"
    description = ("no host synchronisation (.item/.cpu/.numpy, casts "
                   "of tensors, data-dependent shapes, synchronize, "
                   "numpy pulls) in the engine/batcher/wrapper queueing "
                   "hot paths")

    def __init__(self, hot_functions=None):
        self.hot_functions = (HOT_FUNCTIONS if hot_functions is None
                              else hot_functions)
        self._seen_functions = {}

    def _scan(self, ctx, fn, where):
        out = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and _tensor_condition(node.test):
                out.append(Finding.at(
                    ctx, node.test, self.rule,
                    f"a tensor as the condition inside {where} — its "
                    "truth value is a device sync; keep the decision on "
                    "the card (torch.where) or move it to the collect "
                    "side"))
            if not isinstance(node, ast.Call):
                continue
            reason = sync_reason(node)
            if reason is not None:
                out.append(Finding.at(
                    ctx, node, self.rule,
                    f"{reason} inside {where} — keep the result on the "
                    "card or move the pull to the collect side"))
        return out

    def begin(self, repo):
        self._seen_functions = {}

    def run(self, ctx):
        findings = []
        hot = self.hot_functions.get(ctx.relpath, set())
        seen = self._seen_functions.setdefault(ctx.relpath, set())
        for qual, fn in walk_functions(ctx.tree):
            seen.add(qual)
            if qual in hot:
                findings.extend(self._scan(
                    ctx, fn, f"queueing hot path `{qual}`"))
        return findings

    def finalize(self, repo, contexts):
        """Staleness guard on the scope config: a renamed module or hot
        function must fail the lint loudly, not silently unscope it."""
        findings = []
        for rel, names in sorted(self.hot_functions.items()):
            seen = self._seen_functions.get(rel)
            if seen is None:
                findings.append(Finding(
                    rel, 1, 0, self.rule,
                    "hot-path module missing from the package — the "
                    "host-sync scope list (analysis/lint/host_sync.py "
                    "HOT_FUNCTIONS) is stale; update it",
                ))
                continue
            for name in sorted(set(names) - seen):
                findings.append(Finding(
                    rel, 1, 0, self.rule,
                    f"hot-path function {name!r} no longer exists in "
                    "this module — the host-sync scope list "
                    "(analysis/lint/host_sync.py HOT_FUNCTIONS) is "
                    "stale; update it or the queueing path goes "
                    "unchecked",
                ))
        return findings
