"""
The port's public surface against the reference's, module by module.

Every module of ``riptide_tpu`` is one case. Each name it exports (its
``__all__``, the public functions and classes it defines, and for a
package the functions and classes it re-exports from its submodules)
must resolve in the port's counterpart module, with every public method
of each class, and every parameter name of each function must be
accepted by the port's (the port may add keywords, such as
``device=``). The counterpart is the same dotted path under
``riptide_tpu_torch``, but for the renames of :func:`port_module` and
:func:`port_name`.

The only names left out are the TPU and XLA mechanisms of
:data:`EXCLUDED`, each with its reason. Add an exclusion only there, and
only with a one-line reason; a second test fails when an excluded name
is gone from the reference or has appeared in the port.
"""
import importlib
import inspect
import pkgutil

import pytest

import riptide_tpu

# Keys are dotted paths below the package (``module.name``, ``module.
# Class.method``, or a module alone), taken from the module that
# defines the object, so that one entry covers its re-exports too. A key
# ending in "()" names a function whose parameters may differ.
EXCLUDED = {
    # Whole modules.
    "ops.slotffa": "host planning of the TPU slot kernel; the port's "
                   "ops/slottables.py keeps the node_sizes it needs",
    "utils.compat": "shims over jax versions (Pallas compiler params, "
                    "shard_map)",
    # The slot-table internals of the Pallas kernels.
    "ops.slottables.KernelTables": "the Pallas kernel's packed SMEM table "
                                   "layout",
    "ops.slottables.build_tables": "builds the Pallas kernel's slot tables",
    "ops.slottables.combine_tables": "merges Pallas slot tables across "
                                     "lane buckets",
    "ops.slottables.simulate_dense": "numpy model of the Pallas slot "
                                     "kernel's dense schedule",
    "ops.slottables.simulate_dense_pair": "numpy model of the paired Pallas "
                                          "slot kernel",
    "ops.slottables.SLOT_S": "the Pallas kernel's slot width in vregs",
    "ops.slottables.pack_word": "packs a Pallas slot-table word",
    # ops/ffa_kernel.py's Pallas internals.
    "ops.ffa_kernel.CycleKernel": "a built pallas_call with its VMEM "
                                  "residency",
    "ops.ffa_kernel.ffa_snr_cycle": "builds the pallas_call; the port's "
                                    "kernels are csrc/ffa_stage.cu",
    "ops.ffa_kernel.NWPAD": "S/N width padding to the TPU lane tile",
    "ops.ffa_kernel.VMEM_LIMIT": "the TPU's VMEM budget",
    "ops.ffa_kernel.kernel_vmem_bytes": "VMEM footprint of a Pallas launch",
    "ops.ffa_kernel.pack_gather_words": "packs the Pallas kernel's gather "
                                        "words",
    "ops.ffa_kernel.num_level_tables": "count of the level tables resident "
                                       "in VMEM",
    "ops.ffa_kernel.tables_resident": "whether the tables fit in VMEM",
    "ops.ffa_kernel.kernel_code_digest": "digest of the Pallas kernel's "
                                         "bytecode; the port keys its build "
                                         "cache by source, flags and nvcc",
    "search.plan.CycleStage.cycle_kernel": "builds the stage's pallas_call",
    "search.plan.CycleStage.cycle_kernels": "builds the lane buckets' "
                                            "pallas_calls",
    "search.plan.CycleStage.paired_cycle_kernel": "builds the paired "
                                                  "pallas_call",
    # The XLA programs of the search engine.
    "search.engine.cycle_fn": "the jitted XLA gather form of one stage",
    "search.engine.cycle_fn_batch": "the jitted XLA gather form of one "
                                    "stage over a DM batch",
    "search.engine.staged_stage_programs": "AOT-lowered XLA stage programs",
    "search.engine.staged_chunk_program": "the AOT-lowered XLA chunk "
                                          "program",
    "search.engine.staged_peak_program": "the AOT-lowered XLA peak program",
    "search.engine.staged_wire_operands": "abstract wire operands for XLA "
                                          "lowering",
    "search.engine.prepare_batch": "device_put of a batch for the XLA "
                                   "gather form",
    "ops.downsample.split_prefix_sums": "the XLA gather form's float32 "
                                        "hi/lo prefix sums",
    "ops.downsample.downsample_gather": "the XLA gather form of the "
                                        "downsampling",
    "utils.exec_cache.cached_jit": "jax.jit with XLA's persistent cache",
    "utils.exec_cache.load_or_compile_exec": "serialised XLA executables",
    "utils.exec_cache.evict_resident": "drops resident XLA executables",
    # The JAX package's native CPU kernels: the port's CPU path is plain
    # torch, and its native runtime keeps only the host wire prep.
    "native.ffa_tables": "native CPU FFA level tables",
    "native.ffa_transform": "native CPU FFA transform",
    "native.benchmark_ffa": "times the native CPU FFA transform",
    "native.running_median": "native CPU running median",
    "native.downsample": "native CPU downsampling",
    "native.circular_prefix_sum": "native CPU prefix sum of the S/N",
    "native.rollback": "native CPU roll of an FFA row",
    "native.fused_rollback_add": "native CPU FFA merge",
    "native.boxcar_snr": "native CPU boxcar S/N",
    # Helpers over jaxprs: the port's contracts are read from its launch
    # walk (engine.walk_search).
    "analysis.jaxpr_contract.aval_bytes": "bytes of a jaxpr abstract value",
    "analysis.jaxpr_contract.peak_live_bytes": "live bytes over a jaxpr's "
                                               "equations",
    "analysis.jaxpr_contract.count_f64_eqns": "float64 equations of a "
                                              "jaxpr",
    "analysis.jaxpr_contract.collect_dtypes": "dtypes of a jaxpr's values",
    "analysis.jaxpr_contract.donation_report": "XLA buffer donation of a "
                                               "jaxpr",
    # The peak program's device clustering runs wherever the plan
    # allows it: no switch.
    "search.peaks_device.device_cluster_enabled": "reads the port's "
                                                  "removed cluster switch",
    "search.peaks_device.force_device_cluster": "pins the port's removed "
                                                "cluster switch",
    # Signatures that differ.
    "search.peaks_device.PeakPlan.__init__()": "the plan decides its "
                                               "device clustering itself",
    "search.engine.ship_stage_data()": "the port ships one tensor on an "
                                       "explicit device, with a copy event, "
                                       "and needs no plan",
    "analysis.jaxpr_contract.hbm_model()": "the JAX version takes the jaxpr "
                                           "path it traces",
    "analysis.jaxpr_contract.extract_contract()": "the JAX version takes "
                                                  "the jaxpr path and "
                                                  "programs it traces",
}

# Where the port once lacked a name of the reference, as a path below
# the package ("()": where it refused the reference's parameters). None
# of them may be excluded.
REPAIRED = (
    "downsample", "running_median", "fast_running_median", "find_peaks",
    "test", "libffa.benchmark_ffa2",
    "pipeline.batcher.BatchSearcher.process_fname_list",
    "search.engine.is_timeout_error", "search.engine.device_fingerprint",
    "ops.plan.batch_plans", "ops.batch_plans",
    "analysis.finite_guards.check", "analysis.finite_guards.check_module",
    "analysis.liveness_guards.check", "analysis.liveness_guards.check_file",
    "utils.envflags.get()", "obs.span", "obs.Tracer", "obs.build_report",
    "survey.SurveyScheduler", "survey.get_metrics",
)

# Reference modules whose counterpart has another path: the analysis
# package's names live in analysis.lint, with its rules.
_MODULE_RENAMES = {
    "analysis": "analysis.lint",
    "analysis.pallas_layout": "analysis.lint.launch_layout",
    "analysis.jaxpr_contract": "analysis.launch_contract",
    "analysis.sched": "analysis.sched",
}
_NAME_RENAMES = {"PallasLayoutAnalyzer": "LaunchLayoutAnalyzer"}

REF_MODULES = ["riptide_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(riptide_tpu.__path__,
                                          "riptide_tpu.")
    if not m.name.startswith("riptide_tpu.tests"))


def short(module):
    """``riptide_tpu.a.b`` -> ``a.b``."""
    return module.partition(".")[2]


def port_module(ref):
    rel = short(ref)
    if rel in _MODULE_RENAMES:
        rel = _MODULE_RENAMES[rel]
    elif rel.startswith("analysis."):
        rel = "analysis.lint." + rel.partition(".")[2]
    return ".".join(filter(None, ("riptide_tpu_torch", rel)))


def port_name(name):
    if name.endswith("_jax"):
        return name[:-len("_jax")] + "_torch"
    return _NAME_RENAMES.get(name, name)


def _home(obj, module):
    home = getattr(obj, "__module__", None)
    return home if isinstance(home, str) and (
        home == "riptide_tpu" or home.startswith("riptide_tpu.")) else module


def _key(*parts):
    return ".".join(p for p in parts if p)


def exported(mod):
    """The names a reference module exports: its ``__all__``, then the
    public functions and classes it defines and, for a package, those
    it re-exports from its own submodules."""
    names = list(getattr(mod, "__all__", ()))
    pkg = hasattr(mod, "__path__")
    for name, obj in vars(mod).items():
        if name.startswith("_") or name in names or inspect.ismodule(obj) \
                or not callable(obj):
            continue
        home = getattr(obj, "__module__", None) or ""
        if home == mod.__name__ or pkg and home.startswith(mod.__name__ + "."):
            names.append(name)
    return names


def _params(fn):
    """Parameter names a callable takes, and whether it takes ``**kw``;
    None when it has no signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    named = {n for n, p in sig.parameters.items()
             if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    return named, any(p.kind == p.VAR_KEYWORD
                      for p in sig.parameters.values())


def signature_gaps(ref_fn, port_fn):
    """The reference's parameter names the port's callable refuses."""
    ref, port = _params(ref_fn), _params(port_fn)
    if ref is None or port is None or port[1]:
        return []
    return sorted(ref[0] - port[0])


def _methods(cls):
    """Public methods and properties a class itself defines, with the
    function behind each (None for a property), ``__init__`` included."""
    out = {}
    for name, attr in vars(cls).items():
        if name.startswith("_") and name != "__init__":
            continue
        if isinstance(attr, (classmethod, staticmethod)):
            out[name] = attr.__func__
        elif inspect.isfunction(attr):
            out[name] = attr
        elif isinstance(attr, property):
            out[name] = None
    return out


def _method(cls, name):
    attr = inspect.getattr_static(cls, name)
    return attr.__func__ if isinstance(attr, (classmethod, staticmethod)) \
        else attr


def surface_gaps(ref_name):
    """Every export of reference module ``ref_name`` that its port
    counterpart lacks or whose parameters it refuses, as the keys of
    :data:`EXCLUDED` name them (a missing module as its own key)."""
    ref = importlib.import_module(ref_name)
    try:
        port = importlib.import_module(port_module(ref_name))
    except ModuleNotFoundError:
        return [short(ref_name)]
    gaps = []
    for name in exported(ref):
        obj = getattr(ref, name)
        key = _key(short(_home(obj, ref_name)), name)
        if not hasattr(port, port_name(name)):
            gaps.append(key)
            continue
        mine = getattr(port, port_name(name))
        if inspect.isclass(obj) and inspect.isclass(mine):
            ckey = _key(short(_home(obj, ref_name)), obj.__name__)
            for meth, fn in _methods(obj).items():
                if not hasattr(mine, meth):
                    gaps.append(_key(ckey, meth))
                elif fn is not None and signature_gaps(fn, _method(mine,
                                                                   meth)):
                    gaps.append(_key(ckey, meth) + "()")
        elif callable(obj) and not inspect.isclass(obj) \
                and signature_gaps(obj, mine):
            gaps.append(key + "()")
    return gaps


@pytest.mark.parametrize("ref_name", REF_MODULES)
def test_module_surface_resolves_in_the_port(ref_name):
    gaps = [g for g in surface_gaps(ref_name) if g not in EXCLUDED]
    assert gaps == [], (
        f"{ref_name} -> {port_module(ref_name)}: missing or refusing the "
        f"reference's parameters: {gaps}")


def _resolve(key):
    """(reference object, port object or None, the reference object's
    EXCLUDED key) named by a path below the package."""
    path = key[:-2] if key.endswith("()") else key
    parts = path.split(".")
    for cut in range(len(parts), -1, -1):
        modname = _key("riptide_tpu", *parts[:cut])
        try:
            ref = importlib.import_module(modname)
        except ModuleNotFoundError:
            continue
        try:
            port = importlib.import_module(port_module(modname))
        except ModuleNotFoundError:
            port = None
        for attr in parts[cut:]:
            ref = getattr(ref, attr)
            port = getattr(port, port_name(attr), None)
        home = path
        if cut == len(parts) - 1:
            home = _key(short(_home(ref, modname)), parts[-1])
        return ref, port, home + key[len(path):]
    raise AssertionError(f"{key}: no such reference module")


@pytest.mark.parametrize("key", sorted(EXCLUDED))
def test_exclusion_is_a_live_reference_name(key):
    """Each exclusion names something the reference still has and the
    port still lacks (or, for a signature, still takes otherwise), and
    carries a reason."""
    assert EXCLUDED[key].strip()
    ref, port, _ = _resolve(key)
    if key.endswith("()"):
        assert port is not None and signature_gaps(ref, port), (
            f"{key}: the port now takes the reference's parameters")
    else:
        assert port is None, f"{key}: the port now has it"


def test_every_repaired_name_resolves():
    """The names the port once lacked are in place, take the
    reference's parameters, and no exclusion covers them."""
    for key in REPAIRED:
        ref, port, home = _resolve(key)
        assert port is not None, key
        assert key not in EXCLUDED and home not in EXCLUDED, key
        if key.endswith("()") or callable(ref) and not inspect.isclass(ref):
            assert signature_gaps(ref, port) == [], key


def test_module_map_renames():
    assert port_module("riptide_tpu") == "riptide_tpu_torch"
    assert port_module("riptide_tpu.analysis") == "riptide_tpu_torch.analysis.lint"
    assert port_module("riptide_tpu.analysis.host_sync") == \
        "riptide_tpu_torch.analysis.lint.host_sync"
    assert port_module("riptide_tpu.analysis.jaxpr_contract") == \
        "riptide_tpu_torch.analysis.launch_contract"
    assert port_module("riptide_tpu.obs.trace") == "riptide_tpu_torch.obs.trace"
    assert port_name("running_median_jax") == "running_median_torch"
    assert port_name("PallasLayoutAnalyzer") == "LaunchLayoutAnalyzer"
