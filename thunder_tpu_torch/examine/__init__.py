"""Examine: support reporting, trace inspection, static memory and cost.

The counterpart of ``thunder_tpu/examine/__init__.py`` (reference parity:
thunder/examine/__init__.py ``examine:49``, ``get_fusions:190``;
examine/memory_caculation.py ``get_alloc_memory:120``), for a user to call
before spending time on the card:

- :func:`examine`: which torch operations of a callable the port cannot trace;
- :func:`lint`: the trace verifier over every stage of the pass pipeline,
  with a compiled function's cache summary (:func:`format_cache_report`) and,
  when metrics are on, the process-wide metrics (:func:`format_metrics_report`);
- :func:`memory_report`: the predicted peak device memory
  (``analysis/liveness.py``), against the card's capacity;
- :func:`cost_report`: the roofline bound of each op on the card
  (``analysis/cost.py``);
- :func:`hlo_report`: the audit of the compiled program below the trace
  (``analysis/hlo_audit.py``; there is no HLO: a staged entry's CUDA graph,
  or the profiler's record of one eager call);
- :func:`get_fusions`, :func:`get_alloc_memory` over a trace.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from thunder_tpu_torch.analysis.cost import cost_report, trace_cost  # noqa: F401  (examine.cost_report)
from thunder_tpu_torch.analysis.liveness import memory_report, plan_liveness  # noqa: F401  (examine.memory_report)
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.trace import TraceCtx


def _collect_unsupported(fn: Callable, args, kwargs) -> tuple[list[str], Optional[str]]:
    """One eager pass under a recording TorchFunctionMode: every torch call
    is checked for the torch language's coverage and then run, so every
    unsupported op is listed in one run. Returns (unsupported op names,
    the callable's own error or None)."""
    from torch.overrides import TorchFunctionMode

    from thunder_tpu_torch.core.langctxs import Languages, resolve_language
    from thunder_tpu_torch.torch import torch_function_map

    fmap = torch_function_map()
    ctx = resolve_language(Languages.TORCH)
    seen: list[str] = []

    def covered(func) -> bool:
        if func in fmap:
            return True
        name = getattr(func, "__name__", None)
        return bool(name and ctx.has_method(name))

    class Collector(TorchFunctionMode):
        def __torch_function__(self, func, types, f_args=(), f_kwargs=None):
            name = getattr(func, "__name__", "")
            if not covered(func) and not (name.startswith("__") and name.endswith("__")):
                label = getattr(func, "__qualname__", name or repr(func))
                if label not in seen:
                    seen.append(label)
            return func(*f_args, **(f_kwargs or {}))

    user_error: Optional[str] = None
    try:
        with Collector():
            fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the callable's own failure, reported apart
        user_error = f"{type(e).__name__}: {e}"
    return seen, user_error


def examine(fn: Callable, *args, **kwargs) -> dict:
    """Whether ``fn`` can be traced, and which torch operations are not
    supported. A module gets the collector pass first (every unsupported op
    listed, its own error reported as ``user_error``), then is compiled on
    its parameters' device; a function is traced."""
    import torch

    from thunder_tpu_torch.api import trace_program

    unsupported: list[str] = []
    report: dict[str, Any] = {"supported": False, "unsupported_ops": unsupported, "trace": None}
    is_module = isinstance(fn, torch.nn.Module)
    if is_module:
        ops, user_error = _collect_unsupported(fn, args, kwargs)
        unsupported.extend(ops)
        if user_error is not None:
            report["user_error"] = user_error
        if unsupported or user_error:
            return report
    try:
        if is_module:
            from thunder_tpu_torch.frontend.module import ThunderModule

            device = next((p.device for p in fn.parameters()), torch.device("cpu"))
            tm = ThunderModule(fn, device=device)
            comp = tm._compile(tm._params(), args, kwargs, grad=False)["traces"][0]
        else:
            _, comp = trace_program(fn, args, kwargs)
        report["supported"] = True
        report["trace"] = comp
    except NotImplementedError as e:
        unsupported.append(str(e))
    except Exception as e:  # noqa: BLE001
        report["error"] = f"{type(e).__name__}: {e}"
    return report


def lint(fn: Callable, *args, executors: Optional[Any] = None, verbose: bool = True, **kwargs) -> list:
    """Trace ``fn`` on the example inputs, run the pass pipeline
    (acquisition → DCE → CSE → the compiled function's transforms (grad,
    autocast) → claiming → del_last_used) with the verifier off, then run
    the verifier over every stage. Returns every
    :class:`~thunder_tpu_torch.analysis.Diagnostic`; with ``verbose`` prints
    each with its trace line, and a compiled function's cache summary.

    Unlike ``THUNDER_TPU_CHECKS=1`` (which raises at the first failing
    pass), lint collects everything, warnings and info included."""
    from thunder_tpu_torch.analysis import attach_trace_lines, verify
    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.core.trace import debug_checks, mark
    from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.transforms.common import cse, dce

    compiled = fn if getattr(fn, "_lc_cs", None) is not None and getattr(fn, "_lc_cd", None) is not None else None
    transforms = ()
    cd = getattr(fn, "_lc_cd", None)
    if cd is not None:
        fn, transforms = cd.fn, tuple(cd.trace_transforms)
        executors = cd.executors_list if executors is None else executors

    with debug_checks(False):
        plg, comp = trace_program(fn, args, kwargs, record_input_mutations=True)
        mark(comp, "Acquisition")
        mark(plg, "Prologue construction")
        stages: list[tuple[str, TraceCtx]] = [("Prologue construction", plg), ("Acquisition", comp)]
        comp = dce(comp)
        stages.append(("Dead Code Elimination", comp))
        comp = cse(comp)
        stages.append(("Common Subexpression Elimination", comp))
        for transform in transforms:
            comp = transform(comp)
            stages.append((comp.provenance.pss.split(" (took ")[0] if comp.provenance else "transform", comp))
        extrace = transform_for_execution(comp, resolve_executors(executors))
        stages.append(("Transform for execution", extrace))
        extrace = del_last_used(extrace)
        stages.append(("Delete Last Used", extrace))

    diagnostics = []
    for name, trc in stages:
        diags = verify(trc, pass_name=name)
        attach_trace_lines(diags, trc)
        diagnostics.extend(diags)

    if verbose:
        if not diagnostics:
            print(f"lint: {len(stages)} stages verified clean ({len(extrace.bound_symbols)} symbols)")
        for d in diagnostics:
            print(d.format())
        if compiled is not None:
            print(format_cache_report(compiled))
        from thunder_tpu_torch.observability import metrics as obsm

        if obsm.enabled():
            print(format_metrics_report())
    return diagnostics


def hlo_report(fn: Callable, *args, device: Optional[Any] = None, verbose: bool = True, **kwargs):
    """Audit the program behind ``fn`` below its trace (thunder_tpu/examine/
    __init__.py:178-232): the collectives and where they were launched, the
    port's kernels, the layout copies, the host transfers and the exposed
    wire time of what actually ran.

    Accepts, in order of preference:

    - a ``thunder_tpu_torch.jit``-compiled function: the report the
      ``hlo_audit`` compile phase attached to its latest entry (a staged
      entry on the card, audited from its captured graph); else, after a
      call on the example inputs, the report that call's capture attached;
      else (an unstaged entry: the CPU, or a program that reads the host)
      the audit of the profiler's record of one more real call;
    - a staged step (``build_train_step``'s, ``Train.staged``) or a
      ``jit(module)``: ``analysis.hlo_audit.audit_jitted``;
    - a plain callable: compiled with ``jit`` first, on the device of its
      first tensor argument.

    ``device`` is the spec the audit prices at (default: the card's, or the
    CPU's). Returns the :class:`~thunder_tpu_torch.analysis.hlo_audit.HloScheduleReport`;
    with ``verbose`` prints it and its ``hlo.*`` findings."""
    import torch

    from thunder_tpu_torch.analysis import hlo_audit
    from thunder_tpu_torch.executors.staging import CudaGraphStage

    staged_step = isinstance(fn, CudaGraphStage) or hasattr(fn, "staging") or hasattr(fn, "_cache")
    cs = None if staged_step else getattr(fn, "_lc_cs", None)
    if cs is None and not staged_step:
        from thunder_tpu_torch.api import jit

        first = next((x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)), None)
        fn = jit(fn, device=first.device if first is not None else None)
        cs = fn._lc_cs
    if cs is not None:
        report = cs.cache_entries[-1].hlo_audit if cs.cache_entries else None
        if report is None:
            fn(*args, **kwargs)
            report = cs.cache_entries[-1].hlo_audit
        if report is None:
            report = hlo_audit.audit_record(fn, *args, device=device, **kwargs)
    else:
        report = hlo_audit.audit_jitted(fn, *args, device=device, **kwargs)
    if verbose:
        print(report.format())
        for d in report.diagnostics():
            print(d.format())
    return report


def format_cache_report(jfn: Callable) -> str:
    """A compiled function's cache summary: its hit, miss and recompile
    counters and trace and first-run seconds, aggregate and per entry."""
    from thunder_tpu_torch.api import cache_info

    info = cache_info(jfn)
    lines = [
        f"cache[{info['cache_option']}]: {info['calls']} calls, {info['hits']} hits ({info['fast_hits']} O(1) fast, "
        f"{info['slow_hits']} prologue-scan), {info['misses']} misses, {info['compiles']} compiles "
        f"({info['recompiles']} recompiles), {info['prologue_runs']} prologue runs",
        f"  trace {info['trace_seconds']:.3f}s, first-run {info['first_run_seconds']:.3f}s, cache lookups "
        f"{info['cache_lookup_us_total']:.0f}us total",
    ]
    for e in info["entries"]:
        peak = e.get("predicted_peak_bytes")
        lines.append(f"  entry {e['index']} [{e['buckets']}]: {e['hits']} hits ({e['fast_hits']} fast), "
                     f"{e['prologue_runs']} prologue runs, {e['guard_fails']} guard fails, trace {e['trace_s']:.3f}s, "
                     f"first run {e['first_run_s']:.3f}s"
                     + ("" if peak is None else f", predicted peak {peak / 1e6:.2f} MB"))
    return "\n".join(lines)


def format_metrics_report() -> str:
    """One-screen summary of the process-wide observability metrics
    (``thunder_tpu_torch.monitor``): compiles and recompiles, cache
    traffic, claim breakdown, padding waste. The cross-function counterpart
    of :func:`format_cache_report`; empty series are elided."""
    from thunder_tpu_torch.observability.metrics import REGISTRY

    flat = REGISTRY.report_compact()
    if not flat:
        return "metrics: enabled, no samples yet"
    lines = ["metrics (process-wide, thunder_tpu_torch.monitor.report()):"]
    for name, v in flat.items():
        if isinstance(v, dict):  # histogram summary
            lines.append(
                f"  {name}: n={v['count']} mean={v['mean']:.1f} "
                f"min={v['min']:.1f} max={v['max']:.1f}"
            )
        else:
            lines.append(f"  {name}: {v}")
    return "\n".join(lines)


def get_fusions(trace: TraceCtx) -> list[tuple[str, Any]]:
    """The executor-claimed ops of a trace, (executor name, bsym), the
    python executor's left out (reference: examine:190)."""
    return [(b.sym.executor.name, b) for b in trace.bound_symbols
            if b.sym.executor is not None and b.sym.executor.name != "python"]


_NO_ALLOC_IDS = {
    PrimIDs.RETURN, PrimIDs.COMMENT, PrimIDs.PRINT,
    PrimIDs.UNPACK_TRIVIAL, PrimIDs.UNPACK_SEQUENCE, PrimIDs.UNPACK_KEY, PrimIDs.UNPACK_ATTR, PrimIDs.UNPACK_DIM,
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    PrimIDs.CHECK_STRING_VALUE, PrimIDs.CHECK_LEN, PrimIDs.CHECK_KEYS, PrimIDs.CHECK_NONE, PrimIDs.CHECK_DIM_BUCKET,
    PrimIDs.SHALLOW_COPY, PrimIDs.STOP_GRADIENT,
}


def get_alloc_memory(trace: TraceCtx) -> tuple[int, dict[str, int]]:
    """Static peak-allocation estimate over a trace in bytes, and the live
    bytes at each new peak (reference: examine/memory_caculation.py:120):
    inputs are live at entry, each op's outputs allocate, ``del`` frees.
    The liveness planner (:func:`memory_report`) is the finer model."""
    live: dict[str, int] = {}
    for a in tree_flatten((trace.args, trace.kwargs))[0]:
        if isinstance(a, TensorProxy):
            live[a.name] = a.size_bytes
    peak = sum(live.values())
    timeline: dict[str, int] = {"inputs": peak}
    for i, bsym in enumerate(trace.bound_symbols):
        if bsym.sym.id is PrimIDs.DEL:
            for p in bsym.flat_proxy_args:
                live.pop(p.name, None)
            continue
        if bsym.sym.id in _NO_ALLOC_IDS:
            continue
        for o in bsym.flat_proxy_outs:
            if isinstance(o, TensorProxy) and o.name not in live:
                live[o.name] = o.size_bytes
        cur = sum(live.values())
        if cur > peak:
            peak = cur
            timeline[f"{i}:{bsym.sym.name}"] = cur
    return peak, timeline
