"""The jit entry point: acquisition → dce/cse → claiming → staging.

Reference parity: thunder/__init__.py (`jit:299`, the prologue-guarded cache
loop `:409-447`) and the functional frontend of thunder/functional.py.

The counterpart of ``thunder_tpu/api.py``: trace the program into the IR,
run dce and cse and any trace transform asked for (``grad`` and
``value_and_grad`` add the autodiff transform, after which the
attention-residual pass rewrites the joint trace's attention pairs), let the
executors claim it, print it as Python with ``del`` statements after each
last use, and stage it on one device: on CUDA the claimed program is
captured whole as a CUDA graph (``executors/staging.py``, the seat of
``jax.jit``; the first call runs eagerly, the second captures, later calls
replay), unless ``disable_jit_staging`` is set or the program reads the host;
on the CPU it runs eagerly. The prologue re-checks every input's metadata on
each call and is what decides a cache hit; under ``cache="symbolic values"``
it checks a marked dim's bucket instead of its extent, and the entry runs on
inputs padded to the bucket's ceiling (``core/bucketing.py``,
``transforms/padmask.py``). An epilogue replays the writes the program made
to its inputs onto the caller's objects (``_build_epilogue``).
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from thunder_tpu_torch import clang  # registers the clang language  # noqa: F401
from thunder_tpu_torch import torch as ltorch  # registers the torch language  # noqa: F401
from thunder_tpu_torch.common import (
    CACHE_OPTIONS,
    CacheEntry,
    sharp_edge,
    CompileData,
    CompileStats,
    resolve_cache_option,
    resolve_sharp_edges_option,
    sharp_edges_policy,
    timer_ns,
)
from thunder_tpu_torch.core import devices, prims
from thunder_tpu_torch.core.baseutils import GuardFailure, check
from thunder_tpu_torch.core.bucketing import BucketPolicy, make_symbolic_spec
from thunder_tpu_torch.core.codeutils import SigInfo
from thunder_tpu_torch.core.concrete import check_value_guards, value_guards_of
from thunder_tpu_torch.core.langctxs import Languages, langctx_ctx
from thunder_tpu_torch.core.proxies import (
    AnyProxy,
    CollectionProxy,
    NumberProxy,
    Proxy,
    StringProxy,
    TensorProxy,
    proxy,
    tensorproxy_from_concrete,
)
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from thunder_tpu_torch.core.symbol import resolve_inplace, resolve_inplace_tree
from thunder_tpu_torch.core.trace import TraceCtx, debug_checks, from_trace, mark, tracectx
from thunder_tpu_torch.executors import bridge, pythonex, torchex  # register executors  # noqa: F401
from thunder_tpu_torch.executors import flashex, fusedex, normex, quantex  # kernel executors  # noqa: F401
from thunder_tpu_torch.executors import batching, rngex, staging
from thunder_tpu_torch.executors.passes import claim_breakdown, del_last_used, transform_for_execution
from thunder_tpu_torch.extend import add_default_executor, get_executor, resolve_executors
from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm
from thunder_tpu_torch.resilience import chaos as chaos_mod
from thunder_tpu_torch.resilience import deopt as deopt_mod
from thunder_tpu_torch.resilience import watchdog as watchdog_mod
from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals_joint
from thunder_tpu_torch.transforms.common import cse, dce
from thunder_tpu_torch.transforms.padmask import analyze_crop_plan, thread_pad_masks
from thunder_tpu_torch.transforms.rematerialization import rematerialize_joint
from thunder_tpu_torch.transforms.rng import RNG_TAG, functionalize_rng_ops

# The kernel executors claim their composite ops whole; the torch executor
# lowers every remaining prim. The "norm" (normex) and "quant" (quantex)
# executors are opt-in, by name, as in the JAX package. These are the
# registry's defaults (``extend.get_default_executors``), which
# ``add_default_executor`` changes for every later compile.
DEFAULT_EXECUTORS = (flashex.ex, fusedex.ex, torchex.ex)
for _ex in reversed(DEFAULT_EXECUTORS):
    add_default_executor(_ex, front=True)


# =============================================================================
# Acquisition (functional frontend)
# =============================================================================


def _proxy_input(x: Any) -> Any:
    if bridge.is_concrete_tensor(x):
        return tensorproxy_from_concrete(x)
    if isinstance(x, (bool, int, float, complex, str)):
        return proxy(x)
    if x is None or isinstance(x, Proxy):
        return x
    return proxy(x)  # AnyProxy


def _proxify_tree(tree: Any) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_proxify_tree(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _proxify_tree(v) for k, v in tree.items()}
    return _proxy_input(tree)


def _build_prologue(args: tuple, kwargs: dict, proxied_args: tuple, proxied_kwargs: dict,
                    tensor_leaves: list) -> TraceCtx:
    """The guard trace: unpack the input structure, check every leaf's
    metadata or value, and return the flat tensor leaves.

    Reference parity: thunder/core/jit_ext.py `unpack_inputs:1098`. The
    guards implement CONSTANT_VALUES caching: a mismatch raises GuardFailure
    and the cache entry is skipped."""
    plg = TraceCtx(prologue=True)
    plg.name = "prologue"
    plg.set_siginfo(SigInfo("prologue", [], varargs="args", varkwargs="kwargs"))
    for t in tensor_leaves:
        plg.add_name(t.name)

    with tracectx(plg):
        args_coll = CollectionProxy(args, name="args")
        kwargs_coll = CollectionProxy(kwargs, name="kwargs")

        def slot_proxy(p: Any):
            # A None leaf is guarded with check_none, so a None→tensor change
            # misses instead of reusing the trace that baked in the None.
            return AnyProxy(None, prefix="nil") if p is None else p

        def guard_leaf(p: Any, concrete: Any) -> None:
            if isinstance(p, TensorProxy):
                # A dim marked symbolic guards its bucket, lo < d <= hi,
                # not its extent (cache="symbolic values").
                sdims = getattr(p, "_symbolic_dims", None) or {}
                prims.check_tensor_shape_and_metadata(
                    p, tuple(None if i in sdims else int(s) for i, s in enumerate(p.shape)), str(p.device),
                    p.true_dtype, p.requires_grad, bridge.framework_of(concrete),
                )
                for i, (lo, hi, _cid) in sorted(sdims.items()):
                    prims.check_dim_bucket(prims.unpack_dim(p, i), lo, hi)
            elif isinstance(p, NumberProxy):
                prims.check_number_type_and_value(p, p.value)
            elif isinstance(p, StringProxy):
                prims.check_string_value(p, p.value)
            elif isinstance(p, AnyProxy) and p.value is None:
                prims.check_none(p)
            else:
                # An opaque leaf: its value is baked into the trace with no
                # prologue check, so report it per the sharp-edges policy.
                sharp_edge(f"input {getattr(p, 'name', p)!r} of type "
                           f"{type(getattr(p, 'value', concrete)).__name__} cannot be guarded")

        def unpack_into(coll_proxy: CollectionProxy, concrete: Any, proxied: Any) -> None:
            if isinstance(concrete, (tuple, list)):
                prims.check_len(coll_proxy, len(concrete))
                outs, sub, leaf_slots = [], [], []
                for c, p in zip(concrete, proxied):
                    if isinstance(c, (tuple, list, dict)):
                        cp = CollectionProxy(c)
                        outs.append(cp)
                        sub.append((cp, c, p))
                    else:
                        slot = slot_proxy(p)
                        outs.append(slot)
                        leaf_slots.append((slot, c))
                plg.bound_symbols.append(prims.unpack_sequence.bind(coll_proxy, len(concrete), output=outs))
                for slot, c in leaf_slots:
                    guard_leaf(slot, c)
                for cp, c, p in sub:
                    unpack_into(cp, c, p)
            elif isinstance(concrete, dict):
                prims.check_keys(coll_proxy, tuple(concrete.keys()))
                for k, c in concrete.items():
                    p = proxied[k]
                    if isinstance(c, (tuple, list, dict)):
                        cp = CollectionProxy(c)
                        plg.bound_symbols.append(prims.unpack_key.bind(coll_proxy, k, output=cp))
                        unpack_into(cp, c, p)
                    else:
                        slot = slot_proxy(p)
                        plg.bound_symbols.append(prims.unpack_key.bind(coll_proxy, k, output=slot))
                        guard_leaf(slot, c)
            else:
                raise NotImplementedError(f"Cannot unpack {type(concrete)}")

        for coll, concrete, proxied in ((args_coll, args, proxied_args), (kwargs_coll, kwargs, proxied_kwargs)):
            if concrete:
                unpack_into(coll, concrete, proxied)
            else:
                prims.check_len(coll, 0)
        prims.python_return(tuple(tensor_leaves))

    plg.output = tuple(tensor_leaves)
    return plg


def _copy_container_tree(tree: Any) -> Any:
    """A structural copy (fresh containers, the same leaf proxies): the
    baseline that the traced function's container writes are diffed
    against (thunder_tpu/api.py:222)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy_container_tree(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _copy_container_tree(v) for k, v in tree.items()}
    return tree


_MISSING = object()


def _mutation_value_spec(v: Any, extras: list):
    """A value written into an input container: a tensor proxy becomes an
    extra output of the program (``("out", j)``), plain data is kept
    inline."""
    if isinstance(v, TensorProxy):
        extras.append(resolve_inplace(v))
        return ("out", len(extras) - 1)
    if isinstance(v, NumberProxy):
        return ("const", v.value)
    if isinstance(v, dict):
        return ("dict", {k: _mutation_value_spec(x, extras) for k, x in v.items()})
    if isinstance(v, (list, tuple)):
        return ("list" if isinstance(v, list) else "tuple", [_mutation_value_spec(x, extras) for x in v])
    return ("const", v)


def _same_container_type(a: Any, b: Any) -> bool:
    return any(isinstance(a, t) and isinstance(b, t) for t in (dict, list, tuple))


def _tuple_replaced(cur: tuple, orig: tuple) -> bool:
    """Whether a tuple's value changed: tuples are immutable, so a leaf that
    is another object means its slot was rebound to a new tuple, which the
    parent records as a whole."""
    if len(cur) != len(orig):
        return True
    for a, b in zip(cur, orig):
        if isinstance(a, tuple) and isinstance(b, tuple):
            if _tuple_replaced(a, b):
                return True
        elif not _same_container_type(a, b) and a is not b:  # mutable containers are diffed in place
            return True
    return False


def _diff_container_tree(cur: Any, orig: Any, path: tuple, muts: list, extras: list) -> None:
    """Record the writes the traced function made to its input containers
    (thunder_tpu/api.py:279): ``set`` and ``del`` of a dict key, ``resync``
    of a list that changed length or identity. The baseline has fresh
    containers at every level, so containers are compared by recursion,
    never by identity."""
    if isinstance(orig, dict) and isinstance(cur, dict):
        for k in orig:
            if k not in cur:
                muts.append(("del", path, k))
        for k, v in cur.items():
            ov = orig.get(k, _MISSING)
            if isinstance(v, tuple) and isinstance(ov, tuple):
                if _tuple_replaced(v, ov):
                    muts.append(("set", path, k, _mutation_value_spec(v, extras)))
                else:
                    _diff_container_tree(v, ov, path + (k,), muts, extras)
            elif _same_container_type(v, ov):
                _diff_container_tree(v, ov, path + (k,), muts, extras)
            elif ov is _MISSING or ov is not v:
                muts.append(("set", path, k, _mutation_value_spec(v, extras)))
    elif isinstance(orig, list) and isinstance(cur, list):
        if len(cur) != len(orig) or any(
            (a is not b and not _same_container_type(a, b))
            or (isinstance(a, tuple) and isinstance(b, tuple) and _tuple_replaced(a, b))
            for a, b in zip(cur, orig)
        ):
            muts.append(("resync", path, [_mutation_value_spec(v, extras) for v in cur]))
        else:
            for i, (a, b) in enumerate(zip(cur, orig)):
                _diff_container_tree(a, b, path + (i,), muts, extras)
    elif isinstance(orig, tuple) and isinstance(cur, tuple) and len(orig) == len(cur):
        # A tuple cannot be rebound in the caller: recursion alone is right.
        for i, (a, b) in enumerate(zip(cur, orig)):
            _diff_container_tree(a, b, path + (i,), muts, extras)


def _collect_input_mutations(proxied_args, proxied_kwargs, pristine_args, pristine_kwargs,
                             tensor_leaves) -> tuple[list, list]:
    """``(records, extra outputs)`` of the traced function's writes to its
    inputs (thunder_tpu/api.py:319): its container writes, and a ``tensor``
    record for each input tensor it updated in place."""
    muts: list = []
    extras: list = []
    _diff_container_tree(proxied_args, pristine_args, ("args",), muts, extras)
    _diff_container_tree(proxied_kwargs, pristine_kwargs, ("kwargs",), muts, extras)
    for i, p in enumerate(tensor_leaves):
        fp = resolve_inplace(p)
        if fp is not p:
            extras.append(fp)
            muts.append(("tensor", i, ("out", len(extras) - 1)))
    return muts, extras


def trace_program(fn: Callable, args: tuple, kwargs: dict, *, record_input_mutations: bool = False,
                  symbolic_marks: Optional[dict] = None) -> tuple[TraceCtx, TraceCtx]:
    """Acquire ``fn`` as (prologue_trace, computation_trace).

    The computation trace takes the tensor leaves of ``(args, kwargs)`` in
    pytree order; numbers and strings are baked in and guarded by the
    prologue. The writes ``fn`` makes to its inputs (container writes, input
    tensors updated in place) are always detected and listed on
    ``comp_trc._input_mutations``; with ``record_input_mutations`` (the jit
    path; the module frontend has its own epilogue) the values they need are
    returned beside the output, ``{"__out": ..., "__muts": (...)}``, and
    replayed onto the caller's objects after the run (``_build_epilogue``).
    ``symbolic_marks`` (``cache="symbolic values"``): ``{tensor leaf:
    {dim: (lo, hi, class)}}``, the dims the prologue guards by bucket
    instead of by extent; the example inputs are already padded to ``hi``."""
    comp_trc = TraceCtx(fn)
    comp_trc.name = "computation"

    with tracectx(comp_trc):
        proxied_args = _proxify_tree(args)
        proxied_kwargs = _proxify_tree(kwargs)
    pristine_args = _copy_container_tree(proxied_args)
    pristine_kwargs = _copy_container_tree(proxied_kwargs)

    leaves, _ = tree_flatten((proxied_args, proxied_kwargs))
    tensor_leaves = [p for p in leaves if isinstance(p, TensorProxy)]
    for li, dims in (symbolic_marks or {}).items():
        tensor_leaves[li]._symbolic_dims = dict(dims)
    comp_trc.args = tuple(tensor_leaves)
    # Concrete example inputs aligned with the tensor args, for guarded
    # concretization of input-derived scalars (core/concrete.py).
    flat_concrete, _ = tree_flatten((args, kwargs))
    comp_trc._concrete_leaves = [c for c, p in zip(flat_concrete, leaves) if isinstance(p, TensorProxy)]

    from thunder_tpu_torch.frontend.sharp import sharp_edge_interceptors

    with tracectx(comp_trc):
        with langctx_ctx(Languages.TORCH), sharp_edge_interceptors():
            result = fn(*proxied_args, **proxied_kwargs)
        if getattr(comp_trc, "_inplace_seen", False):
            result = resolve_inplace_tree(result)
        muts, extras = _collect_input_mutations(proxied_args, proxied_kwargs, pristine_args, pristine_kwargs,
                                                tensor_leaves)
        comp_trc._input_mutations = muts
        if muts and record_input_mutations:
            kinds = ", ".join(sorted({m[0] for m in muts}))
            sharp_edge(f"traced function mutates its inputs ({kinds}): the final values are replayed onto "
                       "the caller's objects after execution (epilogue)")
            result = {"__out": result, "__muts": tuple(extras)}
        prims.python_return(result)
    comp_trc.output = result

    # The prologue guards the caller's structure as it was before fn wrote
    # into it.
    plg = _build_prologue(args, kwargs, pristine_args, pristine_kwargs, tensor_leaves)
    # Drop the concrete inputs so a cached trace does not pin the first
    # call's tensors for the life of the process.
    comp_trc._concrete_leaves = None
    comp_trc._tconst_memo = None
    return plg, comp_trc


# =============================================================================
# Compilation and dispatch
# =============================================================================


def _fn_name(cd: CompileData) -> str:
    return getattr(cd.fn, "__name__", repr(cd.fn))


def _compile_entry(cd: CompileData, cs: CompileStats, args: tuple, kwargs: dict) -> CacheEntry:
    """Trace, transform, claim and stage one entry, under the compile's
    ``debug_checks`` (the trace verifier after every pass;
    thunder_tpu/api.py:451-458) and its observability bracket: a compile id
    the passes' events carry, ``compile_start`` and, under ``cache="symbolic
    values"``, ``bucket_select`` (thunder_tpu/api.py:456-480). The marked
    dims are lifted into bucket guards and the entry is traced on the inputs
    padded to the bucket ceilings."""
    with debug_checks(cd.compile_options.get("debug_checks")), \
            obs_events.compile_scope(cd.event_log) as compile_id:
        obs_events.emit_event("compile_start", compile_id=compile_id, fn=_fn_name(cd),
                              cache_option=cd.cache_option.name.lower(), call=cs.calls)
        sym_spec = None
        # De-opt ladder (resilience/deopt.py): L3 compiles exact shapes, with
        # no bucket padding; L2 rematerializes the joint program under
        # aggressive_remat, scoped here so that an aborted compile cannot
        # leak it.
        level = deopt_mod.current_level(cd)
        if cd.cache_option is CACHE_OPTIONS.SYMBOLIC_VALUES and level < 3:
            sym_spec = _symbolic_spec_for_call(cd, cs, args, kwargs)
        if sym_spec is not None:
            obs_events.emit_event("bucket_select", compile_id=compile_id, buckets=sym_spec.describe(),
                                  marks={str(li): sorted(d.keys()) for li, d in sym_spec.marks.items()})
            args, kwargs = _pad_example(args, kwargs, sym_spec)
        if level >= 2:
            from thunder_tpu_torch.transforms.rematerialization import aggressive_remat

            with aggressive_remat():
                return _compile_entry_impl(cd, cs, args, kwargs, sym_spec, compile_id, level)
        return _compile_entry_impl(cd, cs, args, kwargs, sym_spec, compile_id, level)


def _record_compile_phase(compile_id, phase: str, seconds: float, *, log=None, **extra) -> None:
    """One compile-pipeline span (thunder_tpu/api.py:543-565): a
    ``compile_phase`` event correlated by compile id and the
    ``thunder_tpu_compile_phase_s{phase=...}`` histogram. The port's phases:
    trace, transforms, claim (claiming, the dels, codegen and the staging
    wrapper), then the entry's first call (warmup: eager, on the card under
    the sync check) and its CUDA-graph capture (capture, at the second
    call). The port has no XLA compile."""
    if obsm.enabled():
        obsm.COMPILE_PHASE_S.observe(seconds, phase=phase)
    target = log if log is not None else obs_events.active_log()
    fields = dict(compile_id=compile_id, phase=phase, s=round(seconds, 6), **extra)
    if target is not None:
        target.emit("compile_phase", **fields)
    else:
        obs_events.tap_event("compile_phase", fields)


def _compile_entry_impl(cd: CompileData, cs: CompileStats, args: tuple, kwargs: dict, sym_spec,
                        compile_id: Optional[int], deopt_level: int = 0) -> CacheEntry:
    start = time.perf_counter()
    # Chaos seam: an injected compile failure or timeout takes the recovery
    # path (the de-opt ladder) a real one would.
    chaos_mod.compile_seam(_fn_name(cd))
    cs.last_trace_tracing_start = timer_ns()
    with sharp_edges_policy(cd.sharp_edges):
        plg_trc, comp_trc = trace_program(cd.fn, args, kwargs, record_input_mutations=True,
                                          symbolic_marks=None if sym_spec is None else sym_spec.marks)
    mark(comp_trc, "Acquisition")
    mark(plg_trc, "Prologue construction")
    cs.last_trace_tracing_stop = timer_ns()
    phases = {"trace": time.perf_counter() - start}
    input_mutations = comp_trc._input_mutations
    if input_mutations and cd.trace_transforms:
        raise NotImplementedError("the traced function mutates its inputs, which cannot be combined with trace "
                                  "transforms (grad/value_and_grad/autocast): make the function pure or apply "
                                  "updates outside it")
    value_guards = value_guards_of(comp_trc)

    traces = [comp_trc]
    comp_trc = dce(comp_trc)
    traces.append(comp_trc)
    comp_trc = cse(comp_trc)
    traces.append(comp_trc)
    if sym_spec is not None:
        # Reductions over padded dims are masked against the true extents
        # before grad, so the masked program is the one differentiated.
        comp_trc, sym_spec.mask_classes, sym_spec.crop_plan, pad_warnings = thread_pad_masks(comp_trc, sym_spec)
        comp_trc = dce(comp_trc)
        traces.append(comp_trc)
        for w in pad_warnings:
            warnings.warn(f"cache='symbolic values': {w}", stacklevel=4)
    for transform in cd.trace_transforms:
        comp_trc = transform(comp_trc)
        traces.append(comp_trc)
    if sym_spec is not None and cd.trace_transforms:
        # grad made new outputs: which of them carry padding.
        sym_spec.crop_plan = analyze_crop_plan(comp_trc, sym_spec)
    # A joint fw+bw trace (from grad): let the flash backward run from the
    # saved (out, lse) instead of recomputing the softmax; skipped from the
    # de-opt ladder's level 1 ("disable fusion").
    if deopt_level < 1:
        comp_trc = save_sdpa_residuals_joint(comp_trc, cd.executors_list)
    # Random draws read a key passed in each call (thunder_tpu/api.py:651).
    comp_trc = functionalize_rng_ops(comp_trc)
    if comp_trc.tags.get(RNG_TAG):
        traces.append(comp_trc)
    phases["transforms"] = time.perf_counter() - start - phases["trace"]
    # The comm scheduler runs on a trace with collectives, and the de-opt
    # ladder turns it off from level 1, so a bad schedule demotes to the
    # certified program order (thunder_tpu/api.py:703).
    extrace = transform_for_execution(comp_trc, cd.executors_list, comm_schedule=deopt_level < 1)
    traces.append(extrace)
    if deopt_level >= 2:
        # De-opt ladder level 2: a joint fw+bw program recomputes cheap
        # forward values in the backward (aggressive_remat is in scope).
        remat = rematerialize_joint(extrace)
        if remat is not extrace:
            remat.tags["claim_breakdown"] = claim_breakdown(remat)
            extrace = remat
            traces.append(extrace)
    claims = extrace.tags.get("claim_breakdown") or {}
    # Chaos seam: NaN-poison a chosen line, after claiming, so the poison is
    # in both the staged entry and the on_nan guard's instrumented re-run.
    poisoned = chaos_mod.maybe_poison_nan(extrace)
    if poisoned is not extrace:
        extrace = poisoned
        traces.append(extrace)
    on_nan = cd.compile_options.get("on_nan")
    claimed_extrace = extrace
    # Per-op instrumentation (observability/instrument.py;
    # thunder_tpu/api.py:710-720): each value-producing line bracketed by
    # host hooks, after claiming (records carry the executor) and before the
    # dels (which then land after the hooks that read the values).
    if cd.instrument_hooks:
        from thunder_tpu_torch.observability.instrument import instrument_for_execution

        extrace = instrument_for_execution(extrace, cd.instrument_hooks)
        traces.append(extrace)
    # The program runs eagerly: the dels are what free each intermediate's
    # device memory as soon as it is dead.
    extrace = del_last_used(extrace)
    traces.append(extrace)

    plg_traces = [plg_trc]
    if cd.cache_option is CACHE_OPTIONS.SAME_INPUT:
        # The caller asserts every call repeats the first one's metadata and
        # values (thunder_tpu/api.py:729-745): the prologue keeps its
        # unpacking and loses its checks. A staged entry's own signature
        # check stays, and raises on inputs of another shape.
        plg_trc = _strip_guards(plg_trc)
        plg_traces.append(plg_trc)
    plg_ex = transform_for_execution(plg_trc, (get_executor("python"),))
    plg_traces.append(plg_ex)
    _maybe_dump_trace(extrace)
    disabled = cd.disable_jit_staging
    if cd.cache_option is CACHE_OPTIONS.NO_CACHING:
        disabled = "cache='no caching' compiles every call, so its program is never called twice"
    if cd.instrument_hooks:
        disabled = "jit(debug_watch=/instrument=): the per-op hooks run on the host between the ops"
    computation_fn, staging_stats = staging.stage(
        extrace.python_callable(), [extrace], cd.device, name=getattr(cd.fn, "__name__", "computation"),
        disabled=disabled, fresh=_key_input if comp_trc.tags.get(RNG_TAG) else None,
        strict=cd.cache_option is CACHE_OPTIONS.SAME_INPUT,
    )
    phases["claim"] = time.perf_counter() - start - phases["trace"] - phases["transforms"]
    flat, treedef = tree_flatten((args, kwargs))
    entry = CacheEntry(
        prologue_fn=plg_ex.python_callable(),
        computation_fn=computation_fn,
        epilogue_fn=_build_epilogue(input_mutations) if input_mutations else None,
        prologue_traces=plg_traces,
        computation_traces=traces,
        value_guards=value_guards,
        staging=staging_stats,
        needs_rng=bool(comp_trc.tags.get(RNG_TAG)),
        sym_spec=sym_spec,
        treedef=treedef,
        leaf_meta=_leaf_meta(flat),
        on_nan=on_nan,
        claimed_extrace=claimed_extrace if on_nan else None,
    )
    entry.stats.degradation_level = deopt_level
    if staging_stats.staged:
        computation_fn.seam = functools.partial(_run_seam, entry)
    entry.stats.trace_s = time.perf_counter() - start
    entry.stats.phases = phases
    entry.compile_id = compile_id
    cs.trace_seconds += entry.stats.trace_s
    cs.compile_count += 1
    for phase in ("trace", "transforms", "claim"):
        _record_compile_phase(compile_id, phase, phases[phase])
    if staging_stats.staged:
        computation_fn.on_capture = lambda s: _record_compile_phase(compile_id, "capture", s, log=cd.event_log)
    # Compile-side metrics and the compile_end event with the claimed
    # trace's executor breakdown (thunder_tpu/api.py:839-860).
    if obsm.enabled():
        obsm.COMPILES.inc()
        if cs.compile_count > 1:
            obsm.RECOMPILES.inc()
        if sym_spec is not None:
            obsm.BUCKET_COMPILES.inc()
        obsm.COMPILE_MS.observe(entry.stats.trace_s * 1e3)
        for ex_name, n in claims.items():
            obsm.CLAIMED_BSYMS.inc(n, executor=ex_name)
        if extrace.tags.get("collective_bytes"):
            obsm.COLLECTIVE_BYTES.inc(extrace.tags["collective_bytes"])
    obs_events.emit_compile_end(compile_id, _fn_name(cd), entry.stats.trace_s * 1e3, extrace,
                                symbolic=sym_spec is not None, recompile=cs.compile_count > 1,
                                staged=staging_stats.staged)
    cs.last_traces = traces
    cs.last_prologue_traces = entry.prologue_traces
    if cd.cache_option is not CACHE_OPTIONS.NO_CACHING:
        cs.cache_entries.append(entry)
    return entry


_GUARD_IDS = {
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA,
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    PrimIDs.CHECK_STRING_VALUE,
    PrimIDs.CHECK_LEN,
    PrimIDs.CHECK_KEYS,
    PrimIDs.CHECK_NONE,
}


def _strip_guards(plg: TraceCtx) -> TraceCtx:
    """The prologue without its ``CHECK_*`` guards (``cache="same input"``)."""
    stripped = from_trace(plg)
    stripped.bound_symbols = [b for b in plg.bound_symbols if b.sym.id not in _GUARD_IDS]
    return stripped


# The trace dump (thunder_tpu/api.py:938-951): each compile's final program
# is appended to a file, for a person to read or edit.
_execution_callback_file = {"path": None}


def set_execution_callback_file(path: Optional[str]) -> None:
    """Append every later compile's final program to ``path`` (None stops)."""
    _execution_callback_file["path"] = path


def _maybe_dump_trace(trc: TraceCtx) -> None:
    path = _execution_callback_file["path"]
    if path:
        with open(path, "a") as f:
            f.write(trc.python())
            f.write("\n\n")


def _key_input(args: tuple) -> set:
    """The RNG key's position in a program's flat inputs: the last."""
    return {len(args) - 1}


_FAST_CACHE_MAX = 4096


def _probe_entries(cs: CompileStats, args: tuple, kwargs: dict, device):
    """The slow tier: run each entry's prologue, newest first; GuardFailure
    is the controlled miss (reference: thunder/__init__.py:409-447). Returns
    the entry, the caller's tensor leaves and the program's inputs
    (:func:`_prepare_inputs`)."""
    for entry in reversed(cs.cache_entries):
        cs.prologue_runs += 1
        entry.stats.prologue_runs += 1
        try:
            flat_inps = entry.prologue_fn(*args, **kwargs)
        except GuardFailure:
            entry.stats.guard_fails += 1
            continue
        prepared = _prepare_inputs(entry, flat_inps, device)
        if entry.value_guards and not check_value_guards(entry.value_guards, prepared[0]):
            entry.stats.guard_fails += 1
            continue
        return entry, flat_inps, prepared
    return None, None, None


def _fast_probe(cs: CompileStats, key: tuple, flat: list, device):
    """The O(1) tier (thunder_tpu/api.py:1733-1762): the entry learned for
    this (tree structure, leaf metadata) key, with no prologue run; its value
    guards are checked again, so a key that several value specializations
    share still reaches the right one."""
    entry = cs.fast_cache.get(key)
    if entry is None:
        return None, None, None
    flat_inps = [x for x in flat if bridge.is_concrete_tensor(x)]
    prepared = _prepare_inputs(entry, flat_inps, device)
    if entry.value_guards and not check_value_guards(entry.value_guards, prepared[0]):
        return None, None, None
    cs.fast_hits += 1
    entry.stats.fast_hits += 1
    return entry, flat_inps, prepared


def _learn(cs: CompileStats, key: tuple, entry: CacheEntry) -> None:
    """Teach the fast tier a key; the table is emptied past 4096 keys."""
    if len(cs.fast_cache) > _FAST_CACHE_MAX:
        cs.fast_cache.clear()
    cs.fast_cache[key] = entry


def _prepare_inputs(entry: CacheEntry, flat_inps, device) -> tuple[list, Optional[dict]]:
    """``(inputs, true extents)``: the caller's tensor leaves on ``device``;
    for a symbolic entry each marked leaf is written into the entry's buffer
    of the bucket ceiling's shape, the tail zeroed on every call, so a
    shorter call never reads a longer one's rows, and the graph reads the
    buffer in place."""
    inps = [bridge.to_torch(x, device) for x in flat_inps]
    spec = entry.sym_spec
    if spec is None:
        return inps, None
    extents = spec.true_extents(flat_inps)
    bufs = entry.pad_buffers
    for li, dims in spec.marks.items():
        x = inps[li]
        buf = bufs.get(li)
        if buf is None:
            shape = list(x.shape)
            for d, (_lo, hi, _cid) in dims.items():
                shape[d] = hi
            buf = bufs[li] = torch.empty(shape, dtype=x.dtype, device=device)
        with torch.no_grad():
            for d in dims:
                n = int(x.shape[d])
                if n < buf.shape[d]:
                    buf.narrow(d, n, buf.shape[d] - n).zero_()
            buf[tuple(slice(0, int(n)) for n in x.shape)].copy_(x)
        inps[li] = buf
    return inps, extents


def _extent_inputs(entry: CacheEntry, extents: dict, device) -> list:
    """The true extents the masked reductions read, one 0-d int32 input
    each, filled in place before the program runs: an ordinary input of a
    staged graph, read by address, never a constant of the capture."""
    out = []
    for cid in entry.sym_spec.mask_classes:
        t = entry.pad_buffers.get(("extent", cid))
        if t is None:
            t = entry.pad_buffers[("extent", cid)] = torch.empty((), dtype=torch.int32, device=device)
        t.fill_(extents[cid])
        out.append(t)
    return out


def _crop_outputs(entry: CacheEntry, out: Any, extents: dict) -> Any:
    """Slice the padded output dims back to the call's true extents (the
    crop plan of ``transforms/padmask.py``). A result that shares memory
    with the entry's input buffers is copied out, since the next call
    writes them."""
    flat, spec = tree_flatten(out)
    for i, dims in entry.sym_spec.crop_plan or ():
        if i < len(flat) and isinstance(flat[i], torch.Tensor):
            for d, cid in dims.items():
                flat[i] = flat[i].narrow(d, 0, int(extents[cid]))
    owned = {b.untyped_storage().data_ptr() for b in entry.pad_buffers.values()}
    flat = [x.clone() if isinstance(x, torch.Tensor) and x.untyped_storage().data_ptr() in owned else x
            for x in flat]
    return tree_unflatten(flat, spec)


def _build_epilogue(muts: list) -> Callable:
    """Replay the writes a traced function made to its inputs onto the
    caller's objects (thunder_tpu/api.py:969, reference:
    thunder/core/jit_ext.py `process_recorded_modifications:1302`).

    Called each run with the caller's ``(args, kwargs)`` and the program's
    ``{"__out", "__muts"}``; returns the output. Record kinds: ``tensor``
    (an input tensor updated in place: its final value is copied into the
    caller's tensor, a numpy input's array), ``set`` and ``del`` (a dict
    key), ``resync`` (a list rebuilt). A tensor written into a container is
    an output of the program: a fresh tensor, never a staged graph's buffer
    (``executors/staging.py`` copies every output out of its pool)."""
    def navigate(args, kwargs, path):
        obj = args if path[0] == "args" else kwargs
        for k in path[1:]:
            obj = obj[k]
        return obj

    def build_value(spec, extras):
        tag, payload = spec
        if tag == "out":
            return extras[payload]
        if tag == "const":
            return payload
        if tag == "dict":
            return {k: build_value(v, extras) for k, v in payload.items()}
        if tag == "list":
            return [build_value(v, extras) for v in payload]
        return tuple(build_value(v, extras) for v in payload)  # "tuple"

    def epilogue(args, kwargs, raw_out):
        extras = raw_out["__muts"]
        # The caller's tensor leaves as the prologue saw them, before any
        # container write below changes the tree.
        callers = [x for x in tree_flatten((args, kwargs))[0] if bridge.is_concrete_tensor(x)]
        for rec in muts:
            if rec[0] == "tensor":
                _, i, spec = rec
                target, val = callers[i], build_value(spec, extras)
                if isinstance(target, torch.Tensor):
                    with torch.no_grad():
                        target.copy_(val.to(target.dtype))
                else:
                    np.copyto(target, val.detach().cpu().numpy().astype(target.dtype, copy=False))
            elif rec[0] == "set":
                _, path, key, spec = rec
                navigate(args, kwargs, path)[key] = build_value(spec, extras)
            elif rec[0] == "del":
                _, path, key = rec
                navigate(args, kwargs, path).pop(key, None)
            else:  # "resync": a list changed length or identity; rebuild it
                _, path, specs = rec
                navigate(args, kwargs, path)[:] = [build_value(s, extras) for s in specs]
        return raw_out["__out"]

    return epilogue


# =============================================================================
# Dispatch keys and symbolic values (thunder_tpu/api.py:1196-1363)
# =============================================================================


def _leaf_part(x: Any) -> tuple:
    """Hashable metadata of one leaf, what the prologue guards: a tensor's
    shape, dtype, device type, requires_grad and framework; a number's or
    string's type and value; an opaque object's type."""
    if isinstance(x, torch.Tensor):
        return ("T", x.shape, x.dtype, x.device.type, x.requires_grad, "torch")
    if isinstance(x, np.ndarray):
        return ("T", x.shape, x.dtype, None, False, "numpy")
    if isinstance(x, (bool, int, float, complex, str)) or x is None:
        return (type(x).__name__, x)
    return ("O", type(x).__name__)


def _leaf_meta(flat: list) -> tuple:
    return tuple(_leaf_part(x) for x in flat)


def _dispatch_key(tree: Any) -> tuple[tuple, list]:
    """``(key, leaves)`` of a call's ``(args, kwargs)`` in one walk: the key
    of the fast tier (thunder_tpu/api.py:1733-1762) is the tree's structure
    (each container's type and length or keys) and every leaf's
    :func:`_leaf_part`; the leaves come in the order the prologue returns
    them (dicts in insertion order)."""
    parts: list = []
    leaves: list = []

    def walk(x):
        if isinstance(x, (tuple, list)):
            parts.append((type(x), len(x)))
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            parts.append((type(x), tuple(x)))
            for v in x.values():
                walk(v)
        else:
            leaves.append(x)
            parts.append(_leaf_part(x))

    walk(tree)
    return tuple(parts), leaves


def _symbolic_spec_for_call(cd: CompileData, cs: CompileStats, args: tuple, kwargs: dict):
    """Which dims this compile lifts symbolic, or None for an exact entry.
    Explicit ``symbolic_dims`` marks apply from the first call; ``"auto"``
    (the default) marks the dims seen varying against a cached entry of the
    same shape class, so params are never padded."""
    flat, treedef = tree_flatten((args, kwargs))
    tensors = [x for x in flat if bridge.is_concrete_tensor(x)]
    shapes = {li: tuple(int(s) for s in x.shape) for li, x in enumerate(tensors)}
    explicit = cd.compile_options.get("symbolic_dims", "auto")
    if explicit is None or explicit == "auto":
        marks_dims = _marks_from_variation(cs, _leaf_meta(flat), treedef)
    elif explicit == "all":
        marks_dims = {li: tuple(range(len(s))) for li, s in shapes.items()}
    elif isinstance(explicit, dict):
        marks_dims = {int(li): tuple(ds) for li, ds in explicit.items()}
    elif isinstance(explicit, (tuple, list)):
        marks_dims = {li: tuple(d for d in explicit if d < len(s)) for li, s in shapes.items()}
    else:
        raise ValueError(f"symbolic_dims: expected 'auto', 'all', a dict of leaf->dims, or a dim tuple; "
                         f"got {explicit!r}")
    marks_dims = {li: ds for li, ds in marks_dims.items() if ds}
    if not marks_dims:
        return None
    return make_symbolic_spec(marks_dims, shapes, cd.compile_options["bucket_policy"])


def _marks_from_variation(cs: CompileStats, cur_meta: tuple, treedef) -> dict:
    """The dims whose extents differ from a cached entry of the same shape
    class, with that entry's own symbolic dims."""
    for entry in reversed(cs.cache_entries):
        if entry.treedef != treedef or len(entry.leaf_meta) != len(cur_meta):
            continue
        entry_marks = entry.sym_spec.marks if entry.sym_spec is not None else {}
        marks: dict[int, tuple] = {}
        li = -1
        ok = True
        for cm, em in zip(cur_meta, entry.leaf_meta):
            if cm[0] == "T" or em[0] == "T":
                if cm[0] != "T" or em[0] != "T":
                    ok = False
                    break
                li += 1
                if cm[2:] != em[2:] or len(cm[1]) != len(em[1]):
                    ok = False  # another dtype, device or rank: not this entry's class
                    break
                dims = set(entry_marks.get(li, {})) | {d for d in range(len(cm[1])) if cm[1][d] != em[1][d]}
                if dims:
                    marks[li] = tuple(sorted(dims))
            elif cm != em:
                ok = False
                break
        if ok and marks:
            return marks
    return {}


def _pad_example(args: tuple, kwargs: dict, sym_spec) -> tuple[tuple, dict]:
    """The example inputs zero-padded to the bucket ceilings: the shapes the
    symbolic trace is acquired on."""
    flat, treedef = tree_flatten((args, kwargs))
    pos = [i for i, x in enumerate(flat) if bridge.is_concrete_tensor(x)]
    for li, dims in sym_spec.marks.items():
        flat[pos[li]] = _pad_concrete(flat[pos[li]], {d: hi for d, (_lo, hi, _cid) in dims.items()})
    return tree_unflatten(flat, treedef)


def _pad_concrete(x: Any, targets: dict):
    widths = [(0, max(0, int(targets.get(d, n)) - int(n))) for d, n in enumerate(x.shape)]
    if not any(w for _, w in widths):
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, widths)
    out = torch.zeros([n + w for n, (_, w) in zip(x.shape, widths)], dtype=x.dtype, device=x.device)
    with torch.no_grad():
        out[tuple(slice(0, n) for n in x.shape)] = x
    return out.requires_grad_(x.requires_grad)


def _observe_dispatch(entry: CacheEntry, hit_kind: Optional[str], lookup_ns: int, start_ns: int,
                      flat_inps: list) -> None:
    """A call's metrics, with metrics on: a hit's kind (fast, slow,
    same_input; None: a miss), lookup and whole-dispatch host µs, and
    under symbolic values the elements of padding dispatched (the bucket
    ceiling's extents less the call's; thunder_tpu/executors/jaxex.py:630)."""
    if hit_kind is not None:
        obsm.CACHE_HITS.inc(kind=hit_kind)
        obsm.CACHE_LOOKUP_US.observe(lookup_ns / 1e3)
        obsm.DISPATCH_US.observe((time.perf_counter_ns() - start_ns) / 1e3)
    spec = entry.sym_spec
    if spec is not None:
        waste = 0
        for li, dims in spec.marks.items():
            shape = [int(n) for n in flat_inps[li].shape]
            padded = [dims[d][1] if d in dims else n for d, n in enumerate(shape)]
            waste += int(np.prod(padded)) - int(np.prod(shape))
        if waste:
            obsm.PADDING_WASTE_ELEMENTS.inc(waste)


def _run_seam(entry: CacheEntry) -> None:
    """The dispatch's chaos seam (thunder_tpu/api.py:1077-1087): an injected
    device OOM (its ``oom@<L`` form reads the entry's de-opt level) and the
    collective-straggler delay. One context-variable probe with chaos off."""
    if not chaos_mod.enabled():
        return
    trc = entry.computation_traces[-1] if entry.computation_traces else None
    chaos_mod.run_seam(has_collectives=bool(trc is not None and int(trc.tags.get("collective_bytes") or 0)),
                       deopt_level=entry.stats.degradation_level)


def _guarded_call(entry: CacheEntry, inps: list):
    """The entry's program on ``inps``; under the collective watchdog
    (``resilience/watchdog.py``) when a timeout is configured and the
    program holds collectives (thunder_tpu/api.py:1088-1110). One dict probe
    with no timeout configured."""
    if watchdog_mod.active_timeout() is None:
        return entry.computation_fn(*inps)
    trc = entry.computation_traces[-1] if entry.computation_traces else None
    if entry.collective_lines is None:
        from thunder_tpu_torch.analysis import schedule as sched_mod
        from thunder_tpu_torch.distributed.prims import collective_trace_lines

        entry.collective_lines = tuple(collective_trace_lines(trc)) if trc is not None else ()
        if entry.collective_lines:
            entry.schedule = sched_mod.certify(trc).axis_labels()
    if not entry.collective_lines:
        return entry.computation_fn(*inps)
    return watchdog_mod.guard_call(entry.computation_fn, tuple(inps),
                                   fn_name=getattr(entry.computation_fn, "__name__", "computation"),
                                   trace_lines=entry.collective_lines, schedule=entry.schedule)


# The global RNG seed (thunder_tpu/api.py:957-966): the k-th call of a
# program with random draws after ``seed(n)`` draws from PRNGKey(n + k).
_global_rng = {"seed": 0}


def seed(n: int) -> None:
    """Set the global RNG seed used for traces with random ops."""
    _global_rng["seed"] = int(n)


def _next_key(device) -> "torch.Tensor":
    """The next call's key, copied to ``device`` before the program runs
    (outside any CUDA-graph capture, which refuses a host-to-device copy);
    a staged program takes it as an ordinary copied input."""
    _global_rng["seed"] += 1
    return rngex.host_key(rngex.prng_key_words(_global_rng["seed"]), device)


def _autocast_transforms(autocast: Any) -> tuple:
    """The ``autocast=`` option as the trace transform put first
    (thunder_tpu/api.py:1620-1627): a dtype or its name, or True for bf16."""
    if not autocast:
        return ()
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.transforms.autocast import autocast as autocast_transform

    if isinstance(autocast, bool):
        dtype = dtypes.bfloat16
    elif isinstance(autocast, str):  # numpy knows no "bfloat16" without ml_dtypes
        dtype = getattr(dtypes, autocast.removeprefix("torch."), None)
        if not isinstance(dtype, dtypes.dtype):
            raise ValueError(f"autocast={autocast!r} names no dtype")
    else:
        dtype = dtypes.to_dtype(autocast)
    return (lambda trc: autocast_transform(trc, dtype),)


def jit(
    fn: Optional[Callable] = None,
    *,
    executors: Optional[Sequence] = None,
    device: Any = None,
    cache: Any = "constant values",
    symbolic_dims: Any = "auto",
    buckets: Optional[dict] = None,
    sharp_edges: Any = "allow",
    disable_jit_staging: bool = False,
    autocast: Any = None,
    debug_checks: Optional[bool] = None,
    events: Optional[str] = None,
    debug_watch: Optional[str] = None,
    instrument: Any = None,
    chaos: Any = None,
    on_nan: Optional[str] = None,
    _trace_transforms: Sequence[Callable] = (),
    **module_options,
) -> Callable:
    """Compile ``fn`` for one device.

    ``device`` is where the program runs: CUDA unless the caller passes
    ``device="cpu"``; asking for CUDA with no card raises here. ``executors``
    lists executors or their names in priority order; the default is
    ``[flash, fused, torch]``; ``"norm"`` and ``"quant"`` (the int8 linear,
    ``executors/quantex.py``) are opt-in. On CUDA tensors the kernel
    executors launch their kernels or raise; on CPU tensors they run their
    plain versions.
    ``cache`` (a string or a ``CACHE_OPTIONS`` member) is ``"constant
    values"`` (the default: an entry per input shape, dtype and number
    value; a hit is found in O(1) by the inputs' metadata, else by running
    the entries' prologues), ``"no caching"`` (every call compiles and runs
    eagerly), ``"same input"`` (the caller asserts every call repeats the
    first one: the prologue's guards are stripped and every call runs the
    newest entry; a staged entry given inputs of another shape raises
    ``StagingError``) or ``"symbolic values"``: marked tensor
    dims are guarded by bucket (``lo < d <= hi``) instead of by extent, the
    inputs are zero-padded to the bucket ceiling, reductions over padded
    dims are masked against the true extents (``transforms/padmask.py``) and
    the outputs cropped back, so one trace, and on CUDA one CUDA graph
    captured at the ceiling, serves every extent of a bucket.
    ``symbolic_dims`` says which dims are marked: ``"auto"`` (the dims seen
    varying against an earlier entry), ``"all"``, a dict ``{tensor leaf
    index: (dims...)}`` (leaves counted in pytree order, dicts in insertion
    order) or a dim tuple for every tensor leaf. ``buckets`` sets the bucket
    rules, e.g. ``{"batch": "pow2", "seq": 128}`` (``core/bucketing.py``;
    also the ``THUNDER_TPU_BUCKETS`` environment variable).
    ``sharp_edges`` ("allow", "warn" or "error") says what a tracing-unsafe
    construct (``random``, clocks, ``os.environ`` read while tracing, a
    write into an input) does. A function that writes into its inputs (a
    dict key set or deleted, a list appended to, an input tensor updated in
    place) has the writes replayed onto the caller's objects after each run.
    On CUDA each compiled entry is staged as a CUDA graph (its first call
    runs eagerly, its second captures, later calls replay;
    ``executors/staging.py``); ``disable_jit_staging=True`` runs every call
    eagerly, and an entry that reads the host (``item``, a masked attention's
    verdict) runs eagerly anyway. ``last_staging(fn)`` says which, and why.
    ``autocast`` ("bfloat16", "float16", a dtype, or True for bf16) runs
    the matrix products in that dtype, inputs cast down and results back
    (``transforms/autocast.py``), before any other trace transform.
    A program that draws random numbers takes a fresh key each call
    (``seed``, ``transforms/rng.py``).
    ``debug_checks=True`` runs the static trace verifier
    (``thunder_tpu_torch/analysis``) on the output of every pass of each
    compile and raises ``TraceVerificationError`` naming the pass that broke
    the trace; ``False`` turns it off; None (the default) defers to the
    ``THUNDER_TPU_CHECKS`` environment variable (thunder_tpu/api.py:1562).
    Observability (``thunder_tpu_torch/observability``): ``events="<path>"``
    writes this function's compile and cache events to its own JSONL log
    (else the ``THUNDER_TPU_EVENTS`` log, if any); ``debug_watch="nan"`` (or
    ``"inf"``, ``"nan+inf"``) runs each op and raises ``NaNWatchError`` at
    the first one whose output is not finite, naming its line;
    ``instrument`` takes ``"time"``, ``"memory"``, a hook, a callable or a
    list of these (``observability.instrument_reports(fn)`` reads them). An
    instrumented entry is not staged: it runs eagerly, on the card unless
    the jit is on the CPU.
    Recovery (``thunder_tpu_torch/resilience``): ``chaos`` takes a chaos
    spec string (or ``ChaosConfig``) active around every call of this
    function (else the ``THUNDER_TPU_CHAOS`` one); ``on_nan`` ("raise",
    "rerun-instrumented" or "warn") checks every call's floating outputs for
    NaN/Inf with one host sync, and on a trip raises
    ``NonFiniteOutputError`` (after re-running the call under a NaN watcher
    that names the producing line, for "rerun-instrumented") or warns. A
    compile or first run that fails with an out-of-memory (or an injected
    compile fault) climbs the de-opt ladder and retries; an injected kernel
    fault demotes that executor's claims and retries; every other failure,
    a real kernel failure included, propagates.
    ``_trace_transforms`` (private) are trace-to-trace transforms run after
    dce/cse, before claiming.

    A ``torch.nn.Module`` gives a ``ThunderModule`` (``frontend/module.py``),
    which also takes ``rematerialize=`` (default True), ``autocast=``,
    ``seq_bucket=`` and ``seq_pad_value=``: with ``seq_bucket=m`` dim 1 of
    every tensor input of rank 2 or more is padded with ``seq_pad_value``
    (default 0) up to the next multiple of m and the outputs that carry it
    are cropped back, so every length of a bucket runs one entry. On CUDA
    its compiled forward and backward are staged as a CUDA graph each; it
    takes ``events=`` but refuses ``debug_watch``/``instrument``, as the JAX
    package's module frontend does.
    """
    if fn is None:
        return functools.partial(jit, executors=executors, device=device, cache=cache,
                                 symbolic_dims=symbolic_dims, buckets=buckets, sharp_edges=sharp_edges,
                                 disable_jit_staging=disable_jit_staging, autocast=autocast,
                                 debug_checks=debug_checks, events=events, debug_watch=debug_watch,
                                 instrument=instrument, chaos=chaos, on_nan=on_nan,
                                 _trace_transforms=_trace_transforms, **module_options)

    cache = resolve_cache_option(cache)
    if isinstance(fn, torch.nn.Module):
        if _trace_transforms:
            raise NotImplementedError("trace transforms are not supported on the nn.Module frontend")
        if debug_watch or instrument is not None:
            raise NotImplementedError("debug_watch/instrument are not yet supported on the torch nn.Module "
                                      "frontend — jit the functional forward instead")
        if chaos is not None or on_nan is not None:
            raise NotImplementedError("chaos/on_nan are not yet supported on the torch nn.Module frontend — use "
                                      "THUNDER_TPU_CHAOS for process-wide chaos, or jit the functional forward")
        if cache is not CACHE_OPTIONS.CONSTANT_VALUES:
            raise TypeError("jit(nn.Module) got unexpected options ['cache']: a module buckets its sequences "
                            "with seq_bucket=")
        from thunder_tpu_torch.frontend.module import thunder_module

        return thunder_module(fn, executors=executors, device=device, sharp_edges=sharp_edges,
                              disable_jit_staging=disable_jit_staging, autocast=autocast,
                              debug_checks=debug_checks, events=events, **module_options)
    if module_options:
        raise TypeError(f"jit() got unexpected options {sorted(module_options)}")

    compile_options = {} if autocast is None else {"autocast": autocast}
    if debug_checks is not None:
        compile_options["debug_checks"] = bool(debug_checks)
    if cache is CACHE_OPTIONS.SYMBOLIC_VALUES:
        # The bucket rules, resolved once: defaults <- THUNDER_TPU_BUCKETS <- buckets=.
        compile_options.update(bucket_policy=BucketPolicy.resolve(buckets), symbolic_dims=symbolic_dims)
    on_nan = deopt_mod.resolve_on_nan(on_nan)
    if on_nan is not None:
        compile_options["on_nan"] = on_nan
    cd = CompileData(
        fn=fn,
        executors_list=resolve_executors(executors),
        device=devices.resolve_device(device),
        trace_transforms=_autocast_transforms(autocast) + tuple(_trace_transforms),
        sharp_edges=resolve_sharp_edges_option(sharp_edges),
        disable_jit_staging=bool(disable_jit_staging),
        cache_option=cache,
        compile_options=compile_options,
        event_log=obs_events.log_for_path(events) if events else None,
        chaos=chaos_mod.resolve(chaos),
    )
    if debug_watch or instrument is not None:
        from thunder_tpu_torch.observability.instrument import resolve_hooks

        cd.instrument_hooks = resolve_hooks(debug_watch, instrument)
    cs = CompileStats()

    @functools.wraps(fn)
    def fn_(*args, **kwargs):
        # The jit's device is what a numpy input's guard and conversion mean.
        with devices.default_device(cd.device):
            if cd.event_log is None and cd.chaos is None:
                return _dispatch(args, kwargs)
            # The function's own log and chaos config cover the whole
            # dispatch, so that its run-time events (a capture, an
            # injection, a demotion, a de-opt) land beside its compile's.
            with obs_events.event_scope(cd.event_log), chaos_mod.chaos_scope(cd.chaos):
                return _dispatch(args, kwargs)

    def _dispatch(args: tuple, kwargs: dict):
        cs.calls += 1
        start = cs.last_trace_host_start = cs.last_trace_cache_start = timer_ns()
        entry = flat_inps = prepared = key = None
        hit_kind = "same_input"
        if cd.cache_option is CACHE_OPTIONS.SAME_INPUT and cs.cache_entries:
            # The newest entry, with no probing: its prologue only unpacks
            # (thunder_tpu/api.py:1721-1731).
            entry = cs.cache_entries[-1]
            cs.prologue_runs += 1
            entry.stats.prologue_runs += 1
            flat_inps = entry.prologue_fn(*args, **kwargs)
            prepared = _prepare_inputs(entry, flat_inps, cd.device)
        elif cd.cache_option is not CACHE_OPTIONS.NO_CACHING:
            # Two tiers: the key learned for these inputs' metadata, else
            # every prologue, newest first; a prologue hit teaches the key.
            key, flat = _dispatch_key((args, kwargs))
            entry, flat_inps, prepared = _fast_probe(cs, key, flat, cd.device)
            hit_kind = "fast"
            if entry is None and cs.cache_entries:
                entry, flat_inps, prepared = _probe_entries(cs, args, kwargs, cd.device)
                if entry is not None:
                    cs.slow_hits += 1
                    hit_kind = "slow"
                    _learn(cs, key, entry)
        cs.last_trace_cache_stop = timer_ns()
        lookup_ns = cs.last_trace_cache_stop - start
        cs.cache_lookup_ns += lookup_ns
        if entry is not None:
            cs.cache_hits += 1
            entry.stats.hits += 1
            cs.last_staging = entry.staging
            try:
                out = _run_entry(cd, entry, args, kwargs, flat_inps, prepared, first=False)
            except Exception as e:
                # Resilience (resilience/deopt.py): a recoverable failure of
                # a warm entry evicts it, quarantines or de-opts, and falls
                # through to the recompile below; anything else propagates.
                if not deopt_mod.handle_run_failure(e, cd, cs, entry, 0):
                    raise
                cs.cache_hits -= 1
                entry = None
            else:
                # The hit path's one observability check (thunder_tpu/api.py:1785-1815).
                if obsm.enabled():
                    _observe_dispatch(entry, hit_kind, lookup_ns, start, flat_inps)
                return out
        cs.cache_misses += 1
        if obsm.enabled():
            obsm.CACHE_MISSES.inc()
        obs_events.emit_event("cache_miss", fn=_fn_name(cd), call=cs.calls)
        # Compile and first run under the recovery driver
        # (thunder_tpu/api.py:1806-1850): an injected kernel fault demotes
        # the executor's claims and re-claims; a compile failure or an
        # out-of-memory climbs the de-opt ladder; both retry, bounded, with
        # backoff. Anything else propagates on the first throw, and a failed
        # first run leaves no entry behind.
        attempt = 0
        while True:
            try:
                entry = _compile_entry(cd, cs, args, kwargs)
            except Exception as e:
                if deopt_mod.handle_compile_failure(e, cd, cs, attempt):
                    attempt += 1
                    continue
                raise
            if key is not None:
                _learn(cs, key, entry)
            cs.prologue_runs += 1
            entry.stats.prologue_runs += 1
            entry.stats.hits += 1
            cs.last_staging = entry.staging
            try:
                flat_inps = entry.prologue_fn(*args, **kwargs)
                prepared = _prepare_inputs(entry, flat_inps, cd.device)
                out = _run_entry(cd, entry, args, kwargs, flat_inps, prepared, first=True)
            except Exception as e:
                if deopt_mod.handle_run_failure(e, cd, cs, entry, attempt):
                    attempt += 1
                    continue
                deopt_mod.evict(cs, entry)
                raise
            if obsm.enabled():
                _observe_dispatch(entry, None, lookup_ns, start, flat_inps)
            return out

    def _run_entry(cd: CompileData, entry: CacheEntry, args: tuple, kwargs: dict, flat_inps, prepared,
                   *, first: bool):
        inps, extents = prepared
        if entry.sym_spec is not None:
            inps = inps + _extent_inputs(entry, extents, cd.device)
        if entry.needs_rng:
            inps = inps + [_next_key(cd.device)]
        if not entry.staging.staged:
            # A staged entry runs the seam inside its program's call (a
            # capture included): executors/staging.py.
            _run_seam(entry)
        run_start = time.perf_counter()
        cs.last_trace_host_execution_start = timer_ns()
        out = _guarded_call(entry, inps)
        if first:
            if cd.device.type == "cuda":
                torch.cuda.synchronize(cd.device)
            entry.stats.first_run_s = time.perf_counter() - run_start
            cs.first_run_seconds += entry.stats.first_run_s
            _record_compile_phase(entry.compile_id, "warmup", entry.stats.first_run_s, log=cd.event_log)
        if entry.sym_spec is not None:
            out = _crop_outputs(entry, out, extents)
        if entry.on_nan is not None and not deopt_mod.outputs_finite(out):
            # The post-step isfinite guard (jit(on_nan=...)), on the cropped
            # outputs: a bucket's padding lanes may hold inf/NaN that the
            # crop discards. The attribution re-runs the same inputs.
            deopt_mod.handle_nonfinite(entry, inps, entry.on_nan)
        if entry.epilogue_fn is not None:
            out = entry.epilogue_fn(args, kwargs, out)
        cs.last_trace_host_execution_stop = cs.last_trace_host_stop = timer_ns()
        return out

    fn_._lc_cd = cd
    fn_._lc_cs = cs
    return fn_


# =============================================================================
# Autodiff entry points (reference: thunder/__init__.py `grad:888`)
# =============================================================================


def grad(fn: Optional[Callable] = None, **jit_kwargs) -> Callable:
    """Compile ``fn`` (a scalar-loss function) into a function returning
    gradients w.r.t. its float tensor inputs, fw+bw claimed and run as one
    program.

    Grads are returned as a tuple ordered like the function's float tensor
    leaves (pytree inputs are flattened in argument order). ``jit_kwargs``
    are :func:`jit`'s options. ``grad`` of a :func:`vmap`-ed function takes
    the pullback of the batched program with ones cotangents on its outputs
    (:func:`_grad_of_vmapped`); ``vmap(grad(f))`` gives per-sample
    gradients."""
    if fn is None:
        return functools.partial(grad, **jit_kwargs)
    if getattr(fn, "_lc_vmap_spec", None) is not None:
        return _grad_of_vmapped(fn, return_value=False, options=jit_kwargs)
    from thunder_tpu_torch.transforms.autodiff import grad_transform

    return jit(fn, _trace_transforms=(lambda trc: grad_transform(trc, return_value=False),), **jit_kwargs)


def value_and_grad(fn: Optional[Callable] = None, **jit_kwargs) -> Callable:
    """Like :func:`grad` but returns ``(value, grads)``."""
    if fn is None:
        return functools.partial(value_and_grad, **jit_kwargs)
    if getattr(fn, "_lc_vmap_spec", None) is not None:
        return _grad_of_vmapped(fn, return_value=True, options=jit_kwargs)
    from thunder_tpu_torch.transforms.autodiff import grad_transform

    return jit(fn, _trace_transforms=(lambda trc: grad_transform(trc, return_value=True),), **jit_kwargs)


# =============================================================================
# Function transforms: vmap, grad of a vmapped function, jvp
# (thunder_tpu/api.py:1938-2290)
# =============================================================================
#
# The JAX package applies jax.vmap and jax.jvp to the claimed program; here
# torch.func.vmap and torch.func.jvp apply to the claimed program's
# callable. Under vmap every kernel claim runs through its batching rule
# (executors/batching.py): one launch a call site. The JAX package catches a
# kernel's transform error and re-stages without kernels; the port does not:
# a kernel without a rule raises, naming it.

_TRANSFORM_OPTIONS = ("executors", "device", "disable_jit_staging", "debug_checks")


def _unwrap_compiled(fn: Callable) -> tuple[Callable, tuple, dict]:
    """``(function, trace transforms, options)`` of a function compiled by
    ``jit``/``grad``/``value_and_grad``, so that vmap and jvp re-stage the
    original function with its transforms (grad, autocast) and options
    instead of tracing through the compiled wrapper; ``(fn, (), {})`` for a
    plain function."""
    if isinstance(fn, torch.nn.Module):
        raise NotImplementedError("vmap/jvp of an nn.Module: pass a function of its parameters")
    cd = getattr(fn, "_lc_cd", None)
    if cd is None:
        return fn, (), {}
    return cd.fn, tuple(cd.trace_transforms), {"executors": cd.executors_list, "device": cd.device,
                                               "disable_jit_staging": cd.disable_jit_staging,
                                               "debug_checks": cd.compile_options.get("debug_checks")}


def _transform_options(options: dict, defaults: dict, what: str) -> tuple:
    """``(executors, device, disable_jit_staging, debug_checks)`` of a
    transform: its own options over those of the compiled function it
    wraps."""
    unknown = sorted(set(options) - set(_TRANSFORM_OPTIONS))
    if unknown:
        raise ValueError(f"{what} supports only the options {list(_TRANSFORM_OPTIONS)}; got {unknown}")
    merged = {**defaults, **{k: v for k, v in options.items() if v is not None}}
    return (resolve_executors(merged.get("executors")), devices.resolve_device(merged.get("device")),
            bool(merged.get("disable_jit_staging", False)), merged.get("debug_checks"))


def _staged_flat_fn(fn: Callable, args: tuple, kwargs: dict, *, executors: Sequence,
                    trace_transforms: Sequence[Callable] = ()):
    """Trace ``fn`` on the example ``(args, kwargs)`` and claim it through
    ``_compile_entry``'s passes. Returns ``(claimed trace, whether it
    draws)``: the trace's callable takes the tensor leaves of ``(args,
    kwargs)`` in pytree order, then an RNG key if it draws; numbers and
    strings are constants of the trace. A function that writes into its
    inputs is refused: no epilogue runs on this path."""
    _, comp = trace_program(fn, args, kwargs)
    if comp._input_mutations:
        kinds = ", ".join(sorted({m[0] for m in comp._input_mutations}))
        raise NotImplementedError(f"the traced function mutates its inputs ({kinds}), which cannot be combined "
                                  "with vmap/jvp (the mutation epilogue does not run on this path): make the "
                                  "function pure or apply updates outside it")
    comp = cse(dce(comp))
    for transform in trace_transforms:
        comp = transform(comp)
    comp = functionalize_rng_ops(save_sdpa_residuals_joint(comp, executors))
    extrace = del_last_used(transform_for_execution(comp, executors))
    return extrace, bool(comp.tags.get(RNG_TAG))


def _meta_key(flat_values: list, extra: tuple = ()) -> tuple:
    """Every leaf's metadata (a tensor's shape and dtype, a number's value,
    an object's type): non-tensor leaves are constants of the staged trace,
    so another value is another entry."""
    parts = []
    for x in flat_values:
        if bridge.is_concrete_tensor(x):
            shape, _dev, dt, _rg = bridge.tensor_metadata(x)
            parts.append((tuple(shape), str(dt)))
        elif isinstance(x, (int, float, bool, str, type(None))):
            parts.append((type(x).__name__, x))
        else:
            parts.append(type(x).__name__)
    return tuple(parts) + tuple(extra)


def _vmap_flatten(args: tuple, kwargs: dict, in_axes, device) -> tuple[tuple, list, list]:
    """``(axes a positional arg, axes a tensor leaf, tensor leaves on
    device)``: an arg's axis applies to every tensor leaf of it; kwargs are
    unbatched. The one flattening that vmap and grad of vmap share."""
    if isinstance(in_axes, (tuple, list)):
        check(len(in_axes) == len(args), lambda: f"vmap in_axes has {len(in_axes)} entries but the call has "
                                                 f"{len(args)} positional arguments", ValueError)
        axes = tuple(in_axes)
    else:
        axes = (in_axes,) * len(args)
    flat_axes, flat_args = [], []
    for a, ax in list(zip(args, axes)) + [(kwargs, None)]:
        for x in tree_flatten(a)[0]:
            if bridge.is_concrete_tensor(x):
                flat_axes.append(ax)
                flat_args.append(bridge.to_torch(x, device))
    return axes, flat_axes, flat_args


def _vmap_example(args: tuple, axes: tuple, device) -> tuple:
    """Slice 0 of every batched tensor leaf (``x.select(ax, 0)`` on the
    device): the example the program is traced on."""

    def slice0(x, ax):
        if ax is None or not bridge.is_concrete_tensor(x):
            return x
        return bridge.to_torch(x, device).select(ax, 0)

    return tuple(tree_map(lambda x, _ax=ax: slice0(x, _ax), a) for a, ax in zip(args, axes))


def _slice_verdicts(extrace, in_dims: tuple, needs_rng: bool):
    """``(sites, code)`` of a claimed trace's masked attention under vmap:
    its distinct masks (``flashex.masked_sites``) and a function of the
    batched tensor leaves that gives, as one int64 vector on the device,
    every slice's verdict of every mask (``flashex.mask_verdict``, taken a
    slice as ``lax.cond`` under ``jax.vmap`` takes it), mask-major: V times
    the number of masks, of any V. ``code`` is None when the trace has no
    masked site."""
    from thunder_tpu_torch.core.trace import from_trace

    sites = flashex.masked_sites(extrace)
    if not sites:
        return sites, None
    trc = from_trace(extrace)
    trc.bound_symbols.extend(b for b in extrace.bound_symbols if b.sym.id not in (PrimIDs.RETURN, PrimIDs.DEL))
    with tracectx(trc):
        prims.python_return(tuple(m for m, _ in sites))
    trc.output = tuple(m for m, _ in sites)
    masks_of = torch.func.vmap(dce(trc).python_callable(), in_dims=in_dims, out_dims=0)
    key = [None] if needs_rng else []  # the last input, which no mask reads

    def code(*flat_args):
        with torch.no_grad():
            masks = masks_of(*flat_args, *key)
            return torch.cat([torch.func.vmap(lambda m, _s=shape: flashex.mask_verdict(m, *_s))(mask).long()
                              for mask, (_, shape) in zip(masks, sites)])

    return sites, code


def _stage_vmapped(cs: CompileStats, fn: Callable, transforms: tuple, example: tuple, kwargs: dict, flat_axes: list,
                   out_dims, *, executors, device, disabled: bool, name: str, checks: Optional[bool]) -> Callable:
    """Trace on one slice, bind the kernels to their batching rules, and
    stage ``torch.func.vmap`` of the program as a CUDA graph under jit's
    predicate (the seat of ``jax.jit(jax.vmap(...))``). Returns the call,
    which takes the batched tensor leaves.

    A program with masked attention takes each slice's verdict of each mask
    before it runs and gives them to the claims (``flashex.with_verdicts``,
    a tuple a mask), so that no rule reads the host inside the graph; a value
    guard holds the verdicts, read once a call with the other entries'
    (``core/concrete.first_holding``), and each set of verdicts is an entry
    with its own graph, as the module frontend keeps its masks."""
    from thunder_tpu_torch.core.concrete import ValueGuard, first_holding

    start = time.perf_counter()
    with debug_checks(checks):
        extrace, needs_rng = _staged_flat_fn(fn, example, kwargs, executors=executors, trace_transforms=transforms)
    # The key is the same for every slice: every slice draws the same
    # numbers, as under jax.vmap.
    in_dims = tuple(flat_axes) + ((None,) if needs_rng else ())
    sites, code = _slice_verdicts(extrace, in_dims, needs_rng)
    cs.trace_seconds += time.perf_counter() - start
    entries: list = []  # (guards, staged call, stats, trace)

    def add_entry(flat_args) -> tuple:
        t0 = time.perf_counter()
        trc, guards = extrace, ()
        if sites:
            want = code(*flat_args)
            digits = want.tolist()
            check_value_guards.host_reads += 1
            n = next(x.shape[ax] for x, ax in zip(flat_args, flat_axes) if ax is not None)
            trc = flashex.with_verdicts(extrace, {m.name: tuple(digits[i * n:(i + 1) * n])
                                                  for i, (m, _) in enumerate(sites)})
            # The whole vector is compared on the device and read as one flag.
            guards = (ValueGuard(lambda *a, _w=want: (code(*a) == _w).all(), "bool", True,
                                 f"slice verdicts of {', '.join(m.name for m, _ in sites)}"),)
        staged, stats = staging.stage(torch.func.vmap(batching.batched_callable(trc), in_dims=in_dims,
                                                      out_dims=out_dims), [trc], device, name=name,
                                      disabled=disabled, fresh=_key_input if needs_rng else None)
        cs.trace_seconds += time.perf_counter() - t0
        cs.compile_count += 1
        entries.append((guards, staged, stats, trc))
        return entries[-1]

    def run(*flat_args):
        i = first_holding([e[0] for e in entries], flat_args) if entries else None
        _, staged, stats, trc = entries[i] if i is not None else add_entry(flat_args)
        cs.last_traces = [trc]
        cs.last_staging = stats
        return staged(*flat_args, *([_next_key(device)] if needs_rng else []))

    return run


def vmap(fn: Callable, in_axes=0, out_axes=0, **options) -> Callable:
    """Vectorizing map of a traced program (reference transforms.py
    `vmap:2051`; thunder_tpu/api.py:2137-2199).

    ``fn`` is traced on one slice (slice 0 of each batched leaf), claimed by
    the executors (the kernels included) and run under ``torch.func.vmap``;
    on CUDA the batched program is staged as one CUDA graph, under the same
    predicate as ``jit``. Every kernel claim runs through its batching rule
    (``executors/batching.py``), which folds the slices into the kernel's
    own batch or rows: one launch a call site, whatever the number of
    slices. Masked attention takes each slice's verdict before the call and
    holds the vector of them as a value guard. A claimed kernel without a
    rule (one of an executor registered later) raises
    ``NotImplementedError``, naming it. ``in_axes`` is one
    axis or one per positional argument (None: unbatched; it applies to
    every tensor leaf of the argument); kwargs are unbatched. A keyed draw
    takes one key for all slices, so every slice draws the same numbers, as
    under ``jax.vmap``.

    ``options`` are ``executors``, ``device`` and ``disable_jit_staging``,
    over those of a compiled ``fn``: ``vmap(grad(f))`` re-stages the
    original f with its grad transform and options (per-sample gradients).
    Staging is cached on the inputs' metadata and axes
    (``compile_stats(vmapped)``)."""
    inner_fn, transforms, defaults = _unwrap_compiled(fn)
    executors, device, disabled, checks = _transform_options(options, defaults, "vmap")
    cache: dict = {}
    cs = CompileStats()
    name = f"vmap({getattr(inner_fn, '__name__', 'fn')})"

    def vmapped(*args, **kwargs):
        cs.calls += 1
        with devices.default_device(device):
            axes, flat_axes, flat_args = _vmap_flatten(args, kwargs, in_axes, device)
            key = _meta_key(tree_flatten((args, kwargs))[0], extra=(tuple(flat_axes), out_axes))
            run = cache.get(key)
            if run is None:
                cs.cache_misses += 1
                cs.last_trace_tracing_start = timer_ns()
                run = cache[key] = _stage_vmapped(cs, inner_fn, transforms, _vmap_example(args, axes, device), kwargs,
                                                  flat_axes, out_axes, executors=executors, device=device,
                                                  disabled=disabled, name=name, checks=checks)
                cs.last_trace_tracing_stop = timer_ns()
            else:
                cs.cache_hits += 1
            return run(*flat_args)

    vmapped._lc_cs = cs
    vmapped._lc_vmap_spec = {"fn": inner_fn, "transforms": transforms, "in_axes": in_axes, "out_axes": out_axes,
                             "options": {"executors": executors, "device": device, "disable_jit_staging": disabled,
                                         "debug_checks": checks}}
    return vmapped


def _grad_of_vmapped(vfn: Callable, *, return_value: bool, options: dict) -> Callable:
    """``grad``/``value_and_grad`` of a :func:`vmap`-ed function
    (thunder_tpu/api.py:1938-2015): the pullback of the batched program with
    ones cotangents on every float output, w.r.t. every float tensor leaf.
    It runs as the vmap of each slice's pullback (``grad_transform`` with
    ones cotangents): a batched leaf takes its slices' grads at its axis, an
    unbatched leaf their sum over the slices (the pullback of its
    broadcast). Staged and cached as vmap is; of jit's options only
    ``executors``, ``device`` and ``disable_jit_staging`` apply."""
    from thunder_tpu_torch.transforms.autodiff import _is_float_tensor, grad_transform

    spec = vfn._lc_vmap_spec
    executors, device, disabled, checks = _transform_options(options, spec["options"], "grad(vmap(f))")
    in_axes, out_axes = spec["in_axes"], spec["out_axes"]

    def pullback(trc):
        wrt = [a for a in trc.args if _is_float_tensor(a)]
        return grad_transform(trc, return_value=return_value, wrt=wrt, ones_cotangent=True)

    transforms = spec["transforms"] + (pullback,)
    cache: dict = {}
    cs = CompileStats()
    name = f"grad(vmap({getattr(spec['fn'], '__name__', 'fn')}))"

    def wrapper(*args, **kwargs):
        cs.calls += 1
        with devices.default_device(device):
            axes, flat_axes, flat_args = _vmap_flatten(args, kwargs, in_axes, device)
            key = _meta_key(tree_flatten((args, kwargs))[0], extra=(tuple(flat_axes), out_axes, return_value))
            run = cache.get(key)
            if run is None:
                cs.cache_misses += 1
                run = cache[key] = _stage_vmapped(cs, spec["fn"], transforms, _vmap_example(args, axes, device),
                                                  kwargs, flat_axes, (out_axes, 0) if return_value else 0,
                                                  executors=executors, device=device, disabled=disabled, name=name,
                                                  checks=checks)
            else:
                cs.cache_hits += 1
            result = run(*flat_args)
        value, per_slice = result if return_value else (None, result)
        diff_axes = [ax for x, ax in zip(flat_args, flat_axes) if x.is_floating_point()]
        grads = tuple(g.sum(0) if ax is None else g.movedim(0, ax) for g, ax in zip(per_slice, diff_axes))
        return (value, grads) if return_value else grads

    wrapper._lc_cs = cs
    return wrapper


class _JvpCache:
    """Staged-jvp cache keyed on a weak reference to the function, not its
    ``id`` (which a new closure at a reused address would alias); a
    function that cannot be weakly referenced is keyed strongly, an
    unhashable one is not cached. LRU, 256 entries
    (thunder_tpu/api.py:2202-2259)."""

    MAX_ENTRIES = 256

    def __init__(self):
        from collections import OrderedDict

        self._entries = OrderedDict()

    def _purge(self, dead_ref) -> None:
        for k in [k for k in self._entries if k[0] is dead_ref]:
            del self._entries[k]

    def get(self, fn, key):
        import weakref

        try:
            ref = weakref.ref(fn)
        except TypeError:
            ref = fn
        try:
            value = self._entries.get((ref, key))
        except TypeError:  # unhashable callable: never cached
            return None
        if value is not None:
            self._entries.move_to_end((ref, key))
        return value

    def put(self, fn, key, value) -> None:
        import weakref

        try:
            ref = weakref.ref(fn, self._purge)
        except TypeError:
            ref = fn
        try:
            self._entries[(ref, key)] = value
            self._entries.move_to_end((ref, key))
        except TypeError:  # unhashable callable: not cached
            return
        while len(self._entries) > self.MAX_ENTRIES:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()


_jvp_cache = _JvpCache()
_jvp_stats = CompileStats()
_JVP_EXECUTORS = ("torch",)
_jvp_stats.executors_note = ("jvp claims with the torch executor only: the kernels have no forward-mode rule "
                             "(the JAX package's are custom_vjp, and its jvp ends on the jax executor)")


def jvp(fn: Callable, primals: tuple, tangents: tuple, *, device: Any = None):
    """Forward-mode derivative of a traced program (reference `jvp:2324`;
    thunder_tpu/api.py:2265-2290): ``(outputs, output tangents)``.

    The port's kernels have no forward-mode rule, and neither have the JAX
    package's (``custom_vjp``; its jvp ends on its jax executor). So jvp
    claims with the torch executor alone, decided here before tracing and
    recorded in ``compile_stats(jvp).executors_note``, and runs
    ``torch.func.jvp`` over the claimed program, unstaged (the reference's
    ``jax.jvp(cached, ...)`` is not jitted either). No kernel wrapper sees a
    tangent: each refuses one (``_build.refuse_transformed``).
    ``tangents`` has the structure of ``primals``; a tangent is taken for
    each float tensor leaf, and the leaves of other primals (integer
    indices, numbers) are ignored. The program runs on ``device``: the
    primals' torch device, else CUDA unless ``device="cpu"``. Staging is
    cached per (function, input metadata)."""
    p_leaves = tree_flatten(tuple(primals))[0]
    t_leaves = tree_flatten(tuple(tangents))[0]
    check(len(p_leaves) == len(t_leaves), lambda: "jvp: tangents must have the structure of primals", ValueError)
    if device is None:
        device = next((x.device for x in p_leaves if isinstance(x, torch.Tensor)), None)
    device = devices.resolve_device(device)
    cs = _jvp_stats
    cs.calls += 1
    with devices.default_device(device):
        flat = [bridge.to_torch(x, device) for x in p_leaves if bridge.is_concrete_tensor(x)]
        tans = [bridge.to_torch(t, device) for x, t in zip(p_leaves, t_leaves) if bridge.is_concrete_tensor(x)]
        key = _meta_key(p_leaves, extra=(str(device),))
        cached = _jvp_cache.get(fn, key)
        if cached is None:
            cs.cache_misses += 1
            extrace, needs_rng = _staged_flat_fn(fn, tuple(primals), {}, executors=resolve_executors(_JVP_EXECUTORS))
            cached = (extrace.python_callable(), extrace, needs_rng)
            _jvp_cache.put(fn, key, cached)
        else:
            cs.cache_hits += 1
        call, extrace, needs_rng = cached
        cs.last_traces = [extrace]
        diff = [i for i, x in enumerate(flat) if x.is_floating_point()]
        extra = [_next_key(device)] if needs_rng else []

        def of_diff(*d):
            full = list(flat)
            for i, x in zip(diff, d):
                full[i] = x
            return call(*full, *extra)

        return torch.func.jvp(of_diff, tuple(flat[i] for i in diff), tuple(tans[i] for i in diff))


jvp._lc_cs = _jvp_stats


def _get_cs(fn: Callable) -> CompileStats:
    cs = getattr(fn, "_lc_cs", None)
    check(cs is not None, "Not a thunder_tpu_torch-compiled function", ValueError)
    return cs


def _get_cd(fn: Callable) -> CompileData:
    cd = getattr(fn, "_lc_cd", None)
    check(cd is not None, "Not a thunder_tpu_torch-compiled function", ValueError)
    return cd


def compile_data(fn: Callable) -> CompileData:
    return _get_cd(fn)


def compile_stats(fn: Callable) -> CompileStats:
    return _get_cs(fn)


def last_compile_options(fn: Callable) -> dict:
    """The compile options a pass read, with what for (reference:
    thunder_tpu/api.py:2337): none, as in the JAX package, since no pass
    reads one yet."""
    return {}


def last_traces(fn: Callable) -> list:
    return _get_cs(fn).last_traces


def last_prologue_traces(fn: Callable) -> list:
    """The prologue traces of the entry compiled last: as built, and
    claimed."""
    return _get_cs(fn).last_prologue_traces


def last_backward_traces(fn: Callable) -> list:
    """The backward traces of the last call of a jitted module that ran a
    backward (empty otherwise); a function's ``grad`` traces are joint."""
    return _get_cs(fn).last_backward_traces


def last_staging(fn: Callable):
    """The ``StagingStats`` of the entry ``fn`` ran last: whether it is
    staged as a CUDA graph and, if not, why (``executors/staging.py``)."""
    return _get_cs(fn).last_staging


def cache_hits(fn: Callable) -> int:
    return _get_cs(fn).cache_hits


def cache_misses(fn: Callable) -> int:
    return _get_cs(fn).cache_misses


def cache_info(fn: Callable) -> dict:
    """Cache counters and seconds, with the keys of the JAX package's
    ``cache_info`` (thunder_tpu/api.py:1404): hits split into ``fast_hits``
    (found by the inputs' metadata key) and ``slow_hits`` (found by running
    prologues). ``degradation_level`` is the de-opt ladder position new
    compiles use, and each entry's the level it was compiled at
    (``resilience/deopt.py``); ``predicted_peak_bytes`` is the liveness
    planner's peak of the entry's execution trace
    (``analysis/liveness.py``)."""
    from thunder_tpu_torch.analysis.liveness import plan_liveness

    cd, cs = _get_cd(fn), _get_cs(fn)
    phases: dict = {}
    for e in cs.cache_entries:
        for k, v in e.stats.phases.items():
            phases[k] = phases.get(k, 0.0) + v
    return {
        "cache_option": cd.cache_option.name.lower(),
        "calls": cs.calls,
        "hits": cs.cache_hits,
        "misses": cs.cache_misses,
        "fast_hits": cs.fast_hits,
        "slow_hits": cs.slow_hits,
        "prologue_runs": cs.prologue_runs,
        "compiles": cs.compile_count,
        "recompiles": cs.recompile_count,
        "trace_seconds": cs.trace_seconds,
        "first_run_seconds": cs.first_run_seconds,
        "cache_lookup_us_total": cs.cache_lookup_ns / 1e3,
        "compile_phase_seconds": phases,
        "degradation_level": deopt_mod.current_level(cd),
        "entries": [dict(index=i, symbolic=e.sym_spec is not None,
                         buckets="exact" if e.sym_spec is None else e.sym_spec.describe(),
                         predicted_peak_bytes=plan_liveness(e.computation_traces[-1], include_rows=False).peak_bytes,
                         **e.stats.as_dict())
                    for i, e in enumerate(cs.cache_entries)],
    }
