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
each call and is what decides a cache hit.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch import clang  # registers the clang language  # noqa: F401
from thunder_tpu_torch import torch as ltorch  # registers the torch language  # noqa: F401
from thunder_tpu_torch.common import (
    CacheEntry,
    CompileData,
    CompileStats,
    resolve_sharp_edges_option,
    sharp_edges_policy,
)
from thunder_tpu_torch.core import devices, prims
from thunder_tpu_torch.core.baseutils import GuardFailure
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
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import resolve_inplace, resolve_inplace_tree
from thunder_tpu_torch.core.trace import TraceCtx, mark, tracectx
from thunder_tpu_torch.executors import bridge, pythonex, torchex  # register executors  # noqa: F401
from thunder_tpu_torch.executors import flashex, fusedex, normex  # kernel executors  # noqa: F401
from thunder_tpu_torch.executors import rngex, staging
from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
from thunder_tpu_torch.extend import get_executor, resolve_executors
from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals_joint
from thunder_tpu_torch.transforms.common import cse, dce
from thunder_tpu_torch.transforms.rng import RNG_TAG, functionalize_rng_ops

# The kernel executors claim their composite ops whole; the torch executor
# lowers every remaining prim. The "norm" executor (normex) is opt-in, by
# name, as in the JAX package.
DEFAULT_EXECUTORS = (flashex.ex, fusedex.ex, torchex.ex)


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
                prims.check_tensor_shape_and_metadata(
                    p, tuple(p.shape), str(p.device), p.true_dtype, p.requires_grad,
                    bridge.framework_of(concrete),
                )
            elif isinstance(p, NumberProxy):
                prims.check_number_type_and_value(p, p.value)
            elif isinstance(p, StringProxy):
                prims.check_string_value(p, p.value)
            elif isinstance(p, AnyProxy) and p.value is None:
                prims.check_none(p)
            # Any other leaf is an opaque object: it is baked into the trace
            # and cannot be guarded.

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


def trace_program(fn: Callable, args: tuple, kwargs: dict, *,
                  record_input_mutations: bool = False) -> tuple[TraceCtx, TraceCtx]:
    """Acquire ``fn`` as (prologue_trace, computation_trace).

    The computation trace takes the tensor leaves of ``(args, kwargs)`` in
    pytree order; numbers and strings are baked in and guarded by the
    prologue. With ``record_input_mutations`` (the jit path; the module
    frontend has its own epilogue) the input tensors that ``fn`` updates in
    place are listed on ``comp_trc._input_mutations`` and their final values
    returned beside the output, ``{"__out": ..., "__muts": (...)}``."""
    comp_trc = TraceCtx(fn)
    comp_trc.name = "computation"

    with tracectx(comp_trc):
        proxied_args = _proxify_tree(args)
        proxied_kwargs = _proxify_tree(kwargs)

    leaves, _ = tree_flatten((proxied_args, proxied_kwargs))
    tensor_leaves = [p for p in leaves if isinstance(p, TensorProxy)]
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
        # In-place updates of input tensors (``x.add_(1)``) are returned as
        # extra outputs and copied into the caller's tensors after the run
        # (the JAX package's epilogue, thunder_tpu/api.py:319, :969, for
        # tensors; a container that fn mutates is not replayed).
        muts = [i for i, p in enumerate(tensor_leaves) if resolve_inplace(p) is not p] if record_input_mutations else []
        comp_trc._input_mutations = muts
        if muts:
            result = {"__out": result, "__muts": tuple(resolve_inplace(tensor_leaves[i]) for i in muts)}
        prims.python_return(result)
    comp_trc.output = result

    plg = _build_prologue(args, kwargs, proxied_args, proxied_kwargs, tensor_leaves)
    # Drop the concrete inputs so a cached trace does not pin the first
    # call's tensors for the life of the process.
    comp_trc._concrete_leaves = None
    comp_trc._tconst_memo = None
    return plg, comp_trc


# =============================================================================
# Compilation and dispatch
# =============================================================================


def _compile_entry(cd: CompileData, cs: CompileStats, args: tuple, kwargs: dict) -> CacheEntry:
    start = time.perf_counter()
    with sharp_edges_policy(cd.sharp_edges):
        plg_trc, comp_trc = trace_program(cd.fn, args, kwargs, record_input_mutations=True)
    mark(comp_trc, "Acquisition")
    mark(plg_trc, "Prologue construction")
    phases = {"trace": time.perf_counter() - start}

    traces = [comp_trc]
    comp_trc = dce(comp_trc)
    traces.append(comp_trc)
    comp_trc = cse(comp_trc)
    traces.append(comp_trc)
    for transform in cd.trace_transforms:
        comp_trc = transform(comp_trc)
        traces.append(comp_trc)
    # A joint fw+bw trace (from grad): let the flash backward run from the
    # saved (out, lse) instead of recomputing the softmax.
    comp_trc = save_sdpa_residuals_joint(comp_trc, cd.executors_list)
    # Random draws read a key passed in each call (thunder_tpu/api.py:651).
    comp_trc = functionalize_rng_ops(comp_trc)
    if comp_trc.tags.get(RNG_TAG):
        traces.append(comp_trc)
    phases["transforms"] = time.perf_counter() - start - phases["trace"]
    extrace = transform_for_execution(comp_trc, cd.executors_list)
    traces.append(extrace)
    # The program runs eagerly: the dels are what free each intermediate's
    # device memory as soon as it is dead.
    extrace = del_last_used(extrace)
    traces.append(extrace)

    plg_ex = transform_for_execution(plg_trc, (get_executor("python"),))
    computation_fn, staging_stats = staging.stage(
        extrace.python_callable(), [extrace], cd.device, name=getattr(cd.fn, "__name__", "computation"),
        disabled=cd.disable_jit_staging, fresh=_key_input if comp_trc.tags.get(RNG_TAG) else None,
    )
    phases["claim"] = time.perf_counter() - start - phases["trace"] - phases["transforms"]
    entry = CacheEntry(
        prologue_fn=plg_ex.python_callable(),
        computation_fn=computation_fn,
        prologue_traces=[plg_trc, plg_ex],
        computation_traces=traces,
        value_guards=value_guards_of(traces[0]),
        staging=staging_stats,
        needs_rng=bool(comp_trc.tags.get(RNG_TAG)),
        input_mutations=list(traces[0]._input_mutations),
    )
    entry.stats.trace_s = time.perf_counter() - start
    entry.stats.phases = phases
    cs.trace_seconds += entry.stats.trace_s
    cs.compile_count += 1
    cs.last_traces = traces
    cs.last_prologue_traces = entry.prologue_traces
    cs.cache_entries.append(entry)
    return entry


def _key_input(args: tuple) -> set:
    """The RNG key's position in a program's flat inputs: the last."""
    return {len(args) - 1}


def _probe_entries(cs: CompileStats, args: tuple, kwargs: dict, device):
    """Run each entry's prologue, newest first; GuardFailure is the
    controlled miss (reference: thunder/__init__.py:409-447)."""
    for entry in reversed(cs.cache_entries):
        cs.prologue_runs += 1
        entry.stats.prologue_runs += 1
        try:
            flat_inps = entry.prologue_fn(*args, **kwargs)
        except GuardFailure:
            entry.stats.guard_fails += 1
            continue
        inps = [bridge.to_torch(x, device) for x in flat_inps]
        if entry.value_guards and not check_value_guards(entry.value_guards, inps):
            entry.stats.guard_fails += 1
            continue
        return entry, inps
    return None, None


def _replay_input_mutations(entry: CacheEntry, args: tuple, kwargs: dict, out: dict) -> Any:
    """Copy each updated input's final value into the caller's tensor (a
    numpy input: its array), then return the program's own output."""
    import numpy as np
    import torch

    callers = [x for x in tree_flatten((args, kwargs))[0] if bridge.is_concrete_tensor(x)]
    for i, val in zip(entry.input_mutations, out["__muts"]):
        target = callers[i]
        if isinstance(target, torch.Tensor):
            with torch.no_grad():
                target.copy_(val.to(target.dtype))
        else:
            np.copyto(target, val.detach().cpu().numpy().astype(target.dtype, copy=False))
    return out["__out"]


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
    sharp_edges: Any = "allow",
    disable_jit_staging: bool = False,
    autocast: Any = None,
    _trace_transforms: Sequence[Callable] = (),
    **module_options,
) -> Callable:
    """Compile ``fn`` for one device.

    ``device`` is where the program runs: CUDA unless the caller passes
    ``device="cpu"``; asking for CUDA with no card raises here. ``executors``
    lists executors or their names in priority order; the default is
    ``[flash, fused, torch]``. On CUDA tensors the kernel executors launch
    their kernels or raise; on CPU tensors they run their plain versions.
    ``sharp_edges`` ("allow", "warn" or "error") says what a tracing-unsafe
    construct (``random``, clocks, ``os.environ`` read while tracing) does.
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
    ``_trace_transforms`` (private) are trace-to-trace transforms run after
    dce/cse, before claiming.

    A ``torch.nn.Module`` gives a ``ThunderModule`` (``frontend/module.py``),
    which also takes ``rematerialize=`` (default True) and ``autocast=``;
    the JAX package's ``seq_bucket=``/``seq_pad_value=`` raise, naming the
    slice of the port that brings them. On CUDA its compiled forward and
    backward are staged as a CUDA graph each.
    """
    if fn is None:
        return functools.partial(jit, executors=executors, device=device, sharp_edges=sharp_edges,
                                 disable_jit_staging=disable_jit_staging, autocast=autocast,
                                 _trace_transforms=_trace_transforms, **module_options)

    import torch

    if isinstance(fn, torch.nn.Module):
        if _trace_transforms:
            raise NotImplementedError("trace transforms are not supported on the nn.Module frontend")
        from thunder_tpu_torch.frontend.module import thunder_module

        return thunder_module(fn, executors=executors, device=device, sharp_edges=sharp_edges,
                              disable_jit_staging=disable_jit_staging, autocast=autocast, **module_options)
    if module_options:
        raise TypeError(f"jit() got unexpected options {sorted(module_options)}")

    cd = CompileData(
        fn=fn,
        executors_list=DEFAULT_EXECUTORS if executors is None else resolve_executors(executors),
        device=devices.resolve_device(device),
        trace_transforms=_autocast_transforms(autocast) + tuple(_trace_transforms),
        sharp_edges=resolve_sharp_edges_option(sharp_edges),
        disable_jit_staging=bool(disable_jit_staging),
        compile_options={} if autocast is None else {"autocast": autocast},
    )
    cs = CompileStats()

    @functools.wraps(fn)
    def fn_(*args, **kwargs):
        # The jit's device is what a numpy input's guard and conversion mean.
        with devices.default_device(cd.device):
            return _dispatch(args, kwargs)

    def _dispatch(args: tuple, kwargs: dict):
        cs.calls += 1
        start = time.perf_counter_ns()
        entry, inps = _probe_entries(cs, args, kwargs, cd.device)
        cs.cache_lookup_ns += time.perf_counter_ns() - start
        first = entry is None
        if not first:
            cs.cache_hits += 1
        else:
            cs.cache_misses += 1
            entry = _compile_entry(cd, cs, args, kwargs)
            inps = [bridge.to_torch(x, cd.device) for x in entry.prologue_fn(*args, **kwargs)]
        entry.stats.hits += 1
        cs.last_staging = entry.staging
        if entry.needs_rng:
            inps = inps + [_next_key(cd.device)]
        start = time.perf_counter()
        out = entry.computation_fn(*inps)
        if first:
            if cd.device.type == "cuda":
                torch.cuda.synchronize(cd.device)
            entry.stats.first_run_s = time.perf_counter() - start
            cs.first_run_seconds += entry.stats.first_run_s
        if entry.input_mutations:
            out = _replay_input_mutations(entry, args, kwargs, out)
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
    are :func:`jit`'s options. ``grad`` of a ``vmap``-ed function comes with
    ``vmap`` (ROADMAP.md)."""
    if fn is None:
        return functools.partial(grad, **jit_kwargs)
    from thunder_tpu_torch.transforms.autodiff import grad_transform

    return jit(fn, _trace_transforms=(lambda trc: grad_transform(trc, return_value=False),), **jit_kwargs)


def value_and_grad(fn: Optional[Callable] = None, **jit_kwargs) -> Callable:
    """Like :func:`grad` but returns ``(value, grads)``."""
    if fn is None:
        return functools.partial(value_and_grad, **jit_kwargs)
    from thunder_tpu_torch.transforms.autodiff import grad_transform

    return jit(fn, _trace_transforms=(lambda trc: grad_transform(trc, return_value=True),), **jit_kwargs)


def compile_data(fn: Callable) -> CompileData:
    return fn._lc_cd


def compile_stats(fn: Callable) -> CompileStats:
    return fn._lc_cs


def last_compile_options(fn: Callable) -> dict:
    """The compile options a pass read, with what for (reference:
    thunder_tpu/api.py:2337): none, as in the JAX package, since no pass
    reads one yet."""
    return {}


def last_traces(fn: Callable) -> list:
    return fn._lc_cs.last_traces


def last_prologue_traces(fn: Callable) -> list:
    """The prologue traces of the entry compiled last: as built, and
    claimed."""
    return fn._lc_cs.last_prologue_traces


def last_backward_traces(fn: Callable) -> list:
    """The backward traces of the last call of a jitted module that ran a
    backward (empty otherwise); a function's ``grad`` traces are joint."""
    return fn._lc_cs.last_backward_traces


def last_staging(fn: Callable):
    """The ``StagingStats`` of the entry ``fn`` ran last: whether it is
    staged as a CUDA graph and, if not, why (``executors/staging.py``)."""
    return fn._lc_cs.last_staging


def cache_hits(fn: Callable) -> int:
    return fn._lc_cs.cache_hits


def cache_misses(fn: Callable) -> int:
    return fn._lc_cs.cache_misses


def cache_info(fn: Callable) -> dict:
    """Cache counters and seconds, with the keys of the JAX package's
    ``cache_info`` (thunder_tpu/api.py:1404). The port has no fast path: every
    hit is found by running prologues (``slow_hits``; ``fast_hits`` is 0),
    no de-opt ladder (``degradation_level`` 0) and no liveness planner
    (``predicted_peak_bytes`` None)."""
    cs = fn._lc_cs
    phases: dict = {}
    for e in cs.cache_entries:
        for k, v in e.stats.phases.items():
            phases[k] = phases.get(k, 0.0) + v
    return {
        "cache_option": "constant_values",
        "calls": cs.calls,
        "hits": cs.cache_hits,
        "misses": cs.cache_misses,
        "fast_hits": 0,
        "slow_hits": cs.cache_hits,
        "prologue_runs": cs.prologue_runs,
        "compiles": cs.compile_count,
        "recompiles": cs.recompile_count,
        "trace_seconds": cs.trace_seconds,
        "first_run_seconds": cs.first_run_seconds,
        "cache_lookup_us_total": cs.cache_lookup_ns / 1e3,
        "compile_phase_seconds": phases,
        "degradation_level": 0,
        "entries": [dict(index=i, symbolic=False, buckets="exact", fast_hits=0, degradation_level=0,
                         predicted_peak_bytes=None, **e.stats.as_dict())
                    for i, e in enumerate(cs.cache_entries)],
    }
