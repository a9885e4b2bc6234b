"""The jit entry point: acquisition → dce/cse → claiming → eager execution.

Reference parity: thunder/__init__.py (`jit:299`, the prologue-guarded cache
loop `:409-447`) and the functional frontend of thunder/functional.py.

The counterpart of ``thunder_tpu/api.py``: trace the program into the IR,
run dce and cse and any trace transform asked for (``grad`` and
``value_and_grad`` add the autodiff transform, after which the
attention-residual pass rewrites the joint trace's attention pairs), let the
executors claim it, print it as Python with ``del`` statements after each
last use, and run it eagerly on one device. The prologue re-checks every
input's metadata on each call and is what decides a cache hit.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch import clang  # registers the clang language  # noqa: F401
from thunder_tpu_torch import torch as ltorch  # registers the torch language  # noqa: F401
from thunder_tpu_torch.common import CacheEntry, CompileData, CompileStats
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
from thunder_tpu_torch.core.trace import TraceCtx, mark, tracectx
from thunder_tpu_torch.executors import bridge, pythonex, torchex  # register executors  # noqa: F401
from thunder_tpu_torch.executors import flashex, fusedex  # kernel executors  # noqa: F401
from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
from thunder_tpu_torch.extend import get_executor, resolve_executors
from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals_joint
from thunder_tpu_torch.transforms.common import cse, dce

# The kernel executors claim their composite ops whole; the torch executor
# lowers every remaining prim.
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


def trace_program(fn: Callable, args: tuple, kwargs: dict) -> tuple[TraceCtx, TraceCtx]:
    """Acquire ``fn`` as (prologue_trace, computation_trace).

    The computation trace takes the tensor leaves of ``(args, kwargs)`` in
    pytree order; numbers and strings are baked in and guarded by the
    prologue."""
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

    with tracectx(comp_trc):
        with langctx_ctx(Languages.TORCH):
            result = fn(*proxied_args, **proxied_kwargs)
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
    plg_trc, comp_trc = trace_program(cd.fn, args, kwargs)
    mark(comp_trc, "Acquisition")
    mark(plg_trc, "Prologue construction")

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
    extrace = transform_for_execution(comp_trc, cd.executors_list)
    traces.append(extrace)
    # The program runs eagerly: the dels are what free each intermediate's
    # device memory as soon as it is dead.
    extrace = del_last_used(extrace)
    traces.append(extrace)

    plg_ex = transform_for_execution(plg_trc, (get_executor("python"),))
    entry = CacheEntry(
        prologue_fn=plg_ex.python_callable(),
        computation_fn=extrace.python_callable(),
        prologue_traces=[plg_trc, plg_ex],
        computation_traces=traces,
        value_guards=value_guards_of(traces[0]),
    )
    cs.last_traces = traces
    cs.cache_entries.append(entry)
    return entry


def _probe_entries(cs: CompileStats, args: tuple, kwargs: dict, device):
    """Run each entry's prologue, newest first; GuardFailure is the
    controlled miss (reference: thunder/__init__.py:409-447)."""
    for entry in reversed(cs.cache_entries):
        try:
            flat_inps = entry.prologue_fn(*args, **kwargs)
        except GuardFailure:
            continue
        inps = [bridge.to_torch(x, device) for x in flat_inps]
        if entry.value_guards and not check_value_guards(entry.value_guards, inps):
            continue
        return entry, inps
    return None, None


def jit(
    fn: Optional[Callable] = None,
    *,
    executors: Optional[Sequence] = None,
    device: Any = None,
    _trace_transforms: Sequence[Callable] = (),
) -> Callable:
    """Compile ``fn`` for eager execution on one device.

    ``device`` is where the program runs: CUDA unless the caller passes
    ``device="cpu"``; asking for CUDA with no card raises here. ``executors``
    lists executors or their names in priority order; the default is
    ``[flash, fused, torch]``. On CUDA tensors the kernel executors launch
    their kernels or raise; on CPU tensors they run their plain versions.
    ``_trace_transforms`` (private) are trace-to-trace transforms run after
    dce/cse, before claiming.
    """
    if fn is None:
        return functools.partial(jit, executors=executors, device=device, _trace_transforms=_trace_transforms)

    cd = CompileData(
        fn=fn,
        executors_list=DEFAULT_EXECUTORS if executors is None else resolve_executors(executors),
        device=devices.resolve_device(device),
        trace_transforms=tuple(_trace_transforms),
    )
    cs = CompileStats()

    @functools.wraps(fn)
    def fn_(*args, **kwargs):
        # The jit's device is what a numpy input's guard and conversion mean.
        with devices.default_device(cd.device):
            return _dispatch(args, kwargs)

    def _dispatch(args: tuple, kwargs: dict):
        entry, inps = _probe_entries(cs, args, kwargs, cd.device)
        if entry is not None:
            cs.cache_hits += 1
            return entry.computation_fn(*inps)
        cs.cache_misses += 1
        entry = _compile_entry(cd, cs, args, kwargs)
        inps = [bridge.to_torch(x, cd.device) for x in entry.prologue_fn(*args, **kwargs)]
        return entry.computation_fn(*inps)

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


def last_traces(fn: Callable) -> list:
    return fn._lc_cs.last_traces


def cache_hits(fn: Callable) -> int:
    return fn._lc_cs.cache_hits


def cache_misses(fn: Callable) -> int:
    return fn._lc_cs.cache_misses
