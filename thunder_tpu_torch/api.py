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

from thunder_tpu_torch import clang  # registers the clang language  # noqa: F401
from thunder_tpu_torch import torch as ltorch  # registers the torch language  # noqa: F401
from thunder_tpu_torch.common import (
    CACHE_OPTIONS,
    CacheEntry,
    sharp_edge,
    CompileData,
    CompileStats,
    resolve_sharp_edges_option,
    sharp_edges_policy,
)
from thunder_tpu_torch.core import devices, prims
from thunder_tpu_torch.core.baseutils import GuardFailure
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
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.symbol import resolve_inplace, resolve_inplace_tree
from thunder_tpu_torch.core.trace import TraceCtx, mark, tracectx
from thunder_tpu_torch.executors import bridge, pythonex, torchex  # register executors  # noqa: F401
from thunder_tpu_torch.executors import flashex, fusedex, normex, quantex  # kernel executors  # noqa: F401
from thunder_tpu_torch.executors import rngex, staging
from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
from thunder_tpu_torch.extend import get_executor, resolve_executors
from thunder_tpu_torch.transforms.attention_residuals import save_sdpa_residuals_joint
from thunder_tpu_torch.transforms.common import cse, dce
from thunder_tpu_torch.transforms.padmask import analyze_crop_plan, thread_pad_masks
from thunder_tpu_torch.transforms.rng import RNG_TAG, functionalize_rng_ops

# The kernel executors claim their composite ops whole; the torch executor
# lowers every remaining prim. The "norm" (normex) and "quant" (quantex)
# executors are opt-in, by name, as in the JAX package.
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


def _compile_entry(cd: CompileData, cs: CompileStats, args: tuple, kwargs: dict) -> CacheEntry:
    """Trace, transform, claim and stage one entry. Under ``cache="symbolic
    values"`` the marked dims are lifted into bucket guards and the entry is
    traced on the inputs padded to the bucket ceilings
    (thunder_tpu/api.py:450-481)."""
    sym_spec = _symbolic_spec_for_call(cd, cs, args, kwargs) if cd.cache_option == SYMBOLIC_VALUES else None
    if sym_spec is not None:
        args, kwargs = _pad_example(args, kwargs, sym_spec)
    start = time.perf_counter()
    with sharp_edges_policy(cd.sharp_edges):
        plg_trc, comp_trc = trace_program(cd.fn, args, kwargs, record_input_mutations=True,
                                          symbolic_marks=None if sym_spec is None else sym_spec.marks)
    mark(comp_trc, "Acquisition")
    mark(plg_trc, "Prologue construction")
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
    flat, treedef = tree_flatten((args, kwargs))
    entry = CacheEntry(
        prologue_fn=plg_ex.python_callable(),
        computation_fn=computation_fn,
        epilogue_fn=_build_epilogue(input_mutations) if input_mutations else None,
        prologue_traces=[plg_trc, plg_ex],
        computation_traces=traces,
        value_guards=value_guards,
        staging=staging_stats,
        needs_rng=bool(comp_trc.tags.get(RNG_TAG)),
        sym_spec=sym_spec,
        treedef=treedef,
        leaf_meta=_leaf_meta(flat),
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
    controlled miss (reference: thunder/__init__.py:409-447). Returns the
    entry, the caller's tensor leaves and the program's inputs
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
    import torch

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
    import torch

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
    import torch

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
    import numpy as np
    import torch

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
# Symbolic values (thunder_tpu/api.py:1196-1363)
# =============================================================================

CONSTANT_VALUES = "constant values"
SYMBOLIC_VALUES = "symbolic values"


def _leaf_meta(flat: list) -> tuple:
    """Hashable metadata of each leaf, what the prologue guards: a tensor's
    shape, dtype, device type, requires_grad and framework; a number's or
    string's type and value; an opaque object's type."""
    parts = []
    for x in flat:
        if bridge.is_concrete_tensor(x):
            shape, dev, dt, rg = bridge.tensor_metadata(x)
            parts.append(("T", tuple(int(s) for s in shape), str(dt), str(dev).split(":")[0], rg,
                          bridge.framework_of(x)))
        elif isinstance(x, (bool, int, float, complex, str)) or x is None:
            parts.append((type(x).__name__, x))
        else:
            parts.append(("O", type(x).__name__))
    return tuple(parts)


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
    import numpy as np
    import torch

    widths = [(0, max(0, int(targets.get(d, n)) - int(n))) for d, n in enumerate(x.shape)]
    if not any(w for _, w in widths):
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, widths)
    out = torch.zeros([n + w for n, (_, w) in zip(x.shape, widths)], dtype=x.dtype, device=x.device)
    with torch.no_grad():
        out[tuple(slice(0, n) for n in x.shape)] = x
    return out.requires_grad_(x.requires_grad)


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
    cache: str = CONSTANT_VALUES,
    symbolic_dims: Any = "auto",
    buckets: Optional[dict] = None,
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
    ``[flash, fused, torch]``; ``"norm"`` and ``"quant"`` (the int8 linear,
    ``executors/quantex.py``) are opt-in. On CUDA tensors the kernel
    executors launch their kernels or raise; on CPU tensors they run their
    plain versions.
    ``cache`` is ``"constant values"`` (the default: an entry per input
    shape, dtype and number value) or ``"symbolic values"``: marked tensor
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
    ``_trace_transforms`` (private) are trace-to-trace transforms run after
    dce/cse, before claiming.

    A ``torch.nn.Module`` gives a ``ThunderModule`` (``frontend/module.py``),
    which also takes ``rematerialize=`` (default True), ``autocast=``,
    ``seq_bucket=`` and ``seq_pad_value=``: with ``seq_bucket=m`` dim 1 of
    every tensor input of rank 2 or more is padded with ``seq_pad_value``
    (default 0) up to the next multiple of m and the outputs that carry it
    are cropped back, so every length of a bucket runs one entry. On CUDA
    its compiled forward and backward are staged as a CUDA graph each.
    """
    if fn is None:
        return functools.partial(jit, executors=executors, device=device, cache=cache,
                                 symbolic_dims=symbolic_dims, buckets=buckets, sharp_edges=sharp_edges,
                                 disable_jit_staging=disable_jit_staging, autocast=autocast,
                                 _trace_transforms=_trace_transforms, **module_options)

    import torch

    if isinstance(cache, CACHE_OPTIONS):
        cache = cache.value
    if cache not in (CONSTANT_VALUES, SYMBOLIC_VALUES):
        raise ValueError(f"cache={cache!r}: expected {CONSTANT_VALUES!r} or {SYMBOLIC_VALUES!r}")
    if isinstance(fn, torch.nn.Module):
        if _trace_transforms:
            raise NotImplementedError("trace transforms are not supported on the nn.Module frontend")
        if cache != CONSTANT_VALUES:
            raise TypeError("jit(nn.Module) got unexpected options ['cache']: a module buckets its sequences "
                            "with seq_bucket=")
        from thunder_tpu_torch.frontend.module import thunder_module

        return thunder_module(fn, executors=executors, device=device, sharp_edges=sharp_edges,
                              disable_jit_staging=disable_jit_staging, autocast=autocast, **module_options)
    if module_options:
        raise TypeError(f"jit() got unexpected options {sorted(module_options)}")

    compile_options = {} if autocast is None else {"autocast": autocast}
    if cache == SYMBOLIC_VALUES:
        # The bucket rules, resolved once: defaults <- THUNDER_TPU_BUCKETS <- buckets=.
        compile_options.update(bucket_policy=BucketPolicy.resolve(buckets), symbolic_dims=symbolic_dims)
    cd = CompileData(
        fn=fn,
        executors_list=DEFAULT_EXECUTORS if executors is None else resolve_executors(executors),
        device=devices.resolve_device(device),
        trace_transforms=_autocast_transforms(autocast) + tuple(_trace_transforms),
        sharp_edges=resolve_sharp_edges_option(sharp_edges),
        disable_jit_staging=bool(disable_jit_staging),
        cache_option=cache,
        compile_options=compile_options,
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
        entry, flat_inps, prepared = _probe_entries(cs, args, kwargs, cd.device)
        cs.cache_lookup_ns += time.perf_counter_ns() - start
        first = entry is None
        if not first:
            cs.cache_hits += 1
        else:
            cs.cache_misses += 1
            entry = _compile_entry(cd, cs, args, kwargs)
            flat_inps = entry.prologue_fn(*args, **kwargs)
            prepared = _prepare_inputs(entry, flat_inps, cd.device)
        entry.stats.hits += 1
        cs.last_staging = entry.staging
        inps, extents = prepared
        if entry.sym_spec is not None:
            inps = inps + _extent_inputs(entry, extents, cd.device)
        if entry.needs_rng:
            inps = inps + [_next_key(cd.device)]
        start = time.perf_counter()
        out = entry.computation_fn(*inps)
        if first:
            if cd.device.type == "cuda":
                torch.cuda.synchronize(cd.device)
            entry.stats.first_run_s = time.perf_counter() - start
            cs.first_run_seconds += entry.stats.first_run_s
        if entry.sym_spec is not None:
            out = _crop_outputs(entry, out, extents)
        if entry.epilogue_fn is not None:
            out = entry.epilogue_fn(args, kwargs, out)
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
    cd, cs = fn._lc_cd, fn._lc_cs
    phases: dict = {}
    for e in cs.cache_entries:
        for k, v in e.stats.phases.items():
            phases[k] = phases.get(k, 0.0) + v
    return {
        "cache_option": cd.cache_option.replace(" ", "_"),
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
        "entries": [dict(index=i, symbolic=e.sym_spec is not None,
                         buckets="exact" if e.sym_spec is None else e.sym_spec.describe(), fast_hits=0,
                         degradation_level=0,
                         predicted_peak_bytes=None, **e.stats.as_dict())
                    for i, e in enumerate(cs.cache_entries)],
    }
