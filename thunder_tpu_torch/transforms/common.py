"""Common trace passes: DCE, CSE, and the trace evaluator.

Reference parity: thunder/core/transform_common.py (`dce:41`, `cse:194`)
and the evaluation machinery in thunder/core/transforms.py
(`eval_trace:1641`, `visitor_transform:353`); the counterpart of
``thunder_tpu/transforms/common.py``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, Variable, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx, wrap_in_trace_provenance


def has_tag(bsym: BoundSymbol, tag: OpTags) -> bool:
    return bsym.has_tag(tag)


def has_random_op(bsym: BoundSymbol) -> bool:
    """Whether ``bsym`` is a random prim or holds one at any depth."""
    return bsym.has_tag(OpTags.RANDOM_OP) or any(has_random_op(s) for s in bsym.subsymbols)


def dce(trace: TraceCtx, keep: Sequence[Proxy] = ()) -> TraceCtx:
    """Dead-code elimination via a backward liveness sweep
    (reference: transform_common.py `dce:41`)."""
    start = time.perf_counter_ns()
    needed: set[Variable] = {variableify(p) for p in keep}

    # The outputs of the trace are live.
    flat_out, _ = tree_flatten(trace.output)
    needed.update(variableify(p) for p in flat_out if isinstance(p, Proxy))

    new_bsyms: list[BoundSymbol] = []
    for bsym in reversed(trace.bound_symbols):
        # SIDE_EFFECT ops act beyond their outputs (I/O, in-place writes) and
        # must survive even when nothing consumes their result.
        keep_bsym = has_tag(bsym, OpTags.DONT_DCE) or has_tag(bsym, OpTags.SIDE_EFFECT)
        if not keep_bsym:
            keep_bsym = any(variableify(o) in needed for o in bsym.flat_proxy_outs)
        if keep_bsym:
            needed.update(variableify(a) for a in bsym.flat_proxy_args)
            new_bsyms.append(bsym)
    new_bsyms.reverse()

    ntrace = from_trace(trace)
    ntrace.bound_symbols = new_bsyms
    return wrap_in_trace_provenance(ntrace, "Dead Code Elimination", start)


def cse(trace: TraceCtx) -> TraceCtx:
    """Common-subexpression elimination by RHS hashing
    (reference: transform_common.py `cse:194`)."""
    start = time.perf_counter_ns()
    seen: dict[Any, BoundSymbol] = {}
    swap_map: dict[Variable, Proxy] = {}
    new_bsyms: list[BoundSymbol] = []

    for bsym in trace.bound_symbols:
        bsym = bsym.from_bsym_swap_proxies(swap_map, skip_output=True)
        # Effectful ops (SIDE_EFFECT/IN_PLACE) must never be merged: two
        # identical copy_ calls are two observable writes, not one value.
        # Nor two draws: a composite that holds one (dropout) is a draw too,
        # where the JAX package's check sees only a top-level random prim.
        if (
            has_random_op(bsym)
            or has_tag(bsym, OpTags.DONT_DCE)
            or has_tag(bsym, OpTags.SIDE_EFFECT)
            or has_tag(bsym, OpTags.IN_PLACE)
            or not bsym.flat_proxy_outs
        ):
            new_bsyms.append(bsym)
            continue
        rhs = bsym.rhs
        prev = seen.get(rhs)
        if prev is not None:
            for old, new in zip(bsym.flat_proxy_outs, prev.flat_proxy_outs):
                swap_map[variableify(old)] = new
            continue
        seen[rhs] = bsym
        new_bsyms.append(bsym)

    ntrace = from_trace(trace)
    ntrace.bound_symbols = new_bsyms
    # Output proxies may have been replaced.
    flat_out, spec = tree_flatten(ntrace.output)
    ntrace.output = tree_unflatten(
        spec, [swap_map.get(variableify(p), p) if isinstance(p, Proxy) else p for p in flat_out]
    )
    return wrap_in_trace_provenance(ntrace, "Common Subexpression Elimination", start)


def eval_trace(trace: TraceCtx, *args, symbol_mapper: Optional[Callable] = None, **kwargs) -> Any:
    """Interpret a trace, binding ``args`` to the trace's signature proxies.

    The workhorse of transform construction (reference: transforms.py
    `eval_trace:1641`): called under an active trace context it re-records
    the program (possibly transformed per ``symbol_mapper``), and on tensors
    it runs it.
    """
    env: dict[str, Any] = {}

    def bind(proxies, values):
        flat_p, _ = tree_flatten(proxies)
        flat_v, _ = tree_flatten(values)
        for p, v in zip(flat_p, flat_v):
            if isinstance(p, Proxy):
                env[p.name] = v

    bind(trace.args, args)
    bind(trace.kwargs, kwargs)

    def read(x):
        if isinstance(x, Proxy):
            if x.name not in env:
                raise RuntimeError(f"eval_trace: undefined proxy {x.name}")
            return env[x.name]
        return x

    def read_tree(tree):
        flat, spec = tree_flatten(tree)
        return tree_unflatten(spec, [read(x) for x in flat])

    for bsym in trace.bound_symbols:
        if bsym.sym.id == PrimIDs.RETURN:
            break
        if bsym.sym.id in (PrimIDs.DEL, PrimIDs.COMMENT):
            continue
        fn = symbol_mapper(bsym) if symbol_mapper is not None else bsym.sym
        if fn is None:
            continue
        result = fn(*read_tree(bsym.args), **read_tree(bsym.kwargs))
        flat_out, _ = tree_flatten(bsym.output)
        flat_res, _ = tree_flatten(result)
        for p, v in zip(flat_out, flat_res):
            if isinstance(p, Proxy):
                env[p.name] = v

    return read_tree(trace.output)


def visitor_transform(trace: TraceCtx, visit: Callable, provenance: str = "Visitor transform") -> TraceCtx:
    """Rebuild a trace by visiting each bound symbol under a recording scope.

    ``visit(bsym)`` returns None (keep the symbol as it is), or records
    replacement ops into the active scope and returns a swap map
    (``Variable`` -> proxy) for the outputs it replaced.
    Reference parity: transforms.py `visitor_transform:353`.
    """
    start = time.perf_counter_ns()
    ntrace = from_trace(trace)
    swap_map: dict[Variable, Proxy] = {}

    with tracectx(ntrace):
        for bsym in trace.bound_symbols:
            bsym = bsym.from_bsym_swap_proxies(swap_map)
            result = visit(bsym)
            if result is None:
                ntrace.bound_symbols.append(bsym)
            elif isinstance(result, dict):
                swap_map.update(result)

    flat_out, spec = tree_flatten(ntrace.output)
    ntrace.output = tree_unflatten(
        spec, [swap_map.get(variableify(p), p) if isinstance(p, Proxy) else p for p in flat_out]
    )
    return wrap_in_trace_provenance(ntrace, provenance, start)


def replace_redundant_inputs(trace: TraceCtx) -> TraceCtx:
    """Deduplicate repeated proxy inputs (reference: transform_common.py:107).
    The identity, as in the JAX package: a trace's inputs are distinct
    proxies by construction."""
    return trace


def order_proxies(bsyms: Sequence[BoundSymbol]) -> dict[str, int]:
    """Proxy name -> index of the bound symbol that first produces it
    (definition order)."""
    order: dict[str, int] = {}
    for i, bsym in enumerate(bsyms):
        for o in bsym.flat_proxy_outs:
            order.setdefault(o.name, i)
    return order
