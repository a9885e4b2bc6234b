"""The claiming pass and codegen-adjacent passes.

Reference parity: thunder/executors/passes.py (`transform_for_execution:131`
— operator-executor claiming and always-executors — and `del_last_used:232`).

Claiming walks each top-level bound symbol: the first executor in priority
order whose checker accepts it claims it whole; otherwise the pass descends
into the symbol's decomposition (subsymbols). Terminal prims must be claimed
by someone (the torch executor covers those the port runs).
"""

from __future__ import annotations

import copy
import time
from typing import Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, variableify
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, wrap_in_trace_provenance
from thunder_tpu_torch.extend import OperatorExecutor, get_always_executors

_PASSTHROUGH_IDS = {
    PrimIDs.DEL,
    PrimIDs.RETURN,
    PrimIDs.COMMENT,
    PrimIDs.UNPACK_TRIVIAL,
    PrimIDs.UNPACK_SEQUENCE,
    PrimIDs.UNPACK_KEY,
    PrimIDs.UNPACK_ATTR,
    PrimIDs.UNPACK_DIM,  # printer emits `d = t.shape[i]`, any backend
    PrimIDs.TENSOR_CONSTANT,  # printer emits a _call_ctx binding, any backend
}


def _claimed(sym: Symbol, ex: OperatorExecutor) -> Symbol:
    new = copy.copy(sym)
    new.executor = ex
    return new


def transform_for_execution(trace: TraceCtx, executors_list: Sequence[OperatorExecutor]) -> TraceCtx:
    """Claim every bound symbol. There is no re-claim after a failure: a
    kernel that fails raises, and nothing quietly takes its place."""
    start = time.perf_counter_ns()
    executors_list = tuple(executors_list) + get_always_executors()
    new_bsyms: list[BoundSymbol] = []

    def claim(bsym: BoundSymbol) -> None:
        if bsym.sym.id in _PASSTHROUGH_IDS:
            new_bsyms.append(bsym)
            return
        for ex in executors_list:
            if ex.can_execute(bsym):
                new_bsyms.append(bsym.from_bsym(sym=_claimed(bsym.sym, ex)))
                return
        if bsym.sym.python_impl is not None:
            # Host-side op with an inline implementation (guards etc.)
            new_bsyms.append(bsym)
            return
        if not bsym.subsymbols and not (
            bsym.has_tag(OpTags.SIDE_EFFECT) or bsym.has_tag(OpTags.DONT_DCE)
        ):
            # A composite whose decomposition recorded nothing is an identity
            # (e.g. ``x[...]`` with full slices, dropout(p=0)): its outputs
            # ARE its input proxies, so the op can simply be dropped — unless
            # it is tagged effectful, in which case dropping it would erase an
            # observable action.
            arg_vars = {variableify(p) for p in bsym.flat_proxy_args}
            if all(variableify(o) in arg_vars for o in bsym.flat_proxy_outs):
                return
        check(
            len(bsym.subsymbols) > 0,
            lambda: f"No executor for primitive {bsym.sym.qualname} (id {bsym.sym.id}) "
            f"among {[ex.name for ex in executors_list]}",
        )
        for sub in bsym.subsymbols:
            claim(sub)

    for bsym in trace.bound_symbols:
        claim(bsym)

    extrace = from_trace(trace)
    extrace.bound_symbols = new_bsyms
    return wrap_in_trace_provenance(extrace, "Transform for execution", start)


def del_last_used(trace: TraceCtx) -> TraceCtx:
    """Insert ``del`` statements after each proxy's last use
    (reference: passes.py `del_last_used:232`).

    The generated program runs eagerly, so these ``del``s are what frees
    each intermediate's device memory as soon as it is dead; without them
    every intermediate would stay alive until the program returns.
    """
    from thunder_tpu_torch.core import prims

    start = time.perf_counter_ns()
    flat_out, _ = tree_flatten(trace.output)
    keep = {variableify(p) for p in flat_out if isinstance(p, Proxy)}

    seen: set = set()
    rev: list[BoundSymbol] = []
    for bsym in reversed(trace.bound_symbols):
        if bsym.sym.id in (PrimIDs.DEL,):
            continue
        to_del = []
        for p in list(bsym.flat_proxy_args) + list(bsym.flat_proxy_outs):
            v = variableify(p)
            if v in seen or v in keep:
                continue
            seen.add(v)
            to_del.append(p)
        if to_del and bsym.sym.id not in (PrimIDs.RETURN,):
            rev.append(prims.python_del.bind(*to_del, output=None))
        rev.append(bsym)
    new_bsyms = list(reversed(rev))

    ntrace = from_trace(trace)
    ntrace.bound_symbols = new_bsyms
    return wrap_in_trace_provenance(ntrace, "Delete Last Used", start)
