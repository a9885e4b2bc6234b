"""The claiming pass and codegen-adjacent passes.

Reference parity: thunder/executors/passes.py (`transform_for_execution:131`
— operator-executor claiming, always-executors and fusion passes — and
`del_last_used:232`).

Claiming walks each top-level bound symbol: the first executor in priority
order whose checker accepts it claims it whole; otherwise the pass descends
into the symbol's decomposition (subsymbols). Terminal prims must be claimed
by someone (the torch executor covers those the port runs). Then each
fusion executor in the list rewrites the claimed trace with its
``fusion_pass``, in list order (thunder_tpu/executors/passes.py:107-110).
"""

from __future__ import annotations

import copy
import time
from typing import Sequence

from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import CollectionProxy, Proxy, variableify
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx, wrap_in_trace_provenance
from thunder_tpu_torch.extend import Executor, FusionExecutor, get_always_executors

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


def _claimed(sym: Symbol, ex: Executor) -> Symbol:
    new = copy.copy(sym)
    new.executor = ex
    return new


def transform_for_execution(trace: TraceCtx, executors_list: Sequence[Executor], *,
                            comm_schedule: bool = False) -> TraceCtx:
    """Claim every bound symbol. There is no re-claim after a failure: a
    kernel that fails raises, and nothing quietly takes its place. With
    ``comm_schedule=True`` (and ``THUNDER_TPU_COMM_SCHEDULE`` not 0) the
    collective-overlap scheduler (``transforms/comm_schedule.py``) runs
    over the claimed trace with its default device and capacity."""
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
    for ex in executors_list:
        if isinstance(ex, FusionExecutor):
            extrace = ex.fusion_pass(extrace)
    extrace.tags["claim_breakdown"] = _claim_breakdown(extrace)
    extrace.tags["collective_bytes"] = _collective_bytes(extrace)
    extrace = wrap_in_trace_provenance(extrace, "Transform for execution", start)
    if comm_schedule:
        from thunder_tpu_torch.transforms import comm_schedule as comm_sched

        if comm_sched.enabled():
            extrace, _ = comm_sched.schedule_collectives(extrace)
    return extrace


def _claim_breakdown(trace: TraceCtx) -> dict[str, int]:
    """{executor name (or "host" for python_impl plumbing): claimed bsyms}:
    the payload of the executor-claim metric and of ``compile_end`` events
    (thunder_tpu/executors/passes.py:126)."""
    out: dict[str, int] = {}
    for bsym in trace.bound_symbols:
        ex = bsym.sym.executor
        name = ex.name if ex is not None else "host"
        out[name] = out.get(name, 0) + 1
    return out


def _collective_bytes(trace: TraceCtx) -> int:
    """The bytes of the collectives' tensor operands (COMM_OP symbols), from
    the trace's metadata: a per-trace constant, the payload of
    ``compile_end`` events and of ``COLLECTIVE_BYTES``
    (thunder_tpu/executors/passes.py:136-149). The wire bytes a ring moves
    for them are ``analysis/cost.py``'s."""
    from thunder_tpu_torch.core.proxies import TensorProxy

    return sum(p.size_bytes for bsym in trace.bound_symbols if OpTags.COMM_OP in bsym.sym.tags
               for p in bsym.flat_proxy_args if isinstance(p, TensorProxy))


def del_last_used(trace: TraceCtx) -> TraceCtx:
    """Insert ``del`` statements after each proxy's last use
    (reference: passes.py `del_last_used:232`).

    The generated program runs eagerly, so these ``del``s are what frees
    each intermediate's device memory as soon as it is dead; without them
    every intermediate would stay alive until the program returns.
    """
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


def _clear_printer(bsym) -> str:
    return f"{bsym.args[0].name}.clear()"


# ``coll.clear()`` on a list the program was given (reference:
# thunder/executors/passes.py clear_mutable_collection).
clear_collection = Symbol(
    "clear_collection",
    lambda coll: None,
    id="clear_collection",
    is_prim=True,
    tags=(OpTags.DONT_DCE,),
    python_printer=_clear_printer,
    module="prims",
)


def take_saved_as_list(bw_trace: TraceCtx, n_saved: int) -> TraceCtx:
    """Make a backward trace take its first ``n_saved`` args (the tensors
    saved for it) as one list, which it unpacks and then clears.

    Run eagerly, a tensor passed as an argument stays referenced by the
    caller for the whole call, so ``del`` inside the backward would free no
    saved tensor before it returns. Given as a list that the backward
    clears, each saved tensor is freed at its ``del``, after its last use —
    as long as the caller keeps no other reference (reference: thunder's
    backward takes ``saved_for_backward`` and clears it).
    Run before ``del_last_used``."""
    start = time.perf_counter_ns()
    saved, rest = tuple(bw_trace.args[:n_saved]), tuple(bw_trace.args[n_saved:])
    new = from_trace(bw_trace)
    with tracectx(new):
        coll = CollectionProxy(list(saved), name="saved_for_backward")
    new.args = (coll,) + rest
    new.bound_symbols = [
        prims.unpack_sequence.bind(coll, n_saved, output=list(saved)),
        clear_collection.bind(coll, output=None),
        *bw_trace.bound_symbols,
    ]
    return wrap_in_trace_provenance(new, "Take saved for backward as a list", start)
