"""Distributed collective-consistency rules (the ``dist.*`` rules).

The counterpart of ``thunder_tpu/analysis/collectives.py``. Before a trace
runs on its process groups (``distributed/runtime.py``), every collective
must name a mesh axis, every collective of one axis must agree on the group
size, an async future must resolve through ``wait``, and a joint forward and
backward trace must carry the backward's reduce-scatter for every forward
fsdp parameter sync.
"""

from __future__ import annotations

from typing import Optional

from thunder_tpu_torch.analysis.context import VerifyContext
from thunder_tpu_torch.analysis.diagnostics import Severity
from thunder_tpu_torch.analysis.registry import register_rule
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.distributed.prims import DistOpIDs

# Collective prims carrying (input, axis, group_size, ...) positionally.
_GROUPED_COLLECTIVES = {
    DistOpIDs.ALL_GATHER,
    DistOpIDs.ALL_REDUCE,
    DistOpIDs.BROADCAST,
    DistOpIDs.REDUCE_SCATTER,
    DistOpIDs.SYNCHRONIZE,
    DistOpIDs.ALL_TO_ALL,
}
# Collectives with an axis but no group size at that slot.
_AXIS_ONLY_COLLECTIVES = {DistOpIDs.PPERMUTE, DistOpIDs.MASK_TO_RANK}

_COLLECTIVE_IDS = _GROUPED_COLLECTIVES | _AXIS_ONLY_COLLECTIVES


def collective_axis_of(bsym) -> Optional[str]:
    """The mesh-axis operand of a collective bsym — THE one copy of the
    (input, axis, group_size, ...) calling convention, shared by the dist.*
    rules here and the schedule certificate (analysis/schedule.py). May
    return a malformed (non-str) value; ``dist.axis`` reports those."""
    if len(bsym.args) > 1:
        return bsym.args[1]
    return bsym.kwargs.get("axis")


_collective_axis = collective_axis_of


def _collective_group_size(bsym):
    if len(bsym.args) > 2:
        return bsym.args[2]
    return bsym.kwargs.get("group_size")


def _is_fsdp_sync(bsym) -> bool:
    """A synchronize over a dim-0-sharded (fsdp) parameter."""
    from thunder_tpu_torch.distributed.prims import _sync_is_sharded

    try:
        a = bsym.args[0] if bsym.args else bsym.kwargs.get("a")
        ptype = bsym.args[3] if len(bsym.args) > 3 else bsym.kwargs.get("parallel_type")
        return _sync_is_sharded(a, ptype)
    except Exception:  # noqa: BLE001 — malformed operand; other rules report it
        return False


@register_rule("dist.axis", "Every collective names a mesh axis (a non-empty string)")
def collective_axis(ctx: VerifyContext) -> None:
    for i, bsym in enumerate(ctx.bsyms):
        if bsym.sym.id not in _COLLECTIVE_IDS:
            continue
        axis = _collective_axis(bsym)
        if not isinstance(axis, str) or not axis:
            ctx.report(
                "dist.axis",
                Severity.ERROR,
                f"{bsym.sym.qualname} has mesh axis {axis!r} (expected a non-empty axis name)",
                bsym_index=i,
                hint="collectives lower by named mesh axis; the rewrite must thread the "
                "distributed config's axis name through",
            )


@register_rule("dist.group-size-mismatch", "Collectives sharing a mesh axis agree on the group size")
def group_size_consistency(ctx: VerifyContext) -> None:
    first_by_axis: dict[str, tuple[int, int]] = {}  # axis -> (group_size, bsym index)
    for i, bsym in enumerate(ctx.bsyms):
        if bsym.sym.id not in _GROUPED_COLLECTIVES:
            continue
        axis = _collective_axis(bsym)
        gs = _collective_group_size(bsym)
        if not isinstance(axis, str) or not isinstance(gs, int):
            continue  # dist.axis reports malformed operands
        prev = first_by_axis.get(axis)
        if prev is None:
            first_by_axis[axis] = (gs, i)
        elif prev[0] != gs:
            ctx.report(
                "dist.group-size-mismatch",
                Severity.ERROR,
                f"{bsym.sym.qualname} uses group size {gs} on axis {axis!r}, but bsym "
                f"{prev[1]} uses {prev[0]} — one mesh axis, two replica-group shapes",
                bsym_index=i,
                hint="a rewrite resized the mesh (or mixed configs); all collectives on an "
                "axis must see the same device count",
            )


@register_rule("dist.future-without-wait", "Async collective futures resolve through wait before use")
def future_without_wait(ctx: VerifyContext) -> None:
    for name, producer in ctx.future_defs.items():
        waited = False
        misused = False
        for i in ctx.live_uses.get(name, ()):
            consumer = ctx.bsyms[i]
            if consumer.sym.id is DistOpIDs.WAIT:
                waited = True
            elif consumer.sym.id is not PrimIDs.RETURN:
                misused = True
                ctx.report(
                    "dist.future-without-wait",
                    Severity.ERROR,
                    f"{consumer.sym.qualname} consumes future {name!r} directly; only "
                    "dist_prims.wait may resolve an async collective's result",
                    bsym_index=i,
                    hint="insert wait(future) (or drop async_op=True) before using the value",
                )
        if not waited and not misused and name not in ctx.output_names:
            ctx.report(
                "dist.future-without-wait",
                Severity.WARNING,
                f"future {name!r} (bsym {producer}) is never waited on — the collective's "
                "completion is unobservable",
                bsym_index=producer,
            )


@register_rule(
    "dist.unbalanced-grad-collectives",
    "In a joint fw+bw trace, every fsdp parameter sync has a backward reduce_scatter",
)
def unbalanced_grad_collectives(ctx: VerifyContext) -> None:
    """The FSDP pairing invariant of the backward rewrite: forward all-gathers
    (fsdp ``synchronize``) and backward ``reduce_scatter``s must balance per
    mesh axis. Scoped to joint grad traces (provenance "Grad transform") —
    forward-only traces legitimately carry unpaired gathers."""
    if not (ctx.pass_name or "").startswith("Grad transform"):
        return
    syncs: dict[str, list[int]] = {}
    scatters: dict[str, int] = {}
    for i, bsym in enumerate(ctx.bsyms):
        if bsym.sym.id is DistOpIDs.SYNCHRONIZE and _is_fsdp_sync(bsym):
            if bsym.kwargs.get("grad_sync", True) is False:
                continue  # no_sync: the deferred collective is outside this trace by design
            axis = _collective_axis(bsym)
            if isinstance(axis, str):
                syncs.setdefault(axis, []).append(i)
        elif bsym.sym.id is DistOpIDs.REDUCE_SCATTER:
            axis = _collective_axis(bsym)
            if isinstance(axis, str):
                scatters[axis] = scatters.get(axis, 0) + 1
    for axis, sites in syncs.items():
        n_sync, n_scatter = len(sites), scatters.get(axis, 0)
        if n_scatter < n_sync:
            ctx.report(
                "dist.unbalanced-grad-collectives",
                Severity.WARNING,
                f"axis {axis!r}: {n_sync} fsdp parameter sync(s) in the forward but only "
                f"{n_scatter} reduce_scatter(s) in the backward — a parameter's gradient "
                "is never re-sharded",
                bsym_index=sites[0],
                hint="the synchronize VJP should emit reduce_scatter(grad, axis, group) for "
                "each sharded parameter (check the grad-sync rewrite)",
            )
