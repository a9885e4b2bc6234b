"""Trace-level collective primitives.

The counterpart of ``thunder_tpu/distributed/prims.py``: the same symbols,
metas and VJP rules (reference parity: thunder/distributed/prims.py,
``PrimIDs:13``; the grad rule of ``synchronize`` at ``:260-298`` is where
DDP and FSDP live). The JAX package lowers them to ``jax.lax`` collectives
over a named mesh axis inside ``shard_map``; here the torch executor runs
them on ``torch.distributed``, each axis name resolving to the process group
the runtime bound it to (``distributed/runtime.py``): NCCL on the card, gloo
on the CPU.

``ppermute`` and ``all_to_all`` have VJP rules of their own, the transposes
``lax`` gives the JAX package: the reverse hop, and the shuffle with its split
and concat dims swapped. Every rank must issue both, so dce keeps them when
their result is unused, and the backward transposes them on every rank, with
a zero cotangent where none reaches this rank's output
(``autodiff.register_paired``).

``async_op=True`` keeps the future/wait structure in the IR, as in the JAX
package, and the implementation runs the collective at once (``wait`` is the
identity): on the card the program is captured whole as one CUDA graph, whose
replay orders the collectives on the stream as the trace does.

Each function that issues a ``torch.distributed`` call is a counted wrapper
(``executors/_build.counted``): it adds one to its ``launches`` where it
calls the collective, and a CUDA graph's replay adds what its capture
called, as for the kernels.
"""

from __future__ import annotations

import enum
import sys
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.proxies import FutureTensorProxy, TensorProxy
from thunder_tpu_torch.core.symbol import Symbol, register_module


class DistOpIDs(enum.Enum):
    ALL_GATHER = enum.auto()
    ALL_REDUCE = enum.auto()
    BROADCAST = enum.auto()
    REDUCE_SCATTER = enum.auto()
    SYNCHRONIZE = enum.auto()
    WAIT = enum.auto()
    PPERMUTE = enum.auto()
    ALL_TO_ALL = enum.auto()
    MASK_TO_RANK = enum.auto()
    HIER_ALL_REDUCE = enum.auto()
    AXIS_SLICE = enum.auto()


def _make(id: DistOpIDs, name: str, meta, *, paired: bool = False) -> Symbol:
    """``paired``: every rank must issue the call, used or not (a hop or a
    shuffle whose peers post the matching send or receive), so neither dce
    nor cse may drop or merge it."""
    from thunder_tpu_torch.core.prims import OpTags

    tags = (OpTags.COMM_OP, OpTags.DONT_DCE) if paired else (OpTags.COMM_OP,)
    return Symbol(name, meta, id=id, is_prim=True, module="dist_prims", tags=tags)


def _out(like: TensorProxy, shape=None, future: bool = False) -> TensorProxy:
    cls = FutureTensorProxy if future else TensorProxy
    return cls(like=like, shape=tuple(shape) if shape is not None else tuple(like.shape), requires_grad=False)


# -- metas --------------------------------------------------------------------


def _all_gather_meta(a: TensorProxy, axis: str, group_size: int, *, dim: int = 0, async_op: bool = False,
                     replicated_grad: bool = False):
    """``replicated_grad=True``: every rank uses the gathered value alike, so
    its cotangent is the same on each and the VJP is this rank's block of it
    (:data:`axis_slice`), with no collective. Otherwise the cotangents are
    each rank's part and the VJP sums them (a reduce-scatter)."""
    shape = list(a.shape)
    shape[dim] = shape[dim] * group_size
    return _out(a, shape, future=async_op)


def _all_reduce_meta(a: TensorProxy, axis: str, group_size: int, *, op: str = "sum", async_op: bool = False,
                     replicated_grad: bool = False):
    """``replicated_grad=True``: every rank uses the reduced value alike, so
    its cotangent is the same on each and is the cotangent of every rank's
    part: the VJP passes it on with no collective (Megatron's exit of a
    tensor-parallel block). Otherwise the VJP is an all-reduce."""
    check(op in ("sum", "avg", "max", "min"), lambda: f"Unsupported reduce op {op}")
    return _out(a, future=async_op)


def _broadcast_meta(a: TensorProxy, axis: str, group_size: int, *, root: int = 0, async_op: bool = False):
    return _out(a, future=async_op)


def _reduce_scatter_meta(a: TensorProxy, axis: str, group_size: int, *, op: str = "sum", dim: int = 0,
                         async_op: bool = False):
    check(a.shape[dim] % group_size == 0,
          lambda: f"reduce_scatter dim {dim} ({a.shape[dim]}) not divisible by {group_size}")
    shape = list(a.shape)
    shape[dim] = shape[dim] // group_size
    return _out(a, shape, future=async_op)


def _sync_is_sharded(a, parallel_type: Optional[str]) -> bool:
    from thunder_tpu_torch.core.proxies import DistParallelType

    if parallel_type is not None:
        return parallel_type == "fsdp"
    return getattr(a, "dist_parallel_type", None) == DistParallelType.FULLY_SHARDED


def _synchronize_meta(a: TensorProxy, axis: str, group_size: int, parallel_type: Optional[str] = None, *,
                      grad_scale: Optional[float] = None, grad_sync: bool = True, dim: int = 0):
    """An fsdp parameter enters as its shard along ``dim`` (dim 0 unless
    given) and synchronizes to the full tensor (an all-gather); a replicated
    one passes through. The VJP holds the grad sync. ``grad_sync=False`` is
    the ``no_sync`` variant: its VJP keeps the scaled local grad, with no
    collective."""
    from thunder_tpu_torch.core.proxies import DistParallelType

    if _sync_is_sharded(a, parallel_type):
        shape = list(a.shape)
        shape[dim] *= group_size
        out = TensorProxy(like=a, shape=shape, requires_grad=a.requires_grad)
        out.dist_parallel_type = DistParallelType.NONE
        return out
    return TensorProxy(like=a, requires_grad=a.requires_grad)


def _wait_meta(fut: TensorProxy):
    check(isinstance(fut, FutureTensorProxy), "wait expects a FutureTensorProxy")
    return TensorProxy(like=fut)


def _ppermute_meta(a: TensorProxy, axis: str, perm: Sequence[tuple]):
    return _out(a)


def _mask_to_rank_meta(a: TensorProxy, axis: str, rank: int):
    """Identity on rank ``rank`` of ``axis``, zeros elsewhere (the transpose
    of broadcast's replicate-from-root forward)."""
    return _out(a)


def _hier_all_reduce_meta(a: TensorProxy, inner_axis: str, outer_axis: str, inner_size: int, outer_size: int, *,
                          op: str = "sum"):
    """An all-reduce over two axes as reduce-scatter over ``inner_axis``,
    all-reduce of the shard over ``outer_axis``, all-gather over
    ``inner_axis``; a flat sum over both when dim 0 does not split."""
    check(op in ("sum", "avg"), lambda: f"Unsupported hierarchical reduce op {op}")
    return _out(a)


def _axis_slice_meta(a: TensorProxy, axis: str, group_size: int, *, dim: int = 0):
    """This rank's block of ``a`` along ``dim``: block i of ``group_size``
    on the rank of index i along ``axis``. No collective runs; its VJP
    all-gathers the blocks' cotangents (each rank's block of a value that
    every rank holds alike)."""
    check(a.shape[dim] % group_size == 0,
          lambda: f"axis_slice dim {dim} ({a.shape[dim]}) not divisible by {group_size}")
    shape = list(a.shape)
    shape[dim] //= group_size
    return TensorProxy(like=a, shape=tuple(shape), requires_grad=a.requires_grad)


def _all_to_all_meta(a: TensorProxy, axis: str, group_size: int, *, split_dim: int, concat_dim: int):
    check(a.shape[split_dim] % group_size == 0, "all_to_all split dim not divisible by group size")
    shape = list(a.shape)
    shape[split_dim] = shape[split_dim] // group_size
    shape[concat_dim] = shape[concat_dim] * group_size
    return _out(a, shape)


all_gather = _make(DistOpIDs.ALL_GATHER, "all_gather", _all_gather_meta)
all_reduce = _make(DistOpIDs.ALL_REDUCE, "all_reduce", _all_reduce_meta)
broadcast = _make(DistOpIDs.BROADCAST, "broadcast", _broadcast_meta)
reduce_scatter = _make(DistOpIDs.REDUCE_SCATTER, "reduce_scatter", _reduce_scatter_meta)
synchronize = _make(DistOpIDs.SYNCHRONIZE, "synchronize", _synchronize_meta)
wait = _make(DistOpIDs.WAIT, "wait", _wait_meta)
ppermute = _make(DistOpIDs.PPERMUTE, "ppermute", _ppermute_meta, paired=True)
all_to_all = _make(DistOpIDs.ALL_TO_ALL, "all_to_all", _all_to_all_meta, paired=True)
mask_to_rank = _make(DistOpIDs.MASK_TO_RANK, "mask_to_rank", _mask_to_rank_meta)
hier_all_reduce = _make(DistOpIDs.HIER_ALL_REDUCE, "hier_all_reduce", _hier_all_reduce_meta)
# Not a collective: it reads this rank's index along the axis and moves no
# byte, so it carries no COMM_OP tag and no schedule lane.
axis_slice = Symbol("axis_slice", _axis_slice_meta, id=DistOpIDs.AXIS_SLICE, is_prim=True, module="dist_prims")

register_module("dist_prims", sys.modules[__name__])


def is_collective_bsym(bsym) -> bool:
    """True for a BoundSymbol that dispatches a collective: its id is a
    :class:`DistOpIDs` (but ``axis_slice``, which moves no byte) or it
    carries the COMM_OP tag."""
    from thunder_tpu_torch.core.prims import OpTags

    sym = getattr(bsym, "sym", None)
    if sym is None:
        return False
    if isinstance(sym.id, DistOpIDs):
        return sym.id is not DistOpIDs.AXIS_SLICE
    return OpTags.COMM_OP in (getattr(sym, "tags", None) or ())


def collective_trace_lines(trace, limit: int = 8) -> list:
    """``L<idx>.<sym>`` labels of a trace's collective sites, the spelling
    of the annotated program's profiler ranges; ``limit`` caps the list."""
    if trace is None:
        return []
    lines = []
    for i, bsym in enumerate(getattr(trace, "bound_symbols", ()) or ()):
        if is_collective_bsym(bsym):
            lines.append(f"L{i}.{bsym.sym.name}")
            if limit and len(lines) >= limit:
                break
    return lines


# -- torch.distributed calls ----------------------------------------------------
# The counted wrappers: each issues one torch.distributed collective on the
# group of its axis. Tensors are made contiguous where torch requires it.
# all_gather_into_tensor and reduce_scatter_tensor exist in every torch the
# port runs on; later versions deprecate them for *_single names that earlier
# ones lack, so the old names are called and their FutureWarning is silenced.
warnings.filterwarnings("ignore", message=r"`torch\.distributed\.(all_gather_into_tensor|reduce_scatter_tensor)` "
                        r"is deprecated", category=FutureWarning)


def _group(axis: str, group_size: int):
    from thunder_tpu_torch.distributed import runtime

    return runtime.group_of(axis, group_size)


def _counted(fn):
    from thunder_tpu_torch.executors import _build

    return _build.counted(fn)


@_counted
def coll_all_gather(out, a, group) -> None:
    coll_all_gather.launches += 1
    dist.all_gather_into_tensor(out, a, group=group)


@_counted
def coll_all_reduce(t, op: str, group) -> None:
    coll_all_reduce.launches += 1
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op],
                    group=group)


@_counted
def coll_broadcast(t, src: int, group) -> None:
    coll_broadcast.launches += 1
    dist.broadcast(t, src=src, group=group)


@_counted
def coll_reduce_scatter(out, a, group) -> None:
    coll_reduce_scatter.launches += 1
    dist.reduce_scatter_tensor(out, a, group=group)


@_counted
def coll_all_to_all(out, a, group) -> None:
    coll_all_to_all.launches += 1
    dist.all_to_all_single(out, a, group=group)


@_counted
def coll_ppermute(ops: list) -> None:
    coll_ppermute.launches += 1
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def collective_launches() -> dict:
    """The counted wrappers' counts by collective."""
    return {fn.__name__.removeprefix("coll_"): fn.launches for fn in (
        coll_all_gather, coll_all_reduce, coll_broadcast, coll_reduce_scatter, coll_all_to_all, coll_ppermute)}


# -- torch executor implementations --------------------------------------------


def gather_dim(a, group, group_size: int, dim: int = 0):
    """``a`` gathered from every rank of ``group`` and concatenated along
    ``dim``, in rank order (``lax.all_gather(tiled=True)``)."""
    gathered = torch.empty((group_size,) + tuple(a.shape), dtype=a.dtype, device=a.device)
    coll_all_gather(gathered.view((group_size * a.shape[0],) + tuple(a.shape[1:])) if a.ndim else gathered,
                    a.contiguous(), group)
    out = gathered.movedim(0, dim) if dim else gathered
    shape = list(a.shape)
    shape[dim] *= group_size
    return out.reshape(shape)


def _ag(a, axis, group_size, *, dim=0, async_op=False, replicated_grad=False):
    return gather_dim(a, _group(axis, group_size), group_size, dim)


def _slice(a, axis, group_size, *, dim=0):
    m = a.shape[dim] // group_size
    return a.narrow(dim, dist.get_rank(_group(axis, group_size)) * m, m)


def _reduce(a, group, group_size: int, op: str):
    # gloo has no average: a sum divided by the group's size, on either backend.
    out = a.clone(memory_format=torch.contiguous_format)
    coll_all_reduce(out, "sum" if op == "avg" else op, group)
    return out / group_size if op == "avg" else out


def _ar(a, axis, group_size, *, op="sum", async_op=False, replicated_grad=False):
    return _reduce(a, _group(axis, group_size), group_size, op)


def _bc(a, axis, group_size, *, root=0, async_op=False):
    group = _group(axis, group_size)
    out = a.clone(memory_format=torch.contiguous_format)
    coll_broadcast(out, dist.get_global_rank(group, root), group)
    return out


def scatter_dim(a, group, group_size: int, dim: int = 0, op: str = "sum"):
    """The sum (or average) over ``group`` of ``a``, of which this rank keeps
    its block along ``dim`` (``lax.psum_scatter(tiled=True)``)."""
    shape = list(a.shape)
    m = shape[dim] // group_size
    blocks = a.reshape(shape[:dim] + [group_size, m] + shape[dim + 1:]).movedim(dim, 0).contiguous()
    out = torch.empty(blocks.shape[1:], dtype=a.dtype, device=a.device)
    coll_reduce_scatter(out, blocks.view((group_size * out.shape[0],) + tuple(out.shape[1:])), group)
    return out / group_size if op == "avg" else out


def _rs(a, axis, group_size, *, op="sum", dim=0, async_op=False):
    return scatter_dim(a, _group(axis, group_size), group_size, dim, op)


def _sync(a, axis, group_size, parallel_type=None, *, grad_scale=None, grad_sync=True, dim=0):
    # An fsdp shard all-gathers to the full param; a replicated param passes
    # through (its sync lives in the VJP's all-reduce); a group of one gathers
    # nothing. None is a call site that always gathers.
    if parallel_type == "replicated" or group_size == 1:
        return a
    return gather_dim(a, _group(axis, group_size), group_size, dim)


def _pp(a, axis, perm):
    from thunder_tpu_torch.distributed import runtime

    group = runtime.group_of(axis)
    me = dist.get_rank(group)
    out = torch.zeros_like(a, memory_format=torch.contiguous_format)
    src = a.contiguous()
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(group, d), group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group))
    if ops:
        coll_ppermute(ops)
    return out


def _a2a(a, axis, group_size, *, split_dim, concat_dim):
    group = _group(axis, group_size)
    shape = list(a.shape)
    m = shape[split_dim] // group_size
    chunks = a.reshape(shape[:split_dim] + [group_size, m] + shape[split_dim + 1:]).movedim(split_dim, 0).contiguous()
    received = chunks.new_empty(chunks.shape)
    coll_all_to_all(received, chunks, group)
    chunk = list(chunks.shape[1:])
    out = received.movedim(0, concat_dim)
    return out.reshape(chunk[:concat_dim] + [group_size * chunk[concat_dim]] + chunk[concat_dim + 1:])


def _mask(a, axis, rank):
    from thunder_tpu_torch.distributed import runtime

    return a if dist.get_rank(runtime.group_of(axis)) == rank else torch.zeros_like(a)


def _har(a, inner_axis, outer_axis, inner_size, outer_size, *, op="sum"):
    # Reduce-scatter within the inner group so each rank owns a 1/inner_size
    # shard, all-reduce only the shard across the outer group, gather the
    # inner group back. A shape that does not split along dim 0 takes a flat
    # sum over both groups instead: the same result, full bytes on the outer.
    if inner_size > 1 and a.ndim and a.shape[0] % inner_size == 0:
        inner = _group(inner_axis, inner_size)
        part = scatter_dim(a, inner, inner_size, 0)
        if outer_size > 1:
            part = _reduce(part, _group(outer_axis, outer_size), outer_size, "sum")
        r = gather_dim(part, inner, inner_size, 0)
    else:
        r = a
        for ax, n in ((inner_axis, inner_size), (outer_axis, outer_size)):
            if n > 1:
                r = _reduce(r, _group(ax, n), n, "sum")
    return r / (inner_size * outer_size) if op == "avg" else r


def _register_torch_impls():
    from thunder_tpu_torch.executors.torchex import ex

    for id, fn in ((DistOpIDs.ALL_GATHER, _ag), (DistOpIDs.ALL_REDUCE, _ar), (DistOpIDs.BROADCAST, _bc),
                   (DistOpIDs.REDUCE_SCATTER, _rs), (DistOpIDs.SYNCHRONIZE, _sync),
                   (DistOpIDs.WAIT, lambda fut: fut), (DistOpIDs.PPERMUTE, _pp), (DistOpIDs.ALL_TO_ALL, _a2a),
                   (DistOpIDs.MASK_TO_RANK, _mask), (DistOpIDs.HIER_ALL_REDUCE, _har),
                   (DistOpIDs.AXIS_SLICE, _slice)):
        ex.register_implementation(id, fn=fn)


_register_torch_impls()


# -- VJP rules ----------------------------------------------------------------
# thunder_tpu/distributed/prims.py:299-368: synchronize's grad rule is where
# DDP and FSDP grad sync live.


def _register_vjps():
    from thunder_tpu_torch.transforms.autodiff import register_paired, register_vjp

    @register_vjp(DistOpIDs.ALL_GATHER)
    def _ag_vjp(bsym, g):
        a, axis, group_size = bsym.args[:3]
        dim = bsym.kwargs.get("dim", 0)
        if bsym.kwargs.get("replicated_grad", False):
            return (axis_slice(g, axis, group_size, dim=dim), None, None)
        return (reduce_scatter(g, axis, group_size, dim=dim), None, None)

    @register_vjp(DistOpIDs.AXIS_SLICE)
    def _slice_vjp(bsym, g):
        a, axis, group_size = bsym.args[:3]
        return (all_gather(g, axis, group_size, dim=bsym.kwargs.get("dim", 0)), None, None)

    @register_vjp(DistOpIDs.REDUCE_SCATTER)
    def _rs_vjp(bsym, g):
        a, axis, group_size = bsym.args[:3]
        return (all_gather(g, axis, group_size, dim=bsym.kwargs.get("dim", 0)), None, None)

    @register_vjp(DistOpIDs.ALL_REDUCE)
    def _ar_vjp(bsym, g):
        a, axis, group_size = bsym.args[:3]
        if bsym.kwargs.get("replicated_grad", False):
            return (g, None, None)
        return (all_reduce(g, axis, group_size), None, None)

    @register_vjp(DistOpIDs.BROADCAST)
    def _bc_vjp(bsym, g):
        # Only the root's input reaches the output: the summed cotangent is
        # the root's alone, every other rank's grad is zero.
        a, axis, group_size = bsym.args[:3]
        return (mask_to_rank(all_reduce(g, axis, group_size), axis, bsym.kwargs.get("root", 0)), None, None)

    @register_vjp(DistOpIDs.WAIT)
    def _wait_vjp(bsym, g):
        return (g,)

    @register_vjp(DistOpIDs.PPERMUTE)
    def _pp_vjp(bsym, g):
        # The cotangent hops back: each pair reversed. A rank nobody sent to
        # got zeros, so its input's cotangent is what nobody sends back:
        # zeros, as the forward gives and lax.ppermute's transpose does.
        a, axis, perm = bsym.args[:3]
        return (ppermute(g, axis, [(d, s) for s, d in perm]), None, None)

    @register_vjp(DistOpIDs.ALL_TO_ALL)
    def _a2a_vjp(bsym, g):
        # The tiled transpose: split where the forward concatenated, and
        # concatenate where it split (lax.all_to_all's transpose rule).
        a, axis, group_size = bsym.args[:3]
        return (all_to_all(g, axis, group_size, split_dim=bsym.kwargs["concat_dim"],
                           concat_dim=bsym.kwargs["split_dim"]), None, None)

    # Each rank runs its transposed hop or shuffle whether or not a
    # cotangent reaches it here: its peers post the matching call.
    register_paired(DistOpIDs.PPERMUTE, DistOpIDs.ALL_TO_ALL)

    @register_vjp(DistOpIDs.HIER_ALL_REDUCE)
    def _har_vjp(bsym, g):
        a, inner_axis, outer_axis, inner_size, outer_size = bsym.args[:5]
        return (hier_all_reduce(g, inner_axis, outer_axis, inner_size, outer_size), None, None, None, None)

    @register_vjp(DistOpIDs.SYNCHRONIZE)
    def _sync_vjp(bsym, g):
        import thunder_tpu_torch.clang as clang

        a, axis, group_size = bsym.args[:3]
        ptype = bsym.args[3] if len(bsym.args) > 3 else bsym.kwargs.get("parallel_type")
        # grad_scale: 1/world when every rank computes the same full-batch
        # grad (replicated data: the average of identical copies); 1.0 when
        # the batch is sharded and the ranks' partial grads must sum.
        scale = bsym.kwargs.get("grad_scale")
        if scale is None:
            scale = 1.0 / group_size
        scaled = clang.mul(g, scale) if scale != 1.0 else g
        if bsym.kwargs.get("grad_sync", True) is False:
            # no_sync: the scaled local grad (full-size for fsdp), reduced
            # when the context exits.
            return (scaled, None, None)
        if _sync_is_sharded(a, ptype):
            return (reduce_scatter(scaled, axis, group_size, dim=bsym.kwargs.get("dim", 0)), None, None)
        return (all_reduce(scaled, axis, group_size), None, None)


_register_vjps()
