"""Running traces that hold collectives, one process a rank.

The counterpart of ``thunder_tpu/distributed/runtime.py``. The JAX package is
single-controller: one process stages the trace under ``shard_map`` over a
mesh, which splits the global inputs by ``in_specs`` and joins the outputs by
``out_specs``, each collective naming a mesh axis. The port is SPMD over
processes, as Thunder itself is: every rank runs the same claimed trace, and
each axis name resolves to a ``torch.distributed`` process group. The user's
contract stays the JAX package's: every rank is called with the same global
inputs, takes its block of each by its spec, runs, and joins the outputs by
theirs, so a program gives the same result on N ranks as on one device.

A spec is :class:`P`, ``jax.sharding.PartitionSpec``'s shape: ``P()`` is
replicated (passed as it is, returned as this rank computed it); each dim may
name an axis, or a tuple of axes outermost first, over whose groups it is
split (this rank's block in, all-gathers out), so ``P(None, "tp")`` splits
dim 1 over tp and ``P(("dp", "fsdp"))`` dim 0 over both. ``mesh`` binds the
axes: None is the world group for every axis (as ``fsdp(model)`` without a
mesh is every device in the JAX package), a process group binds every axis
to it, and a dict ``{axis: group}`` binds each as given (this rank's own
group of that axis, :func:`grid_groups`; ``parallel.make_mesh`` returns
such a dict).

On the card the per-rank program is staged as one CUDA graph, its NCCL
collectives included (``executors/staging.py``): the seat of
``jax.jit(shard_map(...))``. NCCL makes a group's communicator at its first
collective, which must not be the capture's, so a group is warmed with one
small all-reduce when it is first bound (:func:`resolve_axes`). A capture
that fails raises; nothing falls back to an unstaged run or another backend.

The staged program is wrapped in the collective watchdog
(``resilience/watchdog.wrap``): with a timeout configured, a call whose
collectives hang raises ``CollectiveTimeoutError`` naming the callable's
``trace_lines`` and certified ``schedule``, which :func:`shard_map_callable`
also keeps on the callable it returns.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
import torch.distributed as dist

from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten


class P(tuple):
    """A partition spec: one mesh-axis name (or None) a dim, or a tuple of
    names for a dim split over several axes, the first the outermost;
    ``P()`` is replicated, and dims past the spec's length are too."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    @property
    def axis(self):
        """Dim 0's entry (an axis, a tuple of axes, or None)."""
        return self[0] if self else None

    def dim_axes(self, dim: int) -> tuple:
        """The axes dim ``dim`` is split over, outermost first."""
        a = self[dim] if dim < len(self) else None
        return () if a is None else tuple(a) if isinstance(a, tuple) else (a,)

    @property
    def sharded(self) -> tuple:
        """``((dim, axes), ...)`` of every split dim."""
        return tuple((d, self.dim_axes(d)) for d in range(len(self)) if self.dim_axes(d))

    @property
    def axes(self) -> tuple:
        """Every axis the spec names, dim by dim, outermost first."""
        return tuple(ax for _, axes in self.sharded for ax in axes)


_bound: contextvars.ContextVar[dict] = contextvars.ContextVar("thunder_axis_groups", default={})
_warmed: set = set()


def resolve_axes(mesh, axes) -> dict:
    """``{axis: process group}`` for the axis names ``axes`` under ``mesh``
    (None: the world group; a group: that one; a dict: as given). Each NCCL
    group is warmed once, before any capture can meet it."""
    if not dist.is_initialized():
        raise RuntimeError("a program with collectives needs a process group: call "
                           "thunder_tpu_torch.distributed.init() (or torch.distributed.init_process_group) first")
    if isinstance(mesh, dict):
        missing = sorted(set(axes) - set(mesh))
        if missing:
            raise ValueError(f"the mesh binds axes {sorted(mesh)}, not {missing}")
        groups = {ax: mesh[ax] for ax in axes}
    else:
        group = dist.group.WORLD if mesh is None else mesh
        groups = {ax: group for ax in axes}
    for group in groups.values():
        _warm(group)
    return groups


def _warm(group) -> None:
    if id(group) in _warmed:
        return
    if dist.get_backend(group) == "nccl":
        t = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
    _warmed.add(id(group))


@contextlib.contextmanager
def bound_axes(groups: dict):
    """Resolve the axis names of ``groups`` to their groups inside the
    context (what :func:`group_of` reads)."""
    token = _bound.set({**_bound.get(), **groups})
    try:
        yield
    finally:
        _bound.reset(token)


def group_of(axis: str, group_size: Optional[int] = None):
    """The process group bound to ``axis``, checked to hold ``group_size``
    ranks. An axis bound to no group raises."""
    groups = _bound.get()
    if axis not in groups:
        raise RuntimeError(f"a collective on mesh axis {axis!r} ran outside a program bound to process groups "
                           f"(bound: {sorted(groups)}); stage it with distributed.runtime")
    group = groups[axis]
    if group is None:
        raise RuntimeError(f"mesh axis {axis!r} is bound to one rank and no process group: a program on it holds "
                           "no collective (call thunder_tpu_torch.distributed.init() for a group)")
    if group_size is not None and dist.get_world_size(group) != group_size:
        raise RuntimeError(f"the trace's collective on axis {axis!r} has group size {group_size}, but its process "
                           f"group has {dist.get_world_size(group)} ranks")
    return group


def axis_size(axis: str) -> int:
    """The size of the group bound to ``axis`` (``lax.psum(1, axis)``):
    read when a rank traces its program, so that a loop over the axis
    unrolls, as a static axis size does under ``shard_map``. An axis bound
    to None (a mesh of one rank with no process group) has size 1."""
    return 1 if _bound.get().get(axis, False) is None else dist.get_world_size(group_of(axis))


def axis_index(axis: str) -> int:
    """This rank's index in the group bound to ``axis``
    (``lax.axis_index(axis)``), a number known when the rank traces."""
    return 0 if _bound.get().get(axis, False) is None else dist.get_rank(group_of(axis))


def mesh_groups(mesh) -> dict:
    """``{axis: group}`` of every axis of a ``parallel.Mesh``, an axis of
    one rank with no process group bound to None (:func:`axis_size` reads
    1 for it, and a collective on it raises). Each NCCL group is warmed,
    as :func:`resolve_axes` warms it."""
    groups = {ax: mesh.get(ax) for ax in mesh.axis_names}
    for group in groups.values():
        if group is not None:
            _warm(group)
    return groups


# -- the job's ranks ------------------------------------------------------------
# The group the recovery layer's agreements, checkpoints and replica checks
# run over: the world, unless a job that shrank onto its first ranks binds
# the group of the survivors (resilience/autopilot.py). A contextvar, so a
# watchdog worker or the checkpoint writer, which run in a copy of the
# caller's context, see it too.
_job: contextvars.ContextVar = contextvars.ContextVar("thunder_job_group", default=None)


def job_group():
    """The process group that stands for the job's world: the survivors'
    group inside :func:`job_scope`, else None (the world group)."""
    return _job.get()


@contextlib.contextmanager
def job_scope(group):
    """Run the recovery layer over ``group`` (None: the world) inside the
    context: the ranks outside it have left the job."""
    token = _job.set(group)
    try:
        yield
    finally:
        _job.reset(token)


def grid_groups(names: tuple, shape: tuple, ranks: Optional[list] = None) -> dict:
    """This rank's group along each axis of a row-major grid of ``ranks``
    (default: the world's, in order; ``names[i]`` spans ``shape[i]``
    ranks). Every rank of the world calls it with the same arguments: each
    ``new_group`` is collective over the world. A rank outside ``ranks``
    gets no group."""
    import math

    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if math.prod(shape) != len(ranks):
        raise ValueError(f"a grid of shape {shape} needs {math.prod(shape)} ranks, it was given {len(ranks)}")
    me = dist.get_rank()
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    mine = {}
    for i, name in enumerate(names):
        # Every line of ranks along axis i, in a fixed order on every rank.
        for base in range(len(ranks)):
            if base // strides[i] % shape[i] != 0:
                continue
            line = [ranks[base + k * strides[i]] for k in range(shape[i])]
            group = dist.new_group(line)
            if me in line:
                mine[name] = group
    return mine


# -- splitting and joining by spec --------------------------------------------


def split(x, spec, groups: dict):
    """This rank's block of ``x`` by ``spec``: along each split dim, the
    block of this rank's coordinate over that dim's axes (over several
    axes, the blocks in row-major order of the coordinates). A view."""
    if not isinstance(x, torch.Tensor) or spec is None or not spec.axes:
        return x
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} has {len(spec)} dims, the input {x.ndim}")
    for d, axes in spec.sharded:
        n, r = 1, 0
        for ax in axes:
            g = groups[ax]
            n, r = n * dist.get_world_size(g), r * dist.get_world_size(g) + dist.get_rank(g)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of an input ({x.shape[d]}) does not split over the {n} ranks of {axes}")
        m = x.shape[d] // n
        x = x.narrow(d, r * m, m)
    return x


def join_plan(spec, groups: dict) -> list:
    """The gathers that join a block held by ``spec``, in order: (dim, axis,
    the axis group's size) along each split dim, the innermost axis first;
    axes of one rank take none."""
    plan = []
    for d, axes in spec.sharded:
        for ax in reversed(axes):
            n = dist.get_world_size(groups[ax])
            if n > 1:
                plan.append((d, ax, n))
    return plan


def join(x, spec, groups: dict):
    """The global value of an output that this rank holds by ``spec``: its
    blocks all-gathered by ``join_plan``."""
    from thunder_tpu_torch.distributed.prims import gather_dim

    if not isinstance(x, torch.Tensor) or spec is None:
        return x
    for d, ax, n in join_plan(spec, groups):
        x = gather_dim(x, groups[ax], n, d)
    return x


def shard_map_callable(fn: Callable, mesh, in_specs, out_specs, *, traces=(), name: str = "shard_map",
                       trace_lines=None, schedule=None) -> Callable:
    """``fn`` run on this rank's blocks: the global arguments split by
    ``in_specs``, the outputs joined by ``out_specs``, the collectives of
    ``fn`` resolved to the groups ``mesh`` binds. On CUDA the per-rank
    program is staged as one CUDA graph (``traces`` are its claimed traces,
    read for what keeps a program unstaged)."""
    from thunder_tpu_torch.executors import staging

    axes = {ax for s in tree_flatten(in_specs)[0] + tree_flatten(out_specs)[0] if isinstance(s, P) for ax in s.axes}
    axes |= {ax for trc in traces for ax in _trace_axes(trc)}
    groups = resolve_axes(mesh, sorted(axes))
    backends = {dist.get_backend(g) for g in groups.values()} or {dist.get_backend()}
    device = torch.device("cuda", torch.cuda.current_device()) if "nccl" in backends else torch.device("cpu")

    def per_rank(*args):
        with bound_axes(groups):
            return fn(*args)

    from thunder_tpu_torch.resilience import watchdog

    staged, stats = staging.stage(per_rank, list(traces), device, name=name)
    staged = watchdog.wrap(staged, fn_name=name, trace_lines=trace_lines, schedule=schedule)

    def call(*args):
        flat_specs = _flat_in_specs(args, in_specs)
        local = [split(a, s, groups) for a, s in zip(args, flat_specs)]
        out = staged(*local)
        flat, tspec = tree_flatten(out)
        ospecs = _flat_out_specs(out, out_specs)
        return tree_unflatten([join(x, s, groups) for x, s in zip(flat, ospecs)], tspec)

    call.staging = stats
    call.groups = groups
    call.trace_lines = trace_lines
    call.schedule = schedule
    return call


def _flat_in_specs(args: tuple, in_specs) -> list:
    if isinstance(in_specs, P):
        return [in_specs] * len(args)
    if len(in_specs) != len(args):
        raise ValueError(f"{len(in_specs)} in_specs for {len(args)} arguments")
    return list(in_specs)


def _flat_out_specs(out, out_specs) -> list:
    """A spec for each leaf of ``out``: ``out_specs`` mirrors the output's
    tuple structure, a ``P`` standing for a whole subtree."""
    flat, _ = tree_flatten(out)
    if isinstance(out_specs, P):
        return [out_specs] * len(flat)
    res = []

    def walk(o, s):
        if isinstance(s, P) or s is None:
            res.extend([s] * len(tree_flatten(o)[0]))
        elif isinstance(o, (tuple, list)) and isinstance(s, (tuple, list)) and len(o) == len(s):
            for oo, ss in zip(o, s):
                walk(oo, ss)
        elif isinstance(o, dict) and isinstance(s, dict):
            for k in o:
                walk(o[k], s[k])
        else:
            raise ValueError(f"out_specs {s!r} do not match the output structure")

    walk(out, out_specs)
    return res


def _trace_axes(trc) -> set:
    from thunder_tpu_torch.distributed.prims import DistOpIDs, is_collective_bsym

    axes = set()
    for bsym in trc.bound_symbols:
        if not is_collective_bsym(bsym) or bsym.sym.id is DistOpIDs.WAIT:
            continue
        if bsym.sym.id is DistOpIDs.HIER_ALL_REDUCE:
            axes.update(bsym.args[1:3])
        elif len(bsym.args) > 1 and isinstance(bsym.args[1], str):
            axes.add(bsym.args[1])
    return axes


def compile_with_collectives(fn: Callable, example_args: tuple, mesh, in_specs, out_specs, *, grad: bool = False,
                             comm_schedule: bool = False):
    """Trace ``fn`` on this rank's example blocks (so its collectives record
    into the trace; a dict ``mesh``'s axes are bound meanwhile), claim it,
    and stage it by :func:`stage_collective_trace`. ``grad=True`` returns
    the value and the grads of the inputs, as ``grad_transform(
    return_value=True)`` does. ``comm_schedule=True`` runs the
    collective-overlap scheduler over the claimed trace
    (``transforms/comm_schedule.py``). Returns ``(callable, claimed
    trace)``; the callable takes the global arguments."""
    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.transforms.autodiff import grad_transform
    from thunder_tpu_torch.transforms.common import dce

    # A dict mesh's axes are bound while fn traces, so that it may read
    # their sizes and this rank's index (axis_size, axis_index).
    with bound_axes(resolve_axes(mesh, sorted(mesh)) if isinstance(mesh, dict) else {}):
        _, comp = trace_program(fn, example_args, {})
    comp = dce(comp)
    if grad:
        comp = grad_transform(comp, return_value=True)
    extrace = transform_for_execution(comp, resolve_executors(None), comm_schedule=comm_schedule)
    return stage_collective_trace(extrace, mesh, in_specs, out_specs), extrace


def stage_collective_trace(extrace, mesh, in_specs, out_specs) -> Callable:
    """Stage a claimed trace that holds collectives: certify its collective
    schedule (stamped on the trace, and handed on for the watchdog), then
    :func:`shard_map_callable` over ``mesh``."""
    from thunder_tpu_torch.analysis import schedule as sched_mod
    from thunder_tpu_torch.distributed.prims import collective_trace_lines

    schedule = sched_mod.stamp(extrace).axis_labels()
    return shard_map_callable(extrace.python_callable(), mesh, in_specs, out_specs, traces=(extrace,),
                              name=extrace.siginfo.name, trace_lines=collective_trace_lines(extrace),
                              schedule=schedule)
