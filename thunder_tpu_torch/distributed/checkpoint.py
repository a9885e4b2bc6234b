"""Sharded checkpoints on ``torch.distributed.checkpoint``.

The counterpart of ``thunder_tpu/distributed/checkpoint.py``, which saves
through Orbax (reference parity: thunder/distributed/checkpoint.py,
``StateDictOptions:35``, ``save:184``, ``load:197``). Each rank writes its
own blocks (``torch.distributed.checkpoint``, the reference's own seat), and
a load reads the blocks each rank of the target layout needs, which may be a
different number of ranks than saved: a state saved by N ranks loads on M.

A state is a pytree of tensors. Where a leaf is this rank's block of a
larger tensor, ``specs`` says so (``distributed/runtime.P``, over the groups
``mesh`` binds), as a sharding says so of a ``jax.Array``. A leaf split
along dim 0 over one axis (an fsdp shard) is written as a ``DTensor``
sharded along dim 0; a leaf split otherwise (another dim, several axes) is
gathered whole before it is written and split again on load. The tree's structure and each leaf's key are kept
beside the blocks (``structure.json``), so a load needs no template.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as tdist
import torch.utils._pytree as pytree

_STRUCTURE = "structure.json"
_FULL = "full_state.pt"


@dataclass
class StateDictOptions:
    """``StateDictOptions:35``. ``full_state_dict``: gather every block and
    write one consolidated file from rank 0; ``cpu_offload``: gather to host
    memory (the consolidated file is always written from the host);
    ``rank0_only`` is accepted for the API and has no effect, as in the JAX
    package (the consolidated export is always rank 0's)."""

    full_state_dict: bool = False
    cpu_offload: bool = False
    rank0_only: bool = True


class AsyncSaveHandle:
    """What ``save(..., async_save=True)`` returns: the write runs on a
    background thread; ``wait()`` before relying on the files. ``future``
    None marks a save already durable."""

    def __init__(self, future=None):
        self._future = future

    def wait(self) -> None:
        if self._future is not None:
            self._future.result()
            self._future = None


def _dist_on() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def _leaf_specs(state: Any, specs: Any) -> list:
    leaves, _ = pytree.tree_flatten(state)
    if specs is None:
        return [None] * len(leaves)
    flat = pytree.tree_flatten(specs)[0]
    if len(flat) != len(leaves):
        raise ValueError(f"specs have {len(flat)} leaves, the state {len(leaves)}")
    return flat


def _groups(mesh, specs: list) -> dict:
    from thunder_tpu_torch.distributed import runtime

    axes = sorted({ax for s in specs if s is not None for ax in s.axes})
    return runtime.resolve_axes(mesh, axes) if axes else {}


def _dim0(s) -> bool:
    """A spec that splits dim 0 over one axis and nothing else: the blocks
    a ``DTensor`` sharded along dim 0 describes."""
    return s is not None and len(s.sharded) == 1 and s.sharded[0][0] == 0 and len(s.sharded[0][1]) == 1


def _group_device(group=None) -> str:
    """Where a group's tensors live: the card for NCCL, the host for gloo or
    with no group at all."""
    return "cuda" if _dist_on() and tdist.get_backend(group) == "nccl" else "cpu"


def _device_mesh(group):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(group, _group_device(group))


def _as_dtensor(t: torch.Tensor, group):
    from torch.distributed.tensor import DTensor, Shard

    n = tdist.get_world_size(group)
    shape = (t.shape[0] * n,) + tuple(t.shape[1:])
    return DTensor.from_local(t.contiguous(), _device_mesh(group), [Shard(0)], run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def gather_full(state: Any, *, mesh=None, specs=None) -> Any:
    """Every leaf as its whole tensor, a block by ``specs`` all-gathered
    along each split dim over its groups (``runtime.join_plan``'s order):
    the full-state export's gather. The k-th gather
    of every leaf that takes one over the same group, of the same dtype and
    device, rides one all-gather of their blocks laid end to end, so a
    state of many small leaves costs a few collectives, not one a leaf."""
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.distributed.prims import coll_all_gather

    leaves, spec = pytree.tree_flatten(state)
    lspecs = _leaf_specs(state, specs)
    groups = _groups(mesh, lspecs)
    plans = [runtime.join_plan(s, groups) if isinstance(x, torch.Tensor) and s is not None else []
             for x, s in zip(leaves, lspecs)]
    out = list(leaves)
    for k in range(max(map(len, plans), default=0)):
        batches: dict = {}
        for i, ops in enumerate(plans):
            if k < len(ops):
                d, ax, n = ops[k]
                batches.setdefault((ax, n, out[i].dtype, out[i].device), []).append((i, d))
        for (ax, n, dtype, device), members in batches.items():
            flat = torch.cat([out[i].detach().reshape(-1) for i, _ in members])
            gathered = torch.empty((n, flat.numel()), dtype=dtype, device=device)
            coll_all_gather(gathered.view(-1), flat, groups[ax])
            off = 0
            for i, d in members:
                x = out[i]
                blocks = gathered[:, off:off + x.numel()].reshape((n,) + tuple(x.shape))
                off += x.numel()
                shape = list(x.shape)
                shape[d] *= n
                out[i] = blocks.movedim(0, d).reshape(shape)
    return pytree.tree_unflatten(out, spec)


def _keys(state: Any) -> list[str]:
    paths, _ = pytree.tree_flatten_with_path(state)
    return [pytree.keystr(kp) or "[]" for kp, _ in paths]


def save(state: Any, path: str, *, options: Optional[StateDictOptions] = None, async_save: bool = False,
         mesh=None, specs=None) -> Optional[AsyncSaveHandle]:
    """Save a pytree of tensors (``save:184``): every rank writes its own
    blocks, a leaf that ``specs`` marks ``P(axis)`` as its dim-0 block of
    the whole. ``options.full_state_dict`` gathers first and writes one
    file from rank 0. ``async_save=True`` returns an
    :class:`AsyncSaveHandle`, the blocks written on a background thread.
    Every rank of the job's group (``runtime.job_group``: the world unless
    a shrunk job bound its survivors) must call it."""
    import torch.distributed.checkpoint as dcp

    from thunder_tpu_torch.distributed import runtime

    options = options or StateDictOptions()
    path = os.path.abspath(path)
    group = runtime.job_group()
    rank0 = not _dist_on() or tdist.get_rank(group) == 0
    if options.full_state_dict:
        full = gather_full(state, mesh=mesh, specs=specs)
        full = pytree.tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, full)
        if rank0:
            os.makedirs(path, exist_ok=True)
            torch.save(full, os.path.join(path, _FULL))
        if _dist_on():
            tdist.barrier(group=group)
        return AsyncSaveHandle() if async_save else None
    leaves, spec = pytree.tree_flatten(state)
    lspecs = _leaf_specs(state, specs)
    groups = _groups(mesh, lspecs)
    keys = _keys(state)
    flat = {}
    for k, x, s in zip(keys, leaves, lspecs):
        if isinstance(x, torch.Tensor) and _dim0(s) and _dist_on():
            x = _as_dtensor(x.detach(), groups[s.axis])
        elif isinstance(x, torch.Tensor) and s is not None and s.axes and _dist_on():
            x = runtime.join(x.detach(), s, groups)
        elif isinstance(x, torch.Tensor):
            x = x.detach()
        flat[k] = x
    if rank0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _STRUCTURE), "w") as f:
            json.dump({"treespec": pytree.treespec_dumps(spec), "keys": keys}, f)
    if async_save:
        return AsyncSaveHandle(dcp.async_save(flat, checkpoint_id=path, process_group=group, no_dist=not _dist_on()))
    dcp.save(flat, checkpoint_id=path, process_group=group, no_dist=not _dist_on())
    return None


def load(path: str, *, template: Any = None, mesh=None, specs=None) -> Any:
    """Restore a pytree (``load:197``). With ``specs`` (a tree of ``P``
    matching the state) and ``mesh``, a leaf a spec splits comes back as
    this rank's block (a dim-0 block over one axis read from whatever blocks
    the saving ranks wrote); every other leaf comes back whole. Every
    leaf lands on the device of the process group: the card under NCCL, the
    host under gloo or with no group.
    ``template`` (a tree of tensors) gives the structure when the state was
    not saved by :func:`save`."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    from thunder_tpu_torch.distributed import runtime

    path = os.path.abspath(path)
    if os.path.isfile(os.path.join(path, _FULL)):
        state = torch.load(os.path.join(path, _FULL), weights_only=True, map_location=_group_device())
        if specs is None:
            return state
        lspecs = _leaf_specs(state, specs)
        groups = _groups(mesh, lspecs)
        leaves, spec = pytree.tree_flatten(state)
        return pytree.tree_unflatten([runtime.split(x, s, groups).clone() if s is not None and s.axes else x
                                      for x, s in zip(leaves, lspecs)], spec)
    if template is not None:
        keys, spec = _keys(template), pytree.tree_flatten(template)[1]
    else:
        with open(os.path.join(path, _STRUCTURE)) as f:
            meta = json.load(f)
        keys, spec = meta["keys"], pytree.treespec_loads(meta["treespec"])
    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    lspecs = [None] * len(keys) if specs is None else pytree.tree_flatten(specs)[0]
    groups = _groups(mesh, lspecs)
    flat = {}
    for k, s in zip(keys, lspecs):
        m = md[k]
        if not isinstance(m, TensorStorageMetadata):
            flat[k] = None
            continue
        shape, dtype = tuple(m.size), m.properties.dtype
        if _dim0(s) and _dist_on():
            g = groups[s.axis]
            n = tdist.get_world_size(g)
            flat[k] = _as_dtensor(torch.empty((shape[0] // n,) + shape[1:], dtype=dtype, device=_group_device(g)), g)
        else:
            flat[k] = torch.empty(shape, dtype=dtype, device=_group_device())
    dcp.load(flat, checkpoint_id=path, process_group=runtime.job_group(), no_dist=not _dist_on())
    leaves = [flat[k].to_local() if hasattr(flat[k], "to_local") else flat[k] for k in keys]
    leaves = [runtime.split(x, s, groups).clone() if s is not None and s.axes and not _dim0(s) and _dist_on() else x
              for x, s in zip(leaves, lspecs)]
    return pytree.tree_unflatten(leaves, spec)
