"""Meshes of ranks for SPMD training.

The counterpart of ``thunder_tpu/parallel/mesh.py``. Axes follow the JAX
package's convention: ``dp`` (pure data parallel), ``pp`` (pipeline stages),
``fsdp`` (data parallel with sharded params, grads and optimizer state),
``ep`` (expert parallel), ``sp`` (sequence parallel) and ``tp`` (tensor
parallel). A mesh has every axis of :data:`AXIS_ORDER`, the absent ones of
size 1, in that fixed order: outer axes change slowest, so ``tp`` spans
neighbouring ranks (on one node, NVLink) and ``dp`` the farthest.

The JAX package's mesh is data over devices that one process drives. The
port is SPMD over processes, one rank a card, so its mesh is the grid of
ranks: a :class:`Mesh` is ``{axis: this rank's process group along that
axis}`` (``distributed.runtime.grid_groups``), and anything that takes a
dict of groups takes it (``distributed.ddp``/``fsdp``/``shard_map_callable``,
``runtime.resolve_axes``). Every rank calls :func:`make_mesh` with the same
arguments after ``distributed.init()``.

The federated mesh (``SliceTopology``, ``make_federated_mesh``,
``is_federated``, ``slice_axis_size``) belongs to the fleet layer (slice 6b)
of the resilience port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.fsdp * self.ep * self.sp * self.tp

    def axis_sizes(self) -> dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "fsdp": self.fsdp,
                "ep": self.ep, "sp": self.sp, "tp": self.tp}

    @classmethod
    def from_mesh(cls, mesh) -> "MeshConfig":
        """The config of a live mesh (axes it does not carry are 1)."""
        return cls(**{a: int(n) for a, n in axis_sizes(mesh).items() if a in AXIS_ORDER})


class Mesh(dict):
    """The rank grid: ``{axis: this rank's process group along it}``, with
    ``axis_names`` and ``devices`` (the global ranks, shaped by the axes)
    as on a ``jax.sharding.Mesh``. A rank outside the grid (the world
    larger than the mesh) holds no group."""

    def __init__(self, axis_names: tuple, devices: np.ndarray, groups: dict):
        super().__init__(groups)
        self.axis_names = tuple(axis_names)
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh (a :class:`Mesh`, or anything with
    ``axis_names`` and ``devices.shape``)."""
    return {str(a): int(n) for a, n in zip(mesh.axis_names, mesh.devices.shape)}


def make_mesh(config: MeshConfig | dict | None = None, *, devices: Optional[Sequence[int]] = None, **axes) -> Mesh:
    """This rank's :class:`Mesh` of the given axis sizes, over the ranks
    ``devices`` (default: the world's, in order; the first
    ``config.n_devices`` of them are used). A mesh larger than the ranks
    raises ``ValueError``. A mesh of one rank needs no process group: with
    none initialized it binds no axis, and a program on it holds no
    collective."""
    import torch.distributed as dist

    from thunder_tpu_torch.distributed import runtime

    if config is None:
        config = MeshConfig(**{k: int(v) for k, v in axes.items()})
    elif isinstance(config, dict):
        config = MeshConfig(**config)
    n = config.n_devices
    shape = tuple(config.axis_sizes()[a] for a in AXIS_ORDER)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"Mesh needs {n} devices, only 1 available (no process group: call "
                             "thunder_tpu_torch.distributed.init() first)")
        return Mesh(AXIS_ORDER, np.zeros(shape, dtype=np.int64), {})
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if len(ranks) < n:
        raise ValueError(f"Mesh needs {n} devices, only {len(ranks)} available")
    ranks = ranks[:n]
    grid = np.array(ranks, dtype=np.int64).reshape(shape)
    wide = [a for a, k in zip(AXIS_ORDER, shape) if k > 1]
    groups = runtime.grid_groups(tuple(wide), tuple(k for k in shape if k > 1), ranks) if wide else {}
    # An axis of size 1 binds each rank to a group of itself, one made for
    # all such axes (the world itself at one rank).
    me = dist.get_rank()
    if len(wide) < len(AXIS_ORDER):
        if dist.get_world_size() == 1:
            alone = dist.group.WORLD
        else:
            alone = None
            for r in range(dist.get_world_size()):
                g = dist.new_group([r])
                if r == me:
                    alone = g
        if me in ranks:
            groups.update({a: alone for a, k in zip(AXIS_ORDER, shape) if k == 1})
    return Mesh(AXIS_ORDER, grid, groups)
