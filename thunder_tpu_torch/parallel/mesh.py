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

A federated mesh (:func:`make_federated_mesh`) groups the ranks into
slices: a grid of axes ``("dcn",) + AXIS_ORDER`` where slice *i* owns a
contiguous block of ranks and the ``dcn`` axis binds a group across slices,
one rank from each block (the seat of the JAX package's cross-slice axis
over emulated ICI slices).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "sp", "tp")
# The cross-slice axis of a federated mesh: its collectives are the only ones
# that cross a slice boundary (the slower tier the cost model prices apart).
DCN_AXIS = "dcn"


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
    if config is None:
        config = MeshConfig(**{k: int(v) for k, v in axes.items()})
    elif isinstance(config, dict):
        config = MeshConfig(**config)
    return _rank_grid(AXIS_ORDER, tuple(config.axis_sizes()[a] for a in AXIS_ORDER), devices, "Mesh")


def _rank_grid(names: tuple, shape: tuple, devices, what: str) -> Mesh:
    """This rank's :class:`Mesh` of axes ``names`` and sizes ``shape`` over
    the first ranks of ``devices`` (default: the world's), every rank of
    the world calling it alike."""
    import torch.distributed as dist

    from thunder_tpu_torch.distributed import runtime

    n = int(np.prod(shape))
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"{what} needs {n} devices, only 1 available (no process group: call "
                             "thunder_tpu_torch.distributed.init() first)")
        return Mesh(names, np.zeros(shape, dtype=np.int64), {})
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if len(ranks) < n:
        raise ValueError(f"{what} needs {n} devices, only {len(ranks)} available")
    ranks = ranks[:n]
    grid = np.array(ranks, dtype=np.int64).reshape(shape)
    wide = [a for a, k in zip(names, shape) if k > 1]
    groups = runtime.grid_groups(tuple(wide), tuple(k for k in shape if k > 1), ranks) if wide else {}
    # An axis of size 1 binds each rank to a group of itself, one made for
    # all such axes (the world itself at one rank).
    me = dist.get_rank()
    if len(wide) < len(names):
        if dist.get_world_size() == 1:
            alone = dist.group.WORLD
        else:
            alone = None
            for r in range(dist.get_world_size()):
                g = dist.new_group([r])
                if r == me:
                    alone = g
        if me in ranks:
            groups.update({a: alone for a, k in zip(names, shape) if k == 1})
    return Mesh(names, grid, groups)


# =============================================================================
# Federated (slice-granular) meshes
# =============================================================================


@dataclass(frozen=True)
class SliceTopology:
    """Which contiguous block of ranks each slice of a federated mesh owns:
    slice i holds ranks ``[i*devices_per_slice, (i+1)*devices_per_slice)``
    of the mesh's ranks, so in-slice collectives stay among neighbours and
    only the leading :data:`DCN_AXIS` crosses a slice boundary."""

    n_slices: int
    devices_per_slice: int
    per_slice: MeshConfig

    @property
    def n_devices(self) -> int:
        return self.n_slices * self.devices_per_slice

    def slice_of_device(self, flat_index: int) -> int:
        """Slice owning flat rank index ``flat_index``."""
        return int(flat_index) // self.devices_per_slice

    def device_indices(self, slice_id: int) -> range:
        """Flat rank indices of ``slice_id``'s block."""
        lo = int(slice_id) * self.devices_per_slice
        return range(lo, lo + self.devices_per_slice)


def make_federated_mesh(n_slices: int, config: MeshConfig | dict | None = None, *,
                        devices: Optional[Sequence[int]] = None, **axes):
    """This rank's federated :class:`Mesh` of ``n_slices`` slices, each the
    grid ``config``/``axes`` describes, over the ranks ``devices`` (default:
    the world's, in order). Axes are ``("dcn",) + AXIS_ORDER``, shape
    ``(n_slices, dp, pp, fsdp, ep, sp, tp)``; slice i's ranks are the i-th
    contiguous block, and the ``dcn`` group joins the ranks at the same place
    of every slice. Every rank calls it with the same arguments. Raises
    ``ValueError`` for fewer than one slice or fewer ranks than
    ``n_slices`` x the slice's, and with no process group unless the mesh is
    one rank. Returns ``(Mesh, SliceTopology)``."""
    if n_slices < 1:
        raise ValueError(f"need at least 1 slice, got {n_slices}")
    if config is None:
        config = MeshConfig(**{k: int(v) for k, v in axes.items()})
    elif isinstance(config, dict):
        config = MeshConfig(**config)
    per_slice = config.n_devices
    shape = (n_slices,) + tuple(config.axis_sizes()[a] for a in AXIS_ORDER)
    topo = SliceTopology(n_slices=n_slices, devices_per_slice=per_slice, per_slice=config)
    mesh = _rank_grid((DCN_AXIS,) + AXIS_ORDER, shape, devices,
                      f"Federated mesh ({n_slices} slices × {per_slice})")
    return mesh, topo


def is_federated(mesh) -> bool:
    """True when ``mesh`` carries the cross-slice :data:`DCN_AXIS`."""
    return DCN_AXIS in tuple(getattr(mesh, "axis_names", ()) or ())


def slice_axis_size(mesh) -> int:
    """Number of slices a federated mesh spans (1 for a plain mesh)."""
    return axis_sizes(mesh).get(DCN_AXIS, 1)
