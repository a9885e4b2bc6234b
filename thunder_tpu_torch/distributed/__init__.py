"""Distributed API: trace-level collectives and the DDP/FSDP entry points.

The counterpart of ``thunder_tpu/distributed/__init__.py`` (reference parity:
thunder/distributed/__init__.py, ``ddp:88``, ``fsdp:303``, ``FSDPType:248``,
``FSDPBucketingStrategy:261``, ``no_sync:27-67``), on ``torch.distributed``:
one process a rank, NCCL on the card and gloo on the CPU
(``distributed/runtime.py``). ``ddp``/``fsdp`` tag a module, which
``thunder_tpu_torch.jit`` then compiles with a ``synchronize`` for each
parameter and the grad sync in its backward (``frontend/module.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import os
from typing import Optional

import torch
import torch.distributed as tdist

from thunder_tpu_torch.core.proxies import DistParallelType


class FSDPType(enum.Enum):
    """``FSDPType:248``: ZERO2 keeps each gathered parameter saved for the
    backward, ZERO3 gathers it again there from its shard."""

    ZERO2 = enum.auto()
    ZERO3 = enum.auto()


class FSDPBucketingStrategy(enum.Enum):
    """``FSDPBucketingStrategy:261``. Accepted and without effect, as in the
    JAX package, whose collectives XLA's combiner coalesces: the port has no
    bucketing of its own."""

    NONE = enum.auto()
    LAYER = enum.auto()
    BLOCK = enum.auto()


def init(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None, local_device_ids=None, *, device: Optional[str] = None,
         backend: Optional[str] = None, **kwargs) -> dict:
    """Join the process group (``jax.distributed.initialize``'s seat).

    With no arguments the torchrun environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) is read;
    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` give them explicitly, and ``store=`` (a
    ``torch.distributed.Store``) rendezvous without a port. The backend is
    NCCL on the card and gloo when ``device="cpu"``; ``backend=`` names
    another. ``local_device_ids`` picks this rank's card (default
    ``LOCAL_RANK``, else 0). Without ``device="cpu"`` and with no card it
    raises.

    Idempotent; a repeat call whose arguments contradict the live group
    raises. Returns ``{"process_id", "num_processes", "devices",
    "local_devices"}`` (one device a rank)."""
    if not tdist.is_initialized():
        on_cpu = device is not None and torch.device(device).type == "cpu"
        if not on_cpu and not torch.cuda.is_available():
            raise RuntimeError("distributed.init(): no CUDA device; pass device='cpu' for a gloo group on the CPU")
        backend = backend or ("gloo" if on_cpu else "nccl")
        opts = dict(kwargs)
        if num_processes is not None:
            opts["world_size"] = int(num_processes)
        if process_id is not None:
            opts["rank"] = int(process_id)
        if "store" not in opts and "init_method" not in opts:
            opts["init_method"] = f"tcp://{coordinator_address}" if coordinator_address else "env://"
        if not on_cpu:
            ids = local_device_ids if local_device_ids is not None else [int(os.environ.get("LOCAL_RANK", 0))]
            index = int(ids[0] if isinstance(ids, (list, tuple)) else ids)
            torch.cuda.set_device(index)
            if backend == "nccl":
                opts.setdefault("device_id", torch.device("cuda", index))
        tdist.init_process_group(backend=backend, **opts)
    else:
        for name, given, active in (("process_id", process_id, tdist.get_rank()),
                                    ("num_processes", num_processes, tdist.get_world_size())):
            if given is not None and given != active:
                raise RuntimeError(f"distributed.init(): {name}={given} conflicts with the active process group "
                                   f"({name}={active}); call shutdown() first to rebootstrap")
    return {"process_id": tdist.get_rank(), "num_processes": tdist.get_world_size(),
            "devices": tdist.get_world_size(), "local_devices": 1}


def shutdown() -> None:
    """Leave the process group (the torchrun exit's seat)."""
    from thunder_tpu_torch.distributed import runtime

    if tdist.is_initialized():
        tdist.destroy_process_group()
    runtime._warmed.clear()


def is_initialized() -> bool:
    return tdist.is_initialized()


_skip_data_sync = contextvars.ContextVar("skip_data_sync", default=False)


@contextlib.contextmanager
def no_sync():
    """Skip the grad collectives inside the context (gradient accumulation);
    thunder/distributed/__init__.py:27-67."""
    tok = _skip_data_sync.set(True)
    try:
        yield
    finally:
        _skip_data_sync.reset(tok)


def skip_data_parallel_grad_sync() -> bool:
    return _skip_data_sync.get()


def _is_module(x) -> bool:
    from thunder_tpu_torch.frontend.module import ThunderModule

    return isinstance(x, (torch.nn.Module, ThunderModule))


def _validate_dist_cfg(cfg: dict) -> None:
    """A dict mesh (``{axis: group}``) must bind the config's axis; None
    (the world group) and a process group bind every axis."""
    mesh = cfg.get("mesh")
    if isinstance(mesh, dict) and cfg.get("axis") not in mesh:
        raise ValueError(f"{cfg.get('mode')}(axis={cfg.get('axis')!r}) but the mesh binds axes {sorted(mesh)}; "
                         "pass axis=<one of them> (compiling for one device would drop the sharding)")


def _attach_dist_config(model, cfg: dict):
    """Tag a torch module (or configure a jitted one) so that the jit
    inserts ``synchronize`` for its parameters at trace time and runs its
    traces on the mesh's groups (thunder/common.py:521-528)."""
    from thunder_tpu_torch.frontend.module import ThunderModule

    _validate_dist_cfg(cfg)
    if isinstance(model, ThunderModule):
        model.configure_distributed(cfg)
        return model
    model._thunder_dist = cfg
    return model


def ddp(model_or_params, *, mesh=None, axis: str = "dp", broadcast_from: Optional[int] = 0,
        shard_data: bool = True):
    """Replicate a model for data-parallel training (``ddp:88``).

    - a torch ``nn.Module`` or jitted module: tagged; at trace time every
      parameter passes through ``synchronize`` (the identity forward, an
      all-reduce of the scaled grad backward). ``broadcast_from`` is the
      rank whose parameters every rank takes when the module is jitted
      (None: none is sent). ``shard_data=False`` keeps the data inputs
      replicated (an input whose dim 0 is not the batch).
    - a pytree of proxies: each is marked REPLICATED.
    """
    if _is_module(model_or_params):
        return _attach_dist_config(model_or_params, {"mode": "ddp", "mesh": mesh, "axis": axis,
                                                     "broadcast_from": broadcast_from, "shard_data": shard_data})
    return _mark(model_or_params, DistParallelType.REPLICATED)


def fsdp(model_or_params, *, mesh=None, sharding_strategy: FSDPType = FSDPType.ZERO3,
         bucketing_strategy: FSDPBucketingStrategy = FSDPBucketingStrategy.NONE, axis: str = "fsdp",
         shard_data: bool = True):
    """Shard a model's parameters along dim 0 over the mesh axis
    (``fsdp:303``, ``_shard_param:406``).

    - a torch ``nn.Module`` or jitted module: tagged; when jitted, each rank's
      parameter keeps its dim-0 block (one whose dim 0 does not divide stays
      replicated), a ``synchronize`` all-gathers it at trace time, and the
      backward reduce-scatters its grad into the shard's ``.grad``.
    - a pytree: proxies are marked FULLY_SHARDED; with ``mesh``, each tensor
      whose dim 0 divides over the axis becomes this rank's dim-0 block.
    """
    if _is_module(model_or_params):
        return _attach_dist_config(model_or_params, {"mode": "fsdp", "mesh": mesh, "axis": axis,
                                                     "fsdp_type": sharding_strategy, "bucketing": bucketing_strategy,
                                                     "shard_data": shard_data})
    marked = _mark(model_or_params, DistParallelType.FULLY_SHARDED)
    if mesh is None:
        return marked
    from thunder_tpu_torch.core.pytree import tree_map
    from thunder_tpu_torch.distributed import runtime

    group = runtime.resolve_axes(mesh, (axis,))[axis]
    n, r = tdist.get_world_size(group), tdist.get_rank(group)

    def shard(p):
        if isinstance(p, torch.Tensor) and p.ndim >= 1 and p.shape[0] % n == 0 and n > 1:
            m = p.shape[0] // n
            return p.narrow(0, r * m, m).clone()
        return p

    return tree_map(shard, marked)


def _mark(tree, kind: DistParallelType):
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.core.pytree import tree_map

    def mark(p):
        if isinstance(p, TensorProxy):
            p.dist_parallel_type = kind
        return p

    return tree_map(mark, tree)


from thunder_tpu_torch.distributed import prims  # noqa: E402,F401
