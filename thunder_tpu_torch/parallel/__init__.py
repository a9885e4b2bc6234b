"""Parallelism: meshes of ranks, sharding plans, the sharded training step.

The counterpart of ``thunder_tpu/parallel/`` (ROADMAP item 11a). The
collectives are ``distributed/``'s; context, pipeline and expert
parallelism come with item 11b.
"""

from thunder_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh, MeshConfig, axis_sizes, make_mesh
from thunder_tpu_torch.parallel.sharding import (
    data_spec,
    gather_pytree,
    gpt_param_specs,
    named_shardings,
    reshard_pytree,
    shard_pytree,
)
from thunder_tpu_torch.parallel.train import adamw_init, adamw_update, build_train_step, opt_state_specs

__all__ = ["AXIS_ORDER", "Mesh", "MeshConfig", "axis_sizes", "make_mesh", "data_spec", "gather_pytree",
           "gpt_param_specs", "named_shardings", "reshard_pytree", "shard_pytree", "adamw_init", "adamw_update",
           "build_train_step", "opt_state_specs"]
