"""Parallelism: meshes of ranks, sharding plans, the sharded training step,
and context, pipeline and expert parallelism.

The counterpart of ``thunder_tpu/parallel/``. The collectives are
``distributed/``'s. The mesh, the sharding plans and the sharded step over
dp, fsdp and tp are ROADMAP item 11a; ring and Ulysses attention
(``context``), GPipe and 1F1B (``pipeline``, with the pipelined GPT of
``gpt_pp``), the expert-parallel MLP (``moe``) and the step over pp, ep and
sp are item 11b. The federated mesh of slices (``make_federated_mesh``)
serves the fleet layer (``resilience/federation.py``).
"""

from thunder_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DCN_AXIS,
    Mesh,
    MeshConfig,
    SliceTopology,
    axis_sizes,
    is_federated,
    make_federated_mesh,
    make_mesh,
    slice_axis_size,
)
from thunder_tpu_torch.parallel.moe import moe_mlp, moe_mlp_dense_reference
from thunder_tpu_torch.parallel.pipeline import pipeline_apply
from thunder_tpu_torch.parallel.sharding import (
    data_spec,
    gather_pytree,
    gpt_param_specs,
    named_shardings,
    reshard_pytree,
    shard_pytree,
)
from thunder_tpu_torch.parallel.train import adamw_init, adamw_update, build_train_step, opt_state_specs

__all__ = ["AXIS_ORDER", "DCN_AXIS", "Mesh", "MeshConfig", "SliceTopology", "axis_sizes", "make_mesh",
           "make_federated_mesh", "is_federated", "slice_axis_size", "data_spec", "gather_pytree",
           "gpt_param_specs", "named_shardings", "reshard_pytree", "shard_pytree", "adamw_init", "adamw_update",
           "build_train_step", "opt_state_specs", "moe_mlp", "moe_mlp_dense_reference", "pipeline_apply"]
