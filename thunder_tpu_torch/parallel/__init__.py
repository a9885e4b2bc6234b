"""Training steps. One device for now: the mesh and shardings of
``thunder_tpu/parallel/`` come with ROADMAP item 11 (the collectives are
``distributed/``)."""

from thunder_tpu_torch.parallel.train import adamw_init, adamw_update, build_train_step

__all__ = ["adamw_init", "adamw_update", "build_train_step"]
