"""Training steps. One device for now: the mesh, shardings and collectives of
``thunder_tpu/parallel/`` come with the distribution slice (ROADMAP.md)."""

from thunder_tpu_torch.parallel.train import adamw_init, adamw_update, build_train_step

__all__ = ["adamw_init", "adamw_update", "build_train_step"]
