"""Elastic resharded resume: continue a training run on a DIFFERENT mesh.

The counterpart of ``thunder_tpu/resilience/elastic.py``. Losing a host
shrinks the set of ranks; the run continues on what survives instead of
waiting for a replacement. The ingredients:

- :class:`~thunder_tpu_torch.resilience.preemption.CheckpointManager`
  records the **mesh shape** (``parallel.mesh.axis_sizes``) in each step's
  META commit marker (``save(mesh=...)``);
- :func:`elastic_resume` restores the newest valid state (every leaf whole)
  and lands it on the target mesh through its ``P`` tree
  (``parallel.sharding.reshard_pytree``): this rank's block of each leaf;
- the caller rebuilds its step for the surviving mesh
  (``parallel.build_train_step``) and continues from the restored step;
- restores are TIERED: :func:`tiered_restore` picks the newest valid state
  across local RAM -> buddy-replicated peer RAM -> disk
  (``resilience/snapshot.SnapshotStore`` attached to the manager),
  checksum-validating each tier and falling through on mismatch, and every
  ``elastic_resume`` event names its winning ``tier``.

Numerics: resharding is bitwise (a gather and a split never touch values),
but the *continued run* on another mesh shape reduces grads and loss in
another order, so its losses match the uninterrupted run's to float
tolerance, not bitwise. Resuming onto the SAME mesh shape stays bitwise.
"""

from __future__ import annotations

from typing import Any, Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm
from thunder_tpu_torch.resilience import chaos
from thunder_tpu_torch.resilience.preemption import (
    CheckpointManager,
    CheckpointRestoreError,
    _land_like,
)


def mesh_shape(mesh) -> Optional[dict]:
    """``{axis: size}`` of a mesh, or None: the shape record checkpoints
    carry and the resume path compares."""
    if mesh is None:
        return None
    from thunder_tpu_torch.parallel.mesh import axis_sizes

    return axis_sizes(mesh)


def reshard_state(state: Any, mesh, specs, *, src_mesh=None, src_specs=None) -> Any:
    """Re-lay-out a state pytree onto ``mesh`` per its ``P`` tree (bitwise:
    only the layout changes). ``src_mesh``/``src_specs`` say how ``state``
    is laid out now; with no ``src_specs`` every leaf is whole (a restored
    checkpoint or snapshot)."""
    from thunder_tpu_torch.core.pytree import tree_map
    from thunder_tpu_torch.distributed.runtime import P
    from thunder_tpu_torch.parallel.sharding import _is_spec, reshard_pytree

    if src_specs is None:
        src_mesh, src_specs = mesh, tree_map(lambda s: P(), specs, is_leaf=_is_spec)
    return reshard_pytree(state, mesh, specs, src_mesh=src_mesh, src_specs=src_specs)


def tiered_restore(manager: CheckpointManager) -> tuple[Any, dict, str, list]:
    """The tier ladder: pick the NEWEST valid state across local RAM ->
    peer RAM -> disk, checksum-validating each RAM candidate and falling
    through on mismatch or absence. Returns ``(state, meta, tier, tried)``
    where ``tier`` names the winning tier and ``tried`` lists the
    ``tier@step`` candidates that failed validation before it.

    Candidates are ordered newest-step-first with the cheaper tier winning
    ties (a local snapshot and its buddy replica carry the same step; the
    local copy needs no fetch). Disk joins the ladder at its newest
    complete step and uses :meth:`CheckpointManager.restore`'s own
    incomplete/corrupt fall-through below that. The chaos ``snap_corrupt``
    seam fires here, before validation. Every outcome is a ``restore``
    event (``tier``, ``ok``, ``tried``); raises
    :class:`~thunder_tpu_torch.resilience.preemption.CheckpointRestoreError`
    when every tier is exhausted."""
    store = getattr(manager, "store", None)
    if hasattr(manager, "drain"):
        # Quiesce the background writer before reading the directory: a
        # restore racing an in-flight flush's rmtree/rename/GC could see a
        # "complete" step vanish mid-scan.
        manager.drain()
    chaos.snapshot_corrupt_seam(store)
    candidates: list = []
    if store is not None:
        for snap in store.local_snapshots():
            candidates.append((snap.step, 0, "local", snap))
        for snap in store.peer_snapshots():
            candidates.append((snap.step, 1, "peer", snap))
    disk_step = manager.latest_complete_step()
    if disk_step is not None:
        candidates.append((disk_step, 2, "disk", None))
    candidates.sort(key=lambda c: (-c[0], c[1]))
    tried: list = []
    for step, _, tier, snap in candidates:
        if tier == "disk":
            try:
                state, meta = manager.restore()
            except CheckpointRestoreError as e:
                obs_events.emit_event(
                    "restore", step=int(step), tier="disk", ok=False,
                    tried=list(tried), reason=str(e),
                )
                tried.append(f"disk@{step}")
                continue
        else:
            if not snap.verify():
                # The crc caught a rotted or corrupted snapshot: fall
                # through to the next tier instead of resuming from poison.
                obs_events.emit_event(
                    "restore", step=int(step), tier=tier, ok=False,
                    reason="checksum mismatch",
                )
                tried.append(f"{tier}@{step}")
                continue
            state = snap.state
            meta = {"step": snap.step, "rng_seed": snap.rng_seed,
                    "mesh": snap.mesh}
        obs_events.emit_event(
            "restore", step=int(meta["step"]), tier=tier, ok=True,
            tried=list(tried),
        )
        if obsm.enabled():
            obsm.RESTORES.inc(tier=tier)
        return state, meta, tier, tried
    raise CheckpointRestoreError(
        f"no valid state in any tier under {manager.directory!r} "
        f"(tried {tried or 'nothing'})"
    )


def elastic_resume(
    manager: CheckpointManager,
    init_state: Any,
    *,
    mesh=None,
    specs=None,
) -> tuple[Any, int]:
    """(state, start_step) like
    :func:`~thunder_tpu_torch.resilience.preemption.resume`, but landing the
    restored state on ``mesh`` (per ``specs``, a ``P`` tree matching the
    state structure; this rank's blocks) even when the checkpoint was
    written by another mesh shape: the surviving-ranks path after a host
    loss. With no ``mesh``/``specs`` the leaves land whole, on the devices
    of ``init_state``'s.

    The restore is TIERED (:func:`tiered_restore`): the newest valid state
    wins across local RAM -> peer RAM -> disk. The ``elastic_resume`` event
    names the winning ``tier`` and the saved -> target shape;
    ``thunder_tpu_elastic_resumes_total`` counts actual reshards. With no
    complete disk step and nothing valid in RAM, returns ``(init_state,
    0)`` (``init_state`` is itself laid out on ``mesh`` when ``specs`` is
    given), while a disk step that exists but fails to load still raises:
    corruption of a real checkpoint stays loud."""
    def _fresh_start():
        nonlocal init_state
        if mesh is not None and specs is not None:
            init_state = reshard_state(init_state, mesh, specs)
        return init_state, 0

    store = getattr(manager, "store", None)
    # Captured BEFORE the restore attempt: a failing disk restore
    # quarantines the steps it rejects, so asking afterwards would make
    # corrupted durable state indistinguishable from never-had-any.
    had_disk = manager.latest_complete_step() is not None
    if not had_disk and not (store is not None and store.has_snapshots()):
        return _fresh_start()

    try:
        state, meta, tier, _tried = tiered_restore(manager)
    except CheckpointRestoreError:
        if not had_disk:
            return _fresh_start()
        raise
    saved_shape = meta.get("mesh")
    target_shape = mesh_shape(mesh)
    resharded = False
    if mesh is not None and specs is not None:
        state = reshard_state(_land_like(state, init_state), mesh, specs)
        resharded = saved_shape is not None and saved_shape != target_shape
    else:
        state = _land_like(state, init_state)
    obs_events.emit_event(
        "elastic_resume",
        step=int(meta["step"]),
        from_mesh=saved_shape,
        to_mesh=target_shape,
        resharded=resharded,
        tier=tier,
    )
    if resharded and obsm.enabled():
        obsm.ELASTIC_RESUMES.inc()
    if meta.get("rng_seed") is not None:
        from thunder_tpu_torch import api

        api._global_rng["seed"] = int(meta["rng_seed"])
    return state, int(meta["step"])

