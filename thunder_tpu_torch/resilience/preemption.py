"""Preemption-safe training: SIGTERM -> synced step-boundary checkpoint -> resume.

The counterpart of ``thunder_tpu/resilience/preemption.py``. Multi-process
training assumes a process can be preempted: the scheduler sends SIGTERM,
every rank must agree to stop at the SAME step boundary, write one
consistent checkpoint (with retry on transient I/O errors), and a fresh
process must resume from the newest *complete* checkpoint, never a torn one.

- :class:`PreemptionGuard`: installs the SIGTERM handler; at each step
  boundary ``should_checkpoint(step)`` returns the agreed decision (an
  all-reduce of the local flags over the world group; one process: the
  local flag). The chaos seam ``preempt@<step>`` feeds the same path.
- :class:`CheckpointManager`: write to tmp -> atomic rename -> ``META.json``
  commit marker, the marker and the rename on rank 0 only, retry/backoff on
  ``OSError`` (the ``ckpt_io`` chaos seam injects here), corrupted or
  incomplete detection on restore with fallback to the newest complete
  step, bounded retention. The state goes through
  ``distributed/checkpoint.save``/``load``.
- :func:`resume` / :func:`run_training`: the loop: restore (step, RNG seed,
  optimizer state), run, checkpoint on preemption or cadence. A resumed run
  reproduces the uninterrupted loss trajectory bit for bit.

Tiered checkpointing: with a
:class:`~thunder_tpu_torch.resilience.snapshot.SnapshotStore` attached and
``async_flush=True``, :meth:`CheckpointManager.snapshot` makes saving
near-free (the hot path pays only the device-to-host copy, measured as
``checkpoint_stall_ms``; disk durability runs on a background writer
thread) and the tiered restore in :mod:`~thunder_tpu_torch.resilience.elastic`
restores from RAM when it can (local RAM -> buddy peer RAM -> disk,
checksum-validated per tier).

With an autopilot installed (``resilience/autopilot.py``), the preemption
branch and the SDC quarantine and re-run are its decisions: the typed
``autopilot_decision`` event first, then the actuator inside its
serialized-recovery section. With none installed they act directly.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import threading
import time
import weakref
from typing import Any, Callable, Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm
from thunder_tpu_torch.resilience import chaos


class CheckpointWriteError(RuntimeError):
    """Checkpoint save failed after exhausting the retry budget. Names the
    ``ckpt_io`` seam so chaos runs fail loudly when retries are too few."""


class CheckpointRestoreError(RuntimeError):
    """No complete checkpoint could be restored from the directory."""


class Preempted(RuntimeError):
    """Raised by :func:`run_training` after the preemption checkpoint is
    durably written — the caller exits; the next process resumes."""

    def __init__(self, step: int, path: str):
        self.step = step
        self.path = path
        super().__init__(f"preempted: checkpoint written at step {step} ({path})")


class HostLost(RuntimeError):
    """Raised by :func:`run_training` when the chaos ``host_loss`` seam (or
    a caller-signalled peer death) fires at a step boundary, after the
    surviving processes agreed on and durably wrote a checkpoint. The
    caller rebuilds a mesh from the surviving devices and continues via
    :func:`~thunder_tpu_torch.resilience.elastic.elastic_resume` — unlike
    :class:`Preempted`, the next process is expected to run on a SMALLER
    mesh."""

    def __init__(self, step: int, path: str):
        self.step = step
        self.path = path
        super().__init__(
            f"host lost: checkpoint written at step {step} ({path}); "
            f"resume on the surviving mesh via resilience.elastic"
        )


def _world() -> int:
    """The job's rank count: the world's, or the survivors' group's after a
    shrink onto the first ranks (``distributed.runtime.job_scope``)."""
    import torch.distributed as dist

    from thunder_tpu_torch.distributed.runtime import job_group

    return dist.get_world_size(job_group()) if dist.is_available() and dist.is_initialized() else 1


def _is_primary() -> bool:
    """True for the process that owns META commit markers and retention
    sweeps (rank 0; one process: always). Keeping marker writes on one rank
    closes the double-write/partial-retention race: two ranks renaming the
    same step dir or sweeping different step sets corrupt the directory's
    commit protocol."""
    if _world() > 1:
        import torch.distributed as dist

        from thunder_tpu_torch.distributed.runtime import job_group

        return dist.get_rank(job_group()) == 0
    return True


def _agree(local: bool, op: str) -> bool:
    """``local`` all-reduced (``op``: "min" or "max") over the job's group
    (one process: itself), on the group's device (the card under NCCL, the
    host under gloo)."""
    if _world() <= 1:
        return local
    import torch
    import torch.distributed as dist

    from thunder_tpu_torch.distributed.checkpoint import _group_device
    from thunder_tpu_torch.distributed.runtime import job_group

    group = job_group()
    flag = torch.tensor([1 if local else 0], dtype=torch.int32, device=_group_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def _multihost_all(local_ok: bool) -> bool:
    """True iff EVERY rank reports ``local_ok``. Doubles as the commit sync
    point: the other ranks wait here for rank 0's META/rename to land before
    trusting the directory state, and learn whether it landed, so a failed
    save cannot masquerade as durable on the ranks whose own writes
    succeeded."""
    return _agree(local_ok, "min")


def _multi_process() -> bool:
    """True on a job of more than one rank: the async checkpoint writer
    stays off its commit path (see :meth:`CheckpointManager.snapshot`)."""
    return _world() > 1


def _wait_for_peers() -> float:
    """Milliseconds this rank waited at a barrier of the job's group: taken
    before a snapshot's gather, so its ``stall_ms`` counts the copy, the
    gather and the crc32, not the skew of the ranks' steps (each process
    its own, where the JAX package's devices share one)."""
    import torch.distributed as dist

    from thunder_tpu_torch.distributed.runtime import job_group

    t0 = time.perf_counter()
    dist.barrier(group=job_group())
    return (time.perf_counter() - t0) * 1e3


def _multihost_any(local: bool) -> bool:
    """True iff ANY rank reports ``local`` (one process: the local flag):
    the agreement primitive for 'one rank saw it, every rank must act on
    it' decisions (preemption flags, host-loss signals)."""
    return _agree(local, "max")


# Live managers, weakly held: each one's in-flight background-flush state is
# what an operator must see of a flush stuck on a dying disk. WeakSet:
# registration must not keep a throwaway manager (and its writer thread)
# alive.
_managers: "weakref.WeakSet" = weakref.WeakSet()


def inflight_flushes() -> list[dict]:
    """Background flushes currently in flight across every live
    :class:`CheckpointManager`: ``[{directory, step, for_s}]`` (the ops
    plane's checkpoint component reads it)."""
    out = []
    now = time.monotonic()
    for mgr in list(_managers):
        step = mgr._inflight_step
        since = mgr._inflight_since
        if step is not None:
            out.append({
                "directory": mgr.directory,
                "step": int(step),
                "for_s": round(now - since, 3) if since is not None else 0.0,
            })
    return out


class PreemptionGuard:
    """SIGTERM-triggered stop flag with multihost agreement.

    Use as a context manager around the training loop; the previous signal
    handler is restored on exit. ``should_checkpoint(step)`` is called at
    step boundaries only, so the checkpoint always lands on a consistent
    state."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self._flag = False
        self._signum: Optional[int] = None
        self._reported = False

    def _handler(self, signum, frame) -> None:
        # Async-signal-safe: ONLY set flags. Emitting an event here could
        # deadlock — EventLog.emit holds a non-reentrant lock, and the
        # handler runs on whatever thread was interrupted, possibly inside
        # that very emit. The event is emitted at the next step-boundary
        # poll (requested_local), like the chaos preempt path.
        self._flag = True
        self._signum = int(signum)

    def install(self) -> "PreemptionGuard":
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def requested_local(self, step: Optional[int] = None) -> bool:
        if self._flag:
            if not self._reported:
                self._reported = True
                obs_events.emit_event(
                    "preemption", signal=self._signum, step=step
                )
            return True
        if step is not None and chaos.preempt_at_step(step):
            self._flag = True
            self._reported = True
            obs_events.emit_event("preemption", signal=None, step=step)
            return True
        return False

    def should_checkpoint(self, step: Optional[int] = None) -> bool:
        """Multihost-synced stop decision: any host's flag stops every
        host, so all hosts enter the same collective checkpoint save."""
        return _multihost_any(self.requested_local(step))


class CheckpointManager:
    """Durable step checkpoints under ``directory``.

    Layout: ``step_<n>/`` holds the state (``distributed/checkpoint.save``:
    each rank's blocks) plus a ``META.json`` commit marker written LAST — a directory without META is
    incomplete (crashed mid-write) and is ignored (and swept) on restore.
    Saves go to a ``.tmp`` path first and are renamed into place, so a
    crash can never tear a committed step.

    Tiered checkpointing: ``store`` attaches a RAM
    :class:`~thunder_tpu_torch.resilience.snapshot.SnapshotStore` (local ring +
    buddy replica — the fast restore tiers the elastic resume tries before
    disk), and ``async_flush=True`` moves disk durability onto a background
    writer thread: :meth:`snapshot` pays only the device→host copy on the
    hot path (the measured ``checkpoint_stall_ms``) and enqueues the
    tmp→rename→META protocol for the writer, single-in-flight with
    latest-wins backpressure (a newer snapshot supersedes a still-queued
    older one; the superseded one stays restorable in RAM). :meth:`save`
    stays fully synchronous — the preempt/halt path — and drains the
    writer first so two commits never interleave on the directory."""

    META = "META.json"

    def __init__(self, directory: str, *, retries: int = 3,
                 backoff_s: float = 0.1, keep: int = 3,
                 store=None, async_flush: bool = False):
        self.directory = os.path.abspath(directory)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.keep = int(keep)
        self.store = store
        self.async_flush = bool(async_flush)
        # Background-writer state: one flush in flight, at most one pending
        # (latest wins), a writer thread started lazily, and an IO lock so
        # the writer's commit and a synchronous save never interleave the
        # tmp/rename/GC protocol on the same directory.
        self._io_lock = threading.Lock()
        self._flush_cv = threading.Condition()
        self._pending: Optional[tuple] = None  # (Snapshot, Context)
        self._inflight_step: Optional[int] = None
        self._inflight_since: Optional[float] = None
        self._coalesced = 0
        self._writer: Optional[threading.Thread] = None
        self._stop = False
        os.makedirs(self.directory, exist_ok=True)
        _managers.add(self)

    # -- paths ----------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps_on_disk(self) -> list[int]:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if name.startswith("step_") and not name.endswith((".tmp", ".corrupt")):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def _is_complete(self, step: int) -> bool:
        return os.path.isfile(os.path.join(self._step_dir(step), self.META))

    def latest_complete_step(self) -> Optional[int]:
        for step in reversed(self.steps_on_disk()):
            if self._is_complete(step):
                return step
        return None

    # -- save -----------------------------------------------------------------

    @staticmethod
    def _mesh_meta(mesh) -> Optional[dict]:
        if mesh is None:
            return None
        if not hasattr(mesh, "axis_names"):
            return {str(k): int(v) for k, v in mesh.items()}
        from thunder_tpu_torch.parallel.mesh import axis_sizes

        return axis_sizes(mesh)

    def _write_attempts(self, state: Any, step: int, *,
                        rng_seed: Optional[int], mesh_meta: Optional[dict],
                        flush_seams: bool = False, layout: tuple = (None, None),
                        ) -> tuple[Optional[OSError], int, bool]:
        """The tmp-write → atomic-rename → META-commit loop with
        retry/backoff — shared by the synchronous :meth:`save` and the
        background flush. Returns ``(terminal_error, attempts, torn)``;
        ``torn`` (flush path only, the ``snap_torn`` chaos seam) means the
        step directory landed WITHOUT its commit marker — the simulated
        writer-crash shape :meth:`restore` must skip."""
        final = self._step_dir(step)
        primary = _is_primary()
        attempt = 0
        while True:
            tmp = final + ".tmp"
            try:
                chaos.checkpoint_seam()
                with self._io_lock:
                    if primary and os.path.isdir(tmp):
                        shutil.rmtree(tmp)
                    self._write_state(state, tmp, *layout)
                    if flush_seams:
                        # The juicy window: tmp written, nothing committed.
                        # snap_slow holds it open (a slow disk with an
                        # uncommitted tmp on it); snap_torn "crashes" here.
                        chaos.flush_slow_seam()
                        if chaos.flush_torn_seam():
                            # A real crash between the state write and the
                            # META marker can never destroy an already-
                            # committed dir at this step — rename into
                            # place only when the slot is empty, else the
                            # torn shape is just the orphaned .tmp.
                            if primary and not os.path.isdir(final):
                                os.rename(tmp, final)
                            return None, attempt, True
                    if primary:
                        meta = {
                            "step": int(step),
                            "rng_seed": int(rng_seed) if rng_seed is not None else None,
                            "mesh": mesh_meta,
                            "ts": time.time(),
                        }
                        with open(os.path.join(tmp, self.META), "w") as f:
                            json.dump(meta, f)
                        if os.path.isdir(final):
                            shutil.rmtree(final)
                        os.rename(tmp, final)
                return None, attempt, False
            except OSError as e:
                obs_events.emit_event(
                    "checkpoint_save", path=final, step=int(step), ok=False,
                    attempt=attempt, error=str(e),
                )
                if attempt >= self.retries:
                    return e, attempt, False
                if obsm.enabled():
                    obsm.CHECKPOINT_RETRIES.inc()
                if self.backoff_s:
                    time.sleep(min(self.backoff_s * (2 ** attempt), 2.0))
                attempt += 1

    def _committed(self, step: int, attempt: int) -> str:
        """Post-commit bookkeeping shared by save and flush: the ok
        ``checkpoint_save`` record (the recovery event the ckpt_io/preempt
        correlation rules key on) and the primary-only retention sweep."""
        final = self._step_dir(step)
        obs_events.emit_event(
            "checkpoint_save", path=final, step=int(step), ok=True,
            attempt=attempt,
        )
        if _is_primary():
            self._gc()
        return final

    def save(self, state: Any, step: int, *, rng_seed: Optional[int] = None,
             mesh=None, specs=None) -> str:
        """Write ``state`` for ``step`` SYNCHRONOUSLY with retry/backoff on
        transient I/O errors; returns the committed directory path. This is
        the durability barrier: the preempt/halt/host-loss paths call it
        and must not return until the step is on disk.

        With the async writer armed, the in-flight background flush is
        drained first and any still-queued older snapshot is discarded —
        this newer synchronous commit supersedes it (the superseded
        snapshot remains restorable from the RAM tiers).

        ``mesh`` (a ``parallel.Mesh`` or an ``{axis: size}`` dict) records
        the mesh SHAPE that wrote the checkpoint in the META commit marker:
        the record :func:`~thunder_tpu_torch.resilience.elastic.
        elastic_resume` compares against the surviving mesh to decide
        whether a reshard is needed. ``specs`` (a tree of ``P`` matching
        the state) says which leaves are this rank's blocks over ``mesh``.

        Multi-rank discipline: every rank writes its part of the
        (collective) state payload, but ONLY rank 0 writes the META marker,
        renames the step into place, and runs retention sweeps; the other
        ranks wait on the commit: two ranks racing the rename/GC is the
        double-write/partial-retention hazard this closes."""
        self._drain(discard_pending=True)
        terminal, attempt, _ = self._write_attempts(
            state, step, rng_seed=rng_seed, mesh_meta=self._mesh_meta(mesh),
            layout=(mesh if hasattr(mesh, "axis_names") else None, specs),
        )
        # Commit sync: every host reports its terminal status and learns the
        # fleet's. Non-primary hosts both wait for the primary's META/rename
        # to land AND find out whether it did — a step is durable only when
        # EVERY writer committed.
        all_ok = _multihost_all(terminal is None)
        if terminal is not None:
            raise CheckpointWriteError(
                f"checkpoint save for step {step} failed after "
                f"{attempt + 1} attempt(s) at seam ckpt_io: {terminal}"
            ) from terminal
        if not all_ok:
            raise CheckpointWriteError(
                f"checkpoint save for step {step} failed on a peer host — "
                f"the step was not committed"
            )
        return self._committed(step, attempt)

    # -- the async tier: snapshot + background flush ---------------------------

    def snapshot(self, state: Any, step: int, *,
                 rng_seed: Optional[int] = None, mesh=None, specs=None,
                 flush: bool = False):
        """Step-boundary snapshot: device→host copy + crc32 — the ONLY work
        on the training hot path, measured and emitted as the ``snapshot``
        event's ``stall_ms``. The snapshot lands in the RAM tiers (local
        ring + buddy replica via ``self.store``) immediately; with
        ``flush=True`` it is also queued for the background writer's disk
        commit (single in-flight; a newer queued snapshot replaces an older
        one that has not started writing — latest-wins backpressure, so a
        slow disk can never grow a backlog). Returns the
        :class:`~thunder_tpu_torch.resilience.snapshot.Snapshot` (its state
        whole: the blocks ``specs`` splits over ``mesh`` are gathered). On
        more than one rank the gather waits first at a barrier of the job's
        group, outside ``stall_ms``; the event's ``peer_wait_ms`` holds the
        wait."""
        from thunder_tpu_torch.resilience import snapshot as snap_mod

        gathers = specs is not None and hasattr(mesh, "axis_names") and _multi_process()
        wait_ms = _wait_for_peers() if gathers else None
        t0 = time.perf_counter()
        host_state = snap_mod.to_host(state, mesh=mesh if hasattr(mesh, "axis_names") else None, specs=specs)
        crcs = snap_mod.pytree_crc32(host_state)
        stall_ms = (time.perf_counter() - t0) * 1e3
        snap = snap_mod.Snapshot(
            step=int(step), state=host_state,
            rng_seed=int(rng_seed) if rng_seed is not None else None,
            mesh=self._mesh_meta(mesh), crcs=crcs,
        )
        replicated = self.store.put(snap) if self.store is not None else False
        if obsm.enabled():
            obsm.SNAPSHOTS.inc()
            obsm.CHECKPOINT_STALL_MS.observe(stall_ms)
        obs_events.emit_event(
            "snapshot", step=int(step), stall_ms=round(stall_ms, 3),
            replicated=replicated,
            ring=len(self.store.local_snapshots()) if self.store is not None else 0,
            **({} if wait_ms is None else {"peer_wait_ms": round(wait_ms, 3)}),
        )
        if flush:
            if _multi_process():
                # The background writer is process-local: its latest-wins
                # coalescing can leave different ranks flushing different
                # steps, and the collective save runs barriers, so a skewed
                # job would deadlock. On more than one rank the disk cadence
                # stays on the synchronous save() protocol (commit barrier
                # included); the RAM tiers above still provide the cheap
                # snapshots and fast restores. The snapshot's state is
                # whole, so it is saved with no layout.
                self.save(snap.state, snap.step, rng_seed=snap.rng_seed,
                          mesh=snap.mesh)
            else:
                self._enqueue_flush(snap)
        return snap

    def _enqueue_flush(self, snap) -> None:
        import contextvars

        # The writer must run each flush under the SUBMITTER's context:
        # chaos scopes and event-log routing are contextvars and a plain
        # thread starts from an empty context (as for the watchdog worker),
        # snapshotted per flush so a scope entered after the writer thread
        # started still reaches its seams.
        ctx = contextvars.copy_context()
        with self._flush_cv:
            if self._pending is not None:
                self._coalesced += 1
            self._pending = (snap, ctx)
            if self._writer is None or not self._writer.is_alive():
                self._stop = False
                self._writer = threading.Thread(
                    target=self._writer_loop, name="thunder-tpu-torch-ckpt-writer",
                    daemon=True,
                )
                self._writer.start()
            self._flush_cv.notify_all()

    def _writer_loop(self) -> None:
        while True:
            with self._flush_cv:
                while self._pending is None and not self._stop:
                    self._flush_cv.wait()
                if self._pending is None:
                    return
                snap, ctx = self._pending
                self._pending = None
                self._inflight_step = snap.step
                self._inflight_since = time.monotonic()
                coalesced, self._coalesced = self._coalesced, 0
            try:
                ctx.run(self._flush_one, snap, coalesced=coalesced)
            except BaseException:
                # The flush reports via its events; the writer itself must
                # survive anything — a dead writer would silently end disk
                # durability for the rest of the run.
                pass
            finally:
                with self._flush_cv:
                    self._inflight_step = None
                    self._inflight_since = None
                    self._flush_cv.notify_all()

    def _flush_one(self, snap, *, coalesced: int = 0, sync: bool = False) -> None:
        """Commit one snapshot to disk (writer thread, or the caller's
        thread for the synchronous ``flush()``), reporting the outcome as a
        ``snapshot_flush`` event. Never raises: a flush that exhausts its
        retries leaves the RAM tiers holding the snapshot and the next
        synchronous save to fail loudly."""
        t0 = time.perf_counter()
        reason = None
        try:
            terminal, attempt, torn = self._write_attempts(
                snap.state, snap.step, rng_seed=snap.rng_seed,
                mesh_meta=snap.mesh, flush_seams=True,
            )
            ok = terminal is None and not torn
            if torn:
                reason = "torn"
            elif terminal is not None:
                reason = f"retries exhausted: {terminal}"
        except Exception as e:  # a commit bug must not kill the writer
            ok, attempt = False, 0
            reason = str(e)
        ms = (time.perf_counter() - t0) * 1e3
        if obsm.enabled():
            obsm.SNAPSHOT_FLUSHES.inc(ok=str(ok).lower())
        extra: dict = {}
        if reason:
            extra["reason"] = reason
        if coalesced:
            extra["coalesced"] = coalesced
        obs_events.emit_event(
            "snapshot_flush", step=int(snap.step), ok=ok,
            ms=round(ms, 3), sync=sync, **extra,
        )
        if ok:
            self._committed(snap.step, attempt)

    def drain(self) -> None:
        """Public quiesce point: wait until the writer is fully idle —
        both the in-flight flush AND any queued-but-unstarted one have
        completed (a pending flush the writer dequeues a moment after a
        weaker drain returned would race the directory scan all the
        same). The tiered restore calls this before reading the
        directory — a restore racing the writer's rmtree/rename/GC could
        see a step vanish mid-scan."""
        with self._flush_cv:
            while (self._inflight_step is not None
                   or self._pending is not None):
                self._flush_cv.wait()

    def _drain(self, *, discard_pending: bool = False) -> None:
        """Wait out the in-flight background flush (and optionally drop the
        queued one) — the preamble every synchronous commit runs so two
        writers never interleave on the directory."""
        with self._flush_cv:
            if discard_pending:
                self._pending = None
                self._coalesced = 0
            while self._inflight_step is not None:
                self._flush_cv.wait()

    def flush(self, *, wait: bool = True) -> None:
        """Synchronous flush barrier (the preempt/halt path and tests):
        wait out the in-flight background write, then commit any
        still-pending snapshot on the CALLER's thread (its
        ``snapshot_flush`` event carries ``sync=true``)."""
        pending = None
        coalesced = 0
        with self._flush_cv:
            while wait and self._inflight_step is not None:
                self._flush_cv.wait()
            if self._pending is not None:
                pending, _ctx = self._pending
                self._pending = None
                coalesced, self._coalesced = self._coalesced, 0
        if pending is not None:
            self._flush_one(pending, coalesced=coalesced, sync=True)

    def close(self) -> None:
        """Flush and stop the background writer (tests and orderly
        shutdown; production relies on the daemon flag plus the synchronous
        preempt-path :meth:`save`)."""
        self.flush(wait=True)
        with self._flush_cv:
            self._stop = True
            self._flush_cv.notify_all()
        w = self._writer
        if w is not None and w.is_alive():
            w.join(timeout=5.0)

    def _write_state(self, state: Any, tmp_dir: str, mesh=None, specs=None) -> None:
        # distributed/checkpoint.save: each rank writes its blocks (a leaf
        # ``specs`` splits over ``mesh``), the collective writes agreed by
        # torch.distributed.checkpoint.
        from thunder_tpu_torch.distributed import checkpoint as dckpt

        os.makedirs(tmp_dir, exist_ok=True)
        dckpt.save(state, os.path.join(tmp_dir, "state"), mesh=mesh, specs=specs)

    def _read_state(self, step_dir: str) -> Any:
        # Every leaf whole, on the process group's device (the host with no
        # group): the caller lands it where it belongs.
        from thunder_tpu_torch.distributed import checkpoint as dckpt

        return dckpt.load(os.path.join(step_dir, "state"))

    def _quarantined_on_disk(self) -> list[str]:
        """Quarantined checkpoint dirs (``step_*.corrupt`` /
        ``step_*.corrupt.N``), oldest first by the STEP INDEX parsed from
        the name, NOT by mtime: the async writer commits out of order
        relative to synchronous saves, so mtime lies about age and an
        mtime-keyed sweep could evict the newest quarantine. mtime only
        tiebreaks repeat quarantines of one step."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if name.startswith("step_") and ".corrupt" in name:
                path = os.path.join(self.directory, name)
                stem = name[len("step_"):].split(".corrupt", 1)[0]
                try:
                    step = int(stem)
                except ValueError:
                    step = -1
                try:
                    out.append((step, os.path.getmtime(path), path))
                except OSError:
                    continue
        return [p for _, _, p in sorted(out)]

    def _gc(self) -> None:
        # Retention is keyed on the STEP INDEX (steps_on_disk sorts
        # numerically), never mtime: a slow background flush of step N can
        # commit AFTER the synchronous save of step N+k, and an
        # mtime-ordered sweep would then evict the newest checkpoint while
        # keeping the stale flush. restore()'s
        # newest-first scan walks the same step order.
        steps = [s for s in self.steps_on_disk() if self._is_complete(s)]
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # Write debris: an incomplete step dir (torn write — renamed into
        # place without META) or an orphaned .tmp older than the newest
        # complete step can never become complete (its writer moved on);
        # sweeping keeps restore()'s scan short and the directory bounded
        # under a chaos soak full of torn flushes. Primary-only, like the
        # rest of the sweep.
        if steps:
            newest = steps[-1]
            for s in self.steps_on_disk():
                if s < newest and not self._is_complete(s):
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                names = os.listdir(self.directory)
            except OSError:
                names = []
            for name in names:
                if name.startswith("step_") and name.endswith(".tmp"):
                    try:
                        s = int(name[len("step_"):-len(".tmp")])
                    except ValueError:
                        continue
                    if s < newest:
                        shutil.rmtree(os.path.join(self.directory, name),
                                      ignore_errors=True)
        # Quarantined (.corrupt/.corrupt.N) dirs fold into the same bounded
        # retention, or repeated corruption over a long run would grow the
        # directory without limit. Newest `keep` quarantines stay for
        # post-mortem; older ones go. Primary-only, like the rest of the
        # sweep.
        if self.keep > 0:
            for path in self._quarantined_on_disk()[:-self.keep]:
                shutil.rmtree(path, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def _sweep_stale_tmps(self) -> int:
        """Sweep orphan ``step_*.tmp`` dirs at restore time. A writer that
        died mid-flush (between the tmp write and the rename) leaves its
        tmp behind forever: ``_gc`` only reaps tmps OLDER than the newest
        complete step, so a crash mid-flush of the newest step accumulated
        debris across every resume cycle of a chaos soak. At restore entry
        no tmp can still become a checkpoint — the writer that owned it is
        gone and a live background flush publishes under its own step
        (skipped here via ``_inflight_step``) — so everything else found is
        stale. Primary-only, like the rest of the sweep; logged as a
        ``ckpt_tmp_sweep`` event so the accumulation is visible instead of
        silent. Returns the number of dirs swept."""
        if not _is_primary():
            return 0
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        inflight = self._inflight_step
        swept = []
        for name in sorted(names):
            if not (name.startswith("step_") and name.endswith(".tmp")):
                continue
            try:
                step = int(name[len("step_"):-len(".tmp")])
            except ValueError:
                step = -1
            if inflight is not None and step == inflight:
                continue
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
            swept.append(step)
        if swept:
            obs_events.emit_event("ckpt_tmp_sweep", count=len(swept),
                                  steps=swept)
        return len(swept)

    def restore(self) -> tuple[Any, dict]:
        """(state, meta) from the newest COMPLETE checkpoint. A step that
        exists but is incomplete (no META — torn write) or fails to load
        (corrupted payload) is quarantined as ``.corrupt`` and the next
        newest complete step is tried; :class:`CheckpointRestoreError` when
        none remain. Entry first sweeps orphan ``*.tmp`` debris left by
        writers that died mid-flush (:meth:`_sweep_stale_tmps`)."""
        self._sweep_stale_tmps()
        candidates = [s for s in reversed(self.steps_on_disk())]
        tried = []
        for step in candidates:
            step_dir = self._step_dir(step)
            if not self._is_complete(step):
                obs_events.emit_event(
                    "checkpoint_restore", path=step_dir, step=step, ok=False,
                    reason="incomplete (no commit marker)",
                )
                tried.append(step)
                continue
            try:
                with open(os.path.join(step_dir, self.META)) as f:
                    meta = json.load(f)
                state = self._read_state(step_dir)
            except Exception as e:  # corrupted payload/marker: fall back
                obs_events.emit_event(
                    "checkpoint_restore", path=step_dir, step=step, ok=False,
                    reason=f"corrupted: {e}",
                )
                # Unique quarantine name: the same step can corrupt more than
                # once across resume cycles, and rename onto an existing
                # .corrupt dir would raise instead of falling back.
                target = step_dir + ".corrupt"
                n = 1
                while os.path.exists(target):
                    target = f"{step_dir}.corrupt.{n}"
                    n += 1
                try:
                    os.rename(step_dir, target)
                except OSError:
                    # The dir mutated under us (a writer re-committing or a
                    # GC sweep): the fall-through below is still correct —
                    # a restore must degrade, never crash on directory
                    # churn.
                    pass
                tried.append(step)
                continue
            obs_events.emit_event(
                "checkpoint_restore", path=step_dir, step=step, ok=True,
                fallback=bool(tried),
            )
            return state, meta
        raise CheckpointRestoreError(
            f"no complete checkpoint under {self.directory!r} "
            f"(tried steps {tried or 'none'})"
        )


def _land_like(state: Any, like: Any) -> Any:
    """Each restored tensor leaf moved to the device of the matching leaf
    of ``like`` (the caller's initial state), keeping its bits; the tree of
    ``state`` when the structures differ."""
    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten

    flat, spec = tree_flatten(state)
    ref, ref_spec = tree_flatten(like)
    if len(flat) != len(ref):
        return state
    out = [x.to(r.device) if isinstance(x, torch.Tensor) and isinstance(r, torch.Tensor) and x.device != r.device
           else x for x, r in zip(flat, ref)]
    return tree_unflatten(out, spec)


def resume(manager: CheckpointManager, init_state: Any) -> tuple[Any, int]:
    """(state, start_step): the restored newest complete checkpoint, landed
    on the devices of ``init_state``'s leaves, or ``(init_state, 0)`` for a
    fresh run. Restores the global RNG seed so random ops continue the
    saved stream."""
    if manager.latest_complete_step() is None:
        return init_state, 0
    state, meta = manager.restore()
    if meta.get("rng_seed") is not None:
        from thunder_tpu_torch import api

        api._global_rng["seed"] = int(meta["rng_seed"])
    return _land_like(state, init_state), int(meta["step"])


def run_training(
    step_fn: Callable,
    state: Any,
    n_steps: int,
    *,
    manager: CheckpointManager,
    guard: Optional[PreemptionGuard] = None,
    save_every: int = 0,
    snapshot_every: int = 0,
    on_loss: Optional[Callable] = None,
    mesh=None,
    specs=None,
    sdc_guard=None,
    watchdog_timeout_s: Optional[float] = None,
    start_step: Optional[int] = None,
) -> tuple[Any, list]:
    """Drive ``step_fn(state) -> (state, loss)`` for ``n_steps`` with
    preemption-safe checkpointing.

    Resumes from ``manager``'s newest complete checkpoint; checks the
    preemption guard at every step boundary (agreed over the ranks) and,
    when preemption is requested, saves and raises :class:`Preempted`;
    ``save_every > 0`` also checkpoints on that cadence. Returns
    ``(final_state, losses_this_run)``.

    ``snapshot_every > 0`` takes a near-free RAM snapshot
    (``manager.snapshot``: the device-to-host copy only) on that cadence, so
    a fault loses at most ``snapshot_every`` steps; with the manager's async
    writer armed (``CheckpointManager(async_flush=True)``) the
    ``save_every`` disk cadence rides the background flush (the preempt and
    host-loss saves stay synchronous: they are the durability barrier).

    On a mesh:

    - ``mesh`` stamps the mesh shape into every checkpoint's META marker so
      a later :func:`~thunder_tpu_torch.resilience.elastic.elastic_resume`
      can reshard onto another mesh; ``specs`` (a tree of ``P`` matching
      ``state``) says which leaves are this rank's blocks, for the save and
      for the SDC guard;
    - the chaos ``host_loss`` seam at a step boundary checkpoints and
      raises :class:`HostLost` (the surviving ranks' resume path);
    - ``sdc_guard`` (True or a :class:`~thunder_tpu_torch.resilience.
      watchdog.SDCGuard`) cross-checks replica checksums after each guarded
      step, quarantines a divergent step, and re-runs it from the previous
      state: ``step_fn`` must not update its input state in place;
    - ``watchdog_timeout_s`` (or ``THUNDER_TPU_COLLECTIVE_TIMEOUT_S``) runs
      each step under the collective watchdog, turning a hung collective
      into a typed :class:`~thunder_tpu_torch.resilience.watchdog.
      CollectiveTimeoutError`;
    - ``start_step`` skips the internal :func:`resume` and starts the loop
      there with ``state`` as passed (a caller that restored, and perhaps
      resharded, the state itself).

    With an autopilot installed (``resilience.autopilot.current()``), the
    preemption branch and the SDC quarantine route their choices through it
    first, so every recovery carries a typed ``autopilot_decision``
    event."""
    from thunder_tpu_torch import api
    from thunder_tpu_torch.resilience import autopilot as ap_mod
    from thunder_tpu_torch.resilience import watchdog as wd

    sdc = wd.resolve_sdc_guard(sdc_guard)
    if sdc is not None and getattr(step_fn, "_thunder_donates", False):
        raise ValueError(
            "run_training(sdc_guard=...) requires a step_fn that does not update its input state in place: "
            "the quarantine re-run reads the previous state after the step ran"
        )
    if sdc is not None:
        sdc.mesh = mesh if hasattr(mesh, "axis_names") else None
        sdc.specs = specs
    replica_of = wd.replica_layout(sdc.mesh, specs) if sdc is not None else None
    step_name = getattr(step_fn, "__name__", "step")
    own_guard = guard is None
    guard = guard if guard is not None else PreemptionGuard().install()
    losses: list = []

    def run_step(s):
        if watchdog_timeout_s is not None or wd.enabled():
            return wd.guard_call(
                step_fn, (s,), fn_name=step_name, timeout_s=watchdog_timeout_s
            )
        return step_fn(s)

    def corrupt(s):
        return chaos.maybe_corrupt_replica(s, replica_of=replica_of) if chaos.enabled() else s

    try:
        if start_step is not None:
            start = int(start_step)
        else:
            state, start = resume(manager, state)
        for step in range(start, n_steps):
            if guard.should_checkpoint(step):
                ap = ap_mod.current()
                ctx = contextlib.nullcontext()
                if ap is not None:
                    # The decision precedes its recovery event (the ok
                    # checkpoint_save below) so the replay can pair them;
                    # the save, the actuator, runs inside the
                    # serialized-recovery section.
                    ctx = ap.recovery(ap.decide(ap_mod.Signal("preempt", step=step)))
                with ctx:
                    path = manager.save(
                        state, step, rng_seed=api._global_rng["seed"], mesh=mesh, specs=specs
                    )
                raise Preempted(step, path)
            # Host-loss agreement runs through the same any-rank collective
            # as preemption: a rank-targeted injection (host_loss@N,host=1)
            # fires on one process, and every other must learn of it here
            # and enter the same collective save.
            if _multihost_any(chaos.host_loss_at_step(step)):
                obs_events.emit_event(
                    "host_loss", step=step, host=chaos.process_index()
                )
                path = manager.save(
                    state, step, rng_seed=api._global_rng["seed"], mesh=mesh, specs=specs
                )
                raise HostLost(step, path)
            t0 = time.perf_counter()
            prev = state if sdc is not None else None
            state, loss = run_step(state)
            state = corrupt(state)
            if sdc is not None and sdc.due(step):
                state, loss = _sdc_check_and_rerun(
                    sdc, run_step, corrupt, prev, state, loss, step
                )
            losses.append(loss)
            # One step_time event per training step per rank: the per-rank
            # logs merge into the cross-host health summary
            # (analysis/events.host_health: straggler detection).
            obs_events.emit_event("step_time", fn=step_name,
                                  step=step, s=round(time.perf_counter() - t0, 6))
            if on_loss is not None:
                on_loss(step, loss)
            done = step + 1
            if done < n_steps:
                want_disk = bool(save_every and done % save_every == 0)
                want_snap = bool(snapshot_every and done % snapshot_every == 0)
                if (want_disk or want_snap) and getattr(manager, "async_flush", False):
                    # Tiered path: the hot loop pays only the device-to-host
                    # snapshot; the disk cadence rides the background writer.
                    manager.snapshot(
                        state, done, rng_seed=api._global_rng["seed"],
                        mesh=mesh, specs=specs, flush=want_disk,
                    )
                else:
                    if want_snap and hasattr(manager, "snapshot"):
                        manager.snapshot(
                            state, done, rng_seed=api._global_rng["seed"],
                            mesh=mesh, specs=specs,
                        )
                    if want_disk:
                        manager.save(
                            state, done, rng_seed=api._global_rng["seed"],
                            mesh=mesh, specs=specs,
                        )
        return state, losses
    finally:
        if own_guard:
            guard.uninstall()


def _sdc_check_and_rerun(sdc, run_step, corrupt, prev_state, state, loss, step):
    """The SDC quarantine loop: on replica-checksum divergence (or a loss
    spike when armed), discard the poisoned state, re-run the step from
    ``prev_state``, and re-check, up to ``sdc.max_reruns`` times; a
    divergence that survives every re-run raises
    :class:`~thunder_tpu_torch.resilience.watchdog.SDCDetectedError`."""
    from thunder_tpu_torch.resilience import watchdog as wd

    divergence = sdc.check_state(state)
    suspect = bool(divergence) or sdc.loss_suspect(loss)
    if not suspect:
        return state, loss
    leaves = sorted(divergence) if divergence else ["<loss-spike>"]
    if obsm.enabled():
        obsm.SDC_SUSPECTS.inc()
    obs_events.emit_event(
        "sdc_suspect", step=int(step), leaves=leaves,
        devices=wd.suspect_devices(divergence), detail=divergence or None,
    )
    # With an autopilot installed, the quarantine and re-run is a decision:
    # the typed autopilot_decision event precedes the re-run, which runs
    # inside the serialized-recovery section, so an overlapping fault's
    # actuator cannot interleave with it.
    from thunder_tpu_torch.resilience import autopilot as ap_mod

    ap = ap_mod.current()
    ctx = contextlib.nullcontext()
    if ap is not None:
        ctx = ap.recovery(ap.decide(ap_mod.Signal(
            "sdc_suspect", step=int(step),
            evidence={"leaves": leaves, "devices": wd.suspect_devices(divergence)},
        )))
    with ctx:
        for attempt in range(sdc.max_reruns):
            state, loss = run_step(prev_state)
            # A truly bad device corrupts the re-run too: the chaos seam
            # stays in the path so persistent (count>1) SDC rules exercise
            # the rerun-exhausted -> SDCDetectedError ladder.
            state = corrupt(state)
            divergence = sdc.check_state(state)
            ok = not divergence
            if obsm.enabled():
                obsm.SDC_RERUNS.inc(ok=str(ok).lower())
            obs_events.emit_event(
                "sdc_rerun", step=int(step), ok=ok, attempt=attempt
            )
            if ok:
                return state, loss
    # Persistent corruption is about to raise: the flight recorder's ring
    # holds the sdc_suspect/sdc_rerun chain that led here.
    obs_events.flight_dump("sdc")
    raise wd.SDCDetectedError(step, sorted(divergence))
