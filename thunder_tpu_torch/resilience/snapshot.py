"""Tiered snapshot store: RAM ring + buddy-replicated restore tiers.

The counterpart of ``thunder_tpu/resilience/snapshot.py``. The disk
checkpoint (``resilience/preemption.CheckpointManager``) is durable but
expensive: a synchronous save gathers the state to the host and pays the
write/rename protocol on the hot path. The tiers split the cost:

- the **step-boundary stall** is only the device-to-host copy (into pinned
  memory, one ``torch.cuda.synchronize``) plus a crc32 over the host bytes:
  a :class:`Snapshot`, measured and emitted as the ``snapshot`` event's
  ``stall_ms``;
- durability moves to a background writer thread inside
  ``CheckpointManager`` (the tmp -> rename -> META protocol, off the hot
  path);
- availability comes from RAM: each process keeps a small ring of recent
  snapshots (:class:`SnapshotStore`) and replicates every snapshot to a
  **buddy**, so the tiered restore (``resilience/elastic.elastic_resume``)
  can try local RAM -> peer RAM -> disk, checksum-validating each tier and
  falling through on mismatch or absence.

Integrity reuses the SDC guard's checksum
(:func:`~thunder_tpu_torch.resilience.watchdog.array_crc32`): every snapshot
records per-leaf crc32s at capture time and :meth:`Snapshot.verify`
recomputes them before a restore trusts the bytes, so a corrupted replica
(chaos seam ``snap_corrupt``) degrades to the next tier instead of resuming
from poison. The buddy is another in-process :class:`SnapshotStore` (a pair
or a ring of them); shipping a snapshot to another host's RAM is not in the
port.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

TIERS = ("local", "peer", "disk")


def to_host(state: Any, *, mesh=None, specs=None) -> Any:
    """Device-to-host copy of a pytree of tensors: the ONLY work on the
    training hot path (the ``checkpoint_stall_ms`` the ``snapshot`` event
    measures). Leaves that ``specs`` splits over ``mesh`` are all-gathered
    first (``distributed/checkpoint.gather_full``); each CUDA leaf is
    copied into pinned host memory without a sync, and one
    ``torch.cuda.synchronize`` ends the copies."""
    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.distributed.checkpoint import gather_full

    flat, spec = tree_flatten(gather_full(state, mesh=mesh, specs=specs) if specs is not None else state)
    out, synced = [], False
    for x in flat:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                x, synced = host, True
            else:
                x = x.clone()
        out.append(x)
    if synced:
        torch.cuda.synchronize()
    return tree_unflatten(out, spec)


def _is_array(leaf) -> bool:
    import numpy as np
    import torch

    return (isinstance(leaf, torch.Tensor) and leaf.numel() > 0) or (isinstance(leaf, np.ndarray) and leaf.size > 0)


def pytree_crc32(host_state: Any) -> tuple:
    """Per-tensor-leaf crc32s of a host pytree, in flatten order: the SDC
    guard's integrity code (``watchdog.array_crc32``) applied to a
    snapshot. Non-tensor leaves (step counters, python scalars) are skipped:
    they travel in the snapshot but are not checksummed."""
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.resilience.watchdog import array_crc32

    flat, _ = tree_flatten(host_state)
    return tuple(array_crc32(leaf) for leaf in flat if _is_array(leaf))


@dataclass
class Snapshot:
    """One step-boundary capture: the host-side state plus everything a
    restore needs (rng stream, writing mesh shape) and the capture-time
    crc32s that let a later restore verify the bytes are still the bytes."""

    step: int
    state: Any
    rng_seed: Optional[int] = None
    mesh: Optional[dict] = None
    crcs: tuple = ()
    ts: float = field(default_factory=time.time)

    def verify(self) -> bool:
        """True iff the state's array bytes still match the capture-time
        checksums — the gate every RAM-tier restore passes through."""
        return pytree_crc32(self.state) == self.crcs

    def share(self) -> "Snapshot":
        """A new Snapshot sharing the underlying arrays — what replication
        hands the buddy. Sharing is safe because corruption (the chaos
        seam) is copy-on-write: :meth:`SnapshotStore.corrupt_newest`
        replaces the flipped leaf instead of mutating it in place, so one
        tier's corruption never bleeds into the other's copy."""
        return Snapshot(step=self.step, state=self.state,
                        rng_seed=self.rng_seed, mesh=self.mesh,
                        crcs=self.crcs, ts=self.ts)


class SnapshotStore:
    """Per-host ring of recent snapshots plus replicas held for buddies.

    ``put`` appends to the local ring (bounded: ``ring`` newest kept) and
    forwards a shared-array copy to the paired buddy, which files it under
    this host's id. The tiered restore reads ``local_snapshots()`` (own
    ring) and ``peer_snapshots()`` (this host's replicas as held BY the
    buddy — where a replacement process would fetch them from after losing
    its RAM), both newest-first."""

    def __init__(self, host: int = 0, *, ring: int = 4):
        self.host = int(host)
        self.ring = int(ring)
        self._ring: deque = deque(maxlen=self.ring)
        self._replicas: dict[int, deque] = {}  # origin host -> ring of copies
        self.buddy: Optional["SnapshotStore"] = None
        # DCN-partition switch (chaos seam ``dcn_partition``): while True,
        # cross-boundary replication AND peer reads are severed — the buddy
        # is unreachable, not just write-blocked.
        self.partitioned = False
        self._lock = threading.Lock()

    @staticmethod
    def pair(a: "SnapshotStore", b: "SnapshotStore") -> None:
        """Mutual buddies: the two-process wiring."""
        a.buddy, b.buddy = b, a

    @classmethod
    def make_ring(cls, stores: list) -> None:
        """Ring-wire a fleet: buddy of store i = store (i+1) % n, so a lost
        member always leaves a surviving buddy holding its replicas. Two
        stores degenerate to :meth:`pair`."""
        n = len(stores)
        if n < 2:
            raise ValueError(f"a buddy ring needs >= 2 stores, got {n}")
        for i, s in enumerate(stores):
            s.buddy = stores[(i + 1) % n]

    # -- writes ---------------------------------------------------------------

    def put(self, snap: Snapshot) -> bool:
        """File ``snap`` in the local ring and replicate it to the buddy.
        Returns True when a buddy held a replica (the ``snapshot`` event's
        ``replicated`` field). A DCN partition (``partitioned`` on either
        end) severs replication: the local ring still fills, the buddy
        holds nothing new — honest degraded durability, reported as
        ``replicated=False``."""
        with self._lock:
            self._ring.append(snap)
        if (self.buddy is not None and not self.partitioned
                and not self.buddy.partitioned):
            self.buddy.receive(self.host, snap.share())
            return True
        return False

    def receive(self, origin: int, snap: Snapshot) -> None:
        """Buddy side of :meth:`put`: hold ``origin``'s replica in a ring
        of the same bound."""
        with self._lock:
            ring = self._replicas.get(origin)
            if ring is None:
                ring = self._replicas[origin] = deque(maxlen=self.ring)
            ring.append(snap)

    def drop_local(self) -> None:
        """Forget the local ring — what a host loss does to RAM. The chaos
        and test harnesses call this to force the peer/disk tiers."""
        with self._lock:
            self._ring.clear()

    # -- reads ----------------------------------------------------------------

    def local_snapshots(self) -> list:
        """Own ring, newest first."""
        with self._lock:
            return list(self._ring)[::-1]

    def peer_snapshots(self) -> list:
        """This host's replicas as held by the buddy, newest first — the
        peer RAM tier of the restore ladder. Unreachable (empty) while
        either end is DCN-partitioned."""
        if self.buddy is None or self.partitioned or self.buddy.partitioned:
            return []
        with self.buddy._lock:
            ring = self.buddy._replicas.get(self.host)
            return list(ring)[::-1] if ring else []

    def has_snapshots(self) -> bool:
        return bool(self.local_snapshots() or self.peer_snapshots())

    def newest_step(self) -> Optional[int]:
        steps = [s.step for s in self.local_snapshots()]
        steps += [s.step for s in self.peer_snapshots()]
        return max(steps) if steps else None

    # -- chaos hook -----------------------------------------------------------

    def corrupt_newest(self, tier: str) -> bool:
        """Flip one bit in the newest snapshot of ``tier`` (``local`` /
        ``peer``) — the ``snap_corrupt`` chaos seam's actuator. The flip is
        copy-on-write (the leaf is copied, flipped, and swapped into THIS
        tier's Snapshot only), so the share()'d twin in the other tier
        keeps the honest bytes. Returns False when the tier is empty or
        holds no array leaf (the rule stays armed — firing on nothing would
        record an injection that never happened)."""
        import numpy as np
        import torch

        from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten

        snaps = (self.local_snapshots() if tier == "local"
                 else self.peer_snapshots())
        # Corrupt the newest snapshot that is still VALID: the bit flip is
        # an XOR, so "corrupting" an already-corrupted snapshot would undo
        # the damage and silently re-validate the tier.
        for snap in snaps:
            if not snap.verify():
                continue
            flat, spec = tree_flatten(snap.state)
            for i, leaf in enumerate(flat):
                if _is_array(leaf):
                    bad = leaf.clone() if isinstance(leaf, torch.Tensor) else leaf.copy()
                    if isinstance(bad, torch.Tensor):
                        bad.reshape(-1)[:1].view(torch.uint8)[:1].bitwise_xor_(1)
                    else:
                        bad.view(np.uint8).reshape(-1)[0] ^= 1
                    flat = list(flat)
                    flat[i] = bad
                    snap.state = tree_unflatten(flat, spec)
                    return True
            return False
        return False
