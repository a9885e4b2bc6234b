"""Tiered checkpointing through both packages, on the CPU.

The 28 cases of ``tests/test_snapshot.py``, written once over a namespace
``P`` and run through the JAX package and the port
(``thunder_tpu_torch/resilience``): the snapshot store's ring and buddy
replication, copy-on-write corruption, the checkpoint manager's snapshot and
background flush (single in-flight, latest-wins coalescing, the writer
seeing the caller's chaos scope, torn and slow flushes, step-keyed
retention), the tiered restore's checksum fall-through, and the replay's
correlation of the snapshot seams. A state is ``{"p": arange(6) + v, "n": 3}``
in float32, a ``jax.Array`` through the JAX package and a CPU tensor through
the port; a resumed run's losses are held equal, bit for bit, to the
uninterrupted run's of the same package.

Also here: ``pytree_crc32`` of the same float32, int32 and bfloat16 bytes is
the same crc in both packages (the port views a bf16 tensor as int16; the
JAX package reads the bf16 bytes through numpy).
"""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu.monitor as jmonitor
import thunder_tpu_torch.monitor as tmonitor
from thunder_tpu.analysis.diagnostics import Severity
from thunder_tpu.analysis.events import replay_events as jreplay
from thunder_tpu.observability import events as jevents
from thunder_tpu.resilience import chaos as jchaos
from thunder_tpu.resilience import elastic as jelastic
from thunder_tpu.resilience import preemption as jpreemption
from thunder_tpu.resilience import snapshot as jsnapshot
from thunder_tpu_torch.analysis.events import replay_events as treplay
from thunder_tpu_torch.observability import events as tevents
from thunder_tpu_torch.resilience import chaos as tchaos
from thunder_tpu_torch.resilience import elastic as telastic
from thunder_tpu_torch.resilience import preemption as tpreemption
from thunder_tpu_torch.resilience import snapshot as tsnapshot


def _jax_arange(n, v=0.0):
    import jax.numpy as jnp

    return jnp.arange(n, dtype=jnp.float32) + v


def _jax_loss(p):
    import jax.numpy as jnp

    return float(jnp.sum(p * p))


JAX = SimpleNamespace(name="jax", monitor=jmonitor, replay=jreplay, events=jevents, chaos=jchaos,
                      elastic=jelastic, preemption=jpreemption, snapshot=jsnapshot, arange=_jax_arange,
                      loss=_jax_loss, asarray=np.asarray)
PORT = SimpleNamespace(name="port", monitor=tmonitor, replay=treplay, events=tevents, chaos=tchaos,
                       elastic=telastic, preemption=tpreemption, snapshot=tsnapshot,
                       arange=lambda n, v=0.0: torch.arange(n, dtype=torch.float32) + v,
                       loss=lambda p: float(torch.sum(p * p)), asarray=lambda x: x.numpy())
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    monkeypatch.delenv("THUNDER_TPU_CHAOS", raising=False)
    was = (jmonitor.enabled(), tmonitor.enabled())
    for ch, m in ((jchaos, jmonitor), (tchaos, tmonitor)):
        ch.reset_env_config()
        m.disable()
        m.reset()
    yield
    for ch, m, on in ((jchaos, jmonitor, was[0]), (tchaos, tmonitor, was[1])):
        m.reset()
        (m.enable if on else m.disable)()
        ch.reset_env_config()


def _events(path):
    return [json.loads(line) for line in open(path)]


def _state(P, v=0.0):
    return {"p": P.arange(6, v), "n": 3}


def _paired_stores(P, ring=4):
    a, b = P.snapshot.SnapshotStore(host=0, ring=ring), P.snapshot.SnapshotStore(host=1, ring=ring)
    P.snapshot.SnapshotStore.pair(a, b)
    return a, b


def _mgr(P, tmp_path, name="ck", **kw):
    kw.setdefault("backoff_s", 0)
    return P.preemption.CheckpointManager(str(tmp_path / name), **kw)


def _snap(P, step, v=0.0):
    host = P.snapshot.to_host(_state(P, v))
    return P.snapshot.Snapshot(step=step, state=host, rng_seed=7, crcs=P.snapshot.pytree_crc32(host))


def _make_step(P):
    def step(state):
        p = state["p"]
        p = p - 0.1 * (2.0 * p)
        return {"p": p}, P.loss(p)

    return step


def _init_state(P):
    return {"p": P.arange(8)}


# =============================================================================
# SnapshotStore
# =============================================================================


@BOTH
class TestSnapshotStore:
    def test_ring_bound_and_buddy_replication(self, P):
        a, b = _paired_stores(P, ring=2)
        for s in (1, 2, 3):
            assert a.put(_snap(P, s)) is True  # replicated to the buddy
        # Ring keeps the newest 2, newest first; the buddy mirrors them
        # under this host's id.
        assert [s.step for s in a.local_snapshots()] == [3, 2]
        assert [s.step for s in a.peer_snapshots()] == [3, 2]
        assert a.newest_step() == 3
        # An unpaired store still rings locally, just unreplicated.
        lone = P.snapshot.SnapshotStore(host=9, ring=2)
        assert lone.put(_snap(P, 1)) is False
        assert lone.peer_snapshots() == []

    def test_verify_and_copy_on_write_corruption(self, P):
        a, b = _paired_stores(P)
        a.put(_snap(P, 5))
        local, peer = a.local_snapshots()[0], a.peer_snapshots()[0]
        assert local.verify() and peer.verify()
        # Corrupting the local tier must not bleed into the buddy's copy:
        # the replicas share arrays, so the flip is copy-on-write.
        assert a.corrupt_newest("local") is True
        assert not a.local_snapshots()[0].verify()
        assert a.peer_snapshots()[0].verify()
        # Corrupting again targets the newest still-VALID snapshot (an XOR
        # re-flip would silently re-validate the tier) — with only one
        # (already bad) local snapshot there is nothing left to corrupt.
        assert a.corrupt_newest("local") is False
        assert a.corrupt_newest("peer") is True
        assert not a.peer_snapshots()[0].verify()

    def test_corrupt_empty_tier_returns_false(self, P):
        a, _ = _paired_stores(P)
        assert a.corrupt_newest("local") is False
        assert a.corrupt_newest("peer") is False

    def test_drop_local_models_host_loss(self, P):
        a, _ = _paired_stores(P)
        a.put(_snap(P, 4))
        a.drop_local()
        assert a.local_snapshots() == []
        assert [s.step for s in a.peer_snapshots()] == [4]

    def test_crc_skips_non_array_leaves(self, P):
        host = {"p": np.arange(4, dtype=np.float32), "step": 12, "tag": "x"}
        crcs = P.snapshot.pytree_crc32(host)
        assert len(crcs) == 1
        host2 = {"p": np.arange(4, dtype=np.float32), "step": 99, "tag": "y"}
        assert P.snapshot.pytree_crc32(host2) == crcs  # metadata not checksummed


# =============================================================================
# CheckpointManager: snapshot + async flush
# =============================================================================


@BOTH
class TestAsyncCheckpointManager:
    def test_snapshot_event_and_ram_tier(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        with P.events.event_scope(P.events.log_for_path(log)):
            mgr.snapshot(_state(P), 7, rng_seed=11)
        snaps = [r for r in _events(log) if r["kind"] == "snapshot"]
        assert len(snaps) == 1
        assert snaps[0]["step"] == 7 and snaps[0]["replicated"] is True
        assert snaps[0]["stall_ms"] >= 0 and snaps[0]["ring"] == 1
        # Nothing touched disk — the RAM tier alone holds the state.
        assert mgr.latest_complete_step() is None
        snap = a.local_snapshots()[0]
        assert snap.rng_seed == 11 and snap.verify()

    def test_background_flush_commits(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        with P.events.event_scope(P.events.log_for_path(log)):
            mgr.snapshot(_state(P), 4, rng_seed=11, flush=True)
            # Wait for the BACKGROUND commit (close() would otherwise win
            # the race and flush synchronously itself).
            for _ in range(500):
                if mgr.latest_complete_step() == 4:
                    break
                time.sleep(0.01)
            mgr.close()
        assert mgr.latest_complete_step() == 4
        _, meta = mgr.restore()
        assert meta["step"] == 4 and meta["rng_seed"] == 11
        flushes = [r for r in _events(log) if r["kind"] == "snapshot_flush"]
        assert [f["ok"] for f in flushes] == [True]
        assert flushes[0]["sync"] is False
        # The flush also emits the ok checkpoint_save record — the recovery
        # event the ckpt_io/preempt correlation rules key on.
        saves = [r for r in _events(log)
                 if r["kind"] == "checkpoint_save" and r["ok"]]
        assert len(saves) == 1

    def test_single_inflight_latest_wins_coalescing(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr = _mgr(P, tmp_path, async_flush=True)
        with P.events.event_scope(P.events.log_for_path(log)):
            with P.chaos.chaos_scope("snap_slow~0.4"):
                mgr.snapshot(_state(P), 1, flush=True)   # slow flush in flight
                time.sleep(0.05)                        # writer picks it up
                mgr.snapshot(_state(P), 2, flush=True)   # queued
                mgr.snapshot(_state(P), 3, flush=True)   # replaces 2
                mgr.close()
        # Step 2 was coalesced away: the disk saw 1 (slow) then 3.
        assert mgr.steps_on_disk() == [1, 3]
        flushes = {r["step"]: r for r in _events(log)
                   if r["kind"] == "snapshot_flush"}
        assert set(flushes) == {1, 3}
        assert flushes[3].get("coalesced") == 1
        # The slow seam fired and its injection correlates as recovered
        # (the later ok flush) in the replay.
        summary, diags = P.replay(log)
        assert "snap_slow@None" in summary["faults_injected"]
        assert summary["unrecovered_faults"] == []

    def test_sync_save_drains_and_supersedes_pending(self, P, tmp_path):
        mgr = _mgr(P, tmp_path, async_flush=True)
        with P.chaos.chaos_scope("snap_slow~0.4"):
            mgr.snapshot(_state(P), 1, flush=True)
            time.sleep(0.05)
            mgr.snapshot(_state(P), 2, flush=True)  # pending behind the slow one
            # The synchronous save must wait out the in-flight flush and
            # discard the pending older snapshot — it is superseded by this
            # newer durable commit.
            mgr.save(_state(P), 5)
        mgr.close()
        assert mgr.steps_on_disk() == [1, 5]
        assert mgr.latest_complete_step() == 5

    def test_writer_thread_sees_chaos_scope(self, P, tmp_path):
        """Contextvars (chaos scopes, event routing) are copied
        onto the writer per flush — the ckpt_io seam must fire on the
        background path and correlate in the same per-scope log."""
        log = str(tmp_path / "ev.jsonl")
        mgr = _mgr(P, tmp_path, retries=3, async_flush=True)
        with P.events.event_scope(P.events.log_for_path(log)):
            with P.chaos.chaos_scope("ckpt_io*2"):
                mgr.snapshot(_state(P), 1, flush=True)
                mgr.close()
        assert mgr.latest_complete_step() == 1
        saves = [r for r in _events(log) if r["kind"] == "checkpoint_save"]
        assert [s["ok"] for s in saves] == [False, False, True]
        summary, _ = P.replay(log)
        assert summary["kinds"]["fault_injected"] == 2
        assert summary["unrecovered_faults"] == []

    def test_flush_retries_exhausted_reports_not_raises(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr = _mgr(P, tmp_path, retries=1, async_flush=True)
        with P.events.event_scope(P.events.log_for_path(log)):
            with P.chaos.chaos_scope("ckpt_io*inf"):
                mgr.snapshot(_state(P), 1, flush=True)
                mgr.close()  # must not raise out of the writer
        assert mgr.latest_complete_step() is None
        flushes = [r for r in _events(log) if r["kind"] == "snapshot_flush"]
        assert len(flushes) == 1 and flushes[0]["ok"] is False
        assert "retries exhausted" in flushes[0]["reason"]

    def test_torn_flush_restore_skips_and_gc_sweeps(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr = _mgr(P, tmp_path, async_flush=True)
        with P.events.event_scope(P.events.log_for_path(log)):
            mgr.save(_state(P), 10)
            with P.chaos.chaos_scope("snap_torn"):
                mgr.snapshot(_state(P), 20, flush=True)
                mgr.close()
            # The torn step is on disk WITHOUT its commit marker.
            assert mgr.steps_on_disk() == [10, 20]
            assert mgr.latest_complete_step() == 10
            _, meta = mgr.restore()  # newest-first scan skips the torn dir
            assert meta["step"] == 10
            flushes = [r for r in _events(log) if r["kind"] == "snapshot_flush"]
            assert flushes[-1]["ok"] is False and flushes[-1]["reason"] == "torn"
            # A later commit makes the torn dir sweepable debris.
            mgr.save(_state(P), 30)
            assert 20 not in mgr.steps_on_disk()
        summary, _ = P.replay(log)
        assert "snap_torn@None" in summary["faults_injected"]
        assert summary["unrecovered_faults"] == []

    def test_multi_process_flush_stays_synchronous(self, P, tmp_path, monkeypatch):
        """On a real multi-process fleet the background writer is unsafe
        (host-local coalescing would skew the fleet's Orbax barriers; a
        META commit could land before peers finished their shards): the
        flush must fall back to the synchronous save() protocol, commit
        barrier included."""
        monkeypatch.setattr(P.preemption, "_multi_process", lambda: True)
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        mgr.snapshot(_state(P), 4, rng_seed=11, flush=True)
        # Committed on return — no writer thread involved, nothing queued.
        assert mgr.latest_complete_step() == 4
        assert mgr._pending is None and mgr._writer is None

    def test_torn_flush_never_destroys_committed_step(self, P, tmp_path):
        """A real crash between the state write and the META marker leaves
        an existing committed dir at that step intact — the seam must not
        rmtree it (the re-executed-step-re-flushes-after-a-rewind case)."""
        mgr = _mgr(P, tmp_path, async_flush=True)
        mgr.save(_state(P), 20)
        with P.chaos.chaos_scope("snap_torn"):
            mgr._flush_one(_snap(P, 20))
        assert mgr.latest_complete_step() == 20  # committed data survives
        _, meta = mgr.restore()
        assert meta["step"] == 20

    def test_tiered_restore_drains_inflight_flush(self, P, tmp_path):
        """The restore ladder quiesces the background writer before
        reading the directory — it must not race the rmtree/rename/GC of
        an in-flight commit."""
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        with P.chaos.chaos_scope("snap_slow~0.4"):
            mgr.snapshot(_state(P), 6, flush=True)
            time.sleep(0.05)  # the slow flush is now in flight
            _, meta, tier, _ = P.elastic.tiered_restore(mgr)
        assert (tier, meta["step"]) == ("local", 6)
        # drain() ran: the flush finished before the directory was read.
        assert mgr._inflight_step is None
        assert mgr.latest_complete_step() == 6
        mgr.close()

    def test_preempt_during_inflight_flush(self, P, tmp_path):
        """SIGTERM while the writer holds an uncommitted tmp —
        the preemption save must drain the writer and commit, never leave
        debris restore() trips on; the resumed run continues the
        uninterrupted trajectory."""
        ref_mgr = _mgr(P, tmp_path, name="ref")
        _, losses_all = P.preemption.run_training(_make_step(P), _init_state(P), 8,
                                     manager=ref_mgr)
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        # The slow seam holds the step-2 flush's tmp open; preempt@3 then
        # forces the synchronous save while that flush is in flight.
        with P.chaos.chaos_scope("snap_slow~0.6;preempt@3"):
            with pytest.raises(P.preemption.Preempted) as exc_info:
                P.preemption.run_training(_make_step(P), _init_state(P), 8, manager=mgr,
                             save_every=2, snapshot_every=1)
        assert exc_info.value.step == 3
        mgr.close()
        assert mgr.latest_complete_step() == 3
        _, meta = mgr.restore()  # nothing torn/uncommitted trips the scan
        assert meta["step"] == 3
        _, tail = P.preemption.run_training(_make_step(P), _init_state(P), 8, manager=mgr)
        assert tail == losses_all[3:]

    def test_gc_retention_step_keyed_not_mtime(self, P, tmp_path):
        """Out-of-order flush commits must not evict the newest
        STEP — retention keys on the step index, not mtime."""
        mgr = _mgr(P, tmp_path, keep=2, async_flush=True)
        mgr.save(_state(P), 30)
        # An older step commits AFTER step 30 (what a slow background flush
        # looks like): its mtime is newer than step 30's.
        mgr._flush_one(_snap(P, 20))
        assert os.path.getmtime(mgr._step_dir(20)) >= os.path.getmtime(
            mgr._step_dir(30))
        # A third out-of-order commit trips the keep=2 sweep: the smallest
        # STEP goes — an mtime-ordered sweep would have evicted step 30
        # (oldest mtime) and kept the two stale flushes.
        mgr._flush_one(_snap(P, 10))
        assert mgr.steps_on_disk() == [20, 30]
        assert mgr.latest_complete_step() == 30

    def test_quarantine_retention_step_keyed(self, P, tmp_path):
        mgr = _mgr(P, tmp_path, keep=1)
        for step, age in ((10, 0.0), (30, 100.0)):
            d = str(tmp_path / "ck" / f"step_{step:08d}.corrupt")
            os.makedirs(d)
            # Invert mtimes: the OLDER step looks newer on disk.
            t = time.time() - age
            os.utime(d, (t, t))
        mgr.save(_state(P), 40)
        names = sorted(os.listdir(str(tmp_path / "ck")))
        assert "step_00000030.corrupt" in names  # newest STEP survives
        assert "step_00000010.corrupt" not in names


# =============================================================================
# Tiered restore
# =============================================================================


def _make_step(P):
    import jax.numpy as jnp

    def step(state):
        p = state["p"]
        p = p - 0.1 * (2.0 * p)
        return {"p": p}, float(jnp.sum(p * p))

    return step


def _init_state(P):
    import jax.numpy as jnp

    return {"p": jnp.arange(8, dtype=jnp.float32)}


@BOTH
class TestTieredRestore:
    def _mgr_with_tiers(self, P, tmp_path):
        a, b = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        mgr.save(_state(P, 0.0), 5)      # disk: oldest
        mgr.snapshot(_state(P, 1.0), 9)  # RAM: newest, in both local and peer
        return mgr, a

    def test_newest_valid_tier_wins(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr, store = self._mgr_with_tiers(P, tmp_path)
        with P.events.event_scope(P.events.log_for_path(log)):
            _, meta, tier, tried = P.elastic.tiered_restore(mgr)
            assert (tier, meta["step"], tried) == ("local", 9, [])
            # Local RAM gone (host lost it): the buddy replica serves.
            store.drop_local()
            _, meta, tier, _ = P.elastic.tiered_restore(mgr)
            assert (tier, meta["step"]) == ("peer", 9)
            # No RAM at all: disk.
            store.buddy._replicas.clear()
            state, meta, tier, _ = P.elastic.tiered_restore(mgr)
            assert (tier, meta["step"]) == ("disk", 5)
            assert np.allclose(P.asarray(state["p"]),
                               np.arange(6, dtype=np.float32))
        tiers = [(r["tier"], r["step"]) for r in _events(log)
                 if r["kind"] == "restore" and r["ok"]]
        assert tiers == [("local", 9), ("peer", 9), ("disk", 5)]

    def test_checksum_fallthrough_ladder(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr, store = self._mgr_with_tiers(P, tmp_path)
        with P.events.event_scope(P.events.log_for_path(log)):
            with P.chaos.chaos_scope("snap_corrupt@local"):
                _, meta, tier, tried = P.elastic.tiered_restore(mgr)
            assert (tier, meta["step"]) == ("peer", 9)
            assert tried == ["local@9"]
            with P.chaos.chaos_scope("snap_corrupt@local,peer"):
                # local@9 is already bad; this corrupts peer@9 (the newest
                # still-valid RAM entry) — the ladder runs to disk.
                _, meta, tier, tried = P.elastic.tiered_restore(mgr)
            assert (tier, meta["step"]) == ("disk", 5)
            assert tried == ["local@9", "peer@9"]
        summary, _ = P.replay(log)
        assert summary["restore_tiers"] == {"peer": 1, "disk": 1}
        assert summary["restore_fallthroughs"] == 2
        # Both corrupt injections correlate as recovered via the restores.
        assert summary["unrecovered_faults"] == []

    def test_all_tiers_exhausted_raises(self, P, tmp_path):
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        mgr.snapshot(_state(P), 3)  # RAM only, then corrupted everywhere
        a.corrupt_newest("local")
        a.corrupt_newest("peer")
        with pytest.raises(P.preemption.CheckpointRestoreError):
            P.elastic.tiered_restore(mgr)
        # elastic_resume keeps the pre-tier fresh-start semantics: invalid
        # RAM counts as absent when disk never had a complete step.
        state, start = P.elastic.elastic_resume(mgr, _state(P, 9.0))
        assert start == 0
        assert np.allclose(P.asarray(state["p"]),
                           np.arange(6, dtype=np.float32) + 9.0)
        # ...but a COMPLETE disk step that fails to load still raises:
        # corruption of real durable state must stay loud.
        mgr.save(_state(P), 5)
        import shutil

        for name in os.listdir(mgr._step_dir(5)):
            if name != mgr.META:
                p = os.path.join(mgr._step_dir(5), name)
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        with pytest.raises(P.preemption.CheckpointRestoreError):
            P.elastic.elastic_resume(mgr, _state(P))

    def test_elastic_resume_names_tier(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr, _ = self._mgr_with_tiers(P, tmp_path)
        with P.events.event_scope(P.events.log_for_path(log)):
            state, start = P.elastic.elastic_resume(mgr, _state(P))
        assert start == 9
        ev = [r for r in _events(log) if r["kind"] == "elastic_resume"]
        assert len(ev) == 1 and ev[0]["tier"] == "local"
        # The schema now REQUIRES the tier on every elastic_resume.
        summary, diags = P.replay(log)
        assert not [d for d in diags if d.severity >= Severity.ERROR]

    def test_elastic_resume_fresh_start_no_tiers(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        with P.events.event_scope(P.events.log_for_path(log)):
            state, start = P.elastic.elastic_resume(mgr, _state(P))
        assert start == 0
        assert not os.path.exists(log) or not [
            r for r in _events(log) if r["kind"] in ("restore", "elastic_resume")]

    def test_ram_restore_continues_trajectory(self, P, tmp_path):
        """A RAM-tier resume reproduces the uninterrupted loss trajectory —
        the invariant the disk tier holds, one tier up."""
        ref = _mgr(P, tmp_path, name="ref")
        _, losses_all = P.preemption.run_training(_make_step(P), _init_state(P), 8,
                                     manager=ref)
        a, _ = _paired_stores(P)
        mgr = _mgr(P, tmp_path, store=a, async_flush=True)
        # "Crash" after 5 steps; snapshots every step, disk every 4.
        P.preemption.run_training(_make_step(P), _init_state(P), 5, manager=mgr,
                     save_every=4, snapshot_every=1)
        mgr.close()
        state, start = P.elastic.elastic_resume(mgr, _init_state(P))
        assert start == 4  # newest snapshot (done < n_steps cadence)
        if P is JAX:
            import jax

            state = jax.tree_util.tree_map(lambda x: jax.numpy.asarray(x), state)
        _, tail = P.preemption.run_training(_make_step(P), state, 8, manager=mgr,
                               start_step=start)
        assert tail == losses_all[4:]


# =============================================================================
# Replay correlation for the new seams/events
# =============================================================================


def _rec(kind, seq, **fields):
    return {"v": 1, "ts": float(seq), "seq": seq, "kind": kind, **fields}


@BOTH
class TestReplayContracts:
    def _write(self, tmp_path, records):
        p = str(tmp_path / "log.jsonl")
        with open(p, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        return p

    def test_snap_torn_unrecovered_flags(self, P, tmp_path):
        p = self._write(tmp_path, [
            _rec("fault_injected", 1, seam="snap_torn", target=None, n=1),
            _rec("snapshot_flush", 2, step=4, ok=False, reason="torn"),
        ])
        summary, diags = P.replay(p)
        assert summary["unrecovered_faults"] == ["snap_torn@None"]
        # A later ok flush recovers it; a failed one must not.
        p = self._write(tmp_path, [
            _rec("fault_injected", 1, seam="snap_torn", target=None, n=1),
            _rec("snapshot_flush", 2, step=4, ok=False, reason="torn"),
            _rec("snapshot_flush", 3, step=6, ok=True),
        ])
        summary, _ = P.replay(p)
        assert summary["unrecovered_faults"] == []

    def test_snap_corrupt_recovered_by_restore_only(self, P, tmp_path):
        p = self._write(tmp_path, [
            _rec("fault_injected", 1, seam="snap_corrupt", target="local", n=1),
            _rec("restore", 2, step=4, tier="local", ok=False),
            _rec("snapshot_flush", 3, step=6, ok=True),
        ])
        summary, _ = P.replay(p)
        assert summary["unrecovered_faults"] == ["snap_corrupt@local"]
        p = self._write(tmp_path, [
            _rec("fault_injected", 1, seam="snap_corrupt", target="local", n=1),
            _rec("restore", 2, step=4, tier="local", ok=False),
            _rec("restore", 3, step=4, tier="peer", ok=True,
                 tried=["local@4"]),
        ])
        summary, _ = P.replay(p)
        assert summary["unrecovered_faults"] == []
        assert summary["restore_tiers"] == {"peer": 1}
        assert summary["restore_fallthroughs"] == 1

    def test_elastic_resume_requires_tier(self, P, tmp_path):
        p = self._write(tmp_path, [
            _rec("elastic_resume", 1, step=4, from_mesh=None, to_mesh=None,
                 resharded=False),
        ])
        _, diags = P.replay(p)
        missing = [d for d in diags if d.rule == "events.missing-fields"]
        assert missing and "tier" in missing[0].message

    def test_snapshot_stall_aggregation(self, P, tmp_path):
        p = self._write(tmp_path, [
            _rec("snapshot", 1, step=2, stall_ms=1.5),
            _rec("snapshot", 2, step=4, stall_ms=2.5),
        ])
        summary, _ = P.replay(p)
        assert summary["snapshots"] == 2
        assert summary["snapshot_stall_ms_total"] == 4.0


# =============================================================================
# One checksum for both packages
# =============================================================================


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_pytree_crc32_equal_across_packages(dtype):
    """The same bytes give the same crc: a float32, int32 or bfloat16 leaf
    made from one numpy seed, as the JAX package's host array and as the
    port's CPU tensor."""
    import jax.numpy as jnp

    vals = np.random.RandomState(0).randn(3, 5).astype(np.float32) * 100
    if dtype == "int32":
        vals = vals.astype(np.int32)
    jleaf = jnp.asarray(vals, dtype=getattr(jnp, dtype))
    tleaf = torch.from_numpy(vals).to(getattr(torch, dtype))
    jhost = jsnapshot.to_host({"w": jleaf, "step": 4})
    thost = tsnapshot.to_host({"w": tleaf, "step": 4})
    assert np.asarray(jhost["w"]).tobytes() == (thost["w"].view(torch.int16) if dtype == "bfloat16"
                                                else thost["w"]).numpy().tobytes()
    assert jsnapshot.pytree_crc32(jhost) == tsnapshot.pytree_crc32(thost)
    assert len(tsnapshot.pytree_crc32(thost)) == 1
