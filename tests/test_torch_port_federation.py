"""Slice-granular failure domains through both packages, in one process.

The one-process cases of ``tests/test_federation.py``, written once over a
namespace ``P`` and run through the JAX package and the port
(``thunder_tpu_torch/resilience/federation.py``): the cost cases of
``TestHierAllReduceLowering`` (the port's traced through its ``torch``
executor), the chaos slice seams, the snapshot ring and the tmp sweep, the
ledger and the controller, the cross-slice spread detector, the federation
replay, and ``TestFederatedDriver``'s 5 cases. The port's driver runs on a
mesh of one rank, where the JAX test's runs over 2·w virtual devices: its
``_toy_step`` runs no collective, so nothing else changes.
``TestFederatedMesh`` and ``test_hier_numerics_match_flat`` need ranks:
``tests/test_torch_port_fleet_ranks.py`` holds them.

Across the packages, on the same inputs: the chaos slice seams fire equal
sequences, draw for draw; and each driver scenario, under a clock that
advances with the steps (so the rejoin hysteresis clears at the same step
in both), gives equal reports (``shrinks``, ``regrows``,
``degraded_steps``, ``partitioned_steps``, final width), decision lists,
ledger edges and restore tiers, and losses within 1e-6.
"""

import json
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu.monitor as jmonitor
from thunder_tpu.analysis.events import replay_events as jreplay
from thunder_tpu.observability import detect as jdetect
from thunder_tpu.resilience import autopilot as jap
from thunder_tpu.resilience import chaos as jchaos
from thunder_tpu.resilience import federation as jfed
from thunder_tpu.resilience import preemption as jpreemption
from thunder_tpu.resilience import snapshot as jsnapshot

import thunder_tpu_torch.monitor as tmonitor
from thunder_tpu_torch.analysis.events import replay_events as treplay
from thunder_tpu_torch.observability import detect as tdetect
from thunder_tpu_torch.resilience import autopilot as tap
from thunder_tpu_torch.resilience import chaos as tchaos
from thunder_tpu_torch.resilience import federation as tfed
from thunder_tpu_torch.resilience import preemption as tpreemption
from thunder_tpu_torch.resilience import snapshot as tsnapshot


def _jax_mesh(width: int):
    from jax.sharding import PartitionSpec

    from thunder_tpu.parallel import make_mesh

    return make_mesh(dp=2 * width), {"w": PartitionSpec()}


def _port_mesh(width: int):
    from thunder_tpu_torch.distributed.runtime import P as Spec
    from thunder_tpu_torch.parallel import make_mesh

    return make_mesh(dp=1), {"w": Spec()}


def _jax_toy_step(mesh, width, accum):
    import jax.numpy as jnp

    def step_fn(state):
        w = state["w"]
        return {"w": w - 0.01 * w}, float(np.asarray(jnp.sum(w * w)))

    return step_fn


def _port_toy_step(mesh, width, accum):
    def step_fn(state):
        w = state["w"]
        return {"w": w - 0.01 * w}, float(torch.sum(w * w))

    return step_fn


def _jax_ones():
    import jax.numpy as jnp

    return jnp.ones((8,), jnp.float32)


JAX = SimpleNamespace(name="jax", ap=jap, chaos=jchaos, fed=jfed, preemption=jpreemption, snapshot=jsnapshot,
                      detect=jdetect, monitor=jmonitor, replay=jreplay, array=lambda a: a, mesh_for_width=_jax_mesh,
                      toy_step=_jax_toy_step, ones=_jax_ones)
PORT = SimpleNamespace(name="port", ap=tap, chaos=tchaos, fed=tfed, preemption=tpreemption, snapshot=tsnapshot,
                       detect=tdetect, monitor=tmonitor, replay=treplay, array=torch.from_numpy,
                       mesh_for_width=_port_mesh, toy_step=_port_toy_step, ones=lambda: torch.ones(8))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.delenv("THUNDER_TPU_CHAOS", raising=False)
    monkeypatch.delenv("THUNDER_TPU_SLICE_ID", raising=False)
    for P in (JAX, PORT):
        P.chaos.reset_env_config()
        P.ap.install(None)
        P.fed.install_ledger(None)
    yield
    for P in (JAX, PORT):
        P.monitor.set_event_log(None)
        P.ap.install(None)
        P.fed.install_ledger(None)
        P.chaos.reset_env_config()


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# =============================================================================
# Hierarchical lowering and the DCN cost class
# =============================================================================


def _trace_cost(P, fn):
    x = np.zeros((8, 8), np.float32)
    if P is JAX:
        from thunder_tpu.analysis.cost import trace_cost
        from thunder_tpu.api import trace_program
        from thunder_tpu.executors.passes import transform_for_execution
        from thunder_tpu.extend import resolve_executors
        from thunder_tpu.transforms.common import cse, dce

        _, comp = trace_program(fn, (x,), {})
        return trace_cost(transform_for_execution(cse(dce(comp)), resolve_executors(["jax"])), "v5e")
    from thunder_tpu_torch.analysis.cost import cost_report

    return cost_report(fn, torch.from_numpy(x), executors=["torch"], device="cpu")


def _dist(P):
    if P is JAX:
        from thunder_tpu.distributed import prims
    else:
        from thunder_tpu_torch.distributed import prims
    return prims


class TestHierAllReduceLowering:
    @BOTH
    def test_hier_wire_cost_golden(self, P):
        """8x8 f32 (256 B), in-slice group 4, 2 slices: reduce-scatter and
        all-gather move 2*(3/4)*256 = 384 B in the slice; the cross-slice
        all-reduce of the 1/4 shard moves 2*(1/2)*64 = 64 B on DCN: 448."""
        dp = _dist(P)
        tc = _trace_cost(P, lambda a: dp.hier_all_reduce(a, "dp", "dcn", 4, 2))
        assert tc.total_comm_bytes == 448.0
        assert tc.total_dcn_bytes == 64.0

    @BOTH
    def test_flat_all_reduce_on_dcn_axis_prices_dcn(self, P):
        dp = _dist(P)
        tc = _trace_cost(P, lambda a: dp.all_reduce(a, "dcn", 2))
        assert tc.total_dcn_bytes == tc.total_comm_bytes > 0

    @BOTH
    def test_ici_collective_has_zero_dcn_bytes(self, P):
        dp = _dist(P)
        tc = _trace_cost(P, lambda a: dp.all_reduce(a, "dp", 4))
        assert tc.total_comm_bytes > 0
        assert tc.total_dcn_bytes == 0.0

    @BOTH
    def test_dcn_bytes_slower_than_ici(self, P):
        """Same bytes cost more wall time on the slower tier: comm_s prices
        the two bandwidth classes apart (the port's cpu spec carries one;
        its h100 spec prices the one card's links alike)."""
        if P is JAX:
            from thunder_tpu.analysis.cost import DEVICE_SPECS, TraceCost

            dev = DEVICE_SPECS["v5e"]
        else:
            from thunder_tpu_torch.analysis.cost import DEVICE_SPECS, TraceCost

            dev = DEVICE_SPECS["cpu"]
        assert dev.dcn_bw_or_ici < dev.ici_bw
        ici = TraceCost(device=dev, total_comm_bytes=1e9, total_dcn_bytes=0.0)
        dcn = TraceCost(device=dev, total_comm_bytes=1e9, total_dcn_bytes=1e9)
        assert dcn.comm_s > ici.comm_s


# =============================================================================
# Chaos: slice seams and the per-(slice, host) seed
# =============================================================================


class TestChaosSliceSeams:
    @BOTH
    def test_parse_slice_clause(self, P):
        rules = P.chaos.parse_spec("slice_loss@3,slice=1").rules
        assert rules[0].seam == "slice_loss"
        assert rules[0].target == "3" and rules[0].slice == 1

    @BOTH
    def test_slice_loss_fires_exactly_at_step(self, P):
        with P.chaos.chaos_scope("slice_loss@3,slice=1;seed=5"):
            assert P.chaos.slice_loss_at_step(2) is None
            assert P.chaos.slice_loss_at_step(3) == 1
            assert P.chaos.slice_loss_at_step(3) is None  # count exhausted
            assert P.chaos.slice_loss_at_step(4) is None

    @BOTH
    def test_slice_flap_default_slice_zero(self, P):
        with P.chaos.chaos_scope("slice_flap@2;seed=5"):
            assert P.chaos.slice_flap_at_step(2) == 0

    @BOTH
    def test_dcn_partition_carries_heal_delay(self, P):
        with P.chaos.chaos_scope("dcn_partition@4~3.0;seed=5"):
            assert P.chaos.dcn_partition_at_step(3) is None
            rule = P.chaos.dcn_partition_at_step(4)
            assert rule is not None and rule.delay_s == 3.0

    @BOTH
    def test_slice_slow_targets_one_slice(self, P):
        with P.chaos.chaos_scope("slice_slow@slice=1~0.25;seed=5"):
            assert P.chaos.slice_slow_delay(0) == 0.0
            assert P.chaos.slice_slow_delay(1) == 0.25

    @BOTH
    def test_seam_fires_emit_fault_events(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        P.monitor.set_event_log(log)
        try:
            with P.chaos.chaos_scope("slice_loss@1,slice=1;seed=5"):
                P.chaos.slice_loss_at_step(1)
        finally:
            P.monitor.set_event_log(None)
        rec = next(r for r in _events(log) if r["kind"] == "fault_injected")
        assert rec["seam"] == "slice_loss"
        assert rec["target"] == "step1:slice1"

    @BOTH
    def test_seed_derivation_is_stable_and_distinct(self, P):
        a = P.chaos._derive_seed(7, 0, 0)
        assert a == P.chaos._derive_seed(7, 0, 0)  # replayable across runs
        assert len({P.chaos._derive_seed(7, s, h) for s in range(4) for h in range(4)}) == 16

    @BOTH
    def test_rng_keyed_by_slice_env(self, P, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_SLICE_ID", "0")
        r0 = P.chaos.parse_spec("kernel_raise%0.5;seed=11").rng.random()
        monkeypatch.setenv("THUNDER_TPU_SLICE_ID", "1")
        r1 = P.chaos.parse_spec("kernel_raise%0.5;seed=11").rng.random()
        assert r0 != r1

    @BOTH
    def test_slice_id_default_zero(self, P, monkeypatch):
        monkeypatch.delenv("THUNDER_TPU_SLICE_ID", raising=False)
        assert P.chaos.slice_id() == 0


def _fire_sequence(P, spec: str, steps: int = 40) -> list:
    out = []
    with P.chaos.chaos_scope(spec):
        for step in range(steps):
            rule = P.chaos.dcn_partition_at_step(step)
            out.append((P.chaos.slice_loss_at_step(step), P.chaos.slice_flap_at_step(step),
                        None if rule is None else rule.delay_s, P.chaos.slice_slow_delay(step % 3)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_seams_fire_alike_draw_for_draw(seed):
    """Probabilistic slice seams from one seed: both packages fire on the
    same steps with the same victims."""
    spec = f"slice_loss@slice=1%0.3*inf;slice_flap@slice=0%0.2*inf;dcn_partition%0.25*inf~2.0;" \
           f"slice_slow@slice=2%0.5*inf~0.1;seed={seed}"
    want = _fire_sequence(JAX, spec)
    assert _fire_sequence(PORT, spec) == want
    assert any(x[0] is not None for x in want) and any(x[2] is not None for x in want)


# =============================================================================
# Snapshot ring: cross-slice buddy replication and DCN partition
# =============================================================================


def _stores(P, n=2):
    stores = [P.snapshot.SnapshotStore(host=i, ring=4) for i in range(n)]
    P.snapshot.SnapshotStore.make_ring(stores)
    return stores


def _put(P, store, step):
    state = {"w": P.array(np.full(4, float(step), np.float32))}
    snap = P.snapshot.Snapshot(step=step, state=state, crcs=P.snapshot.pytree_crc32(state))
    store.put(snap)
    return snap


class TestSnapshotRing:
    @BOTH
    def test_ring_buddy_wiring(self, P):
        s = _stores(P, 3)
        assert s[0].buddy is s[1] and s[1].buddy is s[2]
        assert s[2].buddy is s[0]

    @BOTH
    def test_ring_needs_two(self, P):
        with pytest.raises(ValueError):
            P.snapshot.SnapshotStore.make_ring([P.snapshot.SnapshotStore(host=0)])

    @BOTH
    def test_put_replicates_to_buddy(self, P):
        s0, s1 = _stores(P)
        _put(P, s0, 3)
        assert [p.step for p in s0.peer_snapshots()] == [3]

    @BOTH
    def test_partition_severs_replication_both_ways(self, P):
        s0, s1 = _stores(P)
        _put(P, s0, 1)
        s1.partitioned = True
        _put(P, s0, 2)  # buddy partitioned: not replicated
        assert [p.step for p in s0.peer_snapshots()] == []  # reads severed too
        s1.partitioned = False
        _put(P, s0, 3)  # healed: replication resumes
        assert sorted(p.step for p in s0.peer_snapshots()) == [1, 3]

    @BOTH
    def test_local_partition_severs_own_put(self, P):
        s0, s1 = _stores(P)
        s0.partitioned = True
        _put(P, s0, 1)
        s0.partitioned = False
        assert [p.step for p in s0.peer_snapshots()] == []


# =============================================================================
# The orphan-tmp sweep on restore
# =============================================================================


class TestTmpSweep:
    @BOTH
    def test_restore_sweeps_stale_tmps(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"))
        mgr.save({"w": P.array(np.ones(4, np.float32))}, 5)
        stale = os.path.join(mgr.directory, "step_3.tmp")
        os.makedirs(stale)
        with open(os.path.join(stale, "junk"), "w") as f:
            f.write("torn")
        P.monitor.set_event_log(log)
        try:
            state, meta = mgr.restore()
        finally:
            P.monitor.set_event_log(None)
        assert meta["step"] == 5
        assert not os.path.exists(stale)
        rec = next(r for r in _events(log) if r["kind"] == "ckpt_tmp_sweep")
        assert rec["count"] == 1 and rec["steps"] == [3]

    @BOTH
    def test_restore_no_tmps_no_event(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"))
        mgr.save({"w": P.array(np.ones(4, np.float32))}, 5)
        P.monitor.set_event_log(log)
        try:
            mgr.restore()
        finally:
            P.monitor.set_event_log(None)
        assert not any(r["kind"] == "ckpt_tmp_sweep" for r in _events(log))


# =============================================================================
# The ledger and the controller's state machine (fake clock: no sleeps)
# =============================================================================


class TestFederationLedger:
    @BOTH
    def test_initial_state(self, P):
        led = P.fed.FederationLedger(3)
        assert led.width() == 3
        assert led.active_slices() == [0, 1, 2]

    @BOTH
    def test_legal_cycle(self, P):
        led = P.fed.FederationLedger(2)
        led.mark_lost(1)
        assert led.state_of(1) == "lost" and led.width() == 1
        led.mark_cooldown(1)
        led.promote(1)
        assert led.width() == 2
        assert [(s, f, t) for s, f, t, _ in led.transitions] == [
            (1, "active", "lost"), (1, "lost", "cooldown"), (1, "cooldown", "active")]

    @BOTH
    def test_illegal_edges_raise(self, P):
        led = P.fed.FederationLedger(2)
        with pytest.raises(ValueError):
            led.promote(1)  # active -> active
        led.mark_lost(1)
        with pytest.raises(ValueError):
            led.promote(1)  # lost -> active skips cooldown

    @BOTH
    def test_transitions_emit_slice_state_events(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        P.monitor.set_event_log(log)
        try:
            P.fed.FederationLedger(2).mark_lost(1, reason="chaos")
        finally:
            P.monitor.set_event_log(None)
        rec = next(r for r in _events(log) if r["kind"] == "slice_state")
        assert rec["slice"] == 1 and rec["from"] == "active"
        assert rec["to"] == "lost" and rec["reason"] == "chaos"

    @BOTH
    def test_debug_state_shape(self, P):
        led = P.fed.FederationLedger(2)
        led.mark_lost(0)
        st = led.debug_state()
        assert st["n_slices"] == 2 and st["width"] == 1
        assert st["slices"][0]["state"] == "lost"
        assert st["transitions"][-1]["to"] == "lost"


def _controller(P, n=2, backoff=10.0, hysteresis=10.0):
    t = [0.0]
    led = P.fed.FederationLedger(n, clock=lambda: t[0])
    fc = P.fed.FleetController(led, P.ap.Autopilot(), rejoin_backoff_s=backoff, hysteresis_s=hysteresis,
                               clock=lambda: t[0])
    return fc, led, t


class TestFleetController:
    @BOTH
    def test_loss_decides_shrink(self, P):
        fc, led, _ = _controller(P)
        d = fc.on_slice_loss(1, step=3)
        assert d is not None and d.actuator == "shrink_dp"
        assert led.state_of(1) == "lost"

    @BOTH
    def test_duplicate_loss_is_noop(self, P):
        fc, _, _ = _controller(P)
        assert fc.on_slice_loss(1) is not None
        assert fc.on_slice_loss(1) is None

    @BOTH
    def test_backoff_holds_slice_out_until_hysteresis_clears(self, P):
        """A recovered slice stays in cooldown until max(rejoin_backoff,
        hysteresis) of STABLE time has passed; a re-failure inside the window
        restarts it and costs no second shrink."""
        fc, led, t = _controller(P, backoff=5.0, hysteresis=8.0)
        fc.on_slice_loss(1, step=1)
        t[0] = 10.0
        fc.on_slice_recovered(1, step=2)
        assert led.state_of(1) == "cooldown"
        t[0] = 12.0
        assert fc.poll(step=3) is None        # 2s stable < 8s window
        t[0] = 17.0
        assert fc.poll(step=4) is None        # 7s stable: backoff cleared, hysteresis not yet
        assert fc.on_slice_loss(1, step=5) is None  # re-failure: no second shrink
        t[0] = 20.0
        fc.on_slice_recovered(1, step=6)
        t[0] = 27.0
        assert fc.poll(step=7) is None        # only 7s since the re-recovery
        t[0] = 28.5
        d = fc.poll(step=8)
        assert d is not None and d.actuator == "regrow_dp"
        assert led.state_of(1) == "active"

    @BOTH
    def test_poll_promotes_one_slice_at_a_time(self, P):
        fc, led, t = _controller(P, n=3, backoff=1.0, hysteresis=1.0)
        fc.on_slice_loss(1)
        fc.on_slice_loss(2)
        t[0] = 5.0
        fc.on_slice_recovered(1)
        fc.on_slice_recovered(2)
        t[0] = 10.0
        assert fc.poll() is not None
        assert led.width() == 2
        assert fc.poll() is not None
        assert led.width() == 3
        assert fc.poll() is None

    @BOTH
    def test_grad_accum_rescales_loss_equivalently(self, P):
        fc, led, _ = _controller(P, n=4)
        assert fc.grad_accum_for(2) == 2     # full width: unchanged
        fc.on_slice_loss(3)
        assert fc.grad_accum_for(2) == 3     # ceil(2*4/3)
        fc.on_slice_loss(2)
        assert fc.grad_accum_for(2) == 4     # 2*4/2
        fc.on_slice_loss(1)
        assert fc.grad_accum_for(2) == 8     # 2*4/1

    @BOTH
    def test_all_slices_lost_halts(self, P):
        fc, _, _ = _controller(P)
        fc.on_slice_loss(0)
        fc.on_slice_loss(1)
        with pytest.raises(P.ap.AutopilotHalt):
            fc.grad_accum_for(1)

    @BOTH
    def test_controller_installs_ledger_for_ops_plane(self, P):
        try:
            fc, led, _ = _controller(P)
            assert P.fed.current_ledger() is led
        finally:
            P.fed.install_ledger(None)


# =============================================================================
# The cross-slice spread detector and the autopilot's strike ledger
# =============================================================================


def _bank(P):
    return P.detect.DetectorBank(P.detect.DetectorConfig(spread_min_steps=2, spread_consecutive=2))


class TestSliceSpreadDetector:
    @BOTH
    def test_slow_slice_flagged(self, P):
        bank = _bank(P)
        for _ in range(8):
            bank.note_slice_step(0, 0.10)
            bank.note_slice_step(1, 0.30)
        hits = [a for a in bank.anomalies if a.kind == "slice_spread"]
        assert hits and hits[0].suspect_host == "slice1"
        assert bank.slice_spread_state()["slow_slices"] == [1]

    @BOTH
    def test_even_fleet_quiet(self, P):
        bank = _bank(P)
        for _ in range(8):
            bank.note_slice_step(0, 0.10)
            bank.note_slice_step(1, 0.11)
        assert not [a for a in bank.anomalies if a.kind == "slice_spread"]

    @BOTH
    def test_anomaly_strikes_autopilot_ledger(self, P):
        ap = P.ap.Autopilot()
        bank = _bank(P)
        with ap.installed():
            for _ in range(16):
                bank.note_slice_step(0, 0.10)
                bank.note_slice_step(1, 0.30)
        assert any(h == "slice1" for h in ap._anomaly_strikes)

    @BOTH
    def test_slice_loss_signal_cites_slice_spread(self, P):
        ap = P.ap.Autopilot()
        ap.note_anomaly({"anomaly": "slice_spread", "severity": "warn", "value": 2.0, "baseline": 1.3,
                         "suspect_host": "slice1"})
        d = ap.decide(P.ap.Signal("slice_loss", step=3, suspect_host="slice1"))
        assert d.actuator == "shrink_dp"
        assert d.signal.evidence.get("anomaly", {}).get("anomaly") == "slice_spread"


# =============================================================================
# The decision replay: shrink_dp / regrow_dp correlation rules
# =============================================================================


def _replay(P, recs, **kw):
    path = os.path.join(tempfile.mkdtemp(), "log.jsonl")
    with open(path, "w") as f:
        for i, r in enumerate(recs):
            base = {"v": 1, "ts": float(i), "seq": i, "pid": 1, "host": 0}
            base.update(r)
            f.write(json.dumps(base) + "\n")
    return P.replay(path, **kw)


def _decision(actuator, signal="slice_loss"):
    return {"kind": "autopilot_decision", "decision_id": 1, "signal": signal, "actuator": actuator}


_RESUME = {"kind": "elastic_resume", "step": 3, "from_mesh": {"dp": 4}, "to_mesh": {"dp": 2}, "resharded": True,
           "tier": "peer"}
_SLICE_STATE = {"kind": "slice_state", "slice": 1, "from": "active", "to": "lost", "reason": "slice_loss"}


class TestFederationReplay:
    @BOTH
    def test_new_kinds_validate(self, P):
        _, diags = _replay(P, [_SLICE_STATE, {"kind": "ckpt_tmp_sweep", "count": 2, "steps": [1, 2]}])
        assert not diags

    @BOTH
    def test_shrink_dp_requires_elastic_resume(self, P):
        summary, _ = _replay(P, [_decision("shrink_dp")])
        assert summary["unactuated_decisions"] == ["shrink_dp<-slice_loss"]
        summary, _ = _replay(P, [_decision("shrink_dp"), _RESUME])
        assert summary["unactuated_decisions"] == []

    @BOTH
    def test_regrow_dp_requires_elastic_resume(self, P):
        summary, _ = _replay(P, [_decision("regrow_dp", "slice_recovered")])
        assert summary["unactuated_decisions"] == ["regrow_dp<-slice_recovered"]
        summary, _ = _replay(P, [_decision("regrow_dp", "slice_recovered"), _RESUME])
        assert summary["unactuated_decisions"] == []

    @BOTH
    def test_slice_loss_fault_requires_resume(self, P):
        fault = {"kind": "fault_injected", "seam": "slice_loss", "target": "step3:slice1", "n": 1}
        summary, _ = _replay(P, [fault])
        assert summary["unrecovered_faults"] == ["slice_loss@step3:slice1"]
        summary, _ = _replay(P, [fault, _RESUME])
        assert summary["unrecovered_faults"] == []

    @BOTH
    def test_slice_flap_recovered_by_slice_state(self, P):
        fault = {"kind": "fault_injected", "seam": "slice_flap", "target": "step3:slice1", "n": 1}
        summary, _ = _replay(P, [fault])
        assert summary["unrecovered_faults"] == ["slice_flap@step3:slice1"]
        summary, _ = _replay(P, [fault, _SLICE_STATE])
        assert summary["unrecovered_faults"] == []


# =============================================================================
# The federated driver end to end (2 emulated slices)
# =============================================================================


N_SLICES = 2


def _run(P, tmp_path, spec, n=20, name="ck", clock=None, **kw):
    """``run_federated_training`` of the toy step under ``spec``. With
    ``clock`` (a one-item list the steps advance) the controller's
    hysteresis runs on it instead of the wall clock."""
    if clock is not None:
        led = P.fed.FederationLedger(N_SLICES, clock=lambda: clock[0])
        fc = P.fed.FleetController(led, P.ap.Autopilot(), rejoin_backoff_s=0.02, hysteresis_s=0.02,
                                   clock=lambda: clock[0])

        def tick(step, loss, width):
            clock[0] += 0.01
        kw.setdefault("on_step", tick)
    else:
        led = P.fed.FederationLedger(N_SLICES)
        fc = P.fed.FleetController(led, P.ap.Autopilot(), rejoin_backoff_s=0.02, hysteresis_s=0.02)
        kw.setdefault("on_step", lambda step, loss, width: __import__("time").sleep(0.004))
    stores = [P.snapshot.SnapshotStore(host=i, ring=4) for i in range(N_SLICES)]
    P.snapshot.SnapshotStore.make_ring(stores)
    mgr = P.preemption.CheckpointManager(str(tmp_path / f"{P.name}-{name}"), store=stores[0])
    try:
        with P.chaos.chaos_scope(spec):
            state, report = P.fed.run_federated_training(
                fc, P.toy_step, {"w": P.ones()}, n, manager=mgr, mesh_for_width=P.mesh_for_width, stores=stores,
                snapshot_every=2, **kw)
    finally:
        P.fed.install_ledger(None)
    return state, report, led, fc.autopilot


def _logged_run(P, tmp_path, spec, **kw):
    log = str(tmp_path / f"{P.name}-ev.jsonl")
    P.monitor.set_event_log(log)
    try:
        _, report, led, ap = _run(P, tmp_path, spec, **kw)
    finally:
        P.monitor.set_event_log(None)
    return report, led, ap, _events(log), log


class TestFederatedDriver:
    @BOTH
    def test_slice_loss_shrinks_then_regrows(self, P, tmp_path):
        report, _, _, recs, log = _logged_run(P, tmp_path, "slice_loss@6,slice=1;seed=3", recover_after=4)
        assert report.halted is None
        assert report.shrinks == 1 and report.regrows == 1
        assert report.degraded_steps > 0
        assert report.final_width == report.full_width == 2
        assert report.steps_executed == 20
        # The slice-loss restore came from the cross-slice buddy's RAM:
        # tier="peer", disk never touched after the initial anchor resume.
        tiers = [r["tier"] for r in recs if r["kind"] == "restore" and r.get("ok")]
        assert tiers.count("peer") == 1
        assert "disk" not in tiers[1:]
        assert [r["actuator"] for r in recs if r["kind"] == "autopilot_decision"] == ["shrink_dp", "regrow_dp"]
        summary, _ = P.replay(log, storm_threshold=64)
        assert summary["unrecovered_faults"] == []
        assert summary["unactuated_decisions"] == []

    @BOTH
    def test_flap_degrades_once(self, P, tmp_path):
        """Fail/recover/fail/recover faster than the hysteresis window costs
        ONE shrink and ONE (deferred) regrow, on the replayed ledger."""
        report, _, _, recs, log = _logged_run(P, tmp_path, "slice_flap@4,slice=1;seed=3")
        assert report.halted is None
        assert report.shrinks == 1 and report.regrows == 1
        assert [r["actuator"] for r in recs if r["kind"] == "autopilot_decision"] == ["shrink_dp", "regrow_dp"]
        assert ("cooldown", "lost") in [(r["from"], r["to"]) for r in recs if r["kind"] == "slice_state"]
        summary, _ = P.replay(log, storm_threshold=64)
        assert summary["unrecovered_faults"] == []
        assert summary["unactuated_decisions"] == []

    @BOTH
    def test_dcn_partition_defers_replication(self, P, tmp_path):
        _, report, _, _ = _run(P, tmp_path, "dcn_partition@4~3.0;seed=3", n=14)
        assert report.halted is None
        assert report.partitioned_steps > 0
        assert report.shrinks == 0  # training continued in-slice

    @BOTH
    def test_slow_slice_inflates_degraded_signal(self, P, tmp_path):
        bank = _bank(P)
        _, report, _, _ = _run(P, tmp_path, "slice_slow@slice=1~0.05;seed=3", n=10,
                               slice_step_time=bank.note_slice_step)
        assert report.halted is None and report.shrinks == 0
        hits = [a for a in bank.anomalies if a.kind == "slice_spread"]
        assert hits and hits[0].suspect_host == "slice1"

    @BOTH
    def test_losses_stay_finite_through_episode(self, P, tmp_path):
        _, report, _, _ = _run(P, tmp_path, "slice_loss@6,slice=1;seed=3", recover_after=4)
        assert all(np.isfinite(loss) for loss in report.losses)


def _scenario(P, tmp_path, spec, kw):
    clock = [0.0]
    report, led, ap, recs, _ = _logged_run(P, tmp_path, spec, clock=clock, **kw)
    return {
        "report": (report.shrinks, report.regrows, report.degraded_steps, report.partitioned_steps,
                   report.full_width, report.final_width, report.steps_executed, report.halted is None),
        "decisions": [(d.signal.kind, d.actuator, d.mode, d.rung, d.signal.suspect_host) for d in ap.decisions],
        "edges": [(s, f, t, r) for s, f, t, r in led.transitions],
        "tiers": [(r["tier"], r["step"]) for r in recs if r["kind"] == "restore" and r.get("ok")],
        "losses": report.losses,
    }


@pytest.mark.parametrize("spec,kw", [
    ("slice_loss@6,slice=1;seed=3", {"recover_after": 4}),
    ("slice_flap@4,slice=1;seed=3", {}),
    ("dcn_partition@4~3.0;seed=3", {"n": 14}),
    ("slice_loss@3,slice=0;seed=3", {"recover_after": 2, "n": 12}),
], ids=["slice_loss", "flap", "dcn_partition", "slice0_loss"])
def test_driver_scenarios_agree_across_packages(spec, kw, tmp_path):
    """Each driver scenario on a clock the steps advance: the same report,
    decisions, ledger edges and restore tiers in both packages, and losses
    within 1e-6."""
    want = _scenario(JAX, tmp_path, spec, kw)
    got = _scenario(PORT, tmp_path, spec, kw)
    for key in ("report", "decisions", "edges", "tiers"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
