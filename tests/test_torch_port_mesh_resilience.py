"""Mesh-wide fault tolerance in one process, through both packages.

The one-process cases of ``tests/test_mesh_resilience.py``, written once over
a namespace ``P`` and run through the JAX package and the port: the chaos
grammar's ``host=`` targeting and per-process RNG streams, the collective
watchdog's units (passthrough, a worker's exception, the typed timeout
naming the trace lines and the straggler of the last ``host_health``, the
environment knob, ``wrap``), the SDC guard's units (divergence and suspect
arithmetic, the loss-spike heuristic, ``resolve_sdc_guard``), the primary
commit discipline, host loss's checkpoint with the mesh shape, the watchdog
inside ``run_training``, and the event schema and correlation of the mesh
kinds.

The port's program is one process a rank, so a replica is another rank: at
one process every leaf has a single replica and the SDC guard has nothing to
cross-check. Here the port's replica layout and its seam are held at one
rank and against a stated layout; the cases with replicas, and the reshard
round trips, run on 2 and 4 gloo ranks in
``tests/test_torch_port_resilience_ranks.py``. The port's
``shard_map_callable`` and its collective lines are held at a one-rank gloo
group, the JAX package's at 8 virtual devices in its own file.
"""

import json
import os
import tempfile
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu.monitor as jmonitor
import thunder_tpu_torch as tt
import thunder_tpu_torch.monitor as tmonitor
from thunder_tpu.analysis.events import replay_events as jreplay
from thunder_tpu.resilience import chaos as jchaos
from thunder_tpu.resilience import elastic as jelastic
from thunder_tpu.resilience import preemption as jpreemption
from thunder_tpu.resilience import watchdog as jwatchdog
from thunder_tpu_torch.analysis.events import replay_events as treplay
from thunder_tpu_torch.observability import metrics as tmetrics
from thunder_tpu_torch.resilience import chaos as tchaos
from thunder_tpu_torch.resilience import elastic as telastic
from thunder_tpu_torch.resilience import preemption as tpreemption
from thunder_tpu_torch.resilience import watchdog as twatchdog

JAX = SimpleNamespace(name="jax", monitor=jmonitor, replay=jreplay, chaos=jchaos, elastic=jelastic,
                      preemption=jpreemption, watchdog=jwatchdog, ones=lambda n: np.ones(n, np.float32),
                      full=lambda n, v: np.full(n, v, np.float32))
PORT = SimpleNamespace(name="port", monitor=tmonitor, replay=treplay, chaos=tchaos, elastic=telastic,
                       preemption=tpreemption, watchdog=twatchdog, ones=lambda n: torch.ones(n),
                       full=lambda n, v: torch.full((n,), float(v)))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    """No ambient chaos, watchdog or metrics in either package."""
    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    monkeypatch.delenv("THUNDER_TPU_CHAOS", raising=False)
    monkeypatch.delenv("THUNDER_TPU_COLLECTIVE_TIMEOUT_S", raising=False)
    monkeypatch.delenv("THUNDER_TPU_CHAOS_PROCESS_INDEX", raising=False)
    was = (jmonitor.enabled(), tmonitor.enabled())
    for P in (JAX, PORT):
        P.chaos.reset_env_config()
        P.watchdog.configure(None)
        P.watchdog.note_host_health(None)
        P.monitor.disable()
        P.monitor.reset()
    yield
    for P, on in zip((JAX, PORT), was):
        P.monitor.reset()
        (P.monitor.enable if on else P.monitor.disable)()
        P.watchdog.configure(None)
        P.watchdog.note_host_health(None)
        P.chaos.reset_env_config()
    # An abandoned worker finishes its injected sleep before the next test.
    for t in list(twatchdog._abandoned) + list(jwatchdog._abandoned):
        t.join(timeout=5.0)


def _events(path):
    return [json.loads(line) for line in open(path)]


def _kinds(path):
    return [r["kind"] for r in _events(path)]


# =============================================================================
# Chaos grammar: host targeting + per-process RNG streams
# =============================================================================


@BOTH
class TestMeshChaosGrammar:
    def test_host_clause_parses(self, P):
        cfg = P.chaos.parse_spec("collective_hang@host=2~0.5;host_loss@3,host=1;sdc*2")
        hang, loss, sdc = cfg.rules
        assert (hang.seam, hang.host, hang.delay_s) == ("collective_hang", 2, 0.5)
        assert (loss.seam, loss.target, loss.host) == ("host_loss", "3", 1)
        assert (sdc.seam, sdc.count, sdc.host) == ("sdc", 2, None)

    def test_malformed_host_clause_raises(self, P):
        with pytest.raises(ValueError, match="host clause"):
            P.chaos.parse_spec("oom@host=abc")

    def test_host_targeting_gates_firing(self, P, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_CHAOS_PROCESS_INDEX", "0")
        with P.chaos.chaos_scope("host_loss@1,host=3"):
            assert not P.chaos.host_loss_at_step(1)
        monkeypatch.setenv("THUNDER_TPU_CHAOS_PROCESS_INDEX", "3")
        with P.chaos.chaos_scope("host_loss@1,host=3"):
            assert P.chaos.host_loss_at_step(1)

    def test_per_process_rng_streams(self, P, monkeypatch):
        def draws(pidx):
            monkeypatch.setenv("THUNDER_TPU_CHAOS_PROCESS_INDEX", str(pidx))
            cfg = P.chaos.parse_spec("oom*inf%0.5;seed=11")
            return [cfg.rng.random() for _ in range(8)]

        assert draws(0) == draws(0)
        assert draws(0) != draws(1)

    def test_step_targeted_host_loss_exact_match(self, P):
        with P.chaos.chaos_scope("host_loss@3"):
            assert not P.chaos.host_loss_at_step(13)
            assert P.chaos.host_loss_at_step(3)
            assert not P.chaos.host_loss_at_step(3)


def test_per_process_streams_equal_across_packages(monkeypatch):
    for pidx in (0, 1, 5):
        monkeypatch.setenv("THUNDER_TPU_CHAOS_PROCESS_INDEX", str(pidx))
        a = [jchaos.parse_spec("oom*inf%0.5;seed=11").rng.random() for _ in range(64)]
        b = [tchaos.parse_spec("oom*inf%0.5;seed=11").rng.random() for _ in range(64)]
        assert a == b


def test_process_index_is_the_rank_or_zero(monkeypatch):
    monkeypatch.delenv("THUNDER_TPU_CHAOS_PROCESS_INDEX", raising=False)
    assert not torch.distributed.is_initialized()
    assert tchaos.process_index() == 0


# =============================================================================
# Collective watchdog
# =============================================================================


@BOTH
class TestCollectiveWatchdog:
    def test_passthrough_when_disabled(self, P):
        assert P.watchdog.guard_call(lambda a: a * 2, (21,), fn_name="f") == 42

    def test_worker_exception_propagates(self, P):
        with pytest.raises(ZeroDivisionError):
            P.watchdog.guard_call(lambda: 1 / 0, (), fn_name="f", timeout_s=5.0)

    def test_timeout_raises_typed_error(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        P.monitor.set_event_log(log)
        try:
            with P.chaos.chaos_scope("collective_hang~0.5"):
                with pytest.raises(P.watchdog.CollectiveTimeoutError) as ei:
                    P.watchdog.guard_call(lambda: 1, (), fn_name="step", timeout_s=0.1,
                                          trace_lines=["L3.synchronize", "L9.reduce_scatter"])
        finally:
            P.monitor.set_event_log(None)
        e = ei.value
        assert e.timeout_s == 0.1
        assert "L3.synchronize" in str(e)
        kinds = _kinds(log)
        assert "fault_injected" in kinds and "collective_timeout" in kinds
        rec = next(r for r in _events(log) if r["kind"] == "collective_timeout")
        assert rec["lines"] == ["L3.synchronize", "L9.reduce_scatter"]

    def test_timeout_names_suspected_straggler(self, P):
        records = [{"kind": "step_time", "host": h, "s": (0.5 if h == 2 else 0.1), "fn": "step", "step": s}
                   for h in range(4) for s in range(3)]
        summary, _ = P.monitor.host_health(records)
        assert summary["stragglers"] == [2]
        with P.chaos.chaos_scope("collective_hang~0.5"):
            with pytest.raises(P.watchdog.CollectiveTimeoutError) as ei:
                P.watchdog.guard_call(lambda: 1, (), fn_name="s", timeout_s=0.05)
        assert ei.value.suspected_host == 2
        assert P.monitor.last_host_health() is summary

    def test_env_configuration(self, P, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_COLLECTIVE_TIMEOUT_S", "7.5")
        P.watchdog._config["resolved"] = False
        assert P.watchdog.active_timeout() == 7.5
        P.monitor.configure_watchdog(None)
        assert P.watchdog.active_timeout() is None

    def test_wrap_probes_at_call_time(self, P):
        calls = []
        guarded = P.watchdog.wrap(lambda x: calls.append(x) or x, fn_name="g")
        assert guarded(5) == 5
        P.monitor.configure_watchdog(3.0)
        assert guarded(6) == 6
        assert calls == [5, 6]


def test_worker_runs_with_the_callers_grad_mode_and_context():
    """The guarded worker thread takes the caller's grad mode and context
    variables (a chaos scope), as the caller's own call would."""
    seen = {}

    def probe():
        seen["grad"] = torch.is_grad_enabled()
        seen["chaos"] = tchaos.active() is not None
        return 1

    with torch.no_grad(), tchaos.chaos_scope("oom*0"):
        assert twatchdog.guard_call(probe, (), fn_name="p", timeout_s=5.0) == 1
    assert seen == {"grad": False, "chaos": True}


def test_collective_trace_lines():
    """The port's collective prims name their lines in a traced program."""
    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.prims import collective_trace_lines

    def f(w, x):
        w2 = dist.synchronize(w, "dp", 8)
        return torch.sum(torch.nn.functional.linear(x, w2))

    w = torch.randn(4, 4)
    x = torch.randn(2, 4)
    _, comp = trace_program(f, (w, x), {})
    lines = collective_trace_lines(comp)
    assert any("synchronize" in ln for ln in lines)
    assert all(ln.startswith("L") for ln in lines)


@pytest.fixture(scope="module")
def one_rank():
    import thunder_tpu_torch.distributed as td

    path = os.path.join(tempfile.mkdtemp(), "store")
    store = torch.distributed.FileStore(path, 1)
    info = td.init(device="cpu", store=store, num_processes=1, process_id=0)
    yield info
    for t in list(twatchdog._abandoned):
        t.join(timeout=5.0)
    td.shutdown()
    assert not td.is_initialized()


def test_shard_map_callable_guarded(one_rank):
    """A hung explicit-collective program at a one-rank gloo group times out
    with its trace lines instead of blocking the host; unguarded it runs."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
    from thunder_tpu_torch.parallel.mesh import make_mesh

    x = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    jf, extrace = compile_with_collectives(lambda a: dist.all_reduce(a, "dp", 1), (x,), make_mesh(dp=1),
                                           (P("dp", None),), P(None, None))
    torch.testing.assert_close(jf(x), x)
    tmonitor.configure_watchdog(0.1)
    with tchaos.chaos_scope("collective_hang~0.5"):
        with pytest.raises(twatchdog.CollectiveTimeoutError) as ei:
            jf(x)
    assert any("all_reduce" in ln for ln in ei.value.trace_lines)
    assert ei.value.schedule is not None


def test_jit_dispatch_guarded(one_rank):
    """``jit``'s dispatch of a program with collectives (a ddp step: the
    params through ``synchronize`` over dp) runs under the watchdog once a
    timeout is configured: a hang times out naming the entry's own
    collective lines; unguarded, the next call gives the loss and grads of
    the same step without collectives, bit for bit."""
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.prims import collective_trace_lines
    from thunder_tpu_torch.distributed.runtime import bound_axes, resolve_axes
    from thunder_tpu_torch.parallel.mesh import make_mesh

    w = torch.from_numpy(np.random.RandomState(0).randn(4, 4).astype(np.float32))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 4).astype(np.float32))

    def loss(w, x):
        return torch.sum(torch.tanh(torch.nn.functional.linear(x, w)))

    ddp = tt.value_and_grad(lambda w, x: loss(dist.synchronize(w, "dp", 1, "replicated"), x), device="cpu")
    want = tt.value_and_grad(loss, device="cpu")(w, x)
    with bound_axes(resolve_axes(make_mesh(dp=1), ["dp"])):
        ddp(w, x)
        lines = collective_trace_lines(tt.last_traces(ddp)[-1])
        assert any("all_reduce" in ln for ln in lines)
        tmonitor.configure_watchdog(0.1)
        try:
            with tchaos.chaos_scope("collective_hang~0.5"):
                with pytest.raises(twatchdog.CollectiveTimeoutError) as ei:
                    ddp(w, x)
        finally:
            tmonitor.configure_watchdog(None)
        for t in list(twatchdog._abandoned):
            t.join(timeout=5.0)
        assert list(ei.value.trace_lines) == lines
        got = ddp(w, x)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]))


def test_replica_layout_at_one_rank(one_rank):
    """At one rank every leaf has one replica: nothing to cross-check and
    nothing the sdc seam can corrupt."""
    from thunder_tpu_torch.distributed.runtime import P
    from thunder_tpu_torch.parallel.mesh import make_mesh

    state = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4), "b": torch.ones(4)}
    assert twatchdog.replica_checksums(state) == {}
    mesh = make_mesh(dp=1)
    assert twatchdog.replica_checksums(state, mesh=mesh, specs={"w": P("dp", None), "b": P()}) == {}
    before = state["w"].clone()
    with tchaos.chaos_scope("sdc*1"):
        out = tchaos.maybe_corrupt_replica(state)
    assert out is state and torch.equal(state["w"], before)


# =============================================================================
# SDC guard
# =============================================================================


@pytest.mark.parametrize("ordinal,flipped", [(1, True), (0, False), (None, True)])
def test_sdc_seam_flips_one_bit_of_its_replica(ordinal, flipped):
    """The port's seam at a stated layout (the first leaf replicated on two
    ranks, this one of the given ordinal): the rank of the rule's target
    ordinal (default 1) flips the low mantissa bit of element 0, in place;
    the other keeps its bytes; a leaf of one replica is skipped."""
    w = torch.arange(8, dtype=torch.float32) + 0.5
    state = {"a": torch.ones(3), "w": w}
    before = w.clone()
    mine = 1 if ordinal is None else ordinal

    def replica_of(i, leaf):
        return None if i == 0 else ((), mine, 2)

    with tchaos.chaos_scope("sdc*1"):
        tchaos.maybe_corrupt_replica(state, replica_of=replica_of)
    assert state["w"] is w
    diff = (w.view(torch.int32) ^ before.view(torch.int32)).tolist()
    assert diff == ([1] + [0] * 7 if flipped else [0] * 8)
    assert torch.equal(state["a"], torch.ones(3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdc_seam_in_bf16_and_f32_changes_the_crc(dtype):
    w = torch.linspace(-1, 1, 16).to(getattr(torch, dtype))
    crc = twatchdog.array_crc32(w)
    with tchaos.chaos_scope("sdc*1"):
        tchaos.maybe_corrupt_replica({"w": w}, replica_of=lambda i, leaf: ((), 1, 2))
    assert twatchdog.array_crc32(w) != crc


@BOTH
class TestSDCGuard:
    def test_divergence_and_suspects(self, P):
        cs = {"leaf0": {"(0,)": {0: 7, 1: 7, 2: 9, 3: 7}}, "leaf1": {"(1,)": {0: 5, 1: 5}}}
        div = P.watchdog.divergent_leaves(cs)
        assert list(div) == ["leaf0"]
        assert P.watchdog.suspect_devices(div) == [2]
        tie = {"leaf0": {"()": {0: 1, 1: 2}}}
        assert P.watchdog.suspect_devices(P.watchdog.divergent_leaves(tie)) == [0, 1]
        assert P.watchdog.divergent_leaves({"leaf0": {"()": {0: 3, 1: 3}}}) == {}

    def test_loss_spike_heuristic(self, P):
        g = P.watchdog.SDCGuard(loss_spike_factor=10.0)
        for v in (1.0, 1.1, 0.9, 1.0):
            assert not g.loss_suspect(v)
        assert g.loss_suspect(50.0)
        assert g.loss_suspect(float("nan"))
        assert not g.loss_suspect(1.05)

    def test_resolve(self, P):
        assert P.watchdog.resolve_sdc_guard(None) is None
        assert P.watchdog.resolve_sdc_guard(False) is None
        assert isinstance(P.watchdog.resolve_sdc_guard(True), P.watchdog.SDCGuard)
        g = P.watchdog.SDCGuard(check_every=3)
        assert P.watchdog.resolve_sdc_guard(g) is g
        with pytest.raises(TypeError):
            P.watchdog.resolve_sdc_guard("yes")


# =============================================================================
# run_training: host loss, the watchdog
# =============================================================================


def _step(P):
    def step(state):
        w = state["w"] - 0.1 * state["w"]
        return {"w": w}, float((w * w).sum())

    return step


@BOTH
class TestRunTrainingFaults:
    def test_host_loss_checkpoints_with_mesh_meta(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"))
        log = str(tmp_path / "ev.jsonl")
        P.monitor.set_event_log(log)
        try:
            with P.chaos.chaos_scope("host_loss@2"):
                with pytest.raises(P.preemption.HostLost) as ei:
                    P.preemption.run_training(_step(P), {"w": P.ones(4)}, 5, manager=mgr,
                                              mesh={"fsdp": 4, "tp": 2})
        finally:
            P.monitor.set_event_log(None)
        assert ei.value.step == 2
        meta = json.load(open(os.path.join(mgr._step_dir(2), "META.json")))
        assert meta["mesh"]["fsdp"] == 4 and meta["mesh"]["tp"] == 2
        assert "host_loss" in _kinds(log)
        summary, _ = P.replay(log, storm_threshold=16)
        assert summary["unrecovered_faults"] == []

    def test_watchdog_timeout_in_run_training(self, P, tmp_path):
        with P.chaos.chaos_scope("collective_hang~0.5"):
            with pytest.raises(P.watchdog.CollectiveTimeoutError):
                P.preemption.run_training(_step(P), {"w": P.ones(4)}, 3,
                                          manager=P.preemption.CheckpointManager(str(tmp_path / "ck")),
                                          watchdog_timeout_s=0.1)


def test_fresh_start_reshards_init_state(tmp_path, one_rank):
    """With nothing to restore, ``elastic_resume`` lays the initial state
    out on the target mesh (at one rank: the whole leaves)."""
    from thunder_tpu_torch.distributed.runtime import P
    from thunder_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(fsdp=1, tp=1)
    specs = {"w": P("fsdp", "tp"), "b": P()}
    host_state = {"w": torch.ones(8, 4), "b": torch.ones(4)}
    mgr = tpreemption.CheckpointManager(str(tmp_path / "empty"))
    state, start = telastic.elastic_resume(mgr, host_state, mesh=mesh, specs=specs)
    assert start == 0
    assert torch.equal(state["w"], host_state["w"]) and torch.equal(state["b"], host_state["b"])


# =============================================================================
# CheckpointManager: the primary's commit discipline
# =============================================================================


@BOTH
class TestPrimaryCommitDiscipline:
    def test_non_primary_skips_meta_and_gc(self, P, tmp_path, monkeypatch):
        mgr = P.preemption.CheckpointManager(str(tmp_path), keep=1)
        monkeypatch.setattr(P.preemption, "_is_primary", lambda: False)
        mgr.save({"x": P.ones(2)}, 1)
        assert mgr.latest_complete_step() is None
        assert os.path.isdir(mgr._step_dir(1) + ".tmp")

    def test_primary_commits_and_gcs(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path), keep=1)
        for s in (1, 2):
            mgr.save({"x": P.full(2, s)}, s, mesh={"fsdp": 4})
        assert mgr.latest_complete_step() == 2
        assert mgr.steps_on_disk() == [2]
        _, meta = mgr.restore()
        assert meta["mesh"] == {"fsdp": 4}


# =============================================================================
# Event schema + correlation for the mesh kinds
# =============================================================================


def _replay(P, recs, **kw):
    path = os.path.join(tempfile.mkdtemp(), "log.jsonl")
    with open(path, "w") as f:
        for i, r in enumerate(recs):
            base = {"v": 1, "ts": float(i), "seq": i, "pid": 1, "host": 0}
            base.update(r)
            f.write(json.dumps(base) + "\n")
    return P.replay(path, **kw)


@BOTH
class TestMeshEventSchema:
    def test_new_kinds_validate(self, P):
        summary, diags = _replay(P, [
            {"kind": "collective_timeout", "fn": "step", "timeout_s": 1.0, "lines": ["L1.synchronize"],
             "suspected_host": 2},
            {"kind": "host_loss", "step": 3, "host": 1},
            {"kind": "elastic_resume", "step": 3, "from_mesh": {"fsdp": 4}, "to_mesh": {"fsdp": 2},
             "resharded": True, "tier": "local"},
            {"kind": "sdc_suspect", "step": 5, "leaves": ["leaf0"]},
            {"kind": "sdc_rerun", "step": 5, "ok": True},
        ])
        assert not diags

    def test_unrecovered_collective_hang_flagged(self, P):
        summary, _ = _replay(P, [{"kind": "fault_injected", "seam": "collective_hang", "target": None, "n": 1}])
        assert summary["unrecovered_faults"] == ["collective_hang@None"]
        summary, _ = _replay(P, [
            {"kind": "fault_injected", "seam": "collective_hang", "target": None, "n": 1},
            {"kind": "collective_timeout", "fn": "step", "timeout_s": 1.0, "lines": [], "suspected_host": None},
        ])
        assert summary["unrecovered_faults"] == []

    def test_failed_sdc_rerun_does_not_count_as_recovery(self, P):
        summary, _ = _replay(P, [
            {"kind": "fault_injected", "seam": "sdc", "target": "leaf0", "n": 1},
            {"kind": "sdc_rerun", "step": 1, "ok": False},
        ])
        assert summary["unrecovered_faults"] == ["sdc@leaf0"]
        summary, _ = _replay(P, [
            {"kind": "fault_injected", "seam": "sdc", "target": "leaf0", "n": 1},
            {"kind": "sdc_rerun", "step": 1, "ok": True},
        ])
        assert summary["unrecovered_faults"] == []

    def test_host_loss_recovers_via_checkpoint(self, P):
        summary, _ = _replay(P, [
            {"kind": "fault_injected", "seam": "host_loss", "target": "2", "n": 1},
            {"kind": "checkpoint_save", "path": "p", "step": 2, "ok": True, "attempt": 0},
        ])
        assert summary["unrecovered_faults"] == []


# =============================================================================
# Metrics
# =============================================================================


@BOTH
def test_watchdog_metric(P):
    P.monitor.enable()
    with P.chaos.chaos_scope("collective_hang~0.5"):
        with pytest.raises(P.watchdog.CollectiveTimeoutError):
            P.watchdog.guard_call(lambda: 1, (), fn_name="mstep", timeout_s=0.05)
    metrics = __import__(f"{'thunder_tpu' if P is JAX else 'thunder_tpu_torch'}.observability.metrics",
                         fromlist=["x"])
    assert metrics.WATCHDOG_TIMEOUTS.value(fn="mstep") == 1


def test_abandoned_worker_cap_runs_unguarded(monkeypatch):
    """Past the cap of live abandoned workers the dispatch runs unguarded,
    loudly, and counts."""
    tmonitor.enable()
    monkeypatch.setenv("THUNDER_TPU_WATCHDOG_MAX_ABANDONED", "1")
    gate = threading.Event()
    with tchaos.chaos_scope("collective_hang~0.3"):
        with pytest.raises(twatchdog.CollectiveTimeoutError):
            twatchdog.guard_call(gate.wait, (2.0,), fn_name="w", timeout_s=0.05)
    with pytest.warns(RuntimeWarning, match="UNguarded"):
        assert twatchdog.guard_call(lambda: 3, (), fn_name="w2", timeout_s=0.05) == 3
    assert tmetrics.WATCHDOG_UNGUARDED.value() == 1
    gate.set()
