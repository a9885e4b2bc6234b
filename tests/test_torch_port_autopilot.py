"""The fleet autopilot through both packages, on the CPU.

The cases of ``tests/test_autopilot.py`` written once over a namespace ``P``
and run through the JAX package and the port
(``thunder_tpu_torch/resilience/autopilot.py``): the policy engine and its
hysteresis ladders, serialized recoveries across threads, the decision
replay (``events.unactuated-decision``), the watchdog's cap on abandoned
workers and the retention of corrupt checkpoints. Less ``TestSoakSchedule``
(its 7 cases read the soak drivers of ``scripts/``, which wait with them)
and ``TestAutopilotDriver`` (its 7 scenarios run on gloo ranks in
``tests/test_torch_port_fleet_ranks.py``).

Across the packages, on the same inputs: a seeded stream of signals (kinds,
suspect hosts, clock steps, anomalies and host-health summaries drawn from
a numpy seed) gives equal decision sequences, actuator, mode, rung and cited
anomaly each. Then the wiring: with an autopilot installed, the de-opt
climb, the preemption branch and the SDC quarantine each emit their
``autopilot_decision`` before their recovery event, in both packages; with
none installed, no decision is emitted. Where the two differ, by design: the
port maps an out-of-memory (``torch.OutOfMemoryError`` or the chaos seam's
injected one) to the ``oom`` signal, where the JAX package's
``signal_from_exception`` names an unknown kind after the exception type.
"""

import contextlib
import json
import os
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu as ttpu
import thunder_tpu.monitor as jmonitor
from thunder_tpu.analysis.events import replay_events as jreplay
from thunder_tpu.observability import metrics as jmetrics
from thunder_tpu.resilience import autopilot as jap
from thunder_tpu.resilience import chaos as jchaos
from thunder_tpu.resilience import preemption as jpreemption
from thunder_tpu.resilience import watchdog as jwatchdog

import thunder_tpu_torch as tt
import thunder_tpu_torch.monitor as tmonitor
from thunder_tpu_torch.analysis.events import replay_events as treplay
from thunder_tpu_torch.observability import metrics as tmetrics
from thunder_tpu_torch.resilience import autopilot as tap
from thunder_tpu_torch.resilience import chaos as tchaos
from thunder_tpu_torch.resilience import preemption as tpreemption
from thunder_tpu_torch.resilience import watchdog as twatchdog

JAX = SimpleNamespace(name="jax", pkg=ttpu, ap=jap, chaos=jchaos, preemption=jpreemption, watchdog=jwatchdog,
                      monitor=jmonitor, metrics=jmetrics, replay=jreplay, array=lambda a: a,
                      jit=lambda f, **k: ttpu.jit(f, **k))
PORT = SimpleNamespace(name="port", pkg=tt, ap=tap, chaos=tchaos, preemption=tpreemption, watchdog=twatchdog,
                       monitor=tmonitor, metrics=tmetrics, replay=treplay, array=torch.from_numpy,
                       jit=lambda f, **k: tt.jit(f, device="cpu", **k))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    """No ambient chaos, watchdog, metrics or autopilot in either package;
    abandoned workers drained between tests so the cap cannot leak across."""
    monkeypatch.setenv("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    monkeypatch.delenv("THUNDER_TPU_CHAOS", raising=False)
    monkeypatch.delenv("THUNDER_TPU_COLLECTIVE_TIMEOUT_S", raising=False)
    monkeypatch.delenv("THUNDER_TPU_WATCHDOG_MAX_ABANDONED", raising=False)
    was = {}
    for P in (JAX, PORT):
        P.chaos.reset_env_config()
        P.watchdog.configure(None)
        P.watchdog.note_host_health(None)
        P.watchdog._abandoned.clear()
        P.ap.install(None)
        was[P.name] = P.monitor.enabled()
        P.monitor.disable()
        P.monitor.reset()
    yield
    for P in (JAX, PORT):
        P.monitor.reset()
        (P.monitor.enable if was[P.name] else P.monitor.disable)()
        P.ap.install(None)
        P.watchdog.configure(None)
        P.watchdog._abandoned.clear()
        P.chaos.reset_env_config()


def _events(path):
    return [json.loads(line) for line in open(path)]


# =============================================================================
# Policy engine
# =============================================================================


class TestPolicyEngine:
    @BOTH
    def test_default_table_first_rung(self, P):
        ap = P.ap.Autopilot(clock=lambda: 0.0)
        for kind, actuator, mode in (
            ("host_loss", "elastic_resume", "shrink"),
            ("collective_hang", "elastic_resume", "same_mesh"),
            ("sdc_suspect", "quarantine_rerun", None),
            ("sdc_persistent", "elastic_resume", "shrink"),
            ("oom", "deopt_escalate", None),
            ("compile_fail", "deopt_escalate", None),
            ("preempt", "checkpoint_halt", None),
        ):
            d = ap.decide(P.ap.Signal(kind))
            assert (d.actuator, d.mode) == (actuator, mode), kind

    @BOTH
    def test_hysteresis_ladder_climbs_and_decays(self, P):
        now = {"t": 0.0}
        ap = P.ap.Autopilot(clock=lambda: now["t"])
        rungs = [ap.decide(P.ap.Signal("collective_hang", suspect_host=1)).mode for _ in range(3)]
        assert rungs == ["same_mesh", "shrink", None]  # third rung halts
        assert ap.decisions[-1].actuator == "checkpoint_halt"
        # Outside the window the strike count decays back to rung 0.
        now["t"] = 1000.0
        d = ap.decide(P.ap.Signal("collective_hang", suspect_host=1))
        assert (d.actuator, d.mode, d.rung) == ("elastic_resume", "same_mesh", 0)

    @BOTH
    def test_hysteresis_keyed_per_suspect_host(self, P):
        ap = P.ap.Autopilot(clock=lambda: 0.0)
        assert ap.decide(P.ap.Signal("collective_hang", suspect_host=1)).rung == 0
        # A different flapping host has its own strike history.
        assert ap.decide(P.ap.Signal("collective_hang", suspect_host=5)).rung == 0
        assert ap.decide(P.ap.Signal("collective_hang", suspect_host=1)).rung == 1

    @BOTH
    def test_flagged_straggler_skips_gentle_rung(self, P):
        """A host the observatory measured slow twice gets no same-mesh retry
        when it hangs."""
        ap = P.ap.Autopilot(clock=lambda: 0.0, health_strikes=2)
        summary = {"spread_ratio": 3.0, "stragglers": [2]}
        ap.note_host_health(summary)
        assert ap.flagged_stragglers() == set()  # one strike: not yet
        ap.note_host_health(summary)
        assert ap.flagged_stragglers() == {2}
        d = ap.decide(P.ap.Signal("collective_hang", suspect_host=2))
        assert (d.mode, d.rung) == ("shrink", 1)
        # An unrelated host still gets the gentle rung.
        assert ap.decide(P.ap.Signal("collective_hang", suspect_host=0)).rung == 0
        # A clean summary clears the flag.
        ap.note_host_health({"spread_ratio": 1.0, "stragglers": []})
        assert ap.flagged_stragglers() == set()

    @BOTH
    def test_host_health_feeds_installed_autopilot(self, P):
        """``host_health`` pushes its summary to the INSTALLED autopilot, not
        just the watchdog."""
        ap = P.ap.Autopilot(health_strikes=1)
        records = [{"kind": "step_time", "host": h, "s": (0.5 if h == 2 else 0.1), "fn": "step", "step": s}
                   for h in range(4) for s in range(3)]
        with ap.installed():
            summary, _ = P.monitor.host_health(records)
        assert summary["stragglers"] == [2]
        assert ap.flagged_stragglers() == {2}

    @BOTH
    def test_unknown_signal_halts(self, P):
        ap = P.ap.Autopilot()
        assert ap.decide(P.ap.Signal("cosmic_ray_in_the_scheduler")).actuator == "checkpoint_halt"

    @BOTH
    def test_decision_event_and_metric(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        P.monitor.set_event_log(log)
        P.monitor.enable()
        try:
            P.ap.Autopilot().decide(P.ap.Signal("host_loss", step=7, suspect_host=3, evidence={"path": "/ck"}))
        finally:
            P.monitor.set_event_log(None)
        rec = next(r for r in _events(log) if r["kind"] == "autopilot_decision")
        assert rec["decision_id"] == 1
        assert rec["signal"] == "host_loss"
        assert rec["actuator"] == "elastic_resume"
        assert rec["mode"] == "shrink"
        assert rec["step"] == 7 and rec["suspect_host"] == 3
        assert rec["evidence"] == {"path": "/ck"}
        assert P.metrics.AUTOPILOT_DECISIONS.value(actuator="elastic_resume") == 1

    @BOTH
    def test_signal_from_exception(self, P):
        ap = P.ap.Autopilot()
        s = ap.signal_from_exception(P.preemption.HostLost(4, "/ck"))
        assert (s.kind, s.step) == ("host_loss", 4)
        s = ap.signal_from_exception(P.preemption.Preempted(9, "/ck"))
        assert (s.kind, s.step) == ("preempt", 9)
        s = ap.signal_from_exception(P.watchdog.CollectiveTimeoutError("step", 1.0, ["L3.synchronize"], 2))
        assert (s.kind, s.suspect_host) == ("collective_hang", 2)
        assert s.evidence["lines"] == ["L3.synchronize"]
        s = ap.signal_from_exception(P.watchdog.SDCDetectedError(5, ["leaf0"]))
        assert (s.kind, s.step, s.evidence["leaves"]) == ("sdc_persistent", 5, ["leaf0"])

    @BOTH
    def test_shrink_shape(self, P):
        assert P.ap.shrink_shape({"fsdp": 4, "tp": 2}) == {"fsdp": 2, "tp": 2}
        assert P.ap.shrink_shape({"fsdp": 1, "tp": 2}) == {"fsdp": 1, "tp": 1}
        assert P.ap.shrink_shape({"fsdp": 1, "tp": 1}) is None
        assert P.ap.shrink_shape({"dp": 8}) == {"dp": 4}


def test_port_out_of_memory_is_the_oom_signal():
    """The port's out-of-memory errors (the CUDA allocator's, and the chaos
    seam's, which carries its message) are the ``oom`` signal the de-opt
    ladder decides on."""
    ap = tap.Autopilot()
    for exc in (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
                tchaos.InjectedOOMError()):
        s = ap.signal_from_exception(exc)
        assert s.kind == "oom" and "out of memory" in s.evidence["error"]
        assert ap.decide(s).actuator == "deopt_escalate"
    assert ap.signal_from_exception(ValueError("x")).kind == "ValueError"


def _signal_stream(seed: int, n: int = 60) -> list:
    """A seeded stream of autopilot inputs: ("signal", kind, host, dt) with a
    clock step, ("anomaly", kind, host, severity, age_s) and ("health",
    stragglers)."""
    rng = np.random.RandomState(seed)
    kinds = ["host_loss", "collective_hang", "sdc_suspect", "sdc_persistent", "oom", "compile_fail", "preempt",
             "slice_loss", "host_unhealthy", "mystery"]
    anomalies = ["step_time_drift", "goodput_drop", "host_spread", "recompile_storm", "slice_spread",
                 "bottleneck_shift"]
    out = []
    for _ in range(n):
        r = rng.rand()
        host = [None, 0, 1, 2, "slice1"][rng.randint(5)]
        if r < 0.65:
            out.append(("signal", kinds[rng.randint(len(kinds))], host, float(rng.choice([0.0, 5.0, 90.0, 400.0]))))
        elif r < 0.9:
            out.append(("anomaly", anomalies[rng.randint(len(anomalies))], host,
                        ["info", "warn", "critical"][rng.randint(3)], float(rng.choice([0.0, 100.0, 5000.0]))))
        else:
            out.append(("health", [int(h) for h in rng.choice(3, rng.randint(0, 3), replace=False)]))
    return out


def _decide_stream(P, stream: list, now: float) -> list:
    clock = {"t": 0.0}
    ap = P.ap.Autopilot(clock=lambda: clock["t"])
    for item in stream:
        if item[0] == "signal":
            _, kind, host, dt = item
            clock["t"] += dt
            ap.decide(P.ap.Signal(kind, suspect_host=host))
        elif item[0] == "anomaly":
            _, kind, host, sev, age = item
            ap.note_anomaly({"anomaly": kind, "severity": sev, "ts": now - age, "value": 2.0, "baseline": 1.0,
                             "suspect_host": host})
        else:
            ap.note_host_health({"spread_ratio": 2.0, "stragglers": item[1]})
    return [(d.signal.kind, d.actuator, d.mode, d.rung, d.fires_in_window,
             (d.signal.evidence or {}).get("anomaly", {}).get("anomaly")) for d in ap.decisions]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_signals_give_the_same_decisions(seed):
    """A seeded stream of signals, anomalies and host-health summaries
    through both packages' autopilots: the same decisions, actuator, mode,
    rung, fires in window and cited anomaly each."""
    stream = _signal_stream(seed)
    now = time.time()
    want = _decide_stream(JAX, stream, now)
    got = _decide_stream(PORT, stream, now)
    assert got == want
    assert {d[1] for d in got} >= {"elastic_resume", "checkpoint_halt"}


# =============================================================================
# Serialized recoveries
# =============================================================================


class TestSerialization:
    @BOTH
    def test_recoveries_serialize_across_threads(self, P):
        ap = P.ap.Autopilot(clock=time.monotonic)
        d1 = ap.decide(P.ap.Signal("host_loss"))
        d2 = ap.decide(P.ap.Signal("collective_hang"))

        def apply(decision):
            with ap.recovery(decision):
                time.sleep(0.15)

        t1 = threading.Thread(target=apply, args=(d1,))
        t2 = threading.Thread(target=apply, args=(d2,))
        t1.start()
        time.sleep(0.03)  # t1 holds the recovery lock first
        t2.start()
        t1.join()
        t2.join()
        assert len(ap.recovery_intervals) == 2
        (a0, a1, _), (b0, b1, _) = sorted(ap.recovery_intervals)
        assert a1 <= b0  # one actuator at a time: intervals never overlap
        assert ap.stats()["serialized_waits"] >= 1

    @BOTH
    def test_nested_recovery_same_thread_is_one_chain(self, P):
        ap = P.ap.Autopilot()
        d1 = ap.decide(P.ap.Signal("sdc_suspect"))
        d2 = ap.decide(P.ap.Signal("collective_hang"))
        with ap.recovery(d1):
            with ap.recovery(d2):  # reentrant: a recovery-caused fault
                pass
        assert len(ap.recovery_intervals) == 2
        assert ap.stats()["serialized_waits"] == 0


# =============================================================================
# Decision correlation in replay
# =============================================================================


def _replay(P, recs, **kw):
    path = os.path.join(tempfile.mkdtemp(), "log.jsonl")
    with open(path, "w") as f:
        for i, r in enumerate(recs):
            base = {"v": 1, "ts": float(i), "seq": i, "pid": 1, "host": 0}
            base.update(r)
            f.write(json.dumps(base) + "\n")
    return P.replay(path, **kw)


def _decision(actuator, **kw):
    rec = {"kind": "autopilot_decision", "decision_id": 1, "signal": "host_loss", "actuator": actuator}
    rec.update(kw)
    return rec


class TestDecisionReplay:
    @BOTH
    def test_new_kinds_validate(self, P):
        _, diags = _replay(P, [
            _decision("elastic_resume", mode="shrink", step=3),
            {"kind": "elastic_resume", "step": 3, "from_mesh": {"fsdp": 4}, "to_mesh": {"fsdp": 2},
             "resharded": True, "tier": "local"},
            {"kind": "goodput", "goodput_tokens_per_sec": 123.0, "useful_tokens": 51200, "wall_s": 60.0},
        ])
        assert not diags

    @BOTH
    def test_unactuated_decision_flagged(self, P):
        summary, diags = _replay(P, [_decision("elastic_resume")])
        assert summary["unactuated_decisions"] == ["elastic_resume<-host_loss"]
        assert any(d.rule == "events.unactuated-decision" for d in diags)

    @BOTH
    def test_each_actuator_pairs_with_its_recovery(self, P):
        pairs = [
            ("elastic_resume", {"kind": "elastic_resume", "step": 1, "from_mesh": None, "to_mesh": None,
                                "resharded": False, "tier": "disk"}),
            ("quarantine_rerun", {"kind": "sdc_rerun", "step": 1, "ok": True}),
            ("deopt_escalate", {"kind": "compile_deopt", "level": 1, "action": "a", "reason": "r", "attempt": 0}),
            ("checkpoint_halt", {"kind": "checkpoint_save", "path": "p", "step": 1, "ok": True, "attempt": 0}),
        ]
        for actuator, recovery in pairs:
            summary, _ = _replay(P, [_decision(actuator), recovery])
            assert summary["unactuated_decisions"] == [], actuator
            assert summary["autopilot_decisions"] == {actuator: 1}

    @BOTH
    def test_failed_save_does_not_actuate_halt(self, P):
        summary, _ = _replay(P, [
            _decision("checkpoint_halt"),
            {"kind": "checkpoint_save", "path": "p", "step": 1, "ok": False, "attempt": 0},
        ])
        assert summary["unactuated_decisions"] == ["checkpoint_halt<-host_loss"]

    @BOTH
    def test_superseded_quarantine_actuated_by_elastic_restore(self, P):
        """An interrupted SDC re-run is recovered by the restore that
        discarded the poisoned state: both the decision and the sdc injection
        accept elastic_resume as recovery."""
        summary, _ = _replay(P, [
            {"kind": "fault_injected", "seam": "sdc", "target": "leaf0", "n": 1},
            _decision("quarantine_rerun", signal="sdc_suspect"),
            {"kind": "elastic_resume", "step": 0, "from_mesh": None, "to_mesh": None, "resharded": False,
             "tier": "disk"},
        ])
        assert summary["unactuated_decisions"] == []
        assert summary["unrecovered_faults"] == []


# =============================================================================
# The installed autopilot at the recovery paths
# =============================================================================


def _sgd_step(P):
    """A step that builds a new state each call: w <- w - 0.1 * w."""
    def step(state):
        w = state["w"]
        return {"w": w - 0.1 * w}, float((w * w).sum())
    return step


@BOTH
@pytest.mark.parametrize("installed", [True, False])
def test_deopt_climb_is_a_decision(P, installed, tmp_path):
    """An injected compile-time OOM climbs the de-opt ladder: with an
    autopilot installed its deopt_escalate decision comes first, then the
    compile_deopt; with none, no decision."""
    log = str(tmp_path / "ev.jsonl")
    P.monitor.set_event_log(log)
    ap = P.ap.Autopilot()
    try:
        jf = P.jit(lambda x: x * 2.0 + 1.0, chaos="oom*1")
        if installed:
            with ap.installed():
                jf(P.array(np.ones(4, np.float32)))
        else:
            jf(P.array(np.ones(4, np.float32)))
    finally:
        P.monitor.set_event_log(None)
    kinds = [(r["kind"], r.get("actuator")) for r in _events(log) if r["kind"] in ("autopilot_decision",
                                                                                      "compile_deopt")]
    if installed:
        assert kinds == [("autopilot_decision", "deopt_escalate"), ("compile_deopt", None)]
        assert [d.signal.kind for d in ap.decisions] == ["oom"]
        assert [(lo, hi) for lo, hi, _ in ap.recovery_intervals if hi < lo] == []
    else:
        assert kinds == [("compile_deopt", None)]
    summary, _ = P.replay(log)
    assert summary["unactuated_decisions"] == [] and summary["unrecovered_faults"] == []


@BOTH
@pytest.mark.parametrize("installed", [True, False])
def test_preemption_and_sdc_paths_are_decisions(P, installed, tmp_path):
    """``run_training`` under ``preempt@2``: the checkpoint_halt decision
    precedes the ok checkpoint_save; the SDC guard's quarantine of a step
    judged divergent (a guard that needs no replicas): the quarantine_rerun
    decision precedes the sdc_rerun. With no autopilot,
    the same runs emit no decision."""
    log = str(tmp_path / "ev.jsonl")
    state = {"w": P.array(np.ones(4, np.float32))}
    ap = P.ap.Autopilot()

    class OnceDivergent(P.watchdog.SDCGuard):
        """Judges the first checked step divergent and every re-run clean."""

        def check_state(self, state):
            self.checks = getattr(self, "checks", 0) + 1
            return {"leaf0": {"()": {0: 1, 1: 2}}} if self.checks == 1 else {}

    guard = OnceDivergent(max_reruns=1)
    P.monitor.set_event_log(log)
    try:
        with (ap.installed() if installed else contextlib.nullcontext()):
            with P.chaos.chaos_scope("preempt@2"):
                with pytest.raises(P.preemption.Preempted):
                    P.preemption.run_training(_sgd_step(P), state, 4,
                                              manager=P.preemption.CheckpointManager(str(tmp_path / "a")))
            P.preemption.run_training(_sgd_step(P), state, 3,
                                      manager=P.preemption.CheckpointManager(str(tmp_path / "b")),
                                      sdc_guard=guard)
    finally:
        P.monitor.set_event_log(None)
    recs = [r for r in _events(log) if r["kind"] in ("autopilot_decision", "checkpoint_save", "sdc_rerun")]
    order = [(r["kind"], r.get("actuator")) for r in recs]
    if installed:
        i = order.index(("autopilot_decision", "checkpoint_halt"))
        assert order[i + 1] == ("checkpoint_save", None)
        j = order.index(("autopilot_decision", "quarantine_rerun"))
        assert order[j + 1] == ("sdc_rerun", None)
        assert [d.actuator for d in ap.decisions][:2] == ["checkpoint_halt", "quarantine_rerun"]
    else:
        assert not any(k == "autopilot_decision" for k, _ in order)
    summary, _ = P.replay(log)
    assert summary["unactuated_decisions"] == []


# =============================================================================
# The watchdog's cap on abandoned workers
# =============================================================================


class TestWatchdogAbandonedCap:
    @BOTH
    def test_cap_refuses_to_arm_then_recovers(self, P, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_WATCHDOG_MAX_ABANDONED", "1")
        with P.chaos.chaos_scope("collective_hang~0.6*2"):
            with pytest.raises(P.watchdog.CollectiveTimeoutError):
                P.watchdog.guard_call(lambda: 1, (), fn_name="a", timeout_s=0.05)
            assert P.watchdog.abandoned_worker_count() == 1
            # Cap reached: the next dispatch runs UNguarded (no worker, no
            # timeout) with a warning: a bounded leak instead of a thread
            # per timeout.
            with pytest.warns(RuntimeWarning, match="abandoned worker"):
                assert P.watchdog.guard_call(lambda: 42, (), fn_name="b", timeout_s=0.05) == 42
            assert P.watchdog.abandoned_worker_count() == 1
        # Once the hung worker exits, arming resumes.
        deadline = time.monotonic() + 5.0
        while P.watchdog.abandoned_worker_count() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert P.watchdog.abandoned_worker_count() == 0
        assert P.watchdog.guard_call(lambda: 7, (), fn_name="c", timeout_s=5.0) == 7

    @BOTH
    def test_unguarded_metric(self, P, monkeypatch):
        P.monitor.enable()
        monkeypatch.setenv("THUNDER_TPU_WATCHDOG_MAX_ABANDONED", "0")
        with pytest.warns(RuntimeWarning):
            P.watchdog.guard_call(lambda: 1, (), fn_name="m", timeout_s=1.0)
        assert P.metrics.WATCHDOG_UNGUARDED.value() == 1


def test_port_abandoned_worker_skips_the_stale_call():
    """A worker the port's watchdog abandoned during an injected hang does
    not go on to run the call once the hang ends (a hung collective never
    completes): its effects would land beside the resumed run's."""
    ran = []
    with tchaos.chaos_scope("collective_hang~0.3"):
        with pytest.raises(twatchdog.CollectiveTimeoutError):
            twatchdog.guard_call(lambda: ran.append(1), (), fn_name="s", timeout_s=0.05)
    for t in list(twatchdog._abandoned):
        t.join(timeout=5.0)
    assert ran == []


# =============================================================================
# The retention of corrupt checkpoints
# =============================================================================


def _fake_quarantine(mgr, name, age):
    d = os.path.join(mgr.directory, name)
    os.makedirs(d)
    now = time.time()
    os.utime(d, (now - age, now - age))
    return d


class TestCorruptRetention:
    @BOTH
    def test_quarantines_fold_into_retention_sweep(self, P, tmp_path):
        # Retention is keyed on the STEP index (mtime only tiebreaks repeat
        # quarantines of one step): the newest-STEP quarantines survive,
        # though step 1's repeats carry the newest mtimes here.
        mgr = P.preemption.CheckpointManager(str(tmp_path), keep=2)
        old = [_fake_quarantine(mgr, f"step_0000000{i}.corrupt", 100 - i) for i in range(3)]
        _fake_quarantine(mgr, "step_00000001.corrupt.1", 10)
        newest = _fake_quarantine(mgr, "step_00000001.corrupt.2", 1)
        mgr.save({"x": P.array(np.ones(2, np.float32))}, 7)
        left = sorted(n for n in os.listdir(mgr.directory) if ".corrupt" in n)
        assert left == ["step_00000001.corrupt.2", "step_00000002.corrupt"]
        assert all(not os.path.exists(p) for p in old[:2])
        assert os.path.exists(newest)

    @BOTH
    def test_repeated_corruption_stays_bounded(self, P, tmp_path):
        """Corrupt, quarantine, resave, repeatedly: the directory must not
        grow without limit."""
        mgr = P.preemption.CheckpointManager(str(tmp_path), keep=2)
        state = {"x": P.array(np.ones(2, np.float32))}
        for round_ in range(5):
            mgr.save(state, round_ + 1)
            step_dir = mgr._step_dir(round_ + 1)
            for root, _, files in os.walk(step_dir):
                for f in files:
                    if f != mgr.META:
                        open(os.path.join(root, f), "w").close()
            try:
                mgr.restore()
            except Exception:
                pass
            time.sleep(0.01)  # distinct quarantine mtimes
        mgr.save(state, 99)
        assert len([n for n in os.listdir(mgr.directory) if ".corrupt" in n]) <= 2

    @BOTH
    def test_quarantine_sweep_is_primary_only(self, P, tmp_path, monkeypatch):
        mgr = P.preemption.CheckpointManager(str(tmp_path), keep=1)
        for i in range(3):
            _fake_quarantine(mgr, f"step_0000000{i}.corrupt", 50 - i)
        monkeypatch.setattr(P.preemption, "_is_primary", lambda: False)
        mgr.save({"x": P.array(np.ones(2, np.float32))}, 5)
        assert len([n for n in os.listdir(mgr.directory) if ".corrupt" in n]) == 3  # non-primary never GCs
