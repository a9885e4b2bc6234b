"""The live ops plane through both packages, on the CPU.

The 44 cases of ``tests/test_opsplane.py``, written once over a namespace
``P`` and run through the JAX package and the port
(``thunder_tpu_torch/observability/opsplane.py``): the flight recorder (the
ring, atomic dumps, retention, the dump at each fault class), the replay's
dump-marker contracts, the streaming detectors, the anomaly -> autopilot
path, and the HTTP ops server on a real ``127.0.0.1:0`` socket (``/metrics``,
``/healthz``, ``/debug/state``, ``/debug/flightrec``). Then the two cases of
``tests/test_timeline.py`` that waited for the ops plane and the autopilot
(the ``/healthz`` timeline component, the citation of a
``bottleneck_shift``).

Across the packages: a dump written by either package replays through
either package's replay to the same findings. The plane off costs the
dispatch fast path nothing: a cache hit reads the event taps zero times, and
an emit with no log reads them once.

Where the two differ, by design: the port's SDC re-run helper takes the
corruption seam as an argument, its terminal executor is ``torch``, and its
autopiloted halt runs on a mesh of one rank (the JAX test's on fsdp4·tp2 over
8 virtual devices: the state here is whole, as it is on every rank there).
"""

import glob
import json
import os
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import thunder_tpu as ttpu
import thunder_tpu.monitor as jmonitor
from thunder_tpu.analysis.diagnostics import Severity as JSeverity
from thunder_tpu.analysis.events import host_health as jhost_health
from thunder_tpu.analysis.events import replay_events as jreplay
from thunder_tpu.observability import detect as jdetect
from thunder_tpu.observability import events as jevents
from thunder_tpu.observability import metrics as jmetrics
from thunder_tpu.observability import opsplane as jops
from thunder_tpu.observability import timeline as jtimeline
from thunder_tpu.resilience import autopilot as jap
from thunder_tpu.resilience import chaos as jchaos
from thunder_tpu.resilience import deopt as jdeopt
from thunder_tpu.resilience import demotion as jdemotion
from thunder_tpu.resilience import preemption as jpreemption
from thunder_tpu.resilience import watchdog as jwatchdog

import thunder_tpu_torch as tt
import thunder_tpu_torch.monitor as tmonitor
from thunder_tpu_torch.analysis.diagnostics import Severity as TSeverity
from thunder_tpu_torch.analysis.events import host_health as thost_health
from thunder_tpu_torch.analysis.events import replay_events as treplay
from thunder_tpu_torch.observability import detect as tdetect
from thunder_tpu_torch.observability import events as tevents
from thunder_tpu_torch.observability import metrics as tmetrics
from thunder_tpu_torch.observability import opsplane as tops
from thunder_tpu_torch.observability import timeline as ttimeline
from thunder_tpu_torch.resilience import autopilot as tap
from thunder_tpu_torch.resilience import chaos as tchaos
from thunder_tpu_torch.resilience import deopt as tdeopt
from thunder_tpu_torch.resilience import demotion as tdemotion
from thunder_tpu_torch.resilience import preemption as tpreemption
from thunder_tpu_torch.resilience import watchdog as twatchdog


def _jax_sum2(a):
    import thunder_tpu.torch as ttorch

    return ttorch.sum(a * 2)


JAX = SimpleNamespace(name="jax", pkg=ttpu, monitor=jmonitor, Severity=JSeverity, host_health=jhost_health,
                      replay=jreplay, detect=jdetect, events=jevents, metrics=jmetrics, ops=jops, timeline=jtimeline,
                      ap=jap, chaos=jchaos, deopt=jdeopt, demotion=jdemotion, preemption=jpreemption,
                      watchdog=jwatchdog, jit=lambda f: ttpu.jit(f, executors=["jax"]), array=lambda a: a,
                      sum2=_jax_sum2)
PORT = SimpleNamespace(name="port", pkg=tt, monitor=tmonitor, Severity=TSeverity, host_health=thost_health,
                       replay=treplay, detect=tdetect, events=tevents, metrics=tmetrics, ops=tops,
                       timeline=ttimeline, ap=tap, chaos=tchaos, deopt=tdeopt, demotion=tdemotion,
                       preemption=tpreemption, watchdog=twatchdog,
                       jit=lambda f: tt.jit(f, device="cpu", executors=["torch"]), array=torch.from_numpy,
                       sum2=lambda a: torch.sum(a * 2))
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=lambda P: P.name)


@pytest.fixture(autouse=True)
def _ops_isolation():
    """Every test starts with both planes down, metrics off and zeroed, no
    quarantines, no de-opt high-water mark, no stale host-health summary."""
    was = {}
    for P in (JAX, PORT):
        was[P.name] = P.monitor.enabled()
        P.monitor.disable()
        P.monitor.reset()
        P.ops.disable()
        P.demotion.clear_quarantine()
        P.deopt.reset_process_state()
        P.watchdog.note_host_health(None)
        P.timeline.disable()
        P.ap.install(None)
    yield
    for P in (JAX, PORT):
        P.ops.disable()
        P.monitor.reset()
        P.demotion.clear_quarantine()
        P.deopt.reset_process_state()
        P.watchdog.note_host_health(None)
        P.timeline.disable()
        P.ap.install(None)
        (P.monitor.enable if was[P.name] else P.monitor.disable)()


def _errors(P, diags):
    return [d for d in diags if d.severity >= P.Severity.ERROR]


def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# =============================================================================
# Flight recorder
# =============================================================================


class TestFlightRecorder:
    @BOTH
    def test_ring_is_bounded_with_monotonic_seq(self, P, tmp_path):
        rec = P.ops.FlightRecorder(capacity=4, directory=str(tmp_path))
        for i in range(10):
            rec.record("step_time", {"fn": "f", "step": i, "s": 0.01})
        snap = rec.snapshot()
        assert len(snap) == 4
        assert [r["step"] for r in snap] == [6, 7, 8, 9]
        assert [r["seq"] for r in snap] == [6, 7, 8, 9]
        assert all(r["v"] == 1 and "ts" in r and "host" in r for r in snap)

    @BOTH
    def test_records_flow_without_an_event_log(self, P, tmp_path):
        # Context is kept even when THUNDER_TPU_EVENTS is unset.
        assert P.events.active_log() is None
        plane = P.ops.enable(serve=False, flightrec_dir=str(tmp_path))
        P.events.emit_event("step_time", fn="f", step=0, s=0.01)
        assert len(plane.recorder) == 1
        assert plane.recorder.snapshot()[0]["kind"] == "step_time"

    @BOTH
    def test_dump_is_schema_valid_and_replayable(self, P, tmp_path):
        rec = P.ops.FlightRecorder(directory=str(tmp_path))
        rec.record("step_time", {"fn": "f", "step": 1, "s": 0.01})
        # An injection whose recovery is still pending at dump time: the
        # trailer marker must satisfy the correlation rule.
        rec.record("fault_injected", {"seam": "sdc", "target": "leaf0", "n": 1})
        path = rec.dump("sdc")
        assert path and os.path.isfile(path)
        assert os.path.basename(path).startswith("flightrec-")
        assert not glob.glob(str(tmp_path / "*.tmp"))
        summary, diags = P.replay(path)
        assert _errors(P, diags) == []
        assert summary["unrecovered_faults"] == []
        assert summary["flightrec_dumps"] == 1
        last = json.loads(open(path).read().splitlines()[-1])
        assert last["kind"] == "flightrec_dump"
        assert last["reason"] == "sdc" and last["records"] == 2

    @BOTH
    def test_dump_retention_sweeps_old_dumps(self, P, tmp_path):
        rec = P.ops.FlightRecorder(directory=str(tmp_path), keep=2)
        for i in range(3):
            rec.record("step_time", {"fn": "f", "step": i, "s": 0.01})
            assert rec.dump("manual")
            time.sleep(0.01)
        assert len(glob.glob(str(tmp_path / "flightrec-*.jsonl"))) == 2

    @BOTH
    def test_dump_dedupes_without_new_records(self, P, tmp_path):
        rec = P.ops.FlightRecorder(directory=str(tmp_path))
        rec.record("step_time", {"fn": "f", "step": 0, "s": 0.01})
        assert rec.dump("collective_timeout") is not None
        # The same fault unwinding through a second trigger: no second dump,
        # but an explicit manual dump always lands.
        assert rec.dump("dispatch_fault") is None
        assert rec.dump("manual") is not None

    @BOTH
    def test_flight_dump_is_noop_with_plane_off(self, P):
        assert P.events.flight_dump("manual") is None
        assert not P.events.ops_active()

    @BOTH
    def test_dump_io_failure_degrades_silently(self, P, tmp_path):
        blocker = tmp_path / "blocked"
        blocker.write_text("not a directory")
        rec = P.ops.FlightRecorder(directory=str(blocker))
        rec.record("step_time", {"fn": "f", "step": 0, "s": 0.01})
        with pytest.warns(UserWarning, match="flight recorder disabled"):
            assert rec.dump("manual") is None
        assert rec.dump("manual") is None  # dead, still never raises


# =============================================================================
# Dump triggers, a fault class each
# =============================================================================


class _AlwaysDivergent:
    max_reruns = 1

    def check_state(self, state):
        return {"leaf0": {"(0,)": {0: 1, 1: 2}}}

    def loss_suspect(self, loss):
        return False


def _sdc_exhaustion(P):
    if P is JAX:
        P.preemption._sdc_check_and_rerun(_AlwaysDivergent(), lambda s: (s, 0.0), {}, {}, 0.0, 3)
    else:
        P.preemption._sdc_check_and_rerun(_AlwaysDivergent(), lambda s: (s, 0.0), lambda s: s, {}, {}, 0.0, 3)


class TestDumpTriggers:
    @BOTH
    def test_watchdog_timeout_dumps(self, P, tmp_path):
        P.ops.enable(serve=False, flightrec_dir=str(tmp_path))
        with P.chaos.chaos_scope("collective_hang~0.6"):
            with pytest.raises(P.watchdog.CollectiveTimeoutError):
                P.watchdog.guard_call(lambda: None, (), fn_name="step", timeout_s=0.05)
        dumps = glob.glob(str(tmp_path / "*-collective_timeout.jsonl"))
        assert len(dumps) == 1
        summary, diags = P.replay(dumps[0])
        assert _errors(P, diags) == []
        assert summary["kinds"]["collective_timeout"] == 1
        assert summary["kinds"]["fault_injected"] == 1

    @BOTH
    def test_sdc_exhaustion_dumps(self, P, tmp_path):
        P.ops.enable(serve=False, flightrec_dir=str(tmp_path))
        with pytest.raises(P.watchdog.SDCDetectedError):
            _sdc_exhaustion(P)
        dumps = glob.glob(str(tmp_path / "*-sdc.jsonl"))
        assert len(dumps) == 1
        summary, diags = P.replay(dumps[0])
        assert _errors(P, diags) == []
        # The failed re-run chain is in the box; the pending recovery is
        # satisfied by the dump marker, not lost.
        assert summary["kinds"]["sdc_suspect"] == 1
        assert summary["kinds"]["sdc_rerun"] == 1

    @BOTH
    def test_unhandled_dispatch_fault_dumps(self, P, tmp_path):
        P.ops.enable(serve=False, flightrec_dir=str(tmp_path))

        def boom(x):
            raise ValueError("user bug")

        jf = P.jit(boom)
        with pytest.raises(ValueError, match="user bug"):
            jf(P.array(np.ones(2, np.float32)))
        assert len(glob.glob(str(tmp_path / "*-dispatch_fault.jsonl"))) == 1

    @BOTH
    def test_autopilot_halt_dumps(self, P, tmp_path):
        P.ops.enable(serve=False, flightrec_dir=str(tmp_path / "fr"))
        w = np.arange(32, dtype=np.float32).reshape(8, 4) * 0.01
        b = np.ones(4, np.float32)
        if P is JAX:
            import jax
            import jax.numpy as jnp
            from jax.sharding import NamedSharding, PartitionSpec

            from thunder_tpu.parallel import make_mesh
            from thunder_tpu.parallel.sharding import shard_pytree

            mesh = make_mesh(fsdp=4, tp=2)
            specs = {"w": PartitionSpec("fsdp", "tp"), "b": PartitionSpec()}
            state0 = shard_pytree({"w": w, "b": b}, mesh, specs)
            shd = {k: NamedSharding(mesh, s) for k, s in specs.items()}

            @jax.jit
            def _step(state):
                return state, jnp.mean((state["w"] @ state["b"]) ** 2)

            def step_fn(state):
                new, loss = _step(state)
                return {k: jax.device_put(v, shd[k]) for k, v in new.items()}, float(np.asarray(loss))
        else:
            from thunder_tpu_torch.distributed.runtime import P as Spec
            from thunder_tpu_torch.parallel import make_mesh

            mesh = make_mesh()
            specs = {"w": Spec(), "b": Spec()}
            state0 = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}

            def step_fn(state):
                return state, float(torch.mean((state["w"] @ state["b"]) ** 2))

        with P.chaos.chaos_scope("preempt@2"):
            with pytest.raises(P.ap.AutopilotHalt):
                P.ap.run_autopiloted_training(
                    P.ap.Autopilot(), lambda m: step_fn, state0, 6,
                    manager=P.preemption.CheckpointManager(str(tmp_path / "ck")),
                    mesh=mesh, specs_for_mesh=lambda m: specs, sdc_guard=False)
        dumps = glob.glob(str(tmp_path / "fr" / "*-autopilot_halt.jsonl"))
        assert len(dumps) == 1
        summary, diags = P.replay(dumps[0])
        assert _errors(P, diags) == []
        assert summary["kinds"]["autopilot_decision"] >= 1


@pytest.mark.parametrize("writer", [JAX, PORT], ids=lambda P: f"dump-of-{P.name}")
def test_a_dump_replays_alike_in_either_package(writer, tmp_path):
    """A dump of an SDC exhaustion and of a watchdog timeout, written by
    either package: both replays give the same findings."""
    writer.ops.enable(serve=False, flightrec_dir=str(tmp_path))
    with pytest.raises(writer.watchdog.SDCDetectedError):
        _sdc_exhaustion(writer)
    with writer.chaos.chaos_scope("collective_hang~0.4"):
        with pytest.raises(writer.watchdog.CollectiveTimeoutError):
            writer.watchdog.guard_call(lambda: None, (), fn_name="step", timeout_s=0.05)
    dumps = sorted(glob.glob(str(tmp_path / "flightrec-*.jsonl")))
    assert len(dumps) == 2
    for path in dumps:
        found = []
        for R in (JAX, PORT):
            summary, diags = R.replay(path)
            found.append((summary["kinds"], summary["unrecovered_faults"], summary["unactuated_decisions"],
                          summary["flightrec_dumps"], summary["faults_injected"],
                          sorted(d.rule for d in _errors(R, diags))))
        assert found[0] == found[1]
        assert found[0][3] == 1 and found[0][5] == []


# =============================================================================
# Replay contracts: schema rows and dump-marker leniency
# =============================================================================


def _lines(tmp_path, records):
    p = tmp_path / "log.jsonl"
    base = {"v": 1, "ts": 1.0, "seq": 0, "pid": 1, "host": 0}
    with open(p, "w") as f:
        for i, rec in enumerate(records):
            f.write(json.dumps(dict(base, ts=float(i), seq=i, **rec)) + "\n")
    return str(p)


class TestReplayContracts:
    @BOTH
    def test_anomaly_schema_row(self, P, tmp_path):
        good = {"kind": "anomaly", "anomaly": "step_time_drift", "severity": "warn", "value": 0.08,
                "baseline": 0.01, "window": [0.01, 0.08]}
        summary, diags = P.replay(_lines(tmp_path, [good]))
        assert _errors(P, diags) == []
        assert summary["anomalies"] == {"step_time_drift": 1}
        bad = {k: v for k, v in good.items() if k != "severity"}
        _, diags = P.replay(_lines(tmp_path, [bad]))
        assert any(d.rule == "events.missing-fields" for d in _errors(P, diags))

    @BOTH
    def test_dump_marker_satisfies_pending_fault(self, P, tmp_path):
        fault = {"kind": "fault_injected", "seam": "sdc", "target": "leaf0", "n": 1}
        summary, diags = P.replay(_lines(tmp_path, [fault]))
        assert summary["unrecovered_faults"] == ["sdc@leaf0"]
        assert any(d.rule == "events.unrecovered-fault" for d in diags)
        marker = {"kind": "flightrec_dump", "reason": "sdc", "records": 1}
        summary, diags = P.replay(_lines(tmp_path, [fault, marker]))
        assert summary["unrecovered_faults"] == []
        assert _errors(P, diags) == []

    @BOTH
    def test_dump_marker_before_fault_does_not_satisfy(self, P, tmp_path):
        records = [{"kind": "flightrec_dump", "reason": "manual", "records": 0},
                   {"kind": "fault_injected", "seam": "sdc", "target": "leaf0", "n": 1}]
        summary, _ = P.replay(_lines(tmp_path, records))
        assert summary["unrecovered_faults"] == ["sdc@leaf0"]

    @BOTH
    def test_dump_marker_satisfies_pending_decision(self, P, tmp_path):
        decision = {"kind": "autopilot_decision", "decision_id": 1, "signal": "host_loss",
                    "actuator": "elastic_resume"}
        summary, _ = P.replay(_lines(tmp_path, [decision]))
        assert summary["unactuated_decisions"] == ["elastic_resume<-host_loss"]
        marker = {"kind": "flightrec_dump", "reason": "autopilot_halt", "records": 1}
        summary, diags = P.replay(_lines(tmp_path, [decision, marker]))
        assert summary["unactuated_decisions"] == []
        assert _errors(P, diags) == []


# =============================================================================
# Streaming detectors
# =============================================================================


class TestDetectors:
    @BOTH
    def test_cusum_steady_stream_is_quiet(self, P):
        det = P.detect.CusumDetector(min_samples=6)
        rng = np.random.RandomState(0)
        assert not any(det.update(0.01 + rng.randn() * 2e-4) for _ in range(200))

    @BOTH
    def test_cusum_detects_sustained_shift_and_freezes_baseline(self, P):
        det = P.detect.CusumDetector(min_samples=6)
        for _ in range(20):
            det.update(0.010)
        baseline = det.stat.mean
        hit = None
        for _ in range(10):
            hit = hit or det.update(0.050)
        assert hit is not None
        assert hit["value"] == 0.050
        # Anomalous samples must not teach the baseline that slow is normal.
        assert det.stat.mean == pytest.approx(baseline)

    @BOTH
    def test_cusum_cooldown_bounds_refire_rate(self, P):
        det = P.detect.CusumDetector(min_samples=6, cooldown=16)
        for _ in range(10):
            det.update(0.010)
        assert sum(1 for _ in range(14) if det.update(0.050)) == 1
        assert sum(1 for _ in range(20) if det.update(0.050)) <= 2

    @BOTH
    def test_goodput_drift_detector(self, P):
        det = P.detect.DriftDetector(min_samples=6, consecutive=3)
        for _ in range(10):
            assert det.update(0.010) is None
        hit = None
        for _ in range(8):
            hit = hit or det.update(0.030)
        assert hit is not None and hit["ratio"] >= det.factor

    @BOTH
    def test_rate_detector_storm(self, P):
        det = P.detect.RateDetector(window_s=60.0, threshold=3)
        t = 1000.0
        assert det.tick(t) is None
        assert det.tick(t + 1) is None
        hit = det.tick(t + 2)
        assert hit is not None and hit["value"] == 3.0
        assert det.tick(t + 3) is None  # cleared on firing: one storm, one anomaly

    @BOTH
    def test_rate_detector_window_expiry(self, P):
        det = P.detect.RateDetector(window_s=10.0, threshold=3)
        assert det.tick(0.0) is None
        assert det.tick(1.0) is None
        assert det.tick(100.0) is None  # the first two fell out the window

    @BOTH
    def test_accumulator_matches_offline_host_health(self, P):
        rng = np.random.RandomState(1)
        records = []
        for step in range(12):
            for host in range(4):
                s = (0.4 if host == 3 else 0.1) + rng.rand() * 1e-3
                records.append({"v": 1, "ts": float(step), "seq": step, "pid": 1, "host": host,
                                "kind": "step_time", "fn": "step", "step": step, "s": s})
        summary, diags = P.host_health(records, spread_threshold=1.5)
        acc = P.detect.HostHealthAccumulator()
        for rec in records:
            acc.add(rec["host"], float(rec["s"]))
        assert summary["hosts"] == acc.host_stats()
        median, spread = acc.spread()
        assert summary["spread_ratio"] == round(spread, 4)
        assert summary["stragglers"] == [3]
        assert any(d.rule == "events.straggler-suspect" for d in diags)

    @BOTH
    def test_bank_step_anomaly_event_and_autopilot_note(self, P, tmp_path):
        log = str(tmp_path / "ev.jsonl")
        P.monitor.set_event_log(log)
        bank = P.detect.DetectorBank(P.detect.DetectorConfig(min_samples=6, cooldown=4))
        P.events.set_ops_taps((bank.consume,))
        ap = P.ap.Autopilot()
        try:
            with ap.installed():
                for i in range(30):
                    P.events.emit_event("step_time", fn="step", step=i, s=0.010 if i < 12 else 0.060)
        finally:
            P.events.set_ops_taps(())
            P.monitor.set_event_log(None)
        assert "step_time_drift" in {a.kind for a in bank.recent_anomalies()}
        summary, diags = P.replay(log)
        assert _errors(P, diags) == []
        assert summary["anomalies"].get("step_time_drift", 0) >= 1
        # The autopilot consumed them: the strikes flag this host.
        assert ap.debug_state()["anomalies"]
        assert ap.flagged_stragglers()

    @BOTH
    def test_bank_recompile_storm(self, P):
        bank = P.detect.DetectorBank(P.detect.DetectorConfig(recompile_threshold=2, recompile_window_s=600.0))
        bank.consume("compile_end", {"fn": "f", "recompile": False})
        assert not bank.recent_anomalies()
        bank.consume("compile_end", {"fn": "f", "recompile": True})
        bank.consume("compile_end", {"fn": "f", "recompile": True})
        assert [a.kind for a in bank.recent_anomalies()] == ["recompile_storm"]

    @BOTH
    def test_bank_spread_anomaly_names_slow_host(self, P):
        bank = P.detect.DetectorBank(P.detect.DetectorConfig(min_samples=50, spread_min_steps=4,
                                                             spread_consecutive=2))
        for step in range(8):
            for host in range(2):
                bank.consume("step_time", {"fn": "step", "step": step, "host": host,
                                           "s": 0.4 if host == 1 else 0.1})
        spread = [a for a in bank.recent_anomalies() if a.kind == "host_spread"]
        assert spread and spread[0].suspect_host == 1
        st = bank.spread_state()
        assert st["stragglers"] == [1] and st["spread_ratio"] > 1.5


# =============================================================================
# Anomaly -> autopilot policy signal
# =============================================================================


def _anomaly(kind="step_time_drift", host=None, sev="warn"):
    return {"anomaly": kind, "severity": sev, "ts": time.time(), "value": 0.06, "baseline": 0.01,
            "suspect_host": host}


class TestAutopilotAnomaly:
    @BOTH
    def test_decide_cites_relevant_anomaly(self, P):
        ap = P.ap.Autopilot()
        ap.note_anomaly(_anomaly())
        cited = ap.decide(P.ap.Signal("collective_hang")).signal.evidence.get("anomaly")
        assert cited and cited["anomaly"] == "step_time_drift"
        assert cited["ts"] is not None

    @BOTH
    def test_irrelevant_anomaly_not_cited(self, P):
        ap = P.ap.Autopilot()
        ap.note_anomaly(_anomaly(kind="recompile_storm"))
        d = ap.decide(P.ap.Signal("collective_hang"))
        assert "anomaly" not in (d.signal.evidence or {})
        d2 = ap.decide(P.ap.Signal("oom"))
        assert d2.signal.evidence["anomaly"]["anomaly"] == "recompile_storm"

    @BOTH
    def test_host_mismatch_not_cited(self, P):
        ap = P.ap.Autopilot()
        ap.note_anomaly(_anomaly(host=2))
        d = ap.decide(P.ap.Signal("collective_hang", suspect_host=5))
        assert "anomaly" not in (d.signal.evidence or {})

    @BOTH
    def test_stale_anomaly_not_cited(self, P):
        ap = P.ap.Autopilot()
        a = _anomaly()
        a["ts"] = time.time() - 10_000.0
        ap.note_anomaly(a)
        assert "anomaly" not in (ap.decide(P.ap.Signal("collective_hang")).signal.evidence or {})

    @BOTH
    def test_anomaly_strikes_skip_gentle_rung(self, P):
        # Two warn anomalies naming host 3 flag it like two host_health
        # summaries would: the next hang skips the same-mesh retry.
        ap = P.ap.Autopilot()
        ap.note_anomaly(_anomaly(host=3))
        ap.note_anomaly(_anomaly(host=3, kind="goodput_drop"))
        assert 3 in ap.flagged_stragglers()
        d = ap.decide(P.ap.Signal("collective_hang", suspect_host=3))
        assert d.rung == 1 and d.mode == "shrink"

    @BOTH
    def test_info_anomaly_does_not_strike(self, P):
        ap = P.ap.Autopilot()
        ap.note_anomaly(_anomaly(host=3, sev="info"))
        ap.note_anomaly(_anomaly(host=3, sev="info"))
        assert 3 not in ap.flagged_stragglers()

    @BOTH
    def test_anomaly_flags_decay_with_time(self, P):
        # No host_health summary clears anomaly strikes, so they decay on
        # their own: a transiently slow host earns its gentle rung back.
        ap = P.ap.Autopilot()
        old = time.time() - ap.anomaly_strike_window_s - 1.0
        for _ in range(2):
            a = _anomaly(host=3)
            a["ts"] = old
            ap.note_anomaly(a)
        assert 3 not in ap.flagged_stragglers()
        ap.note_anomaly(_anomaly(host=3))
        ap.note_anomaly(_anomaly(host=3))
        assert 3 in ap.flagged_stragglers()

    @BOTH
    def test_anomaly_and_health_ledgers_are_independent(self, P):
        ap = P.ap.Autopilot()
        ap.note_anomaly(_anomaly(host=3))
        ap.note_anomaly(_anomaly(host=3))
        ap.note_host_health({"stragglers": [], "spread_ratio": 1.0})
        assert 3 in ap.flagged_stragglers()


# =============================================================================
# The HTTP ops server and the health verdict
# =============================================================================


class TestOpsServer:
    @BOTH
    def test_metrics_endpoint_host_labels_and_always_export(self, P, tmp_path):
        plane = P.ops.enable(port=0, serve=True, flightrec_dir=str(tmp_path))
        code, body = _get(plane.port, "/metrics")
        assert code == 200
        # The metrics gate is OFF, yet the always-export drop counter's 0 is
        # on the wire, host/pid-labelled.
        assert "thunder_tpu_event_log_dropped_total" in body
        drop_lines = [ln for ln in body.splitlines() if ln.startswith("thunder_tpu_event_log_dropped_total")]
        assert any('host="' in ln and ln.endswith(" 0") for ln in drop_lines)

    @BOTH
    def test_prometheus_always_export_tracks_increments(self, P):
        text = P.monitor.prometheus_text()
        assert "thunder_tpu_event_log_dropped_total 0" in text
        P.metrics.EVENT_LOG_DROPPED.inc_always(2)
        text = P.monitor.prometheus_text()
        assert "thunder_tpu_event_log_dropped_total 2" in text
        assert "thunder_tpu_event_log_dropped_total 0" not in text

    @BOTH
    def test_healthz_ok_then_degrades_on_sink_loss(self, P, tmp_path):
        plane = P.ops.enable(port=0, serve=True, flightrec_dir=str(tmp_path))
        code, body = _get(plane.port, "/healthz")
        assert code == 200
        assert json.loads(body)["components"]["event_log"]["status"] == "ok"
        P.metrics.EVENT_LOG_DROPPED.inc_always()
        code, body = _get(plane.port, "/healthz")
        v = json.loads(body)
        assert v["components"]["event_log"]["status"] == "degraded"
        assert v["status"] in ("degraded", "critical")
        assert any("sink" in r for r in v["reasons"])

    @BOTH
    def test_healthz_deopt_and_quarantine_components(self, P, tmp_path):
        plane = P.ops.enable(port=0, serve=True, flightrec_dir=str(tmp_path))
        P.deopt._process_state["max_level"] = 2
        P.demotion.quarantine("linear", "pallas", ttl=60)
        _, body = _get(plane.port, "/healthz")
        v = json.loads(body)
        assert v["components"]["deopt"] == {"status": "degraded", "max_level": 2}
        assert v["components"]["quarantine"]["status"] == "degraded"
        _, body = _get(plane.port, "/debug/state")
        assert json.loads(body)["quarantine"] == {"linear|pallas": pytest.approx(60, abs=5)}

    @BOTH
    def test_healthz_anomaly_component(self, P, tmp_path):
        plane = P.ops.enable(port=0, serve=True, flightrec_dir=str(tmp_path),
                             detectors=P.detect.DetectorConfig(min_samples=6, cooldown=8))
        for i in range(20):
            P.events.emit_event("step_time", fn="step", step=i, s=0.010 if i < 10 else 0.018)
        _, body = _get(plane.port, "/healthz")
        v = json.loads(body)
        assert v["components"]["anomalies"]["recent"]
        assert v["status"] != "ok"

    @BOTH
    def test_healthz_inflight_flush_component(self, P, tmp_path):
        mgr = P.preemption.CheckpointManager(str(tmp_path / "ck"))
        mgr._inflight_step = 12
        mgr._inflight_since = time.monotonic() - 100.0
        try:
            ours = [f for f in P.preemption.inflight_flushes() if f["step"] == 12]
            assert ours and ours[0]["for_s"] > 99
            assert P.ops.health_verdict()["components"]["checkpoint"]["status"] == "degraded"
        finally:
            mgr._inflight_step = None
            mgr._inflight_since = None

    @BOTH
    def test_debug_state_lists_live_functions(self, P, tmp_path):
        jf = P.jit(P.sum2)
        jf(P.array(np.ones((2, 2), np.float32)))
        plane = P.ops.enable(port=0, serve=True, flightrec_dir=str(tmp_path))
        _, body = _get(plane.port, "/debug/state")
        state = json.loads(body)
        assert any(f["calls"] >= 1 for f in state["cache"])
        assert state["detectors"]["consumed"] == 0
        assert state["flight_recorder"]["capacity"] == 512

    @BOTH
    def test_debug_flightrec_and_unknown_route(self, P, tmp_path):
        plane = P.ops.enable(port=0, serve=True, flightrec_dir=str(tmp_path))
        P.events.emit_event("step_time", fn="f", step=0, s=0.01)
        code, body = _get(plane.port, "/debug/flightrec")
        assert code == 200
        path = json.loads(body)["path"]
        assert path and os.path.isfile(path)
        code, _ = _get(plane.port, "/nope")
        assert code == 404

    @BOTH
    def test_shutdown_uninstalls_everything(self, P, tmp_path):
        plane = P.ops.enable(port=0, serve=True, flightrec_dir=str(tmp_path))
        port = plane.port
        assert P.events.ops_active()
        P.monitor.shutdown_ops()
        assert not P.events.ops_active()
        assert P.ops.current() is None
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)
        P.events.emit_event("step_time", fn="f", step=0, s=0.01)  # a no-op, not a crash

    @BOTH
    def test_bind_failure_installs_nothing(self, P, tmp_path):
        # Occupy a port, then ask the plane to bind it: the failed enable
        # must leave NO taps armed.
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        try:
            with pytest.raises(OSError):
                P.ops.enable(port=s.getsockname()[1], serve=True, flightrec_dir=str(tmp_path))
        finally:
            s.close()
        assert P.ops.current() is None
        assert not P.events.ops_active()

    @BOTH
    def test_env_autostart(self, P, tmp_path, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_OPS_PORT", "0")
        monkeypatch.setitem(P.ops._state, "autostarted", False)
        plane = P.ops.maybe_autostart()
        assert plane is not None and plane.port > 0
        assert P.ops.maybe_autostart() is plane  # the second call returns the live plane


def test_port_jit_autostarts_the_plane(monkeypatch, tmp_path):
    """``THUNDER_TPU_OPS_PORT`` arms the port's plane at its first ``jit``
    (the JAX package's ``_ensure_runtime`` does it there too)."""
    monkeypatch.setenv("THUNDER_TPU_OPS_PORT", "0")
    monkeypatch.setenv("THUNDER_TPU_FLIGHTREC_DIR", str(tmp_path))
    monkeypatch.setitem(tops._state, "autostarted", False)
    tt.jit(lambda a: a + 1, device="cpu")
    plane = tops.current()
    assert plane is not None and plane.port > 0
    assert _get(plane.port, "/healthz")[0] == 200


@BOTH
def test_plane_off_costs_the_fast_path_nothing(P, monkeypatch):
    """With the plane off the taps stay empty, a cache hit reads the event
    taps zero times and an emit with no log reads them once."""

    class Counting(dict):
        reads = 0

        def __getitem__(self, key):
            Counting.reads += 1
            return super().__getitem__(key)

    jf = P.jit(P.sum2)
    x = P.array(np.ones((2, 2), np.float32))
    jf(x)  # the miss compiles; what follows is a hit
    assert P.events.ops_taps() == ((), None) and not P.events.ops_active()
    monkeypatch.setattr(P.events, "_ops", Counting(P.events._ops))
    jf(x)
    assert Counting.reads == 0
    P.events.emit_event("step_time", fn="f", step=0, s=0.01)
    assert Counting.reads == 1


# =============================================================================
# The two timeline cases that waited for the ops plane and the autopilot
# =============================================================================


@BOTH
def test_healthz_timeline_component_degrades(P):
    assert "timeline" not in P.ops.health_verdict()["components"]  # not armed
    rec = P.timeline.enable(emit_events=False)
    rec.record_step(0, {"solo": {"total_s": 0.1}})
    comp = P.ops.health_verdict()["components"]["timeline"]
    assert comp["status"] == "degraded"  # <2 hosts: nothing to decompose
    assert comp["hosts"] == 1
    injected = {"h0": 0.0, "h1": 0.03}
    rec = P.timeline.enable(emit_events=False, emulated_skew_s=injected)
    for cid in range(8):
        for host in injected:
            rec.note_collective(host, cid)
    rec.record_step(0, {h: {"total_s": 0.1} for h in injected})
    comp = P.ops.health_verdict()["components"]["timeline"]
    assert comp["status"] == "ok"
    assert comp["hosts"] == 2 and comp["steps"] == 1


@BOTH
def test_autopilot_cites_bottleneck_shift(P):
    ap = P.ap.Autopilot()
    ap.note_anomaly({"anomaly": "bottleneck_shift", "severity": "warn", "ts": time.time(), "value": 0.3,
                     "baseline": 0.06, "suspect_host": "slice1"})
    cited = ap.decide(P.ap.Signal("slice_loss", step=10, suspect_host="slice1")).signal.evidence.get("anomaly")
    assert cited and cited["anomaly"] == "bottleneck_shift"
    assert cited["suspect_host"] == "slice1"
    # A decision naming a different host must NOT cite the host-matched
    # anomaly (strikes would land on the wrong ledger).
    d2 = ap.decide(P.ap.Signal("slice_loss", step=11, suspect_host="slice0"))
    assert "anomaly" not in (d2.signal.evidence or {})
