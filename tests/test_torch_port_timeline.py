"""The fleet timeline (``observability/timeline.py``) through both packages.

The cases of ``tests/test_timeline.py`` that need neither the ops plane nor
the autopilot nor ``scripts/perf_report.py`` (19 of them), each run once
through the JAX package and once through the port on the same records:
clock alignment from collective barriers, the step decomposition's
accounting identities, the bounded ledger, the live recorder and its
detector feed, the skew-corrected merge, the offline assembly, the static
wire split, the cross-check, the module lifecycle and the monitor
facades. Then the two packages' results on one set of records are compared
value for value, and skew recovery is held across 2 and 4 gloo ranks, each
rank a process with its own event log and an injected clock offset.
"""

import json
import os
import subprocess
import sys
import types

import pytest


def _package(name: str) -> types.SimpleNamespace:
    if name == "jax":
        import thunder_tpu.monitor as monitor
        from thunder_tpu.analysis.events import merge_event_logs
        from thunder_tpu.observability import timeline as tl
        from thunder_tpu.observability.detect import DetectorBank, DetectorConfig
    else:
        import thunder_tpu_torch.monitor as monitor
        from thunder_tpu_torch.analysis.events import merge_event_logs
        from thunder_tpu_torch.observability import timeline as tl
        from thunder_tpu_torch.observability.detect import DetectorBank, DetectorConfig
    return types.SimpleNamespace(name=name, monitor=monitor, tl=tl, merge_event_logs=merge_event_logs,
                                 DetectorBank=DetectorBank, DetectorConfig=DetectorConfig)


@pytest.fixture(params=["jax", "torch"])
def pk(request):
    p = _package(request.param)
    was = p.monitor.enabled()
    p.monitor.disable()
    p.monitor.reset()
    p.tl.disable()
    yield p
    p.tl.disable()
    p.monitor.reset()
    (p.monitor.enable if was else p.monitor.disable)()


def _barrier_records(offsets, n_barriers, *, base=1_000.0, spacing=1.0,
                     drift=None):
    """Synthetic multi-host barrier logs: every host completes rendezvous
    ``i`` at true time ``base + i*spacing``, stamped on its own (skewed,
    optionally drifting) clock."""
    drift = drift or {}
    records = []
    for i in range(n_barriers):
        true_ts = base + i * spacing
        for host, off in offsets.items():
            ts = true_ts + off + drift.get(host, 0.0) * (true_ts - base)
            records.append({"kind": "collective", "fn": "train_step",
                            "cid": i, "host": host, "ts": ts})
    return records


def _centered(offsets, skip=()):
    vals = sorted(v for h, v in offsets.items() if h not in skip)
    mid = len(vals) // 2
    med = vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])
    return {h: v - med for h, v in offsets.items()}


# =============================================================================
# Clock alignment
# =============================================================================


def test_skew_recovery_constant_offsets(pk):
    injected = {"a": 0.0, "b": 0.12, "c": -0.08, "d": 0.04}
    ests = pk.tl.estimate_skew(_barrier_records(injected, 10))
    assert set(ests) == set(injected)
    want = _centered(injected)
    for host, est in ests.items():
        assert abs(est.offset_s - want[host]) < 2e-3, host
        assert not est.outlier
        assert est.samples == 10
        assert est.confidence > 0.9
        assert est.mad_s < 1e-3


def test_skew_recovery_with_drift(pk):
    # Host b's clock runs fast by 1 ms of skew per second of wall clock on
    # top of a 100 ms constant offset; the estimator's per-host slope must
    # recover the drift rate while the non-drifting hosts stay near zero.
    injected = {"a": 0.0, "b": 0.10, "c": 0.0}
    ests = pk.tl.estimate_skew(
        _barrier_records(injected, 12, spacing=2.0, drift={"b": 1e-3})
    )
    assert abs(ests["b"].drift_s_per_s - 1e-3) < 3e-4
    assert abs(ests["a"].drift_s_per_s) < 3e-4
    assert abs(ests["c"].drift_s_per_s) < 3e-4


def test_skew_outlier_host_flagged(pk):
    # An unstable clock (alternating +-200 ms) has no constant offset; it
    # must be flagged as an outlier — and excluded from the re-centering —
    # while the stable hosts keep tight, confident estimates.
    stable = {"a": 0.0, "b": 0.04, "c": -0.04}
    records = _barrier_records(stable, 10)
    for i in range(10):
        records.append({"kind": "collective", "fn": "train_step", "cid": i,
                        "host": "noisy",
                        "ts": 1_000.0 + i + (0.2 if i % 2 else -0.2)})
    ests = pk.tl.estimate_skew(records)
    assert ests["noisy"].outlier
    assert ests["noisy"].mad_s > 0.05
    for host in stable:
        assert not ests[host].outlier, host
        assert ests[host].confidence > ests["noisy"].confidence
    # Centering used only the non-outlier hosts: their recovered offsets
    # match the stable-set centering, not one dragged by the wild clock.
    want = _centered(stable)
    for host in stable:
        assert abs(ests[host].offset_s - want[host]) < 0.03, host


def test_skew_min_samples_cut(pk):
    records = _barrier_records({"a": 0.0, "b": 0.05}, 6)
    # Host "late" shows up for only two rendezvous: below min_samples=3.
    for i in (4, 5):
        records.append({"kind": "collective", "fn": "train_step", "cid": i,
                        "host": "late", "ts": 1_000.0 + i + 0.01})
    ests = pk.tl.estimate_skew(records)
    assert "late" not in ests
    assert set(ests) == {"a", "b"}


def test_offsets_for_merge_and_apply(pk):
    injected = {"a": 0.0, "b": 0.12, "c": -0.08}
    ests = pk.tl.estimate_skew(_barrier_records(injected, 8))
    offsets = pk.tl.offsets_for_merge(ests)
    assert set(offsets) == set(injected)
    recs = [{"kind": "x", "host": "b", "ts": 10.0},
            {"kind": "x", "host": "zzz", "ts": 10.0}]
    shifted = pk.tl.apply_offsets(recs, offsets)
    assert shifted[0]["ts"] == pytest.approx(10.0 - offsets["b"])
    assert shifted[1]["ts"] == 10.0  # unknown host untouched
    assert recs[0]["ts"] == 10.0     # copies, not mutation


# =============================================================================
# Step decomposition
# =============================================================================


def test_decompose_step_accounting_identity(pk):
    bd = pk.tl.decompose_step(7, {
        "h0": {"total_s": 1.0},
        "h1": {"total_s": 1.0},
        "h2": {"total_s": 1.3, "ici_s": 0.2, "dcn_s": 0.1, "stall_s": 0.05,
               "compute_s": 0.5},
    })
    assert bd.step == 7 and bd.n_hosts == 3 and bd.slowest_host == "h2"
    assert set(bd.classes) == set(pk.tl.CLASSES)
    assert sum(bd.classes.values()) == pytest.approx(bd.total_s)
    assert bd.classes["straggler_wait"] == pytest.approx(0.3)
    assert bd.classes["exposed_ici"] == pytest.approx(0.2)
    assert bd.classes["exposed_dcn"] == pytest.approx(0.1)
    assert bd.classes["stall"] == pytest.approx(0.05)
    assert bd.classes["compute"] == pytest.approx(0.5)
    assert bd.classes["idle"] == pytest.approx(0.15)
    assert sum(bd.fractions().values()) == pytest.approx(1.0)


def test_decompose_step_compute_inferred_and_capped(pk):
    # No measured compute: the unaccounted budget becomes compute, idle 0.
    bd = pk.tl.decompose_step(0, {
        "h0": {"total_s": 1.0, "ici_s": 0.1, "dcn_s": 0.05, "stall_s": 0.05},
        "h1": {"total_s": 1.0},
    })
    assert bd.classes["compute"] == pytest.approx(0.8)
    assert bd.classes["idle"] == 0.0
    # Typed spans exceeding the median-lane budget are scaled down
    # proportionally — the accounting identity survives over-reporting.
    bd = pk.tl.decompose_step(1, {
        "h0": {"total_s": 1.0, "ici_s": 1.5, "dcn_s": 0.5},
        "h1": {"total_s": 1.0},
    })
    assert sum(bd.classes.values()) == pytest.approx(1.0)
    assert bd.classes["exposed_ici"] == pytest.approx(0.75)
    assert bd.classes["exposed_dcn"] == pytest.approx(0.25)
    assert pk.tl.decompose_step(2, {"h0": {"total_s": 0.0}}) is None


def test_decompose_step_two_host_median_halving(pk):
    # With two hosts the fleet median averages the pair, so only half the
    # lag counts as straggler-wait (the convention the soak's straggler
    # band threshold is calibrated against).
    bd = pk.tl.decompose_step(0, {"fast": {"total_s": 1.0},
                            "slow": {"total_s": 1.1}})
    assert bd.slowest_host == "slow"
    assert bd.classes["straggler_wait"] == pytest.approx(0.05)


# =============================================================================
# Bounded ledger
# =============================================================================


def _bd(pk, step, *, compute=0.8, straggler=0.0, host="h0", total=None):
    classes = {"compute": compute, "exposed_ici": 0.1, "exposed_dcn": 0.05,
               "straggler_wait": straggler, "stall": 0.03, "idle": 0.02}
    return pk.tl.StepBreakdown(step=step, total_s=total or sum(classes.values()),
                         classes=classes, slowest_host=host, n_hosts=4)


def test_ledger_fold_trend_and_attribution(pk):
    ledger = pk.tl.CritPathLedger(capacity=4, alpha=0.3)
    for i in range(6):
        ledger.fold(_bd(pk, i))
    for i in range(6, 10):
        ledger.fold(_bd(pk, i, compute=0.2, straggler=0.6, host="h3"))
    assert ledger.steps == 10
    assert len(ledger.ring) == 4  # bounded
    trend = ledger.trend()
    assert trend["straggler_wait"] > 0      # taking over
    assert trend["compute"] < 0             # receding
    snap = ledger.snapshot()
    assert snap["straggler_hosts"] == {"h3": 4}
    assert set(snap["fractions"]) == set(pk.tl.CLASSES)
    assert snap["steps"] == 10
    for row in snap["last_steps"]:
        assert set(row) == {"step", "total_s", "classes", "slowest_host",
                            "n_hosts"}
    assert "straggler" in ledger.format() or "critical path" in ledger.format()


# =============================================================================
# Live recorder
# =============================================================================


def test_recorder_recovers_emulated_skew(pk):
    injected = {"h0": 0.0, "h1": 0.12, "h2": -0.08, "h3": 0.04}
    rec = pk.tl.TimelineRecorder(emit_events=False, emulated_skew_s=injected)
    for cid in range(8):
        for host in injected:
            rec.note_collective(host, cid, fn="fleet_step", step=cid)
    ests = rec.skew_estimates()
    want = _centered(injected)
    assert set(ests) == set(injected)
    for host, est in ests.items():
        assert abs(est.offset_s - want[host]) < 5e-3, host
        assert not est.outlier
    health = rec.health_state()
    assert health["hosts"] == 4
    assert health["min_confidence"] >= 0.5
    assert health["outlier_hosts"] == []
    dbg = rec.debug_state()
    assert dbg["enabled"] and set(dbg) == {"enabled", "ledger", "skew",
                                           "crosscheck", "health"}


def test_recorder_seeded_straggler_trips_bottleneck_shift(pk):
    # Satellite (c): a seeded straggler fixture must trip bottleneck_shift
    # naming the right host through the DetectorBank feed.
    bank = pk.DetectorBank(pk.DetectorConfig(
        critpath_min_steps=3, critpath_straggler_frac=0.2,
        critpath_consecutive=2, critpath_cooldown=0,
    ))
    rec = pk.tl.TimelineRecorder(emit_events=False, bank=bank,
                           host_label=lambda h: f"host{h}")
    for step in range(10):
        spans = {h: {"total_s": 0.10, "ici_s": 0.01, "stall_s": 0.005}
                 for h in range(4)}
        if step >= 4:
            spans[3] = dict(spans[3], total_s=0.25)  # host 3 lags
        bd = rec.record_step(step, spans)
        assert bd is not None
    shifts = [a for a in bank.recent_anomalies()
              if a.kind == "bottleneck_shift"]
    assert shifts, "seeded straggler did not trip bottleneck_shift"
    named = [a for a in shifts if a.detector == "critpath_straggler_band"]
    assert named and all(a.suspect_host == "host3" for a in named)
    assert rec.ledger.snapshot()["straggler_hosts"].get(3, 0) >= 5


def test_bank_dominant_flip_raises_fleet_level_anomaly(pk):
    bank = pk.DetectorBank(pk.DetectorConfig(
        critpath_min_steps=3, critpath_consecutive=2, step_alpha=0.6,
    ))
    for step in range(4):
        bank.note_critpath_step(step, {"compute": 0.8, "exposed_ici": 0.2})
    for step in range(4, 12):
        bank.note_critpath_step(step, {"compute": 0.1, "exposed_ici": 0.9})
    doms = [a for a in bank.recent_anomalies()
            if a.detector == "critpath_dominant"]
    assert doms, "dominant-class flip did not raise bottleneck_shift"
    assert doms[0].kind == "bottleneck_shift"
    assert doms[0].fn == "compute->exposed_ici"
    assert doms[0].suspect_host is None  # fleet-level: any decision may cite


def test_bank_critpath_cooldown_rearm(pk):
    def run(cooldown):
        bank = pk.DetectorBank(pk.DetectorConfig(
            critpath_min_steps=2, critpath_straggler_frac=0.2,
            critpath_consecutive=2, critpath_cooldown=cooldown,
        ))
        for step in range(20):
            bank.note_critpath_step(step, {"compute": 0.4,
                                           "straggler_wait": 0.6},
                                    slowest_host="h1")
        return sum(1 for a in bank.recent_anomalies()
                   if a.detector == "critpath_straggler_band")

    # cooldown=0 re-alerts every `critpath_consecutive` steps while the
    # violation persists; a long cooldown collapses the run to one alert.
    assert run(0) > run(16) >= 1


# =============================================================================
# Skew-corrected merge + offline assembly
# =============================================================================


def test_merge_event_logs_offsets_fix_cross_host_ordering(pk, tmp_path):
    # Host 2's clock runs 0.8 s ahead: its event at true time 10.5 is
    # stamped 11.3, sorting after host 1's event at true 11.0. The offsets
    # map restores causal order without rewriting record contents.
    log1 = tmp_path / "host1.jsonl"
    log2 = tmp_path / "host2.jsonl"
    log1.write_text(
        json.dumps({"kind": "step_time", "host": 1, "pid": 1, "seq": 0,
                    "ts": 10.0, "step": 0}) + "\n"
        + json.dumps({"kind": "step_time", "host": 1, "pid": 1, "seq": 1,
                      "ts": 11.0, "step": 1}) + "\n")
    log2.write_text(
        json.dumps({"kind": "step_time", "host": 2, "pid": 2, "seq": 0,
                    "ts": 11.3, "step": 0}) + "\n")
    paths = [str(log1), str(log2)]
    unaligned, diags = pk.merge_event_logs(paths)
    assert not diags
    assert [r["host"] for r in unaligned] == [1, 1, 2]  # misordered
    aligned, _ = pk.merge_event_logs(paths, offsets={2: 0.8})
    assert [r["host"] for r in aligned] == [1, 2, 1]    # causal order
    assert aligned[1]["ts"] == 11.3  # ordering only; ts not rewritten


def test_assemble_timeline_offline_twin(pk):
    injected = {"h0": 0.0, "h1": 0.09}
    records = _barrier_records(injected, 8, spacing=1.0)
    for r in records:
        r["step"] = r["cid"]
        r["in_slice_s"] = 0.01
        r["cross_slice_s"] = 0.004
    for i in range(8):
        for host in injected:
            records.append({"kind": "step_time", "host": host, "step": i,
                            "ts": 1_000.0 + i, "fn": "train_step",
                            "s": 0.11 if (host == "h1" and i >= 4) else 0.08})
    records.append({"kind": "snapshot", "host": "h0", "step": 2,
                    "ts": 1_002.0, "stall_ms": 6.0})
    ledger, breakdowns, ests = pk.tl.ledger_from_records(records)
    assert ledger.steps == len(breakdowns) == 8
    assert abs(ests["h1"].offset_s - ests["h0"].offset_s
               - 0.09) < 5e-3  # pairwise skew recovered
    late = [bd for bd in breakdowns if bd.step >= 4]
    assert all(bd.slowest_host == "h1" for bd in late)
    assert all(bd.classes["straggler_wait"] > 0 for bd in late)
    assert all(sum(bd.classes.values()) == pytest.approx(bd.total_s)
               for bd in breakdowns)
    assert breakdowns[2].classes["stall"] > 0 or \
        breakdowns[2].slowest_host == "h1"  # stall charged when on-path


# =============================================================================
# Static wire split + cross-check
# =============================================================================


def test_split_static_wire_tiering(pk):
    site = lambda us, size: types.SimpleNamespace(wire_us=us, group_size=size)
    out = pk.tl.split_static_wire(
        [site(60.0, 4), site(30.0, 16), site(10.0, None)],
        devices_per_slice=4,
    )
    assert out["ici_us"] == pytest.approx(60.0)   # fits in one slice
    assert out["dcn_us"] == pytest.approx(40.0)   # larger or unknown group
    assert out["ici_frac"] + out["dcn_frac"] == pytest.approx(1.0)
    empty = pk.tl.split_static_wire([], devices_per_slice=4)
    assert empty["ici_frac"] == empty["dcn_frac"] == 0.0


def test_crosscheck_static_vs_measured(pk):
    rec = pk.tl.TimelineRecorder(emit_events=False)
    rec.set_static_wire(0.10, 0.05, static_exposed_pct=15.0)
    rec.predicted_exposed_pct = 15.0
    sp = rec.static_spans(1.0)
    assert sp["ici_s"] == pytest.approx(0.10)
    assert sp["compute_s"] == pytest.approx(0.85)
    for step in range(6):
        rec.record_step(step, {
            "h0": dict(sp, total_s=1.0),
            "h1": dict(sp, total_s=1.0),
        })
    cc = rec.crosscheck()
    assert cc["measured_exposed_pct"] == pytest.approx(15.0, abs=0.1)
    assert abs(cc["delta_static_pct"]) < 0.1
    assert abs(cc["delta_predicted_pct"]) < 0.1


# =============================================================================
# /healthz component + module lifecycle
# =============================================================================


def test_module_lifecycle(pk):
    assert pk.tl.current() is None
    assert pk.tl.debug_state() == {"enabled": False}
    assert pk.tl.health_state() is None
    rec = pk.tl.enable(emit_events=False)
    assert pk.tl.current() is rec
    assert pk.tl.debug_state()["enabled"] is True
    pk.tl.disable()
    assert pk.tl.current() is None


def test_monitor_facades(pk):
    rec = pk.monitor.critpath(emit_events=False)
    assert pk.tl.current() is rec
    rec.record_step(0, {"h0": {"total_s": 0.1}, "h1": {"total_s": 0.12}})
    report = pk.monitor.critpath_report()
    assert "critical path" in report
    pk.monitor.shutdown_critpath()
    assert pk.tl.current() is None


# =============================================================================
# The two packages on the same records
# =============================================================================


def test_both_packages_give_the_same_numbers():
    jx, pt = _package("jax"), _package("torch")
    assert pt.tl.CLASSES == jx.tl.CLASSES
    injected = {"h0": 0.0, "h1": 0.09, "h2": -0.05}
    records = _barrier_records(injected, 8, drift={"h2": 2e-4})
    for r in records:
        r["step"] = r["cid"]
        r["in_slice_s"] = 0.01
    for i in range(8):
        for host in injected:
            records.append({"kind": "step_time", "host": host, "step": i, "ts": 1_000.0 + i, "fn": "train_step",
                            "s": 0.11 if (host == "h1" and i >= 4) else 0.08})
    out = []
    for p in (jx, pt):
        ests = p.tl.estimate_skew(records)
        ledger, bds, _ = p.tl.ledger_from_records(records)
        out.append(({h: e.as_dict() for h, e in ests.items()}, [bd.as_dict() for bd in bds], ledger.snapshot()))
    assert out[0] == out[1]


# =============================================================================
# Skew recovery across gloo ranks
# =============================================================================

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_port_dist_worker.py")
SPAWN_TIMEOUT_S = 300


@pytest.mark.parametrize("world", [2, 4])
def test_skew_recovered_across_gloo_ranks(world, tmp_path):
    """Each rank arms ``monitor.critpath(emulated_skew_s={rank: offset})``
    and notes 12 all-reduce completions and steps; its event log carries its
    skewed clock. The merged logs give back the injected offsets (centered
    on the median rank) within 10 ms, every step's classes sum to its wall
    time, and the replay knows every record. The JAX package's estimator
    gives the same estimates from the same merged records."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "CUDA_VISIBLE_DEVICES")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, WORKER, "torch", str(r), str(world), store, str(tmp_path), "",
                               "timeline_skew"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        assert p.returncode == 0, p.stdout.read()[-4000:]
    jx = _package("jax")
    for r in range(world):
        res = json.load(open(tmp_path / f"rank{r}.json"))["timeline_skew"]
        assert res["ok"], res.get("error")
        injected = {str(h): off for h, off in enumerate(res["injected"])}
        want = _centered(injected)
        assert set(res["offsets"]) == set(want)
        for h, off in res["offsets"].items():
            assert abs(off - want[h]) < 10e-3, (h, off, want[h])
        assert all(abs(s - 1.0) < 1e-9 for s in res["sums"]), res["sums"]
        assert res["unknown_kinds"] == 0
        records, _ = jx.merge_event_logs([str(tmp_path / f"timeline{q}.jsonl") for q in range(world)])
        assert {str(h): e.offset_s for h, e in jx.tl.estimate_skew(records).items()} == res["offsets"]
