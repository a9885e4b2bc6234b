"""The soak scripts (``thunder_tpu_torch/scripts/soak_fleet.py``,
``soak_pod.py``) and lint's ``--soak``/``--federation`` checks against the
JAX package's ``scripts/``, in one process on the CPU.

- ``tests/test_autopilot.py``'s ``TestSoakSchedule`` cases that test the
  scripts (deterministic per seed, coverage and overlap, the preempt never
  in the overlap tail, ``arm_fault``'s rules on each package's
  ``ChaosConfig``, the ``soak_ok`` gate) through both packages. scripts;
  its two ``perf_report`` cases wait for the port's benchmark PR.
- ``make_schedule`` gives the JAX script's schedule fault for fault (step,
  seam and target) for seeds 0-30 at (200, 14, 2), (40, 11) and (60, 10,
  4); ``pod_ok`` agrees with the JAX script's on the same results.
- lint's required-key tuples, policy classes and stall cap are the JAX
  CLI's (read from its source); its split checks count an error for each
  doctored result; the torn-write fall-through passes.
- The straggler: the JAX smoke at seed 7 missed it. Its ``step_time``
  samples before the straggler (steps 0-11, pasted below from that run's
  event log) taught the detectors a baseline of 27-138 ms, against a clean
  step of 21.4 ms, so its fixed 60 ms raised no anomaly in 5 slowed steps;
  the port's delay, 8 clean steps, does. Both through the port's
  ``DetectorBank`` with the soak's ``DetectorConfig``.
"""

import ast
import json
import os
import sys

import pytest
import torch

from thunder_tpu_torch.resilience.chaos import ChaosConfig as TChaosConfig
from thunder_tpu_torch.scripts import lint_traces
from thunder_tpu_torch.scripts import soak_fleet as tsf
from thunder_tpu_torch.scripts import soak_pod as tsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


@pytest.fixture(scope="module")
def jax_scripts():
    """The JAX package's ``soak_fleet`` and ``soak_pod`` from ``scripts/``,
    imported as ``TestSoakSchedule`` imports them."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import soak_fleet
    import soak_pod

    return soak_fleet, soak_pod


@pytest.fixture(params=["jax", "torch"])
def sf(request, jax_scripts):
    return jax_scripts[0] if request.param == "jax" else tsf


def _chaos_config(sf):
    if sf is tsf:
        return TChaosConfig(rules=[], seed=0)
    from thunder_tpu.resilience.chaos import ChaosConfig

    return ChaosConfig(rules=[], seed=0)


# =============================================================================
# TestSoakSchedule's cases, through both packages
# =============================================================================


def test_deterministic_per_seed(sf):
    a = sf.make_schedule(7, 200, 14)
    b = sf.make_schedule(7, 200, 14)
    c = sf.make_schedule(8, 200, 14)
    assert [(f.step, f.seam) for f in a] == [(f.step, f.seam) for f in b]
    assert [(f.step, f.seam) for f in a] != [(f.step, f.seam) for f in c]


def test_coverage_and_overlap(sf):
    for seed in (1, 7, 23):
        sched = sf.make_schedule(seed, 200, 14, overlap_pairs=2)
        assert len(sched) == 14
        seams = {f.seam for f in sched}
        assert set(sf.REQUIRED_SEAMS) <= seams
        assert sf.overlapping_pairs(sched) >= 2
        by = [f.seam for f in sched]
        assert by.count("preempt") == 1
        assert by.count("oom") <= 3
        assert all(3 <= f.step for f in sched)
        steps = {}
        for f in sched:
            steps.setdefault(f.step, []).append(f.seam)
        for seams_at in steps.values():
            if "preempt" in seams_at:
                assert seams_at == ["preempt"]


def test_preempt_never_in_overlap_tail(sf):
    for seed in range(6):
        sched = sf.make_schedule(seed, 60, 10, overlap_pairs=4)
        steps = {}
        for f in sched:
            steps.setdefault(f.step, []).append(f.seam)
        for seams_at in steps.values():
            if "preempt" in seams_at:
                assert seams_at == ["preempt"]


def test_arm_fault_rules(sf):
    cfg = _chaos_config(sf)
    for seam, step in (("host_loss", 5), ("preempt", 9)):
        sf.arm_fault(cfg, sf.ScheduledFault(step, seam), hang_delay_s=12.0)
    sf.arm_fault(cfg, sf.ScheduledFault(3, "collective_hang"), hang_delay_s=12.0)
    sf.arm_fault(cfg, sf.ScheduledFault(3, "sdc"), hang_delay_s=12.0)
    sf.arm_fault(cfg, sf.ScheduledFault(4, "snap_slow"), hang_delay_s=12.0)
    sf.arm_fault(cfg, sf.ScheduledFault(4, "snap_corrupt", "local"), hang_delay_s=12.0)
    by = {r.seam: r for r in cfg.rules}
    assert by["host_loss"].target == "6"  # fires at the NEXT boundary
    assert by["preempt"].target == "10"
    assert by["collective_hang"].delay_s == 12.0
    assert by["sdc"].target is None and by["sdc"].count == 1
    assert by["snap_slow"].delay_s == 1.0 and by["snap_corrupt"].target == "local"


def test_straggler_rule_is_the_jax_drivers_but_its_delay():
    """The straggler fires 5 times inside the guarded step, as the JAX
    script arms it; its delay is the caller's, sized from the clean step."""
    cfg = _chaos_config(tsf)
    with pytest.raises(ValueError, match="straggler_delay_s"):
        tsf.arm_fault(cfg, tsf.ScheduledFault(11, "straggler"), hang_delay_s=12.0)
    tsf.arm_fault(cfg, tsf.ScheduledFault(11, "straggler"), hang_delay_s=12.0,
                  straggler_delay_s=tsf.straggler_delay_s(0.02, 2.0))
    (rule,) = cfg.rules
    assert (rule.seam, rule.target, rule.count) == ("straggler", "step", 5)
    assert rule.delay_s == pytest.approx(0.16)
    assert tsf.straggler_delay_s(0.2, 2.0) == 0.5  # a quarter of the watchdog's timeout at most


def test_soak_ok_gate(sf):
    good = {"soak_unrecovered": 0, "soak_unactuated": 0, "soak_replay_errors": 0, "soak_final_loss": 0.5}
    assert sf.soak_ok(good)
    assert not sf.soak_ok({**good, "soak_unrecovered": 1})
    assert not sf.soak_ok({**good, "soak_unactuated": 2})
    assert not sf.soak_ok({**good, "soak_final_loss": float("nan")})


# =============================================================================
# The two packages' scripts agree
# =============================================================================


@pytest.mark.parametrize("shape", [(200, 14, 2), (40, 11), (60, 10, 4)], ids=["full", "smoke", "tail"])
def test_schedules_are_the_jax_drivers_fault_for_fault(jax_scripts, shape):
    jsf = jax_scripts[0]
    for seed in range(31):
        want = [(f.step, f.seam, f.target) for f in jsf.make_schedule(seed, *shape)]
        got = [(f.step, f.seam, f.target) for f in tsf.make_schedule(seed, *shape)]
        assert got == want, seed
    assert tsf.REQUIRED_SEAMS == jsf.REQUIRED_SEAMS and tsf.FILLER_SEAMS == jsf.FILLER_SEAMS
    assert tsf.DETECTED_FAULT_CLASSES == jsf.DETECTED_FAULT_CLASSES


_POD_GOOD = {
    "soak_pod_unrecovered": 0, "soak_pod_unactuated": 0, "soak_pod_replay_errors": 0, "soak_pod_restarts": 0,
    "soak_pod_final_loss": 4.2, "soak_pod_degraded_steps": 5, "soak_pod_min_width": 1, "soak_pod_full_width": 2,
    "soak_pod_final_width": 2, "soak_pod_shrinks": 1, "soak_pod_regrows": 1, "soak_pod_slice_loss_restores": 1,
    "soak_pod_slice_loss_restore_tiers": ["peer"], "soak_pod_disk_restores_after_anchor": 0,
    "soak_pod_ops_port": 1234, "soak_pod_anomalies": {"slice_spread": 1}, "soak_pod_ops_healthz": "ok",
}


@pytest.mark.parametrize("change", [
    {}, {"soak_pod_unrecovered": 1}, {"soak_pod_restarts": 1}, {"soak_pod_final_loss": float("nan")},
    {"soak_pod_degraded_steps": 0}, {"soak_pod_final_width": 1}, {"soak_pod_regrows": 0},
    {"soak_pod_slice_loss_restore_tiers": ["disk"]}, {"soak_pod_disk_restores_after_anchor": 1},
    {"soak_pod_flap_refailures": 1, "soak_pod_shrinks": 2}, {"soak_pod_ops_healthz": ""},
], ids=["good", "unrecovered", "restart", "nan", "no-degraded", "not-regrown", "no-regrow", "disk-tier",
        "disk-after-anchor", "flap-extra-shrink", "no-healthz"])
def test_pod_ok_agrees_with_the_jax_driver(jax_scripts, change):
    res = {**_POD_GOOD, **change}
    assert tsp.pod_ok(res) == jax_scripts[1].pod_ok(res)
    assert tsp.pod_ok(res) == (not change)


def test_pod_spec_is_the_jax_drivers(jax_scripts):
    for argv in (["--smoke", "--device", "cpu"], ["--device", "cpu"], ["--steps", "90", "--device", "cpu"]):
        args = tsp.parse_args(argv)
        jargs = type("A", (), {k: getattr(args, k) for k in ("steps", "smoke", "seed", "recover_after",
                                                             "slow_delay_s")})
        assert tsp.make_spec(args) == jax_scripts[1].make_spec(jargs)


# =============================================================================
# lint_traces' --soak and --federation checks
# =============================================================================


def _jax_cli_constants() -> dict:
    tree = ast.parse(open(os.path.join(SCRIPTS, "lint_traces.py")).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_required_keys_are_the_jax_clis():
    c = _jax_cli_constants()
    assert lint_traces._SOAK_REQUIRED_KEYS == c["_SOAK_REQUIRED_KEYS"]
    assert lint_traces._POD_REQUIRED_KEYS == c["_POD_REQUIRED_KEYS"]
    assert lint_traces._SOAK_POLICY_CLASSES == c["_SOAK_POLICY_CLASSES"]
    assert lint_traces._SOAK_STALL_MS_PER_STEP_CAP == c["_SOAK_STALL_MS_PER_STEP_CAP"]


_SOAK_GOOD = {k: 0 for k in lint_traces._SOAK_REQUIRED_KEYS} | {
    "soak_decisions": {"elastic_resume": 3, "quarantine_rerun": 1, "deopt_escalate": 2, "checkpoint_halt": 1},
    "soak_fault_seams": {s: 1 for s in tsf.REQUIRED_SEAMS}, "soak_overlapping_pairs": 2, "n_devices": 4,
    "soak_seams_not_armed": {}, "soak_seams_not_fired": ["snap_slow", "snap_torn"],
    "checkpoint_stall_ms_per_step": 5.2, "checkpoint_peer_wait_ms_per_step": 3.1, "soak_snapshots": 22,
    "soak_restore_tiers": {"disk": 3, "local": 1},
    "soak_restore_fallthroughs": 1, "soak_anomalies": {"step_time_drift": 1, "recompile_storm": 1},
    "soak_detection_lead": 4.2, "soak_flightrec_dumps": 2, "soak_goodput_tokens_per_sec": 800.0,
}


@pytest.mark.parametrize("change", [
    {"soak_unrecovered": 1}, {"missing": "soak_ops_port"}, {"absent": "quarantine_rerun"},
    {"soak_undetected_detector_classes": 1, "soak_detector_classes_missed": ["straggler"]},
    {"checkpoint_stall_ms_per_step": 54.4}, {"soak_restore_fallthroughs": 0}, {"soak_detection_lead": 0.0},
    {"soak_flightrec_missing": 1}, {"soak_goodput_tokens_per_sec": 0.0}, {"soak_overlapping_pairs": 0},
    {"soak_seams_not_fired": ["ckpt_io", "snap_slow", "snap_torn"]}, {"soak_seams_not_fired": []},
    {"n_devices": 1}, {"missing": "soak_seams_not_fired"},
    {"soak_fault_seams": {"snap_torn": 1, "snap_slow": 1, "host_loss": 1, "oom": 2, "sdc": 1, "preempt": 1}},
], ids=["unrecovered", "missing-key", "absent-policy-class", "missed-detector-class", "stall", "no-fallthrough",
        "no-lead", "flightrec-missing", "no-goodput", "no-overlap", "another-seam-not-fired",
        "silent-seams-fired-on-ranks", "not-fired-at-one-rank", "no-not-fired-key", "four-seams-injected"])
def test_soak_checks_count_an_error_for_a_doctored_result(change, capsys):
    assert lint_traces.soak_checks(dict(_SOAK_GOOD)) == 0
    res = dict(_SOAK_GOOD)
    change = dict(change)
    if "missing" in change:
        del res[change.pop("missing")]
    if "absent" in change:
        absent = change.pop("absent")
        res["soak_decisions"] = {k: v for k, v in res["soak_decisions"].items() if k != absent}
    res.update(change)
    assert lint_traces.soak_checks(res) >= 1
    assert "FAILED" in capsys.readouterr().out


def test_soak_checks_print_the_peer_wait_beside_the_stall(capsys):
    assert lint_traces.soak_checks(dict(_SOAK_GOOD)) == 0
    out = capsys.readouterr().out
    assert "stall OK: 5.20 ms/step over 22 snapshots (peer wait 3.1 ms/step, outside the stall)" in out


def test_replay_sums_the_snapshot_peer_wait(tmp_path):
    """A snapshot taken on ranks carries ``peer_wait_ms`` (its wait at the
    job's barrier, outside ``stall_ms``): the replay sums both."""
    from thunder_tpu_torch.analysis.events import format_replay, replay_events

    p = tmp_path / "log.jsonl"
    p.write_text("".join(json.dumps({"v": 1, "ts": float(i), "seq": i, "kind": "snapshot", "step": 2 * i,
                                     "stall_ms": 1.5, "peer_wait_ms": w}) + "\n"
                         for i, w in enumerate((4.0, 0.25), start=1)))
    summary, diags = replay_events(str(p))
    assert not diags
    assert summary["snapshot_stall_ms_total"] == 3.0 and summary["snapshot_peer_wait_ms_total"] == 4.25
    assert "snapshots: 2 (stall total 3.0 ms, peer wait total 4.25 ms)" in format_replay(summary, diags)


_POD_CHECK_GOOD = {k: 0 for k in lint_traces._POD_REQUIRED_KEYS} | {
    "soak_pod_full_width": 2, "soak_pod_final_width": 2, "soak_pod_min_width": 1, "soak_pod_shrinks": 1,
    "soak_pod_regrows": 1, "soak_pod_degraded_steps": 5, "soak_pod_slice_loss_restores": 1,
    "soak_pod_restore_tiers": {"peer": 1, "disk": 1},
}


@pytest.mark.parametrize("change,elapsed", [
    ({}, 61.0), ({"soak_pod_slice_loss_nonpeer_restores": 1}, 20.0), ({"soak_pod_regrows": 0}, 20.0),
    ({"soak_pod_unactuated": 1}, 20.0), ({"soak_pod_restarts": 1}, 20.0),
], ids=["over-60s", "nonpeer-restore", "no-regrow", "unactuated", "restart"])
def test_federation_checks_count_an_error_for_a_doctored_result(change, elapsed, capsys):
    assert lint_traces.federation_checks(dict(_POD_CHECK_GOOD), 20.0) == 0
    assert lint_traces.federation_checks({**_POD_CHECK_GOOD, **change}, elapsed) >= 1
    assert "FAILED" in capsys.readouterr().out


def test_torn_fallthrough_check_passes(capsys):
    assert lint_traces._torn_fallthrough_check() == 0
    assert "torn-write fall-through OK" in capsys.readouterr().out


# =============================================================================
# The straggler
# =============================================================================

# The JAX smoke at seed 7 (scripts/soak_fleet.py --smoke --seed 7): its
# step_time samples, steps 0-11 (the straggler fired from step 12 on), and
# the clean step _measure_overheads measured (256 tokens / 11965.0 tok/s).
SEED7_BASELINE_S = [0.087645, 0.028437, 0.031902, 0.054195, 0.09422, 0.10347, 0.027663, 0.060741, 0.032817,
                    0.027599, 0.137897, 0.026569]
SEED7_IDEAL_STEP_S = 256 / 11965.0
JAX_STRAGGLER_DELAY_S = 2.0 * 6 / 200.0  # hang_delay_s / 200 at the default 2 s watchdog


def _step_time_anomalies(samples) -> list:
    from thunder_tpu_torch.observability.detect import DetectorBank, DetectorConfig

    bank = DetectorBank(DetectorConfig(min_samples=6, cooldown=20, goodput_consecutive=3,
                                       recompile_threshold=2, recompile_window_s=3600.0))
    for i, s in enumerate(samples):
        bank.consume("step_time", {"fn": "step_fn", "step": i, "s": s, "host": 0})
    return sorted({a.kind for a in bank.anomalies} & {"step_time_drift", "goodput_drop", "host_spread"})


def test_jax_drivers_fixed_delay_is_missed_and_the_ports_is_seen():
    clean = SEED7_BASELINE_S[-1]
    assert _step_time_anomalies(SEED7_BASELINE_S) == []
    assert _step_time_anomalies(SEED7_BASELINE_S + [clean + JAX_STRAGGLER_DELAY_S] * 5) == []
    delay = tsf.straggler_delay_s(SEED7_IDEAL_STEP_S, 2.0)
    assert delay == pytest.approx(tsf.STRAGGLER_STEP_FACTOR * SEED7_IDEAL_STEP_S) and delay < 0.5
    assert _step_time_anomalies(SEED7_BASELINE_S + [clean + delay] * 5) == ["goodput_drop", "step_time_drift"]


def test_drivers_import_quietly_and_read_argv_only_in_main(monkeypatch):
    """Importing a soak script does nothing; ``parse_args`` reads the list it is
    given, and without a card ``--device cuda`` (the default) raises."""
    monkeypatch.setattr(sys, "argv", ["pytest", "not-a-flag"])
    for mod in (tsf, tsp):
        args = mod.parse_args(["--smoke", "--device", "cpu"])
        assert args.devices == 4 and args.seed == 1
    assert tsf.parse_args(["--smoke", "--device", "cpu"]).steps == 40
    assert tsp.parse_args(["--smoke", "--device", "cpu"]).steps == 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsf.main(["--smoke", "--devices", "1"])


def test_flags_and_defaults_match_the_jax_drivers(jax_scripts):
    """The JAX scripts' flags and defaults, plus ``--device`` (default cuda);
    ``--devices`` defaults by device (8 gloo ranks on the CPU, as the JAX
    virtual mesh has 8 devices); the pod's ``--rejoin-backoff-s`` defaults to
    the measured clean step's (None), where the JAX script fixes 0.05 s."""
    import argparse

    for jmod, tmod in zip(jax_scripts, (tsf, tsp)):
        jp = {}
        orig = argparse.ArgumentParser.parse_args

        def capture(self, args=None, namespace=None):
            jp.update({a.dest: a.default for a in self._actions if a.dest != "help"})
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                jmod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        tp = vars(tmod.parse_args(["--device", "cpu"]))
        for k, v in jp.items():
            if k in ("devices", "_subprocess", "regrow_after", "rejoin_backoff_s"):
                continue
            assert tp[k] == v, k
        assert jp["devices"] == 8 == tp["devices"]
        if "regrow_after" in jp:
            assert tp["regrow_after"] == jp["regrow_after"]
        if "rejoin_backoff_s" in jp:
            assert jp["rejoin_backoff_s"] == 0.05 and tp["rejoin_backoff_s"] is None
            assert tmod.parse_args(["--rejoin-backoff-s", "0.2", "--device", "cpu"]).rejoin_backoff_s == 0.2
