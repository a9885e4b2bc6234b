"""The port's benchmark-series gate against the JAX package's, on the CPU.

``thunder_tpu_torch.scripts.perf_report``'s history mode (the counterpart of
``scripts/perf_report.py --history/--threshold/--ack/--gate``) and lint's
series gates. The JAX script is imported as the JAX tests import it
(``tests/test_roofline.py``), and both modules get the same rounds:

- the committed rounds of the JAX series (``BENCH_r01-05``,
  ``MULTICHIP_BENCH_r01-05``, ``SOAK_r01-03``, ``SOAK_POD_r01``,
  ``ROOFLINE_r01``, ``CRITPATH_r01``) and ``BENCH_ACK.json``, read by
  explicit path, as test data only;
- rounds planted in ``tmp_path``: those of ``tests/test_autopilot.py``'s
  soak gate cases, ``tests/test_roofline.py``'s roofline gate and
  ``tests/test_timeline.py``'s critpath gate, and one per invariant of the
  ops-plane and pod families.

Each test asserts the same results from both: ``load_round``'s dicts,
``metric_direction`` and ``noise_floor`` for every name in every series,
``analyze_history``'s regressions (key, pct, acked), ``compare_rounds``,
``format_history``, ``run_history_gate``'s return code and report, and each
``_*_failures`` list. Then the port's own series: its gate globs only
``H100_*`` rounds, so a JAX-named regression beside an empty port series
counts no error, and the same round under the port's prefix counts one.
"""

import io
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import perf_report as jpr  # noqa: E402

from thunder_tpu_torch.scripts import lint_traces  # noqa: E402
from thunder_tpu_torch.scripts import perf_report as tpr  # noqa: E402

COMMITTED = {
    "BENCH": [f"BENCH_r0{i}.json" for i in range(1, 6)],
    "MULTICHIP_BENCH": [f"MULTICHIP_BENCH_r0{i}.json" for i in range(1, 6)],
    "SOAK": [f"SOAK_r0{i}.json" for i in range(1, 4)],
    "SOAK_POD": ["SOAK_POD_r01.json"],
    "ROOFLINE": ["ROOFLINE_r01.json"],
    "CRITPATH": ["CRITPATH_r01.json"],
}
ACK = os.path.join(REPO, "BENCH_ACK.json")
ALL_FILES = [f for files in COMMITTED.values() for f in files]
FAILURES = ("_ops_plane_failures", "_pod_failures", "_critpath_failures", "_roofline_failures")


def _paths(series):
    return [os.path.join(REPO, f) for f in COMMITTED[series]]


def _regs(regs):
    return [(r.key, r.prev, r.cur, r.pct, r.acked, r.reason, r.format()) for r in regs]


def _failures(mod, newest):
    return {name: getattr(mod, name)(newest) for name in FAILURES}


def _gate(mod, paths, **kw):
    out = io.StringIO()
    rc = mod.run_history_gate(paths, out=out, **kw)
    return rc, out.getvalue()


@pytest.mark.parametrize("name", ALL_FILES)
def test_load_round_reads_each_committed_round_alike(name):
    path = os.path.join(REPO, name)
    assert tpr.load_round(path) == jpr.load_round(path)


@pytest.mark.parametrize("series", sorted(COMMITTED))
def test_direction_and_floor_of_every_name_in_every_series(series):
    rounds = [jpr.load_round(p) for p in _paths(series)]
    heads = {m.get("_metric_name", "") for _, m in rounds} | {""}
    names = {n for _, m in rounds for n in m} | {"value", "train_mfu", "soak_goodput_ratio", "op_L3_matmul_us",
                                                 "op_L3_matmul_achieved_frac", "critpath_straggler_wait_frac"}
    assert len(names) > 5
    for head in heads:
        for n in sorted(names):
            assert tpr.metric_direction(n, head) == jpr.metric_direction(n, head), (n, head)
            assert tpr.noise_floor(n, head) == jpr.noise_floor(n, head), (n, head)
            assert tpr.mfu_comparable(n, *[m for _, m in rounds]) == jpr.mfu_comparable(n, *[m for _, m in rounds])


@pytest.mark.parametrize("threshold", [0.10, 0.05, 0.30])
@pytest.mark.parametrize("series", sorted(COMMITTED))
def test_history_of_each_committed_series_alike(series, threshold):
    rounds = [jpr.load_round(p) for p in _paths(series)]
    ack = jpr.load_ack(ACK)
    assert tpr.load_ack(ACK) == ack
    want = jpr.analyze_history(rounds, threshold=threshold, ack=ack)
    assert _regs(tpr.analyze_history(rounds, threshold=threshold, ack=ack)) == _regs(want)
    assert tpr.format_history(rounds, tpr.analyze_history(rounds, threshold=threshold, ack=ack)) == \
        jpr.format_history(rounds, want)
    for gate in (True, False):
        assert _gate(tpr, _paths(series), threshold=threshold, ack_path=ACK, gate=gate) == \
            _gate(jpr, _paths(series), threshold=threshold, ack_path=ACK, gate=gate)
    assert _failures(tpr, rounds[-1]) == _failures(jpr, rounds[-1])


def test_the_committed_bench_series_holds_its_acked_regression():
    """The committed BENCH series regresses at r04->r05 (train_xla_compile_s)
    and BENCH_ACK.json acknowledges it: both gates pass with the ack and
    fail without it, alike."""
    rounds = [jpr.load_round(p) for p in _paths("BENCH")]
    regs = tpr.analyze_history(rounds, ack=tpr.load_ack(ACK))
    assert any(r.acked and r.metric == "train_xla_compile_s" for r in regs)
    none = os.path.join(REPO, "no-such-ack.json")
    for mod in (tpr, jpr):
        assert _gate(mod, _paths("BENCH"), ack_path=ACK, gate=True)[0] == 0
        rc, out = _gate(mod, _paths("BENCH"), ack_path=none, gate=True)
        assert rc == 1 and "un-acknowledged regression" in out


@pytest.mark.parametrize("pair", [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)])
@pytest.mark.parametrize("series", ["BENCH", "MULTICHIP_BENCH"])
def test_compare_rounds_alike(series, pair):
    rounds = [jpr.load_round(p)[1] for p in _paths(series)]
    prev, cur = rounds[pair[0]], rounds[pair[1]]
    for threshold in (0.10, 0.02):
        assert tpr.compare_rounds(prev, cur, threshold=threshold) == jpr.compare_rounds(prev, cur, threshold=threshold)


# -- planted rounds -----------------------------------------------------------


def _roofline_round(n_rows=12, schema_ok=1):
    # tests/test_roofline.py's round.
    m = {"_metric_name": "roofline_gpt_tiny_fwd", "value": 0.5, "roofline_rows": n_rows,
         "roofline_schema_ok": schema_ok}
    for i in range(n_rows):
        m[f"op_L{i}_matmul_us"] = 10.0 + i
        m[f"op_L{i}_matmul_achieved_frac"] = 0.5
    return ("r01", m)


def _critpath_round(**bad):
    # tests/test_timeline.py's good round, with fields overridden.
    m = {"_metric_name": "critpath_exposed_pct", "critpath_steps": 40, "critpath_nonzero_classes": 5,
         "critpath_frac_sum": 1.0, "critpath_skew_recovery_err_ms": 3.2, "critpath_skew_min_confidence": 0.9,
         "critpath_skew_outlier_hosts": 0, "critpath_straggler_host_match": 1,
         "critpath_bottleneck_shift_anomalies": 3, "critpath_cited_decisions": 1, "critpath_delta_static_pct": 1.5}
    m.update(bad)
    return ("CRITPATH_r01", m)


def _pod_round(**bad):
    m = {"_metric_name": "soak_pod_goodput", "soak_pod_full_width": 2, "soak_pod_final_width": 2,
         "soak_pod_min_width": 1, "soak_pod_degraded_steps": 5, "soak_pod_shrinks": 2, "soak_pod_regrows": 2,
         "soak_pod_slice_loss_restores": 1, "soak_pod_flap_injected": 1, "soak_pod_flap_refailures": 1,
         "soak_pod_slow_injected": 1, "soak_pod_slice_spread_anomalies": 2}
    m.update(bad)
    return ("r01", m)


def _soak_round(**bad):
    m = {"_metric_name": "soak_goodput", "soak_undetected_detector_classes": 0, "soak_flightrec_invalid": 0,
         "soak_flightrec_missing": 0, "soak_detection_lead": 1.5}
    m.update(bad)
    return ("r03", m)


PLANTED = {
    "roofline-good": _roofline_round(), "roofline-few-rows": _roofline_round(n_rows=4),
    "roofline-schema": _roofline_round(schema_ok=0),
    "critpath-good": _critpath_round(), "critpath-steps": _critpath_round(critpath_steps=2),
    "critpath-classes": _critpath_round(critpath_nonzero_classes=4), "critpath-sum": _critpath_round(critpath_frac_sum=1.2),
    "critpath-skew": _critpath_round(critpath_skew_recovery_err_ms=60.0),
    "critpath-skew-nan": _critpath_round(critpath_skew_recovery_err_ms=float("nan")),
    "critpath-confidence": _critpath_round(critpath_skew_min_confidence=0.2),
    "critpath-outliers": _critpath_round(critpath_skew_outlier_hosts=1),
    "critpath-straggler": _critpath_round(critpath_straggler_host_match=0),
    "critpath-shift": _critpath_round(critpath_bottleneck_shift_anomalies=0),
    "critpath-cited": _critpath_round(critpath_cited_decisions=0),
    "critpath-delta": _critpath_round(critpath_delta_static_pct=20.0),
    "pod-good": _pod_round(), "pod-unrecovered": _pod_round(soak_pod_unrecovered=1),
    "pod-restarts": _pod_round(soak_pod_restarts=1), "pod-no-regrow": _pod_round(soak_pod_final_width=1),
    "pod-no-degraded": _pod_round(soak_pod_degraded_steps=0), "pod-flap": _pod_round(soak_pod_flap_refailures=0),
    "pod-shrinks": _pod_round(soak_pod_regrows=1), "pod-no-restore": _pod_round(soak_pod_slice_loss_restores=0),
    "pod-slow": _pod_round(soak_pod_slice_spread_anomalies=0),
    "soak-good": _soak_round(), "soak-undetected": _soak_round(soak_undetected_detector_classes=1),
    "soak-invalid": _soak_round(soak_flightrec_invalid=2), "soak-lead": _soak_round(soak_detection_lead=-0.5),
    "soak-pre-plane": ("r01", {"_metric_name": "soak_goodput"}),
    "other-series": ("SOAK_r01", {"_metric_name": "goodput"}),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_invariant_failures_of_planted_rounds_alike(case):
    newest = PLANTED[case]
    want = _failures(jpr, newest)
    assert _failures(tpr, newest) == want
    failed = any(want.values())
    assert failed == (not case.endswith(("good", "pre-plane", "other-series"))), want


def _write(d, name, metrics):
    path = os.path.join(d, name)
    with open(path, "w") as f:
        json.dump({k: v for k, v in metrics.items() if not k.startswith("_")} |
                  {"metric": metrics.get("_metric_name", "")}, f)
    return path


@pytest.mark.parametrize("case", ["roofline-good", "roofline-few-rows", "critpath-good", "critpath-delta",
                                  "pod-good", "pod-no-regrow", "soak-good", "soak-lead"])
def test_one_round_series_gates_on_its_invariants_alike(case, tmp_path):
    label, m = PLANTED[case]
    path = _write(str(tmp_path), "X_r01.json", m)
    for gate in (True, False):
        got = _gate(tpr, [path], gate=gate)
        assert got == _gate(jpr, [path], gate=gate)
        assert got[0] == (1 if gate and any(_failures(jpr, jpr.load_round(path)).values()) else 0)


def test_soak_noise_floors_and_direction_alike():
    # tests/test_autopilot.py's test_soak_noise_floors_and_direction.
    for mod in (tpr, jpr):
        assert mod.metric_direction("value", "soak_goodput") == 1
        assert mod.metric_direction("value", "multichip_fsdp_tp_train_iter") == -1
        assert mod.metric_direction("soak_goodput_tokens_per_sec") == 1
        assert mod.noise_floor("soak_goodput_ratio", "soak_goodput") == 0.15
        assert mod.noise_floor("value", "soak_goodput") == 800.0
        assert mod.noise_floor("soak_recovery_per_fault_s", "soak_goodput") == 1.5
        assert mod.metric_direction("checkpoint_stall_ms_per_step") == -1
        assert mod.noise_floor("checkpoint_stall_ms_per_step", "soak_goodput") == 3.0


def test_goodput_gate_flags_a_drop_alike():
    # tests/test_autopilot.py's test_goodput_gate_flags_drop.
    r1 = {"_metric_name": "soak_goodput", "value": 5000.0, "soak_goodput_ratio": 0.8}
    r2 = {"_metric_name": "soak_goodput", "value": 2000.0, "soak_goodput_ratio": 0.3}
    for rounds in ([("r01", r1), ("r02", r2)], [("r01", r2), ("r02", r1)]):
        assert _regs(tpr.analyze_history(rounds)) == _regs(jpr.analyze_history(rounds))
    assert {r.metric for r in tpr.analyze_history([("r01", r1), ("r02", r2)])} >= {"value"}
    assert not tpr.analyze_history([("r01", r2), ("r02", r1)])


def test_roofline_floors_are_series_scoped_alike():
    # tests/test_roofline.py's TestRooflineGate.test_direction_and_floors.
    for mod in (tpr, jpr):
        assert mod.metric_direction("op_L3_matmul_achieved_frac") == 1
        assert mod.metric_direction("op_L3_matmul_us") == -1
        assert mod.metric_direction("roofline_coverage_pct") == 1
        assert mod.noise_floor("op_L3_matmul_us", "roofline_gpt_tiny_fwd") == 40.0
        assert mod.noise_floor("op_L3_matmul_achieved_frac", "roofline_gpt_tiny_fwd") == 0.05
        assert mod.noise_floor("trace_cache_lookup_us", "open_llama_3b_train_iter_b2_t2048") == 5.0


def test_headline_of_another_workload_is_not_compared_alike():
    r1 = {"_metric_name": "fwd", "value": 1.0, "train_mfu": 0.5}
    r2 = {"_metric_name": "train", "value": 9.0, "train_mfu": 0.1}
    cpu = {"_metric_name": "train", "value": 1.0, "train_mfu": 0.01, "_device_spec": "cpu"}
    for rounds in ([("r01", r1), ("r02", r2)], [("r01", dict(r2, _device_spec="h100")), ("r02", cpu)]):
        assert _regs(tpr.analyze_history(rounds)) == _regs(jpr.analyze_history(rounds))
    assert [r.metric for r in tpr.analyze_history([("r01", r1), ("r02", r2)])] == ["train_mfu"]
    assert tpr.analyze_history([("r01", dict(r2, _device_spec="h100")), ("r02", cpu)]) == []


def test_cli_history_gate_exit_codes(tmp_path, capsys):
    """``perf_report --history ... --gate`` as a command: 0 on the committed
    soak series with the JAX series' acknowledgements given by ``--ack``,
    1 without them (the port's default is its own ``H100_BENCH_ACK.json``,
    which is not committed); 1 on a planted regression, and what it prints
    is the JAX script's."""
    paths = _paths("SOAK")
    assert tpr.main(["--history", *paths, "--gate", "--ack", ACK]) == 0
    assert tpr.main(["--history", *paths, "--gate"]) == 1
    d = str(tmp_path)
    a = shutil.copy(paths[-1], os.path.join(d, "H100_SOAK_r01.json"))
    doc = json.load(open(a))
    doc["value"] = doc["value"] * 0.5
    b = os.path.join(d, "H100_SOAK_r02.json")
    json.dump(doc, open(b, "w"))
    capsys.readouterr()
    none = os.path.join(d, "none.json")
    assert tpr.main(["--history", a, b, "--gate", "--ack", none]) == 1
    ours = capsys.readouterr().out
    assert (1, ours) == _gate(jpr, [a, b], ack_path=none, gate=True) and "REGRESSION: value" in ours
    assert tpr.main(["--history", a, b, "--threshold", "0.6", "--ack", os.path.join(d, "none.json"), "--gate"]) == 0


# -- the port's own series ----------------------------------------------------


def test_the_ports_globs_match_no_jax_round():
    for series in tpr.SERIES:
        assert os.path.basename(tpr.series_glob(series)).startswith(tpr.SERIES_PREFIX)
        assert tpr.series_paths(series) == []  # no round of the port's series is committed
    assert os.path.basename(tpr.series_glob("SOAK")) == "H100_SOAK_r*.json"
    assert tpr.series_paths("SOAK") != _paths("SOAK")
    with pytest.raises(ValueError):
        tpr.series_glob("NOT_A_SERIES")


def _regressing_pair(d, prefix):
    src = jpr.load_round(os.path.join(REPO, "BENCH_r05.json"))
    doc = json.load(open(os.path.join(REPO, "BENCH_r05.json")))
    shutil.copy(os.path.join(REPO, "BENCH_r05.json"), os.path.join(d, f"{prefix}BENCH_r08.json"))
    doc["parsed"]["value"] = src[1]["value"] * 1.5
    json.dump(doc, open(os.path.join(d, f"{prefix}BENCH_r09.json"), "w"))


def test_lint_gate_reads_only_the_ports_series(tmp_path, capsys):
    """A JAX-named regression beside an empty port series counts no error
    and the gate names its glob and 0 rounds; the same rounds under the
    port's prefix count one."""
    d = str(tmp_path)
    _regressing_pair(d, "")
    assert lint_traces._bench_history_gate("BENCH", root=d) == 0
    out = capsys.readouterr().out
    assert "[H100_BENCH_r*.json]: 0 round(s)" in out and "no error counted" in out
    _regressing_pair(d, "H100_")
    assert lint_traces._bench_history_gate("BENCH", root=d) == 1
    out = capsys.readouterr().out
    assert "REGRESSION: value" in out and "[H100_BENCH_r*.json]" in out


def test_one_round_gates_of_lint_alike(tmp_path, capsys):
    """``min_rounds=1`` (the pod, roofline and critpath series): one round
    gates on its invariants; the default 2 leaves it ungated."""
    d = str(tmp_path)
    _write(d, "H100_CRITPATH_r01.json", PLANTED["critpath-delta"][1])
    assert lint_traces._bench_history_gate("CRITPATH", min_rounds=1, root=d) == 1
    assert lint_traces._bench_history_gate("CRITPATH", root=d) == 0
    _write(d, "H100_ROOFLINE_r01.json", PLANTED["roofline-good"][1])
    assert lint_traces._bench_history_gate("ROOFLINE", min_rounds=1, root=d) == 0
    assert "1 round(s), fewer than 2" in capsys.readouterr().out


def test_every_series_gate_is_empty_at_the_repo_root(capsys):
    """The unfiltered lint run's six gates at the repo's root, where no
    round of the port's series is committed: each names its glob and 0
    rounds, and counts no error."""
    for series, min_rounds in (("BENCH", 2), ("MULTICHIP_BENCH", 2), ("SOAK", 2), ("SOAK_POD", 1), ("ROOFLINE", 1),
                               ("CRITPATH", 1)):
        assert lint_traces._bench_history_gate(series, min_rounds=min_rounds) == 0
        assert f"[H100_{series}_r*.json]: 0 round(s)" in capsys.readouterr().out


@pytest.mark.parametrize("delta,errors", [(0.0, 0), (2.9, 0), (3.1, 1)])
def test_soak_per_fault_check_against_the_newest_port_round(tmp_path, delta, errors):
    """``--soak``'s recovery seconds a fault against the newest round of the
    port's SOAK series, within twice the soak floor (the JAX CLI's rule);
    the JAX series' rounds beside it are not read."""
    d = str(tmp_path)
    ref = json.load(open(os.path.join(REPO, "SOAK_r03.json")))
    shutil.copy(os.path.join(REPO, "SOAK_r03.json"), os.path.join(d, "SOAK_r03.json"))
    assert lint_traces._soak_per_fault_check({"soak_recovery_per_fault_s": 99.0}, root=d) == 0
    json.dump(ref, open(os.path.join(d, "H100_SOAK_r01.json"), "w"))
    result = {"soak_recovery_per_fault_s": ref["soak_recovery_per_fault_s"] + delta}
    assert lint_traces._soak_per_fault_check(result, root=d) == errors
    assert 2 * jpr.noise_floor("per_fault_s", "soak_goodput") == 3.0
