"""``lint_traces --multichip`` on gloo ranks, on the CPU.

``python -m thunder_tpu_torch.scripts.lint_traces --multichip`` runs in a
process of its own (its output to a file in the test's directory), which
runs ``thunder_tpu_torch.scripts.bench_multichip --iters 3 --profile-steps
2 --device cpu`` on 4 gloo ranks (fsdp2-tp2; each rank's output to a file of
its own) and holds its result to the JAX CLI's checks: the schema (the
JAX CLI's ``_MULTICHIP_REQUIRED_KEYS``, letter for letter), the collective
rows of the profiled step with their hidden/exposed split, and the comm
scheduler moving at least one site of the explicit-collective step and
cutting its static exposed share; then the gate of the port's
``H100_MULTICHIP_BENCH`` series, which holds no round. It exits 0.

``multichip_checks`` is also held to planted results, one fault each.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 300
sys.path.insert(0, os.path.join(REPO, "scripts"))


def _env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    return env


def test_lint_multichip_exits_0_on_gloo_ranks(tmp_path):
    log = tmp_path / "lint.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "thunder_tpu_torch.scripts.lint_traces", "--multichip"],
                                stdout=f, stderr=subprocess.STDOUT, env=_env(tmp_path), cwd=REPO)
        try:
            rc = proc.wait(timeout=SPAWN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = log.read_text()
    assert rc == 0, out[-4000:]
    assert "lint_traces --multichip: 0 error(s)" in out and "FAILED" not in out, out[-4000:]
    assert "--devices 4 --iters 3 --profile-steps 2" in out
    assert "schema OK (18 required keys)" in out
    rows = re.search(r"collective rows OK: \[(.*?)\]", out)
    assert rows and {"'all-gather'", "'all-reduce'", "'reduce-scatter'"} <= set(rows.group(1).split(", "))
    m = re.search(r"overlap table OK: (\d+)/(\d+) site\(s\), (\d+) scheduler move\(s\), static exposed "
                  r"([\d.]+)% -> ([\d.]+)%", out)
    assert m, out[-4000:]
    shown, total, moves, before, after = int(m[1]), int(m[2]), int(m[3]), float(m[4]), float(m[5])
    assert shown == total > 0 and moves >= 1 and after < before
    assert "series gate [H100_MULTICHIP_BENCH_r*.json]: 0 round(s)" in out


def _good() -> dict:
    from thunder_tpu_torch.scripts import lint_traces

    res = {k: 1 for k in lint_traces._MULTICHIP_REQUIRED_KEYS}
    res.update(collectives={"all-gather": {"us_per_step": 1.0, "hidden_us_per_step": 0.0, "exposed_us_per_step": 1.0,
                                           "calls": 2}},
               overlap=[{"collective": "L1.synchronize"}], overlap_sites_shown=1, overlap_sites_total=1,
               comm_schedule={"moves": 2}, collective_exposed_pct=30.0, collective_exposed_pct_unscheduled=60.0)
    return res


@pytest.mark.parametrize("fault", ["none", "missing-key", "no-rows", "row-fields", "overlap-error", "no-table",
                                   "no-counts", "no-moves", "no-cut"])
def test_multichip_checks_count_each_fault(fault, capsys):
    import lint_traces as jlint

    from thunder_tpu_torch.scripts import lint_traces

    assert lint_traces._MULTICHIP_REQUIRED_KEYS == jlint._MULTICHIP_REQUIRED_KEYS
    res = _good()
    if fault == "missing-key":
        del res["train_mfu"]
    elif fault == "no-rows":
        res["collectives"] = {}
    elif fault == "row-fields":
        del res["collectives"]["all-gather"]["hidden_us_per_step"]
    elif fault == "overlap-error":
        res["overlap_error"] = "RuntimeError: planted"
    elif fault == "no-table":
        res["overlap"] = []
    elif fault == "no-counts":
        del res["overlap_sites_total"]
    elif fault == "no-moves":
        res["comm_schedule"] = {"moves": 0}
    elif fault == "no-cut":
        res["collective_exposed_pct"] = 60.0
    assert lint_traces.multichip_checks(res) == (0 if fault == "none" else 1)
    assert ("FAILED" in capsys.readouterr().out) == (fault != "none")


def test_resilience_overhead_fields_on_two_gloo_ranks(tmp_path):
    """``bench_multichip --resilience-overhead`` on 2 gloo ranks (fsdp2, no
    profile): the JAX rounds' resilience fields, the guarded step's
    seconds, the watchdog's and SDC check's cost, the snapshot stall beside
    a synchronous save."""
    import json

    out = tmp_path / "mc.json"
    log = tmp_path / "bench.log"
    cmd = [sys.executable, "-m", "thunder_tpu_torch.scripts.bench_multichip", "--device", "cpu", "--devices", "2",
           "--iters", "3", "--no-profile", "--resilience-overhead",
           "--out", str(out)]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=_env(tmp_path), cwd=REPO)
        try:
            rc = proc.wait(timeout=SPAWN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert rc == 0, log.read_text()[-4000:]
    res = json.loads(out.read_text())
    assert res["mesh"] == {"fsdp": 2, "tp": 1} and res["n_devices"] == 2 and "collectives" not in res
    for k in ("resilience_iter_s", "resilience_overhead_pct", "sdc_check_us_per_step", "watchdog_dispatch_us",
              "checkpoint_stall_ms_per_step", "checkpoint_sync_save_ms"):
        assert isinstance(res[k], (int, float)) and res[k] >= 0, (k, res.get(k))
    assert res["resilience_iter_s"] >= res["train_iter_strict_sync_s"] * 0.1
