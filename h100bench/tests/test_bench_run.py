"""Whole runs of small cells on the CPU: a sound run is correct, each fault
the cell can have makes it not; the command refuses a machine without the
card and a checkout without the program; nothing JAX is loaded."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from h100bench import cells, control, harness
from h100bench.run import forbidden_modules

HERE = Path(__file__).resolve().parent
DATA = HERE / "data"
CHECKOUT = HERE.parents[1]
BENCH = cells.load_json(DATA / "bench.json")


def _run(workload, fault=None, seed=2**31 + 17):
    cell = cells.load_cell(BENCH, workload, root=DATA)
    runner = control.FAULTS[cell.traffic["kind"]][fault] if fault else None
    return harness.run_cell(cell, seed, 0.3, False, "cpu", time.perf_counter(), runner=runner)


@pytest.mark.parametrize("workload", ["neox-tiny.train", "neox-tiny.score"])
def test_a_sound_run_is_correct_and_prints_its_numbers(workload):
    r = _run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(cells.load_cell(BENCH, workload, DATA).limits)
    names = {m["name"] for m in cells.load_cell(BENCH, workload, DATA).end_to_end}
    assert set(r["metrics"]) == names and all(m["value"] > 0 for k, m in r["metrics"].items() if "peak" not in k)


@pytest.mark.parametrize("workload,fault", [
    ("neox-tiny.train", "half_batch"),
    ("neox-tiny.train", "unchanged"),
    ("neox-tiny.score", "half_batch"),
    ("neox-tiny.score", "stale_answer"),
    ("neox-tiny.score", "rows_reversed"),
])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    assert not _run(workload, fault)["correct"]


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["thunder_tpu_torch", "thunder_tpu_torch.api", "h100bench", "jaxtyping", "torch"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["thunder_tpu", "jax.numpy", "flax.linen", "jaxlib"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "thunder_tpu"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(CHECKOUT)!r})\n"
        "from h100bench import cells, harness\n"
        "from h100bench.run import forbidden_modules\n"
        f"bench = cells.load_json({str(DATA / 'bench.json')!r})\n"
        "for w in ('neox-tiny.train', 'neox-tiny.score'):\n"
        f"    harness.run_cell(cells.load_cell(bench, w, root=cells.Path({str(DATA)!r})), 3, 0.2, False, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps(forbidden_modules(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "h100bench/run.py", "--workload", "pythia-410m.score.w2048", "--seed",
                           "5", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_the_command_refuses_a_machine_without_the_card():
    out = _command(CHECKOUT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "h100bench", tmp_path / "h100bench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "thunder_tpu_torch" in out.stderr
