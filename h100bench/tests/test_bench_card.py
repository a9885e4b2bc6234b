"""On the card, at each cell's own size: its control, the program's own int8
path (the ``quant`` executor ahead of the default stack), is not correct.
Run with ``python -m pytest h100bench/tests -m cuda`` on the H100; skips
elsewhere."""

import time

import pytest

from h100bench import cells, control, harness

pytestmark = pytest.mark.cuda
BENCH = cells.load_json(cells.HERE.parent / "BENCHMARK.json")
SEED = 2**31 + 101


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    cell = cells.load_cell(BENCH, workload)
    runner = control.runner_for(cell.traffic["kind"], "control")
    r = harness.run_cell(cell, SEED, 4.0, False, "cuda:0", time.perf_counter(), runner=runner)
    assert not r["correct"], r["checks"]
