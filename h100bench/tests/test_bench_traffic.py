"""The traffic draws: the same for a seed, and the same work for every seed."""

from collections import Counter
from pathlib import Path

import pytest
import torch

from h100bench import cells
from h100bench.runners import score, train

ROOT = Path(__file__).resolve().parents[1]
BENCH = cells.load_json(ROOT.parent / "BENCHMARK.json")
DATA = ROOT / "tests" / "data"
TINY = cells.load_json(DATA / "bench.json")


def test_the_scoring_mix_is_whole_windows_of_the_context():
    t = cells.load_json(ROOT / "traffic" / "score-w2048-b8.json")
    assert score.length_set(t) == [2048]
    for conf in BENCH["configs"]:
        assert cells.load_json(ROOT.parent / conf["file"])["max_position_embeddings"] == 2048
    assert score.ceiling(2048, t["bucket"]) == 2048  # no padding


def test_a_lognormal_length_set_is_its_clipped_quantiles():
    t = {"length": {"median": 768, "sigma": 0.7, "min": 256, "max": 2048}, "lengths_per_cycle": 64}
    lengths = score.length_set(t)
    assert len(lengths) == 64 and lengths == sorted(lengths)
    assert min(lengths) >= 256 and max(lengths) == 2048
    assert abs(lengths[32] - 768) < 40


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 1])
def test_score_calls_repeat_for_a_seed_and_every_seed_scores_the_same_lengths_in_the_same_order(seed):
    cell = cells.load_cell(TINY, "neox-tiny.score", root=DATA)

    def calls(s):
        drv = score.Runner(cell, "cpu")
        drv.pool = drv.inputs(s)
        return [drv.next_call() for _ in range(2 * len(drv.lengths))]

    first = calls(seed)
    assert first == calls(seed)
    n = len(score.length_set(cell.traffic))
    for cycle in (first[:n], first[n:]):
        assert Counter(T for T, _ in cycle) == Counter(score.length_set(cell.traffic))
    other = calls(seed + 1)
    assert [T for T, _ in first] == [T for T, _ in other]  # the order is the same for every seed
    assert [r for _, r in first] != [r for _, r in other]  # the rows are the seed's
    assert [T for T, _ in first[:n]] != [T for T, _ in first[n:]]  # each cycle is shuffled anew


def test_train_schedule_repeats_and_rows_differ_within_an_epoch():
    cell = cells.load_cell(TINY, "neox-tiny.train", root=DATA)
    a, b = train.Runner(cell, "cpu"), train.Runner(cell, "cpu")
    a.load(2**32 + 3)
    b.load(2**32 + 3)
    assert torch.equal(a.sched, b.sched) and torch.equal(a.pool, b.pool)
    per_epoch = cell.traffic["pool_rows"] // cell.traffic["batch"]
    epoch = a.sched[:per_epoch].reshape(-1)
    assert len(set(epoch.tolist())) == epoch.numel()
    c = train.Runner(cell, "cpu")
    c.load(2**32 + 4)
    assert not torch.equal(a.sched, c.sched)


def test_weights_repeat_for_a_seed():
    cell = cells.load_cell(TINY, "neox-tiny.train", root=DATA)
    a = cells.flatten(cells.make_params(cell, 5, "cpu"))
    b = cells.flatten(cells.make_params(cell, 5, "cpu"))
    c = cells.flatten(cells.make_params(cell, 6, "cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte"], c["wte"])
    assert a["blocks.0.norm_1.weight"].dtype == torch.bfloat16
    assert abs(float(a["blocks.0.norm_1.weight"].float().mean()) - 1.0) < 0.01
