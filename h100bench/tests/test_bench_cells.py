"""BENCHMARK.json and the files it names: found by name, and within the
rules of the benchmark's description."""

import json
import re
import shutil
from pathlib import Path

import pytest

from h100bench import cells, harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = cells.load_json(ROOT.parent / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion", "experts_per_tok")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"] and BENCH["command"][1] == "h100bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lengths():
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_hold_what_is_run():
    for conf in BENCH["configs"]:
        c = cells.load_json(ROOT.parent / conf["file"])
        assert conf["file"].startswith("h100bench/configs/") and c["source"] == conf["source"]
        assert c["reduced"] == conf["reduced"]
        for key in conf["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")) and not any(w in key for w in WIDTHS), key
        assert c["model_type"] == "gpt_neox"


def test_each_cell_loads_by_name_and_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = cells.load_cell(BENCH, w["name"])
        assert cell.chips == 1 and harness.runner_class(cell.traffic["kind"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert set(cell.limits) == ({"loss_gap", "grad_gap", "grad_diff", "change_gap"} if cell.traffic["kind"] == "train"
                                    else {"token_gap_rms"})
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


def test_each_reader_declares_what_benchmark_json_says():
    for m in BENCH["per_layer"]:
        reader = cells.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"]), m["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert {"kernels", "device", "executors"} <= set(layers)


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A configuration, a mix, a metric and a kernel group added as files
    are found by name, with no file of the harness edited."""
    for sub in ("configs", "traffic", "limits", "metrics", "kernels"):
        shutil.copytree(ROOT / sub, tmp_path / sub)
    conf = cells.load_json(ROOT / "configs" / "pythia-410m.json")
    conf["num_hidden_layers"] = 12
    (tmp_path / "configs" / "pythia-160m-ish.json").write_text(json.dumps(conf))
    mix = cells.load_json(ROOT / "traffic" / "score-w2048-b8.json")
    mix["batch"] = 32
    (tmp_path / "traffic" / "score-short-b32.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / "x.score.short.json").write_text('{"token_gap_rms": 0.01}')
    (tmp_path / "metrics" / "calls.score.py").write_text(
        'LAYER = "entry and dispatch"\nUNIT = "calls"\nMOVES = "score_tokens_per_s"\n\n\n'
        'def read(run):\n    return len(run.window["records"])\n')
    (tmp_path / "kernels" / "moe.json").write_text('{"order": 60, "patterns": ["moe_"]}')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "x", "file": "h100bench/configs/pythia-160m-ish.json"})
    bench["workloads"].append({"name": "x.score.short", "config": "x", "traffic": "score-short-b32", "chips": 1})
    bench["per_layer"].append({"name": "calls.score", "unit": "calls", "moves": "score_tokens_per_s",
                               "workloads": ["x.score.short"]})
    bench["end_to_end"] = [dict(m, workloads=m.get("workloads", []) + ["x.score.short"]) if "score" in m["name"]
                           else m for m in bench["end_to_end"]]
    cell = cells.load_cell(bench, "x.score.short", root=tmp_path)
    assert cell.dims.layers == 12 and cell.traffic["batch"] == 32
    assert [m["name"] for m in cell.per_layer] == ["calls.score"]
    assert cells.metric_reader("calls.score", tmp_path).read(type("R", (), {"window": {"records": [1, 2]}})) == 2
    assert "moe" in dict(cells.kernel_groups(tmp_path))
    with pytest.raises(KeyError):
        cells.load_cell(bench, "no.such.cell", root=tmp_path)


def test_runners_are_found_by_the_mix_kind():
    from h100bench.runners import score, train

    assert harness.runner_class("train") is train.Runner and harness.runner_class("score") is score.Runner
    with pytest.raises(ModuleNotFoundError):
        harness.runner_class("no_such_kind")
