"""The port's bench driver and attention microbenchmark against the JAX
scripts, on the CPU.

``thunder_tpu_torch.scripts.bench`` (the counterpart of ``bench.py``'s
driver) at gpt-tiny (2 layers, B=2 x T=64, 3 iterations, ``--device cpu``):

- its JSON line holds every key of ``bench.py``'s (read from ``bench.py``'s
  own source; ``BENCH_r05.json``'s committed line is a subset) and of its
  compile phases, and ``device_spec``; nothing else;
- its first training loss, and the loss after the async iterations, equal
  the JAX ``build_train`` step's at the same weights, carried across (bf16
  weights and arithmetic: ``tests/framework.py``'s bf16 tolerance);
- against a planted round of the port's ``H100_BENCH`` series its deltas
  and regressions are JAX ``compare_rounds``'s; with none, ``vs_rev`` is
  null and the deltas empty;
- the light roofline mode writes a round whose invariants hold under both
  packages' ``perf_report``.

``thunder_tpu_torch.scripts.bench_attn`` at B=1 H=2 T=128 D=100:
``chain_time``'s calls, and every route against the materialized one (on
the CPU the kernel routes are their plain versions). No timing order is
asserted on the CPU.
"""

import ast
import copy
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.models import gpt as jgpt

from thunder_tpu_torch.models import gpt as tgpt
from thunder_tpu_torch.scripts import bench, bench_attn
from thunder_tpu_torch.scripts import perf_report as tpr

from framework import tolerances

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

import perf_report as jpr  # noqa: E402

ARGS = ["--model", "gpt-tiny", "--layers", "2", "--seq", "64", "--iters", "3", "--device", "cpu"]


def _jax_bench_keys() -> tuple[list, list]:
    """The keys ``bench.py``'s ``main`` puts in its line (``prev_round``
    only beside a committed round) and those of ``_bench_train``'s compile
    phases, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    line, phases = [], []
    for fn, name, out in ((fns["main"], "result", line), (fns["_bench_train"], "phases", phases)):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == name and isinstance(node.value, ast.Dict):
                out += [k.value for k in node.value.keys]
            elif isinstance(target, ast.Subscript) and getattr(target.value, "id", None) == name:
                out.append(target.slice.value)
    return [k for k in dict.fromkeys(line) if k != "prev_round"], list(dict.fromkeys(phases))


@pytest.fixture(scope="module")
def line():
    return bench.run(bench.parse_args(ARGS))


def test_the_line_has_every_key_of_bench_py(line):
    keys, phases = _jax_bench_keys()
    assert list(bench.BENCH_KEYS) == keys and list(bench.COMPILE_PHASE_KEYS) == phases
    assert set(k for k in line if not k.startswith("_")) == set(keys) | {"device_spec"}
    assert set(line["train_compile_phases"]) == set(phases)
    committed = json.load(open(os.path.join(REPO, "BENCH_r05.json")))["parsed"]
    assert set(committed) <= set(line)
    json.dumps({k: v for k, v in line.items() if not k.startswith("_")})  # the line serializes


def test_the_line_reads_the_run(line):
    assert line["device_spec"] == "cpu" and line["metric"] == "gpt-tiny_train_iter_b2_t64_l2"
    assert line["vs_rev"] is None and line["deltas_vs_prev"] == {} and line["regressions_vs_prev"] == []
    train = line["_train"]
    assert np.isfinite(train["loss0"]) and train["loss_last"] < train["loss0"]
    n_sync, n_strict = bench.protocol_iters(3)
    assert train["steps"] == 2 + 3 + n_sync + n_strict and bench.protocol_iters(45) == (20, 10)
    assert line["timing_protocol"] == "async_3iter_chain_single_sync"
    assert line["train_compile_phases"]["comm_schedule_moves"] == 0
    assert line["recompile_count"] == 3  # 8 batch sizes, 4 pow2 buckets: 1 compile and 3 recompiles
    attr = line["attribution"]
    assert attr["coverage_pct"] > 90 and len(attr["top5"]) == 5 and attr["topk"]
    assert all(set(r) == {"line", "sym", "pass", "us_per_step", "share_pct", "flops", "bytes", "roofline_us",
                          "achieved_frac", "bound"} for r in attr["topk"])
    # MFU on the cpu spec is a number, and perf_report does not gate it.
    cur = dict(line, _device_spec="cpu")
    assert not tpr.mfu_comparable("train_mfu", cur)


def test_first_losses_equal_the_jax_build_train(line):
    """The bench's step at the JAX ``build_train``'s weights (gpt-tiny, bf16,
    seed 0, carried across), on the same tokens: the first loss and the
    loss after 2 + 3 steps."""
    import bench as jbench

    jcfg = jgpt.name_to_config("gpt-tiny")
    jparams = jgpt.init_params(jcfg, dtype=jdtypes.bfloat16, device_init=True, seed=0)
    tparams = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jfn, flat, idx, tgt, *_ = jbench.build_train("gpt-tiny", 2, 64)
    jlosses = []
    for _ in range(5):
        flat, loss = jfn(flat, idx, tgt)
        jlosses.append(float(np.asarray(loss)))
    tcfg = tgpt.name_to_config("gpt-tiny")
    got = bench._bench_train(tcfg, 2, 64, 3, torch.device("cpu"), params=tparams)
    tol = tolerances(torch.bfloat16)
    np.testing.assert_allclose([got["loss0"], got["loss_last"]], [jlosses[0], jlosses[-1]], **tol)


def test_deltas_against_a_planted_port_round_are_compare_rounds(line, tmp_path, capsys):
    cur = {k: v for k, v in line.items() if not k.startswith("_") and k not in ("vs_rev", "deltas_vs_prev",
                                                                               "regressions_vs_prev")}
    prev = dict(cur, value=cur["value"] / 1.5, train_iter_synced_s=cur["train_iter_synced_s"] * 1.01,
                trace_cache_lookup_us=cur["trace_cache_lookup_us"] + 50.0)
    d = str(tmp_path)
    json.dump({"n": 7, "parsed": prev}, open(os.path.join(d, "H100_BENCH_r07.json"), "w"))
    json.dump({"parsed": dict(prev, value=1e9)}, open(os.path.join(d, "BENCH_r09.json"), "w"))  # a JAX name: not read
    got = bench.add_deltas(copy.deepcopy(cur), root=d)
    label, pm = jpr.load_round(os.path.join(d, "H100_BENCH_r07.json"))
    deltas, regs = jpr.compare_rounds(pm, dict(cur, _metric_name=cur["metric"]), threshold=0.10)
    assert (got["vs_rev"], got["prev_round"], got["deltas_vs_prev"], got["regressions_vs_prev"]) == \
        (label, label, deltas, regs)
    assert label == "r07" and any(r.startswith("value ") for r in regs) and "value" in deltas
    assert "WARNING: regression vs r07" in capsys.readouterr().err
    none = bench.add_deltas(copy.deepcopy(cur), root=str(tmp_path / "empty"))
    assert none["vs_rev"] is None and none["deltas_vs_prev"] == {} and "prev_round" not in none


def test_roofline_round_holds_under_both_gates(tmp_path):
    out = str(tmp_path / "H100_ROOFLINE_r01.json")
    assert bench.main(["--roofline-out", out, "--device", "cpu", "--seq", "16"]) == 0
    doc = json.load(open(out))
    assert doc["probes"] == 3 and doc["device_spec"] == "cpu" and doc["metric"] == "roofline_gpt_tiny_fwd"
    newest = tpr.load_round(out)
    assert newest == jpr.load_round(out)
    assert tpr._roofline_failures(newest) == jpr._roofline_failures(newest) == []
    g = io.StringIO()
    assert tpr.run_history_gate([out], gate=True, out=g) == 0 and "absolute invariants only" in g.getvalue()


# -- bench_attn ---------------------------------------------------------------


def test_chain_time_runs_the_chain():
    calls = []
    t = bench_attn.chain_time(lambda s: calls.append(s) or s + 1, 0, torch.device("cpu"), n_short=2, n_long=5)
    assert isinstance(t, float) and len(calls) == 1 + 2 + 2 + 5
    assert calls[1:3] == [0, 1] and calls[3:5] == [0, 1] and calls[5:] == [0, 1, 2, 3, 4]


def test_routes_against_the_materialized_one():
    res = bench_attn.run(1, 2, 128, 100, device="cpu", n_short=1, n_long=2, out=io.StringIO())
    routes = {r["route"]: r for r in res["routes"]}
    assert list(routes) == ["splash", "legacy", "materialized", "sdpa"] and res["shape"]["D"] == 100
    for name in ("splash", "legacy", "materialized"):
        r = routes[name]
        assert not r["yardstick"]
        # On the CPU each route is its kernels' plain version: the
        # materialized route's arithmetic exactly.
        assert r["maxerr"] == r["row_rel_err"] == r["bwd_maxerr"] == r["bwd_row_rel_err"] == 0.0, r
        assert r["fwd_ms"] is not None and r["fwd_bwd_ms"] is not None
    sdpa = routes["sdpa"]
    assert sdpa["yardstick"] and sdpa["row_rel_err"] <= 2.0 ** -6 and sdpa["bwd_row_rel_err"] <= 2.0 ** -4
    assert bench_attn.flops_fwd(2, 32, 2048, 100) == 2 * 2 * 2 * 32 * 2048 * 2048 * 100 / 2
