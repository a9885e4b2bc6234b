"""The port's runnable tools against the JAX package's, on the CPU.

``thunder_tpu_torch.scripts.lint_traces`` (the counterpart of
``scripts/lint_traces.py``), ``profile_train`` and ``perf_report
--trace-dir`` (of ``scripts/profile_train.py`` and ``scripts/perf_report.py``):

- the default corpus through both CLIs (the name filter "-", which every
  program's name holds: the JAX CLI's unfiltered run adds its committed
  series gates): 0 errors in each, the same program names in the same
  order;
- ``--events`` on one log and on two merged logs written by the port's
  ``jit(events=...)`` (``test_lint_traces_cli``,
  ``tests/test_observability.py:580``, and
  ``test_lint_traces_cli_merges_multiple_logs``,
  ``tests/test_perf_attribution.py:587``); a record missing its fields is
  an ERROR, exit 1;
- exit 2 on a bad ``--storm-threshold``, a ``--device`` with no value, and
  ``perf_report`` with no mode; ``--soak`` and ``--federation`` run their
  smokes (``tests/test_torch_port_soak_ranks.py``) and no longer wait, and a
  bad flag beside them still exits 2 (``--multichip`` and ``perf_report
  --history``/``--gate`` run too: ``tests/test_torch_port_bench_multichip_ranks.py``,
  ``test_torch_port_perf_history.py``);
- ``--static``, ``--schedule``, ``--chaos``, ``--ops``, ``--roofline`` and
  ``--critpath`` on ``--device cpu`` exit 0 (run side by side, a process
  each, every output in a file);
- ``perf_report --trace-dir`` on a Chrome trace built here (an eager step's
  ranges and a CUDA graph's replay placed by a launch-order map written
  beside it) names the ``L<idx>.linear`` row and every graph kernel placed;
- ``profile_train --device cpu --layers 1`` at gpt-tiny's size writes a
  directory that ``perf_report`` reads, with the ``--model`` join.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
SMOKES = ["--static", "--schedule", "--chaos", "--ops", "--roofline", "--critpath"]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               THUNDER_TPU_RETRY_BACKOFF_S="0", **extra)
    return env


def _start(cmd: list, log: str) -> subprocess.Popen:
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=_env(), cwd=REPO)
    p.log = log
    return p


def _finish(procs: dict) -> dict:
    """``{key: (returncode, output)}`` once every process ended."""
    try:
        for p in procs.values():
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {k: (p.returncode, open(p.log).read()) for k, p in procs.items()}


def _port(*args) -> list:
    return [sys.executable, "-m", "thunder_tpu_torch.scripts.lint_traces", *args]


def _run(cmd: list, tmp_path, name="out") -> tuple:
    return _finish({0: _start(cmd, str(tmp_path / f"{name}.log"))})[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two CLIs' corpus runs and the port's six smokes, side by side."""
    d = tmp_path_factory.mktemp("lint")
    procs = {"jax": _start([sys.executable, os.path.join(REPO, "scripts", "lint_traces.py"), "-"],
                           str(d / "jax.log")),
             "port": _start(_port("-", "--device", "cpu"), str(d / "port.log"))}
    procs.update({m: _start(_port(m, "--device", "cpu"), str(d / f"{m[2:]}.log")) for m in SMOKES})
    return _finish(procs)


def _names(out: str) -> list:
    return [line.split(":", 1)[1].strip() for line in out.splitlines() if line.startswith("--- ")]


def test_corpus_through_both_clis(runs):
    (jrc, jout), (prc, pout) = runs["jax"], runs["port"]
    assert jrc == 0 and "lint_traces: 0 error(s)" in jout, jout[-3000:]
    assert prc == 0 and "lint_traces: 0 error(s)" in pout, pout[-3000:]
    assert _names(pout) == _names(jout)
    assert len(_names(pout)) == 9 and "gpt-tiny-backward-autocast" in _names(pout)


@pytest.mark.parametrize("mode", SMOKES)
def test_smoke_passes_on_the_cpu(runs, mode):
    rc, out = runs[mode]
    assert rc == 0, out[-4000:]
    assert f"lint_traces {mode}: 0 error(s)" in out
    assert "FAILED" not in out


def _events_log(path: str, fn=tclang.abs) -> list:
    jf = tt.jit(lambda x: fn(x), device="cpu", events=path)
    jf(torch.ones(2))
    return [json.loads(line) for line in open(path) if line.strip()]


def test_events_cli_one_log(tmp_path):
    log = str(tmp_path / "cli.jsonl")
    _events_log(log)
    rc, out = _run(_port("--events", log), tmp_path)
    assert rc == 0, out
    assert "0 error(s)" in out


def test_events_cli_merges_multiple_logs(tmp_path):
    log0, log1 = str(tmp_path / "h0.jsonl"), str(tmp_path / "h1.jsonl")
    recs = _events_log(log0, tclang.tanh)
    with open(log1, "w") as f:
        for r in recs:
            r["host"] = 1
            f.write(json.dumps(r) + "\n")
    rc, out = _run(_port("--events", log0, log1, "--storm-threshold", "8"), tmp_path)
    assert rc == 0, out
    assert f"{len(recs) * 2} records" in out


def test_events_cli_planted_error_exits_1(tmp_path):
    log = str(tmp_path / "bad.jsonl")
    recs = _events_log(log)
    with open(log, "a") as f:
        f.write(json.dumps({"v": recs[0]["v"], "kind": "compile_end", "ts": 1.0}) + "\n")
    rc, out = _run(_port("--events", log), tmp_path)
    assert rc == 1, out
    assert "events.missing-fields" in out


@pytest.mark.parametrize("args", [
    ["--events", "x.jsonl", "--storm-threshold", "many"],
    ["--events", "x.jsonl", "--storm-threshold"],
    ["--events"],
    ["--device"],
    ["--soak", "--device"],
    ["--federation", "--device"],
], ids=["storm-word", "storm-missing", "events-no-log", "device-no-value", "soak-device-no-value",
        "federation-device-no-value"])
def test_usage_errors_and_waiting_modes_exit_2(args, tmp_path):
    from thunder_tpu_torch.scripts import lint_traces

    assert lint_traces.main(list(args)) == 2


@pytest.mark.parametrize("mode,smoke", [("--soak", "_soak_smoke"), ("--federation", "_federation_smoke")],
                         ids=["soak", "federation"])
def test_soak_and_federation_no_longer_wait(mode, smoke, monkeypatch, capsys):
    """Each mode runs its smoke (stubbed here: the smokes run on gloo ranks in
    ``tests/test_torch_port_soak_ranks.py``) and returns its verdict; no line
    says it waits."""
    from thunder_tpu_torch.scripts import lint_traces

    calls = []
    monkeypatch.setitem(lint_traces._SMOKES, mode, lambda: calls.append(mode) or 0)
    assert getattr(lint_traces, smoke) is not None
    assert lint_traces.main([mode]) == 0 and calls == [mode]
    monkeypatch.setitem(lint_traces._SMOKES, mode, lambda: 3)
    assert lint_traces.main([mode]) == 1
    assert "waits" not in capsys.readouterr().out


def test_each_call_resolves_its_own_device(monkeypatch):
    """``--device cpu`` on one call does not carry over to the next: a call
    without it asks for the card, and with none raises."""
    from thunder_tpu_torch.scripts import lint_traces

    assert lint_traces.main(["reduction-mix", "--device", "cpu"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint_traces.main(["reduction-mix"])


@pytest.mark.parametrize("args", [[]], ids=["nothing"])
def test_perf_report_waiting_modes_exit_2(args, capsys):
    from thunder_tpu_torch.scripts import perf_report

    assert perf_report.main(args) == 2
    assert "usage: perf_report" in capsys.readouterr().out


HOST = dict(pid=10, tid=11)
STREAM = dict(pid=0, tid=7)


def _range(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, args={"External id": 0}, **HOST)


def _launch(name, ts, corr):
    return dict(ph="X", cat="cuda_runtime", name=name, ts=ts, dur=2.0, args={"correlation": corr}, **HOST)


def _kernel(name, ts, dur, corr):
    return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur, args={"correlation": corr, "stream": 7}, **STREAM)


def test_perf_report_trace_dir_names_the_linear_line(tmp_path):
    """An eager step: L3.linear's range launches a cuBLAS kernel, L4.sum's a
    reduction; then two steps of a CUDA graph's replay, whose kernels the
    launch-order map beside the trace places on L3 and L4."""
    evs = [_range("thunder_step#0", 0.0, 200.0),
           _range("L3.linear#Delete_Last_Used", 10.0, 60.0), _launch("cudaLaunchKernel", 20.0, 1),
           _kernel("nvjet_tst_128x256", 30.0, 40.0, 1),
           _range("L4.sum#Delete_Last_Used", 80.0, 40.0), _launch("cudaLaunchKernel", 90.0, 2),
           _kernel("reduce_kernel", 100.0, 10.0, 2)]
    for step, t0 in ((1, 300.0), (2, 800.0)):
        evs += [_range(f"thunder_step#{step}", t0, 400.0), _launch("cudaGraphLaunch", t0 + 10, 10 + step),
                _kernel("nvjet_tst_128x256", t0 + 50, 40.0, 10 + step),
                _kernel("reduce_kernel", t0 + 100, 10.0, 10 + step)]
    with open(tmp_path / "thunder_step.trace.json", "w") as f:
        json.dump({"traceEvents": evs}, f)
    with open(tmp_path / "launch_map.json", "w") as f:
        json.dump([["nvjet_tst_128x256", "L3.linear#Delete_Last_Used"], ["reduce_kernel", "L4.sum#Delete_Last_Used"]],
                  f)
    from thunder_tpu_torch.scripts import perf_report

    join = perf_report.attribution_of(str(tmp_path), steps=3)
    attr = join.attribution
    assert attr.graph_ops == 4 and attr.graph_placed == 4 and attr.graph_mismatched == 0
    assert attr.coverage == pytest.approx(1.0)
    by = {r.label: r.measured_us for r in join.rows}
    assert by["L3.linear#Delete_Last_Used"] == pytest.approx(40.0)
    assert by["L4.sum#Delete_Last_Used"] == pytest.approx(10.0)
    rc, out = _run([sys.executable, "-m", "thunder_tpu_torch.scripts.perf_report", "--trace-dir", str(tmp_path),
                    "--steps", "3"], tmp_path, "report")
    assert rc == 0, out
    assert "L3.linear#Delete_Last_Used" in out
    assert "100.0% of device time attributed" in out and "graph kernels 4 of 4 placed" in out


def test_profile_train_dir_reads_back_with_the_cost_join(tmp_path):
    out_dir = tmp_path / "prof"
    rc, out = _run([sys.executable, "-m", "thunder_tpu_torch.scripts.profile_train", str(out_dir), "--device", "cpu",
                    "--model", "gpt-tiny", "--layers", "1", "--seq", "64"], tmp_path, "profile")
    assert rc == 0, out[-3000:]
    meta = json.load(open(out_dir / "meta.json"))
    assert (meta["model"], meta["layers"], meta["steps"], meta["launch_map"]) == ("gpt-tiny", 1, 3, None)
    # Every row is asked for: the check is of the join, not of the rows'
    # order by profiled CPU time, which load on the host reshuffles.
    from thunder_tpu_torch.scripts import perf_report

    n_rows = len(perf_report.attribution_of(str(out_dir)).rows)
    rc, report = _run([sys.executable, "-m", "thunder_tpu_torch.scripts.perf_report", "--trace-dir", str(out_dir),
                       "--model", "gpt-tiny", "--top", str(n_rows)], tmp_path, "report")
    assert rc == 0, report[-3000:]
    assert "(3 step(s) profiled)" in report and "cost model [h100]" in report
    rows = [line.split()[0] for line in report.splitlines() if line.strip().startswith("L")]
    assert any(".sdpa_fwd_res#" in r for r in rows) and any(".linear#" in r for r in rows)
    # The join prices the step profiled: a flag that differs from meta.json
    # is refused, not priced on another program.
    for flags in (["--seq", "2048"], ["--model", "open_llama_3b"], ["--batch", "4"]):
        assert perf_report.main(["--trace-dir", str(out_dir), "--model", "gpt-tiny", *flags]) == 2
    assert perf_report.join_shape(meta, "gpt-tiny", 2, 64) == ("gpt-tiny", 2, 64, 1)
