"""Context, pipeline and expert parallelism and the sharded step over pp, ep
and sp (ROADMAP 11b), on 2 and 4 gloo ranks against the JAX package.

The ranks run the "@parallel" scenarios of ``tests/_torch_port_dist_worker.py``
(one spawn a world size, meeting on a FileStore under the test's temporary
directory); the JAX side runs the same scenarios over as many virtual CPU
devices, in three processes (2 devices; 4 devices, the scenarios in two
halves) beside them. Every spawn writes its output to a file and has
``SPAWN_TIMEOUT_S``. Each rank also holds its results against the
scenario's own oracle (plain attention, the dense MoE, the stages applied in
sequence, the port's one-device program) before it reports them.

The JAX scenarios of ``tests/_dist_worker.py`` use 8 devices; here they run
at 4, with these reduced sizes:
- ``ring_attention`` and ``ulysses_attention``: sp=4, the shapes (2, 4, 64,
  16) and (2, 8, 64, 16) unchanged;
- ``long_context_train``: sp=4, (B, H, S, D, V) = (2, 2, 128, 8, 32)
  unchanged;
- ``moe_ep`` and ``moe_capacity``: ep=4 with E=8 experts and 32 tokens (2
  experts and 8 tokens a rank, as at 8 ranks with 16 and 64);
- ``pipeline_pp``: pp=4, 4 stages in place of 8;
- ``gpt_pipeline``: pp=4, 4 layers, unchanged; XLA's ``temp_size_in_bytes``
  becomes ``analysis/liveness.plan_liveness`` of the claimed programs.

The compiled-program audit of the fsdp2·tp2 step (``hlo_audit_fsdp_tp``,
ROADMAP item 13) rides in the same spawn, beside the JAX package's audit of
its compiled step on 4 virtual devices.

Tolerances are the scenarios' own: values rtol 1e-4, atol 1e-5 (GPipe 1e-5,
1e-6), grads 1e-3, 1e-4 (long context 1e-3, 1e-5; GPipe 1e-4, 1e-5), drops
2e-3, 2e-4, the pipelined GPT's loss 2e-5 and grads 1e-2, 3e-4; the sharded
step's losses within 1e-5 and its SGD params within 1e-5 of each leaf's
largest value (``test_sharded_train_step``'s).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_port_dist_worker import JAX_PARALLEL_SCENARIOS  # noqa: E402
from test_torch_port_distributed_ranks import WORKER, _env, _results, _start_ranks, _wait  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    # The JAX side in three processes, the 4-device scenarios in two halves,
    # beside the two spawns of ranks.
    four = JAX_PARALLEL_SCENARIOS[4]
    jax_runs = [(2, root / "jax2", JAX_PARALLEL_SCENARIOS[2]), (4, root / "jax4a", four[:len(four) // 2]),
                (4, root / "jax4b", four[len(four) // 2:])]
    jax_procs = []
    for n, d, names in jax_runs:
        d.mkdir()
        with open(d / "jax.log", "w") as f:
            p = subprocess.Popen([sys.executable, WORKER, "jax", str(n), str(d), ",".join(names)],
                                 env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"),
                                 stdout=f, stderr=subprocess.STDOUT, text=True)
        p.log = str(d / "jax.log")
        jax_procs.append(p)
    ranks = {n: _start_ranks(n, str(root / f"torch{n}"), "", "@parallel") for n in (4, 2)}
    try:
        for n, procs in ranks.items():
            _wait(procs, f"the {n}-rank spawn")
    finally:
        _wait(jax_procs, "the JAX package's run")
    jax_results = {2: {}, 4: {}}
    for n, d, _ in jax_runs:
        jax_results[n].update(json.load(open(d / "jax.json")))
    return {n: _results(n, str(root / f"torch{n}")) for n in ranks}, jax_results


def _ranks(runs, world: int, name: str) -> list:
    """Every rank's result of ``name``, each checked to have passed."""
    out = []
    for r, res in runs[0][world].items():
        if name not in res:
            failed = [k for k, v in res.items() if not v["ok"]]
            pytest.fail(f"rank {r} did not run {name}: scenario {failed} failed before it:\n"
                        + "".join(res[k]["error"] for k in failed))
        assert res[name]["ok"], f"rank {r}, {name}:\n{res[name]['error']}"
        out.append(res[name])
    return out


def _jax(runs, world: int, name: str) -> dict:
    res = runs[1][world][name]
    assert res["ok"], res.get("error")
    return res


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("perm", ["ring", "chain"])
@pytest.mark.parametrize("world", [2, 4])
def test_ppermute_and_all_to_all_vjps(runs, world, perm):
    """The grad of sum(w · ppermute(x)) over a ring and over an open chain
    (the pipeline's hop: the first rank receives zeros, the last sends
    nothing), and of sum(u · all_to_all(x)), through the VJP rules, equal
    to the grads worked out by hand (the worker held them at 1e-6); the
    backward holds a transposed hop and shuffle for each forward one."""
    for res in _ranks(runs, world, f"vjp_{perm}"):
        assert res["max_err"] < 1e-6


@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_attention(runs, name):
    """Ring (ppermute) and Ulysses (all_to_all) attention over sp=4: the
    output against the JAX package's (rtol 1e-4, atol 1e-5), and the ring's
    grads of sum(out²) against ``jax.grad``'s (1e-3, 1e-4). Both sides'
    grads were held against plain attention on the ranks; ``jax.grad``
    through Ulysses' untiled all_to_all fails in the JAX package, so
    Ulysses' grads are held there only."""
    jres = _jax(runs, 4, name)
    for res in _ranks(runs, 4, name):
        _close(res["out"], jres["out"], 1e-4, 1e-5)
        assert res["collectives"] == (["ppermute"] if name == "ring_attention" else ["all_to_all"])
        for got, want in zip(res["grads"], jres.get("grads", ())):
            _close(got, want, 1e-3, 1e-4)
        assert len(res["grads"]) == 3


def test_long_context_train(runs):
    """The sequence-parallel LM step over sp=4: the loss within 1e-5 of the
    JAX package's, the grads of wq and wo within 1e-3, 1e-5."""
    jres = _jax(runs, 4, "long_context_train")
    for res in _ranks(runs, 4, "long_context_train"):
        _close(res["loss"], jres["loss"], 1e-5)
        for got, want in zip(res["grads"], jres["grads"]):
            _close(got, want, 1e-3, 1e-5)


def test_moe_expert_parallel(runs):
    """``moe_ep`` at ep=4: the no-drop output (1e-4, 1e-5) and the router,
    w1 and w2 grads (1e-3, 1e-4) against the JAX package's; capacity 1's
    lossy output against its too (2e-3, 2e-4)."""
    jres = _jax(runs, 4, "moe_ep")
    for res in _ranks(runs, 4, "moe_ep"):
        _close(res["out"], jres["out"], 1e-4, 1e-5)
        for got, want, name in zip(res["grads"], jres["grads"], ("router", "w1", "w2")):
            _close(got, want, 1e-3, 1e-4, name)
        _close(res["dropped"], jres["dropped"], 2e-3, 2e-4)


def test_moe_capacity_drops(runs):
    """``moe_capacity`` at ep=4, C=1: assignments were dropped (the count
    matched the host replication of the slot accounting on every rank), the
    output against the JAX package's (2e-3, 2e-4), and 15 SGD steps under
    drops: the first loss within 1e-4 of the JAX package's, the last under
    0.4 of the first."""
    jres = _jax(runs, 4, "moe_capacity")
    for res in _ranks(runs, 4, "moe_capacity"):
        assert 0 < res["dropped"] < res["total"]
        _close(res["out"], jres["out"], 2e-3, 2e-4)
        _close(res["losses"][0], jres["losses"][0], 1e-4)
        assert res["losses"][-1] < 0.4 * res["losses"][0]


def test_gpipe_pipeline(runs):
    """``pipeline_pp`` at pp=4: the GPipe output (1e-5, 1e-6) and the grads
    of W and b (1e-4, 1e-5) against the JAX package's; 25 pipelined SGD
    steps, the first loss within 1e-5 of the JAX package's, the last under
    0.6 of the first."""
    jres = _jax(runs, 4, "pipeline_pp")
    for res in _ranks(runs, 4, "pipeline_pp"):
        _close(res["out"], jres["out"], 1e-5, 1e-6)
        for got, want in zip(res["grads"], jres["grads"]):
            _close(got, want, 1e-4, 1e-5)
        _close(res["losses"][0], jres["losses"][0], 1e-5)
        assert res["losses"][-1] < 0.6 * res["losses"][0]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_gpt_pipeline(runs, schedule):
    """The 4-layer GPT split embed → blocks → head over pp=4: the loss
    within 2e-5 and every grad leaf within rtol 1e-2, atol 3e-4 of the JAX
    package's ``gpt_pp_loss_and_grads`` (the ranks held both against the
    port's one-device program too)."""
    jres = _jax(runs, 4, "gpt_pipeline")[schedule]
    for res in _ranks(runs, 4, "gpt_pipeline"):
        got = res[schedule]
        _close(got["loss"], jres["loss"], 2e-5)
        assert got["grads"].keys() == jres["grads"].keys()
        for leaf, want in jres["grads"].items():
            _close(got["grads"][leaf], want, 1e-2, 3e-4, leaf)


def test_gpt_pipeline_memory_and_training(runs):
    """1F1B's stash held at most n_stages inputs; GPipe's planned peak grows
    from 4 to 16 microbatches, 1F1B's does not and is below GPipe's; 8
    pipelined SGD steps take the loss down by more than 0.3."""
    for res in _ranks(runs, 4, "gpt_pipeline"):
        peaks = res["peaks"]
        assert peaks["gpipe16"] > peaks["gpipe4"]
        assert peaks["1f1b16"] == peaks["1f1b4"] < peaks["gpipe16"]
        assert res["losses"][-1] < res["losses"][0] - 0.3


STEP_CASES = [(2, "sp_train"), (2, "pp_train"), (2, "ep_train"), (4, "dp_sp_train"), (4, "fsdp_sp_train"),
              (4, "sp_tp_train")]


@pytest.mark.parametrize("world,name", STEP_CASES)
def test_sharded_step_over_pp_ep_sp(runs, world, name):
    """``build_train_step(mesh=...)`` over sp2, pp2, ep2, dp2·sp2,
    fsdp2·sp2 and sp2·tp2, two SGD steps: the losses within 1e-5 of the
    JAX package's sharded step and of the port's one-device step, the same
    on every rank; the gathered params within 1e-5 of the JAX package's and
    of one device's, relative to each leaf's largest value. An sp mesh
    rings its attention (ppermute); pp and ep name no collective."""
    jres = _jax(runs, world, name)
    results = _ranks(runs, world, name)
    for res in results:
        _close(res["losses"], jres["losses"], 1e-5)
        _close(res["losses"], res["ref_losses"], 1e-5)
        assert res["param_rel"] < 1e-5, res["param_rel"]
        assert res["params"].keys() == jres["params"].keys()
        for leaf, want in jres["params"].items():
            got, want = np.asarray(res["params"][leaf]), np.asarray(want)
            assert np.abs(got - want).max() / (np.abs(want).max() + 1e-12) < 1e-5, leaf
        assert res["losses"] == results[0]["losses"]
    assert results[0]["ring"] == ("sp" in name)
    if name in ("pp_train", "ep_train"):
        assert results[0]["collectives"] == []


def test_compiled_program_audit_on_ranks(runs):
    """``TestLivePjit``'s counterpart (``tests/test_hlo_audit.py:323``), the
    fsdp2·tp2 step of gpt-tiny on 4 gloo ranks, audited from the op record
    of one real step (``analysis/hlo_audit.audit_jitted``). The port's audit
    names all-gather and reduce-scatter sites with nonzero wire bytes, all
    explicit: a site a collective line of the claimed trace (every such line
    that ran), its wire bytes the line's ``cost`` wire bytes (the worker
    held them equal). Its one inserted site is the loss's sum over the data
    axis that ``build_train_step``'s step makes outside the claimed program;
    an all-reduce planted outside the trace is a second one, of 4096 bytes at
    the all-reduce factor 2(g-1)/g. One stream on the CPU: every site
    exposed. The JAX package's audit of its compiled step finds the same two
    families, every site inserted by the SPMD partitioner."""
    jres = _jax(runs, 4, "hlo_audit_fsdp_tp")
    assert jres["families"].get("all-gather", 0) >= 1 and jres["families"].get("reduce-scatter", 0) >= 1
    assert jres["explicit"] == 0 and jres["inserted"] == jres["sites"]
    for res in _ranks(runs, 4, "hlo_audit_fsdp_tp"):
        for fam in ("all-gather", "reduce-scatter"):
            assert res["explicit_families"][fam] == res["families"][fam] >= 1
            assert res["wire_bytes"][fam] > 0
        assert res["explicit"] == res["collective_lines"] and res["explicit_scopes"]
        assert [(f, w, g) for f, w, g, _ in res["inserted"]] == [("all-reduce", 4 * 1.5, 4)]
        assert res["planted_explicit"] == res["explicit"]
        assert sorted(w for _, w, _, _ in res["planted"]) == [6.0, 4096 * 1.5]
        assert res["single_stream"] and 0.0 < res["exposed_pct"] <= 100.0
