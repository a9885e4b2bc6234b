"""The port's distribution on 2 and 4 gloo ranks against the JAX package.

Each world size is one spawn: its ranks run every scenario of that size
(``tests/_torch_port_dist_worker.py``) in one go, meeting on a FileStore
under the test's temporary directory (no port, so parallel test workers
never collide), each scenario under a time limit of its own. The JAX side
runs the same scenarios once a size, in one process over as many virtual
CPU devices, as ``tests/test_distributed.py`` runs its own. The 4-rank
spawn runs first and saves the checkpoint that the 2-rank spawn loads. The
sharded training step's scenarios (``TRAIN_SCENARIOS``) run in spawns of
their own, a 4-rank and a 2-rank one beside the others.

Tolerances are the JAX scenarios' own: ``rtol=1e-4`` on values and losses,
``rtol=2e-4, atol=1e-5`` on grads; the collectives of small integers
agree exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_port_dist_worker.py")
SPAWN_TIMEOUT_S = 300


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "CUDA_VISIBLE_DEVICES")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", **extra)
    return env


def _wait(procs: list, what: str) -> None:
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        if p.returncode != 0:
            out = p.stdout.read() if p.stdout else open(p.log).read()
            pytest.fail(f"{what} exited {p.returncode}:\n{out[-4000:]}")


def _start_ranks(world: int, out: str, ckpt: str, scenarios: str = "") -> list:
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    procs = []
    for r in range(world):
        # Each rank writes to a file of its own: a pipe nobody reads while
        # the other spawns run could fill and stall the rank.
        log = os.path.join(out, f"rank{r}.log")
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, WORKER, "torch", str(r), str(world), store, out, ckpt]
                                 + ([scenarios] if scenarios else []), env=_env(), stdout=f,
                                 stderr=subprocess.STDOUT, text=True)
        p.log = log
        procs.append(p)
    return procs


def _results(world: int, out: str) -> dict:
    return {r: json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(world)}


def _spawn_ranks(world: int, out: str, ckpt: str) -> dict:
    _wait(_start_ranks(world, out, ckpt), f"the {world}-rank spawn")
    return _results(world, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    jax_dirs = {n: root / f"jax{n}" for n in (2, 4)}
    jax_procs = []
    for n, d in jax_dirs.items():
        d.mkdir()
        # Output to a file: XLA's warnings could fill a pipe that nobody
        # reads until the process ends, and stall it.
        with open(d / "jax.log", "w") as f:
            p = subprocess.Popen([sys.executable, WORKER, "jax", str(n), str(d)],
                                 env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"),
                                 stdout=f, stderr=subprocess.STDOUT, text=True)
        p.log = str(d / "jax.log")
        jax_procs.append(p)
    train = {n: _start_ranks(n, str(root / f"train{n}"), "", "@train") for n in (4, 2)}
    try:
        ckpt = str(root / "ckpt")
        torch_runs = {4: _spawn_ranks(4, str(root / "torch4"), ckpt)}
        torch_runs[2] = _spawn_ranks(2, str(root / "torch2"), ckpt)
    finally:
        for n, procs in train.items():
            _wait(procs, f"the {n}-rank spawn of the sharded step")
        _wait(jax_procs, "the JAX package's run")
    for n in train:
        for r, res in _results(n, str(root / f"train{n}")).items():
            torch_runs[n][r].update(res)
    jax_runs = {n: json.load(open(d / "jax.json")) for n, d in jax_dirs.items()}
    return torch_runs, jax_runs


def _ranks(runs, world: int, name: str) -> list:
    """Every rank's result of ``name``, each checked to have passed."""
    torch_runs, _ = runs
    out = []
    for r, res in torch_runs[world].items():
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


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives(runs, world):
    n = world
    x = np.arange(2 * n, dtype=np.float64).reshape(n, 2)
    jres = _jax(runs, world, "collectives")
    for res in _ranks(runs, world, "collectives"):
        for k, want in (("s", x.sum(0)), ("g", x), ("rs", n * x)):
            np.testing.assert_array_equal(res[k], np.ravel(want))
            np.testing.assert_array_equal(res[k], jres[k])


@pytest.mark.parametrize("world", [2, 4])
def test_calibrate_ici_from_the_ranks_collectives(runs, world):
    """calibrate_ici fitted from the gloo ranks' measured all-reduce and
    all-gather (cost.py's wire bytes over the measured seconds): each
    family gets a rate of its own, no faster than the spec's link rate,
    and trace_cost prices the family's wire bytes at it."""
    from thunder_tpu_torch.analysis.cost import DEVICE_SPECS, OpCost, calibrate_ici

    spec = DEVICE_SPECS["cpu"]
    for res in _ranks(runs, world, "calibration"):
        samples = [tuple(s) for s in res["samples"]]
        assert all(b > 0 and t > 0 for _, b, t in samples)
        cal = calibrate_ici(spec, samples)
        for cls, nbytes, secs in samples:
            assert 0 < cal.ici_bw_for(cls) <= spec.ici_bw
            assert cal.ici_bw_for(cls) == pytest.approx(min(nbytes / secs, spec.ici_bw))
            t, bound = OpCost(comm_bytes=nbytes).seconds(cal, cls=cls)
            assert bound == "comm" and t == pytest.approx(nbytes / cal.ici_bw_for(cls))


@pytest.mark.parametrize("world", [2, 4])
def test_broadcast_grad(runs, world):
    root = min(3, world - 1)
    jres = _jax(runs, world, "broadcast_grad")
    want = np.zeros(world)
    want[root] = world * 2.0 * (root + 1)
    for res in _ranks(runs, world, "broadcast_grad"):
        assert res["loss"] == [float((root + 1) ** 2)] == jres["loss"]
        np.testing.assert_array_equal(res["grad"], want)
        np.testing.assert_array_equal(res["grad"], jres["grad"])


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_api(runs, world):
    _ranks(runs, world, "fsdp_api")


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
@pytest.mark.parametrize("world", [2, 4])
def test_module_train(runs, world, mode):
    """4 SGD steps: losses against one device and the JAX package (rtol
    1e-4), the last step's grads against the JAX package's (2e-4) and
    bit-close to one device's."""
    name = f"module_{mode}_train"
    jres = _jax(runs, world, name)
    for res in _ranks(runs, world, name):
        _close(res["losses"], res["ref_losses"], 1e-4)
        _close(res["losses"], jres["losses"], 1e-4)
        assert res["losses"][-1] < res["losses"][0], res["losses"]
        assert res["grad_rel_vs_one_device"] < 2e-4
        for k, g in res["grads"].items():
            _close(g, jres["grads"][k], 2e-4, 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_zero3(runs, world):
    jres = _jax(runs, world, "fsdp_zero3")
    for res in _ranks(runs, world, "fsdp_zero3"):
        _close(res["loss3"], res["loss2"], 1e-5)
        _close(res["loss3"], jres["loss3"], 1e-4)
        _close(res["loss2"], jres["loss2"], 1e-4)
        assert res["saved3"] < res["saved2"]


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_memory(runs, world):
    for res in _ranks(runs, world, "fsdp_memory"):
        assert res["held_share"] < 1.0 / world + 0.1


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
@pytest.mark.parametrize("world", [2, 4])
def test_no_sync(runs, world, mode):
    """3 microbatches under no_sync against the JAX package's (the ranks
    checked them against one big-batch backward themselves)."""
    jres = _jax(runs, world, f"no_sync_{mode}")
    for res in _ranks(runs, world, f"no_sync_{mode}"):
        for k, g in res["grads"].items():
            _close(g, jres["grads"][k], 2e-4, 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_batch_reduced_output(runs, world):
    jres = _jax(runs, world, "batch_reduced_output")
    for res in _ranks(runs, world, "batch_reduced_output"):
        _close(res["reduced"], jres["reduced"], 1e-4, 1e-5)
        _close(res["masked"], jres["masked"], 1e-4, 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_masked_module_under_ddp_reads_its_verdicts_on_its_block(runs, world):
    """Not a JAX scenario: a padded batch under ddp, two masks of one
    shape, against eager torch on the valid rows (rtol 1e-4)."""
    for res in _ranks(runs, world, "masked_ddp"):
        assert res["compiles"] >= 1


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_init(runs, world):
    _ranks(runs, world, "multihost_init")


def test_grid_collectives_at_four_ranks(runs):
    """ppermute, all_to_all and hier_all_reduce (its hierarchical path and
    its flat fall-back) on a 2 x 2 grid, equal to the JAX package's."""
    jres = _jax(runs, 4, "grid")
    for res in _ranks(runs, 4, "grid"):
        for k in ("p", "t", "h", "flat"):
            np.testing.assert_array_equal(res[k], jres[k], err_msg=k)


@pytest.mark.parametrize("world", [4, 2])
def test_checkpoint_saved_by_four_ranks_loads_on_two(runs, world):
    _ranks(runs, world, "checkpoint")


# -- the sharded training step (ROADMAP 11a) ------------------------------------

TRAIN_CASES = [(2, "ddp_train"), (2, "fsdp_train"), (2, "tp_fsdp_train"),
               (4, "ddp_train"), (4, "fsdp_train"), (4, "tp_fsdp_train"), (4, "dp_tp_train")]


@pytest.mark.parametrize("world,name", TRAIN_CASES)
def test_sharded_train_step(runs, world, name):
    """``build_train_step(mesh=...)`` on this world's mesh shape
    (``_torch_port_dist_worker.TRAIN_CASES``: dp2, fsdp2, tp2, dp4, fsdp4,
    fsdp2·tp2, dp2·tp2), two AdamW steps: the losses against the JAX
    package's sharded step over as many virtual devices and against the
    port's one-device step, at the JAX scenarios' tolerances (rtol 1e-5 on
    the first loss, 1e-4 on the second); the same on every rank. The
    params gathered after two SGD steps (donated: the blocks update in
    place) within 1e-5 of the JAX package's sharded step's and of one
    device's, relative to each leaf's largest value; after AdamW within
    1e-3, whose normalization m/sqrt(v) turns a grad's last bits into the
    update's. The worker checked each rank's
    1/n share of every split leaf and of its moments, and that no tp rank
    gathers a whole MLP weight."""
    jres = _jax(runs, world, name)
    results = _ranks(runs, world, name)
    for res in results:
        for i, rtol in enumerate((1e-5, 1e-4)):
            _close(res["losses"][i], jres["losses"][i], rtol)
            _close(res["losses"][i], res["ref_losses"][i], rtol)
        assert res["sgd_param_rel"] < 1e-5, res["sgd_param_rel"]
        assert res["param_rel"] < 1e-3, res["param_rel"]
        for key, tol in (("sgd_params", 1e-5), ("params", 1e-3)):
            assert res[key].keys() == jres[key].keys(), key
            for leaf, want in jres[key].items():
                got, want = np.asarray(res[key][leaf]), np.asarray(want)
                assert got.shape == want.shape, (key, leaf)
                rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
                assert rel < tol, (key, leaf, rel)
        assert res["losses"] == results[0]["losses"]
    mesh_has_tp = name in ("tp_fsdp_train", "dp_tp_train")
    assert ("axis_slice" in results[0]["collectives"]) == mesh_has_tp


@pytest.mark.parametrize("world", [2, 4])
def test_scheduled_sharded_step_is_bit_equal(runs, world):
    """The comm scheduler moved gathers of the sharded step, and the
    scheduled step's losses and params equal the unscheduled step's bit for
    bit (the worker compared them with ``torch.equal``)."""
    for res in _ranks(runs, world, "scheduled_step"):
        assert res["moves"] >= 1


def test_scheduled_trace_matches_unscheduled_numerics(runs):
    """``tests/test_comm_schedule.py``'s two multi-device cases on 4 gloo
    ranks (fsdp2 x tp2): the scheduled MLP program computes what the
    unscheduled one does (rtol 1e-6), and ``compile_with_collectives(
    comm_schedule=True)`` schedules and runs."""
    for res in _ranks(runs, 4, "comm_schedule"):
        assert res["moves"] >= 1 and res["wired_moves"] >= 1


@pytest.mark.parametrize("world", [2, 4])
def test_reshard_roundtrip_different_mesh(runs, world):
    """``reshard_pytree`` between mesh shapes (fsdp4 and dp2·tp2; fsdp2
    and tp2) and back keeps every bit (``TestCheckpoint.
    test_reshard_roundtrip_different_mesh``'s question, through
    ``distributed/checkpoint``'s gather)."""
    _ranks(runs, world, "reshard")
