"""The port's distribution on 2 and 4 gloo ranks against the JAX package.

Each world size is one spawn: its ranks run every scenario of that size
(``tests/_torch_port_dist_worker.py``) in one go, meeting on a FileStore
under the test's temporary directory (no port, so parallel test workers
never collide), each scenario under a time limit of its own. The JAX side
runs the same scenarios once a size, in one process over as many virtual
CPU devices, as ``tests/test_distributed.py`` runs its own. The 4-rank
spawn runs first and saves the checkpoint that the 2-rank spawn loads.

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
            out = p.stdout.read() if p.stdout else ""
            pytest.fail(f"{what} exited {p.returncode}:\n{out[-4000:]}")


def _spawn_ranks(world: int, out: str, ckpt: str) -> dict:
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    procs = [subprocess.Popen([sys.executable, WORKER, "torch", str(r), str(world), store, out, ckpt],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    _wait(procs, f"the {world}-rank spawn")
    return {r: json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(world)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    jax_dirs = {n: root / f"jax{n}" for n in (2, 4)}
    jax_procs = []
    for n, d in jax_dirs.items():
        d.mkdir()
        jax_procs.append(subprocess.Popen(
            [sys.executable, WORKER, "jax", str(n), str(d)],
            env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        ckpt = str(root / "ckpt")
        torch_runs = {4: _spawn_ranks(4, str(root / "torch4"), ckpt)}
        torch_runs[2] = _spawn_ranks(2, str(root / "torch2"), ckpt)
    finally:
        _wait(jax_procs, "the JAX package's run")
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
