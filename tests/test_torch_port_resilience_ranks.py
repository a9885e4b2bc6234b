"""The recovery layer on 2 and 4 gloo ranks, against the JAX package.

The ranks run the "@resilience" scenarios of ``tests/_torch_port_dist_worker.py``
(one spawn a world size, meeting on a FileStore under the test's temporary
directory); the JAX side runs ``tests/test_mesh_resilience.py``'s step on
the same state over 4 virtual CPU devices, in a process of its own beside
the 4-rank spawn. The 2-rank spawn runs after the 4-rank one: it resumes
the checkpoint the 4 ranks wrote when their host was lost. Every spawn
writes its output to a file and has ``SPAWN_TIMEOUT_S``.

The JAX package's scenarios run on fsdp4·tp2 over 8 devices; here on
fsdp2·tp2 over 4 ranks (and 4 devices), the elastic resume onto fsdp2 over 2
(the JAX side's first 2 devices). The state is ``{"b": ones(4), "w":
arange(32).reshape(8, 4) * 0.01}``, "b" replicated and "w" split over both
axes; the step is one SGD step of mean((w @ b)^2). The reshard round trip
fsdp2·tp2 -> fsdp2 -> 4x1 -> fsdp2·tp2 runs at 4 ranks with fsdp2 as
dp2·fsdp2 (fsdp2's layout on each half of the ranks).

Tolerances: the port's and the JAX package's losses agree to rtol 1e-6 (the
JAX scenario's own tolerance for a continued run on another mesh); a resume
and an SDC re-run reproduce the port's own losses bit for bit; reshards are
bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_port_dist_worker import RES_LOSS_AT, RESILIENCE_SCENARIOS  # noqa: E402
from test_torch_port_distributed_ranks import WORKER, _env, _results, _start_ranks, _wait  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resilience")
    ckpt = str(root / "ckpt")
    jdir = root / "jax4"
    jdir.mkdir()
    with open(jdir / "jax.log", "w") as f:
        jax_proc = subprocess.Popen([sys.executable, WORKER, "jax", "4", str(jdir), "@resilience"],
                                    env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
                                    stdout=f, stderr=subprocess.STDOUT, text=True)
    jax_proc.log = str(jdir / "jax.log")
    four = _start_ranks(4, str(root / "r4"), ckpt, "@resilience")
    _wait(four, "the 4-rank spawn")
    # The survivors resume what the 4 ranks checkpointed at their host loss.
    two = _start_ranks(2, str(root / "r2"), ckpt, "@resilience")
    _wait(two + [jax_proc], "the 2-rank spawn and the JAX side")
    return {4: _results(4, str(root / "r4")), 2: _results(2, str(root / "r2")),
            "jax": json.load(open(jdir / "jax.json"))}


def _ok(res: dict, name: str) -> dict:
    assert res[name]["ok"], res[name].get("error")
    return res[name]


@pytest.mark.parametrize("world,name", [(w, n) for w in (4, 2) for n in RESILIENCE_SCENARIOS[w]])
def test_scenario_ran_on_every_rank(runs, world, name):
    for r in range(world):
        _ok(runs[world][r], name)


@pytest.mark.parametrize("world", [4, 2])
def test_synced_preemption(runs, world):
    """Only rank 1 saw the flag; every rank stopped at step 2 and the step
    committed; only rank 0 wrote META.json."""
    for r in range(world):
        res = _ok(runs[world][r], "res_synced_preemption")
        assert res["stopped"] == 2 and res["committed"] == 2
        assert res["primary"] == (r == 0)
        assert res["meta_writes"] == (["META.json"] if r == 0 else [])


def test_sdc_guard_names_the_leaf_and_the_rank(runs):
    """The corrupted replica of the replicated leaf is named by leaf and by
    rank (the JAX package names leaf0 and device 1 for the same state), the
    step re-runs clean, and the losses are the uninterrupted run's, bit for
    bit, and the JAX package's to rtol 1e-6."""
    jres = _ok(runs["jax"], "res_sdc_guard")
    for r in range(4):
        res = _ok(runs[4][r], "res_sdc_guard")
        assert res["losses"] == res["baseline"]
        assert res["suspect_leaves"] == jres["suspect_leaves"] == [["leaf0"]]
        assert res["suspect_devices"] == jres["suspect_devices"] == [[1]]
        assert res["reruns_ok"] == jres["reruns_ok"] == [True]
        np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-6)


def test_persistent_corruption_raises_sdc_detected(runs):
    jres = _ok(runs["jax"], "res_sdc_guard")
    for r in range(4):
        assert _ok(runs[4][r], "res_sdc_guard")["persistent"] == jres["persistent"] == ["leaf0"]


def test_host_loss_then_elastic_resume_on_two_ranks(runs):
    """fsdp2·tp2 loses a host at step 3: the 4 ranks checkpoint it with the
    mesh shape; 2 ranks resume it onto fsdp2 from the disk tier (resharded)
    and continue, within rtol 1e-6 of the uninterrupted run and of the JAX
    package's continued run."""
    jres = _ok(runs["jax"], "res_host_loss")
    base = _ok(runs[4][0], "res_host_loss")
    for r in range(4):
        res = _ok(runs[4][r], "res_host_loss")
        assert res["lost"] == RES_LOSS_AT == jres["lost"]
        assert (res["mesh"]["fsdp"], res["mesh"]["tp"]) == (2, 2)
        assert res["baseline"] == base["baseline"]
    for r in range(2):
        res = _ok(runs[2][r], "res_elastic_resume")
        assert res["start"] == RES_LOSS_AT == jres["start"]
        ev = res["event"]
        assert ev["tier"] == "disk" and ev["resharded"] is True
        assert (ev["from_mesh"]["tp"], ev["to_mesh"]["tp"], ev["to_mesh"]["fsdp"]) == (2, 1, 2)
        np.testing.assert_allclose(res["continued"], base["baseline"][RES_LOSS_AT:], rtol=1e-6)
        np.testing.assert_allclose(res["continued"], jres["continued"], rtol=1e-6)


def test_reshard_round_trips_are_bitwise(runs):
    for r in range(4):
        res = _ok(runs[4][r], "res_reshard")
        assert res["hops"] == 3 and res["leaves"] > 0


@pytest.mark.parametrize("world", [4, 2])
def test_watchdog_times_out_a_hung_collective(runs, world):
    """The guarded shard_map_callable raised CollectiveTimeoutError within
    its 1 s timeout (the hang slept 3 s), naming its all_reduce line; the
    next call gave the right sum."""
    for r in range(world):
        res = _ok(runs[world][r], "res_watchdog")
        assert res["raised"] is not None and res["raised"]["timeout_s"] == 1.0
        assert any("all_reduce" in ln for ln in res["raised"]["lines"])
        assert res["elapsed"] < 2.5
        assert res["sum_ok"]
