"""The fleet layer on 4 gloo ranks, against the JAX package.

The ranks run the "@fleet" scenarios of ``tests/_torch_port_dist_worker.py``
(one spawn of 4 ranks, meeting on a FileStore under the test's temporary
directory); the JAX side runs the same scenarios in one process on 4
virtual CPU devices, beside it. Every spawn writes its output to a file and
has ``SPAWN_TIMEOUT_S``.

- ``tests/test_autopilot.py``'s TestAutopilotDriver, its 7 scenarios on
  fsdp2·tp2 in both packages (the JAX test's fsdp4·tp2 needs 8 ranks): a
  shrink is the grid over the first ranks (fsdp1·tp2 over ranks 0-1), the
  ranks outside it sit out, and come back for a regrow. The state and step
  are "@resilience"'s (one SGD step of mean((w @ b)^2), "w" split over both
  axes). The event logs of all ranks replay merged: a rank that sat out a
  shrink decided it, the survivors actuated it.
- ``tests/test_federation.py``'s TestFederatedMesh (5 cases) and
  ``test_hier_numerics_match_flat`` on 2 slices of 2 ranks.
- TestFederatedDriver's slice-loss and flap scenarios over those 4 ranks:
  the mesh of width w is ``make_mesh(dp=2*w)`` over the first 2·w ranks, on
  a clock the steps advance.

Tolerances: the losses of a run that shrank agree with the JAX package's to
rtol 1e-5 (the reduction order changes with the mesh, as in the JAX test);
decisions, final mesh shapes, reports, ledger edges, restore tiers and the
replay's findings are equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_port_dist_worker import FLEET_SCENARIOS  # noqa: E402
from test_torch_port_distributed_ranks import WORKER, _env, _results, _start_ranks, _wait  # noqa: E402

WORLD = 4
SURVIVORS = (0, 1)  # the shrunk grid fsdp1·tp2 holds the first two ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    jdir = root / "jax4"
    jdir.mkdir()
    with open(jdir / "jax.log", "w") as f:
        jax_proc = subprocess.Popen([sys.executable, WORKER, "jax", str(WORLD), str(jdir), "@fleet"],
                                    env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}"),
                                    stdout=f, stderr=subprocess.STDOUT, text=True)
    jax_proc.log = str(jdir / "jax.log")
    ranks = _start_ranks(WORLD, str(root / "r4"), str(root / "ckpt"), "@fleet")
    _wait(ranks + [jax_proc], "the 4-rank fleet spawn and the JAX side")
    return {"torch": _results(WORLD, str(root / "r4")), "jax": json.load(open(jdir / "jax.json"))}


def _ok(res: dict, name: str) -> dict:
    assert res[name]["ok"], res[name].get("error")
    return res[name]


def _pair(runs, name: str):
    return [_ok(runs["torch"][r], name) for r in range(WORLD)], _ok(runs["jax"], name)


@pytest.mark.parametrize("name", FLEET_SCENARIOS[WORLD])
def test_scenario_ran_on_every_rank_and_in_jax(runs, name):
    for r in range(WORLD):
        _ok(runs["torch"][r], name)
    _ok(runs["jax"], name)


# =============================================================================
# TestAutopilotDriver on fsdp2·tp2
# =============================================================================


def _close(got: list, want: list, rtol: float) -> None:
    """Losses by step: None (a step not run here) at the same steps, the
    rest within ``rtol``."""
    assert [x is None for x in got] == [x is None for x in want]
    np.testing.assert_allclose([x for x in got if x is not None], [x for x in want if x is not None], rtol=rtol)


def _same_driver_verdict(ranks, jres, *, shrunk: bool):
    """Decisions, the final mesh and the replay equal on every rank and the
    JAX side; the survivors' losses within rtol 1e-5 of the JAX package's,
    and a rank that sat out holds none for the steps it sat out."""
    for r, res in enumerate(ranks):
        assert res["halted"] is False
        assert res["intervals_ok"]
        assert res["final_shape"] == jres["final_shape"]
        assert res["replay"]["unrecovered"] == res["replay"]["unactuated"] == res["replay"]["errors"] == []
        if r in SURVIVORS or not shrunk:
            assert res["decisions"] == jres["decisions"]
            _close(res["losses"], jres["losses"], 1e-5)
        else:
            assert res["decisions"] == jres["decisions"][:len(res["decisions"])]
            assert any(x is None for x in res["losses"])
    assert jres["replay"]["unrecovered"] == jres["replay"]["unactuated"] == []


def test_host_loss_shrinks_and_continues(runs):
    ranks, jres = _pair(runs, "fl_host_loss")
    assert [d[1:3] for d in jres["decisions"]] == [["elastic_resume", "shrink"]]
    assert jres["final_shape"]["fsdp"] == 1 and jres["final_shape"]["tp"] == 2
    _same_driver_verdict(ranks, jres, shrunk=True)
    for r in SURVIVORS:
        # The losses continue the uninterrupted trajectory.
        np.testing.assert_allclose(ranks[r]["losses"], ranks[r]["baseline"], rtol=1e-5)
        assert ranks[r]["recoveries"] == 1
    for r in range(len(SURVIVORS), WORLD):
        assert ranks[r]["losses"][2:] == [None] * 4 and ranks[r]["recoveries"] == 0


def test_collective_hang_resumes_same_mesh(runs):
    ranks, jres = _pair(runs, "fl_hang_same_mesh")
    hang = [d for d in jres["decisions"] if d[0] == "collective_hang"]
    assert len(hang) == 1 and hang[0][2] == "same_mesh"
    assert jres["final_shape"]["fsdp"] == 2  # never shrank
    _same_driver_verdict(ranks, jres, shrunk=False)


def test_persistent_sdc_shrinks_away(runs):
    ranks, jres = _pair(runs, "fl_persistent_sdc")
    assert jres["by_actuator"]["quarantine_rerun"] >= 1
    assert jres["by_actuator"]["elastic_resume"] == 1
    shrink = [d for d in jres["decisions"] if d[0] == "sdc_persistent"]
    assert len(shrink) == 1 and shrink[0][2] == "shrink"
    _same_driver_verdict(ranks, jres, shrunk=True)


def test_preempt_halts_then_restart_completes(runs):
    ranks, jres = _pair(runs, "fl_preempt_restart")
    assert jres["halt"] == {"step": 2, "decisions": [["preempt", "checkpoint_halt", None, 0]]}
    for res in ranks:
        assert res["halt"] == jres["halt"]
        assert res["losses"][:2] == [None, None]  # not re-run
        assert all(x is not None for x in res["losses"][2:])
    _same_driver_verdict(ranks, jres, shrunk=False)


def test_overlap_host_loss_after_sdc_rerun_serializes(runs):
    ranks, jres = _pair(runs, "fl_overlap_sdc_host_loss")
    assert {d[1] for d in jres["decisions"]} == {"quarantine_rerun", "elastic_resume"}
    _same_driver_verdict(ranks, jres, shrunk=True)


def test_overlap_hang_during_elastic_resume(runs):
    ranks, jres = _pair(runs, "fl_overlap_hang_in_resume")
    kinds = [d[0] for d in jres["decisions"]]
    assert kinds[0] == "host_loss" and "collective_hang" in kinds
    _same_driver_verdict(ranks, jres, shrunk=True)


def test_regrow_after_healthy_window(runs):
    """The ranks that sat out the shrink come back for the regrow: every
    rank ends on the full mesh with the same decisions."""
    ranks, jres = _pair(runs, "fl_regrow")
    modes = [(d[0], d[2]) for d in jres["decisions"]]
    assert ("host_loss", "shrink") in modes and ("host_recovered", "regrow") in modes
    assert jres["final_shape"]["fsdp"] == 2  # back on the full mesh
    for res in ranks:
        assert res["decisions"] == jres["decisions"]
    _same_driver_verdict(ranks, jres, shrunk=True)
    for r in range(len(SURVIVORS), WORLD):
        np.testing.assert_allclose(ranks[r]["losses"][3:], jres["losses"][3:], rtol=1e-5)


# =============================================================================
# TestFederatedMesh and the hierarchical all-reduce on 2 slices x 2 ranks
# =============================================================================


def _mesh_facts(runs):
    ranks, jres = _pair(runs, "fl_federated_mesh")
    return ranks, jres


def test_shape_and_axes(runs):
    ranks, jres = _mesh_facts(runs)
    for res in ranks:
        assert res["shape"] == jres["shape"] == {"axis0": "dcn", "slices": 2, "n_slices": 2, "per_slice": 2,
                                                 "federated": True}
        assert res["dcn"] and res["dcn_group"]


def test_slice_blocks_are_contiguous(runs):
    ranks, jres = _mesh_facts(runs)
    for res in ranks:
        assert res["blocks"] == jres["blocks"] == {"s0": [0, 1], "s1": [2, 3], "of1": 0, "of2": 1}


def test_plain_mesh_not_federated(runs):
    ranks, jres = _mesh_facts(runs)
    for res in ranks:
        assert res["plain"] == jres["plain"] == [False, 1]


def test_slice_axis_size(runs):
    ranks, jres = _mesh_facts(runs)
    for res in ranks:
        assert res["slice_axis_size"] == jres["slice_axis_size"] == 2


def test_too_many_devices_raises(runs):
    ranks, jres = _mesh_facts(runs)
    assert "8 devices" in jres["too_many"]
    for res in ranks:
        assert res["too_many"] is not None and "8 devices" in res["too_many"]


def test_hier_numerics_match_flat(runs):
    """Reduce-scatter over dp, all-reduce over dcn, all-gather over dp: the
    flat sum over both axes (4·x), in both packages, on every rank."""
    ranks, jres = _pair(runs, "fl_hier_numerics")
    assert jres["equal"] and jres["sum_ok"]
    for res in ranks:
        assert res["equal"] and res["sum_ok"]
        np.testing.assert_allclose(res["got"], jres["got"], rtol=1e-6)


# =============================================================================
# TestFederatedDriver over the 4 ranks
# =============================================================================


@pytest.mark.parametrize("name", ["fl_slice_loss", "fl_slice_flap"])
def test_federated_driver_on_ranks(runs, name):
    """One shrink and one regrow, from the buddy's peer-RAM tier, with the
    same report, decisions, ledger edges, tiers and widths on every rank as
    in the JAX package, losses within 1e-6 and a clean replay."""
    ranks, jres = _pair(runs, name)
    assert jres["report"][:2] == [1, 1] and jres["report"][5] == 2
    assert [d[1] for d in jres["decisions"]] == ["shrink_dp", "regrow_dp"]
    assert jres["tiers"].count("peer") == 1 and "disk" not in jres["tiers"][1:]
    if name == "fl_slice_flap":
        assert ["cooldown", "lost"] in [e[1:3] for e in jres["edges"]]
    for res in ranks:
        for key in ("report", "decisions", "edges", "tiers", "widths"):
            assert res[key] == jres[key], key
        np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-6)
        assert res["replay"] == {"unrecovered": [], "unactuated": []}
