"""Mesh, sharding plans, the comm scheduler, the distributed benchmark runner
and the introspection API (C.2), through the port and the JAX package.

- ``gpt_param_specs`` equals the JAX package's leaf for leaf on gpt-tiny,
  llama-tiny and open_llama_3b over the mesh shapes dp2·tp2, fsdp4,
  dp2·fsdp2·tp2 and fsdp2·tp2; ``P`` names axes on any dim.
- A mesh of one rank needs no process group, and its sharded step is the
  one-device step bit for bit; a mesh larger than the ranks raises.
- ``tests/test_comm_schedule.py``'s cases through the port: 22 here, the two
  that run the scheduled program on several devices in
  ``tests/test_torch_port_distributed_ranks.py`` (gloo ranks), and neither
  of the two that need the chaos seam and the de-opt ladder (the resilience
  slice). One more: an internal failure falls back with a ``sharp_edge``.
- ``benchmarks/distributed.py``: ``parse_config``, each error dict, and the
  LitGPT CLI's ``--fsdp 2 --tp 2`` line on 4 gloo ranks against the
  unsharded CLI's.
- C.2: ``TestCompileStats`` (``tests/test_tooling.py:182-221``) and
  ``test_cache_info_rejects_uncompiled``
  (``tests/test_symbolic_cache.py:383-385``) through both packages.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import thunder_tpu_torch.clang as clang
import thunder_tpu_torch.core.prims as prims
from thunder_tpu_torch.analysis import Severity, verify
from thunder_tpu_torch.analysis import schedule as sched_mod
from thunder_tpu_torch.analysis.cost import DEVICE_SPECS, calibrate_ici, resolve_device_spec, trace_cost
from thunder_tpu_torch.analysis.liveness import plan_liveness
from thunder_tpu_torch.api import trace_program
from thunder_tpu_torch.core import devices, dtypes
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.trace import TraceCtx, tracectx
from thunder_tpu_torch.distributed import prims as dist_prims
from thunder_tpu_torch.distributed.runtime import P
from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
from thunder_tpu_torch.extend import resolve_executors
from thunder_tpu_torch.transforms.common import dce
from thunder_tpu_torch.transforms.comm_schedule import PlacementError, apply_placement, enabled, schedule_collectives

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_port_dist_worker import mlp_extrace as _mlp_extrace  # noqa: E402

CONFIGS = ["gpt-tiny", "llama-tiny", "open_llama_3b"]
MESHES = [{"dp": 2, "tp": 2}, {"fsdp": 4}, {"dp": 2, "fsdp": 2, "tp": 2}, {"fsdp": 2, "tp": 2}]


def _plain(x):
    """A spec tree as plain containers; a dim's one-axis tuple as the axis
    (``PartitionSpec`` normalizes ``("dp",)`` to ``"dp"``)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in x)


# =============================================================================
# Mesh and specs
# =============================================================================


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("name", CONFIGS)
def test_gpt_param_specs_match_jax(name, axes):
    from thunder_tpu.models import gpt as jm
    from thunder_tpu.parallel import make_mesh as jax_mesh
    from thunder_tpu.parallel.sharding import data_spec as jax_data_spec
    from thunder_tpu.parallel.sharding import gpt_param_specs as jax_specs

    from thunder_tpu_torch.models import gpt as m
    from thunder_tpu_torch.parallel import MeshConfig, data_spec, gpt_param_specs

    jmesh = jax_mesh(**axes)
    for kw in ({}, {"tp": False}, {"fsdp": False}):
        want = _plain(jax_specs(jm.name_to_config(name), jmesh, **kw))
        got = _plain(gpt_param_specs(m.name_to_config(name), MeshConfig(**axes), **kw))
        assert got == want, kw
    assert _plain(data_spec(MeshConfig(**axes))) == _plain(jax_data_spec(jmesh))


def test_partition_spec_names_axes_on_any_dim():
    s = P(None, "tp")
    assert s.dim_axes(0) == () and s.dim_axes(1) == ("tp",) and s.dim_axes(5) == ()
    assert s.sharded == ((1, ("tp",)),) and s.axes == ("tp",) and s.axis is None
    s = P(("dp", "fsdp"), "tp")
    assert s.sharded == ((0, ("dp", "fsdp")), (1, ("tp",))) and s.axes == ("dp", "fsdp", "tp")
    assert s.axis == ("dp", "fsdp")
    assert P().axes == () and P("fsdp").axes == ("fsdp",) and P("fsdp").axis == "fsdp"


def test_one_rank_mesh_needs_no_group_and_a_larger_one_raises():
    from thunder_tpu_torch.parallel import MeshConfig, axis_sizes, gpt_param_specs, make_mesh, shard_pytree
    from thunder_tpu_torch.models import gpt as m

    mesh = make_mesh(dp=1, fsdp=1, tp=1)
    assert axis_sizes(mesh) == {"dp": 1, "pp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
    assert MeshConfig.from_mesh(mesh) == MeshConfig() and mesh.size == 1
    with pytest.raises(ValueError, match="Mesh needs 2 devices, only 1 available"):
        make_mesh(fsdp=2)
    cfg = m.name_to_config("gpt-tiny")
    params = m.init_params(cfg, dtype=torch.float32, device="cpu")
    specs = gpt_param_specs(cfg, mesh)
    assert all(s.axes == () for s in torch.utils._pytree.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P)))
    blocks = shard_pytree(params, mesh, specs)
    assert all(a is b for a, b in zip(torch.utils._pytree.tree_leaves(blocks), torch.utils._pytree.tree_leaves(params)))


def test_one_rank_sharded_step_is_the_one_device_step():
    """The mesh's step at one rank places no collective: its program, its
    losses and its params (3 AdamW steps, then 3 SGD steps with donation)
    equal the one-device step's bit for bit."""
    from thunder_tpu_torch.models import gpt as m
    from thunder_tpu_torch.parallel import build_train_step, gpt_param_specs, make_mesh, opt_state_specs, shard_pytree

    cfg = m.name_to_config("llama-tiny")
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16)))
    tgt = torch.roll(idx, -1, 1)
    mesh = make_mesh()
    specs = gpt_param_specs(cfg, mesh)
    assert opt_state_specs(specs) == {"step": P(), "m": specs, "v": specs}
    assert opt_state_specs(specs, "sgd") == {"step": P()}
    for optimizer, donate in (("adamw", False), ("sgd", True)):
        pa = m.init_params(cfg, dtype=torch.float32, seed=3, device="cpu")
        pb = shard_pytree(m.init_params(cfg, dtype=torch.float32, seed=3, device="cpu"), mesh, specs)
        s0, o0, ex0 = build_train_step(cfg, pa, idx, tgt, lr=1e-2, optimizer=optimizer, donate=donate,
                                       return_extrace=True)
        s1, o1, ex1 = build_train_step(cfg, pb, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2,
                                       optimizer=optimizer, donate=donate, return_extrace=True)
        assert not [b for b in ex1.bound_symbols if dist_prims.is_collective_bsym(b)]
        assert [b.sym.name for b in ex0.bound_symbols] == [b.sym.name for b in ex1.bound_symbols]
        for _ in range(3):
            pa, o0, l0 = s0(pa, o0, idx, tgt)
            pb, o1, l1 = s1(pb, o1, idx, tgt)
            assert torch.equal(l0, l1)
        for a, b in zip(torch.utils._pytree.tree_leaves(pa), torch.utils._pytree.tree_leaves(pb)):
            assert torch.equal(a, b)


def test_sharded_step_refuses_what_comes_later():
    """What came with item 11b now runs: a mesh of 2 pipeline and 2 expert
    ranks names no collective (no spec names pp or ep), so its step is the
    one-device program, bit for bit, with no process group. What it still
    refuses: a sequence that does not split over sp (naming both sizes), a
    batch split over tp; param_specs without a mesh; a param that is not
    this rank's block, naming shard_pytree."""
    from thunder_tpu_torch.models import gpt as m
    from thunder_tpu_torch.parallel import AXIS_ORDER, Mesh, build_train_step, gpt_param_specs

    cfg = m.name_to_config("gpt-tiny")
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 8)))
    tgt = torch.roll(idx, -1, 1)
    pp_ep = Mesh(AXIS_ORDER, np.zeros((1, 2, 1, 2, 1, 1), dtype=np.int64), {})
    runs = []
    for mesh in (None, pp_ep):
        params = m.init_params(cfg, dtype=torch.float32, seed=1, device="cpu")
        step, opt, ex = build_train_step(cfg, params, idx, tgt, mesh=mesh, lr=1e-2, optimizer="sgd",
                                         return_extrace=True)
        losses = []
        for _ in range(2):
            params, opt, loss = step(params, opt, idx, tgt)
            losses.append(loss)
        runs.append((losses, params, [b.sym.name for b in ex.bound_symbols]))
    (l0, p0, names0), (l1, p1, names1) = runs
    assert names0 == names1 and all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(p0), torch.utils._pytree.tree_leaves(p1)))
    params = m.init_params(cfg, dtype=torch.float32, device="cpu")
    sp3 = Mesh(AXIS_ORDER, np.zeros((1, 1, 1, 1, 3, 1), dtype=np.int64), {})
    with pytest.raises(ValueError, match="8 positions does not split over the 3 ranks of 'sp'"):
        build_train_step(cfg, params, idx, tgt, mesh=sp3)
    tp2 = Mesh(AXIS_ORDER, np.zeros((1, 1, 1, 1, 1, 2), dtype=np.int64), {})
    with pytest.raises(ValueError, match="over tp"):
        build_train_step(cfg, params, idx, tgt, mesh=tp2, batch_spec=P("tp"))
    with pytest.raises(ValueError, match="need a mesh"):
        build_train_step(cfg, params, idx, idx, param_specs=gpt_param_specs(cfg, None))
    fsdp = Mesh(AXIS_ORDER, np.zeros((1, 1, 2, 1, 1, 1), dtype=np.int64), {})
    with pytest.raises(ValueError, match="shard_pytree"):
        build_train_step(cfg, params, idx, idx, mesh=fsdp, param_specs=gpt_param_specs(cfg, fsdp))


# =============================================================================
# The comm scheduler (tests/test_comm_schedule.py through the port)
# =============================================================================


def _cpu():
    return devices.Device("cpu")


def _t(shape=(64, 64), name=None):
    return TensorProxy(name=name, shape=shape, dtype=dtypes.float32, device=_cpu())


class TestPredictOverlap:
    def _gather_then_compute(self):
        """gather (wire) -> independent matmul -> consumer of the gather."""
        trc = TraceCtx()
        with tracectx(trc):
            a = _t((16, 64))
            b = _t((64, 64))
            trc.args = (a, b)
            g = dist_prims.all_gather(a, "dp", 4, dim=0)
            c = clang.matmul(b, b)          # independent of g: in g's window
            out = clang.matmul(c, clang.transpose(g, 0, 1))
            prims.python_return(out)
            trc.output = out
        return trc

    def test_window_is_independent_compute(self):
        pred = sched_mod.predict_overlap(self._gather_then_compute(), device="h100")
        site = pred.sites[0]
        assert site.sym == "all_gather"
        assert site.first_consumer == 2  # the consuming matmul
        assert site.window_us > 0
        assert site.hidden_us == pytest.approx(min(site.wire_us, site.window_us))

    def test_hidden_capped_by_wire(self):
        pred = sched_mod.predict_overlap(self._gather_then_compute(), device="h100")
        for s in pred.sites:
            assert s.hidden_us <= s.wire_us + 1e-9
            assert s.exposed_us == pytest.approx(s.wire_us - s.hidden_us)

    def test_budget_not_double_counted(self):
        """Two collectives sharing one window line cannot both claim it."""
        trc = TraceCtx()
        with tracectx(trc):
            a = _t((16, 64))
            b = _t((64, 64))
            trc.args = (a, b)
            g1 = dist_prims.all_gather(a, "dp", 4, dim=0)
            g2 = dist_prims.all_gather(a, "tp", 4, dim=0)
            c = clang.matmul(b, b)  # the one shared window line
            o1 = clang.matmul(c, clang.transpose(g1, 0, 1))
            o2 = clang.matmul(o1, clang.transpose(g2, 0, 1))
            out = clang.add(o2, o2)
            prims.python_return(out)
            trc.output = out
        pred = sched_mod.predict_overlap(trc, device="h100")
        s1, s2 = pred.sites[0], pred.sites[1]
        # The two windows overlap on the shared compute line: whatever the
        # split, total hidden cannot exceed the compute in the UNION of the
        # two windows (lines between site 0/1 and their first consumers).
        union = range(2, max(s1.first_consumer, s2.first_consumer))
        union_budget = sum(
            r.roofline_s * 1e6
            for r in trace_cost(trc, "h100").rows
            if r.index in union and r.kind != "collective"
        )
        assert s1.hidden_us + s2.hidden_us <= union_budget + 1e-6
        # The first site drains the shared line entirely (its window is only
        # that line and smaller than its wire), so the second site's hidden
        # comes from the rest of its window alone.
        shared_us = next(
            r.roofline_s * 1e6 for r in trace_cost(trc, "h100").rows
            if r.index == 2
        )
        assert s1.hidden_us == pytest.approx(shared_us)
        assert s2.hidden_us <= s2.window_us - shared_us + 1e-6

    def test_exposed_pct_totals(self):
        pred = sched_mod.predict_overlap(_mlp_extrace(), device="cpu")
        assert 0.0 <= pred.exposed_pct <= 100.0
        assert pred.exposed_us == pytest.approx(pred.wire_us - pred.hidden_us)


class TestScheduler:
    def test_hoists_prefetchable_synchronize(self):
        extrace = _mlp_extrace()
        pred0 = sched_mod.predict_overlap(extrace, device="cpu")
        scheduled, rep = schedule_collectives(extrace, device="cpu")
        assert rep is not None and rep.moves >= 1
        pred1 = sched_mod.predict_overlap(scheduled, device="cpu")
        assert pred1.hidden_us > pred0.hidden_us
        assert pred1.exposed_pct < pred0.exposed_pct
        moved = [s for s in rep.sites if s.moved]
        assert any(s.sym == "synchronize" for s in moved)
        for s in moved:
            assert s.index_after < s.index_before  # this pass only hoists

    def test_first_gather_is_pinned(self):
        extrace = _mlp_extrace()
        scheduled, rep = schedule_collectives(extrace, device="cpu")
        first = min(rep.sites, key=lambda s: s.index_before)
        assert first.sym == "synchronize"
        assert not first.moved

    def test_recertifies_with_identical_axis_order(self):
        extrace = _mlp_extrace()
        cert0 = sched_mod.stamp(extrace)
        scheduled, rep = schedule_collectives(extrace, device="cpu")
        assert rep.moves >= 1
        cert1 = sched_mod.certify(scheduled)
        assert cert1.axis_order == cert0.axis_order
        # recertify stamped the trace: the verifier accepts the new order.
        assert scheduled.tags.get("collective_order") == cert1.axis_order
        assert [d for d in verify(scheduled)
                if d.severity >= Severity.ERROR] == []

    def test_uncertified_hand_reorder_still_flagged(self):
        """Scheduling does not weaken the reorder rule: a later pass that
        hand-swaps two same-axis collectives on the SCHEDULED trace is
        still an ERROR."""
        from thunder_tpu_torch.core.trace import from_trace

        scheduled, rep = schedule_collectives(_mlp_extrace(), device="cpu")
        cert = sched_mod.certify(scheduled)
        fsdp_sites = [s.index for s in cert.sites if s.axis == "fsdp"]
        bad = from_trace(scheduled)
        bs = list(scheduled.bound_symbols)
        i, j = fsdp_sites[0], fsdp_sites[1]
        bs[i], bs[j] = bs[j], bs[i]
        bad.bound_symbols = bs
        diags = verify(bad, pass_name="evil post-schedule pass")
        assert any(d.rule == "sched.uncertified-reorder"
                   and d.severity == Severity.ERROR for d in diags)

    def test_seeded_bad_placement_rejected(self):
        extrace = _mlp_extrace()
        cert = sched_mod.certify(extrace)
        movable = next(s for s in cert.sites if s.sym == "synchronize"
                       and s.hoistable)
        with pytest.raises(PlacementError):
            apply_placement(extrace, movable.key, movable.latest + 3)
        with pytest.raises(PlacementError):
            apply_placement(extrace, movable.key, movable.earliest - 1)
        with pytest.raises(PlacementError):
            apply_placement(extrace, "no_such_site[xx]->t0", 0)

    def test_legal_placement_applies_and_recertifies(self):
        extrace = _mlp_extrace()
        cert = sched_mod.certify(extrace)
        movable = next(s for s in cert.sites if s.sym == "synchronize"
                       and s.hoistable)
        moved = apply_placement(extrace, movable.key, movable.earliest)
        cert2 = sched_mod.certify(moved)
        assert cert2.axis_order == cert.axis_order
        assert [d for d in verify(moved)
                if d.severity >= Severity.ERROR] == []

    def test_liveness_backoff_under_capacity(self):
        fwd = _mlp_extrace(grad=False)
        free, _ = schedule_collectives(fwd, device="cpu")
        p0 = plan_liveness(fwd, include_rows=False).peak_bytes
        p1 = plan_liveness(free, include_rows=False).peak_bytes
        assert p1 > p0  # hoisted gathers materialize full weights early
        cap = (p0 + p1) // 2
        capped, rep = schedule_collectives(
            _mlp_extrace(grad=False), device="cpu", capacity_bytes=cap
        )
        assert rep.backoffs >= 1
        assert plan_liveness(capped, include_rows=False).peak_bytes <= cap
        assert rep.capacity_bytes == cap

    def test_no_collectives_is_identity(self):
        trc = TraceCtx()
        with tracectx(trc):
            a = _t()
            trc.args = (a,)
            out = clang.mul(a, a)
            prims.python_return(out)
            trc.output = out
        new, rep = schedule_collectives(trc)
        assert new is trc and rep is None

    def test_del_carrying_trace_is_identity(self):
        extrace = del_last_used(_mlp_extrace())
        new, rep = schedule_collectives(extrace, device="cpu")
        assert new is extrace and rep is None

    def test_env_kill_switch(self, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_COMM_SCHEDULE", "0")
        assert not enabled()
        extrace = _mlp_extrace()
        new = transform_for_execution(
            dce(trace_program(lambda x: clang.mul(x, x),
                              (torch.ones(4, 4),), {})[1]),
            resolve_executors(["torch"]), comm_schedule=True,
        )
        assert new is not None  # hook path runs without scheduling
        monkeypatch.setenv("THUNDER_TPU_COMM_SCHEDULE", "1")
        assert enabled()

    def test_report_tag_is_json_serializable(self):
        scheduled, rep = schedule_collectives(_mlp_extrace(), device="cpu")
        tag = scheduled.tags["comm_schedule"]
        loaded = json.loads(json.dumps(tag))
        assert loaded["moves"] == rep.moves
        assert loaded["exposed_pct_after"] <= loaded["exposed_pct_before"]
        assert len(loaded["sites"]) == len(rep.sites)


class TestExposedCollectiveRule:
    def test_fires_info_on_exposed_site(self):
        trc = TraceCtx()
        with tracectx(trc):
            a = _t((256, 256))
            trc.args = (a,)
            g = dist_prims.all_gather(a, "dp", 8, dim=0)
            out = clang.mul(g, g)  # immediate consumer: fully exposed
            prims.python_return(out)
            trc.output = out
        diags = [d for d in verify(trc) if d.rule == "sched.exposed-collective"]
        assert diags and all(d.severity == Severity.INFO for d in diags)
        assert "exposed" in diags[0].message

    def test_silent_without_collectives(self):
        trc = TraceCtx()
        with tracectx(trc):
            a = _t()
            trc.args = (a,)
            out = clang.mul(a, a)
            prims.python_return(out)
            trc.output = out
        assert [d for d in verify(trc)
                if d.rule == "sched.exposed-collective"] == []

    def test_advisory_never_gates(self):
        """INFO diagnostics must not fail verify_or_raise at ERROR."""
        from thunder_tpu_torch.analysis import verify_or_raise

        trc = TraceCtx()
        with tracectx(trc):
            a = _t((256, 256))
            trc.args = (a,)
            g = dist_prims.all_gather(a, "dp", 8, dim=0)
            out = clang.mul(g, g)
            prims.python_return(out)
            trc.output = out
        verify_or_raise(trc)  # must not raise


class TestCalibration:
    def test_fit_and_pricing(self):
        spec = DEVICE_SPECS["cpu"]
        # 1 MB all-gather measured at 1 s -> 1 MB/s effective.
        cal = calibrate_ici(spec, [("all-gather", 1e6, 1.0)])
        assert cal.ici_bw_for("all-gather") == pytest.approx(1e6)
        # Unfitted classes fall back to the datasheet rate.
        assert cal.ici_bw_for("all-reduce") == spec.ici_bw
        assert cal.ici_bw_for(None) == spec.ici_bw
        # The base spec is untouched (frozen + replace).
        assert spec.ici_class_bw is None

    def test_fit_clamped_to_datasheet(self):
        spec = DEVICE_SPECS["cpu"]
        cal = calibrate_ici(spec, [("all-reduce", 1e12, 1.0)])  # "faster than wire"
        assert cal.ici_bw_for("all-reduce") == spec.ici_bw

    def test_empty_or_garbage_samples_are_identity(self):
        spec = DEVICE_SPECS["cpu"]
        assert calibrate_ici(spec, []) is spec
        assert calibrate_ici(spec, [(None, 0, 0), ("x", 1e3, 0.0)]) is spec

    def test_trace_cost_prices_calibrated_wire(self):
        extrace = _mlp_extrace(grad=False)
        spec = resolve_device_spec("cpu")
        slow = calibrate_ici(spec, [("all-gather", 1e6, 1.0)])  # 1 MB/s
        base_rows = [r for r in trace_cost(extrace, spec).rows
                     if r.sym == "synchronize"]
        slow_rows = [r for r in trace_cost(extrace, slow).rows
                     if r.sym == "synchronize"]
        assert slow_rows[0].roofline_s > base_rows[0].roofline_s * 100


def test_internal_failure_falls_back_with_a_sharp_edge(monkeypatch, tmp_path):
    """The pass's fallback is the reference's logged policy: an internal
    error returns the unscheduled trace and writes a ``sharp_edge`` event
    (``policy="comm_schedule_fallback"``), never silently."""
    from thunder_tpu_torch.observability import events

    def broken(*a, **k):
        raise RuntimeError("broken pricing")

    extrace = _mlp_extrace()
    monkeypatch.setattr(sched_mod, "predict_overlap", broken)
    path = tmp_path / "events.jsonl"
    events.set_global_path(str(path))
    try:
        new, rep = schedule_collectives(extrace, device="cpu")
    finally:
        events.set_global_path(None)
    assert new is extrace and rep is None
    recs = [json.loads(line) for line in open(path)]
    assert [r["policy"] for r in recs if r["kind"] == "sharp_edge"] == ["comm_schedule_fallback"]
    assert "broken pricing" in recs[-1]["message"]


# =============================================================================
# benchmarks/distributed.py
# =============================================================================


def test_parse_config():
    from thunder_tpu_torch.benchmarks.distributed import parse_config

    assert parse_config("dp2-fsdp2-tp2") == {"dp": 2, "fsdp": 2, "tp": 2}
    assert parse_config("fsdp4") == {"fsdp": 4}
    for bad in ("dp2-dp4", "xx2", "dp", "dp2_tp2"):
        with pytest.raises(ValueError):
            parse_config(bad)


_CLI = ["--dtype", "float32", "--warmup", "1", "--optimizer", "sgd", "--lr", "0.01"]


def test_run_config_error_dicts():
    from thunder_tpu_torch.benchmarks.distributed import run_config

    kw = dict(model="llama-tiny", micro_batch=4, seq=16, iters=1, device="cpu")
    assert run_config("dp2-dp2", **kw)["error"].startswith("Duplicate axis")
    assert run_config("zz2", **kw)["error"].startswith("Bad mesh spec")
    assert run_config("pp2", **kw) == {"mesh": "pp2", "error": "axis pp not exposed by the litgpt CLI"}
    assert run_config("dp1", **kw, extra=_CLI, timeout=0.01) == {"mesh": "dp1", "error": "timed out after 0.01 s"}
    out = run_config("dp1", **kw, extra=["--help"])
    assert out["error"].startswith("unparseable output") and out["mesh"] == "dp1"
    out = run_config("dp1", **dict(kw, model="no-such-model"))
    assert out["error"].startswith("rank 0 exited 1")


def test_cli_fsdp_tp_on_four_gloo_ranks_matches_one_device():
    """``--fsdp 2 --tp 2``: four gloo ranks of the LitGPT CLI, rank 0's
    JSON line against the unsharded CLI's losses, run in this process (4
    decimals, as the CLI rounds them). ``dp1`` as a rank of its own takes
    the mesh path at a mesh of one (its line names a gloo group of one),
    and its losses are the unsharded CLI's."""
    from thunder_tpu_torch.benchmarks import litgpt
    from thunder_tpu_torch.benchmarks.distributed import run_config

    kw = dict(model="llama-tiny", micro_batch=4, seq=32, iters=2, device="cpu", extra=_CLI, timeout=240)
    one = litgpt.run_one(litgpt.parse_args(["--model", "llama-tiny", "--micro-batch", "4", "--seq", "32",
                                            "--iters", "2", "--device", "cpu", *_CLI]))
    dp1 = run_config("dp1", **kw)
    four = run_config("fsdp2-tp2", **kw)
    assert "error" not in dp1 and "error" not in four, (dp1, four)
    assert "process_group" not in one
    assert dp1["process_group"] == {"backend": "gloo", "world": 1}
    assert four["process_group"] == {"backend": "gloo", "world": 4}
    assert (dp1["loss_first"], dp1["loss_last"]) == (one["loss_first"], one["loss_last"])
    assert four["mesh"] == "fsdp2-tp2" and four["n_params"] == one["n_params"]
    assert four["loss_first"] == pytest.approx(one["loss_first"], abs=2e-4)
    assert four["loss_last"] == pytest.approx(one["loss_last"], abs=2e-4)
    assert four["loss_last"] < four["loss_first"]


# =============================================================================
# C.2: the introspection API, through both packages
# =============================================================================


def _pkg(name):
    if name == "jax":
        import thunder_tpu as tt
        import thunder_tpu.torch as lt

        return tt, lt, {}, lambda *s: np.random.RandomState(sum(s)).randn(*s).astype(np.float32)
    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as lt

    return tt, lt, {"device": "cpu"}, lambda *s: torch.from_numpy(np.random.RandomState(sum(s)).randn(*s)
                                                                  .astype(np.float32))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_timers_populated(pkg):
    tt, lt, opts, t = _pkg(pkg)
    jf = tt.jit(lambda x: lt.sum(x), **opts)
    jf(t(4, 4))
    cs = tt.compile_stats(jf)
    assert cs.cache_misses == 1
    assert cs.last_trace_tracing_stop >= cs.last_trace_tracing_start > 0
    assert cs.last_compile_time_ms > 0
    jf(t(4, 4))
    assert cs.last_trace_cache_stop >= cs.last_trace_cache_start >= cs.last_trace_host_start > 0
    assert cs.last_cache_lookup_us >= 0
    if pkg == "torch":
        assert cs.last_trace_host_stop >= cs.last_trace_host_execution_stop >= cs.last_trace_host_execution_start > 0
        v = tt.vmap(lambda x: lt.sum(x), **opts)
        v(t(3, 4))
        assert tt.compile_stats(v).last_compile_time_ms > 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_module_introspection(pkg):
    tt, _, opts, _ = _pkg(pkg)
    m = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.GELU(), torch.nn.Linear(8, 4))
    tm = tt.jit(m, **opts)
    x = torch.randn(3, 8)
    loss = tm(x).sum()
    cs = tt.compile_stats(tm)
    assert cs.cache_misses == 1 and cs.cache_hits == 0 and cs.calls == 1
    assert cs.last_trace_tracing_stop > cs.last_trace_tracing_start > 0
    traces = tt.last_traces(tm)
    assert traces and "linear" in traces[-1].python()
    bw = tt.last_backward_traces(tm)
    assert bw and ("matmul" in bw[-1].python() or "linear" in bw[-1].python())
    loss.backward()
    tm(x)
    assert cs.cache_hits == 1 and cs.calls == 2
    assert tt.cache_hits(tm) == 1 and tt.cache_misses(tm) == 1
    cd = tt.compile_data(tm)
    assert cd.is_module and cd.fn is m
    tm(torch.randn(5, 8))
    assert cs.cache_misses == 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_cache_info_rejects_uncompiled(pkg):
    tt = _pkg(pkg)[0]
    with pytest.raises(ValueError):
        tt.cache_info(lambda x: x)
    if pkg == "torch":
        for helper in (tt.compile_data, tt.compile_stats, tt.last_traces, tt.last_prologue_traces,
                       tt.last_backward_traces, tt.last_staging, tt.cache_hits, tt.cache_misses):
            with pytest.raises(ValueError, match="Not a thunder_tpu_torch-compiled function"):
                helper(lambda x: x)
