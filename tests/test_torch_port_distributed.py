"""The port's distribution layer in one process, against the JAX package.

The trace-level cases of ``tests/test_distributed.py`` (TestCollectiveIR),
``tests/test_analysis.py`` (TestCollectiveRules),
``tests/test_static_planner.py`` (TestScheduleCertificate), the collective
pricing of ``tests/test_perf_attribution.py``, ``tests/test_federation.py``
and ``tests/test_comm_schedule.py``, and ``tests/test_tooling.py``'s
TestCheckpoint, each built the same way in both packages and held to the
same result. Then the one-rank group (gloo on a FileStore): a jitted
module under ddp, fsdp ZERO2 and ZERO3, and no_sync, against the untagged
module, bit for bit, as ``chip_smoke.py`` phase 22 holds them on NCCL. The
multi-rank cases are ``tests/test_torch_port_distributed_ranks.py``.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import thunder_tpu  # noqa: F401 - the reference the trace-level cases hold the port to
import thunder_tpu_torch as tt


def _pkg(name: str) -> types.SimpleNamespace:
    """The modules a trace-building case needs, from either package."""
    import importlib

    root = {"jax": "thunder_tpu", "port": "thunder_tpu_torch"}[name]
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    trace = mod("core.trace")
    return types.SimpleNamespace(
        name=name, clang=mod("clang"), prims=mod("core.prims"), dist=mod("distributed.prims"),
        distributed=mod("distributed"), proxies=mod("core.proxies"), dtypes=mod("core.dtypes"),
        devices=mod("core.devices"), TraceCtx=trace.TraceCtx, tracectx=trace.tracectx, from_trace=trace.from_trace,
        TraceProvenance=trace.TraceProvenance, detached_trace=trace.detached_trace, analysis=mod("analysis"), schedule=mod("analysis.schedule"),
        cost=mod("analysis.cost"), api=mod("api"), autodiff=mod("transforms.autodiff"),
        common=mod("transforms.common"))


PKGS = ("jax", "port")


def _t(p, shape=(4, 4), name=None):
    return p.proxies.TensorProxy(name=name, shape=shape, dtype=p.dtypes.float32, device=p.devices.Device("cpu"))


def _rule(diags, rule):
    return [(d.bsym_index, d.severity.name) for d in diags if d.rule == rule]


def _both(build):
    """``build(pkg)`` in each package; the two results, which must agree."""
    got = {name: build(_pkg(name)) for name in PKGS}
    assert got["jax"] == got["port"], got
    return got["port"]


# =============================================================================
# TestCollectiveIR (tests/test_distributed.py:43-128)
# =============================================================================


def _grad_source(p, sharded: bool) -> str:
    ltorch = __import__({"jax": "thunder_tpu.torch", "port": "thunder_tpu_torch.torch"}[p.name], fromlist=["x"])
    rng = np.random.RandomState(0)
    if sharded:
        w, x, axis, n = rng.randn(2, 8).astype(np.float32), rng.randn(3, 8).astype(np.float32), "fsdp", 4
    else:
        w, x, axis, n = rng.randn(4, 4).astype(np.float32), rng.randn(2, 4).astype(np.float32), "dp", 8
    if p.name == "port":
        w, x = torch.from_numpy(w), torch.from_numpy(x)

    def f(w, x):
        if sharded:
            w.dist_parallel_type = p.proxies.DistParallelType.FULLY_SHARDED
        w2 = p.dist.synchronize(w, axis, n)
        return ltorch.sum(ltorch.linear(x, w2) ** 2.0)

    _, comp = p.api.trace_program(f, (w, x), {})
    return p.autodiff.grad_transform(p.common.dce(comp)).python()


class TestCollectiveIR:
    @pytest.mark.parametrize("sharded", [False, True], ids=["ddp", "fsdp"])
    def test_synchronize_vjp(self, sharded):
        """ddp: the backward all-reduces the grad scaled by 1/8; fsdp: it
        reduce-scatters the grad scaled by 1/4 (prims.py:286-298)."""
        def build(p):
            src = _grad_source(p, sharded)
            return ("synchronize" in src, "reduce_scatter" in src, "all_reduce" in src,
                    ("0.25" if sharded else "0.125") in src)

        assert _both(build) == (True, sharded, not sharded, True)

    def test_all_gather_meta_shapes(self):
        def build(p):
            with p.detached_trace():
                t = p.proxies.TensorProxy(shape=(2, 3), dtype=None, device="cpu")
                out = p.dist.all_gather(t, "dp", 4)
                fut = p.dist.all_gather(t, "dp", 4, async_op=True)
                waited = p.dist.wait(fut)
                rs = p.dist.reduce_scatter(t, "dp", 2, dim=0)
                return (tuple(out.shape), isinstance(fut, p.proxies.FutureTensorProxy),
                        isinstance(waited, p.proxies.FutureTensorProxy), tuple(waited.shape), tuple(rs.shape))

        assert _both(build) == ((8, 3), True, False, (8, 3), (1, 3))

    def test_no_sync_context(self):
        def build(p):
            d = p.distributed
            seen = [d.skip_data_parallel_grad_sync()]
            with d.no_sync():
                seen.append(d.skip_data_parallel_grad_sync())
            return seen + [d.skip_data_parallel_grad_sync()]

        assert _both(build) == [False, True, False]


# =============================================================================
# TestCollectiveRules (tests/test_analysis.py:302)
# =============================================================================


def _verified(p, body, provenance=None, **kw):
    trc = p.TraceCtx()
    with p.tracectx(trc):
        out = body(p, trc)
        p.prims.python_return(out)
    trc.output = out
    if provenance:
        trc.provenance = p.TraceProvenance(provenance)
    return p.analysis.verify(trc, **kw)


def _group_mismatch(p, trc):
    a = _t(p)
    trc.args = (a,)
    return p.dist.all_reduce(p.dist.all_reduce(a, "dp", 4), "dp", 8)


def _groups_consistent(p, trc):
    a = _t(p)
    trc.args = (a,)
    return p.dist.all_reduce(p.dist.all_reduce(a, "dp", 4), "dp", 4)


def _bad_axis(p, trc):
    a = _t(p)
    trc.args = (a,)
    return p.dist.all_reduce(a, "", 4)


def _future_unwaited(p, trc):
    a = _t(p)
    trc.args = (a,)
    fut = p.dist.all_gather(a, "dp", 4, async_op=True)
    return p.clang.mul(fut, fut)


def _future_waited(p, trc):
    a = _t(p)
    trc.args = (a,)
    got = p.dist.wait(p.dist.all_gather(a, "dp", 4, async_op=True))
    return p.clang.mul(got, got)


def _joint(balanced: bool):
    def body(p, trc):
        shard = _t(p, (2, 4))
        shard.dist_parallel_type = p.proxies.DistParallelType.FULLY_SHARDED
        trc.args = (shard,)
        full = p.dist.synchronize(shard, "fsdp", 4, "fsdp")
        loss = p.clang.mul(full, full)
        return p.dist.reduce_scatter(loss, "fsdp", 4) if balanced else loss

    return body


class TestCollectiveRules:
    @pytest.mark.parametrize("body, rule, want", [
        (_group_mismatch, "dist.group-size-mismatch", [(1, "ERROR")]),
        (_groups_consistent, "dist.group-size-mismatch", []),
        (_bad_axis, "dist.axis", [(0, "ERROR")]),
        (_future_unwaited, "dist.future-without-wait", [(1, "ERROR")]),
        (_future_waited, "dist.future-without-wait", []),
    ], ids=["mismatch", "consistent", "bad-axis", "unwaited", "waited"])
    def test_rule(self, body, rule, want):
        assert _both(lambda p: _rule(_verified(p, body), rule)) == want

    @pytest.mark.parametrize("balanced", [False, True])
    def test_grad_collectives_balance(self, balanced):
        got = _both(lambda p: _rule(_verified(p, _joint(balanced), "Grad transform (joint fw+bw)"),
                                    "dist.unbalanced-grad-collectives"))
        assert got == ([] if balanced else [(0, "WARNING")])


# =============================================================================
# TestScheduleCertificate (tests/test_static_planner.py:236)
# =============================================================================


def _two_axis(p):
    trc = p.TraceCtx()
    with p.tracectx(trc):
        a, b = _t(p), _t(p)
        trc.args = (a, b)
        out = p.clang.add(p.dist.all_reduce(a, "dp", 4), p.dist.all_reduce(b, "tp", 2))
        p.prims.python_return(out)
        trc.output = out
    return trc


def _same_axis(p):
    trc = p.TraceCtx()
    with p.tracectx(trc):
        a = _t(p)
        trc.args = (a,)
        out = p.clang.add(p.dist.all_reduce(a, "dp", 4), p.dist.all_reduce(a, "dp", 4))
        p.prims.python_return(out)
        trc.output = out
    return trc


def _sites(cert):
    return [(s.index, s.sym, s.axis, s.earliest, s.latest, s.deps_before, s.deps_after) for s in cert.sites]


class TestScheduleCertificate:
    def test_independent_axes_are_movable(self):
        def build(p):
            cert = p.schedule.certify(_two_axis(p))
            s1, s2 = cert.sites
            return _sites(cert), s1.latest == s2.index, s2.hoistable, sorted(cert.axis_order), cert.axis_labels()

        got = _both(build)
        assert got[1:] == (True, True, ["dp", "tp"], {"dp": ["L0.all_reduce"], "tp": ["L1.all_reduce"]})

    def test_same_axis_collectives_pin_each_other(self):
        def build(p):
            s1, s2 = p.schedule.certify(_same_axis(p)).sites
            return s1.latest < s2.index, s2.earliest > s1.index

        assert _both(build) == (True, True)

    def test_wait_pairing_constrains_placement(self):
        def build(p):
            trc = p.TraceCtx()
            with p.tracectx(trc):
                a = _t(p)
                trc.args = (a,)
                got = p.dist.wait(p.dist.all_gather(a, "dp", 4, async_op=True))
                out = p.clang.mul(got, got)
                p.prims.python_return(out)
                trc.output = out
            cert = p.schedule.certify(trc)
            return cert.site_at(1).earliest > cert.site_at(0).index

        assert _both(build) is True

    def test_inplace_write_is_an_anti_dependency(self):
        def build(p):
            trc = p.TraceCtx()
            with p.tracectx(trc):
                a, src = _t(p), _t(p)
                trc.args = (a, src)
                written = _t(p)
            trc.bound_symbols.append(p.prims.copy_.bind(src, a, output=written))
            with p.tracectx(trc):
                r = p.dist.all_reduce(a, "dp", 4)
                out = p.clang.mul(r, r)
                p.prims.python_return(out)
                trc.output = out
            site = p.schedule.certify(trc).sites[0]
            return site.earliest, 0 in site.deps_before

        assert _both(build) == (1, True)

    @pytest.mark.parametrize("recertified", [False, True])
    def test_reorder_flagged_unless_recertified(self, recertified):
        def build(p):
            trc = _same_axis(p)
            p.schedule.stamp(trc)
            moved = p.from_trace(trc)
            bs = list(trc.bound_symbols)
            bs[0], bs[1] = bs[1], bs[0]
            moved.bound_symbols = bs
            if recertified:
                p.schedule.recertify(moved)
            diags = p.analysis.verify(moved, pass_name="reorder pass", disable={"ssa.use-before-def"})
            found = [(d.severity.name, d.pass_name) for d in diags if d.rule == "sched.uncertified-reorder"]
            # A flagged order never becomes the baseline: verifying again fires again.
            again = [d for d in p.analysis.verify(moved, disable={"ssa.use-before-def"})
                     if d.rule == "sched.uncertified-reorder"]
            return found, bool(again)

        got = _both(build)
        assert got == (([], False) if recertified else ([("ERROR", "reorder pass")], True))

    def test_additions_and_deletions_are_legal(self):
        def build(p):
            trc = _two_axis(p)
            p.schedule.stamp(trc)
            grown = p.from_trace(trc)
            grown.bound_symbols = list(trc.bound_symbols)
            with p.tracectx(grown):
                p.dist.all_reduce(grown.args[0], "dp", 4)
            grown.bound_symbols.insert(3, grown.bound_symbols.pop())
            return [d.rule for d in p.analysis.verify(grown) if d.rule == "sched.uncertified-reorder"]

        assert _both(build) == []


# =============================================================================
# Collective pricing and calibrate_ici
# =============================================================================


class TestCollectivePricing:
    def test_collective_wire_bytes(self):
        def build(p):
            g = 8
            a = p.proxies.TensorProxy("a", shape=(1024,), dtype=p.dtypes.float32)
            out = p.proxies.TensorProxy("o", shape=(1024,), dtype=p.dtypes.float32)
            ar = p.cost.bsym_cost(p.dist.all_reduce.bind(a, "data", g, output=out))
            ag = p.cost.bsym_cost(p.dist.all_gather.bind(a, "data", g, output=out))
            return ar.kind, ar.comm_bytes, ag.comm_bytes

        assert _both(build) == ("collective", 2.0 * 7 / 8 * 4096, 7 / 8 * 4096)

    @pytest.mark.parametrize("case", ["hier", "dcn-axis", "ici-axis", "fsdp-sync"])
    def test_trace_wire_bytes(self, case):
        """hier: 8x8 f32 (256 B), inner group 4, outer 2: 2*(3/4)*256 = 384 B
        within the inner group, 2*(1/2)*64 = 64 B of the shard on the slower
        tier; a flat all-reduce on the "dcn" axis is all slower tier."""
        def build(p):
            def fn(a):
                if case == "hier":
                    return p.dist.hier_all_reduce(a, "dp", "dcn", 4, 2)
                if case == "fsdp-sync":
                    return p.dist.synchronize(a, "fsdp", 4, "fsdp")
                return p.dist.all_reduce(a, "dcn" if case == "dcn-axis" else "dp", 2)

            x = np.zeros((8, 8), np.float32)
            if p.name == "jax":
                tc = p.cost.cost_report(fn, x, executors=["jax"], device="cpu")
            else:
                tc = p.cost.cost_report(fn, torch.from_numpy(x), executors=["torch"], device="cpu")
            return tc.total_comm_bytes, tc.total_dcn_bytes, [r.bound for r in tc.collective_rows()]

        got = _both(build)
        want = {"hier": (448.0, 64.0), "dcn-axis": (256.0, 256.0), "ici-axis": (256.0, 0.0),
                "fsdp-sync": (3 / 4 * 1024, 0.0)}[case]
        assert got[:2] == want and got[2] == ["comm"]

    def test_slower_tier_costs_more(self):
        from thunder_tpu_torch.analysis.cost import DEVICE_SPECS, TraceCost

        dev = DEVICE_SPECS["cpu"]
        assert dev.dcn_bw_or_ici < dev.ici_bw
        assert (TraceCost(device=dev, total_comm_bytes=1e9, total_dcn_bytes=1e9).comm_s
                > TraceCost(device=dev, total_comm_bytes=1e9).comm_s)

    def test_h100_link_rate_is_the_nvlink_datasheet(self):
        from thunder_tpu_torch.analysis.cost import DEVICE_SPECS

        # NVLink 4: 900 GB/s a GPU in both directions together, 450 each way.
        assert DEVICE_SPECS["h100"].ici_bw == 450e9 and DEVICE_SPECS["h100"].dcn_bw == 0.0

    def test_calibrate_ici(self):
        def build(p):
            spec = p.cost.DEVICE_SPECS["cpu"]
            cal = p.cost.calibrate_ici(spec, [("all-gather", 1e6, 1.0)])
            clamped = p.cost.calibrate_ici(spec, [("all-reduce", 1e12, 1.0)])
            return (cal.ici_bw_for("all-gather"), cal.ici_bw_for("all-reduce") == spec.ici_bw,
                    cal.ici_bw_for(None) == spec.ici_bw, spec.ici_class_bw,
                    clamped.ici_bw_for("all-reduce") == spec.ici_bw,
                    p.cost.calibrate_ici(spec, []) is spec,
                    p.cost.calibrate_ici(spec, [(None, 0, 0), ("x", 1e3, 0.0)]) is spec,
                    p.cost.collective_sym_class("synchronize"))

        assert _both(build) == (1e6, True, True, None, True, True, True, "all-gather")

    def test_trace_cost_prices_calibrated_wire(self):
        from thunder_tpu_torch.analysis.cost import calibrate_ici, cost_report, resolve_device_spec, trace_cost
        from thunder_tpu_torch.distributed import prims as dist

        tc = cost_report(lambda a: dist.synchronize(a, "fsdp", 4, "fsdp"), torch.zeros(8, 8),
                         executors=["torch"], device="cpu")
        spec = resolve_device_spec("cpu")
        slow = calibrate_ici(spec, [("all-gather", 1e6, 1.0)])
        assert tc.collective_rows()
        from thunder_tpu_torch.analysis.liveness import claimed_trace

        trc = claimed_trace(lambda a: dist.synchronize(a, "fsdp", 4, "fsdp"), (torch.zeros(8, 8),), {}, ["torch"])
        base = [r for r in trace_cost(trc, spec).rows if r.sym == "synchronize"]
        slowed = [r for r in trace_cost(trc, slow).rows if r.sym == "synchronize"]
        assert slowed[0].roofline_s > base[0].roofline_s * 100


# =============================================================================
# TestCheckpoint (tests/test_tooling.py:92-145), one process
# =============================================================================


def _state():
    from thunder_tpu_torch.models import gpt as m

    return m.init_params(m.name_to_config("gpt-tiny"), dtype=torch.float32, seed=3, device="cpu")


class TestCheckpoint:
    @pytest.mark.parametrize("how", ["sync", "async", "full", "template"])
    def test_roundtrip(self, tmp_path, how):
        """Saved and loaded bit for bit: written in the background
        (async), as one consolidated file (full), or loaded by a template's
        structure where the checkpoint keeps none (template)."""
        import os

        import torch.utils._pytree as pytree

        from thunder_tpu_torch.distributed.checkpoint import StateDictOptions, load, save

        state = _state()
        path = str(tmp_path / "ckpt")
        if how == "async":
            handle = save(state, path, async_save=True)
            assert handle is not None
            handle.wait()
        else:
            save(state, path, options=StateDictOptions(full_state_dict=how == "full"))
        if how == "template":
            os.remove(os.path.join(path, "structure.json"))
        got = load(path, template=state if how == "template" else None)
        a, s1 = pytree.tree_flatten(state)
        b, s2 = pytree.tree_flatten(got)
        assert s1 == s2
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# =============================================================================
# A one-rank group: ddp, fsdp and no_sync against the untagged module
# =============================================================================


def test_init_without_a_card_raises(monkeypatch):
    # Before this file's one-rank group is made (its fixture is first used below).
    import thunder_tpu_torch.distributed as td

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not td.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.init(coordinator_address="localhost:1", num_processes=1, process_id=0)


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 32)
        self.fc2 = nn.Linear(32, 4)
        self.norm = nn.LayerNorm(32)

    def forward(self, x):
        return self.fc2(self.norm(F.gelu(self.fc1(x))))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import thunder_tpu_torch.distributed as td

    store = torch.distributed.FileStore(str(tmp_path_factory.mktemp("store") / "s"), 1)
    info = td.init(device="cpu", store=store, num_processes=1, process_id=0)
    yield info
    td.shutdown()
    assert not td.is_initialized()


def _tagged(mode: str):
    from thunder_tpu_torch.distributed import FSDPType, ddp, fsdp

    torch.manual_seed(0)
    m = MLP()
    if mode == "ddp":
        return ddp(m)
    return fsdp(m, sharding_strategy=FSDPType.ZERO2 if mode == "zero2" else FSDPType.ZERO3)


@pytest.mark.parametrize("mode", ["ddp", "zero2", "zero3"])
def test_one_rank_module_is_bit_equal_to_untagged(one_rank, mode):
    """At one rank every collective is the identity and grad_scale is 1:
    the losses and grads of 3 SGD steps equal the untagged module's bit
    for bit, and the traces hold the JAX package's collectives."""
    assert one_rank == {"process_id": 0, "num_processes": 1, "devices": 1, "local_devices": 1}
    torch.manual_seed(0)
    ref = MLP()
    m = _tagged(mode)
    t_ref, tm = tt.jit(ref, device="cpu"), tt.jit(m, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(6, 8).astype(np.float32))
    opts = [torch.optim.SGD(mod.parameters(), lr=0.1) for mod in (ref, m)]
    for _ in range(3):
        losses = []
        for t, opt in zip((t_ref, tm), opts):
            opt.zero_grad()
            loss = t(x).square().mean()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        assert torch.equal(*losses)
        for (name, p), q in zip(ref.named_parameters(), m.parameters()):
            assert torch.equal(p.grad, q.grad), name
    fw, bw = tt.last_traces(tm)[-1].python(), tt.last_backward_traces(tm)[-1].python()
    assert "synchronize" in fw
    assert ("all_reduce" if mode == "ddp" else "reduce_scatter") in bw
    assert ("synchronize" in bw) == (mode == "zero3")
    assert tt.compile_stats(tm).last_traces[-1].tags["collective_bytes"] > 0


def test_one_rank_no_sync_has_no_collective_and_sums_microbatches(one_rank):
    torch.manual_seed(0)
    ref = MLP()
    tm = tt.jit(_tagged("ddp"), device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 6, 8).astype(np.float32))
    with tm.no_sync():
        for k in range(2):
            (tm(x[k]).square().mean() / 2).backward()
        bw = tt.last_backward_traces(tm)[-1].python()
        assert "all_reduce" not in bw and "reduce_scatter" not in bw
    assert not tm._nosync_accum
    (ref(x.reshape(12, 8)).square().mean()).backward()
    for (name, p), q in zip(ref.named_parameters(), tm.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-5, atol=1e-6, msg=name)


def test_one_rank_checkpoint_of_fsdp_module_state(one_rank, tmp_path):
    """The state of an fsdp module saved with its specs loads back into a
    fresh one bit for bit (``chip_smoke.py`` phase 22 (d))."""
    from thunder_tpu_torch.distributed import checkpoint as ck
    from thunder_tpu_torch.distributed.runtime import P

    tm = tt.jit(_tagged("zero3"), device="cpu")
    state = {k: v.detach() for k, v in tm.state_dict().items()}
    specs = {k: P("fsdp") if k in tm._sharded else P() for k in state}
    ck.save(state, str(tmp_path / "m"), specs=specs)
    fresh = tt.jit(_tagged("zero3"), device="cpu")
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    fresh.load_state_dict(ck.load(str(tmp_path / "m"), specs=specs))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_a_collective_outside_a_bound_program_raises():
    from thunder_tpu_torch.distributed.runtime import group_of

    with pytest.raises(RuntimeError, match="outside a program bound to process groups"):
        group_of("dp")


# =============================================================================
# Attribution's collective rows (thunder_tpu/observability/attribution.py:60-218, :674)
# =============================================================================


def _ev(cat, name, ts, dur, corr=None, tid=11, pid=10):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=pid, tid=tid,
                args={} if corr is None else {"correlation": corr})


def test_collective_rows_and_their_join(tmp_path):
    """A line whose symbol is a collective is a collective row whatever its
    kernel is called (at one rank, a copy); an NCCL kernel outside every
    line is a row by its own name; a row's hidden time is what kernels on
    another stream overlapped; the join puts the cost model's wire time
    beside a line's row."""
    import json

    from thunder_tpu_torch.analysis.cost import DEVICE_SPECS, OpCostRow, TraceCost
    from thunder_tpu_torch.observability.attribution import attribute, collective_class, join_cost_attribution

    events = [
        _ev("user_annotation", "L3.all_reduce#bw", 0.0, 50.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 60.0, 2.0, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 70.0, 2.0, 3),
        _ev("kernel", "elementwise_kernel<copy>", 100.0, 40.0, 1, tid=7, pid=0),
        _ev("kernel", "nvjet_gemm", 120.0, 100.0, 2, tid=8, pid=0),
        _ev("kernel", "ncclDevKernel_AllGather_RING_LL", 300.0, 30.0, 3, tid=9, pid=0),
    ]
    path = tmp_path / "c.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    attr = attribute(str(path))
    rows = attr.collectives
    assert set(rows) == {"L3.all_reduce#bw", "ncclDevKernel_AllGather_RING_LL"}
    line = rows["L3.all_reduce#bw"]
    assert (line.cls, line.us, line.hidden_us, line.exposed_us, line.count) == ("all-reduce", 40.0, 20.0, 20.0, 1)
    nccl = rows["ncclDevKernel_AllGather_RING_LL"]
    assert (nccl.cls, nccl.us, nccl.hidden_us) == ("all-gather", 30.0, 0.0)
    assert attr.collective_summary()["all-reduce"].us == 40.0
    assert collective_class("nvjet_gemm") is None and collective_class("ncclKernel_ReduceScatter_RING") == "reduce-scatter"
    cost = TraceCost(device=DEVICE_SPECS["h100"], rows=[
        OpCostRow(index=3, sym="all_reduce", kind="collective", flops=0.0, bytes_moved=0.0, roofline_s=2e-6,
                  bound="comm", intensity=0.0, comm_bytes=900e3)])
    join = join_cost_attribution(attr, {"bw": cost}, steps=1)
    by_key = {c.key: c for c in join.collectives}
    assert by_key["L3.all_reduce#bw"].predicted_wire_us == pytest.approx(2.0)
    assert by_key["ncclDevKernel_AllGather_RING_LL"].predicted_wire_us is None  # a line's row exists
    assert "collectives (us/step)" in join.format()
