"""Device-time attribution, the cost join and the roofline ledger of the
port, on the CPU.

The counterparts of ``tests/test_perf_attribution.py`` (scope parsing,
self-time nesting, the join, the monitor report, a live profile) and of
``tests/test_roofline.py`` (the join's bytes, the ledger, the drift band,
the sampler's duty cycle and probe pipeline), less the cases that need HLO
(``hlo_scope_map``: the port's seat is the launch-order map), ``scripts/``
(``perf_report``), the committed ``ROOFLINE_r*.json`` or the ops plane.
Scope parsing and the drift band run through both packages; the rest is
the port's own reading of a ``torch.profiler`` Chrome trace, so its cases
build that trace inside the test: kernels with the correlation ids of their
launches, a cuBLAS kernel and a counted wrapper's kernel under one line's
range, nested ranges, and a CUDA graph's replay, whose kernels carry only
their ``cudaGraphLaunch``'s correlation and come out unattributed unless a
launch-order map places them.
"""

import json
import os
import types

import pytest
import torch

import thunder_tpu.observability.attribution as jattr
import thunder_tpu.observability.detect as jdetect

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.monitor as tmonitor
import thunder_tpu_torch.observability.attribution as tattr
from thunder_tpu_torch.analysis.cost import trace_cost
from thunder_tpu_torch.observability import detect as tdetect
from thunder_tpu_torch.observability import metrics as tmetrics
from thunder_tpu_torch.observability.attribution import (
    Attribution,
    ScopeRef,
    attribute,
    join_cost_attribution,
    launch_map_of_events,
    parse_scope,
    trace_costs,
)
from thunder_tpu_torch.observability.roofline import ROW_FIELDS, RooflineLedger, RooflineSampler

BOTH_ATTR = pytest.mark.parametrize("A", [jattr, tattr], ids=["jax", "port"])
BOTH_DETECT = pytest.mark.parametrize("D", [jdetect, tdetect], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _metrics_isolation():
    was = tmonitor.enabled()
    tmonitor.disable()
    tmonitor.reset()
    yield
    tmonitor.reset()
    (tmonitor.enable if was else tmonitor.disable)()


def _extrace(fn, *args):
    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.transforms.common import cse, dce

    _, comp = trace_program(fn, args, {})
    return transform_for_execution(cse(dce(comp)), resolve_executors(["torch"]))


def _matmul_join(measured_us=300.0, steps=1):
    a = torch.ones(1024, 1024)  # a bound of microseconds on the H100: the ledger keeps 3 decimals
    extrace = _extrace(lambda a, b: tclang.sum(tclang.tanh(tclang.matmul(a, b))), a, a)
    cost = trace_cost(extrace, "h100")
    mm = [r for r in cost.rows if r.kind == "matmul"][0]
    attr = Attribution(by_line={ScopeRef(mm.index, mm.sym, "Transform_for_execution"): measured_us},
                       device_busy_us=measured_us)
    return join_cost_attribution(attr, cost, steps=steps), mm, cost


# =============================================================================
# Scope parsing: both packages
# =============================================================================


class TestScopeParsing:
    @BOTH_ATTR
    @pytest.mark.parametrize("name, want", [
        ("jit_f/L17.matmul#Transform_for_execution/dot.3", (17, "matmul", "Transform_for_execution")),
        ("L3.tanh@Delete_Last_Used", (3, "tanh", "Delete_Last_Used")),
        ("jit_f/jit_main/L5.linear/dot.1", (5, "linear", None)),
        ("L9.torch.sdpa_fwd_res#Transform_for_execution/custom-call", (9, "torch.sdpa_fwd_res",
                                                                      "Transform_for_execution")),
        ("L4.apply_rope#backward_Delete_Last_Used", (4, "apply_rope", "backward_Delete_Last_Used")),
        ("L2.sgd_update#run_step", (2, "sgd_update", "run_step")),
        ("fusion.123", None),
        ("", None),
    ])
    def test_parse(self, A, name, want):
        ref = A.parse_scope(name)
        assert (None if ref is None else (ref.line, ref.sym, ref.pass_name)) == want

    @BOTH_ATTR
    def test_multiple_scopes_in_one_name(self, A):
        refs = A.parse_scopes("fusion jit/L1.mul#P/multiply jit/L2.add#P/add")
        assert {(r.line, r.sym) for r in refs} == {(1, "mul"), (2, "add")}

    def test_label_round_trips(self):
        for ref in (ScopeRef(3, "linear", "Delete_Last_Used"), ScopeRef(5, "sum", None)):
            assert parse_scope(ref.label) == ref


# =============================================================================
# A torch.profiler Chrome trace, built here
# =============================================================================

HOST = dict(pid=10, tid=11)
STREAM = dict(pid=0, tid=7)


def _range(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, args={"External id": 0}, **HOST)


def _launch(name, ts, corr, cat="cuda_runtime"):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=2.0, args={"correlation": corr}, **HOST)


def _kernel(name, ts, dur, corr, cat="kernel"):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args={"correlation": corr, "stream": 7}, **STREAM)


def _graph_step(step: int, t0: float, corr: int, names_durs) -> list:
    """One profiled step holding one CUDA-graph replay: the step's range,
    its cudaGraphLaunch, and the graph's kernels, which carry the launch's
    correlation and sit in no line's range."""
    evs = [_range(f"thunder_step#{step}", t0, 400.0), _launch("cudaGraphLaunch", t0 + 10, corr)]
    ts = t0 + 50
    for name, dur in names_durs:
        evs.append(_kernel(name, ts, dur, corr))
        ts += dur + 1
    return evs


def _eager_events() -> list:
    """An eager step: L3.linear's range launches a cuBLAS kernel and a
    memset; L5's range holds a nested L6 range, whose launch goes to L6,
    and a driver-API launch of a counted wrapper's kernel, to L5; one
    launch sits outside every range (a staging copy)."""
    return [
        _range("thunder_step#0", 0.0, 1000.0),
        _range("L3.linear#Delete_Last_Used", 10.0, 90.0),
        dict(ph="X", cat="cpu_op", name="aten::linear", ts=12.0, dur=70.0, args={}, **HOST),
        _launch("cudaLaunchKernel", 20.0, 1),
        _launch("cudaMemsetAsync", 30.0, 2),
        _range("L5.sdpa_fwd_res#Delete_Last_Used", 110.0, 90.0),
        _range("L6.inner#Delete_Last_Used", 120.0, 30.0),
        _launch("cudaLaunchKernel", 130.0, 3),
        _launch("cuLaunchKernel", 160.0, 4, cat="cuda_driver"),
        _launch("cudaLaunchKernel", 205.0, 5),
        _kernel("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN", 300.0, 50.0, 1),
        _kernel("Memset (Device)", 360.0, 4.0, 2, cat="gpu_memset"),
        _kernel("elementwise_kernel<inner>", 370.0, 6.0, 3),
        _kernel("flash_fwd_kernel<100, true>", 380.0, 300.0, 4),
        _kernel("copy_kernel", 690.0, 10.0, 5),
    ]


def _write(tmp_path, events, name="t.trace.json") -> str:
    p = tmp_path / name
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


class TestChromeTraceAttribution:
    def test_launches_charge_their_innermost_line(self, tmp_path):
        attr = attribute(_write(tmp_path, _eager_events()))
        by = {ref.label: us for ref, us in attr.by_line.items()}
        assert attr.mode == "cuda"
        # The cuBLAS kernel and the memset launched in L3's range.
        assert by["L3.linear#Delete_Last_Used"] == pytest.approx(54.0)
        # The nested range wins; the driver-API launch of the wrapper's
        # kernel sits in L5's range outside L6's.
        assert by["L6.inner#Delete_Last_Used"] == pytest.approx(6.0)
        assert by["L5.sdpa_fwd_res#Delete_Last_Used"] == pytest.approx(300.0)
        assert attr.unattributed == {"copy_kernel": pytest.approx(10.0)}
        assert attr.device_busy_us == pytest.approx(370.0)
        assert attr.coverage == pytest.approx(360.0 / 370.0)
        assert attr.line_ops(ScopeRef(3, "linear", "Delete_Last_Used")) == {
            "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN": [50.0, 1], "Memset (Device)": [4.0, 1]}
        assert attr.by_pass == {"Delete_Last_Used": pytest.approx(360.0)}
        assert "L5.sdpa_fwd_res" in attr.format()

    def test_launch_order_map_of_an_eager_run(self, tmp_path):
        lmap = launch_map_of_events(_eager_events())
        assert lmap == [("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN", "L3.linear#Delete_Last_Used"),
                        ("Memset (Device)", "L3.linear#Delete_Last_Used"),
                        ("elementwise_kernel<inner>", "L6.inner#Delete_Last_Used"),
                        ("flash_fwd_kernel<100, true>", "L5.sdpa_fwd_res#Delete_Last_Used"),
                        ("copy_kernel", None)]

    def test_launch_order_map_within_one_call(self):
        """``scope_map_of`` maps one call: the session's lead-in
        (``profile.LEAD_IN``) is not part of it."""
        from thunder_tpu_torch.observability.profile import LEAD_IN

        lead = [_range(LEAD_IN, 0.0, 50.0), _launch("cudaLaunchKernel", 8.0, 1), _kernel("k_lead", 60.0, 3.0, 1)]
        call = [_range("L1.add#P", 105.0, 10.0), _launch("cudaLaunchKernel", 108.0, 2), _kernel("k_add", 160.0, 3.0, 2)]
        assert launch_map_of_events(lead + call) == [("k_add", "L1.add#P")]

    def test_lead_in_is_left_out(self, tmp_path):
        """What a session runs in its lead-in range (``profile.LEAD_IN``: on
        the card a sleep and a burst of small kernels, to take the place of
        records lost at a session's start) is not the profiled work."""
        from thunder_tpu_torch.observability.profile import LEAD_IN

        lead = [_range(LEAD_IN, -500.0, 400.0), _launch("cudaLaunchKernel", -450.0, 90),
                _kernel("spin_kernel", -400.0, 300.0, 90),
                dict(ph="X", cat="cpu_op", name="aten::add_", ts=-300.0, dur=5.0, args={}, **HOST)]
        attr = attribute(_write(tmp_path, lead + _eager_events()))
        assert attr.device_busy_us == pytest.approx(370.0) and "spin_kernel" not in attr.unattributed

    def test_graph_replay_kernels_are_unattributed_without_a_map(self, tmp_path):
        evs = _graph_step(0, 0.0, 9, [("k_a", 20.0), ("k_b", 30.0)])
        attr = attribute(_write(tmp_path, evs))
        assert not attr.by_line and attr.unattributed == {"k_a": 20.0, "k_b": 30.0}
        assert (attr.graph_ops, attr.graph_placed) == (2, 0) and attr.coverage == 0.0

    def test_graph_replay_placed_by_the_map_step_by_step(self, tmp_path):
        lmap = [("k_a", "L7.add#P"), ("k_b", "L8.mul#P"), ("k_c", None)]
        kern = [("k_a", 20.0), ("k_b", 30.0), ("k_c", 5.0)]
        evs = _graph_step(0, 0.0, 9, kern) + _graph_step(1, 1000.0, 10, kern)
        attr = attribute(_write(tmp_path, evs), launch_map=lmap)
        assert attr.by_line == {ScopeRef(7, "add", "P"): 40.0, ScopeRef(8, "mul", "P"): 60.0}
        assert attr.counts == {ScopeRef(7, "add", "P"): 2, ScopeRef(8, "mul", "P"): 2}
        # A kernel the map itself could not place stays unattributed.
        assert attr.unattributed == {"k_c": 10.0}
        assert (attr.graph_ops, attr.graph_placed, attr.graph_steps) == (6, 4, [3, 3])

    def test_a_backward_graph_launched_from_another_thread_joins_its_step(self, tmp_path):
        """A module's step replays its forward graph from the caller's thread
        and its backward graph from autograd's: both are one step's kernels,
        placed against the map of the whole eager step."""
        lmap = [("k_a", "L7.add#F"), ("k_b", "L8.mul#F"), ("k_c", "L3.mul#B")]
        evs = []
        for step, t0 in enumerate((0.0, 1000.0)):
            evs += [_range(f"thunder_step#{step}", t0, 400.0), _launch("cudaGraphLaunch", t0 + 10, 20 + step),
                    dict(_launch("cudaGraphLaunch", t0 + 30, 30 + step), tid=12),
                    _kernel("k_a", t0 + 50, 20.0, 20 + step), _kernel("k_b", t0 + 80, 30.0, 20 + step),
                    _kernel("k_c", t0 + 120, 10.0, 30 + step)]
        attr = attribute(_write(tmp_path, evs), launch_map=lmap)
        assert (attr.graph_steps, attr.graph_placed, attr.graph_mismatched) == ([3, 3], 6, 0)
        assert attr.by_line[ScopeRef(3, "mul", "B")] == 20.0

    def test_a_kernel_the_map_cannot_place_is_unattributed_and_named(self, tmp_path):
        """The replay launched a kernel the eager run did not, in place of
        one it did: a step of the map's length whose names differ anywhere
        is placed nowhere, each kernel named, and counted as differing."""
        lmap = [("k_a", "L7.add#P"), ("k_x", "L9.div#P"), ("k_b", "L8.mul#P")]
        evs = _graph_step(0, 0.0, 9, [("k_a", 20.0), ("k_b", 30.0), ("k_y", 7.0)])
        attr = attribute(_write(tmp_path, evs), launch_map=lmap)
        assert not attr.by_line
        assert attr.unattributed == {"k_a": 20.0, "k_b": 30.0, "k_y": 7.0}
        assert (attr.graph_ops, attr.graph_placed, attr.graph_mismatched) == (3, 0, 1)

    # Three repeated layers of four kernels, two of them of one name:
    # (name, line) with the layer's own line indices.
    LAYERS = [(name, f"L{10 * layer + j}.{sym}#P") for layer in range(3)
              for j, (name, sym) in enumerate([("k_norm", "rms"), ("k_mm", "linear"), ("k_mm", "linear"),
                                               ("k_act", "silu")])]

    @pytest.mark.parametrize("lost, lost_from_map, placed", [
        ((), (), 12),  # the step matches the map: every kernel placed
        ((4,), (), 11),  # layer 1's norm lost mid-sequence: each side of it placed
        ((5,), (), 10),  # one of layer 1's two k_mm lost: which one is not known
        ((0, 1), (), 10),  # the step's first records lost
        ((0, 11), (), 0),  # two runs lost: nothing placed
        ((), (0, 1), 10),  # the map's first records lost: the step's first two kernels unplaced
        ((2,), (2,), 11),  # the same record lost from both: a whole match
    ], ids=["whole", "mid", "ambiguous", "start", "two_runs", "map_start", "both"])
    def test_a_step_is_placed_by_position_with_every_name_checked(self, lost, lost_from_map, placed):
        """A kernel lost from the replay's records in the middle of repeated
        layers: the alignment never charges a kernel to another layer's line
        (a fuzzy match of identical layers would), and places only the
        kernels whose position in the map is certain."""
        truth = [kv for i, kv in enumerate(self.LAYERS) if i not in lost]
        lmap = [kv for i, kv in enumerate(self.LAYERS) if i not in lost_from_map]
        got = tattr.align_to_map([n for n, _ in truth], [n for n, _ in lmap], [parse_scope(s) for _, s in lmap])
        assert len(got) == placed
        assert all(ref.label == truth[i][1] for i, ref in got.items())

    def test_a_mid_sequence_loss_in_a_replayed_step(self, tmp_path):
        """An ambiguous loss through ``attribute``: the placed kernels on
        their own lines, the unplaced one named, the step counted as
        differing."""
        truth = [kv for i, kv in enumerate(self.LAYERS) if i != 5]
        evs = _graph_step(0, 0.0, 9, [(n, 10.0) for n, _ in truth])
        attr = attribute(_write(tmp_path, evs), launch_map=self.LAYERS)
        assert (attr.graph_ops, attr.graph_placed, attr.graph_mismatched) == (11, 10, 1)
        assert attr.unattributed == {"k_mm": 10.0}
        # Layer 1's k_mm left is one of its two lines, not known which.
        assert {r.label for r in attr.by_line} == {s for i, (_, s) in enumerate(self.LAYERS) if i not in (5, 6)}

    def test_eager_and_graph_kernels_in_one_trace(self, tmp_path):
        lmap = [("k_a", "L7.add#P")]
        evs = _eager_events() + _graph_step(1, 2000.0, 20, [("k_a", 25.0)])
        attr = attribute(_write(tmp_path, evs), launch_map=lmap)
        assert attr.by_line[ScopeRef(7, "add", "P")] == 25.0
        assert attr.by_line[ScopeRef(5, "sdpa_fwd_res", "Delete_Last_Used")] == 300.0

    def test_cpu_ops_charged_self_time(self, tmp_path):
        """No kernel events: host ops' self time, each op charged to the
        innermost range holding its start; a wrapper op holding a 90 us
        child contributes its own 10 us."""
        evs = [
            _range("L0.matmul#P", 0.0, 200.0),
            dict(ph="X", cat="cpu_op", name="aten::matmul", ts=1.0, dur=100.0, args={}, **HOST),
            dict(ph="X", cat="cpu_op", name="aten::mm", ts=5.0, dur=90.0, args={}, **HOST),
            dict(ph="X", cat="cpu_op", name="aten::copy_", ts=300.0, dur=7.0, args={}, **HOST),
        ]
        attr = attribute(_write(tmp_path, evs))
        assert attr.mode == "cpu" and attr.device_busy_us == pytest.approx(107.0)
        assert attr.by_line[ScopeRef(0, "matmul", "P")] == pytest.approx(100.0)
        assert attr.line_ops(ScopeRef(0, "matmul", "P")) == {"aten::matmul": [10.0, 1], "aten::mm": [90.0, 1]}
        assert attr.unattributed == {"aten::copy_": pytest.approx(7.0)}

    def test_gzipped_trace_and_directory(self, tmp_path):
        import gzip

        d = tmp_path / "prof"
        d.mkdir()
        with gzip.open(d / "x.trace.json.gz", "wt") as f:
            json.dump({"traceEvents": _eager_events()}, f)
        assert attribute(str(d)).device_busy_us == pytest.approx(370.0)
        with pytest.raises(FileNotFoundError):
            attribute(str(tmp_path / "empty"))


# =============================================================================
# A live torch.profiler run on the CPU
# =============================================================================


class TestLiveProfile:
    def test_live_cpu_profile_covers_the_traces_lines(self, tmp_path, monkeypatch):
        monkeypatch.setenv("THUNDER_ANNOTATE_TRACES", "1")
        jf = tt.jit(lambda x, w: tclang.sum(tclang.tanh(tclang.matmul(x, w))), device="cpu")
        x = torch.ones(128, 128)
        res = tt.profile(jf, x, x, trace_dir=str(tmp_path / "prof"), steps=2, warmup=1)
        attr = res["attribution"]
        assert attr is not None and attr.mode == "cpu"
        final = tt.last_traces(jf)[-1]
        lines = {(i, b.sym.name) for i, b in enumerate(final.bound_symbols)
                 if b.flat_proxy_outs and b.sym.name != "python_return"}
        assert {(r.line, r.sym) for r in attr.by_line} == lines
        assert all(r.pass_name == "Delete_Last_Used" for r in attr.by_line)
        assert all(attr.counts[r] >= 2 for r in attr.by_line)  # every step's op
        assert attr.coverage > 0.5

    def test_profile_without_annotation_attributes_nothing(self, tmp_path):
        jf = tt.jit(lambda x: tclang.sum(tclang.tanh(x)), device="cpu")
        res = tt.profile(jf, torch.ones(16, 16), trace_dir=str(tmp_path / "p"), steps=1, warmup=1)
        assert res["attribution"] is None

    def test_monitor_attribution_report_joins_the_live_profile(self, tmp_path, monkeypatch):
        monkeypatch.setenv("THUNDER_TPU_ANNOTATE_TRACES", "1")
        jf = tt.jit(lambda x, w: tclang.sum(tclang.tanh(tclang.matmul(x, w))), device="cpu")
        x = torch.ones(64, 64)
        res = tt.profile(jf, x, x, trace_dir=str(tmp_path / "prof"), steps=3, warmup=1)
        rep = tmonitor.attribution_report(res["trace_dir"], jfn=jf, device="h100", steps=3)
        mm = next(r for r in rep.rows if r.sym == "matmul")
        assert mm.roofline_us > 0 and mm.bound and mm.flops == 2 * 64 ** 3
        assert rep.measured_step_us == pytest.approx(res["attribution"].device_busy_us / 3)
        assert "perf attribution" in rep.format() and "L" in rep.format()


# =============================================================================
# Cost × measured join
# =============================================================================


class TestJoin:
    def test_join_matches_lines_and_scales_steps(self):
        join, mm, cost = _matmul_join(300.0, steps=3)
        assert join.measured_step_us == pytest.approx(100.0)
        row = join.rows[0]
        assert row.measured_us == pytest.approx(100.0) and row.bound == mm.bound
        assert row.roofline_us == pytest.approx(mm.roofline_s * 1e6)
        assert 0 < row.efficiency <= 1.0
        assert join.mfu == pytest.approx(cost.total_flops / (100e-6 * cost.device.peak_flops["bf16"]))
        assert "perf attribution" in join.format()

    def test_join_keyed_by_trace_tag(self):
        """A split step's two traces: each scope looks up its own trace's
        cost rows by the tag in front of its pass."""
        from thunder_tpu_torch.benchmarks.train import build_train
        from thunder_tpu_torch.models import gpt

        tr = build_train(gpt.name_to_config("llama-tiny"), 1, 8, device="cpu")
        costs = trace_costs([tr.fw_trace, tr.bw_trace], "h100")
        assert set(costs) == {"augmented_forward_Delete_Last_Used", "backward_Delete_Last_Used"}
        fw_rope = next(r for r in costs["augmented_forward_Delete_Last_Used"].rows if r.sym == "apply_rope")
        bw_row = next(r for r in costs["backward_Delete_Last_Used"].rows if r.index == fw_rope.index)
        refs = {ScopeRef(fw_rope.index, fw_rope.sym, "augmented_forward_Delete_Last_Used"): 10.0,
                ScopeRef(bw_row.index, bw_row.sym, "backward_Delete_Last_Used"): 20.0}
        join = join_cost_attribution(Attribution(by_line=refs, device_busy_us=30.0), costs)
        by = {r.label: r for r in join.rows}
        assert by[f"L{fw_rope.index}.apply_rope#augmented_forward_Delete_Last_Used"].roofline_us == \
            pytest.approx(fw_rope.roofline_s * 1e6)
        assert by[f"L{bw_row.index}.{bw_row.sym}#backward_Delete_Last_Used"].roofline_us == \
            pytest.approx(bw_row.roofline_s * 1e6)

    def test_padding_waste_on_the_join(self):
        tmonitor.enable()
        tmetrics.PADDING_WASTE_ELEMENTS.inc(8)
        join, _, _ = _matmul_join()
        assert join.padding_waste_elements == 8.0 and "padding waste" in join.format()

    def test_joined_row_carries_cost_bytes(self):
        join, mm, _ = _matmul_join()
        row = join.rows[0]
        assert row.bytes_moved == pytest.approx(mm.bytes_moved) and row.bytes_moved > 0
        assert row.flops == pytest.approx(mm.flops) and 0 < row.efficiency <= 1.0


# =============================================================================
# The roofline ledger, the drift band and the sampler
# =============================================================================


def _fake_join(rows):
    return types.SimpleNamespace(rows=rows)


def _fake_row(label, sym="matmul", line=3, measured_us=100.0, share=0.5, roofline_us=40.0, flops=1e6,
              bytes_moved=2e4, bound="operations"):
    eff = min(1.0, roofline_us / measured_us) if roofline_us else None
    return types.SimpleNamespace(label=label, sym=sym, line=line, pass_name="p", measured_us=measured_us,
                                 share=share, roofline_us=roofline_us, efficiency=eff, bound=bound, flops=flops,
                                 bytes_moved=bytes_moved)


class TestLedger:
    def test_fold_real_join_row_schema(self):
        join, mm, _ = _matmul_join()
        ledger = RooflineLedger()
        touched = ledger.fold(join, executor_by_sym={mm.sym: "torch"})
        assert len(touched) == 1 and ledger.folds == 1
        snap = ledger.snapshot()
        row = snap["rows"][0]
        assert set(row) == set(ROW_FIELDS) and snap["schema"] == list(ROW_FIELDS)
        assert row["measured_us"] == pytest.approx(300.0) and row["bytes"] == pytest.approx(mm.bytes_moved)
        assert row["roofline_us"] == pytest.approx(mm.roofline_s * 1e6, rel=1e-3)
        assert row["bound"] == mm.bound and row["executor"] == "torch" and 0 < row["achieved_frac"] <= 1.0

    def test_row_fields_are_the_jax_packages(self):
        from thunder_tpu.observability.roofline import ROW_FIELDS as JROW

        assert ROW_FIELDS == JROW

    def test_rows_sorted_and_samples_accumulate(self):
        ledger = RooflineLedger()
        ledger.fold(_fake_join([_fake_row("a", measured_us=10.0), _fake_row("b", measured_us=90.0)]))
        ledger.fold(_fake_join([_fake_row("a", measured_us=12.0)]))
        rows = ledger.rows()
        assert [e.label for e in rows] == ["b", "a"]
        by = {e.label: e for e in rows}
        assert by["a"].samples == 2 and by["b"].samples == 1 and by["a"].measured_us == pytest.approx(12.0)

    def test_bounded_eviction_drops_cheapest(self):
        ledger = RooflineLedger(max_ops=3)
        ledger.fold(_fake_join([_fake_row(f"op{i}", measured_us=float(i + 1)) for i in range(5)]))
        assert {e.label for e in ledger.rows()} == {"op4", "op3", "op2"} and len(ledger) == 3

    def test_trend_classification(self):
        ledger = RooflineLedger()
        for label, effs in (("up", (0.2, 0.2, 0.2, 0.6, 0.6, 0.6)), ("down", (0.6, 0.6, 0.6, 0.2, 0.2, 0.2)),
                            ("steady", (0.4, 0.41, 0.4, 0.41, 0.4, 0.41))):
            for eff in effs:
                ledger.fold(_fake_join([_fake_row(label, measured_us=100.0, roofline_us=eff * 100.0)]))
        by = {e.label: e for e in ledger.rows()}
        assert (by["up"].trend, by["down"].trend, by["steady"].trend) == ("improving", "degrading", "flat")
        ledger.fold(_fake_join([_fake_row("young")]))
        assert {e.label: e for e in ledger.rows()}["young"].trend == "flat"

    def test_format_table(self):
        ledger = RooflineLedger()
        ledger.fold(_fake_join([_fake_row("L3.matmul#p")]))
        out = ledger.format()
        assert "roofline ledger: 1 op(s)" in out and "L3.matmul#p" in out and "operations" in out


class TestBandDetector:
    @BOTH_DETECT
    def test_two_sided_trip_and_cooldown(self, D):
        det = D.BandDetector(factor=1.5, consecutive=2, min_samples=3, cooldown=4)
        for _ in range(5):
            assert det.update(1.0) is None
        assert det.update(3.0) is None
        hit = det.update(3.0)
        assert hit is not None and hit["ratio"] == pytest.approx(3.0, rel=0.05)
        for _ in range(4):
            assert det.update(3.0) is None
        assert det.update(3.0) is None and det.update(3.0) is not None
        low = D.BandDetector(factor=1.5, consecutive=2, min_samples=3)
        for _ in range(5):
            low.update(1.0)
        low.update(0.2)
        assert low.update(0.2) is not None

    @BOTH_DETECT
    def test_bank_note_roofline_op_fake_clock(self, D, monkeypatch):
        now = [1000.0]
        monkeypatch.setattr(D.time, "time", lambda: now[0])
        bank = D.DetectorBank(D.DetectorConfig())
        for _ in range(3):
            bank.note_roofline_op("L3.matmul#p", 100.0, 100.0)
        now[0] = 1010.0
        bank.note_roofline_op("L3.matmul#p", 800.0, 100.0)
        bank.note_roofline_op("L3.matmul#p", 800.0, 100.0)
        assert len(bank.anomalies) == 1
        a = bank.anomalies[0]
        assert (a.kind, a.fn, a.severity) == ("cost_model_drift", "L3.matmul#p", "critical")
        assert a.ts == pytest.approx(1010.0)
        for _ in range(bank.config.cooldown):
            bank.note_roofline_op("L3.matmul#p", 800.0, 100.0)
        assert len(bank.anomalies) == 1 and bank.debug_state()["roofline_streams"] == 1

    @BOTH_DETECT
    def test_executor_claimed_op_is_kernel_regression(self, D, monkeypatch):
        monkeypatch.setattr(D.time, "time", lambda: 5.0)
        bank = D.DetectorBank(D.DetectorConfig())
        for _ in range(3):
            bank.note_roofline_op("L7.sdpa#p", 50.0, 50.0, executor="flash")
        bank.note_roofline_op("L7.sdpa#p", 400.0, 50.0, executor="flash")
        bank.note_roofline_op("L7.sdpa#p", 400.0, 50.0, executor="flash")
        assert [a.kind for a in bank.anomalies] == ["kernel_regression"]

    @BOTH_DETECT
    def test_step_time_drift_and_recompile_storm_on_the_same_stream(self, D, monkeypatch):
        """The bank fed one stream of records raises the same anomalies in
        both packages (step-time drift, then a recompile storm)."""
        monkeypatch.setattr(D.time, "time", lambda: 50.0)
        bank = D.DetectorBank(D.DetectorConfig())
        for s in [0.1] * 12 + [0.5] * 6:
            bank.consume("step_time", {"fn": "step", "step": 0, "s": s, "host": 0})
        for _ in range(4):
            bank.consume("compile_end", {"recompile": True})
        kinds = [a.kind for a in bank.anomalies]
        assert "step_time_drift" in kinds and kinds[-1] == "recompile_storm"

    def test_anomaly_counted_and_logged(self, tmp_path):
        from thunder_tpu_torch.observability import events as tevents

        tmonitor.enable()
        log = str(tmp_path / "a.jsonl")
        tevents.set_global_path(log)
        try:
            bank = tdetect.DetectorBank(tdetect.DetectorConfig())
            for _ in range(4):
                bank.consume("compile_end", {"recompile": True})
        finally:
            tevents.set_global_path(None)
        assert tmetrics.ANOMALIES.value(kind="recompile_storm") == 1
        recs = [json.loads(line) for line in open(log)]
        assert [r["anomaly"] for r in recs if r["kind"] == "anomaly"] == ["recompile_storm"]

    @BOTH_DETECT
    def test_host_health_accumulator(self, D):
        acc = D.HostHealthAccumulator()
        for h, s in ((0, 1.0), (1, 1.0), (2, 3.0), (0, 1.0)):
            acc.add(h, s)
        assert acc.spread() == (1.0, 3.0) and acc.host_stats()[0]["steps"] == 2


def _synthetic_trace(trace_dir, rows):
    """One step of host ops, each in its scope's range, as a CPU profile."""
    events, ts = [], 0.0
    for name, dur in rows:
        events.append(_range(name, ts, dur + 2))
        events.append(dict(ph="X", cat="cpu_op", name="aten::op", ts=ts + 1, dur=dur, args={}, **HOST))
        ts += dur + 4
    path = os.path.join(trace_dir, "host.trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


class TestSampler:
    def test_duty_cycle_counts(self, monkeypatch):
        probed = []
        sampler = RooflineSampler(every=3)
        monkeypatch.setattr(sampler, "sample", lambda fn, *a, **k: probed.append(1) or fn(*a, **k))
        calls = []
        out = None
        for i in range(9):
            out = sampler.maybe_sample(lambda i=i: calls.append(i) or i)
        assert len(calls) == 9 and out == 8 and len(probed) == 3

    def test_off_by_default_and_env_arming(self, monkeypatch):
        monkeypatch.delenv("THUNDER_TPU_ROOFLINE_EVERY", raising=False)
        off = RooflineSampler()
        assert off.every == 0 and not off.enabled
        for _ in range(5):
            off.maybe_sample(lambda: 1)
        assert off.probes == 0 and not off.tick()
        monkeypatch.setenv("THUNDER_TPU_ROOFLINE_EVERY", "5")
        assert RooflineSampler().every == 5
        monkeypatch.setenv("THUNDER_TPU_ROOFLINE_EVERY", "bogus")
        assert RooflineSampler().every == 0

    def test_probe_pipeline_on_synthetic_fixture(self, monkeypatch):
        """A probe against a synthetic trace: the profile bracket stubbed to
        drop a pre-built trace, the cost half a real ``trace_cost`` of the
        trace the scope names; the bank, when given one, gets the ratio."""
        import thunder_tpu_torch.observability.profile as profile_mod

        a = torch.ones(64, 64)
        extrace = _extrace(lambda a, b: tclang.sum(tclang.tanh(tclang.matmul(a, b))), a, a)
        cost = trace_cost(extrace, "h100")
        mm = [r for r in cost.rows if r.kind == "matmul"][0]
        scope = f"L{mm.index}.{mm.sym}#Transform_for_execution"

        def fake_profile(fn, *args, trace_dir=None, launch_map=None, **kwargs):
            fn(*args)
            _synthetic_trace(trace_dir, [(scope, 120.0)])
            return {"trace_dir": trace_dir, "steps": 1, "total_s": 1e-4, "avg_s": 1e-4, "profiler": True,
                    "attribution": attribute(trace_dir)}

        monkeypatch.setattr(profile_mod, "profile", fake_profile)
        bank = tdetect.DetectorBank(tdetect.DetectorConfig())
        sampler = RooflineSampler(every=1, bank=bank)
        sampler._cost = {"Transform_for_execution": cost}
        sampler._executor_by_sym = {mm.sym: "torch"}
        sampler._resolved = True
        assert sampler.maybe_sample(lambda: "step-out") == "step-out"
        assert sampler.probes == 1 and tmetrics.ROOFLINE_PROBES.value() == 1
        entry = sampler.ledger.rows()[0]
        assert (entry.sym, entry.line, entry.executor) == (mm.sym, mm.index, "torch")
        assert entry.measured_us == pytest.approx(120.0)
        assert entry.roofline_us == pytest.approx(mm.roofline_s * 1e6, rel=1e-3)
        assert entry.bytes == pytest.approx(mm.bytes_moved)
        assert sampler.last_coverage == pytest.approx(1.0)
        assert bank.debug_state()["roofline_streams"] == 1
        state = sampler.debug_state()
        assert state["enabled"] and state["probes"] == 1 and state["ledger"]["ops"] == 1

    def test_sampled_training_matches_unsampled(self, monkeypatch):
        """The sampler runs no step the caller did not ask for: with
        ``eager=Train.step_eager`` (the first probe runs it in place of the
        step, to take the launch-order map) the losses of four sampled steps
        and the params after them are those of four unsampled steps, bit
        for bit."""
        from thunder_tpu_torch.benchmarks.train import build_train
        from thunder_tpu_torch.models import gpt

        monkeypatch.setenv("THUNDER_ANNOTATE_TRACES", "1")
        cfg = gpt.name_to_config("llama-tiny")
        plain, sampled = (build_train(cfg, 1, 8, device="cpu", seed=0) for _ in range(2))
        want = [plain.step() for _ in range(4)]
        sampler = RooflineSampler(every=2, traces=[sampled.fw_trace, sampled.bw_trace], eager=sampled.step_eager,
                                  device="h100")
        got = [sampler.maybe_sample(sampled.step) for _ in range(4)]
        assert sampler.probes == 2 and sampler.ledger.rows()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(sampled.flat_params, plain.flat_params))

    def test_sampled_random_program_draws_as_unsampled(self, monkeypatch):
        """A program with random draws takes the next key at each call: the
        outputs and the RNG counter after four sampled calls are those after
        four unsampled ones."""
        import torch.nn.functional as F

        from thunder_tpu_torch import api

        monkeypatch.setenv("THUNDER_ANNOTATE_TRACES", "1")
        x = torch.ones(16, 16)
        plain = tt.jit(lambda x: F.dropout(x, 0.5), device="cpu")
        sampled = tt.jit(lambda x: F.dropout(x, 0.5), device="cpu")
        monkeypatch.setitem(api._global_rng, "seed", 3)
        want = [plain(x) for _ in range(4)]
        counter = api._global_rng["seed"]
        api._global_rng["seed"] = 3
        sampler = RooflineSampler(sampled, every=2, device="h100")
        got = [sampler.maybe_sample(sampled, x) for _ in range(4)]
        assert sampler.probes == 2 and api._global_rng["seed"] == counter
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    def test_live_probe_of_a_jit_function(self, monkeypatch, tmp_path):
        """A real probe on the CPU: a jit function built under annotation,
        its cost resolved from its last trace, the ledger filled with its
        lines, the report printable through the monitor facade."""
        monkeypatch.setenv("THUNDER_ANNOTATE_TRACES", "1")
        jf = tt.jit(lambda x, w: tclang.sum(tclang.tanh(tclang.matmul(x, w))), device="cpu")
        x = torch.ones(64, 64)
        jf(x, x)
        sampler = tmonitor.roofline(jf, every=2, device="h100")
        try:
            for _ in range(4):
                sampler.maybe_sample(jf, x, x)
            assert sampler.probes == 2
            syms = {e.sym for e in sampler.ledger.rows()}
            assert "matmul" in syms
            mm = next(e for e in sampler.ledger.rows() if e.sym == "matmul")
            assert mm.roofline_us > 0 and mm.samples == 2 and mm.executor == "torch"
            assert "roofline ledger" in tmonitor.roofline_report()
        finally:
            tmonitor.shutdown_roofline()
        assert tmonitor.roofline_report() is None
