"""The compiled-program auditor (``analysis/hlo_audit.py``) through both packages, on the CPU.

The JAX package audits compiled HLO text; the port has no HLO and audits
(a) a staged entry's CUDA graph, the DOT text of ``CUDAGraph.debug_dump``,
and (b) the profiler's op record of one eager call. Written once and run
through both packages where the JAX side has the case:

- ``TestHloOpCost``' 7 cases (``tests/test_hlo_audit.py:197-253``): the same
  duck-typed ops priced by both packages' ``cost.hlo_op_cost`` give equal
  operations, memory bytes and wire bytes;
- ``TestHloRules``' 7 cases (``:379-451``): seeded reports put in a trace's
  tags give the same ``hlo.*`` rule ids and severities through each
  package's verifier; ``to_json`` round-trips and ``format`` runs;
- ``test_examine_hlo_report``, ``test_audit_jitted_rejects_non_jitted``;
- a planted host read: ``hlo.host-transfer-in-step`` fires in both audits
  (the port's: an ``.item()`` in the program, read in the op record; the
  JAX package cannot compile a program with ``.item()``, so its host
  transfer is an ``outfeed`` planted in the compiled text of the same
  function's device part);
- the static wire split of the fleet timeline takes each audit's sites.

The port alone: reader (a) on an excerpt of a real dump pasted below (taken
on an NVIDIA H100 80GB HBM3 by ``chip_smoke.py`` phase 27 (c)): node counts
by kind, edges, memcpy directions and bytes, the line join of a capture's
marks; reader (b) on a live CPU run of gpt-tiny's ``value_and_grad``: every
matmul line priced, the priced operations equal to ``cost.trace_cost``
within 1e-6 relative, the layout copies equal to the record's copy ops; a
planted transposed-then-contiguous operand of 1 MiB fires
``hlo.layout-copy``; :func:`follow_lines` reports each line of a program
and of a program it calls.
"""

import json
import os
import re
import tempfile

import numpy as np
import pytest
import torch

import thunder_tpu as ttpu
import thunder_tpu.clang as jclang
from thunder_tpu.analysis import Severity as JSeverity
from thunder_tpu.analysis import hlo_audit as jaudit
from thunder_tpu.analysis import verify as jverify
from thunder_tpu.analysis.cost import HLO_COLLECTIVE_FACTORS as J_FACTORS
from thunder_tpu.analysis.cost import hlo_collective_wire_bytes as j_wire
from thunder_tpu.analysis.cost import hlo_op_cost as j_cost
from thunder_tpu.observability import timeline as jtimeline

import thunder_tpu_torch as tt
from thunder_tpu_torch.analysis import Severity as TSeverity
from thunder_tpu_torch.analysis import hlo_audit as taudit
from thunder_tpu_torch.analysis import verify as tverify
from thunder_tpu_torch.analysis.cost import HLO_COLLECTIVE_FACTORS as T_FACTORS
from thunder_tpu_torch.analysis.cost import hlo_collective_wire_bytes as t_wire
from thunder_tpu_torch.analysis.cost import hlo_op_cost as t_cost
from thunder_tpu_torch.analysis.cost import trace_cost
from thunder_tpu_torch.examine import hlo_report
from thunder_tpu_torch.observability import timeline as ttimeline
from thunder_tpu_torch.observability.profile import traced

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hlo_fsdp_tp_small.txt")
PKGS = pytest.mark.parametrize("pkg", ["jax", "port"])


# =============================================================================
# Pricing: the JAX package's HLO-op rules in both packages
# =============================================================================


def _op(pkg, opcode, *, result_numel=1, result_bytes=4.0, operand_numel=0, operand_bytes=0.0, group_size=1,
        k_dim=0, family=None):
    mod = jaudit if pkg == "jax" else taudit
    return mod.HloOp(name="t", opcode=opcode, result_type="f32[]", shapes=(), operands=(), index=0,
                     result_numel=result_numel, result_bytes=result_bytes, operand_numel=operand_numel,
                     operand_bytes=operand_bytes, group_size=group_size, k_dim=k_dim, family=family)


def _priced(pkg, *args, inner_flops=0.0, **kw):
    """The cost of one op in ``pkg``, held equal to the JAX package's."""
    cost = (j_cost if pkg == "jax" else t_cost)(_op(pkg, *args, **kw), inner_flops=inner_flops)
    want = j_cost(_op("jax", *args, **kw), inner_flops=inner_flops)
    if want is None:
        assert cost is None
        return None
    assert (cost.flops, cost.bytes_moved, cost.comm_bytes, cost.kind) == (
        want.flops, want.bytes_moved, want.comm_bytes, want.kind)
    return cost


@PKGS
class TestHloOpCost:
    def test_dot(self, pkg):
        c = _priced(pkg, "dot", result_numel=8 * 32, result_bytes=8 * 32 * 4.0,
                    operand_bytes=(8 * 16 + 16 * 32) * 4.0, k_dim=16)
        assert c.flops == pytest.approx(2.0 * 8 * 32 * 16)
        assert c.kind == "matmul"

    def test_collective_factors(self, pkg):
        factors, wire = (J_FACTORS, j_wire) if pkg == "jax" else (T_FACTORS, t_wire)
        assert set(factors) == set(J_FACTORS)
        n = 1024.0
        for fam, factor_fn in J_FACTORS.items():
            assert wire(fam, n, 4) == pytest.approx(n * factor_fn(4)) == pytest.approx(j_wire(fam, n, 4))
        assert wire("all-gather", n, 4) == pytest.approx(n * 0.75)
        assert wire("all-reduce", n, 4) == pytest.approx(n * 1.5)
        assert wire("collective-permute", n, 4) == pytest.approx(n)
        assert wire("not-a-collective", n, 4) == 0.0
        assert wire("all-gather", n, 1) == pytest.approx(n)

    def test_done_half_is_free(self, pkg):
        assert _priced(pkg, "all-gather-done", family="all-gather") is None

    def test_start_carries_wire(self, pkg):
        c = _priced(pkg, "all-gather-start", result_bytes=4096.0, group_size=4, family="all-gather")
        assert c.kind == "collective"
        assert c.comm_bytes == pytest.approx(4096.0 * 0.75)

    def test_native_reduce_scatter_prices_operand(self, pkg):
        c = _priced(pkg, "reduce-scatter", result_bytes=1024.0, operand_bytes=4096.0, group_size=4,
                    family="reduce-scatter")
        assert c.comm_bytes == pytest.approx(4096.0 * 0.75)

    def test_free_and_move_and_reduce(self, pkg):
        assert _priced(pkg, "parameter") is None
        assert _priced(pkg, "bitcast") is None
        copy = _priced(pkg, "copy", result_bytes=64.0, operand_bytes=64.0)
        assert copy.kind == "layout" and copy.bytes_moved == pytest.approx(128.0)
        red = _priced(pkg, "reduce", result_numel=1, operand_numel=64, operand_bytes=256.0)
        assert red.kind == "reduction" and red.flops == pytest.approx(64.0)

    def test_fusion_carries_inner_flops(self, pkg):
        c = _priced(pkg, "fusion", result_bytes=128.0, operand_bytes=256.0, inner_flops=1000.0)
        assert c.kind == "fusion"
        assert c.flops == pytest.approx(1000.0)
        assert c.bytes_moved == pytest.approx(384.0)


# =============================================================================
# The hlo.* rules on seeded reports, through each package's verifier
# =============================================================================


def _seeded_report(pkg, **overrides):
    mod = jaudit if pkg == "jax" else taudit
    rep = mod.HloScheduleReport(module="seeded", device="cpu", n_ops=10, n_computations=1)
    for k, v in overrides.items():
        setattr(rep, k, v)
    return rep


def _exposed_site(pkg, wire_us=50.0, hidden_us=0.0):
    mod = jaudit if pkg == "jax" else taudit
    return mod.HloCollectiveSite(name="all-gather.1", opcode="all-gather", family="all-gather", computation="main",
                                 index=3, group_size=4, wire_bytes=1 << 20, wire_us=wire_us, window_us=hidden_us,
                                 hidden_us=hidden_us)


def _program_trace(pkg):
    if pkg == "jax":
        jf = ttpu.jit(lambda a: jclang.sum(jclang.mul(a, a)), executors=["jax"])
        jf(np.ones((2, 2), np.float32))
    else:
        jf = tt.jit(lambda a: (a * a).sum(), device="cpu")
        jf(torch.ones(2, 2))
    return jf._lc_cs.cache_entries[0].computation_traces[-1]


def _verify_with_report(pkg, rep):
    trace = _program_trace(pkg)
    trace.tags["hlo_audit"] = rep
    try:
        return (jverify if pkg == "jax" else tverify)(trace)
    finally:
        trace.tags.pop("hlo_audit", None)


def _hlo(diags) -> list:
    return sorted((d.rule, int(d.severity)) for d in diags if d.rule.startswith("hlo."))


@PKGS
class TestHloRules:
    def test_exposed_collective_fires(self, pkg):
        diags = _verify_with_report(pkg, _seeded_report(pkg, sites=[_exposed_site(pkg)]))
        hits = [d for d in diags if d.rule == "hlo.exposed-collective"]
        assert len(hits) == 1 and int(hits[0].severity) == int(JSeverity.INFO)
        assert "inserted" in hits[0].message

    def test_exposed_collective_quiet_when_hidden(self, pkg):
        diags = _verify_with_report(pkg, _seeded_report(pkg, sites=[_exposed_site(pkg, 50.0, 50.0)]))
        assert not [d for d in diags if d.rule == "hlo.exposed-collective"]

    def test_layout_copy_fires_above_floor(self, pkg):
        diags = _verify_with_report(pkg, _seeded_report(pkg, layout_copies=3, layout_copy_bytes=float(2 << 20)))
        assert _hlo(diags) == [("hlo.layout-copy", int(JSeverity.INFO))]
        quiet = _verify_with_report(pkg, _seeded_report(pkg, layout_copies=3, layout_copy_bytes=1024.0))
        assert not _hlo(quiet)

    def test_padding_waste_fires_above_quarter(self, pkg):
        diags = _verify_with_report(pkg, _seeded_report(pkg, pad_fractions={"leaf0.dim0": 0.5, "leaf0.dim1": 0.1}))
        hits = [d for d in diags if d.rule == "hlo.padding-waste"]
        assert len(hits) == 1 and int(hits[0].severity) == int(JSeverity.WARNING)
        assert "leaf0.dim0" in hits[0].message

    def test_host_transfer_fires(self, pkg):
        diags = _verify_with_report(pkg, _seeded_report(pkg, host_transfers=2,
                                                        host_transfer_ops=["outfeed.1", "send.2"]))
        assert _hlo(diags) == [("hlo.host-transfer-in-step", int(JSeverity.WARNING))]

    def test_rules_advisory_only(self, pkg):
        rep = _seeded_report(pkg, sites=[_exposed_site(pkg)], layout_copies=5, layout_copy_bytes=float(8 << 20),
                             pad_fractions={"leaf0.dim0": 0.9}, host_transfers=3, host_transfer_ops=["outfeed.1"])
        diags = _hlo(_verify_with_report(pkg, rep))
        assert len(diags) >= 4 and all(sev < int(JSeverity.ERROR) for _, sev in diags)
        other = "port" if pkg == "jax" else "jax"
        twin = _seeded_report(other, sites=[_exposed_site(other)], layout_copies=5, layout_copy_bytes=float(8 << 20),
                              pad_fractions={"leaf0.dim0": 0.9}, host_transfers=3, host_transfer_ops=["outfeed.1"])
        assert diags == _hlo(_verify_with_report(other, twin))

    def test_no_report_no_findings(self, pkg):
        trace = _program_trace(pkg)
        trace.tags.pop("hlo_audit", None)
        assert not _hlo((jverify if pkg == "jax" else tverify)(trace))


def test_severities_are_the_same_scale():
    assert [int(s) for s in (TSeverity.INFO, TSeverity.WARNING, TSeverity.ERROR)] == [
        int(s) for s in (JSeverity.INFO, JSeverity.WARNING, JSeverity.ERROR)]


# =============================================================================
# Reader (a): a CUDA graph's DOT dump, an excerpt of a real one
# =============================================================================

# chip_smoke.py phase 27 (c) on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128,
# CUDA 12.8): the staged probe's graph, whole. Two elementwise kernels, a
# cuBLAS product (two kernels), a memcpy from the device to the device, a
# copy kernel (a transpose made contiguous), the copies to and from pinned
# host memory, a kernel on a side stream (its fork and join are edges, not
# nodes) and the port's rope kernel.
GRAPH_EXCERPT = r'''digraph dot {
subgraph cluster_10 {
label="graph_10" graph[style="dashed"];
"graph_10_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 9) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_13AUnaryFunctorIfffNS0_15binary_internal10MulFunctorIfEEEESt5arrayIPcLm2EEEEviT0_T1_\<\<\<64,128,0\>\>\>}
| {{node handle | func handle} | {0x000000001F100820 | 0x0000000009AE8190}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_10_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 8) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_21CUDAFunctorOnSelf_addIfEESt5arrayIPcLm2EEEEviT0_T1_\<\<\<64,128,0\>\>\>}
| {{node handle | func handle} | {0x000000001F100F88 | 0x000000000C221310}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_10_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 7) | sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas\<\<\<\{8,8,4\},64,6528\>\>\>}
| {{node handle | func handle} | {0x000000001F1016F0 | 0x0000000027F5E470}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_10_node_3"[style="bold" shape="record" label="{KERNEL
| {ID | 3 (topoId: 6) | sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_execute_split_k_kernel__5x_cublas\<\<\<\{8,8\},64,4608\>\>\>}
| {{node handle | func handle} | {0x000000001F101E58 | 0x0000000027F55CD0}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_10_node_4"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {4 (topoId: 5) | 0x000000001F1025C0}}
| {kind | DtoD (DEVICE to DEVICE)}
| {{srcPtr | dstPtr} | {pitch | ptr | xsize | ysize | pitch | ptr | xsize | ysize} | {0 | 0x00007FB547800000 | 0 | 0 | 0 | 0x00007FB547880000 | 0 | 0}}
| {{srcPos | {{x | 0} | {y | 0} | {z | 0}}} | {dstPos | {{x | 0} | {y | 0} | {z | 0}}} | {Extent | {{Width | 262144} | {Height | 1} | {Depth | 1}}}}
}"];

"graph_10_node_5"[style="bold" shape="record" label="{KERNEL
| {ID | 5 (topoId: 4) | _ZN2at6native18elementwise_kernelILi128ELi2EZNS0_22gpu_kernel_impl_nocastIZZZNS0_23direct_copy_kernel_cudaERNS_18TensorIteratorBaseEENKUlvE1_clEvENKUlvE5_clEvEUlfE_EEvS4_RKT_EUliE_EEviT1_\<\<\<256,128,0\>\>\>}
| {{node handle | func handle} | {0x000000001F102D28 | 0x000000000A4F16F0}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_10_node_6"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {6 (topoId: 3) | 0x000000001F103490}}
| {kind | DtoH (DEVICE to HOST PINNED)}
| {{srcPtr | dstPtr} | {pitch | ptr | xsize | ysize | pitch | ptr | xsize | ysize} | {0 | 0x00007FB547800000 | 0 | 0 | 0 | 0x00007FB547400200 | 0 | 0}}
| {{srcPos | {{x | 0} | {y | 0} | {z | 0}}} | {dstPos | {{x | 0} | {y | 0} | {z | 0}}} | {Extent | {{Width | 262144} | {Height | 1} | {Depth | 1}}}}
}"];

"graph_10_node_7"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {7 (topoId: 1) | 0x000000001F103BF8}}
| {kind | HtoD (HOST PINNED to DEVICE)}
| {{srcPtr | dstPtr} | {pitch | ptr | xsize | ysize | pitch | ptr | xsize | ysize} | {0 | 0x00007FB547440200 | 0 | 0 | 0 | 0x00007FB547900000 | 0 | 0}}
| {{srcPos | {{x | 0} | {y | 0} | {z | 0}}} | {dstPos | {{x | 0} | {y | 0} | {z | 0}}} | {Extent | {{Width | 256} | {Height | 1} | {Depth | 1}}}}
}"];

"graph_10_node_8"[style="bold" shape="record" label="{KERNEL
| {ID | 8 (topoId: 2) | _ZN2at6native29vectorized_elementwise_kernelILi4EZZZNS0_15sin_kernel_cudaERNS_18TensorIteratorBaseEENKUlvE0_clEvENKUlvE0_clEvEUlfE_St5arrayIPcLm2EEEEviT0_T1_\<\<\<64,128,0\>\>\>}
| {{node handle | func handle} | {0x000000001F104360 | 0x000000000F7A2980}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_10_node_9"[style="bold" shape="record" label="{KERNEL
| {ID | 9 (topoId: 0) | _ZN39_GLOBAL__N__68748a05_7_rope_cu_d3932e8b11rope_kernelI13__nv_bfloat16Li8ELi8ELb0EEEvPKT_S4_S4_PS2_iiixxxiiiiii\<\<\<\{1,2\},256,8192\>\>\>}
| {{node handle | func handle} | {0x000000001F104AC8 | 0x0000000012A3B530}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_10_node_0" -> "graph_10_node_1" [headlabel=0];
"graph_10_node_1" -> "graph_10_node_2" [headlabel=0];
"graph_10_node_2" -> "graph_10_node_3" [headlabel=0];
"graph_10_node_3" -> "graph_10_node_4" [headlabel=0];
"graph_10_node_4" -> "graph_10_node_5" [headlabel=0];
"graph_10_node_5" -> "graph_10_node_6" [headlabel=0];
"graph_10_node_6" -> "graph_10_node_7" [headlabel=0];
"graph_10_node_7" -> "graph_10_node_8" [headlabel=0];
"graph_10_node_7" -> "graph_10_node_9" [headlabel=0];
"graph_10_node_8" -> "graph_10_node_9" [headlabel=1];
}
}
'''


class TestGraphReader:
    def test_nodes_by_kind_and_edges(self):
        mod = taudit.parse_graph_dump(GRAPH_EXCERPT)
        (comp,) = mod.computations
        assert comp.name == "graph_10" and comp.is_entry
        kinds = [op.node for op in comp.ops]
        assert kinds.count("kernel") == 7 and kinds.count("memcpy") == 3 and len(kinds) == 10
        assert [op.operands for op in comp.ops] == [[], [0], [1], [2], [3], [4], [5], [6], [7], [7, 8]]
        memcpys = [(op.index, op.direction, op.nbytes) for op in comp.ops if op.node == "memcpy"]
        assert memcpys == [(4, "DtoD", 262144.0), (6, "DtoH", 262144.0), (7, "HtoD", 256.0)]
        gemm = comp.ops[2]
        assert gemm.name.startswith("sm80_xmma_gemm") and gemm.launch == "{8,8,4},64,6528"
        assert comp.ops[0].name.startswith("void at::native::vectorized_elementwise_kernel<4")
        assert taudit.port_kernel_of(comp.ops[9].name) == "rope_kernel" and comp.ops[9].launch == "{1,2},256,8192"
        # The side stream's kernel (8) forks from 7 and joins at 9: nothing
        # runs beside anything, and the reachability says so.
        anc, desc = taudit._reachability(comp)
        assert all(((anc[i] | desc[i]) >> j) & 1 for i in range(10) for j in range(10))

    def test_audit_classifies(self):
        rep = taudit.audit_hlo(GRAPH_EXCERPT, device="h100")
        assert (rep.n_ops, rep.matmuls, rep.host_transfers, rep.fusions) == (10, 2, 2, 1)
        assert rep.port_kernels == {"rope_kernel": 1} and sum(rep.kernels.values()) == 7
        # The DtoD memcpy and the copy kernel; only the memcpy's bytes are
        # known off every line.
        assert rep.layout_copies == 2 and rep.layout_copy_bytes == 2.0 * 262144
        assert sorted(op.split("/")[-1] for op in rep.host_transfer_ops) == ["memcpy DtoH", "memcpy HtoD"]
        # The kernels are on no line: named, never priced.
        assert rep.unpriced == 7 and not rep.sites and rep.single_stream
        assert _hlo(rep.diagnostics()) == [("hlo.host-transfer-in-step", 1)]
        js = rep.to_json()
        assert js["v"] == 1 and js["source"] == "graph" and json.loads(json.dumps(js)) == js
        assert "10 ops" in rep.format()

    def test_marks_place_nodes_on_lines(self):
        # A capture's marks: (node count as the line started, trace, line).
        jf = tt.jit(lambda a, b: torch.tanh(a @ b) + a, device="cpu")
        jf(torch.ones(16, 16), torch.ones(16, 16))
        trc = tt.last_traces(jf)[-1]
        mm = next(i for i, b in enumerate(trc.bound_symbols) if b.sym.name == "matmul")
        tanh = next(i for i, b in enumerate(trc.bound_symbols) if b.sym.name == "tanh")
        marks = [(0, None, None), (2, trc, mm), (4, trc, tanh), (5, None, None)]
        mod = taudit.parse_graph_dump(GRAPH_EXCERPT, marks=marks)
        scopes = [op.op_name for op in mod.entry.ops]
        assert scopes[:2] == ["", ""] and scopes[2:4] == [trc.scope_of(mm)] * 2 and scopes[4] == trc.scope_of(tanh)
        assert scopes[5:] == [""] * 5
        rep = taudit.audit_hlo(mod, device="h100")
        rows = {r.index: r for r in trace_cost(trc, "h100").rows}
        # The two lines' operations; the memcpys off them move bytes only.
        assert rep.flops == rows[mm].flops + rows[tanh].flops
        assert rep.lines_priced == 2 and mod.entry.ran_lines == [trc.scope_of(mm), trc.scope_of(tanh)]

    def test_garbage_raises(self):
        with pytest.raises(ValueError):
            taudit.parse_graph_dump("this is not a graph")
        with pytest.raises(ValueError):
            taudit.audit_hlo("digraph dot { }")

    def test_port_kernel_names(self):
        assert taudit.port_kernel_of("_Z16flash_fwd_kernelI13__nv_bfloat16Li128ELb0EEv11FlashParams") == \
            "flash_fwd_kernel"
        assert taudit.port_kernel_of("void norm_fwd_kernel_block<float>(float const*)") == "norm_fwd_kernel_block"
        assert taudit.port_kernel_of("_Z21norm_fwd_kernel_blockIfEvPKf") == "norm_fwd_kernel_block"
        assert taudit.port_kernel_of("ncclDevKernel_AllReduce_Sum_f32_RING_LL") is None


# =============================================================================
# Reader (b): the op record of a live CPU run
# =============================================================================


def _record(fn, *args):
    """One call of ``fn`` profiled with shapes; ``(events, module)``."""
    from thunder_tpu_torch.observability.attribution import load_trace_events

    scopes = taudit._ScopeRanges()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "r.trace.json")
        with traced(path, record_shapes=True):
            with taudit.follow_lines(scopes):
                out = fn(*args)
            scopes.close()
        events = load_trace_events(path)
    return out, events, taudit.ops_of_record(events, scopes.traces.values())


class TestRecordReader:
    @pytest.fixture(scope="class")
    def gpt_tiny(self):
        from thunder_tpu_torch.models import gpt

        cfg = gpt.name_to_config("gpt-tiny")
        os.environ["THUNDER_ANNOTATE_TRACES"] = "1"
        try:
            params = gpt.init_params(cfg, dtype=torch.float32, seed=0, device="cpu")
            rng = np.random.RandomState(0)
            idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)))
            tgt = torch.from_numpy(np.roll(idx.numpy(), -1, axis=1).copy())
            vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg), device="cpu")
            vg(params, idx, tgt)
            _, events, module = _record(vg, params, idx, tgt)
        finally:
            del os.environ["THUNDER_ANNOTATE_TRACES"]
        return vg, events, module

    def test_priced_flops_equal_trace_cost(self, gpt_tiny):
        vg, _, module = gpt_tiny
        trc = tt.last_traces(vg)[-1]
        rep = taudit.audit_hlo(module, device="cpu")
        want = trace_cost(trc, "cpu").total_flops
        assert want > 0 and rep.flops == pytest.approx(want, rel=1e-6)
        assert rep.source == "record" and rep.n_ops == len(module.entry.ops) > 0

    def test_every_matmul_line_is_priced(self, gpt_tiny):
        vg, _, module = gpt_tiny
        trc = tt.last_traces(vg)[-1]
        rows = {r.index: r for r in trace_cost(trc, "cpu").rows}
        mm_lines = {trc.scope_of(i) for i, r in rows.items() if r.kind == "matmul"}
        placed = {op.op_name for op in module.entry.ops}
        assert len(mm_lines) >= 8 and mm_lines <= placed
        rep = taudit.audit_hlo(module, device="cpu")
        assert rep.matmuls >= len(mm_lines) and rep.unpriced == 0

    def test_layout_copies_equal_the_records_copy_ops(self, gpt_tiny):
        _, events, module = gpt_tiny
        rep = taudit.audit_hlo(module, device="cpu")
        ops = [ev for ev in events if ev.get("cat") == "cpu_op"]
        products = [(ev["tid"], ev["ts"], ev["ts"] + ev["dur"]) for ev in ops if ev["name"] in ("aten::addmm", "aten::mm",
                                                                                               "aten::bmm")]
        lines = [(ev["tid"], ev["ts"], ev["ts"] + ev["dur"], ev["name"]) for ev in events
                 if ev.get("cat") == "user_annotation" and re.match(r"L\d+\.", ev.get("name", ""))]

        def line_sym(ev):
            held = [(b - a, name) for t, a, b, name in lines if t == ev["tid"] and a <= ev["ts"] < b]
            return min(held)[1].split(".", 1)[1].split("#")[0] if held else None

        # Same-dtype copies on a line that asks for a view (or on none),
        # less those inside a product (addmm's copy of its bias into the
        # output is the product's own work).
        copies = [ev for ev in ops if ev["name"] == "aten::copy_"
                  and len(set((ev.get("args") or {}).get("Input type", [])[:2])) == 1
                  and not any(t == ev["tid"] and a <= ev["ts"] < b for t, a, b in products)
                  and line_sym(ev) in (None, "reshape", "squeeze", "unsqueeze", "broadcast_in_dim", "transpose")]
        assert len(copies) > 0 and rep.layout_copies == len(copies)

    def test_planted_layout_copy_fires(self):
        def f(x):
            return x.transpose(0, 1).reshape(-1) * 2  # a 1 MiB f32 operand, transposed, made contiguous

        rep = hlo_report(f, torch.ones(512, 512), verbose=False)
        assert rep.layout_copies >= 1 and rep.layout_copy_bytes >= 2 * (1 << 20)
        assert "hlo.layout-copy" in {r for r, _ in _hlo(rep.diagnostics())}

    def test_follow_lines_reports_each_line(self):
        inner = tt.jit(lambda a: a * 3, device="cpu")
        jf = tt.jit(lambda a: (a + 1).sum(), device="cpu")
        jf(torch.ones(3))
        inner(torch.ones(3))
        seen = []
        with taudit.follow_lines(lambda trc, idx: seen.append(None if trc is None else trc.bound_symbols[idx].sym.name)):
            jf(torch.ones(3))
        assert "add" in seen and "sum" in seen and seen[-1] is None
        prog = tt.compile_stats(jf).cache_entries[0].computation_fn
        info = prog.__globals__["__thunder_program__"]
        assert info.code is prog.__code__ and info.line_of(1) is None


# =============================================================================
# Entry points and planted faults, through both packages
# =============================================================================


@PKGS
def test_examine_hlo_report(pkg):
    if pkg == "jax":
        from thunder_tpu.examine import hlo_report as jhlo_report

        rep = jhlo_report(lambda a: jclang.sum(jclang.tanh(a)), np.ones((4, 8), np.float32), verbose=False)
        assert isinstance(rep, jaudit.HloScheduleReport)
    else:
        rep = hlo_report(lambda a: torch.tanh(a).sum(), torch.ones(4, 8), verbose=False)
        assert isinstance(rep, taudit.HloScheduleReport)
        assert rep.flops == pytest.approx(2 * 32.0)  # tanh and sum, one operation an element each
    assert rep.n_ops > 0


@PKGS
def test_audit_jitted_rejects_non_jitted(pkg):
    with pytest.raises(TypeError):
        (jaudit if pkg == "jax" else taudit).audit_jitted(lambda x: x, 1.0)


def _jax_text_with_host_transfer():
    """The compiled HLO of the device part of ``g`` below (``sum(x)``),
    with the host read of its ``.item()`` planted as an ``outfeed`` of the
    scalar: a host transfer inside the step, as the JAX auditor reads one."""
    import jax
    import jax.numpy as jnp

    text = jax.jit(lambda x: jnp.sum(x)).lower(jnp.ones((4, 4), jnp.float32)).compile().as_text()
    root = re.search(r"ROOT %([\w.\-]+) = f32\[\]", text)
    planted = (f"  %tok = token[] after-all()\n  %outfeed.1 = token[] outfeed(f32[] %{root.group(1)}, token[] %tok), "
               'outfeed_shape=f32[]\n')
    return text.replace(root.group(0), planted + root.group(0), 1)


@PKGS
def test_planted_item_fires_host_transfer(pkg):
    if pkg == "jax":
        rep = jaudit.audit_hlo(_jax_text_with_host_transfer())
        diags = rep.diagnostics()
    else:
        def g(x):
            s = x.sum().item()  # the planted host read
            return x * 2, s

        rep = hlo_report(g, torch.ones(4, 4), verbose=False)
        diags = rep.diagnostics()
        assert any("aten::item" in op for op in rep.host_transfer_ops)
    assert rep.host_transfers >= 1
    assert ("hlo.host-transfer-in-step", int(JSeverity.WARNING)) in _hlo(diags)


@PKGS
def test_report_json_roundtrip_and_format(pkg):
    if pkg == "jax":
        with open(FIXTURE) as f:
            rep = jaudit.audit_hlo(f.read())
    else:
        rep = taudit.audit_hlo(GRAPH_EXCERPT, device="h100")
    js = rep.to_json()
    assert js["v"] == 1
    for key in ("module", "device", "n_ops", "collectives", "inserted_collectives", "exposed_pct", "sites",
                "fusions", "layout_copies", "host_transfers", "flops", "hbm_bytes", "comm_bytes", "pad_fractions"):
        assert key in js
    assert json.loads(json.dumps(js)) == js
    assert "collectives" in rep.format()
    assert all(int(d.severity) < int(JSeverity.ERROR) for d in rep.diagnostics())


@PKGS
def test_timeline_takes_the_audits_sites(pkg):
    """The fleet timeline's static join: ``split_static_wire(report.sites)``
    and ``set_static_wire(..., static_exposed_pct=report.exposed_pct)``."""
    if pkg == "jax":
        with open(FIXTURE) as f:
            rep = jaudit.audit_hlo(f.read())
        tl = jtimeline
    else:
        rep = _seeded_report("port", sites=[_exposed_site("port", 40.0, 10.0), _exposed_site("port", 20.0, 0.0)])
        rep.sites[1].group_size = 16
        tl = ttimeline
    split = tl.split_static_wire(rep.sites, devices_per_slice=8)
    assert split["ici_us"] + split["dcn_us"] == pytest.approx(rep.wire_us, abs=1e-2)
    rec = tl.TimelineRecorder()
    rec.set_static_wire(0.1 * split["ici_frac"], 0.1 * split["dcn_frac"], static_exposed_pct=rep.exposed_pct)
    assert rec.static_exposed_pct == pytest.approx(rep.exposed_pct)
    if pkg == "port":
        assert split["dcn_us"] == pytest.approx(20.0) and rep.exposed_pct == pytest.approx(50.0 / 60.0 * 100.0)
