"""The compiled-program auditor: the counterpart of ``thunder_tpu/analysis/hlo_audit.py``.

There is no HLO. The port runs no XLA program: a staged entry's compiled
executable is its CUDA graph (``executors/staging.py``, the seat of
``jax.jit``), and an unstaged entry runs its claimed trace eagerly. In the
seat of ``lowered.compile().as_text()`` this module reads one of two
programs, each below every trace-level rule:

(a) **the staged graph**: the verbose DOT text of
    ``torch.cuda.CUDAGraph.debug_dump`` (:func:`parse_graph_dump`), which a
    capture takes while the audit is on, with the graph's node count at each
    trace line the capture ran (:func:`follow_lines`): a node belongs to the
    line that was running when the capture made it. Kernel nodes (function,
    grid, block, dynamic shared memory), memcpy nodes (kind, bytes), memset,
    host and event nodes, and the edges between them.
(b) **the op record**: the ``torch.profiler`` record of one eager call
    (:func:`ops_of_record`), read through
    ``observability/attribution.record_ops``, the reading the launch-order
    map shares: device ops on the card, the host ops that did the work on
    the CPU, each with the scope of its line and the input shapes and types
    of its aten op.

Both feed one path (:func:`audit_hlo`):

1. **Classify** each op: a collective (an NCCL kernel, a ``c10d::`` op, or any
   op of a ``dist_prims`` line) by family, *explicit* when its line is a
   trace-level collective symbol (``cost.collective_sym_class``) and
   *inserted* otherwise (launched outside the trace); the port's own kernels
   (the functions of ``csrc/``, the seat of the JAX package's fusions);
   matmuls; layout copies; host transfers.
2. **Price**: an op placed on a trace line takes its line's cost
   (``cost.trace_cost``'s row), a line charged once, its time split over its
   ops; an op outside every line is priced by the JAX package's HLO-op rules
   (``cost.hlo_op_cost``) when it carries bytes or shapes (a memcpy, a
   memset, a host op, a collective launched outside the trace), and is
   otherwise counted unpriced and named, never guessed.
3. **Schedule**: a collective site's overlap window is the priced compute
   that can run while its wire is busy: in a graph, the nodes that neither
   reach the site nor are reached by it; in a record, the ops on other
   streams that run while it does. Windows share a budget, so two sites
   never claim the same op. On one stream every site is exposed, and the
   report says so.

Advisory by construction: the ``hlo.*`` rules report INFO or WARNING only,
and the compile phase (``api.py``) turns any failure of the audit into a
``sharp_edge``. ``THUNDER_TPU_HLO_AUDIT=0`` turns the phase off, and with it
the graph a capture keeps to dump it. User entry point:
``thunder_tpu_torch.examine.hlo_report(fn, *args)``.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import os
import re
import sys
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional, Sequence

from thunder_tpu_torch.analysis.cost import (
    collective_group_size,
    collective_sym_class,
    cost_row,
    hlo_op_cost,
    resolve_device_spec,
)
from thunder_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from thunder_tpu_torch.analysis.registry import register_rule
from thunder_tpu_torch.observability.attribution import INERT_OPS

__all__ = [
    "HloOp",
    "HloComputation",
    "HloModule",
    "HloCollectiveSite",
    "HloScheduleReport",
    "parse_graph_dump",
    "ops_of_record",
    "follow_lines",
    "audit_hlo",
    "audit_jitted",
    "audit_record",
    "program_of_stages",
    "enabled",
]


def enabled() -> bool:
    """The compile phase's kill switch: ``THUNDER_TPU_HLO_AUDIT=0`` (or
    ``false``, ``off``) turns it off, and with it the graph a capture keeps
    to dump and its line marks."""
    return os.environ.get("THUNDER_TPU_HLO_AUDIT", "1").strip().lower() not in ("0", "false", "off")


# The __global__ functions of csrc/: the port's own launches.
PORT_KERNELS = (
    "flash_fwd_kernel", "flash_bwd_di_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel", "rope_kernel",
    "ce_fwd_kernel", "ce_bwd_kernel", "norm_fwd_kernel", "norm_fwd_kernel_block", "norm_bwd_kernel",
    "norm_colsum_kernel", "rng_draw_kernel", "amax_kernel", "quantize_tensor_kernel", "quantize_rows_kernel",
    "int8_gemm_kernel", "int8_gemm_wgmma_kernel",
)
# A demangled name ("void flash_fwd_kernel<...>(...)"), or a mangled one,
# where an identifier is its length then its characters ("16flash_fwd_kernel").
_PORT_KERNEL_RE = re.compile(
    r"(?<![A-Za-z0-9_])(?:\d+)?(" + "|".join(sorted(PORT_KERNELS, key=len, reverse=True)) + r")(?![A-Za-z0-9_])")
_MANGLED_IDENT_RE = re.compile(r"(\d+)(" + "|".join(sorted(PORT_KERNELS, key=len, reverse=True)) + ")")
_MATMUL_KERNEL_RE = re.compile(r"gemm|nvjet|cutlass|cublas|xmma", re.I)
_COPY_KERNEL_RE = re.compile(r"direct_copy_kernel", re.I)
_MATMUL_OPS = frozenset({"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul", "aten::linear",
                         "aten::_scaled_mm", "aten::addmv", "aten::mv", "aten::dot"})
_COPY_OPS = frozenset({"aten::copy_", "aten::contiguous", "aten::clone"})
# A read of a value to the host (``.item()``); the reads of a 0-d host
# tensor an op takes as a number are not transfers. On the card the read's
# memcpy is the device op.
_HOST_OPS = frozenset({"aten::item"})
_REDUCE_OPS = frozenset({"aten::sum", "aten::mean", "aten::amax", "aten::amin", "aten::max", "aten::min",
                         "aten::argmax", "aten::argmin", "aten::var", "aten::var_mean", "aten::std", "aten::prod",
                         "aten::cumsum", "aten::norm", "aten::linalg_vector_norm", "aten::logsumexp"})
# The lines that ask for a view: a copy on one is a layout the program
# forced (a reshape of a transposed tensor), the JAX package's layout copy.
# A copy on any other line is that op's own data movement (a pad, a cat).
_VIEW_LINES = frozenset({"reshape", "squeeze", "unsqueeze", "broadcast_in_dim", "transpose", "permute", "expand",
                         "view", "flatten", "movedim", "contiguous"})
# torch.distributed's ops, by the family of their collective.
_C10D_FAMILIES = {
    "allreduce": "all-reduce", "allgather": "all-gather", "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter", "broadcast": "collective-broadcast", "alltoall": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute", "reduce": "all-reduce",
}
_C10D_RE = re.compile(r"^c10d::_?(allreduce|allgather|all_gather|reduce_scatter|broadcast|alltoall|send|recv|reduce)")
# The families attribution.COLLECTIVE_SYM_CLASS names differently from HLO.
_HLO_FAMILY = {"broadcast": "collective-broadcast"}

_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "long int": 8, "int": 4, "short int": 2,
    "signed char": 1, "unsigned char": 1, "bool": 1, "c10::complex<float>": 8, "c10::complex<double>": 16,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1, "float32": 4, "bfloat16": 2, "float16": 2, "int64": 8,
    "int32": 4, "int8": 1, "uint8": 1,
}


def _dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(dtype, 4)


def _numel(dims) -> float:
    n = 1.0
    for d in dims:
        n *= d
    return n


@functools.lru_cache(maxsize=None)
def demangle(name: str) -> str:
    """A C++ symbol demangled by the C++ runtime's ``__cxa_demangle`` (the
    demangler the profiler's kernel names come from), or ``name`` as it is."""
    if not name.startswith("_Z"):
        return name
    try:
        demangler, free = _cxxabi()
    except (OSError, AttributeError):
        return name
    status = ctypes.c_int()
    ptr = demangler(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not ptr:
        return name
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        free(ptr)


@functools.lru_cache(maxsize=1)
def _cxxabi() -> tuple:
    """``(__cxa_demangle, free)``: the C++ runtime's demangler, and the C
    library's ``free`` for the string it returns."""
    demangler = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    demangler.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    demangler.restype = ctypes.c_void_p
    free = ctypes.CDLL(None).free
    free.argtypes = [ctypes.c_void_p]
    free.restype = None
    return demangler, free


def port_kernel_of(name: str) -> Optional[str]:
    """The ``csrc/`` function a kernel name launches, or None."""
    for m in _MANGLED_IDENT_RE.finditer(name):
        if int(m.group(1)) == len(m.group(2)):
            return m.group(2)
    m = _PORT_KERNEL_RE.search(name)
    return m.group(1) if m else None


# =============================================================================
# The op model
# =============================================================================


@dataclass
class HloOp:
    """One executed device operation (a node of a captured graph, or an op
    of a profiler record), with the fields the JAX package's op carries and
    :func:`~thunder_tpu_torch.analysis.cost.hlo_op_cost` reads.

    ``node`` is what ran: "kernel", "memcpy", "memset", "host", "event_record",
    "event_wait", "empty", a graph's other node types, or "op" (a host op of
    the CPU's record). ``opcode`` is its pricing opcode in the JAX package's
    vocabulary ("dot", "copy", "send"/"recv" for a transfer to/from the host,
    a collective's family, "fusion" for the port's own kernels, "kernel"
    for any other). ``op_name`` is the scope of the trace line it ran in,
    ``L<idx>.<sym>#<pass>`` ("" outside every line). ``operands`` are the
    indices of the ops it depends on (a graph's edges); ``stream`` is a
    record's stream or thread, a graph's branch."""

    name: str
    opcode: str
    result_type: str = ""
    shapes: list = field(default_factory=list)  # [(dtype, (dims...)), ...] of the inputs, where known
    operands: list = field(default_factory=list)
    index: int = 0
    computation: str = ""
    op_name: str = ""
    result_numel: float = 0.0
    result_bytes: float = 0.0
    operand_numel: float = 0.0
    operand_bytes: float = 0.0
    group_size: int = 1
    k_dim: float = 0.0
    family: Optional[str] = None
    # -- the port's --
    node: str = "kernel"
    kind: str = "compute"  # collective | fusion | matmul | layout | host | compute | sync
    stream: Any = 0
    direction: str = ""  # a memcpy's: DtoD, HtoD, DtoH, HtoH, default
    nbytes: float = 0.0  # a memcpy's or memset's bytes
    launch: str = ""  # a kernel's <<<grid, block, shared memory>>>
    start: float = 0.0  # a record's µs
    dur: float = 0.0
    host_op: str = ""  # the aten op whose call launched a device op
    args: dict = field(default_factory=dict)  # a record's event arguments


@dataclass
class HloComputation:
    """One program: a captured graph, or one call's record."""

    name: str
    is_entry: bool = False
    ops: list = field(default_factory=list)
    defs: dict = field(default_factory=dict)  # op name -> index
    ran_lines: list = field(default_factory=list)  # the scopes of the lines it ran, in order


@dataclass
class HloModule:
    """The programs of one audit. ``traces`` maps a trace's scope tag
    (``TraceCtx._annotate_tag``) to the trace, to price its lines;
    ``source`` is "graph" or "record"."""

    name: str
    computations: list = field(default_factory=list)
    traces: dict = field(default_factory=dict)
    source: str = "graph"

    @property
    def ran_lines(self) -> list:
        return [s for c in self.computations for s in c.ran_lines]

    @property
    def entry(self) -> Optional[HloComputation]:
        for c in self.computations:
            if c.is_entry:
                return c
        return self.computations[0] if self.computations else None

    @property
    def n_ops(self) -> int:
        return sum(len(c.ops) for c in self.computations)

    def bsym_of(self, scope: str):
        """``(trace, index)`` of a line scope, or None when no trace of the
        module holds that line under that symbol."""
        from thunder_tpu_torch.observability.attribution import parse_scope

        ref = parse_scope(scope)
        trc = self.traces.get(ref.pass_name) if ref is not None else None
        if trc is None or not 0 <= ref.line < len(trc.bound_symbols):
            return None
        return (trc, ref.line) if trc.bound_symbols[ref.line].sym.name == ref.sym else None


# =============================================================================
# Following a program line by line
# =============================================================================


# The sys.monitoring tool id the line following takes (0-2 and 5 are the
# debugger's, coverage's, the profiler's and the optimizer's).
_MONITOR_TOOL = 4


@contextlib.contextmanager
def follow_lines(on_line: Callable[[Any, Optional[int]], None], traces: Optional[Sequence] = None) -> Iterator[bool]:
    """Within the block, call ``on_line(trace, index)`` as each line of a
    generated program (``TraceCtx.python_callable``) makes its first call on
    this thread (a line that calls nothing launches nothing), and
    ``on_line(None, None)`` when the program returns to code outside every
    program. A program called from a line of another is followed too; when
    it returns, the outer line is reported again. Only the programs' own
    code objects are instrumented (``sys.monitoring``'s local call, start
    and return events, each placed by its bytecode offset: the line events
    of Python 3.12 cost time linear in a program's length, each), so the
    rest runs at full speed. ``traces``: follow only the programs of these
    traces (a staged program's), not every live one. Yields False, and
    follows nothing, where the tool id is taken (another monitor)."""
    from thunder_tpu_torch.core.trace import live_programs

    mon = getattr(sys, "monitoring", None)
    wanted = None if traces is None else {id(t) for t in traces}
    infos = {p.code: p for p in live_programs() if p.code is not None and (wanted is None or id(p.trace) in wanted)}
    try:
        mon.use_tool_id(_MONITOR_TOOL, "thunder_tpu_torch.hlo_audit")
    except (AttributeError, ValueError):
        yield False
        return
    me = threading.get_ident()
    stack: list = []  # [ProgramLines, current index] of each program frame
    events = mon.events

    def start(code, offset):
        if threading.get_ident() == me:
            stack.append([infos[code], None])

    def call(code, offset, fn, arg0):
        if threading.get_ident() != me or not stack or stack[-1][0].code is not code:
            return
        top = stack[-1]
        idx = top[0].line_at(offset)
        if top[1] != idx:
            top[1] = idx
            on_line(top[0].trace, idx)

    def ret(code, offset, value):
        if threading.get_ident() != me or not stack:
            return
        stack.pop()
        if stack:
            on_line(stack[-1][0].trace, stack[-1][1])
        else:
            on_line(None, None)

    callbacks = {events.PY_START: start, events.CALL: call, events.PY_RETURN: ret}
    try:
        for event, fn in callbacks.items():
            mon.register_callback(_MONITOR_TOOL, event, fn)
        for code in infos:
            mon.set_local_events(_MONITOR_TOOL, code, events.PY_START | events.CALL | events.PY_RETURN)
        yield True
    finally:
        for code in infos:
            mon.set_local_events(_MONITOR_TOOL, code, 0)
        for event in callbacks:
            mon.register_callback(_MONITOR_TOOL, event, None)
        mon.free_tool_id(_MONITOR_TOOL)


# =============================================================================
# Reader (a): the staged graph
# =============================================================================

_NODE_RE = re.compile(r'"graph_(\d+)_node_(\d+)"\s*\[[^\]]*?label="\{(.*?)\}"\];', re.S)
_EDGE_RE = re.compile(r'"graph_(\d+)_node_(\d+)"\s*->\s*"graph_(\d+)_node_(\d+)"')
_ID_RE = re.compile(r"(\d+) \(topoId: \d+\)")
_KERNEL_RE = re.compile(r"\(topoId: \d+\) \| (.*?)\\<\\<\\<(.*?)\\>\\>\\>")
_KIND_RE = re.compile(r"\{kind \| (\w+)(?: \(([^)]*)\))?\}")
_EXTENT_RE = re.compile(r"\{Width \| (\d+)\} \| \{Height \| (\d+)\} \| \{Depth \| (\d+)\}")
_MEMSET_RE = re.compile(r"\{?(width|height|elementSize|pitch|value)\s*\|\s*(\d+)", re.I)
_NODE_TYPES = {"KERNEL": "kernel", "MEMCPY": "memcpy", "MEMSET": "memset", "HOST": "host",
               "EVENT_RECORD": "event_record", "WAIT_EVENT": "event_wait", "EMPTY": "empty", "GRAPH": "graph",
               "MEM_ALLOC": "mem_alloc", "MEM_FREE": "mem_free", "EXT_SEMAS_SIGNAL": "semaphore_signal",
               "EXT_SEMAS_WAIT": "semaphore_wait", "CONDITIONAL": "conditional", "BATCH_MEM_OP": "mem_op"}


def _graph_op(gid: str, nid: int, label: str) -> HloOp:
    head = re.match(r"\s*([A-Z_]+)", label)
    node = _NODE_TYPES.get(head.group(1), head.group(1).lower()) if head else "unknown"
    m = _ID_RE.search(label)
    index = int(m.group(1)) if m else nid
    op = HloOp(name=node, opcode="kernel", index=index, computation=f"graph_{gid}", node=node)
    if node == "kernel":
        km = _KERNEL_RE.search(label)
        if km:
            op.name = demangle(km.group(1).strip())
            op.launch = km.group(2).replace("\\", "")
    elif node == "memcpy":
        km = _KIND_RE.search(label)
        op.direction = km.group(1) if km else "default"
        if op.direction == "default" and km and km.group(2):
            # cudaMemcpyDefault: the pointers' spaces, "DEVICE to HOST PINNED".
            src, _, dst = km.group(2).partition(" to ")
            op.direction = ("H" if "HOST" in src else "D") + "to" + ("H" if "HOST" in dst else "D")
        em = _EXTENT_RE.search(label)
        op.nbytes = float(_numel(int(x) for x in em.groups())) if em else 0.0
        op.name = f"memcpy {op.direction}"
    elif node == "memset":
        fields = {k.lower(): int(v) for k, v in _MEMSET_RE.findall(label)}
        op.nbytes = float(fields.get("width", 0) * fields.get("height", 1) * fields.get("elementsize", 1))
    return op


def parse_graph_dump(text: str, *, marks: Optional[list] = None, name: str = "") -> HloModule:
    """Parse the verbose DOT text of ``CUDAGraph.debug_dump`` into an
    :class:`HloModule`, a computation a graph. ``marks`` are the capture's
    line marks (``[(node count, trace or None, line index), ...]``, in the
    order the lines ran, :func:`follow_lines`): a node of the first graph
    belongs to the line that was running when it was made (its ID is its
    place in the order the capture made the nodes). Raises ``ValueError``
    when the text holds no node."""
    if not isinstance(text, str) or "digraph" not in text:
        raise ValueError("not a CUDA graph's DOT dump")
    module = HloModule(name=name, source="graph")
    comps: dict[str, HloComputation] = {}
    dot_ids: dict[int, str] = {}  # id(op) -> its DOT node name
    for gid, nid, label in _NODE_RE.findall(text):
        comp = comps.get(gid)
        if comp is None:
            comp = comps[gid] = HloComputation(name=f"graph_{gid}", is_entry=not comps)
            module.computations.append(comp)
        op = _graph_op(gid, int(nid), label)
        dot_ids[id(op)] = f"node_{nid}"
        comp.ops.append(op)
    if not comps:
        raise ValueError("no node in the CUDA graph's DOT dump")
    for comp in module.computations:
        # A node's ID is its place in the order the capture made the nodes.
        comp.ops.sort(key=lambda o: o.index)
        comp.defs = {dot_ids[id(op)]: i for i, op in enumerate(comp.ops)}
        for i, op in enumerate(comp.ops):
            op.index = i
    for g1, n1, g2, n2 in _EDGE_RE.findall(text):
        comp = comps.get(g1)
        if comp is None or g1 != g2:
            continue
        src, dst = comp.defs.get(f"node_{n1}"), comp.defs.get(f"node_{n2}")
        if src is not None and dst is not None and src not in comp.ops[dst].operands:
            comp.ops[dst].operands.append(src)
    _branches(module.entry)
    if marks:
        counts = [m[0] for m in marks]
        for op in module.entry.ops:
            k = bisect.bisect_right(counts, op.index) - 1
            if k >= 0 and marks[k][1] is not None:
                op.op_name = marks[k][1].scope_of(marks[k][2])
        seen = set()
        for _, trc, idx in marks:
            if trc is not None and (id(trc), idx) not in seen:
                seen.add((id(trc), idx))
                module.entry.ran_lines.append(trc.scope_of(idx))
                module.traces.setdefault(trc._annotate_tag(), trc)
    return module


def _branches(comp: Optional[HloComputation]) -> None:
    """Number a graph's branches into ``op.stream``: a node continues the
    branch of its first dependency unless an earlier node already did."""
    if comp is None:
        return
    continued: set = set()
    n = 0
    for op in comp.ops:
        dep = next((d for d in op.operands if d not in continued), None)
        if dep is None:
            op.stream = n
            n += 1
        else:
            continued.add(dep)
            op.stream = comp.ops[dep].stream


def program_of_stages(stages) -> HloModule:
    """The :class:`HloModule` of the graphs the staged programs ``stages``
    (``executors/staging.CudaGraphStage``) captured last, a computation a
    graph, each node placed by its stage's line marks."""
    module = HloModule(name="+".join(st.name for st in stages), source="graph")
    for st in stages:
        if st.graph_dump is None:
            raise ValueError(f"the staged program {st.name!r} kept no graph dump (not captured, or captured with "
                             "THUNDER_TPU_HLO_AUDIT=0)")
        part = parse_graph_dump(st.graph_dump, marks=st.line_marks, name=st.name)
        for comp in part.computations:
            comp.name = f"{st.name}/{comp.name}"
            comp.is_entry = comp.is_entry and not module.computations
            for op in comp.ops:
                op.computation = comp.name
            module.computations.append(comp)
        module.traces.update(part.traces)
    return module


# =============================================================================
# Reader (b): the op record
# =============================================================================


def _shapes_of(ev: Optional[dict]) -> list:
    args = (ev or {}).get("args") or {}
    dims, types = args.get("Input Dims") or [], args.get("Input type") or []
    out = []
    for d, t in zip(dims, types):
        if isinstance(d, list) and all(isinstance(x, int) for x in d) and t and t not in ("Scalar", "ScalarList"):
            out.append((t, tuple(d)))
        elif t == "TensorList" and isinstance(d, list):
            # A list's element types are not recorded: each is priced at 4 bytes an element.
            out += [(t, tuple(x)) for x in d if isinstance(x, list) and all(isinstance(n, int) for n in x)]
    return out


def ops_of_record(source: Any, traces=()) -> HloModule:
    """Parse the ``torch.profiler`` record of one eager call (a trace dir or
    Chrome-trace file of one session, or its events) into an
    :class:`HloModule`: its ops through ``attribution.record_ops`` (device
    ops on the card, the host ops that did the work on the CPU), each with
    its line's scope and its aten op's input shapes and types (a record
    taken with ``record_shapes=True``). ``traces`` are the traces whose
    lines the scopes name, to price them."""
    from thunder_tpu_torch.observability import attribution as att

    if isinstance(source, (str, os.PathLike)):
        events = [ev for path in att.find_trace_files(str(source)) for ev in att.load_trace_events(path)]
    else:
        events = list(source)
    module = HloModule(name="record", source="record")
    for trc in traces:
        module.traces.setdefault(trc._annotate_tag(), trc)
    comp = HloComputation(name="record", is_entry=True)
    module.computations.append(comp)
    for r in att.record_ops(events):
        ev = r.event
        args = ev.get("args") or {}
        cat = ev.get("cat")
        node = "kernel" if cat == "kernel" else "memcpy" if cat == "gpu_memcpy" else "memset" if cat == "gpu_memset" \
            else "op"
        name = str(ev.get("name", ""))
        op = HloOp(name=name, opcode="kernel", index=len(comp.ops), computation=comp.name, node=node,
                   op_name=r.scope.label if r.scope is not None else "", stream=(ev.get("pid"), ev.get("tid")),
                   start=float(ev.get("ts", 0.0)), dur=float(ev.get("dur", 0.0)), shapes=_shapes_of(r.host_op),
                   host_op=str((r.host_op or {}).get("name", "")))
        comms = ev if name == "record_param_comms" else r.host_op if op.host_op == "record_param_comms" else None
        if comms is not None:
            op.args = dict(comms.get("args") or {})
        if node in ("memcpy", "memset"):
            op.nbytes = float(args.get("bytes", 0) or 0)
            m = re.search(r"\b([DH]to[DH])\b", name)
            op.direction = m.group(1) if m else ("DtoD" if node == "memcpy" else "")
        comp.ops.append(op)
    for ev in sorted(events, key=lambda e: float(e.get("ts", 0.0))):
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            ref = att.parse_scope(str(ev.get("name", "")))
            if ref is not None and ref.label not in comp.ran_lines:
                comp.ran_lines.append(ref.label)
    return module


class _ScopeRanges:
    """:func:`follow_lines`' callback for a profiled call: each line of a
    program runs in a profiler range named by its scope (what
    ``THUNDER_ANNOTATE_TRACES=1`` puts in the program itself), and the
    traces that ran are kept."""

    def __init__(self):
        self.open = None
        self.traces: dict = {}

    def __call__(self, trace, idx) -> None:
        import torch

        self.close()
        if trace is not None and idx is not None:
            self.traces.setdefault(trace._annotate_tag(), trace)
            self.open = torch.profiler.record_function(trace.scope_of(idx))
            self.open.__enter__()

    def close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def audit_record(fn: Callable, *args, device: Any = None, pad_fractions: Optional[dict] = None,
                 **kwargs) -> "HloScheduleReport":
    """Reader (b) on demand: one call of ``fn(*args, **kwargs)``, its staged
    entries running their eager programs (``attribution.eager_stages``),
    under ``torch.profiler`` with shapes recorded, each line of each program
    it runs on this thread in a range of its scope; then the audit of that
    record. The call is a real one: a training step updates its params."""
    from thunder_tpu_torch.observability.attribution import eager_stages
    from thunder_tpu_torch.observability.profile import traced

    scopes = _ScopeRanges()
    with tempfile.TemporaryDirectory(prefix="thunder_hlo_record_") as d:
        path = os.path.join(d, "record.trace.json")
        with eager_stages(fn), traced(path, record_shapes=True):
            try:
                with follow_lines(scopes):
                    fn(*args, **kwargs)
            finally:
                scopes.close()
        module = ops_of_record(path, scopes.traces.values())
    return audit_hlo(module, device=device, pad_fractions=pad_fractions)


# =============================================================================
# Classification
# =============================================================================


def _line_sym(scope: str) -> Optional[str]:
    from thunder_tpu_torch.observability.attribution import parse_scope

    ref = parse_scope(scope)
    return ref.sym if ref is not None else None


@functools.lru_cache(maxsize=4096)
def _kernel_kind(name: str) -> tuple:
    """``(collective family, csrc/ function, a product?, a copy?)`` of a
    kernel or op name: a graph repeats a few dozen names thousands of times."""
    from thunder_tpu_torch.observability.attribution import collective_class

    fam = collective_class(name)
    m = _C10D_RE.match(name)
    fam = _HLO_FAMILY.get(fam, fam) if fam is not None else _C10D_FAMILIES[m.group(1)] if m else None
    return fam, port_kernel_of(name), bool(_MATMUL_KERNEL_RE.search(name)), bool(_COPY_KERNEL_RE.search(name))


def _collective_family(op: HloOp) -> Optional[str]:
    """The family of a collective op by its own name (an NCCL kernel, a
    ``c10d::`` op, ``record_param_comms``), or None."""
    fam = _kernel_kind(op.name)[0]
    if fam is not None:
        return fam
    if op.name == "record_param_comms":
        coll = str(op.args.get("Collective name", "")).lower().replace("_into_tensor", "")
        for key, fam in _C10D_FAMILIES.items():
            if key.replace("_", "") in coll.replace("_", ""):
                return fam
    return None


def _classify(op: HloOp) -> None:
    """Stamp ``op.kind``, ``op.family`` and the pricing fields of an op
    outside every line."""
    sym = _line_sym(op.op_name)
    line_family = collective_sym_class(sym) if sym else None
    own = _collective_family(op)
    if line_family is not None or own is not None:
        op.kind, op.family = "collective", own or _HLO_FAMILY.get(line_family, line_family)
        op.opcode = op.family
        return
    aten = op.host_op or op.name
    forced = sym is None or sym in _VIEW_LINES
    if op.node == "memcpy":
        op.kind = ("layout" if forced else "compute") if op.direction in ("DtoD", "default", "") else "host"
        op.opcode = "copy" if op.kind == "layout" else ("recv" if op.direction == "HtoD" else "send")
        op.result_bytes = op.operand_bytes = op.nbytes
        return
    if op.node == "memset":
        op.opcode, op.result_bytes = "memset", op.nbytes
        return
    if op.node in ("host", "event_record", "event_wait"):
        op.kind = "host" if op.node == "host" else "sync"
        op.opcode = "send" if op.node == "host" else "after-all"
        return
    _, port, product, copy = _kernel_kind(op.name) if op.node == "kernel" else (None, None, False, False)
    if port:
        op.kind, op.opcode = "fusion", "fusion"
        return
    if product or aten in _MATMUL_OPS:
        op.kind = "matmul"
    elif aten in _HOST_OPS:
        op.kind = "host"
    elif forced and (copy or aten in _COPY_OPS) and _same_dtypes(op):
        op.kind = "layout"
    _shape_fields(op, aten)


def _same_dtypes(op: HloOp) -> bool:
    types = {t for t, _ in op.shapes}
    return len(types) <= 1


def _shape_fields(op: HloOp, aten: str) -> None:
    """The duck-typed fields of an op outside every line, from the input
    shapes its aten op recorded (none known: left unpriced)."""
    if aten in INERT_OPS:
        op.opcode = "bitcast"
        return
    if not op.shapes:
        return
    sizes = [(_numel(d), _dtype_bytes(t), d) for t, d in op.shapes]
    op.operand_numel = sum(n for n, _, _ in sizes)
    op.operand_bytes = sum(n * b for n, b, _ in sizes)
    if op.kind == "matmul":
        mats = [d for _, _, d in sizes if len(d) >= 2][-2:]
        if len(mats) == 2:
            a, b = mats
            op.k_dim = float(a[-1])
            batch = _numel(a[:-2]) if len(a) > 2 else 1.0
            op.result_numel = batch * a[-2] * b[-1]
            op.result_bytes = op.result_numel * sizes[-1][1]
            op.opcode = "dot"
        return
    n, b, _ = max(sizes, key=lambda s: s[0])
    op.result_numel, op.result_bytes = n, n * b
    if op.kind == "layout":
        op.opcode, op.operand_bytes = "copy", n * sizes[-1][1]
    elif op.kind == "host":
        op.opcode = "send"
    elif aten in _REDUCE_OPS:
        op.opcode, op.result_numel, op.result_bytes = "reduce", 1.0, float(b)
    else:
        op.opcode = "elementwise"


def _collective_fields(op: HloOp) -> None:
    """A collective launched outside the trace: its full tensor's bytes and
    its group from what the record holds (the shapes of its ``c10d::`` op,
    ``record_param_comms``' arguments; the default group's size where the
    record names none)."""
    args = op.args
    if args.get("In msg nelems") is not None:
        n = float(args.get("Out msg nelems") or args.get("In msg nelems") or 0)
        op.result_bytes = op.operand_bytes = n * _dtype_bytes(str(args.get("dtype", "float")).lower())
        op.group_size = int(args.get("Group size") or 1)
        return
    tensors = [(_numel(d), _dtype_bytes(t)) for t, d in op.shapes]
    if tensors:
        full = max(n * b for n, b in tensors)
        op.result_bytes = op.operand_bytes = full
    try:
        import torch.distributed as dist

        op.group_size = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    except (RuntimeError, ValueError):
        op.group_size = 1


# =============================================================================
# Schedule analysis and report
# =============================================================================


@dataclass
class HloCollectiveSite:
    """One collective site of the program: an explicit one is a collective
    line of the trace (its ops, at one rank a copy or nothing), an inserted
    one an op launched outside the trace. Wire bytes are the cost model's;
    the window and the hidden time come from the happens-before scan."""

    name: str
    opcode: str
    family: str
    computation: str
    index: int
    group_size: int
    wire_bytes: float
    wire_us: float
    window_us: float
    hidden_us: float
    first_consumer: Optional[int] = None
    inserted: bool = True
    derived: bool = False
    scope: str = ""
    nodes: int = 0

    @property
    def exposed_us(self) -> float:
        return max(0.0, self.wire_us - self.hidden_us)

    def label(self) -> str:
        return f"{self.computation}/{self.name}"

    def to_json(self) -> dict:
        return {
            "name": self.name, "opcode": self.opcode, "family": self.family,
            "computation": self.computation, "index": self.index, "group_size": self.group_size,
            "wire_bytes": self.wire_bytes, "wire_us": round(self.wire_us, 3), "window_us": round(self.window_us, 3),
            "hidden_us": round(self.hidden_us, 3), "exposed_us": round(self.exposed_us, 3),
            "first_consumer": self.first_consumer, "inserted": self.inserted, "derived": self.derived,
            "scope": self.scope, "nodes": self.nodes,
        }


@dataclass
class HloScheduleReport:
    """Everything the auditor recovered from one program. ``fusions`` counts
    the port's own kernel launches (``port_kernels`` by ``csrc/`` function);
    ``kernels`` counts every kernel by name; ``unpriced_ops`` names the ops
    no rule could price; ``single_stream`` says every op ran on one stream
    or branch, so no collective can hide."""

    module: str
    device: str
    n_ops: int = 0
    n_computations: int = 0
    sites: list = field(default_factory=list)
    by_family: dict = field(default_factory=dict)
    fusions: int = 0
    layout_copies: int = 0
    layout_copy_bytes: float = 0.0
    layout_copy_ops: list = field(default_factory=list)
    host_transfers: int = 0
    host_transfer_ops: list = field(default_factory=list)
    flops: float = 0.0
    hbm_bytes: float = 0.0
    comm_bytes: float = 0.0
    compute_us: float = 0.0
    pad_fractions: dict = field(default_factory=dict)
    audit_s: float = 0.0
    source: str = "graph"
    matmuls: int = 0
    port_kernels: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    lines_priced: int = 0
    unpriced: int = 0
    unpriced_ops: list = field(default_factory=list)
    streams: int = 1

    @property
    def single_stream(self) -> bool:
        return self.streams <= 1

    @property
    def wire_us(self) -> float:
        return sum(s.wire_us for s in self.sites)

    @property
    def hidden_us(self) -> float:
        return sum(s.hidden_us for s in self.sites)

    @property
    def exposed_us(self) -> float:
        return sum(s.exposed_us for s in self.sites)

    @property
    def exposed_pct(self) -> float:
        """Exposed share of the predicted wire time, in percent."""
        return self.exposed_us / self.wire_us * 100.0 if self.wire_us else 0.0

    @property
    def inserted_collectives(self) -> int:
        return sum(1 for s in self.sites if s.inserted)

    @property
    def explicit_collectives(self) -> int:
        return sum(1 for s in self.sites if not s.inserted)

    def to_json(self) -> dict:
        return {
            "v": 1,
            "module": self.module,
            "device": self.device,
            "source": self.source,
            "n_ops": self.n_ops,
            "n_computations": self.n_computations,
            "streams": self.streams,
            "collectives": {k: dict(v) for k, v in sorted(self.by_family.items())},
            "inserted_collectives": self.inserted_collectives,
            "explicit_collectives": self.explicit_collectives,
            "fusions": self.fusions,
            "port_kernels": dict(self.port_kernels),
            "kernels": dict(self.kernels),
            "matmuls": self.matmuls,
            "layout_copies": {"count": self.layout_copies, "bytes": self.layout_copy_bytes},
            "host_transfers": self.host_transfers,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "comm_bytes": self.comm_bytes,
            "compute_us": round(self.compute_us, 3),
            "wire_us": round(self.wire_us, 3),
            "hidden_us": round(self.hidden_us, 3),
            "exposed_us": round(self.exposed_us, 3),
            "exposed_pct": round(self.exposed_pct, 2),
            "lines_priced": self.lines_priced,
            "unpriced": self.unpriced,
            "pad_fractions": dict(self.pad_fractions),
            "audit_s": self.audit_s,
            "sites": [s.to_json() for s in self.sites],
        }

    def format(self) -> str:
        lines = [
            f"program audit [{self.module or 'program'} @ {self.device}, {self.source}]: {self.n_ops} ops / "
            f"{self.n_computations} computations on {self.streams} stream(s), {len(self.sites)} collectives "
            f"({self.inserted_collectives} inserted), {self.fusions} port kernels, {self.matmuls} matmuls, "
            f"{self.layout_copies} layout copies, {self.host_transfers} host transfers",
            f"  priced {self.flops / 1e9:.3f} GFLOP, {self.hbm_bytes / 1e6:.2f} MB, {self.lines_priced} lines; "
            f"{self.unpriced} op(s) unpriced"
            + (f" ({', '.join(self.unpriced_ops[:3])}{', ...' if self.unpriced > 3 else ''})" if self.unpriced else ""),
            f"  wire {self.wire_us:.1f}us, hidden {self.hidden_us:.1f}us, exposed {self.exposed_us:.1f}us "
            f"({self.exposed_pct:.1f}%)",
        ]
        if self.sites and self.single_stream:
            lines.append("  one stream: every collective site is exposed (nothing can run beside its wire)")
        for fam, agg in sorted(self.by_family.items()):
            lines.append(f"  {fam:<20} n={agg['count']:<3} wire {agg['wire_bytes'] / 1e6:9.3f} MB"
                         f"  {agg['wire_us']:9.1f}us")
        if self.sites:
            lines.append(f"  {'site':<34} {'family':<16} {'wire us':>9} {'window':>9} {'hidden':>9} {'exposed':>9}")
        for s in sorted(self.sites, key=lambda s: -s.wire_us)[:20]:
            lines.append(f"  {s.label():<34.34} {s.family:<16} {s.wire_us:>9.2f} {s.window_us:>9.2f} "
                         f"{s.hidden_us:>9.2f} {s.exposed_us:>9.2f}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()

    def diagnostics(self) -> list:
        """The ``hlo.*`` findings over this report, without a trace."""
        diags: list[Diagnostic] = []
        for reporter in (_report_exposed, _report_layout_copy, _report_padding, _report_host_transfer):
            reporter(self, lambda *a, **k: diags.append(_diag(*a, **k)))
        return diags


def _diag(rule: str, severity: Severity, message: str, *, hint: Optional[str] = None,
          bsym_index: Optional[int] = None) -> Diagnostic:
    return Diagnostic(rule=rule, severity=severity, message=message, hint=hint, bsym_index=bsym_index)


def _line_rows(module: HloModule, dev) -> dict:
    """``{scope: cost row}`` (``cost.cost_row``) of every line the program
    placed an op on or ran; a line the cost model holds free has none."""
    rows = {}
    scopes = {op.op_name for c in module.computations for op in c.ops if op.op_name} | set(module.ran_lines)
    for scope in scopes:
        found = module.bsym_of(scope)
        row = cost_row(found[1], found[0].bound_symbols[found[1]], dev) if found is not None else None
        if row is not None:
            rows[scope] = row
    return rows


def audit_hlo(program: Any, *, device: Any = None, pad_fractions: Optional[dict] = None) -> HloScheduleReport:
    """Classify, price and schedule-analyze one program: an
    :class:`HloModule` (:func:`parse_graph_dump`, :func:`ops_of_record`,
    :func:`program_of_stages`), or a graph's DOT text (its nodes then on no
    line). Raises on what it cannot parse (the compile phase and ``examine``
    turn that into a ``sharp_edge``). ``pad_fractions`` (class label →
    padded-away fraction) ride along for ``hlo.padding-waste``."""
    module = parse_graph_dump(program) if isinstance(program, str) else program
    if not isinstance(module, HloModule) or not module.computations:
        raise ValueError(f"audit_hlo needs a program (HloModule or DOT text), got {type(program).__name__}")
    dev = resolve_device_spec(device)
    report = HloScheduleReport(module=module.name, device=dev.name, n_ops=module.n_ops,
                               n_computations=len(module.computations), pad_fractions=dict(pad_fractions or {}),
                               source=module.source)
    rows = _line_rows(module, dev)
    charged: set = set()
    streams: set = set()
    for comp in module.computations:
        by_line: dict[str, list] = {}
        for op in comp.ops:
            _classify(op)
            if op.op_name:
                by_line.setdefault(op.op_name, []).append(op)
        compute_us: dict[int, float] = {}
        for scope, ops in by_line.items():
            row = rows.get(scope)
            if row is None:
                if module.bsym_of(scope) is None:  # a line of no trace the audit was given
                    report.unpriced += len(ops)
                    report.unpriced_ops.extend(f"{comp.name}/{scope}:{op.name[:60]}" for op in ops)
                continue  # else a line the cost model holds free (bookkeeping, a host read)
            if scope not in charged:
                charged.add(scope)
                report.lines_priced += 1
                report.flops += row.flops
                report.hbm_bytes += row.bytes_moved
                report.comm_bytes += row.comm_bytes
            work = [op for op in ops if op.kind != "collective"]
            if row.kind != "collective" and work:
                for op in work:
                    compute_us[op.index] = row.roofline_s * 1e6 / len(work)
        for op in comp.ops:
            if op.node == "kernel":
                report.kernels[op.name] = report.kernels.get(op.name, 0) + 1
            if op.kind in ("collective", "sync"):
                if op.kind == "sync":
                    streams.add(op.stream)
                continue
            streams.add(op.stream)
            if op.kind == "fusion":
                report.fusions += 1
                fn = _kernel_kind(op.name)[1]
                report.port_kernels[fn] = report.port_kernels.get(fn, 0) + 1
            elif op.kind == "matmul":
                report.matmuls += 1
            elif op.kind == "layout":
                report.layout_copies += 1
                report.layout_copy_bytes += 2.0 * _copy_bytes(op, module)
                report.layout_copy_ops.append(f"{comp.name}/{op.name[:60]}" + (f"@{op.op_name}" if op.op_name else ""))
            elif op.kind == "host":
                report.host_transfers += 1
                report.host_transfer_ops.append(f"{comp.name}/{op.name[:60]}" + (f"@{op.op_name}" if op.op_name else ""))
            if op.op_name:
                continue
            cost = hlo_op_cost(op) if (op.result_bytes or op.operand_bytes or op.result_numel) else None
            if cost is None:
                if op.opcode not in ("bitcast", "after-all") and op.node not in ("empty", "event_record",
                                                                                  "event_wait"):
                    report.unpriced += 1
                    report.unpriced_ops.append(f"{comp.name}/{op.name[:60]}")
                continue
            report.flops += cost.flops
            report.hbm_bytes += cost.bytes_moved
            t = max(cost.flops / dev.peak_for("f32") if cost.flops else 0.0, cost.bytes_moved / dev.hbm_bw)
            compute_us[op.index] = t * 1e6
        report.compute_us += sum(compute_us.values())
        _scan_sites(report, module, comp, rows, compute_us, dev)
    report.streams = max(1, len(streams))
    for agg in report.by_family.values():
        agg["wire_us"] = round(agg["wire_us"], 3)
    return report


def _copy_bytes(op: HloOp, module: HloModule) -> float:
    """One side of a layout copy: a memcpy's bytes, an op's recorded
    output, else the output of the line it ran in."""
    from thunder_tpu_torch.core.proxies import TensorProxy

    if op.node == "memcpy" or op.result_bytes:
        return op.nbytes if op.node == "memcpy" else op.result_bytes
    found = module.bsym_of(op.op_name) if op.op_name else None
    if found is None:
        return 0.0
    trc, idx = found
    return float(sum(p.size_bytes for p in trc.bound_symbols[idx].flat_proxy_outs if isinstance(p, TensorProxy)))


def _scan_sites(report: HloScheduleReport, module: HloModule, comp: HloComputation, rows: dict,
                compute_us: dict, dev) -> None:
    """The sites of one computation and their windows, each op's priced
    compute a budget that the sites draw on in program order."""
    def explicit_line(scope: str) -> bool:
        return bool(scope) and scope in rows and collective_sym_class(rows[scope].sym) is not None

    sites: list[tuple] = []  # (anchor op or None, scope, ops)
    explicit: dict[str, list] = {}
    for op in comp.ops:
        if op.kind != "collective":
            continue
        if explicit_line(op.op_name):
            explicit.setdefault(op.op_name, []).append(op)
        else:
            sites.append((op, "", [op]))
    for scope, ops in explicit.items():
        # The line's collective call (not the allocation before it) anchors it.
        sites.append((next((op for op in ops if _collective_family(op)), ops[0]), scope, ops))
    for scope in comp.ran_lines:
        if scope not in explicit and explicit_line(scope):
            sites.append((None, scope, []))  # the line ran and launched no op (a collective at one rank)
    sites.sort(key=lambda s: s[0].index if s[0] is not None else len(comp.ops))
    reach = _reachability(comp) if module.source == "graph" and any(s[0] is not None for s in sites) else None
    budget = dict(compute_us)
    for anchor, scope, ops in sites:
        if scope:
            row = rows[scope]
            trc, idx = module.bsym_of(scope)
            g = collective_group_size(trc.bound_symbols[idx])
            fam = collective_sym_class(row.sym)
            fam = _HLO_FAMILY.get(fam, fam)
            wire_bytes = row.comm_bytes
        else:
            _collective_fields(anchor)
            cost = hlo_op_cost(anchor) if anchor.result_bytes else None
            g, fam = anchor.group_size, anchor.family
            wire_bytes = cost.comm_bytes if cost is not None else 0.0
            if cost is None:
                report.unpriced += 1
                report.unpriced_ops.append(f"{comp.name}/{anchor.name[:60]}")
        bw = dev.ici_bw_for(fam)
        wire_us = wire_bytes / bw * 1e6 if bw else 0.0
        window = hidden = 0.0
        first_consumer = None
        if anchor is not None:
            for j in _window_of(anchor, ops, comp, reach):
                avail = budget.get(j, 0.0)
                window += compute_us.get(j, 0.0)
                if avail and hidden < wire_us:
                    take = min(avail, wire_us - hidden)
                    budget[j] = avail - take
                    hidden += take
            first_consumer = _first_consumer(anchor, ops, comp, reach)
        site = HloCollectiveSite(
            name=scope or anchor.name[:60], opcode=anchor.name[:60] if anchor is not None else "none",
            family=fam or "all-reduce", computation=comp.name, index=anchor.index if anchor is not None else -1,
            group_size=int(g), wire_bytes=wire_bytes, wire_us=wire_us, window_us=window,
            hidden_us=min(hidden, wire_us), first_consumer=first_consumer, inserted=not scope, scope=scope,
            nodes=len(ops))
        report.sites.append(site)
        agg = report.by_family.setdefault(site.family, {"count": 0, "wire_bytes": 0.0, "wire_us": 0.0, "inserted": 0})
        agg["count"] += 1
        agg["wire_bytes"] += wire_bytes
        agg["wire_us"] += wire_us
        agg["inserted"] += int(site.inserted)


def _reachability(comp: HloComputation) -> tuple[list, list]:
    """Each node's ancestors and descendants in a graph, as bit sets."""
    n = len(comp.ops)
    succ: list[list] = [[] for _ in range(n)]
    for op in comp.ops:
        for d in op.operands:
            succ[d].append(op.index)
    # Node IDs follow the capture's order, so every edge points forward.
    desc = [0] * n
    for i in range(n - 1, -1, -1):
        m = 1 << i
        for s in succ[i]:
            m |= desc[s]
        desc[i] = m
    anc = [0] * n
    for i in range(n):
        m = 1 << i
        for d in comp.ops[i].operands:
            m |= anc[d]
        anc[i] = m
    return anc, desc


def _window_of(anchor: HloOp, ops: list, comp: HloComputation, reach) -> list:
    """The ops that can run while the site's wire is busy."""
    own = {op.index for op in ops}
    if reach is not None:
        anc, desc = reach
        tied = anc[anchor.index] | desc[anchor.index]
        return [op.index for op in comp.ops if not (tied >> op.index) & 1 and op.index not in own]
    end = anchor.start + anchor.dur
    return [op.index for op in comp.ops if op.stream != anchor.stream and op.index not in own
            and op.kind not in ("collective", "sync") and op.start < end and op.start + op.dur > anchor.start]


def _first_consumer(anchor: HloOp, ops: list, comp: HloComputation, reach) -> Optional[int]:
    own = {op.index for op in ops}
    if reach is not None:
        desc = reach[1][anchor.index]
        return next((op.index for op in comp.ops if op.index not in own and (desc >> op.index) & 1), None)
    return next((op.index for op in comp.ops if op.index > anchor.index and op.index not in own
                 and op.stream == anchor.stream), None)


# =============================================================================
# Entry points
# =============================================================================


def _stages_of(fn: Any) -> list:
    """The staged programs behind ``fn``: a ``jit`` function's latest staged
    entry, a ``jit(module)``'s forward and backward, a staged step itself."""
    from thunder_tpu_torch.executors.staging import CudaGraphStage

    if isinstance(fn, CudaGraphStage):
        return [fn]
    cs = getattr(fn, "_lc_cs", None)
    if cs is not None and cs.cache_entries and isinstance(cs.cache_entries[-1].computation_fn, CudaGraphStage):
        return [cs.cache_entries[-1].computation_fn]
    out = []
    for es in getattr(fn, "_cache", {}).values():
        for e in es if isinstance(es, list) else ():
            if isinstance(e, dict) and e.get("stages") is not None:
                out = [st for st in e["stages"][:2] if isinstance(st, CudaGraphStage)]
    return out


def audit_jitted(fn: Any, *args, device: Any = None, pad_fractions: Optional[dict] = None,
                 **kwargs) -> HloScheduleReport:
    """Audit a port-compiled callable: a ``jit``, ``grad``,
    ``value_and_grad`` or ``jit(module)`` function, or a staged step
    (``build_train_step``'s, ``build_train``'s ``Train.staged``). In order:
    the report the compile phase attached to its latest entry; the graphs
    its staged programs captured last (reader (a)); with example inputs, the
    record of one real call (reader (b), :func:`audit_record`). Raises
    ``TypeError`` on anything else."""
    from thunder_tpu_torch.executors.staging import CudaGraphStage

    cs = getattr(fn, "_lc_cs", None)
    compiled = cs is not None or isinstance(fn, CudaGraphStage) or hasattr(fn, "_cache") or hasattr(fn, "staging")
    if not compiled:
        raise TypeError(f"audit_jitted needs a thunder_tpu_torch-compiled callable or staged step, got "
                        f"{type(fn).__name__}")
    if cs is not None and cs.cache_entries and getattr(cs.cache_entries[-1], "hlo_audit", None) is not None:
        return cs.cache_entries[-1].hlo_audit
    stages = _stages_of(fn)
    if stages and all(st.graph_dump is not None for st in stages):
        return audit_hlo(program_of_stages(stages), device=device, pad_fractions=pad_fractions)
    if args or kwargs:
        call = fn.eager if isinstance(fn, CudaGraphStage) else fn
        return audit_record(call, *args, device=device, pad_fractions=pad_fractions, **kwargs)
    raise TypeError("audit_jitted: no captured graph to read and no example inputs to record a call with")


# =============================================================================
# hlo.* verifier rules (advisory: INFO or WARNING, never gate a compile)
# =============================================================================

# The JAX package's thresholds (thunder_tpu/analysis/hlo_audit.py:781-785).
_HLO_EXPOSED_MIN_WIRE_US = 1.0
_HLO_LAYOUT_COPY_MIN_BYTES = float(1 << 20)
_HLO_PAD_WASTE_MIN_FRAC = 0.25


def _audit_report_of(ctx) -> Optional[HloScheduleReport]:
    tags = getattr(ctx.trace, "tags", None)
    rep = tags.get("hlo_audit") if isinstance(tags, dict) else None
    return rep if isinstance(rep, HloScheduleReport) else None


def _report_exposed(rep: HloScheduleReport, emit) -> None:
    for s in rep.sites:
        if s.wire_us < _HLO_EXPOSED_MIN_WIRE_US or s.exposed_us <= 0.0:
            continue
        kind = "inserted (launched outside the trace)" if s.inserted else "explicit"
        emit(
            "hlo.exposed-collective",
            Severity.INFO,
            f"{s.label()} [{s.family}, {kind}]: predicted {s.exposed_us:.1f}us of {s.wire_us:.1f}us wire exposed "
            f"({s.hidden_us:.1f}us hidden under the {s.window_us:.1f}us window of work that can run beside it)",
            hint="an explicit site moves with the comm scheduler (transforms/comm_schedule.py) and its "
            "future/wait placement; one launched outside the trace moves only in the code that launched it",
        )


def _report_layout_copy(rep: HloScheduleReport, emit) -> None:
    if rep.layout_copies == 0 or rep.layout_copy_bytes < _HLO_LAYOUT_COPY_MIN_BYTES:
        return
    emit(
        "hlo.layout-copy",
        Severity.INFO,
        f"{rep.layout_copies} layout copies move {rep.layout_copy_bytes / 1e6:.2f} MB through device memory in the "
        "program",
        hint="a copy is an aten op materializing a layout the program forced (a reshape of a transposed view, a "
        "contiguous operand); keep the producer's layout or let the consumer read the strided view",
    )


def _report_padding(rep: HloScheduleReport, emit) -> None:
    for label, frac in sorted(rep.pad_fractions.items()):
        if frac < _HLO_PAD_WASTE_MIN_FRAC:
            continue
        emit(
            "hlo.padding-waste",
            Severity.WARNING,
            f"bucket dim {label}: {frac * 100.0:.0f}% of the padded extent is padding — every op touching it pays "
            "full-bucket FLOPs/HBM",
            hint="a tighter BucketPolicy (smaller multiple, or pow2 → multiple) trades recompiles for less padded "
            "compute; core/bucketing.py",
        )


def _report_host_transfer(rep: HloScheduleReport, emit) -> None:
    if rep.host_transfers == 0:
        return
    ops = ", ".join(rep.host_transfer_ops[:4])
    emit(
        "hlo.host-transfer-in-step",
        Severity.WARNING,
        f"{rep.host_transfers} host transfer(s) inside the step ({ops}{'…' if rep.host_transfers > 4 else ''})",
        hint="a host round-trip serializes the device pipeline every step (and keeps an entry from staging); "
        "move the offending computation on the device or out of the step",
    )


def _make_rule(reporter):
    def rule(ctx) -> None:
        rep = _audit_report_of(ctx)
        if rep is None:
            return
        reporter(rep, lambda rule_id, sev, msg, **kw: ctx.report(rule_id, sev, msg, **kw))
    return rule


register_rule(
    "hlo.exposed-collective",
    "Collective wire time is predicted hidden in the staged graph or the op record",
)(_make_rule(_report_exposed))
register_rule(
    "hlo.layout-copy",
    "The program materializes significant layout-change copies",
)(_make_rule(_report_layout_copy))
register_rule(
    "hlo.padding-waste",
    "Bucket padding wastes a large fraction of every padded dim's compute",
)(_make_rule(_report_padding))
register_rule(
    "hlo.host-transfer-in-step",
    "The step round-trips through the host",
)(_make_rule(_report_host_transfer))
