"""Device-time attribution: a ``torch.profiler`` Chrome trace → trace lines.

The counterpart of ``thunder_tpu/observability/attribution.py``: the
*measured* half of the performance join (the *predicted* half is
``analysis/cost.py``). A program generated under
``THUNDER_ANNOTATE_TRACES=1`` (or ``THUNDER_TPU_ANNOTATE_TRACES=1``) runs
each value-producing line inside a ``record_function`` range named
``L<idx>.<sym>#<pass>`` (``core/trace.py``); this module reads the Chrome
trace that ``thunder_tpu_torch.profile()`` writes and charges measured time
back to those lines.

How a device kernel finds its line. Kernels, memcpys and memsets carry a
``correlation`` id, and so does the runtime or driver call that launched
them (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``); that
call has a timestamp on a host thread. A kernel is charged to the innermost
``L…#…`` range that contains its launch on that thread: a cuBLAS kernel and
a kernel executor's counted wrapper launch inside the range of the bound
symbol that called them, so they land on its line. (``gpu_user_annotation``
events, the ranges projected onto the device, are not read.)

A CUDA graph's replay has no ranges: every kernel of the graph carries the
correlation of its ``cudaGraphLaunch``. Those are placed through a
**launch-order map** (:func:`scope_map_of`: the seat of the JAX package's
``hlo_scope_map``/``scope_map_of``, which read scopes from HLO metadata):
the ordered ``(kernel name, scope)`` list of one annotated eager run of the
same program. The graph's kernels of one step, in device order, are placed
by position, the name checked at every position (:func:`align_to_map`): a
step that matches the map takes its scopes kernel by kernel. A step that
differs from it (records lost on the way) is placed only where one run of
missing or extra kernels explains the difference, from the start up to the
run and from the end back to it; a kernel whose place is not certain, and
every kernel of a step no such run explains, is counted unattributed and
named, never guessed. Without a map every graph kernel is unattributed.

On the CPU (no kernel events) the device is the host: each ``cpu_op``
event is charged its self time (its duration less its nested ops',
``_self_times``) to the innermost scope containing its start.

Scope parsing accepts the JAX package's three spellings:
``L<idx>.<sym>#<pass>`` (the current one), ``L<idx>.<sym>@<pass>`` and
the truncated ``L<idx>.<sym>`` (provenance lost: ``pass_name=None``).

Collectives (thunder_tpu/observability/attribution.py:60-218, :674): a
device op is a collective when its line's symbol is a collective prim
(:data:`COLLECTIVE_SYM_CLASS`) or it is an NCCL kernel (``nccl…AllReduce…``
and the like, outside any line); each is a :class:`CollectiveRow` of
``Attribution.collectives``, its time split into what kernels on other
streams of the card overlapped (hidden) and the rest (exposed), and
``PerfJoin.collectives`` joins each with the cost model's wire time
(:func:`_join_collectives`).

Not here: the JAX package's fusion groups (a kernel is charged whole to one
range).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

# Scope with provenance: L<idx>.<sym>(#|@)<pass>. Symbol names may be dotted.
_SCOPE_RE = re.compile(r"L(\d+)\.([A-Za-z_][\w.]*?)[#@]([\w]+)")
# Truncated scope: L<idx>.<sym> at a path-segment boundary.
_SCOPE_BARE_RE = re.compile(r"L(\d+)\.([A-Za-z_][\w.]*?)(?=/|$)")

# Trace-level collective symbols (distributed/prims.py) → the collective
# family their torch.distributed call runs. A line whose sym is one of these
# is a collective whatever its kernels are named (at one rank NCCL may run a
# copy, or nothing).
COLLECTIVE_SYM_CLASS = {
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "broadcast": "broadcast",
    "all_to_all": "all-to-all",
    "ppermute": "collective-permute",
    "synchronize": "all-gather",  # an fsdp gather; a replicated sync is the identity
    "hier_all_reduce": "all-reduce",
}

# NCCL's kernels: ncclDevKernel_AllReduce_Sum_bf16_RING_LL, ncclKernel_AllGather_…
_NCCL_RE = re.compile(r"nccl\w*?_(AllGather|AllReduce|ReduceScatter|Broadcast|Reduce|SendRecv|AllToAll)", re.I)
_NCCL_CLASS = {"allgather": "all-gather", "allreduce": "all-reduce", "reducescatter": "reduce-scatter",
               "broadcast": "broadcast", "reduce": "all-reduce", "sendrecv": "collective-permute",
               "alltoall": "all-to-all"}


def collective_class(name: str, refs: Sequence["ScopeRef"] = ()) -> Optional[str]:
    """The collective family of a device op ("all-gather", "all-reduce",
    ...), or None for compute: by its line's symbol when it has a line,
    else by its NCCL kernel name."""
    for ref in refs:
        if ref is not None and ref.sym in COLLECTIVE_SYM_CLASS:
            return COLLECTIVE_SYM_CLASS[ref.sym]
    m = _NCCL_RE.search(name or "")
    return _NCCL_CLASS[m.group(1).lower()] if m else None


# Event categories that are device time.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host calls that launch device work and carry its correlation id.
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass(frozen=True)
class ScopeRef:
    """One parsed ``L<idx>.<sym>[#<pass>]`` scope."""

    line: int
    sym: str
    pass_name: Optional[str] = None

    @property
    def label(self) -> str:
        p = f"#{self.pass_name}" if self.pass_name else ""
        return f"L{self.line}.{self.sym}{p}"


def parse_scope(name: str) -> Optional[ScopeRef]:
    """First scope reference in ``name`` (a range name such as
    ``L3.linear#Delete_Last_Used``), or None."""
    refs = parse_scopes(name)
    return refs[0] if refs else None


def parse_scopes(name: str) -> list[ScopeRef]:
    """Every scope reference in ``name``. Provenance-bearing matches win
    over truncated ones covering the same span."""
    if not name:
        return []
    refs: list[ScopeRef] = []
    spans: list[tuple[int, int]] = []
    for m in _SCOPE_RE.finditer(name):
        refs.append(ScopeRef(int(m.group(1)), m.group(2), m.group(3)))
        spans.append(m.span())
    for m in _SCOPE_BARE_RE.finditer(name):
        if any(a <= m.start() < b for a, b in spans):
            continue
        refs.append(ScopeRef(int(m.group(1)), m.group(2), None))
    return refs


# =============================================================================
# Trace-events loading
# =============================================================================


def find_trace_files(path: str) -> list[str]:
    """The Chrome-trace JSON file(s) under ``path``: a profile dir from
    ``thunder_tpu_torch.profile()`` (searched recursively for
    ``*.trace.json[.gz]``), or a single file."""
    if os.path.isfile(path):
        return [path]
    out: list[str] = []
    for pat in ("**/*.trace.json.gz", "**/*.trace.json"):
        out.extend(glob.glob(os.path.join(path, pat), recursive=True))
    return sorted(out)


def load_trace_events(path: str) -> list[dict]:
    """Raw trace-event dicts from one Chrome-trace JSON file (gzipped or
    plain; top-level ``{"traceEvents": [...]}`` or a bare list)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        return doc.get("traceEvents", [])
    return doc


# =============================================================================
# Attribution
# =============================================================================


@dataclass
class CollectiveRow:
    """Measured device time of one collective: one line (``L<i>.<sym>``) or,
    outside every line, one NCCL kernel name. ``hidden_us`` is the part
    that kernels on another stream of the card overlapped."""

    key: str
    cls: str
    us: float = 0.0
    hidden_us: float = 0.0
    count: int = 0

    @property
    def exposed_us(self) -> float:
        return max(0.0, self.us - self.hidden_us)

    @property
    def hidden_frac(self) -> float:
        return self.hidden_us / self.us if self.us else 0.0


@dataclass
class Attribution:
    """Measured device time aggregated per trace line / symbol / pass.

    ``ops`` keeps each (scope, op name) pair's microseconds and count (the
    kernels of a line by name; scope None: unattributed). ``mode`` is
    "cuda" (device kernels) or "cpu" (host ops' self time). ``graph_ops``
    counts the kernels that a CUDA graph's replay launched, ``graph_placed``
    those the launch-order map placed on a line, ``graph_mismatched`` the
    steps (or graph launches) whose kernels differ from the map by name or
    length."""

    by_line: dict[ScopeRef, float] = field(default_factory=dict)  # scope -> us
    counts: dict[ScopeRef, int] = field(default_factory=dict)
    by_sym: dict[str, float] = field(default_factory=dict)
    by_pass: dict[str, float] = field(default_factory=dict)
    unattributed: dict[str, float] = field(default_factory=dict)  # op name -> us
    ops: dict[tuple, list] = field(default_factory=dict)  # (scope or None, op name) -> [us, count]
    device_busy_us: float = 0.0
    idle_us: float = 0.0
    files: list[str] = field(default_factory=list)
    mode: str = "cpu"
    graph_ops: int = 0
    graph_placed: int = 0
    graph_mismatched: int = 0
    graph_steps: list = field(default_factory=list)  # graph kernels a step (or a launch), in trace order
    collectives: dict[str, CollectiveRow] = field(default_factory=dict)  # key -> row

    @property
    def collective_us(self) -> float:
        return sum(r.us for r in self.collectives.values())

    @property
    def exposed_collective_us(self) -> float:
        return sum(r.exposed_us for r in self.collectives.values())

    def collective_summary(self) -> dict[str, CollectiveRow]:
        """The collective rows summed by family."""
        out: dict[str, CollectiveRow] = {}
        for row in self.collectives.values():
            agg = out.setdefault(row.cls, CollectiveRow(key=row.cls, cls=row.cls))
            agg.us += row.us
            agg.hidden_us += row.hidden_us
            agg.count += row.count
        return out

    @property
    def attributed_us(self) -> float:
        return sum(self.by_line.values())

    @property
    def coverage(self) -> float:
        """Fraction of device time attributed to named trace lines."""
        return self.attributed_us / self.device_busy_us if self.device_busy_us else 0.0

    @property
    def with_provenance_us(self) -> float:
        return sum(us for ref, us in self.by_line.items() if ref.pass_name)

    def top(self, k: int = 10) -> list[tuple[ScopeRef, float]]:
        return sorted(self.by_line.items(), key=lambda kv: -kv[1])[:k]

    def line_ops(self, ref: ScopeRef) -> dict[str, list]:
        """``{op name: [us, count]}`` of the ops charged to ``ref``."""
        return {name: v for (r, name), v in self.ops.items() if r == ref}

    def _charge(self, ref: Optional[ScopeRef], name: str, us: float, hidden_us: float = 0.0) -> None:
        self.device_busy_us += us
        cls = collective_class(name, (ref,))
        if cls is not None:
            row = self.collectives.setdefault(ref.label if ref is not None else name,
                                              CollectiveRow(key=ref.label if ref is not None else name, cls=cls))
            row.us += us
            row.hidden_us += hidden_us
            row.count += 1
        slot = self.ops.setdefault((ref, name), [0.0, 0])
        slot[0] += us
        slot[1] += 1
        if ref is None:
            self.unattributed[name] = self.unattributed.get(name, 0.0) + us
            return
        self.by_line[ref] = self.by_line.get(ref, 0.0) + us
        self.counts[ref] = self.counts.get(ref, 0) + 1
        self.by_sym[ref.sym] = self.by_sym.get(ref.sym, 0.0) + us
        if ref.pass_name:
            self.by_pass[ref.pass_name] = self.by_pass.get(ref.pass_name, 0.0) + us

    def format(self, top_k: int = 10) -> str:
        what = "device-busy" if self.mode == "cuda" else "host op self time"
        lines = [
            f"attribution: {self.device_busy_us / 1e3:.3f} ms {what} over "
            f"{len(self.files)} trace file(s), {self.coverage * 100:.1f}% attributed "
            f"to {len(self.by_line)} trace lines"
            + (f"; graph kernels {self.graph_placed} of {self.graph_ops} placed by the launch-order map"
               f" ({self.graph_mismatched} step(s) differing from it)" if self.graph_ops else ""),
            f"  {'line':<34} {'calls':>6} {'us':>10} {'share':>7}",
        ]
        for ref, us in self.top(top_k):
            share = us / self.device_busy_us * 100 if self.device_busy_us else 0.0
            lines.append(
                f"  {ref.label:<34.34} {self.counts.get(ref, 0):>6} {us:>10.1f} {share:>6.1f}%"
            )
        if self.unattributed:
            worst = sorted(self.unattributed.items(), key=lambda kv: -kv[1])[:3]
            lines.append("  unattributed: " + ", ".join(f"{n[:60]}={us:.0f}us" for n, us in worst))
        if self.collectives:
            lines.append(f"  collectives: {self.collective_us:.1f}us, {self.exposed_collective_us:.1f}us exposed "
                         f"over {len(self.collectives)} row(s)")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()


def _self_times(ops: list[dict]) -> dict[int, float]:
    """Self time (dur minus nested children) per event, keyed by ``id(ev)``:
    host ops nest (``aten::linear`` holds ``aten::addmm``), so each is
    charged only the time not covered by a child on the same (pid, tid)."""
    return _nesting(ops)[0]


def _nesting(ops: list[dict]) -> tuple[dict[int, float], dict[int, list]]:
    """``(self times, children)``: :func:`_self_times`, and the events each
    event directly holds on its thread, by ``id`` of the holder."""
    out: dict[int, float] = {}
    parents: dict[int, list] = {}
    by_tid: dict[tuple, list[dict]] = {}
    for ev in ops:
        by_tid.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for evs in by_tid.values():
        # Parents sort before their children: earlier start first, longer
        # duration first on ties.
        evs.sort(key=lambda e: (float(e.get("ts", 0.0)), -float(e.get("dur", 0.0))))
        stack: list[tuple[float, int]] = []  # (end_ts, id) of open intervals
        for ev in evs:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
            eps = 1e-6  # float slack on interval ends
            while stack and stack[-1][0] <= ts + eps:
                stack.pop()
            out[id(ev)] = dur
            if stack:
                out[stack[-1][1]] -= dur  # direct parent loses this child's span
                parents.setdefault(stack[-1][1], []).append(ev)
            stack.append((ts + dur, id(ev)))
    return out, parents


def _innermost(ranges: list[tuple], queries: list[tuple]) -> dict:
    """For ranges ``(start, end, value)`` of one host thread, which nest,
    and queries ``(t, key)``: ``{key: value of the innermost range holding
    t}`` (None when no range does)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: dict = {}
    stack: list[tuple] = []
    i = 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _user_ranges(events: list[dict]) -> tuple[dict, dict]:
    """``(scopes, others)``: the ``record_function`` ranges by host thread,
    those whose name is a trace-line scope (value: its ScopeRef) and the
    rest (value: the event, e.g. a profiled step's range)."""
    scopes: dict[tuple, list] = {}
    others: dict[tuple, list] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "user_annotation":
            continue
        ts = float(ev.get("ts", 0.0))
        end = ts + float(ev.get("dur", 0.0))
        thread = (ev.get("pid"), ev.get("tid"))
        ref = parse_scope(str(ev.get("name", "")))
        if ref is not None:
            scopes.setdefault(thread, []).append((ts, end, ref))
        else:
            others.setdefault(thread, []).append((ts, end, id(ev)))
    return scopes, others


def _without_lead_in(events: list[dict]) -> list[dict]:
    """``events`` less what a profile session did in its lead-in range
    (``profile.LEAD_IN``): the host events inside it and the device work
    they launched."""
    from thunder_tpu_torch.observability.profile import LEAD_IN

    spans = {}
    for ev in events:
        if ev.get("cat") == "user_annotation" and ev.get("name") == LEAD_IN:
            ts = float(ev.get("ts", 0.0))
            spans.setdefault((ev.get("pid"), ev.get("tid")), []).append((ts, ts + float(ev.get("dur", 0.0))))
    if not spans:
        return events

    def inside(ev) -> bool:
        t = float(ev.get("ts", 0.0))
        return any(a <= t < b for a, b in spans.get((ev.get("pid"), ev.get("tid")), ()))

    dropped = {(ev.get("args") or {}).get("correlation") for ev in events
               if ev.get("cat") in _LAUNCH_CATS and inside(ev)}
    return [ev for ev in events
            if not (ev.get("cat") in _DEVICE_CATS and (ev.get("args") or {}).get("correlation") in dropped)
            and not (ev.get("ph") == "X" and ev.get("cat") not in _DEVICE_CATS and inside(ev))]


def _device_ops(events: list[dict]) -> list[dict]:
    return [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS]


def _launches(events: list[dict]) -> dict:
    """Correlation id → the host call that launched the device work."""
    out = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in _LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                out[corr] = ev
    return out


def _is_graph_launch(ev: Optional[dict]) -> bool:
    return ev is not None and "GraphLaunch" in str(ev.get("name", ""))


def _scoped_device_ops(events: list[dict]) -> list[tuple[dict, Optional[ScopeRef], Optional[dict]]]:
    """Each device op with the scope its launch sat in (None outside every
    scope, and for a graph's kernels) and its launching host call."""
    ops = _device_ops(events)
    launches = _launches(events)
    scopes, _ = _user_ranges(events)
    queries: dict[tuple, list] = {}
    for ev in ops:
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        if launch is not None and not _is_graph_launch(launch):
            queries.setdefault((launch.get("pid"), launch.get("tid")), []).append(
                (float(launch.get("ts", 0.0)), id(ev)))
    found: dict = {}
    for thread, qs in queries.items():
        found.update(_innermost(scopes.get(thread, []), qs))
    return [(ev, found.get(id(ev)), launches.get((ev.get("args") or {}).get("correlation"))) for ev in ops]


LaunchMap = list  # [(op name, scope label or None)] of one call, in device order

# A collective's own work on the CPU: gloo's (and NCCL's) range on its thread.
_COMM_RANGE_RE = re.compile(r"^(gloo|nccl):")
# Host ops that only make a view or an empty tensor: no work of their own.
INERT_OPS = frozenset({
    "aten::view", "aten::reshape", "aten::_reshape_alias", "aten::_unsafe_view", "aten::as_strided", "aten::t",
    "aten::transpose", "aten::permute", "aten::expand", "aten::unsqueeze", "aten::squeeze", "aten::select",
    "aten::slice", "aten::narrow", "aten::split", "aten::chunk", "aten::unbind", "aten::detach", "aten::alias",
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::resolve_conj", "aten::resolve_neg",
    "aten::lift_fresh", "aten::set_", "aten::resize_", "aten::numpy_T", "aten::view_as", "aten::expand_as",
})
# Host ops whose work is their own, whatever ops they hold: a product
# (addmm's copy of its bias into the output is the product's), a read of a
# value to the host.
WHOLE_OPS = frozenset({"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm", "aten::addmv",
                       "aten::mv", "aten::dot", "aten::_scaled_mm", "aten::item"})


@dataclass
class RecordOp:
    """One op of a profiler record, in the order it started: a device op
    (kernel, memcpy, memset) on the card, a leaf host op (an ``aten::`` op
    holding no other) on the CPU. ``scope``: the line whose range held its
    launch (the op itself on the CPU); ``launch``: the host call that
    launched a device op; ``host_op``: the op whose call launched it (its
    recorded input shapes and types), the op itself on the CPU."""

    event: dict
    scope: Optional[ScopeRef]
    launch: Optional[dict]
    host_op: Optional[dict]
    device: bool


def record_ops(events: list[dict]) -> list[RecordOp]:
    """The ops of one profiled call's trace events, a session's lead-in
    (``profile.LEAD_IN``) left out: the one reading that the launch-order map
    (:func:`launch_map_of_events`) and the compiled-program auditor's op
    record (``analysis/hlo_audit.ops_of_record``) share. On the card, each
    device op with its scope and the innermost ``cpu_op`` holding its launch
    on that thread; on the CPU (no device ops), each ``cpu_op`` that did the
    work, not the ones that called it: an op holding no op but views and
    allocations (:data:`INERT_OPS`), or a product or a host read
    (:data:`WHOLE_OPS`, the ops it holds left out), with the innermost scope holding its start; ops
    inside a collective's own range (``gloo:…``, ``nccl:…``, on the
    library's thread) left out."""
    events = _without_lead_in(events)
    host = [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") == "cpu_op"]
    by_thread: dict[tuple, list] = {}
    for ev in host:
        ts = float(ev.get("ts", 0.0))
        by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append((ts, ts + float(ev.get("dur", 0.0)), ev))
    if _device_ops(events):
        scoped = _scoped_device_ops(events)
        queries: dict[tuple, list] = {}
        for ev, _, launch in scoped:
            if launch is not None:
                queries.setdefault((launch.get("pid"), launch.get("tid")), []).append(
                    (float(launch.get("ts", 0.0)), id(ev)))
        held: dict = {}
        for thread, qs in queries.items():
            held.update(_innermost(by_thread.get(thread, []), qs))
        out = [RecordOp(ev, ref, launch, held.get(id(ev)), True) for ev, ref, launch in scoped]
    else:
        _, children = _nesting(host)
        inner: set = set()
        stack = [c for ev in host if ev.get("name") in WHOLE_OPS for c in children.get(id(ev), ())]
        while stack:
            ev = stack.pop()
            inner.add(id(ev))
            stack += children.get(id(ev), ())
        comm: dict[tuple, list] = {}
        for ev in events:
            if ev.get("ph") == "X" and _COMM_RANGE_RE.match(str(ev.get("name", ""))):
                ts = float(ev.get("ts", 0.0))
                comm.setdefault((ev.get("pid"), ev.get("tid")), []).append((ts, ts + float(ev.get("dur", 0.0))))
        leaves = [ev for ev in host if id(ev) not in inner
                  and (ev.get("name") in WHOLE_OPS or all(c.get("name") in INERT_OPS for c in children.get(id(ev), ())))
                  and not any(a <= float(ev.get("ts", 0.0)) < b for a, b in comm.get((ev.get("pid"), ev.get("tid")), ()))]
        scopes, _ = _user_ranges(events)
        queries = {}
        for ev in leaves:
            queries.setdefault((ev.get("pid"), ev.get("tid")), []).append((float(ev.get("ts", 0.0)), id(ev)))
        found: dict = {}
        for thread, qs in queries.items():
            found.update(_innermost(scopes.get(thread, []), qs))
        out = [RecordOp(ev, found.get(id(ev)), None, ev, False) for ev in leaves]
    out.sort(key=lambda r: float(r.event.get("ts", 0.0)))
    return out


def launch_map_of_events(events: list[dict]) -> LaunchMap:
    """The launch-order map of one annotated eager call's trace events: each
    device op in the order it started on the device, with its scope's
    label; a session's lead-in (``profile.LEAD_IN``) left out."""
    return [(str(r.event.get("name", "")), r.scope.label if r.scope is not None else None)
            for r in record_ops(events) if r.device]


def launch_map_of_trace(source: str) -> LaunchMap:
    """:func:`launch_map_of_events` of the profile at ``source`` (a trace
    dir of one session, or its Chrome-trace file)."""
    out: LaunchMap = []
    for path in find_trace_files(source):
        out += launch_map_of_events(load_trace_events(path))
    return out


def align_to_map(names: Sequence[str], map_names: Sequence[str], map_refs: Sequence) -> dict[int, Any]:
    """``{position in names: map ref}`` of the kernels whose place in the map
    is certain. Equal lengths: every position, if every name matches, else
    none. Otherwise the longer of the two is read as the shorter with one
    run of kernels added (records lost from the other): position i, in the
    prefix that matches the map from the start, is map position i; in the
    suffix that matches from the end, map position i + len(map) -
    len(names). Where the two cover the shorter whole, a position in one of
    them takes its ref, and a position in both only when both give the same
    ref (the run sits where names repeat, so its place is not known); the
    added run is placed nowhere. Where they do not cover it, more than one
    run differs: none is placed."""
    n, m = len(names), len(map_names)
    if n == m:
        return {i: r for i, r in enumerate(map_refs) if r is not None} if list(names) == list(map_names) else {}
    pre = 0
    while pre < min(n, m) and names[pre] == map_names[pre]:
        pre += 1
    suf = 0
    while suf < min(n, m) and names[n - 1 - suf] == map_names[m - 1 - suf]:
        suf += 1
    if pre + suf < min(n, m):
        return {}
    placed = {}
    for i in range(n):
        refs = ([map_refs[i]] if i < pre else []) + ([map_refs[i + m - n]] if i >= n - suf else [])
        if refs and refs[0] is not None and all(r == refs[0] for r in refs):
            placed[i] = refs[0]
    return placed


def _hidden_fn(ops: list[dict]) -> Callable[[dict], float]:
    """``hidden(ev)``: the microseconds of device op ``ev`` that compute ops
    on the card's other streams overlapped (the union of their intervals,
    NCCL's own kernels left out), the JAX package's hidden lane time."""
    import bisect

    streams: dict[Any, list] = {}
    for ev in ops:
        if _NCCL_RE.search(str(ev.get("name", ""))):
            continue
        ts = float(ev.get("ts", 0.0))
        streams.setdefault(ev.get("tid"), []).append((ts, ts + float(ev.get("dur", 0.0))))
    starts = {}
    for tid, ivs in streams.items():
        ivs.sort()
        starts[tid] = [a for a, _ in ivs]

    def hidden(ev: dict) -> float:
        a = float(ev.get("ts", 0.0))
        b = a + float(ev.get("dur", 0.0))
        cut = []
        for tid, ivs in streams.items():
            if tid == ev.get("tid"):
                continue
            # A stream's ops do not overlap: walk back from the last one that
            # starts before ev ends to the first that ends before it starts.
            j = bisect.bisect_left(starts[tid], b) - 1
            while j >= 0 and ivs[j][1] > a:
                cut.append((max(a, ivs[j][0]), min(b, ivs[j][1])))
                j -= 1
        total, end = 0.0, a
        for x, y in sorted(cut):
            if y > end:
                total += y - max(x, end)
                end = y
        return total

    return hidden


def _place_graph_ops(attr: Attribution, graph_ops: list, launch_map: Optional[LaunchMap],
                     step_of: dict, hidden: Optional[Callable] = None) -> None:
    """Charge a graph replay's kernels through the launch-order map: the
    kernels of each step (or of each graph launch, outside any step range)
    in device order, placed by :func:`align_to_map`."""
    groups: dict[Any, list] = {}
    for ev, launch in graph_ops:
        key = step_of.get(id(launch))
        if key is None:
            key = ("launch", (ev.get("args") or {}).get("correlation"))
        groups.setdefault(key, []).append(ev)
    map_names = [n for n, _ in launch_map] if launch_map else []
    map_refs = [parse_scope(s) if s else None for _, s in launch_map] if launch_map else []
    for evs in groups.values():
        evs.sort(key=lambda e: float(e.get("ts", 0.0)))
        names = [str(e.get("name", "")) for e in evs]
        placed = align_to_map(names, map_names, map_refs) if map_names else {}
        attr.graph_ops += len(evs)
        attr.graph_placed += len(placed)
        attr.graph_mismatched += bool(map_names) and names != map_names
        attr.graph_steps.append(len(evs))
        for i, ev in enumerate(evs):
            ref = placed.get(i)
            attr._charge(ref, names[i], float(ev.get("dur", 0.0)),
                         hidden(ev) if hidden is not None and collective_class(names[i], (ref,)) else 0.0)

def attribute(source: str, *, launch_map: Optional[LaunchMap] = None) -> Attribution:
    """Aggregate measured time per trace line from the profile at ``source``
    (a ``thunder_tpu_torch.profile()`` trace dir, or one Chrome-trace JSON
    file). ``launch_map`` (:func:`scope_map_of`) places a CUDA graph's
    kernels; without it they are unattributed."""
    files = find_trace_files(source)
    if not files:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {source!r}")
    attr = Attribution(files=files)
    for path in files:
        events = _without_lead_in(load_trace_events(path))
        if _device_ops(events):
            attr.mode = "cuda"
            _, others = _user_ranges(events)
            hidden = _hidden_fn(_device_ops(events))
            graph_ops = []
            queries: dict[tuple, list] = {}
            for ev, ref, launch in _scoped_device_ops(events):
                if _is_graph_launch(launch):
                    graph_ops.append((ev, launch))
                    queries.setdefault((launch.get("pid"), launch.get("tid")), []).append(
                        (float(launch.get("ts", 0.0)), id(launch)))
                else:
                    name = str(ev.get("name", ""))
                    attr._charge(ref, name, float(ev.get("dur", 0.0)),
                                 hidden(ev) if collective_class(name, (ref,)) else 0.0)
            # A graph launch's step: the innermost other range holding it
            # (profile()'s step range). A backward's graph launches from
            # autograd's own thread, inside the step the caller's thread
            # holds: its step is the range of its process holding its time.
            step_of: dict = {}
            for thread, qs in queries.items():
                step_of.update(_innermost(others.get(thread, []), qs))
            for thread, qs in queries.items():
                lost = [q for q in qs if step_of.get(q[1]) is None]
                spans = [r for t, rs in others.items() if t[0] == thread[0] and t != thread for r in rs]
                if lost and spans:
                    step_of.update({k: v for k, v in _innermost(spans, lost).items() if v is not None})
            _place_graph_ops(attr, graph_ops, launch_map, step_of, hidden)
            continue
        # The CPU: host ops' self time, each charged to the innermost scope
        # holding its start.
        ops = [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") == "cpu_op"]
        self_us = _self_times(ops)
        scopes, _ = _user_ranges(events)
        queries = {}
        for ev in ops:
            queries.setdefault((ev.get("pid"), ev.get("tid")), []).append((float(ev.get("ts", 0.0)), id(ev)))
        found: dict = {}
        for thread, qs in queries.items():
            found.update(_innermost(scopes.get(thread, []), qs))
        for ev in ops:
            us = self_us[id(ev)]
            if us > 0.0:
                attr._charge(found.get(id(ev)), str(ev.get("name", "")), us)
    return attr


@contextmanager
def eager_stages(fn: Any):
    """Within the block, every staged entry of the ``jit``-compiled ``fn``
    (a function, or a module: its forward and backward stages) runs its
    stage's eager program (the same annotated program, each line in its
    range), so a profiled call launches its kernels where attribution sees
    their lines; the stages are put back after, their graphs untouched.
    Nothing for any other callable."""
    from thunder_tpu_torch.executors.staging import CudaGraphStage

    def eager(stage):
        return stage.eager if isinstance(stage, CudaGraphStage) else stage

    cs = getattr(fn, "_lc_cs", None)
    swapped = [] if cs is None else [
        (e, e.computation_fn) for e in cs.cache_entries if isinstance(e.computation_fn, CudaGraphStage)]
    modules = [e for es in getattr(fn, "_cache", {}).values() if isinstance(es, list) for e in es
               if isinstance(e, dict) and e.get("stages") is not None]
    saved = [e["stages"] for e in modules]
    try:
        for entry, stage in swapped:
            entry.computation_fn = stage.eager
        for e in modules:
            fwd, bwd, fstats, bstats = e["stages"]
            e["stages"] = (eager(fwd), eager(bwd), fstats, bstats)
        yield
    finally:
        for entry, stage in swapped:
            entry.computation_fn = stage
        for e, stages in zip(modules, saved):
            e["stages"] = stages


def scope_map_of(fn: Callable, *args, **kwargs) -> LaunchMap:
    """The launch-order map of ``fn``: one call of its annotated program,
    run eagerly under ``torch.profiler`` (CPU and CUDA), each device op in
    order with the scope it was launched in. ``fn`` is the eager program
    (e.g. ``Train.step_eager``), or a ``jit``-compiled function, whose staged
    entries run their eager program here (:func:`eager_stages`). The
    program must have been generated with ``THUNDER_ANNOTATE_TRACES=1``.
    The call is a real one: a training step updates its params, a program
    with random draws takes the next key."""
    from thunder_tpu_torch.observability.profile import traced

    with tempfile.TemporaryDirectory(prefix="thunder_launch_map_") as d:
        path = os.path.join(d, "eager.trace.json")
        with eager_stages(fn), traced(path):
            fn(*args, **kwargs)
        out = launch_map_of_trace(path)
    if not out:
        raise RuntimeError("scope_map_of: the eager call launched no device work")
    return out


# =============================================================================
# Roofline join (predicted × measured)
# =============================================================================


@dataclass
class JoinedRow:
    """One trace line with both its measured time and its static roofline
    bound."""

    label: str
    sym: str
    line: int
    pass_name: Optional[str]
    measured_us: float  # per profiled step
    share: float  # of device-busy time
    calls: float = 0.0  # device ops per step
    roofline_us: Optional[float] = None
    efficiency: Optional[float] = None  # roofline/measured, 1.0 = at the roof
    bound: Optional[str] = None  # operations|bytes|free
    flops: Optional[float] = None
    bytes_moved: Optional[float] = None


@dataclass
class CollectiveJoin:
    """One collective row (per step) beside ``cost.py``'s wire time for it:
    a line's own, or, for NCCL kernels outside any line, its family's."""

    key: str
    cls: str
    count: float
    us: float
    hidden_us: float
    exposed_us: float
    predicted_wire_us: Optional[float] = None


@dataclass
class PerfJoin:
    """The joined report: measured lines annotated with predicted cost,
    roofline ratio and boundedness, and the collective rows."""

    rows: list[JoinedRow]
    attribution: Attribution
    cost: Optional[Any] = None  # TraceCost, or {pass tag: TraceCost}
    steps: int = 1
    measured_step_us: float = 0.0
    mfu: Optional[float] = None
    padding_waste_elements: Optional[float] = None
    collectives: list[CollectiveJoin] = field(default_factory=list)

    def format(self, top_k: int = 10) -> str:
        a = self.attribution
        lines = [
            f"perf attribution: {self.measured_step_us / 1e3:.3f} ms device-busy/step "
            f"({self.steps} step(s) profiled), {a.coverage * 100:.1f}% attributed",
        ]
        costs = _costs(self.cost)
        if costs:
            dev = costs[0].device
            flops = sum(c.total_flops for c in costs)
            roof = sum(c.roofline_s for c in costs)
            lines.append(
                f"  cost model [{dev.name}]: {flops / 1e9:.2f} GFLOP/step, roofline bound {roof * 1e3:.3f} ms"
                + (f", MFU at measured time {self.mfu * 100:.1f}%" if self.mfu is not None else "")
            )
        if self.padding_waste_elements:
            lines.append(
                f"  bucket padding waste: {self.padding_waste_elements:.3g} elements "
                "dispatched beyond true extents (thunder_tpu_padding_waste_elements_total)"
            )
        lines.append(
            f"  {'line':<34} {'us/step':>9} {'share':>7} {'roofline':>9} {'eff':>6} {'bound':>10}"
        )
        for r in self.rows[:top_k]:
            roof = f"{r.roofline_us:.1f}" if r.roofline_us is not None else "-"
            eff = f"{r.efficiency * 100:.0f}%" if r.efficiency is not None else "-"
            lines.append(
                f"  {r.label:<34.34} {r.measured_us:>9.1f} {r.share * 100:>6.1f}% "
                f"{roof:>9} {eff:>6} {r.bound or '-':>10}"
            )
        if a.unattributed:
            worst = sorted(a.unattributed.items(), key=lambda kv: -kv[1])[:3]
            lines.append("  unattributed: " + ", ".join(
                f"{n[:60]}={us / self.steps:.0f}us" for n, us in worst))
        if self.collectives:
            lines.append("  collectives (us/step):")
            lines.append(f"  {'collective':<34} {'n':>5} {'measured':>9} {'hidden':>8} {'exposed':>8} {'predicted':>10}")
            for c in self.collectives:
                pred = f"{c.predicted_wire_us:.1f}" if c.predicted_wire_us is not None else "-"
                lines.append(f"  {c.key:<34.34} {c.count:>5g} {c.us:>9.1f} {c.hidden_us:>8.1f} {c.exposed_us:>8.1f} "
                             f"{pred:>10}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()


def _costs(cost: Any) -> list:
    if cost is None:
        return []
    return list(cost.values()) if isinstance(cost, dict) else [cost]


def trace_costs(traces: Sequence, device: Any = None) -> dict:
    """``{pass tag: TraceCost}`` of the traces one step runs (a split
    step's forward and backward), keyed as their scopes name them."""
    from thunder_tpu_torch.analysis.cost import trace_cost

    return {trc._annotate_tag(): trace_cost(trc, device) for trc in traces}


def _join_collectives(attr: Attribution, cost: Optional[Any], steps: int) -> list[CollectiveJoin]:
    """The collective rows a step, each beside its wire time on the cost's
    spec (thunder_tpu/observability/attribution.py:674): a line's row joins
    its cost row by (line, symbol) in its pass's trace; the NCCL kernels
    outside any line join, by family, the wire time of every collective of
    that family in the traces, when no line row exists."""
    if not attr.collectives:
        return []
    by_line: dict[tuple, float] = {}
    by_cls: dict[str, float] = {}
    for tag, c in (cost.items() if isinstance(cost, dict) else [(None, cost)] if cost is not None else []):
        for r in c.rows:
            if r.kind != "collective" or not r.comm_bytes:
                continue
            us = r.roofline_s * 1e6
            by_line[(tag, r.index, r.sym)] = us
            cls = COLLECTIVE_SYM_CLASS.get(r.sym)
            if cls is not None:
                by_cls[cls] = by_cls.get(cls, 0.0) + us
    out = []
    scoped = {k: v for k, v in attr.collectives.items() if parse_scope(k) is not None}
    for key, row in sorted(attr.collectives.items(), key=lambda kv: -kv[1].us):
        ref = parse_scope(key)
        if ref is not None:
            pred = by_line.get((ref.pass_name if isinstance(cost, dict) else None, ref.line, ref.sym))
        else:
            pred = None if scoped else by_cls.get(row.cls)
        out.append(CollectiveJoin(key=key, cls=row.cls, count=row.count / steps, us=row.us / steps,
                                  hidden_us=row.hidden_us / steps, exposed_us=row.exposed_us / steps,
                                  predicted_wire_us=pred))
    return out


def join_cost_attribution(
    attr: Attribution,
    cost: Optional[Any] = None,
    *,
    steps: int = 1,
) -> PerfJoin:
    """Join measured per-line time with the static cost model.

    ``cost`` is a ``TraceCost`` of the executed trace, or ``{pass tag:
    TraceCost}`` (:func:`trace_costs`) for a step of several traces, each
    scope then matched in its own trace's rows. Lines match on (index,
    symbol); a line that moved between passes falls back to a symbol-name
    match when the symbol is unique. ``steps`` divides measured totals down
    to per-step numbers comparable with the per-call bounds."""
    steps = max(1, steps)
    tables: dict[Optional[str], tuple[dict, dict]] = {}
    for tag, c in (cost.items() if isinstance(cost, dict) else [(None, cost)] if cost is not None else []):
        by_line: dict[tuple[int, str], Any] = {}
        by_sym: dict[str, list] = {}
        for r in c.rows:
            by_line[(r.index, r.sym)] = r
            by_sym.setdefault(r.sym, []).append(r)
        tables[tag] = (by_line, by_sym)

    rows: list[JoinedRow] = []
    for ref, us in sorted(attr.by_line.items(), key=lambda kv: -kv[1]):
        measured = us / steps
        row = JoinedRow(
            label=ref.label, sym=ref.sym, line=ref.line, pass_name=ref.pass_name,
            measured_us=measured, calls=attr.counts.get(ref, 0) / steps,
            share=us / attr.device_busy_us if attr.device_busy_us else 0.0,
        )
        by_line, by_sym = tables.get(ref.pass_name if isinstance(cost, dict) else None, ({}, {}))
        crow = by_line.get((ref.line, ref.sym))
        if crow is None and len(by_sym.get(ref.sym, [])) == 1:
            crow = by_sym[ref.sym][0]
        if crow is not None:
            row.roofline_us = crow.roofline_s * 1e6
            row.bound = crow.bound
            row.flops = crow.flops
            row.bytes_moved = crow.bytes_moved
            if measured > 0:
                row.efficiency = min(1.0, row.roofline_us / measured)
        rows.append(row)

    join = PerfJoin(
        rows=rows, attribution=attr, cost=cost, steps=steps,
        measured_step_us=attr.device_busy_us / steps,
    )
    join.collectives = _join_collectives(attr, cost, steps)
    costs = _costs(cost)
    if costs and attr.device_busy_us:
        peak = costs[0].device.peak_flops["bf16"]
        join.mfu = sum(c.total_flops for c in costs) / (attr.device_busy_us / steps / 1e6 * peak)
    from thunder_tpu_torch.observability import metrics as obsm

    if obsm.enabled():
        waste = obsm.PADDING_WASTE_ELEMENTS.value()
        if waste:
            join.padding_waste_elements = float(waste)
    return join
