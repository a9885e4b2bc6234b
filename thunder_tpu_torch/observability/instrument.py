"""Per-op instrumentation transform over execution traces.

The counterpart of ``thunder_tpu/observability/instrument.py``: every
value-producing bound symbol of a claimed execution trace is bracketed with
host pre/post callback prims, so hooks observe the concrete outputs of each
op together with its bound symbol's name, generated trace line and pass
provenance.

An instrumented entry runs unstaged (the hooks are host side effects a CUDA
graph cannot hold: ``api._compile_entry`` gives the staging predicate its
reason), eagerly on the device the jit runs on, the card unless the caller
asked for the CPU. With no hook asked for nothing is inserted and the entry
stages as usual.

Built-in hooks:

- :class:`NaNWatcher`: ``jit(fn, debug_watch="nan")`` raises (or warns,
  ``action="warn"``) at the first op whose output turns NaN/Inf, naming its
  bound symbol, trace line and pass provenance. It reads each output's
  verdict on the host, one read an op.
- :class:`OpTimer`: per-op times. On the CPU, the host's wall time of the
  op (dispatch and compute), as the JAX package's. On the card, the op's
  device time: a sleep kernel holds the card while the host enqueues the op,
  and two CUDA events around the op time what the card spends on it, then a
  synchronize; an op whose launches outran the sleep is counted in
  ``host_gaps`` (its time then holds some of the host's) and the sleep
  doubles for the next op, up to ``OpTimer.MAX_SLEEP_S``: an op that
  synchronizes inside (a host read) outruns any sleep, and is counted a
  gap at the cap.
- :class:`MemoryHighWater`: peak device memory and the op during which it
  was reached: on the card ``torch.cuda.max_memory_allocated`` read after
  each op (the allocator's high-water mark, so a peak inside an op counts);
  elsewhere the JAX package's estimate, the cumulative bytes of the outputs
  (an upper bound that ignores frees).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, wrap_in_trace_provenance
from thunder_tpu_torch.observability import metrics as obsm
from thunder_tpu_torch.observability.events import emit_event


@dataclass(frozen=True)
class OpRecord:
    """What a hook learns about the op it brackets."""

    index: int  # bound-symbol index in the instrumented trace's source
    sym_name: str
    executor: Optional[str]
    line: str  # the generated trace line
    provenance: Optional[str]  # which pass produced the trace being run
    trace_name: str
    device: Optional[str] = None  # "cuda"/"cpu": the device of the op's first tensor output


class InstrumentationHook:
    """Base class: override either or both callbacks. ``outputs`` is the
    tuple of concrete flat proxy outputs (tensors, numbers)."""

    def on_op_start(self, rec: OpRecord) -> None:  # pragma: no cover - trivial
        pass

    def on_op_end(self, rec: OpRecord, outputs: tuple) -> None:  # pragma: no cover
        pass

    def report(self) -> dict:
        return {}


class CallbackHook(InstrumentationHook):
    """Wrap a bare ``fn(rec, outputs)`` callable as a post-op hook."""

    def __init__(self, fn: Callable[[OpRecord, tuple], None]):
        self._fn = fn

    def on_op_end(self, rec: OpRecord, outputs: tuple) -> None:
        self._fn(rec, outputs)


class NaNWatchError(RuntimeError):
    """A watched trace produced a NaN/Inf. Carries the attribution."""

    def __init__(self, kind: str, rec: OpRecord, out_index: int):
        self.kind = kind
        self.sym_name = rec.sym_name
        self.trace_line = rec.line
        self.provenance = rec.provenance
        self.bsym_index = rec.index
        super().__init__(
            f"{kind} detected in output {out_index} of BoundSymbol "
            f"{rec.sym_name!r} (bsym {rec.index} of trace {rec.trace_name!r})\n"
            f"    >> {rec.line}\n"
            f"    produced by pass: {rec.provenance or 'unknown'}"
        )


def _nonfinite_kind(x: Any, watch_nan: bool, watch_inf: bool) -> Optional[str]:
    if not isinstance(x, torch.Tensor) or not (x.is_floating_point() or x.is_complex()):
        return None
    if watch_nan and bool(torch.isnan(x).any()):
        return "NaN"
    if watch_inf and bool(torch.isinf(x).any()):
        return "Inf"
    return None


class NaNWatcher(InstrumentationHook):
    """``mode``: "nan", "inf", or "nan+inf". ``action``: "raise" (default)
    or "warn" (log every trip, keep executing)."""

    def __init__(self, mode: str = "nan", action: str = "raise"):
        mode = mode.lower()
        if mode not in ("nan", "inf", "nan+inf", "inf+nan", "both"):
            raise ValueError(f"debug_watch: unknown mode {mode!r} (nan|inf|nan+inf)")
        self.watch_nan = "nan" in mode or mode == "both"
        self.watch_inf = "inf" in mode or mode == "both"
        if action not in ("raise", "warn"):
            raise ValueError(f"debug_watch action must be 'raise' or 'warn', got {action!r}")
        self.action = action
        self.trips: list[dict] = []

    def on_op_end(self, rec: OpRecord, outputs: tuple) -> None:
        for i, x in enumerate(outputs):
            kind = _nonfinite_kind(x, self.watch_nan, self.watch_inf)
            if kind is None:
                continue
            obsm.NAN_WATCH_TRIPS.inc(symbol=rec.sym_name)
            emit_event(
                "nan_watch", value_kind=kind, symbol=rec.sym_name,
                bsym_index=rec.index, line=rec.line, provenance=rec.provenance,
            )
            err = NaNWatchError(kind, rec, i)
            if self.action == "raise":
                raise err
            self.trips.append(
                {"kind": kind, "symbol": rec.sym_name, "bsym_index": rec.index,
                 "line": rec.line, "provenance": rec.provenance}
            )
            import warnings

            warnings.warn(str(err), RuntimeWarning, stacklevel=2)

    def report(self) -> dict:
        return {"trips": list(self.trips)}


class OpTimer(InstrumentationHook):
    """Time per op, keyed by symbol name (see the module docstring: wall
    time on the CPU, the op's device time on the card). ``sleep_s`` is the
    first sleep on the card; it doubles after a host gap, up to
    ``MAX_SLEEP_S``."""

    MAX_SLEEP_S = 5e-3

    def __init__(self, sleep_s: float = 2e-4):
        self.times_s: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.host_gaps = 0
        self._sleep_s = sleep_s
        self._t0: float = 0.0
        self._start = None

    def on_op_start(self, rec: OpRecord) -> None:
        self._start = None
        if rec.device == "cuda":
            # The card holds at the sleep while the host enqueues the op, so
            # the events time the op's kernels, not the host's launches.
            torch.cuda._sleep(int(self._sleep_s * 2e9))  # cycles; the H100 clocks below 2 GHz
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()

    def on_op_end(self, rec: OpRecord, outputs: tuple) -> None:
        if self._start is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            if self._start.query():  # the card woke before the op was queued
                self.host_gaps += 1
                self._sleep_s = min(2 * self._sleep_s, self.MAX_SLEEP_S)
            stop.synchronize()
            dt = self._start.elapsed_time(stop) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        key = rec.sym_name
        self.times_s[key] = self.times_s.get(key, 0.0) + dt
        self.counts[key] = self.counts.get(key, 0) + 1
        obsm.INSTRUMENTED_OP_US.observe(dt * 1e6, symbol=key)

    def report(self) -> dict:
        total = sum(self.times_s.values()) or 1.0
        top = sorted(self.times_s.items(), key=lambda kv: -kv[1])
        return {
            "total_s": sum(self.times_s.values()),
            "host_gaps": self.host_gaps,
            "ops": [
                {"symbol": k, "total_s": v, "calls": self.counts[k],
                 "pct": 100.0 * v / total}
                for k, v in top
            ],
        }


class MemoryHighWater(InstrumentationHook):
    """Peak device memory across the instrumented run, with the op during
    which it was reached (see the module docstring). ``exact`` says whether
    the allocator was read (the card) or the outputs' bytes estimated."""

    def __init__(self):
        self.peak_bytes = 0
        self.peak_op: Optional[str] = None
        self._estimate = 0
        # Resolved once, on the first op: mixing allocator bytes with a
        # from-zero estimate would corrupt the peak comparison.
        self.exact: Optional[bool] = None

    def on_op_end(self, rec: OpRecord, outputs: tuple) -> None:
        if self.exact is None:
            self.exact = rec.device == "cuda"
        if self.exact:
            used = int(torch.cuda.max_memory_allocated())
        else:
            self._estimate += sum(
                int(x.numel() * x.element_size()) for x in outputs if isinstance(x, torch.Tensor)
            )
            used = self._estimate
        if used > self.peak_bytes:
            self.peak_bytes = used
            self.peak_op = rec.sym_name
            obsm.DEVICE_MEM_HIGH_WATER.set_max(used)

    def report(self) -> dict:
        return {"peak_bytes": self.peak_bytes, "peak_op": self.peak_op,
                "exact": bool(self.exact)}


# -- the transform ------------------------------------------------------------

# Plumbing prims that produce no device value worth observing.
_SKIP_IDS = {
    PrimIDs.DEL, PrimIDs.RETURN, PrimIDs.COMMENT,
    PrimIDs.UNPACK_TRIVIAL, PrimIDs.UNPACK_SEQUENCE, PrimIDs.UNPACK_KEY,
    PrimIDs.UNPACK_ATTR, PrimIDs.UNPACK_DIM,
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    PrimIDs.CHECK_STRING_VALUE, PrimIDs.CHECK_LEN, PrimIDs.CHECK_KEYS,
    PrimIDs.CHECK_NONE, PrimIDs.CHECK_DIM_BUCKET,
}


def instrument_for_execution(
    extrace: TraceCtx, hooks: Sequence[InstrumentationHook]
) -> TraceCtx:
    """Bracket every value-producing bound symbol of ``extrace`` with
    ``instrument_pre``/``instrument_post`` host prims that dispatch to
    ``hooks``. Returns a new trace (provenance: "Instrumentation")."""
    start = time.perf_counter_ns()
    hooks = tuple(hooks)
    records: dict[int, OpRecord] = {}
    provenance = extrace.pass_name()

    def pre_impl(idx: int) -> None:
        rec = records[idx]
        for h in hooks:
            h.on_op_start(rec)

    def post_impl(idx: int, *outs) -> None:
        rec = records[idx]
        for h in hooks:
            h.on_op_end(rec, outs)

    # SIDE_EFFECT keeps DCE/CSE and the verifier's dead-symbol rule from
    # touching the brackets; python_impl is what the generated code calls.
    pre_sym = Symbol(
        "instrument_pre", meta=None, id="observability.instrument_pre",
        is_prim=True, python_impl=pre_impl, tags=(OpTags.SIDE_EFFECT, OpTags.DONT_DCE),
    )
    post_sym = Symbol(
        "instrument_post", meta=None, id="observability.instrument_post",
        is_prim=True, python_impl=post_impl, tags=(OpTags.SIDE_EFFECT, OpTags.DONT_DCE),
    )

    new_bsyms: list[BoundSymbol] = []
    for i, bsym in enumerate(extrace.bound_symbols):
        outs = bsym.flat_proxy_outs
        if bsym.sym.id in _SKIP_IDS or not outs:
            new_bsyms.append(bsym)
            continue
        ex = bsym.sym.executor
        dev = next((o.device for o in outs if isinstance(o, TensorProxy)), None)
        records[i] = OpRecord(
            index=i,
            sym_name=bsym.sym.name,
            executor=ex.name if ex is not None else None,
            line=bsym.one_line(),
            provenance=provenance,
            trace_name=extrace.name,
            device=dev.type if dev is not None else None,
        )
        new_bsyms.append(pre_sym.bind(i, output=None))
        new_bsyms.append(bsym)
        new_bsyms.append(post_sym.bind(i, *outs, output=None))

    ntrace = from_trace(extrace)
    ntrace.bound_symbols = new_bsyms
    return wrap_in_trace_provenance(ntrace, "Instrumentation", start)


def resolve_hooks(debug_watch: Optional[str], instrument: Any) -> tuple:
    """Normalize the ``jit(debug_watch=..., instrument=...)`` options into
    hook instances. ``instrument`` accepts a hook, a bare callable
    (post-op), the shorthands "time"/"memory", or a sequence of any."""
    hooks: list[InstrumentationHook] = []
    if debug_watch:
        hooks.append(NaNWatcher(mode=str(debug_watch)))
    items = instrument if isinstance(instrument, (list, tuple)) else (
        [instrument] if instrument is not None else []
    )
    for it in items:
        if isinstance(it, InstrumentationHook):
            hooks.append(it)
        elif it == "time":
            hooks.append(OpTimer())
        elif it == "memory":
            hooks.append(MemoryHighWater())
        elif callable(it):
            hooks.append(CallbackHook(it))
        else:
            raise ValueError(
                f"instrument: expected a hook, callable, 'time'/'memory', or a "
                f"sequence of those; got {it!r}"
            )
    return tuple(hooks)


def instrument_reports(jfn: Callable) -> list[dict]:
    """The hook reports of a compiled function's instrumentation (empty when
    not instrumented)."""
    cd = getattr(jfn, "_lc_cd", None)
    hooks = cd.instrument_hooks if cd is not None else ()
    return [
        {"hook": type(h).__name__, **h.report()} for h in hooks
    ]
