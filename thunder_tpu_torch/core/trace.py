"""TraceCtx: the linear SSA-like program representation.

Reference parity: thunder/core/trace.py (`TraceCtx:46`, `python:309`,
`python_callable:400`, `from_trace:434`, tracectx contextvars `:453-474`,
`detached_trace:508`, `TraceProvenance:29`).

A trace is a list of ``BoundSymbol``s plus the signature (proxied args) and
output. It prints as valid Python and compiles to a callable. Every transform
is trace→trace and stamps a ``TraceProvenance`` so the full compilation
history is inspectable — reading the generated program is the primary
debugging tool, as in the reference.
"""

from __future__ import annotations

import bisect
import collections
import contextvars
import time
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.core import baseutils, codeutils
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.codeutils import SigInfo
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol


class TraceProvenance:
    def __init__(self, pss: str):
        self.pss = pss

    def __repr__(self) -> str:
        return f"# Constructed by {self.pss}"


class TraceCtx:
    def __init__(self, fn: Optional[Callable] = None, *, prologue: bool = False):
        self.fn = fn
        self.args: tuple = ()
        self.kwargs: dict = {}
        self.output: Any = None
        self.bound_symbols: list[BoundSymbol] = []
        self._scopes: list[list[BoundSymbol]] = [self.bound_symbols]
        self._names: set[str] = set()
        self._counter = baseutils.NamedCounter()
        self.provenance: Optional[TraceProvenance] = None
        self.name: str = "prologue" if prologue else "computation"
        self._siginfo: Optional[SigInfo] = None
        # Free-form metadata transforms may attach (e.g. saved_for_backward).
        self.tags: dict[str, Any] = {}

    # -- naming --------------------------------------------------------------

    def make_name(self, prefix: str = "t") -> str:
        while True:
            name = f"{prefix}{self._counter.next(prefix)}"
            if name not in self._names:
                self._names.add(name)
                return name

    def add_name(self, name: str) -> None:
        # Strict: the trace IR is SSA, so a name registered twice means two
        # proxies would alias one name — the verifier's ssa rules depend on
        # registration being unique (reference: trace.py add_name raises too).
        check(
            name not in self._names,
            lambda: f"Name {name!r} is already registered in this trace",
            ValueError,
        )
        self._names.add(name)

    def has_name(self, name: str) -> bool:
        return name in self._names

    # -- scopes --------------------------------------------------------------

    def push_scope(self, scope: list) -> None:
        self._scopes.append(scope)

    def pop_scope(self) -> list:
        check(len(self._scopes) > 1, "Cannot pop the root scope")
        return self._scopes.pop()

    @property
    def current_scope(self) -> list:
        return self._scopes[-1]

    def add_bound_symbol(self, bsym: BoundSymbol) -> None:
        self.current_scope.append(bsym)

    # -- signature -----------------------------------------------------------

    @property
    def siginfo(self) -> SigInfo:
        if self._siginfo is not None:
            return self._siginfo
        params = []
        for a in self.args:
            if isinstance(a, Proxy):
                params.append(a.name)
            else:
                params.append(codeutils.prettyprint(a))
        return SigInfo(self.name, params)

    def set_siginfo(self, siginfo: SigInfo) -> None:
        self._siginfo = siginfo

    # -- codegen -------------------------------------------------------------

    def pass_name(self) -> Optional[str]:
        """The provenance pass name without its timing suffix (``"Transform
        for execution"`` from ``"Transform for execution (took 3.2 ms)"``) —
        the one parsing point shared by annotated codegen and
        instrumentation attribution (observability/instrument.py)."""
        if self.provenance is None:
            return None
        pss = self.provenance.pss
        cut = pss.find(" (took")
        return pss[:cut] if cut >= 0 else pss

    def _annotate_tag(self) -> str:
        """Compact pass-provenance tag for profiler scope names: the pass
        name with spaces collapsed, e.g. "Transform_for_execution". A trace
        not named "computation" (a split step's "augmented_forward" and
        "backward") has its name in front, "backward_Delete_Last_Used", so
        that the lines of two traces run in one step keep apart in a
        profile (``observability/attribution.py``)."""
        tag = (self.pass_name() or self.name).replace(" ", "_")
        return tag if self.name in ("computation", tag) else f"{self.name}_{tag}"

    def python(self, *, print_depth: int = 1, include_header: bool = True, annotate: bool = False) -> str:
        """Render the trace as Python source. ``annotate=True`` wraps each
        value-producing op in ``torch.profiler.record_function`` so op names
        show in profiler timelines (reference: thunder/core/profile.py:15
        `add_markers`, env THUNDER_ANNOTATE_TRACES). The range name carries
        the trace-line index and the pass provenance (``L<idx>.<sym>#<pass>``),
        so a profiler row maps back to both the generated line and the
        transform that produced it."""
        lines: list[str] = []
        if include_header:
            if self.provenance is not None:
                lines.append(repr(self.provenance))
            lines.append("import thunder_tpu_torch.core.dtypes as dtypes")
            lines.append("import thunder_tpu_torch.core.devices as devices")
            lines.append("")
        lines.append(self.siginfo.prettyprint())
        lines.extend(self._body(print_depth, annotate)[0])
        return "\n".join(lines) + "\n"

    def _body(self, print_depth: int, annotate: bool) -> tuple[list[str], list[Optional[int]]]:
        """The body's source lines, and the index of the bound symbol that
        each line of it belongs to."""
        body: list[str] = []
        owners: list[Optional[int]] = []
        tag = self._annotate_tag() if annotate else ""
        for i, bsym in enumerate(self.bound_symbols):
            n = len(body)
            if annotate and bsym.flat_proxy_outs:
                body.append(f"{baseutils.indent(1)}with __annotate_scope({self.scope_of(i, tag)!r}):")
                body.extend(bsym.python(indent=2, print_depth=print_depth))
            else:
                body.extend(bsym.python(indent=1, print_depth=print_depth))
            owners.extend([i] * sum(line.count("\n") + 1 for line in body[n:]))
        if not body:
            body = [f"{baseutils.indent(1)}pass"]
            owners = [None]
        return body, owners

    def scope_of(self, index: int, tag: Optional[str] = None) -> str:
        """The profiler scope of line ``index``, ``L<idx>.<sym>#<pass>``."""
        return f"L{index}.{self.bound_symbols[index].sym.name}#{self._annotate_tag() if tag is None else tag}"

    def gen_ctx(self) -> dict[str, Any]:
        """Build the exec namespace: every call target of every top-level
        bound symbol, plus dtypes/devices modules and per-bsym call ctx."""
        from thunder_tpu_torch.core import dtypes, devices

        ctx: dict[str, Any] = {"dtypes": dtypes, "devices": devices}
        for bsym in self.bound_symbols:
            if bsym.sym.python_printer is not None:
                ctx.update(bsym._call_ctx)
                continue
            name, target = bsym.gen_call_target()
            if isinstance(target, tuple):  # (module label, module object)
                label, mod = target
                ctx[label] = mod
            else:
                existing = ctx.get(name)
                check(
                    existing is None or existing is target,
                    lambda: f"Name collision in generated code: {name}",
                )
                ctx[name] = target
            ctx.update(bsym._call_ctx)
        return ctx

    def python_callable(self, **exec_ctx) -> Callable:
        """The trace compiled to a function. Its globals hold a
        :class:`ProgramLines` under ``__thunder_program__``: which line of
        the trace each source line runs (the compiled-program auditor
        follows a capture or a profiled call line by line through it)."""
        annotate = annotate_enabled()
        body, owners = self._body(1, annotate)
        source = "\n".join([self.siginfo.prettyprint(), *body]) + "\n"
        ctx = self.gen_ctx()
        if annotate:
            import torch

            ctx["__annotate_scope"] = torch.profiler.record_function
        lines = ProgramLines(self, (None, *owners))
        ctx["__thunder_program__"] = lines
        ctx.update(exec_ctx)
        fn = baseutils.compile_and_exec(self.siginfo.name, source, ctx)
        fn.__thunder_trace__ = self
        lines.code = fn.__code__
        return fn

    def __repr__(self) -> str:
        return self.python()


class ProgramLines:
    """A generated program's map from source lines to trace lines:
    ``owners[n - 1]`` is the index in ``trace.bound_symbols`` of the line
    that source line ``n`` runs (None: the signature); ``code`` is the
    program's code object. Every live one is in :func:`live_programs`."""

    __slots__ = ("trace", "owners", "code", "_starts", "_lines", "__weakref__")

    def __init__(self, trace: "TraceCtx", owners: tuple):
        self.trace, self.owners, self.code = trace, owners, None
        self._starts = self._lines = None
        _LIVE_PROGRAMS.add(self)

    def line_of(self, lineno: Optional[int]) -> Optional[int]:
        return self.owners[lineno - 1] if lineno is not None and 0 < lineno <= len(self.owners) else None

    def line_at(self, offset: int) -> Optional[int]:
        """The trace line that the program's bytecode at ``offset`` runs."""
        if self._starts is None:
            ranges = sorted(self.code.co_lines())
            self._starts = [start for start, _, _ in ranges]
            self._lines = [self.line_of(line) for _, _, line in ranges]
        k = bisect.bisect_right(self._starts, offset) - 1
        return self._lines[k] if k >= 0 else None


_LIVE_PROGRAMS: "weakref.WeakSet[ProgramLines]" = weakref.WeakSet()


def live_programs() -> list:
    """The :class:`ProgramLines` of every generated program still alive."""
    return list(_LIVE_PROGRAMS)


def annotate_enabled() -> bool:
    """Whether generated programs run each line in a profiler range
    (``THUNDER_ANNOTATE_TRACES=1``; the JAX package's spelling
    ``THUNDER_TPU_ANNOTATE_TRACES`` too), read when a program is generated."""
    import os

    return any(os.environ.get(name, "").lower() not in ("", "0", "false", "off")
               for name in ("THUNDER_ANNOTATE_TRACES", "THUNDER_TPU_ANNOTATE_TRACES"))


def from_trace(trc: TraceCtx) -> TraceCtx:
    """A new empty trace inheriting signature/names from ``trc``
    (reference: trace.py `from_trace:434`)."""
    new = TraceCtx(trc.fn)
    new.args = trc.args
    new.kwargs = trc.kwargs
    new.output = trc.output
    new.name = trc.name
    new._siginfo = trc._siginfo
    new._names = set(trc._names)
    new._counter = trc._counter  # share so fresh proxies never collide
    new.tags = dict(trc.tags)
    return new


# -- tracing context management ----------------------------------------------

_tracectx = contextvars.ContextVar("tracectx", default=None)

# Trace-level grad mode (torch.no_grad/enable_grad during acquisition):
# False ⇒ Symbol.__call__ detaches op outputs via stop_gradient, matching
# eager's "values computed under no_grad are leaves" semantics.
_grad_mode_ctx = contextvars.ContextVar("trace_grad_mode", default=True)


def get_tracectx() -> Optional[TraceCtx]:
    return _tracectx.get()


def set_tracectx(trace: TraceCtx):
    return _tracectx.set(trace)


def reset_tracectx(token) -> None:
    _tracectx.reset(token)


@contextmanager
def tracectx(trace: Optional[TraceCtx]):
    tok = _tracectx.set(trace)
    try:
        yield trace
    finally:
        _tracectx.reset(tok)


@contextmanager
def detached_trace():
    """A fresh throwaway trace context (reference: trace.py:508)."""
    trace = TraceCtx()
    with tracectx(trace):
        yield trace


# -- debug checks (the trace verifier's pipeline hook) ------------------------
#
# Every pass stamps provenance through wrap_in_trace_provenance/mark; with
# checks enabled, that stamping point also runs the static verifier
# (thunder_tpu_torch/analysis) on the pass's output, so the first malformed
# trace is attributed to the pass that made it (thunder_tpu/core/trace.py:
# 273-304). Enabled per compile by jit(debug_checks=True) (the context
# variable) or process-wide by THUNDER_TPU_CHECKS=1. The same point is the
# observability tap (_record_pass): each pass's ms and a "pass" event.

_debug_checks_ctx = contextvars.ContextVar("trace_debug_checks", default=None)


def debug_checks_enabled() -> bool:
    v = _debug_checks_ctx.get()
    if v is not None:
        return v
    import os

    return os.environ.get("THUNDER_TPU_CHECKS", "").strip().lower() not in ("", "0", "false", "off")


@contextmanager
def debug_checks(enabled: Optional[bool]):
    """Scope the verifier on (True) or off (False); None defers to the
    enclosing scope and the THUNDER_TPU_CHECKS environment variable."""
    if enabled is None:
        yield
        return
    tok = _debug_checks_ctx.set(bool(enabled))
    try:
        yield
    finally:
        _debug_checks_ctx.reset(tok)


def _maybe_verify(trc: TraceCtx) -> TraceCtx:
    if debug_checks_enabled():
        from thunder_tpu_torch.analysis import verify_or_raise

        start = time.perf_counter_ns()
        verify_or_raise(trc)
        verify_seconds.append((time.perf_counter_ns() - start) / 1e9)
    return trc


# The verifier's seconds at each pass it checked, the latest last (what the
# checks cost: a caller clears it, compiles, and reads it).
verify_seconds: collections.deque = collections.deque(maxlen=4096)


def _record_pass(pass_name: str, elapsed_ms: Optional[float], trc: TraceCtx) -> None:
    """Observability tap on the provenance-stamping point every pass flows
    through (thunder_tpu/core/trace.py:307-323): the pass's ms into the
    ``thunder_tpu_pass_ms`` histogram and a "pass" event in the JSONL log,
    correlated to the enclosing compile. Each sink is one flag or
    context-variable check when observability is off."""
    from thunder_tpu_torch.observability import events
    from thunder_tpu_torch.observability import metrics as obsm

    if obsm.enabled() and elapsed_ms is not None:
        obsm.PASS_MS.observe(elapsed_ms, **{"pass": pass_name})
    if events.active_log() is not None:
        events.emit_event(
            "pass",
            compile_id=events.current_compile_id(),
            name=pass_name,
            ms=elapsed_ms,
            n_bsyms=len(trc.bound_symbols),
            trace=trc.name,
        )


def wrap_in_trace_provenance(trc: TraceCtx, pass_name: str, start_ns: int) -> TraceCtx:
    elapsed_ms = (time.perf_counter_ns() - start_ns) / 1e6
    trc.provenance = TraceProvenance(f"{pass_name} (took {elapsed_ms:.2f} ms)")
    _record_pass(pass_name, elapsed_ms, trc)
    return _maybe_verify(trc)


def mark(trc: TraceCtx, pass_name: str) -> TraceCtx:
    trc.provenance = TraceProvenance(pass_name)
    _record_pass(pass_name, None, trc)
    return _maybe_verify(trc)
