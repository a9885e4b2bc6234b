"""CompileData / CompileStats / CacheEntry, and the sharp-edges option.

Reference parity: thunder/common.py (`CompileData:138`, `CompileStats:54`,
`CacheEntry` in thunder/__init__.py:281) and thunder/core/options.py
(CACHE_OPTIONS, SHARP_EDGES_OPTIONS). Cut to the jit path of this package:
the four cache options (every tensor's metadata and every number's value
guarded by the prologue, symbolic values, no caching, and "same input",
which strips the guards); staging as a CUDA graph (``disable_jit_staging``,
executors/staging.py); the reference package's distribution state, de-opt
ladder, observability taps and compile-phase spans come with later parts of
the port.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class CACHE_OPTIONS(enum.Enum):
    """The cache options by their ``jit(cache=...)`` strings
    (thunder_tpu/common.py:18-30)."""

    NO_CACHING = "no caching"
    CONSTANT_VALUES = "constant values"
    SAME_INPUT = "same input"
    SYMBOLIC_VALUES = "symbolic values"


def resolve_cache_option(x: Any) -> CACHE_OPTIONS:
    """A member, or its string in any case."""
    if isinstance(x, CACHE_OPTIONS):
        return x
    if isinstance(x, str):
        for opt in CACHE_OPTIONS:
            if opt.value == x.lower():
                return opt
    raise ValueError(f"Unknown cache option cache={x!r}: expected one of {[o.value for o in CACHE_OPTIONS]}")


class SHARP_EDGES_OPTIONS(enum.Enum):
    ALLOW = enum.auto()
    WARN = enum.auto()
    ERROR = enum.auto()


_string_to_sharp_edges = {
    "allow": SHARP_EDGES_OPTIONS.ALLOW,
    "warn": SHARP_EDGES_OPTIONS.WARN,
    "error": SHARP_EDGES_OPTIONS.ERROR,
}


def resolve_sharp_edges_option(x: Any) -> SHARP_EDGES_OPTIONS:
    if isinstance(x, SHARP_EDGES_OPTIONS):
        return x
    if isinstance(x, str):
        opt = _string_to_sharp_edges.get(x.lower())
        if opt is not None:
            return opt
    raise ValueError(f"Unknown sharp_edges option {x!r} (allow|warn|error)")


class ThunderSharpEdgeWarning(UserWarning):
    """A tracing-unsafe construct was observed (reference:
    thunder/core/options.py:146 + jit_ext.py `_general_jit_sharp_edge:468`)."""


class ThunderSharpEdgeError(RuntimeError):
    """sharp_edges='error': a tracing-unsafe construct was observed."""


_sharp_edges_policy = contextvars.ContextVar("sharp_edges_policy", default=SHARP_EDGES_OPTIONS.ALLOW)
_sharp_edges_suppressed = contextvars.ContextVar("sharp_edges_suppressed", default=False)


@contextlib.contextmanager
def suppress_sharp_edges():
    """Scope for framework-internal work during tracing (e.g. guarded
    concretization) whose own env/clock reads are not the user's sharp
    edges."""
    tok = _sharp_edges_suppressed.set(True)
    try:
        yield
    finally:
        _sharp_edges_suppressed.reset(tok)


def sharp_edge(msg: str) -> None:
    """Report a tracing-unsafe construct per the active policy: ALLOW is
    silent (the reference's default), WARN emits ThunderSharpEdgeWarning,
    ERROR raises ThunderSharpEdgeError."""
    if _sharp_edges_suppressed.get():
        return
    policy = _sharp_edges_policy.get()
    # Observability tap (before the ALLOW return, as in the JAX package: the
    # event log wants every sharp edge; the policy only governs warn/raise).
    from thunder_tpu_torch.observability import events
    from thunder_tpu_torch.observability import metrics as obsm

    if obsm.enabled():
        obsm.SHARP_EDGES.inc()
    if events.active_log() is not None:
        events.emit_event("sharp_edge", message=msg, policy=policy.name.lower())
    if policy is SHARP_EDGES_OPTIONS.ALLOW:
        return
    full = (
        f"sharp edge: {msg}. The trace specializes on the observed value; "
        f"changes to it will NOT recompile. Pass sharp_edges='allow' to silence."
    )
    if policy is SHARP_EDGES_OPTIONS.ERROR:
        raise ThunderSharpEdgeError(full)
    warnings.warn(full, ThunderSharpEdgeWarning, stacklevel=3)


@contextlib.contextmanager
def sharp_edges_policy(policy: SHARP_EDGES_OPTIONS):
    tok = _sharp_edges_policy.set(policy)
    try:
        yield
    finally:
        _sharp_edges_policy.reset(tok)


@dataclass
class CompileData:
    """Options resolved at jit() time (reference: thunder/common.py:138)."""

    fn: Callable
    executors_list: tuple = ()
    device: Any = None  # the torch.device the entry runs on
    # Trace-to-trace transforms run after dce/cse and before claiming
    # (``grad`` / ``value_and_grad`` pass the autodiff transform here).
    trace_transforms: tuple = ()
    sharp_edges: SHARP_EDGES_OPTIONS = SHARP_EDGES_OPTIONS.ALLOW
    # Run every entry eagerly instead of capturing it as a CUDA graph
    # (executors/staging.py; reference: thunder_tpu/common.py:139).
    disable_jit_staging: bool = False
    # api.jit's ``cache``: a CACHE_OPTIONS member.
    cache_option: CACHE_OPTIONS = CACHE_OPTIONS.CONSTANT_VALUES
    # The compile options given to jit (``autocast``; under symbolic values
    # ``bucket_policy`` and ``symbolic_dims``).
    compile_options: dict = field(default_factory=dict)
    # jit(events=path): this function's own JSONL log (an EventLog), which
    # its compiles and dispatches write to instead of the global one.
    event_log: Any = None
    # jit(debug_watch=, instrument=): the hooks, resolved once a function so
    # that every entry feeds the same instances (observability/instrument.py).
    instrument_hooks: tuple = ()
    # A jitted nn.Module's (frontend/module.py): fn is the module itself.
    is_module: bool = False
    # jit(chaos=...): the function's chaos config (resilience/chaos.py),
    # active around each of its dispatches.
    chaos: Any = None


class EntryStats:
    """One cache entry's counters (reference: thunder_tpu/common.py:156),
    those the port keeps (``api.cache_info``), with the de-opt ladder level
    the entry was compiled at (``resilience/deopt.py``)."""

    __slots__ = ("hits", "fast_hits", "prologue_runs", "guard_fails", "trace_s", "first_run_s", "phases",
                 "degradation_level")

    def __init__(self):
        self.hits = 0  # calls this entry served, its first included
        self.fast_hits = 0  # hits found by the O(1) key lookup, no prologue run
        self.prologue_runs = 0
        self.guard_fails = 0  # prologue or value-guard rejections while probing
        self.trace_s = 0.0  # host seconds tracing, transforming and claiming it
        self.first_run_s = 0.0  # its first run, ending in a synchronize on CUDA
        self.phases: dict = {}
        self.degradation_level = 0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


@dataclass
class CacheEntry:
    """One compiled specialization (reference: thunder/__init__.py:281)."""

    prologue_fn: Callable
    computation_fn: Callable
    prologue_traces: list
    computation_traces: list
    # Guards over input-derived scalar values that the trace specialized on
    # (core/concrete.py): all must re-evaluate equal for a cache hit.
    value_guards: tuple = ()
    # Whether computation_fn is staged as a CUDA graph, or why not, and its
    # counters (executors/staging.py StagingStats).
    staging: Any = None
    # The program takes a fresh RNG key as its last input (transforms/rng.py).
    needs_rng: bool = False
    # Replays the writes the program made to its inputs onto the caller's
    # objects (api._build_epilogue), or None.
    epilogue_fn: Optional[Callable] = None
    # cache="symbolic values": the bucket spec (core/bucketing.py), the
    # inputs' tree and leaf metadata (for "auto" marks), and the buffers the
    # entry pads its marked inputs into and fills its true extents in.
    sym_spec: Any = None
    treedef: Any = None
    leaf_meta: tuple = ()
    pad_buffers: dict = field(default_factory=dict)
    stats: EntryStats = field(default_factory=EntryStats)
    # The id of the compile that built the entry (observability/events.py),
    # which its first-run and capture phases carry.
    compile_id: Optional[int] = None
    # jit(on_nan=...): the guard's mode, and the claimed trace (before the
    # dels) its instrumented re-run runs (resilience/deopt.py).
    on_nan: Optional[str] = None
    claimed_extrace: Any = None
    # The collective lines and certified per-axis order the watchdog names
    # on a timeout (resilience/watchdog.py); computed at the first guarded
    # call.
    collective_lines: Optional[tuple] = None
    schedule: Optional[dict] = None


class CompileStats:
    """Caches, counters and trace history (reference: thunder/common.py:54)."""

    def __init__(self):
        self.cache_entries: list[CacheEntry] = []
        self.cache_hits: int = 0
        self.cache_misses: int = 0
        # The O(1) dispatch tier (api._dispatch): (tree structure, leaf
        # metadata) -> entry, learned on a compile or a prologue (slow) hit.
        self.fast_cache: dict = {}
        self.fast_hits: int = 0
        self.slow_hits: int = 0
        self.calls: int = 0
        self.prologue_runs: int = 0
        self.compile_count: int = 0
        self.trace_seconds: float = 0.0
        self.first_run_seconds: float = 0.0
        self.cache_lookup_ns: int = 0
        self.last_traces: list = []
        self.last_prologue_traces: list = []
        self.last_backward_traces: list = []
        self.last_staging = None  # the StagingStats of the entry that ran last
        # Why a transform claims with other executors than it was given
        # (jvp: the torch executor alone), or None.
        self.executors_note: Optional[str] = None
        self.last_backward_staging = None  # a module's: that of the backward it ran with
        # Nanosecond timers (thunder_tpu/common.py:262-270): a call's host
        # span and its cache lookup, the last compile's tracing, and the
        # program's run on the host (its enqueue, on the card).
        self.last_trace_host_start: int = 0
        self.last_trace_host_stop: int = 0
        self.last_trace_cache_start: int = 0
        self.last_trace_cache_stop: int = 0
        self.last_trace_tracing_start: int = 0
        self.last_trace_tracing_stop: int = 0
        self.last_trace_host_execution_start: int = 0
        self.last_trace_host_execution_stop: int = 0

    @property
    def last_compile_time_ms(self) -> float:
        return (self.last_trace_tracing_stop - self.last_trace_tracing_start) / 1e6

    @property
    def recompile_count(self) -> int:
        return max(self.compile_count - 1, 0)

    @property
    def last_cache_lookup_us(self) -> float:
        return (self.last_trace_cache_stop - self.last_trace_cache_start) / 1e3


def timer_ns() -> int:
    return time.perf_counter_ns()
