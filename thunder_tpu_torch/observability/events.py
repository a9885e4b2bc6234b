"""Structured JSONL event log.

The counterpart of ``thunder_tpu/observability/events.py``, a copy of its
stdlib-only code: every durable compilation-pipeline happening (compile
start and end, per-pass durations from the provenance hook in
``core/trace.py``, cache misses, bucket selection, sharp-edge observations,
NaN-watch trips, profile brackets) is one JSON object on one line, so logs
stream, tail, and replay (``thunder_tpu_torch.analysis.events``).

Activation:

- process-wide: ``THUNDER_TPU_EVENTS=<path>`` (checked lazily, once), or
  ``monitor.set_event_log(path)``;
- per-function: ``jit(fn, events="<path>")`` (and ``jit(module,
  events=...)``): that function's compiles and cache events go to its own
  log, overriding the global one.

Schema (the JAX package's; the replay validates it):

    {"v": 1, "ts": <unix seconds>, "seq": <per-log counter>, "kind": "...",
     "pid": <os pid>, "host": <torch.distributed rank or 0>,
     ...kind-specific fields...}

Kind-specific required fields live in
``thunder_tpu_torch.analysis.events.SCHEMA``. Emission is a no-op costing
one dict lookup when no log is active.

Ops plane: when ``observability/opsplane`` is enabled it installs **taps**
here: the flight-recorder ring and the streaming detector bank see every
emitted record, with or without a JSONL log configured. With the plane off
(the default) the taps tuple is empty and every emit path pays one
module-global truth test; the dispatch fast path emits nothing and pays
nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import sys
import threading
import time
from typing import Any, Optional

SCHEMA_VERSION = 1

# -- ops-plane taps (observability/opsplane installs them; empty = plane off) --
# A tuple of ``tap(kind, fields)`` callables that see every emitted record,
# independent of whether a JSONL sink is configured: the flight recorder's
# ring and the detector bank. One module-global truth test when empty.
_ops: dict[str, Any] = {"taps": (), "recorder": None}


def set_ops_taps(taps: tuple, *, recorder=None) -> None:
    """Install (or clear, with ``()``) the ops-plane event taps. ``recorder``
    is the flight recorder :func:`flight_dump` delegates to."""
    _ops["taps"] = tuple(taps)
    _ops["recorder"] = recorder


def ops_active() -> bool:
    return bool(_ops["taps"])


def ops_taps() -> tuple:
    """(taps, recorder): for a caller that restores the installed taps
    around an armed/off measurement without tearing down a live server."""
    return _ops["taps"], _ops["recorder"]


def _tap(kind: str, fields: dict) -> None:
    for tap in _ops["taps"]:
        try:
            tap(kind, fields)
        except Exception:
            # A tap observes the workload; it must never take it down.
            pass


def tap_event(kind: str, fields: dict) -> None:
    """Feed the taps directly: for emit sites that write through a specific
    :class:`EventLog` handle (which taps on its own) but skip emitting
    entirely when no log is configured."""
    if _ops["taps"]:
        _tap(kind, fields)


def flight_dump(reason: str = "manual"):
    """Dump the installed flight recorder's ring (``flightrec-<ts>-
    <reason>.jsonl``); None when the ops plane is off. The spelling the
    fault sites use (watchdog timeout, SDC exhaustion, autopilot halt, an
    unhandled dispatch fault): one global probe when off, never raises."""
    rec = _ops["recorder"]
    if rec is None:
        return None
    try:
        return rec.dump(reason)
    except Exception:
        return None


_identity: dict[str, Any] = {}


def host_identity() -> dict[str, Any]:
    """``{"pid", "host"}`` stamped into every event record so per-host JSONL
    logs from a multi-process job can be merged with stable ordering
    (``thunder_tpu_torch.analysis.events.merge_event_logs``). ``host`` is
    ``torch.distributed.get_rank()`` when a process group is already
    initialized at the FIRST emission (the seat of ``jax.process_index()``),
    else 0, and then FROZEN: merge ordering and compile-id correlation key
    on (host, pid), so one process's events never flip identity mid-log.
    Observability never initializes a process group itself, and asks only
    when torch is already imported."""
    pid = os.getpid()
    if _identity.get("pid") != pid:
        # Fork-safety: a forked worker is a new writer and re-resolves.
        _identity.clear()
        _identity["pid"] = pid
        host = 0
        dist = sys.modules.get("torch.distributed")
        if dist is not None:
            try:
                if dist.is_available() and dist.is_initialized():
                    host = int(dist.get_rank())
            except Exception:
                pass
        _identity["host"] = host
    return {"pid": pid, "host": _identity["host"]}


class EventLog:
    """Append-only JSONL sink. Opens lazily, one line per event, flushed per
    write (a crashed process keeps everything emitted before the crash).

    Construct via :func:`log_for_path` — one shared instance per path, so
    two functions logging to the same file share one handle and one ``seq``
    counter (independent instances would interleave duplicate seq values)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._seq = 0
        self._lock = threading.Lock()
        self._dead = False

    def emit(self, kind: str, **fields) -> None:
        # The taps see the record whether or not the sink survives.
        if _ops["taps"]:
            _tap(kind, fields)
        # Observability must never take the workload down: a sink I/O
        # failure (unwritable path, disk full) warns once and disables this
        # log instead of crashing the compile/training step it observes.
        if self._dead:
            return
        rec = {"v": SCHEMA_VERSION, "ts": time.time(), "kind": kind}
        rec.update(host_identity())
        rec.update(fields)
        try:
            with self._lock:
                if self._f is None:
                    d = os.path.dirname(os.path.abspath(self.path))
                    if d:
                        os.makedirs(d, exist_ok=True)
                    self._f = open(self.path, "a")
                rec["seq"] = self._seq
                self._f.write(json.dumps(rec, default=str))
                self._f.write("\n")
                self._f.flush()
                self._seq += 1
        except OSError as e:
            self._dead = True
            # Silent observability loss must itself be observable: the drop
            # counter increments past the metrics gate so monitor.report()
            # shows it even when metrics were never enabled.
            from thunder_tpu_torch.observability import metrics as obsm

            obsm.EVENT_LOG_DROPPED.inc_always()
            import warnings

            warnings.warn(
                f"thunder_tpu_torch event log {self.path!r} disabled after I/O "
                f"failure: {e}",
                stacklevel=3,
            )

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# -- active-log resolution ----------------------------------------------------

_active_log: contextvars.ContextVar[Optional[EventLog]] = contextvars.ContextVar(
    "thunder_tpu_event_log", default=None
)
_global = {"path": None, "log": None}
_logs_by_path: dict[str, EventLog] = {}


def log_for_path(path: str) -> EventLog:
    """The shared :class:`EventLog` for ``path`` (one instance per absolute
    path process-wide — keeps the per-log ``seq`` counter monotonic when
    several functions log to the same file)."""
    key = os.path.abspath(path)
    log = _logs_by_path.get(key)
    if log is None:
        log = _logs_by_path[key] = EventLog(path)
    return log


def set_global_path(path: Optional[str]) -> None:
    """Point the process-wide log somewhere (None disables). Mostly for
    tests; production uses THUNDER_TPU_EVENTS."""
    _global["path"] = path
    _global["log"] = log_for_path(path) if path else None
    _global["resolved"] = True


def _global_log() -> Optional[EventLog]:
    if not _global.get("resolved"):
        path = os.environ.get("THUNDER_TPU_EVENTS", "").strip()
        _global["path"] = path or None
        _global["log"] = log_for_path(path) if path else None
        _global["resolved"] = True
    return _global["log"]


def active_log() -> Optional[EventLog]:
    log = _active_log.get()
    if log is not None:
        return log
    return _global_log()


def emit_event(kind: str, **fields) -> None:
    """Emit to the active log (contextvar override, else the global
    THUNDER_TPU_EVENTS log); no-op when neither is configured, except for
    the taps, which see every record even with no log."""
    log = active_log()
    if log is not None:
        log.emit(kind, **fields)  # taps fire inside emit
    elif _ops["taps"]:
        _tap(kind, fields)


def emit_compile_end(
    compile_id, fn_name: str, ms: float, trace=None, *,
    symbolic: bool = False, recompile: bool = False, staged: bool = True,
) -> None:
    """The one writer of ``compile_end`` records, shared by the functional
    pipeline (``api._compile_entry``) and the module frontend
    (``frontend/module.py``) so the schema cannot diverge between producers.
    ``trace`` is the final execution trace; its ``claim_breakdown`` tag
    (stamped by ``executors/passes.py``) becomes the event's executor
    payload, its ``collective_bytes`` tag the bytes of its collectives'
    operands."""
    log = active_log()
    if log is None and not _ops["taps"]:
        return
    tags = getattr(trace, "tags", None) or {}
    fields = dict(
        compile_id=compile_id,
        fn=fn_name,
        ms=ms,
        n_bsyms=len(trace.bound_symbols) if trace is not None else None,
        claims=tags.get("claim_breakdown") or {},
        collective_bytes=int(tags.get("collective_bytes") or 0),
        symbolic=symbolic,
        recompile=recompile,
        staged=staged,
    )
    if log is not None:
        log.emit("compile_end", **fields)  # taps fire inside emit
    else:
        # No sink configured, taps installed: they still see the record.
        _tap("compile_end", fields)


@contextlib.contextmanager
def event_scope(log: Optional[EventLog]):
    """Route ``emit_event`` to ``log`` within the scope (None = no change)."""
    if log is None:
        yield
        return
    tok = _active_log.set(log)
    try:
        yield
    finally:
        _active_log.reset(tok)


# -- compile correlation ------------------------------------------------------
# Per-pass events fire deep inside core/trace.py with no compile handle in
# scope; a contextvar carries the compile id so one compile's pass events
# correlate in the log.

_compile_id: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "thunder_tpu_compile_id", default=None
)
_compile_seq = {"n": 0}


def current_compile_id() -> Optional[int]:
    return _compile_id.get()


@contextlib.contextmanager
def compile_scope(log: Optional[EventLog] = None):
    """Allocate a process-unique compile id, route events to ``log`` (when
    given), and yield the id. Used by ``api._compile_entry`` and the module
    frontend's compile."""
    _compile_seq["n"] += 1
    cid = _compile_seq["n"]
    tok = _compile_id.set(cid)
    try:
        with event_scope(log):
            yield cid
    finally:
        _compile_id.reset(tok)
