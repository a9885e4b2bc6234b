"""Compile de-optimization ladder, the recovery driver, and the NaN guard.

The counterpart of ``thunder_tpu/resilience/deopt.py``. On a compile failure
or device OOM the runtime does not die: it walks a staged de-opt ladder,
recompiling with progressively safer (slower, smaller-memory)
configurations, with bounded retries and exponential backoff:

====  ==========================================================
L0    normal compilation
L1    skip the attention-residual pair (the flash backward
      recomputes its softmax) and the collective-overlap scheduler
      (``transforms/comm_schedule.py``: a bad schedule demotes to
      program order). The port donates no input, so the JAX
      package's donation knob has no seat.
L2    L1 + aggressive rematerialization of a joint fw+bw program
      (``transforms/rematerialization.rematerialize_joint`` under
      ``aggressive_remat``: reductions join the recomputable set,
      chains run 4x longer)
L3    L2 + exact shapes (no bucket padding for ``cache="symbolic
      values"`` entries)
====  ==========================================================

On a real run failure (not a chaos fault) the ladder skips a level that
would compile the failing entry's program again: L2 when the joint remat
recomputes nothing, L3 when the entry has no bucket padding. The JAX
package climbs through them.

The per-function ladder position is sticky on ``CompileData`` and each entry
records the level it was compiled at (``degradation_level`` in
``cache_info``).

On an **OOM** the ladder does not climb blind: the static liveness planner
(``analysis/liveness.predict_level_peaks``) prices each remaining level from
the failing entry's claimed trace, and the ladder jumps to the first level
predicted to fit the device capacity, skipping levels *proven* too big (the
prediction is a lower bound, so predicted >= capacity is a proof). Every
planner-guided jump logs ``predicted_peak_bytes``/``capacity_bytes``/
``skipped_levels`` in its ``compile_deopt`` event. Capacity:
``THUNDER_TPU_HBM_BYTES``, then the allocator's own limit (the card's memory
times the fraction ``torch.cuda.set_per_process_memory_fraction`` set), then
the DeviceSpec.

Also here: the post-step isfinite guard (``jit(on_nan=...)``): on a
non-finite output the step is re-run once **instrumented** under a NaN
watcher, so the producing op is named before raising
(:class:`NonFiniteOutputError`) or warning.

Knobs: ``THUNDER_TPU_MAX_RECOVERY_ATTEMPTS`` (default 4),
``THUNDER_TPU_RETRY_BACKOFF_S`` (base, default 0.05; doubles per attempt,
capped at 2 s; 0 in tests).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm
from thunder_tpu_torch.resilience import demotion

MAX_LEVEL = 3

_LEVEL_ACTIONS = {
    1: "disable fusion/donation",
    2: "aggressive rematerialization",
    3: "exact shapes (no bucket padding)",
}


def max_attempts() -> int:
    try:
        return int(os.environ.get("THUNDER_TPU_MAX_RECOVERY_ATTEMPTS", "4"))
    except ValueError:
        return 4


def _backoff_s(attempt: int) -> float:
    try:
        base = float(os.environ.get("THUNDER_TPU_RETRY_BACKOFF_S", "0.05"))
    except ValueError:
        base = 0.05
    return min(base * (2 ** attempt), 2.0)


def current_level(cd) -> int:
    return getattr(cd, "_deopt_level", 0)


# Process-wide high-water mark of the ladder: any function de-opted means
# this process is trading speed for survival.
_process_state = {"max_level": 0}


def process_max_level() -> int:
    return _process_state["max_level"]


def reset_process_state() -> None:
    """Tests only: the high-water mark is process-wide by design."""
    _process_state["max_level"] = 0


def _planned_peaks(entry, cs, cd=None):
    """(predicted per-level peak bytes, device capacity bytes) for the
    failing entry's claimed trace, or (None, None) when no trace or capacity
    is known (the ladder then climbs blind). The entry's symbolic spec and
    its last call's true extents price L3 (exact shapes); a
    symbolic-cache function failing before its entry exists leaves L3
    unknown, never skipped."""
    from thunder_tpu_torch.common import CACHE_OPTIONS

    trace = None
    sym_spec = None
    true_extents = None
    if entry is not None:
        sym_spec = entry.sym_spec
        true_extents = entry.last_true_extents
        if entry.computation_traces:
            trace = entry.computation_traces[-1]
    if trace is None and cs is not None and getattr(cs, "last_traces", None):
        trace = cs.last_traces[-1]
    if trace is None:
        return None, None
    from thunder_tpu_torch.analysis.liveness import device_capacity_bytes, predict_level_peaks

    capacity = device_capacity_bytes(getattr(cd, "device", None) if cd is not None else None)
    if not capacity:
        return None, None
    bucketing_unknown = entry is None and getattr(cd, "cache_option", None) is CACHE_OPTIONS.SYMBOLIC_VALUES
    peaks = predict_level_peaks(trace, sym_spec=sym_spec, donated=trace.tags.get("donated_inputs") or (),
                                true_extents=true_extents, bucketing_unknown=bucketing_unknown)
    return peaks, capacity


def _choose_level(peaks: dict, capacity: int, base: int, repeated: tuple = ()):
    """First ladder level above ``base``, and not in ``repeated``, whose
    predicted peak fits the capacity, skipping levels the planner *proves*
    still won't fit. Unknown peaks (None) are never skipped. When no level
    fits, the blind one-step climb, with no prediction attached."""
    skipped: list[int] = []
    levels = [lv for lv in range(base + 1, MAX_LEVEL + 1) if lv not in repeated]
    for level in levels:
        p = peaks.get(level)
        if p is None or p < capacity:
            return level, p, skipped
        skipped.append(level)
    return (levels[0] if levels else MAX_LEVEL + 1), None, []


def _repeats(level: int, entry) -> bool:
    """Whether ``level`` would compile the program that the level below it
    compiled for the failing ``entry``: L2 when the joint remat has nothing
    to recompute (a program that is not a joint fw+bw one, or whose saved
    values are all too dear to recompute), L3 when the entry has no bucket
    padding to drop (not ``cache="symbolic values"``). A deterministic
    failure there would repeat, so a real one skips such a level."""
    if level == 2:
        trace = entry.computation_traces[-1] if entry.computation_traces else None
        if trace is None:
            return False
        from thunder_tpu_torch.core.trace import debug_checks
        from thunder_tpu_torch.transforms.rematerialization import aggressive_remat, rematerialize_joint

        with aggressive_remat(), debug_checks(False):
            return rematerialize_joint(trace) is trace
    return level == 3 and entry.sym_spec is None


def _injected(exc: BaseException) -> bool:
    from thunder_tpu_torch.resilience.chaos import ChaosError

    return any(isinstance(e, ChaosError) for e in demotion._root_causes(exc))


def escalate(cd, reason: str, attempt: int, *, entry=None, cs=None, real: bool = False) -> bool:
    """Bump ``cd``'s ladder position, record it, and sleep the backoff.
    False when the ladder is exhausted: the caller re-raises. A ``real``
    run failure (not a chaos fault, whose rule may name the level) skips
    the levels that would compile the failing entry's program again
    (:func:`_repeats`); the event lists them as ``repeated_levels``. With an
    autopilot installed the climb is its ``deopt_escalate`` decision
    first."""
    base = current_level(cd)
    repeated: tuple = ()
    if real and entry is not None:
        repeated = tuple(lv for lv in range(base + 1, MAX_LEVEL + 1) if _repeats(lv, entry))
    level = next((lv for lv in range(base + 1, MAX_LEVEL + 1) if lv not in repeated), MAX_LEVEL + 1)
    predicted = None
    capacity = None
    skipped: list[int] = []
    if level <= MAX_LEVEL and "oom" in reason:
        try:
            peaks, capacity = _planned_peaks(entry, cs, cd)
        except Exception:  # noqa: BLE001 — planning must never block recovery
            peaks = None
        if peaks and capacity:
            level, predicted, skipped = _choose_level(peaks, capacity, base, repeated)
    if level > MAX_LEVEL or attempt >= max_attempts():
        return False
    # With an autopilot installed the climb is a policy decision: the typed
    # autopilot_decision (actuator deopt_escalate) precedes the
    # compile_deopt recovery event it correlates with, and the escalation
    # applies inside the serialized-recovery critical section, so a de-opt
    # on another thread cannot interleave with an elastic resume in flight.
    from thunder_tpu_torch.resilience import autopilot as ap_mod

    ap = ap_mod.current()
    ctx = contextlib.nullcontext()
    if ap is not None:
        decision = ap.decide(ap_mod.Signal(
            "oom" if "oom" in reason else "compile_fail",
            evidence={"reason": reason, "level": level, "attempt": attempt},
        ))
        ctx = ap.recovery(decision)
    with ctx:
        cd._deopt_level = level
        if level > _process_state["max_level"]:
            _process_state["max_level"] = level
        backoff = _backoff_s(attempt)
        if obsm.enabled():
            obsm.COMPILE_DEOPTS.inc(level=str(level))
        # Planner fields appear only on planner-guided escalations: consumers
        # detect guidance by field presence.
        planner = {}
        if predicted is not None or skipped:
            planner = {
                k: v
                for k, v in (("predicted_peak_bytes", predicted),
                             ("capacity_bytes", capacity),
                             ("skipped_levels", skipped or None))
                if v is not None
            }
        obs_events.emit_event(
            "compile_deopt",
            level=level,
            action=_LEVEL_ACTIONS.get(level, "?"),
            reason=reason,
            attempt=attempt,
            backoff_s=backoff,
            **planner,
            **({"repeated_levels": [lv for lv in repeated if lv < level]} if any(lv < level for lv in repeated) else {}),
        )
        if backoff:
            time.sleep(backoff)
    return True


# -- the recovery driver (called from api._dispatch) ---------------------------


def handle_compile_failure(exc: BaseException, cd, cs, attempt: int) -> bool:
    """Recovery decision for an exception raised while *building* an entry
    (tracing, claiming, staging). True: the caller retries the compile."""
    kind = demotion.classify_failure(exc)
    if kind in (demotion.COMPILE, demotion.OOM):
        _release_device_memory()
        return escalate(cd, f"compile failure: {kind}", attempt, cs=cs)
    if kind == demotion.KERNEL:
        return _demote_from(exc, None, cs, attempt)
    if kind == demotion.CACHE_CORRUPT:
        return _purge_compile_cache(exc, attempt)
    return False


def handle_run_failure(exc: BaseException, cd, cs, entry, attempt: int) -> bool:
    """Recovery decision for an exception raised while *running* an entry
    (its eager first run, its CUDA-graph capture, or a warm run). Evicts
    the entry, so the retry recompiles. True: the caller retries."""
    kind = demotion.classify_failure(exc)
    if kind is None:
        return False
    _drop_frames(exc)
    evict(cs, entry)
    if kind == demotion.KERNEL:
        extrace = entry.computation_traces[-1] if entry.computation_traces else None
        return _demote_from(exc, extrace, cs, attempt)
    if kind in (demotion.COMPILE, demotion.OOM):
        return escalate(cd, f"run failure: {kind}", attempt, entry=entry, cs=cs, real=not _injected(exc))
    if kind == demotion.CACHE_CORRUPT:
        return _purge_compile_cache(exc, attempt)
    return False


def _demote_from(exc, extrace, cs, attempt: int) -> bool:
    if attempt >= max_attempts():
        return False
    pairs = demotion.failing_pairs(exc, extrace) if extrace is not None else []
    if not pairs:
        from thunder_tpu_torch.resilience.chaos import InjectedKernelError

        injected = next((e for e in demotion._root_causes(exc) if isinstance(e, InjectedKernelError)), None)
        if injected is not None:
            # A raise while building: no trace in hand, but the injected
            # error names the executor, so quarantine it executor-wide.
            return demotion.quarantine("*", injected.executor, reason=str(injected))
        return False
    demoted = False
    for sym_id, ex_name in pairs:
        demoted |= demotion.quarantine(sym_id, ex_name, reason=type(exc).__name__)
    return demoted


def _drop_frames(exc: BaseException) -> None:
    """Clear the locals of the failed run's frames: the traceback would
    otherwise keep the program's intermediates (and a failed capture's
    pool tensors) alive through the retry."""
    import traceback

    for e in demotion._root_causes(exc):
        traceback.clear_frames(e.__traceback__)


def _release_device_memory() -> None:
    """After a failed attempt on the card: hand the failed attempt's cached
    blocks back, so the retry does not see them and fail again."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        except RuntimeError:  # a sticky CUDA error: the caller raises the original
            pass


def evict(cs, entry) -> None:
    """Drop a failed entry: from the entries, from the fast-probe table, and
    its staged graph with its private pool."""
    try:
        cs.cache_entries.remove(entry)
    except ValueError:
        pass
    cs.fast_cache.clear()  # keys pointing at the dead entry regenerate
    release = getattr(entry.computation_fn, "release", None)
    if release is not None:
        release()
    _release_device_memory()


def _purge_compile_cache(exc, attempt: int) -> bool:
    if attempt >= max_attempts():
        return False
    from thunder_tpu_torch.resilience import compile_cache

    return compile_cache.purge_on_error(exc)


# -- post-step isfinite guard --------------------------------------------------


class NonFiniteOutputError(RuntimeError):
    """``jit(on_nan=...)``: a step produced NaN/Inf. When the entry was
    re-run instrumented, ``symbol``/``line``/``provenance`` name the
    producing op."""

    def __init__(self, msg: str, *, symbol: Optional[str] = None,
                 line: Optional[str] = None, provenance: Optional[str] = None):
        self.symbol = symbol
        self.line = line
        self.provenance = provenance
        super().__init__(msg)


ON_NAN_MODES = ("raise", "rerun-instrumented", "warn")


def resolve_on_nan(value) -> Optional[str]:
    if value is None:
        return None
    value = str(value)
    if value not in ON_NAN_MODES:
        raise ValueError(
            f"on_nan: expected one of {ON_NAN_MODES} or None, got {value!r}"
        )
    return value


def outputs_finite(out) -> bool:
    """Cheap isfinite sweep over the floating tensor leaves of a step output.
    Each leaf is one reduction, its largest |value| (the inf-norm, which a
    NaN or an Inf makes non-finite): one read of the leaf, where
    ``isfinite(x).all()`` runs several full-size elementwise kernels before
    its reduction. The per-leaf results are folded into ONE device scalar,
    so the all-finite case pays a single host sync, not one per leaf."""
    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten

    norms = [
        torch.linalg.vector_norm(x.detach(), float("inf")).float()
        for x in tree_flatten(out)[0]
        if isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel()
    ]
    if not norms:
        return True
    return bool(torch.isfinite(torch.stack(norms)).all())


def handle_nonfinite(entry, inps: list, mode: str):
    """The ``on_nan`` policy after the guard tripped. ``rerun-instrumented``
    re-runs the SAME inputs once through the claimed trace bracketed with a
    NaN watcher, so the raise names the producing BoundSymbol, its generated
    line, and the pass that made it."""
    if obsm.enabled():
        obsm.NAN_GUARD_TRIPS.inc()
    obs_events.emit_event("nan_guard", action=mode)

    symbol = line = provenance = None
    if mode == "rerun-instrumented" and getattr(entry, "claimed_extrace", None) is not None:
        from thunder_tpu_torch.executors.passes import del_last_used
        from thunder_tpu_torch.observability.instrument import (
            NaNWatchError,
            NaNWatcher,
            instrument_for_execution,
        )

        watcher = NaNWatcher(mode="nan+inf")
        itrace = instrument_for_execution(entry.claimed_extrace, (watcher,))
        itrace = del_last_used(itrace)
        try:
            itrace.python_callable()(*inps)
        except NaNWatchError as e:
            symbol, line, provenance = e.sym_name, e.trace_line, e.provenance
            obs_events.emit_event(
                "nan_guard", action="attributed", symbol=symbol, line=line,
                provenance=provenance,
            )
    if mode == "warn":
        import warnings

        warnings.warn(
            "thunder_tpu_torch: step produced non-finite outputs (on_nan='warn')",
            RuntimeWarning, stacklevel=3,
        )
        return
    detail = f" — produced by {symbol!r}: {line} [{provenance}]" if symbol else ""
    if symbol and getattr(entry, "sym_spec", None) is not None:
        # The instrumented re-run watches PADDED intermediates; an op whose
        # padding lanes legitimately produce inf/NaN can be named before
        # the true (cropped-extent) producer. Say so rather than misdirect.
        detail += (
            " (bucketed entry: the named op may be a padding-lane producer "
            "upstream of the true one)"
        )
    raise NonFiniteOutputError(
        f"step produced non-finite outputs (on_nan={mode!r}){detail}",
        symbol=symbol, line=line, provenance=provenance,
    )
