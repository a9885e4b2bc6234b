"""Mesh-level step guards: the collective watchdog and the SDC guard.

The counterpart of ``thunder_tpu/resilience/watchdog.py``: two detectors
for faults one process cannot see from its own stack: a peer that stopped
participating in a collective (the job hangs forever in an NCCL call with
no error), and silent data corruption (a flipped bit in one replica's
memory poisons the run with no signal at all).

**Collective watchdog**: :func:`guard_call` runs a dispatch that contains
collectives on a worker thread, on the caller's device and current CUDA
stream, with the caller's grad mode, and joins with a configurable timeout
(``THUNDER_TPU_COLLECTIVE_TIMEOUT_S`` / :func:`configure`). A hung NCCL
collective cannot be cancelled, and the abandoned worker may still hold a
CUDA-graph replay on that stream, so on timeout the watchdog abandons the
worker and raises a typed :class:`CollectiveTimeoutError` naming the
collective trace lines of the guarded program and the suspected host (from
the last :func:`~thunder_tpu_torch.analysis.events.host_health` summary,
:func:`note_host_health`): the process must restart (checkpoint + elastic
resume in a fresh process). Dispatch sites that opt in: ``api._dispatch``
(traces with collectives), ``distributed/runtime.shard_map_callable``, and
``resilience.preemption.run_training`` steps on a mesh. The watchdog is off
unless a timeout is configured: steady-state overhead is one dict probe.

**SDC guard**: :class:`SDCGuard`, armed through
``run_training(sdc_guard=...)``: after each guarded step it cross-checks the
crc32 of each replicated leaf across the data-parallel replicas of the
training state (each rank's crc all-gathered over the world). Replicas hold
bitwise-equal copies by construction, so any divergence is a corrupted
device; the guard emits ``sdc_suspect`` naming the leaf and the ranks,
quarantines the step (discards the poisoned state), and re-runs it from the
previous state; ``sdc_rerun`` records the outcome; a divergence that
survives the re-run raises :class:`SDCDetectedError`. The step must not
update its input state in place (the previous state must survive it).
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm
from thunder_tpu_torch.resilience import chaos


class CollectiveTimeoutError(RuntimeError):
    """A guarded dispatch containing collectives did not complete within the
    watchdog timeout — a peer stopped participating (host hang/loss) or the
    interconnect stalled. Carries the collective trace lines of the guarded
    program and the suspected host from the last host-health summary."""

    seam = "collective_hang"

    def __init__(self, fn_name: str, timeout_s: float,
                 trace_lines: Optional[Sequence[str]] = None,
                 suspected_host: Optional[Any] = None,
                 schedule: Optional[dict] = None):
        self.fn_name = fn_name
        self.timeout_s = timeout_s
        self.trace_lines = list(trace_lines or [])
        self.suspected_host = suspected_host
        # Certified per-axis collective order of the guarded program
        # ({axis: ["L<i>.<sym>", ...]} — analysis/schedule.ScheduleCertificate
        # .axis_labels()): everything left of a pending collective must have
        # completed on every healthy host, which is what narrows a hang to
        # the first line a dead peer never reached.
        self.schedule = dict(schedule or {})
        lines = ", ".join(self.trace_lines) if self.trace_lines else \
            "collectives inserted by the SPMD partitioner (no trace lines)"
        suspect = (
            f"suspected host {suspected_host} (straggler per host_health)"
            if suspected_host is not None
            else "no straggler data (run monitor.host_health over per-host logs)"
        )
        sched = ""
        if self.schedule:
            sched = "; certified order " + "; ".join(
                f"{axis}: " + " -> ".join(labels)
                for axis, labels in sorted(self.schedule.items())
            )
        super().__init__(
            f"collective watchdog: {fn_name!r} exceeded {timeout_s:g}s — "
            f"a peer stopped participating; pending collectives: {lines}; "
            f"{suspect}{sched}"
        )


class SDCDetectedError(RuntimeError):
    """Replica checksums diverged and the quarantine re-run did not clear
    it — persistent corruption (bad device memory), not a transient flip."""

    seam = "sdc"

    def __init__(self, step: int, leaves: Sequence[str]):
        self.step = step
        self.leaves = list(leaves)
        super().__init__(
            f"SDC guard: replica checksum divergence at step {step} survived "
            f"the quarantine re-run (leaves: {', '.join(self.leaves)}) — "
            f"suspect persistent device corruption"
        )


# -- watchdog configuration ----------------------------------------------------

_config: dict = {"timeout_s": None, "resolved": False}
_last_health: dict = {"summary": None}
# Workers abandoned after a timeout (a hung collective cannot be cancelled,
# so the thread leaks until the hang clears). A soak full of injected hangs
# would otherwise grow live threads without bound: past
# THUNDER_TPU_WATCHDOG_MAX_ABANDONED live abandoned workers, guard
# arming is refused — the dispatch runs unguarded with a warning — until
# some of them die. The registry lock keeps a concurrent timeout's append
# from being lost under another thread's prune (guard_call is explicitly
# multi-thread safe).
_abandoned: list = []
_abandoned_lock = threading.Lock()


def max_abandoned_workers() -> int:
    try:
        return int(os.environ.get("THUNDER_TPU_WATCHDOG_MAX_ABANDONED", "16"))
    except ValueError:
        return 16


def abandoned_worker_count() -> int:
    """Live abandoned watchdog workers (dead ones are pruned on each call)."""
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return len(_abandoned)


def configure(timeout_s: Optional[float]) -> None:
    """Arm (or disarm with ``None``) the collective watchdog process-wide —
    the programmatic spelling of ``THUNDER_TPU_COLLECTIVE_TIMEOUT_S``."""
    _config["timeout_s"] = float(timeout_s) if timeout_s else None
    _config["resolved"] = True


def active_timeout() -> Optional[float]:
    if not _config["resolved"]:
        env = os.environ.get("THUNDER_TPU_COLLECTIVE_TIMEOUT_S", "").strip()
        _config["timeout_s"] = float(env) if env else None
        _config["resolved"] = True
    return _config["timeout_s"]


def enabled() -> bool:
    return active_timeout() is not None


def note_host_health(summary: Optional[dict]) -> None:
    """Record the latest cross-host health summary
    (``analysis/events.host_health`` calls this) so a later timeout can name
    the suspected straggler instead of just "somewhere in the mesh"."""
    _last_health["summary"] = summary


def last_host_health() -> Optional[dict]:
    return _last_health["summary"]


def _suspected_host() -> Optional[Any]:
    summary = _last_health["summary"]
    if summary and summary.get("stragglers"):
        return summary["stragglers"][0]
    return None


# -- the guarded call ----------------------------------------------------------


def guard_call(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    *,
    fn_name: str = "?",
    trace_lines: Optional[Sequence[str]] = None,
    timeout_s: Optional[float] = None,
    schedule: Optional[dict] = None,
):
    """Run ``fn(*args, **kwargs)`` under the collective watchdog.

    With no timeout configured this is a direct call. Otherwise the call
    runs on a daemon worker thread, on the caller's CUDA device and current
    stream with the caller's grad mode, and the caller joins with the
    timeout: on expiry the worker is abandoned (a hung collective cannot be
    cancelled: the process must restart, and recovery is checkpoint +
    elastic resume in a fresh process) and :class:`CollectiveTimeoutError` raises, after
    emitting a ``collective_timeout`` event and bumping
    ``thunder_tpu_collective_watchdog_timeouts_total``. The chaos
    ``collective_hang`` seam fires inside the guarded region, so injected
    hangs exercise exactly this path."""
    timeout = timeout_s if timeout_s is not None else active_timeout()
    if timeout is None:
        return fn(*args, **(kwargs or {}))
    cap = max_abandoned_workers()
    if abandoned_worker_count() >= cap:
        # Refusing to arm bounds the leak: each timeout strands one worker
        # thread forever (the hung collective cannot be cancelled), and a
        # soak full of hangs must not grow threads without limit. The
        # dispatch still runs — unguarded, loudly.
        import warnings

        if obsm.enabled():
            obsm.WATCHDOG_UNGUARDED.inc()
        warnings.warn(
            f"thunder_tpu_torch collective watchdog: {cap} abandoned worker(s) "
            f"still alive (THUNDER_TPU_WATCHDOG_MAX_ABANDONED={cap}); "
            f"running {fn_name!r} UNguarded until they exit",
            RuntimeWarning, stacklevel=2,
        )
        return fn(*args, **(kwargs or {}))

    import contextvars

    # The worker must see the caller's context: chaos scopes and per-function
    # event-log routing are contextvars, and a fresh thread starts from an
    # empty context.
    ctx = contextvars.copy_context()
    box: dict = {}
    # CUDA's current device and stream and torch's grad mode are per
    # thread: the worker takes the caller's.
    import torch

    grad = torch.is_grad_enabled()
    stream = torch.cuda.current_stream() if torch.cuda.is_available() and torch.cuda.is_initialized() else None

    def worker():
        try:
            def body():
                chaos.collective_hang_seam()
                # Sub-timeout slowdown (straggler@step): the streaming
                # detectors (observability/detect.py) must see a drifting
                # step before it becomes a hang.
                chaos.straggler_seam("step")
                with torch.set_grad_enabled(grad):
                    if stream is None:
                        return fn(*args, **(kwargs or {}))
                    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                        return fn(*args, **(kwargs or {}))

            box["out"] = ctx.run(body)
        except BaseException as e:  # propagated to the caller below
            box["exc"] = e

    t = threading.Thread(
        target=worker, name=f"thunder-tpu-watchdog:{fn_name}", daemon=True
    )
    t.start()
    t.join(timeout)
    if t.is_alive():
        with _abandoned_lock:
            _abandoned.append(t)
        lines = list(trace_lines or [])
        suspect = _suspected_host()
        if obsm.enabled():
            obsm.WATCHDOG_TIMEOUTS.inc(fn=fn_name)
        # schedule appears only when the trace carried a certificate —
        # consumers detect certification by field presence, not null.
        extra = {"schedule": dict(schedule)} if schedule else {}
        obs_events.emit_event(
            "collective_timeout", fn=fn_name, timeout_s=timeout,
            lines=lines, suspected_host=suspect, **extra,
        )
        raise CollectiveTimeoutError(fn_name, timeout, lines, suspect, schedule)
    if "exc" in box:
        raise box["exc"]
    return box.get("out")


class _GuardedCallable:
    """The :func:`wrap` result: calls route through :func:`guard_call` when
    the watchdog is armed at call time (plain passthrough otherwise), and
    every other attribute access delegates to the wrapped callable, so a
    wrapped staged program keeps its ``staging``/``groups``/... attributes."""

    def __init__(self, fn: Callable, name: str,
                 trace_lines: Optional[Sequence[str]],
                 schedule: Optional[dict] = None):
        self.__wrapped__ = fn
        self._name = name
        self._trace_lines = trace_lines
        self._schedule = schedule
        self.__name__ = f"watchdog[{name}]"

    def __call__(self, *args, **kwargs):
        if active_timeout() is None:
            return self.__wrapped__(*args, **kwargs)
        return guard_call(self.__wrapped__, args, kwargs, fn_name=self._name,
                          trace_lines=self._trace_lines,
                          schedule=self._schedule)

    def __getattr__(self, item):
        return getattr(self.__wrapped__, item)

    def __repr__(self):
        return f"<watchdog-guarded {self.__wrapped__!r}>"


def wrap(fn: Callable, *, fn_name: Optional[str] = None,
         trace_lines: Optional[Sequence[str]] = None,
         schedule: Optional[dict] = None) -> Callable:
    """A callable that routes through :func:`guard_call` when the watchdog
    is armed at call time and is a plain passthrough otherwise — dispatch
    sites wrap once at build time and pay one probe per call. Non-call
    attribute access passes through to ``fn``. ``schedule`` is the certified per-axis collective order
    (``analysis.schedule.ScheduleCertificate.axis_labels()``) attached to
    any timeout diagnosis."""
    return _GuardedCallable(fn, fn_name or getattr(fn, "__name__", "?"),
                            trace_lines, schedule)


# =============================================================================
# SDC guard: cross-replica checksums
# =============================================================================


def array_crc32(arr) -> int:
    """crc32 over a host tensor's (or array's) bytes, contiguity-normalized:
    the one integrity checksum shared by the SDC replica guard and the
    tiered snapshot store (``resilience/snapshot.py``). A bf16 tensor is
    viewed as int16 first (numpy has no bf16), which gives the bytes, and so
    the crc, of the JAX package's ``np.asarray`` of the same values."""
    import numpy as np
    import torch

    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.contiguous().numpy()
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return zlib.crc32(arr)


def replica_layout(mesh=None, specs=None) -> Callable:
    """``replica_of(i, leaf) -> (key, ordinal, count)`` or None: where this
    rank's block of flat leaf ``i`` sits among its replicas. ``key`` is the
    block's index (this rank's coordinates on the axes the leaf's spec
    splits over): ranks with the same key hold replicas of the same block;
    ``ordinal`` is this rank's place among them and ``count`` their number.
    With no ``mesh`` every leaf is replicated over the whole world (pure
    data parallelism); a leaf whose spec splits it over every axis larger
    than one has a single replica, and is skipped."""
    import numpy as np
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return lambda i, leaf: None
    rank, world = dist.get_rank(), dist.get_world_size()
    if mesh is None:
        return (lambda i, leaf: ((), rank, world)) if world > 1 else (lambda i, leaf: None)
    from thunder_tpu_torch.parallel.sharding import _flat_specs

    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    where = np.argwhere(mesh.devices == rank)
    if not len(where):
        return lambda i, leaf: None
    coords = dict(zip(mesh.axis_names, (int(c) for c in where[0])))
    flat_specs = _flat_specs(specs) if specs is not None else None

    def replica_of(i, leaf):
        split = set(flat_specs[i].axes) if flat_specs is not None and flat_specs[i] is not None else set()
        free = [a for a in mesh.axis_names if a not in split and sizes[a] > 1]
        count = int(np.prod([sizes[a] for a in free])) if free else 1
        if count < 2:
            return None
        ordinal = 0
        for a in free:
            ordinal = ordinal * sizes[a] + coords[a]
        key = tuple(coords[a] for a in mesh.axis_names if a in split)
        return key, ordinal, count

    return replica_of


def replica_checksums(state, *, mesh=None, specs=None) -> dict:
    """Per-leaf, per-replica-group crc32 checksums of this rank's training
    state, all-gathered over the world: each rank's crc32 of every leaf that
    has replicas (:func:`replica_layout`). Returns ``{leaf_name:
    {block_index: {rank: crc}}}`` covering only leaves that have replicas;
    a fully sharded leaf is skipped without a host read."""
    import torch
    import torch.distributed as dist

    from thunder_tpu_torch.core.pytree import tree_flatten

    replica_of = replica_layout(mesh, specs)
    flat, _ = tree_flatten(state)
    mine: dict = {}
    for i, leaf in enumerate(flat):
        if not isinstance(leaf, torch.Tensor) or leaf.numel() == 0:
            continue
        where = replica_of(i, leaf)
        if where is None:
            continue
        mine[f"leaf{i}"] = (str(where[0]), array_crc32(leaf))
    if not mine:
        return {}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    out: dict = {}
    for rank, per_leaf in enumerate(gathered):
        for leaf, (idx, crc) in per_leaf.items():
            out.setdefault(leaf, {}).setdefault(idx, {})[rank] = crc
    return out


def divergent_leaves(checksums: dict) -> dict:
    """``{leaf: {block_index: {rank: crc}}}`` restricted to groups whose
    replicas disagree: empty means the state is replica-consistent."""
    bad: dict = {}
    for leaf, groups in checksums.items():
        for idx, per_dev in groups.items():
            if len(set(per_dev.values())) > 1:
                bad.setdefault(leaf, {})[idx] = dict(per_dev)
    return bad


def suspect_devices(divergence: dict) -> list:
    """Minority ranks per divergent group: the corrupted replicas (ties
    report every rank in the group)."""
    suspects: list = []
    for groups in divergence.values():
        for per_dev in groups.values():
            counts: dict = {}
            for crc in per_dev.values():
                counts[crc] = counts.get(crc, 0) + 1
            majority = max(counts.values())
            if majority == min(counts.values()):
                suspects.extend(per_dev)  # even split: all suspect
            else:
                suspects.extend(
                    d for d, crc in per_dev.items() if counts[crc] < majority
                )
    return sorted(set(suspects))


@dataclass
class SDCGuard:
    """Opt-in per-step silent-data-corruption guard for
    :func:`~thunder_tpu_torch.resilience.preemption.run_training`.

    ``check_every`` thins the checksum to every Nth step (the check costs a
    host read of every replicated leaf); ``max_reruns`` bounds the
    quarantine re-runs per divergent step; ``loss_spike_factor`` arms the
    loss heuristic: a finite loss larger than ``factor`` times the rolling
    median of the last ``history`` losses is treated as an SDC suspect too.
    ``mesh``/``specs`` (set by ``run_training``) say which leaves are
    replicated where."""

    check_every: int = 1
    max_reruns: int = 1
    loss_spike_factor: Optional[float] = None
    history: int = 8
    mesh: Any = field(default=None, repr=False)
    specs: Any = field(default=None, repr=False)
    _losses: list = field(default_factory=list, repr=False)

    def due(self, step: int) -> bool:
        return self.check_every > 0 and step % self.check_every == 0

    def check_state(self, state) -> dict:
        """Divergence report for ``state`` (empty dict = consistent). Every
        rank must call it: the crcs are all-gathered."""
        return divergent_leaves(replica_checksums(state, mesh=self.mesh, specs=self.specs))

    def loss_suspect(self, loss) -> bool:
        """Rolling-median spike heuristic over scalar losses (see class
        docstring); also trips on non-finite losses."""
        if self.loss_spike_factor is None:
            return False
        import math

        try:
            v = float(loss)
        except (TypeError, ValueError):
            return False
        if not math.isfinite(v):
            return True
        prior = sorted(abs(x) for x in self._losses[-self.history:])
        median = prior[len(prior) // 2] if len(prior) >= 3 else 0.0
        spike = median > 0 and abs(v) > self.loss_spike_factor * median
        if not spike:
            self._losses.append(v)  # a suspect loss must not skew the median
        return spike


def resolve_sdc_guard(value) -> Optional[SDCGuard]:
    """Normalize a ``run_training(sdc_guard=...)`` value: None/False off,
    True for a default :class:`SDCGuard`, or a configured instance."""
    if not value:
        return None
    if value is True:
        return SDCGuard()
    if isinstance(value, SDCGuard):
        return value
    raise TypeError(f"sdc_guard must be bool or SDCGuard, got {type(value).__name__}")
