"""Fleet autopilot: the policy engine that picks WHICH recovery to apply.

The counterpart of ``thunder_tpu/resilience/autopilot.py``. The recovery
layer's actuators (executor demotion, the compile de-opt ladder, the
collective watchdog, the elastic resume, the SDC quarantine and re-run,
checkpoint-and-halt) each fire in isolation; in production the faults arrive
mixed and concurrent. This module sits between the *signal streams* and the
*actuators*:

Signals (normalized into :class:`Signal`):

- ``CollectiveTimeoutError`` verdicts with suspect-host naming (watchdog);
- ``sdc_suspect`` divergences and persistent :class:`SDCDetectedError`;
- ``HostLost`` / ``Preempted`` step-boundary faults (preemption);
- out-of-memory and compile-failure escalations (the de-opt ladder consults
  the installed autopilot before climbing);
- ``analysis/events.host_health`` spread-ratio summaries
  (:meth:`Autopilot.note_host_health`): a host the observatory already
  flagged as a straggler skips the gentle same-mesh retry when it later
  hangs a collective;
- streaming-detector anomalies (:meth:`Autopilot.note_anomaly`), which
  decisions cite as evidence.

Actuators (``DECISION_RECOVERY_KINDS`` in ``analysis/events.py`` names each
one's recovery event):

===================  ========================================================
``elastic_resume``   checkpoint restore via :func:`~.elastic.elastic_resume`
                     (``mode`` ``same_mesh``, ``shrink`` or ``regrow``)
``quarantine_rerun`` the SDC guard's quarantine + re-run of a divergent step
``deopt_escalate``   the compile de-opt ladder climbs a level
``checkpoint_halt``  save a durable checkpoint and stop: the next process
                     resumes
``shrink_dp``        a slice died: shrink the data-parallel group to the
                     survivors (``resilience/federation.py`` applies it)
``regrow_dp``        a cooled-down slice cleared the rejoin hysteresis
===================  ========================================================

Every decision is a typed ``autopilot_decision`` event carrying its evidence
(signal kind, step, suspect host, hysteresis rung, fires-in-window), and must
be followed by its actuator's recovery event: the replay rule
``events.unactuated-decision`` enforces it, as ``events.unrecovered-fault``
does for injections.

**Hysteresis.** Repeated signals of one kind (keyed by suspect host) within
``window_s`` climb the policy's ladder; outside the window the count decays
to the first rung. ``backoff_s`` spaces actuator applications.

**Serialization.** Recoveries apply one at a time, inside
:meth:`Autopilot.recovery`, a critical section reentrant per thread; the
recorded ``recovery_intervals`` let tests assert no two overlapped.

**Shrinking on ranks.** The port is SPMD over processes, one rank a card,
and its mesh is the grid of ranks (``parallel.mesh``). A shrink in
:func:`run_autopiloted_training` is the smaller grid over the FIRST ranks:
the survivors bind their own group as the job's
(``distributed.runtime.job_scope``), so the recovery layer's agreements,
checkpoints and replica checks run over them alone, and a rank outside the
grid sits out the remaining steps. It waits on one world broadcast from
rank 0, which names the next mesh the job builds: a regrow brings it back
(it takes part in the restore), the end of the run releases it.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.observability import metrics as obsm

ACTUATORS = (
    "elastic_resume", "quarantine_rerun", "deopt_escalate", "checkpoint_halt",
    # Fleet actuators: shrink the data-parallel group away from a lost slice,
    # regrow it when the slice rejoins after hysteresis. Both actuate as the
    # elastic resume that re-enters training at the new width, applied by
    # the federation driver.
    "shrink_dp", "regrow_dp",
)

# Signal kinds the default policy table covers. Unknown kinds fall through
# to checkpoint_halt: an unclassified fault must degrade to the safest
# actuator (durable state, loud stop), never be silently retried.
SIGNAL_KINDS = (
    "host_loss", "collective_hang", "sdc_suspect", "sdc_persistent",
    "oom", "compile_fail", "preempt", "host_unhealthy",
    "slice_loss", "slice_recovered",
)


class AutopilotHalt(RuntimeError):
    """The autopilot chose ``checkpoint_halt``: a durable checkpoint exists
    and this process should exit; the next allocation resumes from it."""

    def __init__(self, step: int, reason: str, decision=None):
        self.step = step
        self.reason = reason
        self.decision = decision
        self.report: Optional["AutopilotReport"] = None  # attached by the driver
        super().__init__(
            f"autopilot halt at step {step}: {reason} — checkpoint is "
            f"durable; resume in a fresh process"
        )


@dataclass
class Signal:
    """One normalized fault/health observation the policy engine decides on.
    ``suspect_host`` keys the hysteresis history (per-host strike counts);
    ``evidence`` is free-form and lands verbatim in the decision event."""

    kind: str
    step: Optional[int] = None
    suspect_host: Optional[Any] = None
    evidence: dict = field(default_factory=dict)


@dataclass
class Policy:
    """Hysteresis ladder for one signal kind: the Nth signal within
    ``window_s`` (keyed by suspect host) applies ``ladder[min(N-1, last)]``.
    ``backoff_s`` is the base anti-thrash delay before applying the
    actuator, doubled per rung."""

    signal: str
    ladder: tuple  # of (actuator, mode-or-None)
    window_s: float = 300.0
    backoff_s: float = 0.0


def default_policies() -> dict[str, Policy]:
    """The policy table: the JAX package's, rung for rung."""
    return {p.signal: p for p in (
        # A dead host never comes back by retrying: shrink immediately;
        # two losses inside the window and the third halts (the mesh is
        # evaporating faster than it can reshard).
        Policy("host_loss",
               (("elastic_resume", "shrink"), ("elastic_resume", "shrink"),
                ("checkpoint_halt", None)),
               window_s=600.0),
        # A hang may be transient (ICI hiccup): first retry the same mesh
        # from the last checkpoint; a repeat within the window means the
        # suspect is flapping — shrink away from it; a third halts.
        Policy("collective_hang",
               (("elastic_resume", "same_mesh"), ("elastic_resume", "shrink"),
                ("checkpoint_halt", None)),
               window_s=120.0),
        # Transient bit-flips are the SDC guard's job (it bounds its own
        # reruns); the decision records that the quarantine path was chosen.
        Policy("sdc_suspect", (("quarantine_rerun", None),), window_s=60.0),
        # Corruption that survived the rerun budget is a bad device, not a
        # cosmic ray: shrink away from it, halt if it persists.
        Policy("sdc_persistent",
               (("elastic_resume", "shrink"), ("checkpoint_halt", None)),
               window_s=600.0),
        # Memory/compile pressure de-opts in place — the ladder itself is
        # bounded (THUNDER_TPU_MAX_RECOVERY_ATTEMPTS), so no escalation
        # rung is needed here.
        Policy("oom", (("deopt_escalate", None),), window_s=60.0),
        Policy("compile_fail", (("deopt_escalate", None),), window_s=60.0),
        # Preemption is an order, not a fault: save and stop.
        Policy("preempt", (("checkpoint_halt", None),), window_s=60.0),
        # A dead SLICE shrinks the DP group and keeps training on
        # the survivors; two losses inside the window still shrink (the
        # fleet has width to give), the third halts — slices are evaporating
        # faster than the fleet can rescale. Keyed on the slice id (the
        # signal's suspect_host), so two different flapping slices don't
        # share a strike count.
        Policy("slice_loss",
               (("shrink_dp", None), ("shrink_dp", None),
                ("checkpoint_halt", None)),
               window_s=600.0),
    )}


@dataclass
class Decision:
    """One policy-engine verdict, mirrored into an ``autopilot_decision``
    event. ``rung``/``fires_in_window`` expose the hysteresis state that
    produced it; the correlation rule pairs it with the actuator's recovery
    event (``DECISION_RECOVERY_KINDS``)."""

    id: int
    signal: Signal
    actuator: str
    mode: Optional[str] = None
    rung: int = 0
    fires_in_window: int = 0
    window_s: float = 0.0
    backoff_s: float = 0.0


class Autopilot:
    """The policy engine. One instance drives one training job; install it
    (:meth:`installed` / :func:`install`) so the seams that cannot take a
    parameter — the de-opt ladder inside the dispatcher, the SDC guard
    inside ``run_training`` — find it via :func:`current`.

    ``clock`` is injectable for deterministic hysteresis tests;
    ``spread_threshold``/``health_strikes`` govern when host-health
    summaries mark a host as a known straggler (which skips the gentle
    same-mesh rung on its next collective hang)."""

    def __init__(self, policies: Optional[dict] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 spread_threshold: float = 1.5, health_strikes: int = 2):
        self.policies = dict(policies) if policies is not None else default_policies()
        self._clock = clock
        self.spread_threshold = float(spread_threshold)
        self.health_strikes = int(health_strikes)
        self.decisions: list[Decision] = []
        self.recovery_intervals: list[tuple[float, float, int]] = []
        self._fires: dict = {}           # (kind, suspect) -> [ts, ...]
        self._health_strikes: dict = {}  # host -> consecutive flags
        self._flagged: set = set()       # hosts past the strike budget
        # Streaming-detector anomalies (observability/detect.py), newest
        # last; decide() cites the relevant one in its evidence so the soak
        # can measure detection lead time (anomaly ts -> decision ts).
        # Anomaly-earned straggler strikes live in their OWN time-windowed
        # ledger (timestamps, pruned on read) — unlike the health ledger,
        # no host_health summary ever runs to clear them, so they must
        # decay on their own or a transient slowdown would flag a host for
        # the rest of a week-long run.
        self._anomalies: deque = deque(maxlen=64)
        self._anomaly_strikes: dict = {}  # host -> [anomaly ts, ...]
        self.anomaly_cite_window_s = 300.0
        self.anomaly_strike_window_s = 600.0
        self._state_lock = threading.Lock()
        self._serial = threading.RLock()
        self._owner: Optional[int] = None
        self._depth = 0
        self._serialized_waits = 0
        self._active_decision_id: Optional[int] = None

    # -- signal intake --------------------------------------------------------

    def note_host_health(self, summary: Optional[dict]) -> None:
        """Consume a ``host_health`` summary (spread ratio + stragglers).
        A host flagged in ``health_strikes`` consecutive summaries becomes a
        known straggler: its next ``collective_hang`` decision starts one
        rung up the ladder (no same-mesh retry for a host the observatory
        already measured slow)."""
        if not summary:
            return
        with self._state_lock:
            stragglers = set(summary.get("stragglers") or ())
            for host in stragglers:
                n = self._health_strikes.get(host, 0) + 1
                self._health_strikes[host] = n
                if n >= self.health_strikes:
                    self._flagged.add(host)
            for host in list(self._health_strikes):
                if host not in stragglers:
                    self._health_strikes.pop(host, None)
                    self._flagged.discard(host)

    def _anomaly_flagged(self, now: Optional[float] = None) -> set:
        """Hosts with >= health_strikes warn+ anomalies inside the strike
        window. Pruned on read: anomaly flags DECAY — a host that stopped
        drifting earns its gentle same-mesh rung back. Called under
        _state_lock."""
        now = time.time() if now is None else now
        flagged = set()
        for host, ts in list(self._anomaly_strikes.items()):
            ts[:] = [t for t in ts if now - t <= self.anomaly_strike_window_s]
            if not ts:
                del self._anomaly_strikes[host]
            elif len(ts) >= self.health_strikes:
                flagged.add(host)
        return flagged

    def flagged_stragglers(self) -> set:
        with self._state_lock:
            return set(self._flagged) | self._anomaly_flagged()

    def note_anomaly(self, anomaly: Optional[dict]) -> None:
        """Consume one streaming-detector anomaly (
        ``observability/detect.DetectorBank`` routes every verdict here
        when an autopilot is installed). The anomaly joins the evidence
        ring that :meth:`decide` cites, and a warn+ anomaly naming a
        suspect host is a straggler strike: ``health_strikes`` of them
        inside ``anomaly_strike_window_s`` flag the host exactly like
        consecutive host_health summaries would — it loses the gentle
        same-mesh rung on its next hang BEFORE a watchdog timeout ever
        names it. The anomaly ledger is separate from the health one
        (health summaries clear on recovery; anomaly strikes decay by
        time) so the two feeders cannot erase each other's evidence."""
        if not anomaly:
            return
        rec = dict(anomaly)
        rec.setdefault("ts", time.time())
        with self._state_lock:
            self._anomalies.append(rec)
            host = rec.get("suspect_host")
            if host is not None and rec.get("severity") in ("warn", "critical"):
                self._anomaly_strikes.setdefault(host, []).append(
                    float(rec["ts"]))

    # Which anomaly kinds are evidence for which signal kinds: a slow/
    # drifting step backs the hang/loss ladders; a recompile storm backs
    # the compile-pressure ladder.
    _ANOMALY_RELEVANCE = {
        "collective_hang": ("step_time_drift", "goodput_drop", "host_spread",
                            "bottleneck_shift"),
        "host_loss": ("step_time_drift", "goodput_drop", "host_spread",
                      "bottleneck_shift"),
        "host_unhealthy": ("step_time_drift", "goodput_drop", "host_spread",
                           "bottleneck_shift"),
        "oom": ("recompile_storm",),
        "compile_fail": ("recompile_storm",),
        # A DCN-tier spread verdict is evidence for the slice ladder: the
        # slow slice was already a named suspect before it died;
        # so is the fleet timeline's bottleneck_shift — the critical path
        # had already moved onto straggler-wait / exposed DCN.
        "slice_loss": ("slice_spread", "goodput_drop", "bottleneck_shift"),
    }

    def _cite_anomaly(self, signal: Signal) -> Optional[dict]:
        """The newest relevant anomaly within the citation window (wall
        clock — anomaly timestamps come from the detectors' ``time.time``),
        host-matched when both sides name one. Called under _state_lock."""
        kinds = self._ANOMALY_RELEVANCE.get(signal.kind)
        if not kinds:
            return None
        now = time.time()
        for rec in reversed(self._anomalies):
            if rec.get("anomaly") not in kinds:
                continue
            if now - float(rec.get("ts") or 0.0) > self.anomaly_cite_window_s:
                continue
            a_host = rec.get("suspect_host")
            if (signal.suspect_host is not None and a_host is not None
                    and signal.suspect_host != a_host):
                continue
            return {
                "anomaly": rec.get("anomaly"),
                "severity": rec.get("severity"),
                "ts": rec.get("ts"),
                "value": rec.get("value"),
                "baseline": rec.get("baseline"),
                "suspect_host": a_host,
            }
        return None

    def signal_from_exception(self, exc: BaseException) -> Signal:
        """Normalize a fault exception raised out of the training loop. An
        out-of-memory (``torch.OutOfMemoryError``, or the chaos seam's
        injected one, which carries the CUDA allocator's message) is the
        ``oom`` signal the de-opt ladder decides on."""
        from thunder_tpu_torch.resilience import demotion
        from thunder_tpu_torch.resilience.preemption import HostLost, Preempted
        from thunder_tpu_torch.resilience.watchdog import (
            CollectiveTimeoutError,
            SDCDetectedError,
        )

        if isinstance(exc, HostLost):
            return Signal("host_loss", step=exc.step,
                          evidence={"path": exc.path})
        if isinstance(exc, Preempted):
            return Signal("preempt", step=exc.step,
                          evidence={"path": exc.path})
        if isinstance(exc, CollectiveTimeoutError):
            return Signal("collective_hang", suspect_host=exc.suspected_host,
                          evidence={"fn": exc.fn_name,
                                    "timeout_s": exc.timeout_s,
                                    "lines": list(exc.trace_lines)})
        if isinstance(exc, SDCDetectedError):
            return Signal("sdc_persistent", step=exc.step,
                          evidence={"leaves": list(exc.leaves)})
        if demotion.classify_failure(exc) == demotion.OOM:
            return Signal("oom", evidence={"error": str(exc)})
        return Signal(type(exc).__name__, evidence={"error": str(exc)})

    # -- the decision ---------------------------------------------------------

    def decide(self, signal: Signal) -> Decision:
        """Pick the actuator for ``signal`` per the policy table and the
        hysteresis state, record the firing, and emit the
        ``autopilot_decision`` event. Pure bookkeeping — the caller applies
        the actuator (inside :meth:`recovery`)."""
        with self._state_lock:
            policy = self.policies.get(signal.kind)
            if policy is None:
                # Unknown signal: the safe actuator, single-rung.
                policy = Policy(signal.kind, (("checkpoint_halt", None),))
            now = self._clock()
            key = (signal.kind, signal.suspect_host)
            hist = self._fires.setdefault(key, [])
            hist[:] = [t for t in hist if now - t <= policy.window_s]
            rung = min(len(hist), len(policy.ladder) - 1)
            if (signal.kind == "collective_hang"
                    and (signal.suspect_host in self._flagged
                         or signal.suspect_host in self._anomaly_flagged())
                    and rung == 0 and len(policy.ladder) > 1):
                # The observatory already measured this host slow: skip the
                # same-mesh retry rung, go straight to shrinking away.
                rung = 1
            hist.append(now)
            actuator, mode = policy.ladder[rung]
            # Cite the streaming-detector evidence: a decision
            # whose fault the detectors saw coming carries the anomaly in
            # its evidence — the soak's detection-lead-time join keys on
            # exactly this (decision ts − cited anomaly ts).
            cited = self._cite_anomaly(signal)
            if cited is not None:
                signal.evidence = dict(signal.evidence or {})
                signal.evidence["anomaly"] = cited
            decision = Decision(
                id=0, signal=signal, actuator=actuator,
                mode=mode, rung=rung, fires_in_window=len(hist),
                window_s=policy.window_s,
                backoff_s=policy.backoff_s * (2 ** rung) if policy.backoff_s else 0.0,
            )
        return self._record(decision)

    def _record(self, decision: Decision) -> Decision:
        """The one writer of decision records: id assignment, the
        ``autopilot_decision`` event, and the actuator metric — shared by
        :meth:`decide` and the non-fault regrow path so the event shape
        cannot diverge between producers."""
        with self._state_lock:
            decision.id = len(self.decisions) + 1
            self.decisions.append(decision)
        if obsm.enabled():
            obsm.AUTOPILOT_DECISIONS.inc(actuator=decision.actuator)
        extra = {"mode": decision.mode} if decision.mode else {}
        obs_events.emit_event(
            "autopilot_decision",
            decision_id=decision.id,
            signal=decision.signal.kind,
            actuator=decision.actuator,
            step=decision.signal.step,
            suspect_host=decision.signal.suspect_host,
            rung=decision.rung,
            fires_in_window=decision.fires_in_window,
            window_s=decision.window_s,
            evidence=decision.signal.evidence or None,
            **extra,
        )
        return decision

    # -- serialized application -----------------------------------------------

    @contextlib.contextmanager
    def recovery(self, decision: Decision):
        """Critical section for applying ``decision``'s actuator: one
        recovery at a time across threads (reentrant within one thread, so
        a recovery that triggers a nested fault handles it as one chain).
        Sleeps the decision's hysteresis backoff before yielding and records
        the (start, end, decision_id) interval for the serialization
        assertions."""
        me = threading.get_ident()
        if self._owner is not None and self._owner != me:
            with self._state_lock:
                self._serialized_waits += 1
        self._serial.acquire()
        try:
            self._owner = me
            self._depth += 1
            self._active_decision_id = decision.id
            if decision.backoff_s:
                time.sleep(decision.backoff_s)
            t0 = self._clock()
            try:
                yield
            finally:
                self.recovery_intervals.append((t0, self._clock(), decision.id))
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._active_decision_id = None
            self._serial.release()

    def debug_state(self, last: int = 16) -> dict:
        """The ops-plane ``/debug/state`` view: live strike ladders, flagged
        stragglers, recent anomalies, and the last ``last`` decisions."""
        with self._state_lock:
            return {
                "strikes": {
                    f"{kind}@{host}": len(ts)
                    for (kind, host), ts in sorted(
                        self._fires.items(), key=lambda kv: str(kv[0]))
                    if ts
                },
                "flagged_stragglers": sorted(
                    set(self._flagged) | self._anomaly_flagged(), key=str),
                "anomalies": list(self._anomalies)[-last:],
                "decisions": [
                    {"id": d.id, "signal": d.signal.kind,
                     "actuator": d.actuator, "mode": d.mode, "rung": d.rung,
                     "suspect_host": d.signal.suspect_host}
                    for d in self.decisions[-last:]
                ],
                "serialized_waits": self._serialized_waits,
            }

    def stats(self) -> dict:
        """Decision/recovery accounting for reports and tests."""
        by_actuator: dict[str, int] = {}
        for d in self.decisions:
            by_actuator[d.actuator] = by_actuator.get(d.actuator, 0) + 1
        return {
            "decisions": len(self.decisions),
            "by_actuator": by_actuator,
            "recoveries": len(self.recovery_intervals),
            "serialized_waits": self._serialized_waits,
            "flagged_stragglers": sorted(self.flagged_stragglers(), key=str),
        }

    # -- installation ---------------------------------------------------------

    @contextlib.contextmanager
    def installed(self):
        """Make this the process's active autopilot within the scope — the
        de-opt ladder and the SDC guard consult :func:`current`."""
        tok = _current.set(self)
        prev, _process["autopilot"] = _process["autopilot"], self
        try:
            yield self
        finally:
            _current.reset(tok)
            _process["autopilot"] = prev


_current: contextvars.ContextVar[Optional[Autopilot]] = contextvars.ContextVar(
    "thunder_tpu_torch_autopilot", default=None
)
# The autopilot installed last in the process, for readers on threads of
# their own (the ops plane's HTTP handlers), which do not see the context
# the installing thread set.
_process: dict = {"autopilot": None}


def current() -> Optional[Autopilot]:
    """The installed autopilot, or None — seams that cannot take a
    parameter (deopt.escalate, the SDC guard) ask here before deciding."""
    return _current.get()


def in_process() -> Optional[Autopilot]:
    """:func:`current`, else the autopilot installed last anywhere in the
    process: what ``/debug/state`` shows from the ops server's threads."""
    return _current.get() or _process["autopilot"]


def install(ap: Optional[Autopilot]):
    """Process-wide installation (None uninstalls); prefer the scoped
    :meth:`Autopilot.installed` where a ``with`` block fits."""
    _current.set(ap)
    _process["autopilot"] = ap
    return ap


# =============================================================================
# Mesh reshaping helpers
# =============================================================================


def shrink_shape(shape: dict, order=("fsdp", "tp", "dp")) -> Optional[dict]:
    """Halve the first axis in ``order`` (then any axis) still > 1: "half
    the machines survived" as a shape transform. None when the mesh is
    already a single rank (nothing left to shrink onto)."""
    axes = [a for a in order if shape.get(a, 1) > 1]
    axes += [a for a in shape if a not in order and shape[a] > 1]
    if not axes:
        return None
    out = dict(shape)
    out[axes[0]] = out[axes[0]] // 2
    return out


def _make_mesh(shape: dict):
    """The grid of ``shape`` over the first ranks (``parallel.make_mesh``);
    every rank of the world calls it, as ``make_mesh`` requires."""
    from thunder_tpu_torch.parallel import make_mesh

    return make_mesh(**{k: int(v) for k, v in shape.items()})


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _members(mesh) -> Optional[list]:
    """The global ranks of ``mesh`` when they are fewer than the world's
    (a shrunk grid over the first ranks), else None."""
    devices = getattr(mesh, "devices", None)
    if devices is None or _world() <= 1:
        return None
    ranks = sorted(int(r) for r in devices.reshape(-1))
    return ranks if len(ranks) < _world() else None


def _job_group(mesh):
    """The survivors' process group of a shrunk ``mesh`` (None for a mesh
    over the whole world). ``new_group`` is collective over the world:
    every rank calls this, after the same :func:`_make_mesh`."""
    members = _members(mesh)
    if members is None:
        return None
    import torch.distributed as dist

    return dist.new_group(members)


def _in_mesh(mesh) -> bool:
    members = _members(mesh)
    if members is None:
        return True
    import torch.distributed as dist

    return dist.get_rank() in members


def _world_message(msg=None):
    """Rank 0's ``msg``, received by every rank of the world: how a rank
    sitting out learns what the survivors do next."""
    import torch
    import torch.distributed as dist

    box = [msg]
    device = None
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


# =============================================================================
# The autopiloted training driver
# =============================================================================


@dataclass
class AutopilotReport:
    """What :func:`run_autopiloted_training` hands back besides the state."""

    losses: list = field(default_factory=list)
    decisions: list = field(default_factory=list)
    final_mesh_shape: Optional[dict] = None
    recoveries: int = 0
    halted: Optional[AutopilotHalt] = None
    steps_executed: int = 0  # includes re-executed (wasted) steps


def run_autopiloted_training(
    autopilot: Autopilot,
    build_for_mesh: Callable,
    init_state: Any,
    n_steps: int,
    *,
    manager,
    mesh,
    specs_for_mesh: Callable,
    sdc_guard=True,
    watchdog_timeout_s: Optional[float] = None,
    save_every: int = 0,
    snapshot_every: int = 0,
    on_step: Optional[Callable] = None,
    regrow_after: Optional[int] = None,
    max_recoveries: int = 32,
    warm_start: bool = True,
) -> tuple[Any, AutopilotReport]:
    """Drive training to ``n_steps`` under the autopilot: faults raised out
    of :func:`~.preemption.run_training` are normalized into signals, the
    policy engine picks the actuator, and this loop applies it: elastic
    resume (same mesh, shrunk mesh, regrow), or checkpoint-and-halt
    (:class:`AutopilotHalt`). The quarantine-rerun and de-opt actuators fire
    *inside* the step through the installed-autopilot hooks.

    ``build_for_mesh(mesh) -> step_fn`` (``step_fn(state) -> (state, loss)``,
    not updating its input state in place when ``sdc_guard`` is on) and
    ``specs_for_mesh(mesh) -> P tree`` rebuild the workload for whatever
    mesh survives; ``state`` holds this rank's blocks by those specs.
    ``regrow_after`` N healthy post-shrink steps reshard back up to the
    original mesh. An anchor checkpoint is written up front so the first
    recovery always has something to resume from. ``snapshot_every``
    forwards to :func:`~.preemption.run_training`'s RAM-snapshot cadence:
    with a :class:`~.snapshot.SnapshotStore` attached to ``manager``, every
    ``elastic_resume`` here restores from the newest valid tier and its
    event names the tier.

    On several ranks a shrink is the smaller grid over the first ranks (the
    module docstring): a rank outside it sits out until a regrow brings it
    back or the run ends, and its report holds no loss for the steps it sat
    out. Returns ``(state, AutopilotReport)``; losses are indexed by step
    (re-executed steps overwrite, so each step counts once)."""
    from thunder_tpu_torch import api
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.resilience import elastic
    from thunder_tpu_torch.resilience.preemption import (
        HostLost,
        Preempted,
        run_training,
    )
    from thunder_tpu_torch.resilience.watchdog import (
        CollectiveTimeoutError,
        SDCDetectedError,
    )

    full_shape = elastic.mesh_shape(mesh)
    cur_mesh = mesh
    cur_shape = dict(full_shape or {})
    cur_specs = specs_for_mesh(cur_mesh)
    job = None  # the survivors' group while the grid is smaller than the world
    sat_out = False  # ranks outside the grid wait for rank 0's next message
    state = init_state
    report = AutopilotReport(losses=[None] * n_steps, final_mesh_shape=cur_shape)
    shrunk_at: Optional[int] = None  # step the mesh last shrank at

    if manager.latest_complete_step() is None:
        # Recovery anchor: elastic_resume (the recovery event every
        # elastic decision must be followed by) needs a checkpoint on disk.
        manager.save(state, 0, rng_seed=api._global_rng["seed"], mesh=cur_mesh, specs=cur_specs)
    # The driver owns every restore: elastic_resume lays the restored leaves
    # out on the current mesh, so run_training always gets start_step and
    # never resumes on its own.
    state, start = elastic.elastic_resume(manager, state, mesh=cur_mesh, specs=cur_specs)

    def _remesh(shape: dict):
        """The grid of ``shape`` and its job group, built by every rank."""
        nonlocal job, sat_out
        target = _make_mesh(shape)
        job = _job_group(target)
        sat_out = not _in_mesh(target)
        return target

    def _elastic(decision: Decision, target_mesh, target_shape):
        nonlocal state, start, cur_mesh, cur_shape, cur_specs
        with autopilot.recovery(decision):
            cur_mesh, cur_shape = target_mesh, dict(target_shape)
            report.final_mesh_shape = cur_shape
            if sat_out:
                return
            cur_specs = specs_for_mesh(target_mesh)
            with runtime.job_scope(job):
                state, start = elastic.elastic_resume(manager, state, mesh=target_mesh, specs=cur_specs)
            report.recoveries += 1

    def _on_loss(step, loss):
        report.losses[step] = loss
        report.steps_executed += 1
        if on_step is not None:
            on_step(step, loss)

    def _tell(msg) -> None:
        # Rank 0 (always a survivor: the grid is over the first ranks)
        # tells the ranks sitting out what the job does next.
        if job is not None:
            _world_message(msg)

    def _halt(step: int, reason: str, decision, exc):
        report.decisions = list(autopilot.decisions)
        report.halted = AutopilotHalt(step, reason, decision)
        report.halted.report = report
        _tell(("end", None))
        # Black-box dump: every halt leaves the ring's preceding context on
        # disk next to the durable checkpoint.
        obs_events.flight_dump("autopilot_halt")
        raise report.halted from exc

    def _save(step: int) -> None:
        with runtime.job_scope(job):
            manager.save(state, step, rng_seed=api._global_rng["seed"], mesh=cur_mesh, specs=cur_specs)

    warmed: set = set()

    with autopilot.installed():
        while True:
            if sat_out:
                # Outside the grid: wait for the survivors' next mesh (a
                # regrow brings this rank back) or the end of the run.
                kind, info = _world_message()
                if kind == "end":
                    report.decisions = list(autopilot.decisions)
                    return state, report
                step, healthy, shape = info
                target = _remesh(shape)
                _elastic(_decide_regrow(autopilot, step, healthy), target, shape)
                shrunk_at = None
                continue
            step_fn = build_for_mesh(cur_mesh)
            shape_key = tuple(sorted(cur_shape.items()))
            if warm_start and shape_key not in warmed:
                # One discarded step OUTSIDE the watchdog: the first call on
                # a freshly built mesh step pays the compile, and a cold
                # compile inside the guarded dispatch reads as a hang, which
                # would climb the collective_hang ladder on a healthy mesh.
                with runtime.job_scope(job):
                    step_fn(state)
                warmed.add(shape_key)
            # After a shrink, run only up to the regrow boundary so the
            # driver gets the state back at a step edge and can reshard up.
            target = n_steps
            if regrow_after and shrunk_at is not None and cur_shape != full_shape:
                target = min(n_steps, (start or 0) + regrow_after)
            try:
                with runtime.job_scope(job):
                    state, _ = run_training(
                        step_fn, state, target,
                        manager=manager, mesh=cur_mesh, specs=cur_specs, sdc_guard=sdc_guard,
                        watchdog_timeout_s=watchdog_timeout_s,
                        save_every=save_every, snapshot_every=snapshot_every,
                        on_loss=_on_loss,
                        start_step=start,
                    )
                if target >= n_steps:
                    report.decisions = list(autopilot.decisions)
                    _tell(("end", None))
                    return state, report
                # Healthy through the regrow window: checkpoint at the
                # boundary and reshard back up to the full mesh.
                _save(target)
                decision = _decide_regrow(autopilot, target, regrow_after)
                _tell(("regrow", (target, regrow_after, full_shape)))
                _elastic(decision, _remesh(full_shape), full_shape)
                shrunk_at = None
                continue
            except Preempted as e:
                # The checkpoint_halt decision was emitted inside
                # run_training before the save; this process stops here.
                _halt(e.step, "preemption", None, e)
            except (HostLost, CollectiveTimeoutError, SDCDetectedError) as e:
                if report.recoveries >= max_recoveries:
                    _tell(("end", None))
                    raise
                signal = autopilot.signal_from_exception(e)
                decision = autopilot.decide(signal)
                if decision.actuator == "checkpoint_halt":
                    with autopilot.recovery(decision):
                        _save(start if start is not None else 0)
                    _halt(signal.step or 0, f"policy ladder exhausted for {signal.kind}", decision, e)
                new_shape = shrink_shape(cur_shape) if decision.mode == "shrink" else None
                if decision.mode == "shrink" and (new_shape is None or job is not None):
                    # Nothing left to shrink onto (or ranks already sit out,
                    # and a new grid is built by the whole world): halt.
                    with autopilot.recovery(decision):
                        _save(start or 0)
                    _halt(signal.step or 0, "mesh exhausted", decision, e)
                if new_shape is not None:
                    _elastic(decision, _remesh(new_shape), new_shape)
                    shrunk_at = start
                else:  # same_mesh
                    _elastic(decision, cur_mesh, cur_shape)
                continue


def _decide_regrow(autopilot: Autopilot, step: int, healthy: Optional[int]) -> Decision:
    """The regrow decision: not fault-triggered, so it bypasses the policy
    ladder: a healthy window elapsed and replacement capacity is assumed
    back (the stand-in for a scheduler granting a new host)."""
    return autopilot._record(Decision(
        id=0,
        signal=Signal("host_recovered", step=step,
                      evidence={"healthy_steps": healthy}),
        actuator="elastic_resume", mode="regrow",
    ))


def decide_regrow_dp(autopilot: Autopilot, slice_: int, step: Optional[int],
                     evidence: Optional[dict] = None) -> Decision:
    """The fleet regrow decision: emitted when the federation ledger
    promotes a cooled-down slice back to active. A recovery, not a fault, so
    like :func:`_decide_regrow` it bypasses the policy ladder, but still
    flows through :meth:`Autopilot._record` so the decision is a
    replay-required event like every other actuator's."""
    return autopilot._record(Decision(
        id=0,
        signal=Signal("slice_recovered", step=step,
                      suspect_host=f"slice{slice_}",
                      evidence=dict(evidence or {})),
        actuator="regrow_dp",
    ))
