"""Slice-granular failure domains: the fleet controller.

The counterpart of ``thunder_tpu/resilience/federation.py``. The recovery
layer below this one treats a HOST as the unit of failure; on a fleet
federated over a slower cross-slice network the unit is a **slice**: a block
of devices that lives or dies together (a maintenance drain, a power domain,
a partition takes out the whole slice). This module owns that failure
domain:

- :class:`FederationLedger`: slice membership as a TYPED ledger: every slice
  is ``active`` / ``lost`` / ``cooldown`` and every transition is a
  ``slice_state`` event, so the fleet's membership history is
  reconstructable from the log alone;
- :class:`FleetController`: the shrink/regrow state machine. On slice loss,
  shrink the data-parallel group and keep training on the survivors (the
  ``shrink_dp`` actuator; gradient accumulation rescales loss-equivalently
  so the global batch is unchanged). On recovery, the slice enters
  **cooldown** behind a rejoin backoff with hysteresis: it rejoins
  (``regrow_dp``) only after staying healthy for the full window, so a
  flapping slice degrades the fleet ONCE;
- :func:`run_federated_training`: the federated driver over emulated
  slices, wiring the chaos slice seams (``slice_loss``, ``dcn_partition``,
  ``slice_slow``, ``slice_flap``) through the controller and the tiered
  restore. The emulation is the caller's ``mesh_for_width``: one rank (the
  whole fleet in one process), or the gloo ranks of a federated grid, where
  the JAX package emulates the slices on virtual devices in one process.

Cross-slice checkpoint replication rides the peer-snapshot tier
(``resilience/snapshot.SnapshotStore.make_ring``): each slice's snapshots
replicate to a buddy slice across the slice boundary, so a whole-slice loss
restores from the buddy's RAM (``restore`` event ``tier="peer"``) and the
disk tier is never touched in a slice-loss recovery.

Loss equivalence of the shrink: at full width ``W`` slices the global batch
is ``W x per_slice_batch x grad_accum``. After shrinking to ``w`` survivors,
:meth:`FleetController.grad_accum_for` returns ``ceil(grad_accum x W / w)``:
the survivors run more accumulation micro-steps so each optimizer step
still sees (at least) the same global batch: fewer tokens/s, same
tokens/step.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from thunder_tpu_torch.observability import events as obs_events
from thunder_tpu_torch.resilience import chaos
from thunder_tpu_torch.resilience.autopilot import (
    Autopilot,
    AutopilotHalt,
    Decision,
    Signal,
    decide_regrow_dp,
)

SLICE_STATES = ("active", "lost", "cooldown")

# The process-wide membership ledger the ops plane reads (/healthz rolls
# up per-slice health; /debug/state exposes the full ledger). Installed by
# FleetController construction — one fleet controller per process, like
# the autopilot's `current()`.
_state: dict = {"ledger": None}


def install_ledger(ledger: Optional["FederationLedger"]) -> None:
    """Install (or, with None, clear) the ledger ``current_ledger`` serves."""
    _state["ledger"] = ledger


def current_ledger() -> Optional["FederationLedger"]:
    return _state["ledger"]


@dataclass
class SliceEntry:
    """One slice's row in the membership ledger. ``recovered_at`` is the
    controller-clock time the slice last came back (cooldown entry) — the
    stability window the rejoin hysteresis measures from; a re-failure
    inside cooldown clears it, restarting the window."""

    slice_id: int
    state: str = "active"
    lost_at: Optional[float] = None
    recovered_at: Optional[float] = None
    losses: int = 0

    def as_dict(self) -> dict:
        return {
            "slice": self.slice_id, "state": self.state,
            "losses": self.losses, "lost_at": self.lost_at,
            "recovered_at": self.recovered_at,
        }


class FederationLedger:
    """Typed slice-membership ledger — the single writer of ``slice_state``
    events, so the transition history in the log IS the membership history
    (no second bookkeeping path can diverge from it). Transitions are the
    edges of the state machine only: active→lost, lost→cooldown,
    cooldown→lost (re-failure), cooldown→active (promotion); anything else
    raises — a fleet controller that tries an illegal edge has a logic
    bug, and silently absorbing it would corrupt the replay."""

    def __init__(self, n_slices: int, *,
                 clock: Callable[[], float] = time.monotonic):
        if n_slices < 1:
            raise ValueError(f"a fleet needs >= 1 slice, got {n_slices}")
        self.n_slices = int(n_slices)
        self._clock = clock
        self.entries = {i: SliceEntry(i) for i in range(self.n_slices)}
        self.transitions: list[tuple[int, str, str, str]] = []

    _EDGES = {
        ("active", "lost"), ("lost", "cooldown"),
        ("cooldown", "lost"), ("cooldown", "active"),
    }

    def _transition(self, slice_: int, to: str, reason: str) -> SliceEntry:
        e = self.entries[int(slice_)]
        frm = e.state
        if (frm, to) not in self._EDGES:
            raise ValueError(
                f"illegal slice state transition {frm!r} -> {to!r} for "
                f"slice {slice_} ({reason})"
            )
        e.state = to
        now = self._clock()
        if to == "lost":
            e.lost_at = now
            e.recovered_at = None
            e.losses += 1
        elif to == "cooldown":
            e.recovered_at = now
        self.transitions.append((e.slice_id, frm, to, reason))
        obs_events.emit_event(
            "slice_state", slice=e.slice_id, to=to, reason=reason,
            **{"from": frm},
        )
        return e

    def mark_lost(self, slice_: int, reason: str = "slice_loss") -> SliceEntry:
        return self._transition(slice_, "lost", reason)

    def mark_cooldown(self, slice_: int,
                      reason: str = "slice_recovered") -> SliceEntry:
        return self._transition(slice_, "cooldown", reason)

    def promote(self, slice_: int, reason: str = "rejoin") -> SliceEntry:
        return self._transition(slice_, "active", reason)

    def active_slices(self) -> list[int]:
        return [i for i, e in sorted(self.entries.items())
                if e.state == "active"]

    def width(self) -> int:
        """Current data-parallel width in slices."""
        return len(self.active_slices())

    def state_of(self, slice_: int) -> str:
        return self.entries[int(slice_)].state

    def debug_state(self) -> dict:
        """The ops-plane ``/debug/state`` view of fleet membership."""
        return {
            "n_slices": self.n_slices,
            "width": self.width(),
            "slices": [self.entries[i].as_dict()
                       for i in range(self.n_slices)],
            "transitions": [
                {"slice": s, "from": f, "to": t, "reason": r}
                for s, f, t, r in self.transitions[-32:]
            ],
        }


class FleetController:
    """The shrink/regrow state machine over a :class:`FederationLedger`.

    ``rejoin_backoff_s`` is the minimum hold-out after a slice recovers;
    ``hysteresis_s`` is the stability window it must survive WITHOUT
    re-failing. Both are measured on the injectable ``clock`` from the
    cooldown entry (``recovered_at``), and a re-failure restarts the
    window — so a slice flapping faster than the window never rejoins
    until it genuinely stabilizes, and the fleet pays exactly one shrink
    for the whole episode.

    Decisions flow through the autopilot: a loss is a ``slice_loss``
    signal decided on the policy ladder (``shrink_dp`` — or
    ``checkpoint_halt`` when slices evaporate faster than the window), a
    promotion is a ladder-bypassing ``regrow_dp`` record
    (:func:`~.autopilot.decide_regrow_dp`). Both are replay-required
    events; the driver applies each inside ``autopilot.recovery`` so no
    two fleet actuations overlap."""

    def __init__(self, ledger: FederationLedger, autopilot: Autopilot, *,
                 rejoin_backoff_s: float = 1.0, hysteresis_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None):
        self.ledger = ledger
        self.autopilot = autopilot
        self.rejoin_backoff_s = float(rejoin_backoff_s)
        self.hysteresis_s = float(hysteresis_s)
        self._clock = clock if clock is not None else ledger._clock
        install_ledger(ledger)

    # -- loss / recovery intake -----------------------------------------------

    def on_slice_loss(self, slice_: int, step: Optional[int] = None,
                      reason: str = "slice_loss") -> Optional[Decision]:
        """A slice died. Returns the shrink (or halt) decision when the
        fleet must actually degrade, None when it already has:

        - ``active`` → ``lost``: decide on the ``slice_loss`` ladder —
          normally ``shrink_dp``;
        - ``cooldown`` → ``lost``: a re-failure inside the rejoin window.
          The fleet never regrew, so there is nothing to shrink — the
          ledger records the flap and the hold-out restarts. This is the
          edge that makes a flapping slice degrade once;
        - ``lost``: duplicate report, no-op."""
        state = self.ledger.state_of(slice_)
        if state == "lost":
            return None
        if state == "cooldown":
            self.ledger.mark_lost(slice_, reason="flap_refailure")
            return None
        self.ledger.mark_lost(slice_, reason=reason)
        return self.autopilot.decide(Signal(
            "slice_loss", step=step, suspect_host=f"slice{int(slice_)}",
            evidence={"slice": int(slice_), "reason": reason},
        ))

    def on_slice_recovered(self, slice_: int,
                           step: Optional[int] = None) -> None:
        """A lost slice reports healthy again. It does NOT rejoin: it
        enters cooldown, and :meth:`poll` promotes it only after the
        backoff + hysteresis window passes without another failure."""
        if self.ledger.state_of(slice_) == "lost":
            self.ledger.mark_cooldown(slice_)

    def poll(self, step: Optional[int] = None) -> Optional[Decision]:
        """Promote at most ONE cooled-down slice whose stability window has
        cleared (oldest recovery first), returning its ``regrow_dp``
        decision — the driver applies one regrow at a time so each
        resharding lands at a step boundary."""
        now = self._clock()
        hold = max(self.rejoin_backoff_s, self.hysteresis_s)
        ready = [
            e for e in self.ledger.entries.values()
            if e.state == "cooldown" and e.recovered_at is not None
            and now - e.recovered_at >= hold
        ]
        if not ready:
            return None
        e = min(ready, key=lambda e: e.recovered_at)
        stable_s = now - e.recovered_at
        self.ledger.promote(e.slice_id)
        return decide_regrow_dp(
            self.autopilot, e.slice_id, step,
            evidence={"stable_s": round(stable_s, 3),
                      "rejoin_backoff_s": self.rejoin_backoff_s,
                      "hysteresis_s": self.hysteresis_s},
        )

    # -- degraded-mode arithmetic ----------------------------------------------

    def grad_accum_for(self, base: int = 1) -> int:
        """Gradient-accumulation factor at the CURRENT width that keeps the
        global batch loss-equivalent to full width (see module docstring).
        Ceil, so a non-divisible shrink errs on the side of a slightly
        larger batch rather than a smaller one."""
        width = self.ledger.width()
        if width < 1:
            raise AutopilotHalt(0, "fleet exhausted: no active slices")
        return math.ceil(int(base) * self.ledger.n_slices / width)


# =============================================================================
# The federated training driver
# =============================================================================


@dataclass
class FleetReport:
    """What :func:`run_federated_training` hands back besides the state."""

    losses: list = field(default_factory=list)
    decisions: list = field(default_factory=list)
    shrinks: int = 0
    regrows: int = 0
    full_width: int = 0
    final_width: int = 0
    steps_executed: int = 0       # includes re-executed (wasted) steps
    degraded_steps: int = 0       # steps run at reduced width
    partitioned_steps: int = 0    # steps with the DCN tier severed
    halted: Optional[AutopilotHalt] = None


def run_federated_training(
    controller: FleetController,
    build_for_width: Callable,
    init_state: Any,
    n_steps: int,
    *,
    manager,
    mesh_for_width: Callable,
    stores: Optional[list] = None,
    grad_accum: int = 1,
    snapshot_every: int = 0,
    save_every: int = 0,
    recover_after: Optional[int] = None,
    on_step: Optional[Callable] = None,
    slice_step_time: Optional[Callable] = None,
    timeline=None,
    warm_start: bool = True,
    max_recoveries: int = 32,
) -> tuple[Any, FleetReport]:
    """Drive an emulated federated fleet to ``n_steps`` under the
    controller: the chaos slice seams fire at step boundaries, losses
    shrink the DP width through the autopilot's ``shrink_dp`` decisions,
    and cooled-down slices regrow through ``regrow_dp`` — all without a
    process restart.

    - ``build_for_width(mesh, width, accum) -> step_fn`` rebuilds the
      workload for the surviving width (``step_fn(state) -> (state,
      loss)``); ``accum`` is the loss-equivalent gradient-accumulation
      factor (:meth:`FleetController.grad_accum_for`).
    - ``mesh_for_width(width) -> (mesh, specs)`` builds the emulated mesh
      spanning ``width`` slices and the matching tree of ``P`` (this
      rank's blocks of the state); on ranks every rank calls it alike.
    - ``stores`` is one ring-wired :class:`~.snapshot.SnapshotStore` per
      slice (``SnapshotStore.make_ring``); the driver keeps the manager's
      store on the lowest ACTIVE slice, fans each snapshot out to every
      other active slice, and — on a slice loss — restores through the
      VICTIM's store so the read lands on the cross-slice buddy's peer-RAM
      tier (never disk).
    - ``recover_after`` N steps after a ``slice_loss``, the victim reports
      healthy again (the stand-in for the scheduler re-granting the
      slice); rejoin then waits out the controller's backoff + hysteresis.
    - ``slice_step_time(slice_id, seconds)`` receives each active slice's
      per-step duration (base step + its ``slice_slow`` inflation) — the
      feed for the cross-slice spread detector
      (``observability/detect.py``).
    - ``timeline`` is an armed
      :class:`~thunder_tpu_torch.observability.timeline.TimelineRecorder`: each
      step the driver feeds it per-slice spans (work + snapshot stall +
      measured dispatch gap, wire legs from the recorder's static split)
      and one lockstep-barrier ``collective`` rendezvous record per slice
      — the fleet critical-path ledger's entire input.

    A ``slice_flap`` injection scripts the victim through a fail/recover/
    fail/recover loop on consecutive steps — faster than any sane
    hysteresis window — which the controller must absorb as ONE shrink
    and ONE deferred regrow (the acceptance invariant the replayed event
    ledger proves)."""
    from thunder_tpu_torch import api
    from thunder_tpu_torch.resilience import elastic

    ledger = controller.ledger
    autopilot = controller.autopilot
    full_width = ledger.n_slices
    report = FleetReport(losses=[None] * n_steps, full_width=full_width,
                         final_width=ledger.width())

    def _attach_primary_store() -> None:
        if stores:
            active = ledger.active_slices()
            manager.store = stores[active[0]] if active else None

    _attach_primary_store()

    def _mesh(width: int):
        return mesh_for_width(width)

    def _build(mesh, width: int):
        fn = build_for_width(mesh, width, controller.grad_accum_for(grad_accum))
        if warm_start:
            key = (width,)
            if key not in warmed:
                fn(state)  # one discarded step: pay the compile off-ledger
                warmed.add(key)
        return fn

    def _fan_out(snap) -> None:
        # DP state is replicated: every active slice holds (and buddy-
        # replicates) the snapshot, so ANY slice's loss leaves a surviving
        # peer copy across the DCN boundary.
        if not stores or snap is None:
            return
        for sid in ledger.active_slices():
            st = stores[sid]
            if st is not manager.store:
                st.put(snap.share())

    def _halt(step: int, reason: str, decision, exc=None):
        manager.save(state, step, rng_seed=api._global_rng["seed"], mesh=mesh, specs=specs)
        report.decisions = list(autopilot.decisions)
        report.final_width = ledger.width()
        halted = AutopilotHalt(step, reason, decision)
        report.halted = halted
        obs_events.flight_dump("autopilot_halt")
        raise halted from exc

    warmed: set = set()
    state = init_state
    width = ledger.width()
    mesh, specs = _mesh(width)
    if manager.latest_complete_step() is None:
        # Durability anchor (written once, BEFORE any slice-loss recovery:
        # the restores themselves must land on RAM tiers).
        manager.save(state, 0, rng_seed=api._global_rng["seed"], mesh=mesh, specs=specs)
    state, step = elastic.elastic_resume(manager, state, mesh=mesh,
                                         specs=specs)
    step_fn = _build(mesh, width)
    pending_recover: dict[int, int] = {}   # slice -> step it reports healthy
    flap_script: dict[int, list[tuple[str, int]]] = {}  # step -> actions
    partition_heal_at: Optional[int] = None

    def _apply_shrink(decision, victim: int, at_step: int):
        nonlocal state, step, width, mesh, specs, step_fn
        if ledger.width() < 1:
            _halt(at_step, "fleet exhausted: no active slices", decision)
        if decision.actuator == "checkpoint_halt":
            _halt(at_step, "slice_loss policy ladder exhausted", decision)
        if stores:
            # The victim's RAM died with it; its state survives ONLY as the
            # cross-slice buddy's replica. Restoring through the victim's
            # store makes the tier ladder prove exactly that (tier="peer").
            stores[victim].drop_local()
            manager.store = stores[victim]
        with autopilot.recovery(decision):
            width = ledger.width()
            mesh, specs = _mesh(width)
            state, step = elastic.elastic_resume(manager, state, mesh=mesh,
                                                 specs=specs)
        _attach_primary_store()
        step_fn = _build(mesh, width)
        report.shrinks += 1

    def _apply_regrow(decision, at_step: int):
        nonlocal state, step, width, mesh, specs, step_fn
        # Snapshot at the boundary so the regrow resume restores THIS step
        # from RAM (local tier) instead of replaying from an old anchor.
        snap = manager.snapshot(state, at_step,
                                rng_seed=api._global_rng["seed"], mesh=mesh, specs=specs)
        _fan_out(snap)
        with autopilot.recovery(decision):
            width = ledger.width()
            mesh, specs = _mesh(width)
            state, step = elastic.elastic_resume(manager, state, mesh=mesh,
                                                 specs=specs)
        _attach_primary_store()
        step_fn = _build(mesh, width)
        report.regrows += 1

    def _feed_timeline(at_step: int, base_s: float, delays: dict,
                       stall_s: float, gap_s: float) -> None:
        # Per-slice spans for the critical-path ledger: each slice's own
        # work is the base step plus its chaos inflation; the snapshot
        # stall and the driver's dispatch gap are uniform (every host
        # snapshots its own shard / waits on the same loop). Wire legs come
        # from the recorder's static split of the compute work — measured
        # per-leg timing is a hardware-fleet capability; the emulated fleet
        # prices it statically, which is exactly what keeps the recorder's
        # static-vs-measured cross-check falsifiable.
        spans: dict = {}
        wall = base_s + (max(delays.values()) if delays else 0.0) + stall_s
        for sid, d in delays.items():
            sp = dict(timeline.static_spans(base_s))
            sp["total_s"] = base_s + d + stall_s + gap_s
            sp["stall_s"] = stall_s
            spans[sid] = sp
            # The lockstep barrier ending the step is the rendezvous
            # anchor every slice leaves together — one collective record
            # per slice, `s` = the wire time this slice spent in it.
            timeline.note_collective(
                sid, at_step, fn="fleet_step",
                s=max(0.0, wall - (base_s + d + stall_s)),
                in_slice_s=sp.get("ici_s", 0.0),
                cross_slice_s=sp.get("dcn_s", 0.0),
                step=at_step,
            )
        timeline.record_step(at_step, spans)

    # Installed for the loop's duration (the run_training pattern): the
    # DetectorBank publishes every anomaly to autopilot.current(), and
    # the controller's decisions must cite that evidence ring -- an
    # uninstalled autopilot would decide blind.
    with autopilot.installed():
        while step < n_steps:
            iter_t0 = time.perf_counter()
            # ---- chaos seams + scripted recoveries at the step boundary ----
            for kind, sid in flap_script.pop(step, []):
                if kind == "lose":
                    d = controller.on_slice_loss(sid, step, reason="slice_flap")
                    if d is not None:
                        _apply_shrink(d, sid, step)
                else:
                    controller.on_slice_recovered(sid, step)
            for sid, at in list(pending_recover.items()):
                if step >= at:
                    del pending_recover[sid]
                    controller.on_slice_recovered(sid, step)
            if partition_heal_at is not None:
                if step >= partition_heal_at:
                    partition_heal_at = None
                    if stores:
                        for st in stores:
                            st.partitioned = False
                else:
                    report.partitioned_steps += 1

            victim = chaos.slice_loss_at_step(step)
            if victim is not None:
                if report.shrinks + report.regrows >= max_recoveries:
                    _halt(step, "max recoveries exceeded", None)
                d = controller.on_slice_loss(victim, step)
                if d is not None:
                    _apply_shrink(d, victim, step)
                if recover_after:
                    pending_recover[victim] = step + int(recover_after)

            flapper = chaos.slice_flap_at_step(step)
            if flapper is not None:
                # Scripted flap: lose now, recover next step, re-fail the one
                # after, recover again — two cycles inside any hysteresis
                # window long enough to matter.
                d = controller.on_slice_loss(flapper, step, reason="slice_flap")
                if d is not None:
                    _apply_shrink(d, flapper, step)
                flap_script.setdefault(step + 1, []).append(("recover", flapper))
                flap_script.setdefault(step + 2, []).append(("lose", flapper))
                flap_script.setdefault(step + 3, []).append(("recover", flapper))

            rule = chaos.dcn_partition_at_step(step)
            if rule is not None and stores:
                for st in stores:
                    st.partitioned = True
                partition_heal_at = step + max(1, int(round(rule.delay_s)))

            regrow = controller.poll(step)
            if regrow is not None:
                _apply_regrow(regrow, step)

            # ---- the training step ----
            t0 = time.perf_counter()
            state, loss = step_fn(state)
            base_s = time.perf_counter() - t0
            slow = 0.0
            delays: dict = {}
            for sid in ledger.active_slices():
                d = chaos.slice_slow_delay(sid)
                delays[sid] = d
                if slice_step_time is not None:
                    slice_step_time(sid, base_s + d)
                slow = max(slow, d)
            if slow:
                # The fleet steps in lockstep: the slowest slice gates the step.
                time.sleep(slow)
            report.losses[step] = loss
            report.steps_executed += 1
            if width < full_width:
                report.degraded_steps += 1
            if on_step is not None:
                on_step(step, loss, width)

            done = step + 1
            snap_stall_s = 0.0
            if done < n_steps:
                want_disk = bool(save_every and done % save_every == 0)
                want_snap = bool(snapshot_every and done % snapshot_every == 0)
                if want_snap or want_disk:
                    t_snap = time.perf_counter()
                    async_flush = bool(getattr(manager, "async_flush", False))
                    snap = manager.snapshot(
                        state, done, rng_seed=api._global_rng["seed"], mesh=mesh,
                        specs=specs, flush=want_disk and async_flush,
                    )
                    _fan_out(snap)
                    if want_disk and not async_flush:
                        manager.save(state, done,
                                     rng_seed=api._global_rng["seed"], mesh=mesh, specs=specs)
                    snap_stall_s = time.perf_counter() - t_snap
            if timeline is not None and delays:
                # The dispatch gap: loop wall time not accounted to work,
                # lockstep wait, or the snapshot stall — the step's idle class.
                gap_s = max(0.0, (time.perf_counter() - iter_t0)
                            - base_s - slow - snap_stall_s)
                _feed_timeline(step, base_s, delays, snap_stall_s, gap_s)
            step = done

    # Drain any still-cooling slice the caller wants resolved via poll()
    # after the run; the report captures where the fleet ended up.
    report.decisions = list(autopilot.decisions)
    report.final_width = ledger.width()
    return state, report
