#!/usr/bin/env python
"""Fleet soak: sustained mixed-fault abuse, with a goodput number.

The counterpart of ``scripts/soak_fleet.py``. It runs the FSDP x TP GPT
training workload (plus a sidecar ``jit`` dispatch standing in for serving
traffic) for tens or hundreds of steps under a **seeded random chaos
schedule**: host_loss, collective_hang, sdc, oom, preempt, ckpt_io, the
tiered-checkpoint seams and a straggler, interleaved and sometimes
overlapping. The fleet autopilot (``resilience/autopilot.py``) decides every
recovery. The run must end with zero unrecovered faults and zero unactuated
decisions (the replay's correlation rules), and its headline is goodput:

    goodput = (useful_tokens / wall_s) x (1 - resilience_overhead_pct/100)

``useful_tokens`` counts each of the N steps once (steps re-run after a
restore are paid in ``wall_s``); ``wall_s`` is the whole soak, every
recovery included; the overhead is the measured steady cost of the
watchdog and the SDC guard against the clean step.

Ranks: one process a rank. ``--device cpu`` spawns ``--devices`` gloo ranks
of this module (default 8, the JAX script's virtual mesh; ``--smoke``: 4),
each writing its output to a file of its own, and prints rank 0's result;
the mesh is fsdp(N/2) x tp2, and a host loss shrinks it to the grid over the
first ranks. On the card it runs one NCCL rank a card (``--smoke``: one), on
a mesh of one rank: there a host loss finds no smaller grid, the autopilot
halts ("mesh exhausted") and the restart resumes on the same mesh from
disk. Seams that only a second rank can show are not armed at one rank and
are named, with the reason, under ``soak_seams_not_armed``. Armed seams
that never fired (the background flush's seams on ranks, whose disk cadence
is the synchronous collective save) are named under
``soak_seams_not_fired``.

The straggler's delay is sized from the measured clean step
(``STRAGGLER_STEP_FACTOR`` times it, capped at a quarter of the watchdog's
timeout), where the JAX script sleeps a fixed ``hang_delay_s / 200``: see
:func:`straggler_delay_s`.

Output: one JSON line on stdout, with every key the JAX script emits.

Usage::

    python -m thunder_tpu_torch.scripts.soak_fleet --smoke                 # the card, one rank
    python -m thunder_tpu_torch.scripts.soak_fleet --smoke --device cpu    # 4 gloo ranks
    python -m thunder_tpu_torch.scripts.soak_fleet --steps 200 --faults 14 --seed 1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from dataclasses import dataclass

SPAWN_TIMEOUT_S = 1500  # the ranks of one soak


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# =============================================================================
# The seeded chaos schedule (copied from scripts/soak_fleet.py: stdlib only,
# so a seed gives the same schedule in both packages, fault for fault)
# =============================================================================

# Every required seam appears at least once so each autopilot policy class
# is exercised on any seed: host_loss/collective_hang -> elastic_resume,
# sdc -> quarantine_rerun, oom -> deopt_escalate, preempt ->
# checkpoint_halt, ckpt_io -> the manager's own retry; the tiered-
# checkpoint seams -> the snapshot pipeline degrades one tier and keeps
# going (torn/slow flush -> a later commit; corrupt replica -> the restore
# ladder's checksum fall-through); straggler -> a sub-timeout slowdown the
# streaming detectors must flag (anomaly event, positive detection lead)
# before any watchdog timeout would.
REQUIRED_SEAMS = ("host_loss", "collective_hang", "sdc", "oom", "ckpt_io",
                  "preempt", "snap_torn", "snap_corrupt", "snap_slow",
                  "straggler")

# Fault classes a streaming detector covers: the soak gate requires >=1
# anomaly of the mapped kinds whenever the class was injected.
DETECTED_FAULT_CLASSES = {
    "straggler": ("step_time_drift", "goodput_drop", "host_spread"),
    "oom": ("recompile_storm",),
}
# The filler pool excludes preempt: each preempt is a full
# checkpoint-and-halt + process-restart cycle, and one per soak is the
# scenario; a schedule of mostly restarts would measure restart latency,
# not goodput under churn. It also excludes the snap seams: they are
# near-free by design, and padding the schedule with them would flatter
# the per-fault recovery number instead of stressing the heavy actuators.
FILLER_SEAMS = ("host_loss", "collective_hang", "sdc", "oom", "ckpt_io")
# Seams that fire lazily at a later seam visit (a background flush, a
# tiered restore) rather than at their trigger step.
_LAZY_SNAP_SEAMS = ("snap_torn", "snap_slow")

# Seams one rank cannot show, and why: the soak does not arm them at
# world size 1 and names them in its output.
ONE_RANK_SEAMS = {
    "sdc": "the SDC guard finds replicas by mesh coordinates, and a mesh of one rank holds no replica to compare",
}
# Seams armed on ranks that never fire there, and why: the soak names them
# in its output under ``soak_seams_not_fired``.
RANK_SILENT_SEAMS = {
    s: "its seam visit is the background flush, and on ranks the disk cadence is the synchronous collective save"
    for s in _LAZY_SNAP_SEAMS
}


def seams_expected_not_fired(fault_seams: dict, world: int) -> list:
    """The scheduled seams (``fault_seams``: seam -> count) that a soak on
    ``world`` ranks arms and never fires: ``RANK_SILENT_SEAMS`` on two ranks
    or more, none at one."""
    return sorted(s for s in RANK_SILENT_SEAMS if fault_seams.get(s)) if world > 1 else []

# The straggler's delay, in clean steps (see straggler_delay_s).
STRAGGLER_STEP_FACTOR = 8.0


@dataclass
class ScheduledFault:
    """One schedule entry: ``seam`` is armed at the end of ``step`` (so it
    fires on step+1's boundary/dispatch). Entries sharing a ``step`` are an
    overlapping pair — both armed before either recovery runs. ``target``
    carries a seam-specific target clause (the snap_corrupt tier)."""

    step: int
    seam: str
    target: str = None


def make_schedule(seed: int, n_steps: int, n_faults: int,
                  overlap_pairs: int = 2) -> list[ScheduledFault]:
    """Deterministic mixed-fault schedule: ``n_faults`` events over
    ``n_steps`` steps, covering every REQUIRED_SEAMS kind, with
    ``overlap_pairs`` of them sharing a trigger step (arriving before the
    prior fault's recovery has run). Same seed → same schedule.

    Tiered-checkpoint seams get special placement: ``snap_torn``/
    ``snap_slow`` fire at the NEXT background flush, so they are pinned
    into the early third of the run (armed at the tail they would never
    see a flush and never inject); ``snap_corrupt`` fires at the next
    tiered restore, so it is co-scheduled onto an elastic-driving fault's
    step (host_loss/collective_hang — whose recovery IS a restore) and
    targets the local tier, forcing the ladder through the buddy
    replica."""
    if n_faults < len(REQUIRED_SEAMS):
        raise ValueError(
            f"need at least {len(REQUIRED_SEAMS)} faults to cover every seam"
        )
    rng = random.Random(seed)
    seams = list(REQUIRED_SEAMS)
    while len(seams) < n_faults:
        pick = rng.choice(FILLER_SEAMS)
        # The de-opt ladder is 3 levels deep and sticky per function: a 4th
        # oom would exhaust it and (correctly) kill the run — cap the
        # schedule at what the ladder can absorb.
        if pick == "oom" and seams.count("oom") >= 3:
            continue
        seams.append(pick)
    # The recompile-storm detector needs >=2 recompiles inside its window:
    # with any filler slots at all, guarantee a second oom so the storm
    # anomaly is deterministic on every seed.
    if len(seams) > len(REQUIRED_SEAMS) and seams.count("oom") < 2:
        seams[len(REQUIRED_SEAMS)] = "oom"
    rng.shuffle(seams)
    # The preempt goes late: everything after it replays in the "restarted
    # process", and a very early halt would leave most faults untested
    # before the restart. It must land in the SLOT region (the first
    # n_slots seams get their own trigger step) — in the overlap tail it
    # would be co-scheduled onto another fault's step, whose recovery
    # would then fire in no process after the halt.
    n_slots = n_faults - overlap_pairs
    seams.remove("preempt")
    seams.insert(min(int(len(seams) * 0.6), max(0, n_slots - 1)), "preempt")
    lo, hi = 3, max(4, n_steps - 4)
    spacing = max(3, (hi - lo) // max(1, n_slots))
    slots = []
    for i in range(n_slots):
        base = lo + i * spacing
        slots.append(min(hi, base + rng.randrange(max(1, spacing - 2))))
    schedule = [ScheduledFault(step, seam) for step, seam in zip(slots, seams)]
    # Overlapping pairs: the remaining seams land ON an existing slot.
    # A preempt never overlaps (its recovery is a process exit — the pair's
    # second fault would fire in nobody's process).
    candidates = [f for f in schedule if f.seam != "preempt"]
    for seam in seams[n_slots:]:
        host = rng.choice(candidates)
        schedule.append(ScheduledFault(host.step, seam))
    # Tiered-checkpoint seam placement (docstring): torn/slow flush seams
    # must still have a flush ahead of them; a corrupted replica must have
    # a restore ahead of it.
    preempt_steps = {f.step for f in schedule if f.seam == "preempt"}
    early_hi = lo + max(3, (hi - lo) // 3)
    for f in schedule:
        if f.seam in _LAZY_SNAP_SEAMS and f.step > early_hi:
            step = lo + rng.randrange(max(1, early_hi - lo))
            while step in preempt_steps:
                step = lo + rng.randrange(max(1, early_hi - lo))
            f.step = step
    # Straggler placement: late enough that the step-time detectors have a
    # baseline (min_samples of clean steps), and with at least one
    # elastic-driving fault still AHEAD of it — the anomaly must precede a
    # hang/host-loss decision for detection lead to be positive and
    # measurable.
    straggler_step = None
    for f in schedule:
        if f.seam == "straggler":
            f.step = min(10 + rng.randrange(4), hi)
            while f.step in preempt_steps:
                f.step += 1
            straggler_step = f.step
    elastic_hosts = [f for f in schedule
                     if f.seam in ("host_loss", "collective_hang")]
    if straggler_step is not None and elastic_hosts and not any(
            f.step > straggler_step + 2 for f in elastic_hosts):
        # Every hang/host-loss landed before the straggler window: push the
        # latest one past it so its decision can cite the anomaly.
        latest = max(elastic_hosts, key=lambda f: f.step)
        latest.step = min(straggler_step + 4 + rng.randrange(3), hi)
        while latest.step in preempt_steps:
            latest.step += 1
    # snap_corrupt co-schedules AFTER the adjustments above so the restore
    # that must follow it really does (the host it rides may have moved).
    for f in schedule:
        if f.seam == "snap_corrupt" and elastic_hosts:
            f.step = rng.choice(elastic_hosts).step
            f.target = "local"
    # Re-pinning (lazy snap seams, the straggler, the elastic adjustment)
    # can strand an overlap-tail entry alone on its step: repair by
    # co-scheduling movable mid-weight seams (armed-at-step, position-
    # insensitive) until the requested pairs are back.
    def _pairs() -> int:
        by_step: dict[int, int] = {}
        for f in schedule:
            by_step[f.step] = by_step.get(f.step, 0) + 1
        return sum(n - 1 for n in by_step.values() if n > 1)

    while _pairs() < overlap_pairs:
        counts: dict[int, int] = {}
        for f in schedule:
            counts[f.step] = counts.get(f.step, 0) + 1
        movable = [f for f in schedule
                   if f.seam in ("sdc", "ckpt_io", "oom")
                   and counts[f.step] == 1]
        targets = [f for f in schedule
                   if f.seam not in ("preempt", "straggler")
                   and f.step not in preempt_steps]
        if not movable:
            break
        mover = movable[-1]
        choices = [f for f in targets
                   if f is not mover and f.step != mover.step]
        if not choices:
            break
        mover.step = rng.choice(choices).step
    schedule.sort(key=lambda f: (f.step, f.seam))
    return schedule


def overlapping_pairs(schedule: list[ScheduledFault]) -> int:
    by_step: dict[int, int] = {}
    for f in schedule:
        by_step[f.step] = by_step.get(f.step, 0) + 1
    return sum(n - 1 for n in by_step.values() if n > 1)


def straggler_delay_s(ideal_step_s: float, watchdog_timeout_s: float) -> float:
    """The straggler's per-step delay: ``STRAGGLER_STEP_FACTOR`` clean steps,
    capped at a quarter of the watchdog's timeout (a slowdown, never a hang).

    The JAX script sleeps a fixed ``hang_delay_s / 200`` (60 ms at its
    defaults), whatever the step takes. Its seed-7 smoke missed the
    straggler: before the straggler the detectors' baseline had learned
    steps of 27-138 ms (the first step, the flushes, the SDC re-run, the
    de-opt recompiles), an EWMA sigma of 36-42 ms, so each slowed step sat
    0.6-0.7 sigma above it and the CUSUM reached 1.5 of its 6; the
    fast/slow goodput ratio crossed 1.6 once, not 3 times running. With the
    baseline's mean and sigma both near twice the clean step, the goodput
    detector's 3 consecutive ratios above 1.6 need the first slowed step
    above ~6.4 clean steps (5.4 of delay); 8 leaves a margin."""
    return min(STRAGGLER_STEP_FACTOR * ideal_step_s, watchdog_timeout_s / 4.0)


def arm_fault(cfg, fault: ScheduledFault, *, hang_delay_s: float,
              straggler_delay_s: float = None) -> None:
    """Append ``fault``'s FaultRule to the LIVE chaos config — the soak's
    step callback arms each scheduled fault at its trigger step, which is
    what lets two entries overlap deterministically (both rules armed
    before either recovery runs). The rules are the JAX script's but the
    straggler's delay, which the caller sizes from the clean step
    (:func:`straggler_delay_s`)."""
    from thunder_tpu_torch.resilience.chaos import FaultRule

    seam = fault.seam
    if seam in ("host_loss", "preempt"):
        # Step-targeted: fires at the NEXT step's boundary check.
        cfg.rules.append(FaultRule(seam, target=str(fault.step + 1)))
    elif seam == "collective_hang":
        cfg.rules.append(FaultRule(seam, delay_s=hang_delay_s))
    elif seam == "snap_slow":
        # A slow flush must be slow relative to the flush cadence so the
        # single-in-flight backpressure actually coalesces behind it, but
        # must not dwarf the recovery budget it rides in.
        cfg.rules.append(FaultRule(seam, delay_s=min(1.0, hang_delay_s / 4)))
    elif seam == "snap_corrupt":
        # Fires at the next tiered restore; the target picks the tier(s).
        cfg.rules.append(FaultRule(seam, target=fault.target or "local"))
    elif seam == "straggler":
        # Sub-timeout slowdown over several consecutive guarded steps
        # (target "step" fires inside watchdog.guard_call, never on the
        # sidecar).
        if straggler_delay_s is None:
            raise ValueError("arm_fault: the straggler's delay is sized from the clean step; "
                             "pass straggler_delay_s (straggler_delay_s())")
        cfg.rules.append(FaultRule(seam, target="step", count=5,
                                   delay_s=straggler_delay_s))
    else:  # sdc, oom, ckpt_io, snap_torn: fire at their next seam visit
        cfg.rules.append(FaultRule(seam))


# =============================================================================
# The soak run
# =============================================================================


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _soak_mesh(world: int):
    """fsdp(world/2) x tp2 (the JAX script's fsdp(N/2) x tp2), one rank's
    mesh at world size 1."""
    from thunder_tpu_torch.parallel import make_mesh

    if world == 1:
        return make_mesh()
    return make_mesh(fsdp=world // 2, tp=2)


def _build_workload(args):
    """The FSDP x TP training workload + per-mesh builders (the
    ``lint_traces --chaos-multihost`` idiom) and the sidecar ``jit``
    dispatch (the 'serving traffic' that owns the oom/de-opt seam)."""
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    import thunder_tpu_torch.torch as ttorch
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.models import gpt as m
    from thunder_tpu_torch.parallel import build_train_step, shard_pytree
    from thunder_tpu_torch.parallel.sharding import gpt_param_specs
    from thunder_tpu_torch.parallel.train import opt_state_specs
    from thunder_tpu_torch.resilience.elastic import mesh_shape

    dev = devices.resolve_device(args.device)
    cfg = m.name_to_config(args.model)
    params = m.init_params(cfg, dtype=torch.float32, seed=0, device=dev)
    rng = np.random.RandomState(args.seed)
    idx_np = rng.randint(0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    tgt = torch.from_numpy(np.roll(idx_np, -1, axis=1)).to(dev)

    step_cache: dict = {}
    opt_cache: dict = {}

    def build_for_mesh(mesh):
        key = tuple(sorted((mesh_shape(mesh) or {}).items()))
        if key in step_cache:
            return step_cache[key]
        specs = gpt_param_specs(cfg, mesh)
        step, opt_cache[key] = build_train_step(cfg, shard_pytree(params, mesh, specs), idx, tgt, mesh=mesh,
                                                param_specs=specs, lr=1e-2, executors=["torch"], donate=False)

        def step_fn(state):
            p, o = state
            p, o, loss = step(p, o, idx, tgt)
            return (p, o), float(loss)

        step_cache[key] = step_fn
        return step_fn

    def specs_for_mesh(mesh):
        p_specs = gpt_param_specs(cfg, mesh)
        return (p_specs, opt_state_specs(p_specs))

    mesh = _soak_mesh(_world()[1])
    # The full mesh's step first: its build gives the initial opt state.
    build_for_mesh(mesh)
    blocks = shard_pytree(params, mesh, gpt_param_specs(cfg, mesh))
    opt0 = opt_cache[tuple(sorted((mesh_shape(mesh) or {}).items()))]

    # Sidecar "serving" dispatch: a jit function whose dispatches run
    # through api._run_entry — the seam where oom fires and the de-opt
    # ladder (deopt_escalate decisions) recovers.
    xa = torch.from_numpy(rng.randn(4, 8).astype(np.float32)).to(dev)
    wa = torch.from_numpy(rng.randn(6, 8).astype(np.float32)).to(dev)
    sidecar = tt.jit(lambda a, w: ttorch.sum(ttorch.gelu(ttorch.linear(a, w))), executors=["torch"],
                     device=args.device)

    tokens_per_step = args.batch * args.seq
    return (mesh, (blocks, opt0), build_for_mesh, specs_for_mesh,
            lambda: sidecar(xa, wa), tokens_per_step)


def _measure_overheads(step_fn, state, mesh, specs, n: int = 6):
    """(ideal step seconds, resilience_overhead_pct, state): the median
    clean step, the median SDC checksum and the median watchdog spawn,
    the overhead measured directly (loop-vs-loop deltas drown in jitter).
    Every rank calls it alike (the checksums are all-gathered)."""
    from thunder_tpu_torch.resilience.watchdog import SDCGuard, guard_call

    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    guard = SDCGuard(check_every=1, mesh=mesh, specs=specs)
    steps, checks = [], []
    for _ in range(max(4, n)):
        t0 = time.perf_counter()
        state, _ = step_fn(state)
        t1 = time.perf_counter()
        steps.append(t1 - t0)
        guard.check_state(state)
        checks.append(time.perf_counter() - t1)
    spawns = []
    noop = lambda: None  # noqa: E731
    for _ in range(20):
        t0 = time.perf_counter()
        guard_call(noop, (), fn_name="noop", timeout_s=60.0)
        spawns.append(time.perf_counter() - t0)
    step_s, check_s, spawn_s = med(steps), med(checks), med(spawns)
    overhead_pct = ((check_s + spawn_s) / step_s * 100.0) if step_s else 0.0
    return step_s, overhead_pct, state


def _gather(obj) -> list:
    """Every rank's ``obj`` (one process: ``[obj]``)."""
    import torch.distributed as dist

    rank, world = _world()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def run_soak(args) -> dict:
    """The soak on this rank (every rank of the process group calls it
    alike; on ranks ``args.workdir`` must be shared). Returns the result:
    rank 0's counts and readings, the replay verdicts summed over every
    rank's own log."""
    import tempfile

    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.analysis import Severity
    from thunder_tpu_torch.analysis.events import format_replay, replay_events
    from thunder_tpu_torch.observability import metrics as obsm
    from thunder_tpu_torch.resilience import autopilot as ap_mod
    from thunder_tpu_torch.resilience import chaos
    from thunder_tpu_torch.resilience.chaos import ChaosConfig
    from thunder_tpu_torch.resilience.elastic import mesh_shape
    from thunder_tpu_torch.resilience.preemption import CheckpointManager

    rank, world = _world()
    tmp = args.workdir or tempfile.mkdtemp(prefix="ttpu_soak_")
    log = os.path.join(tmp, f"events{rank}.jsonl" if world > 1 else "events.jsonl")
    monitor.set_event_log(log)

    # The schedule is built FIRST (deterministic per seed) so the detector
    # config below can be sized to what it will actually inject.
    schedule = make_schedule(args.seed, args.steps, args.faults,
                             overlap_pairs=args.overlap_pairs)
    not_armed = dict(ONE_RANK_SEAMS) if world == 1 else {}
    n_ooms = sum(1 for f in schedule if f.seam == "oom")

    # Live ops plane: the soak runs scrapeable — /metrics + /healthz on an
    # ephemeral port, the flight recorder dumping on every timeout/SDC/halt,
    # and the streaming detectors (tuned to the soak's compressed
    # timescale) feeding anomalies into the autopilot.
    plane = None
    flightrec_dir = os.path.join(tmp, f"flightrec{rank}" if world > 1 else "flightrec")
    if args.ops_plane:
        from thunder_tpu_torch.observability import opsplane
        from thunder_tpu_torch.observability.detect import DetectorConfig

        plane = opsplane.enable(
            port=0, serve=True,
            flightrec_dir=flightrec_dir, flightrec_keep=64,
            detectors=DetectorConfig(
                min_samples=6, cooldown=20, goodput_consecutive=3,
                # N recompiles inside the run = a storm at soak scale,
                # sized to the schedule's oom count.
                recompile_threshold=min(2, max(1, n_ooms)),
                recompile_window_s=3600.0,
            ),
        )
        _log(f"ops plane: http://127.0.0.1:{plane.port} (/metrics /healthz /debug/state); "
             f"flight recorder -> {flightrec_dir}")

    (mesh, state0, build_for_mesh, specs_for_mesh, sidecar,
     tokens_per_step) = _build_workload(args)
    _log(f"workload: {args.model} B={args.batch} T={args.seq} mesh={mesh_shape(mesh)} "
         f"rank {rank} of {world} on {args.device}")

    # Warm the full-mesh step + sidecar, then measure the ideal step and
    # the resilience overhead OUTSIDE the soak wall clock.
    step_fn = build_for_mesh(mesh)
    state, _ = step_fn(state0)
    sidecar()
    ideal_step_s, overhead_pct, _ = _measure_overheads(step_fn, state, mesh, specs_for_mesh(mesh))
    # Every rank arms the same straggler: rank 0's measurement.
    ideal_step_s, overhead_pct = _gather((ideal_step_s, overhead_pct))[0]
    ideal_tps = tokens_per_step / ideal_step_s if ideal_step_s else 0.0
    strag_s = straggler_delay_s(ideal_step_s, args.watchdog_timeout_s)
    _log(f"ideal step {ideal_step_s * 1e3:.1f}ms -> {ideal_tps:.0f} tok/s; "
         f"resilience overhead {overhead_pct:.2f}%; straggler delay {strag_s * 1e3:.1f}ms")

    n_overlap = overlapping_pairs(schedule)
    by_seam: dict[str, int] = {}
    for f in schedule:
        by_seam[f.seam] = by_seam.get(f.seam, 0) + 1
    _log(f"schedule (seed={args.seed}): "
         + ", ".join(f"{f.seam}@{f.step}" for f in schedule)
         + f" ({n_overlap} overlapping pair(s))"
         + (f"; not armed at one rank: {sorted(not_armed)}" if not_armed else ""))

    by_step: dict[int, list] = {}
    for f in schedule:
        by_step.setdefault(f.step, []).append(f)

    cfg = ChaosConfig(rules=[], seed=args.seed)
    # Hysteresis windows sized to the soak's compressed timescale: the
    # production defaults (minutes) span the entire run, which would make
    # every repeated fault look like flapping.
    policies = ap_mod.default_policies()
    for pol in policies.values():
        pol.window_s = min(pol.window_s, args.hysteresis_window_s)
    autopilot = ap_mod.Autopilot(policies=policies)

    def fresh_manager():
        # Tiered checkpointing: a local RAM ring buddy-paired with a peer
        # store + the async background disk writer (on ranks the disk
        # cadence is the synchronous collective save). A restart gets a
        # FRESH pair — the next allocation's RAM starts empty, disk is the
        # only tier that survives a process death.
        from thunder_tpu_torch.resilience.snapshot import SnapshotStore

        store = SnapshotStore(host=0, ring=args.snapshot_ring)
        buddy = SnapshotStore(host=1, ring=args.snapshot_ring)
        SnapshotStore.pair(store, buddy)
        return CheckpointManager(os.path.join(tmp, "ckpt"), keep=3,
                                 backoff_s=0.01, store=store,
                                 async_flush=True)

    mgr = fresh_manager()

    armed: set = set()

    def on_step(step, loss):
        # Sidecar dispatch first (an armed oom fires here), then arm
        # whatever the schedule planted at this step. Each entry arms at
        # most once — steps re-executed after a restore must not re-plant
        # faults that already fired.
        sidecar()
        for fault in by_step.get(step, ()):  # same step = overlapping
            if id(fault) in armed or fault.seam in not_armed:
                continue
            armed.add(id(fault))
            arm_fault(cfg, fault, hang_delay_s=args.watchdog_timeout_s * 6, straggler_delay_s=strag_s)

    halts = own_halts = 0  # the job's, and those this rank ran (and dumped)
    losses: list = [None] * args.steps
    reports = []
    wall0 = time.perf_counter()
    with chaos.chaos_scope(cfg):
        while True:
            halt = None
            try:
                state, report = ap_mod.run_autopiloted_training(
                    autopilot, build_for_mesh, state0, args.steps,
                    manager=mgr, mesh=mesh, specs_for_mesh=specs_for_mesh,
                    sdc_guard=True,
                    watchdog_timeout_s=args.watchdog_timeout_s,
                    save_every=args.save_every,
                    snapshot_every=args.snapshot_every, on_step=on_step,
                    regrow_after=args.regrow_after,
                )
            except ap_mod.AutopilotHalt as e:
                halt, report = e, e.report
            if report is not None:
                reports.append(report)
            # A checkpoint_halt (preemption, an exhausted ladder or mesh)
            # raises on the ranks that ran it; a rank sitting out a shrink
            # is told the run ended and returns. Every rank learns of the
            # halt, so the whole job restarts: "the next allocation"
            # resumes from the durable checkpoint — same process, fresh
            # driver call with EMPTY RAM tiers.
            halted = [h for h in _gather(None if halt is None else str(halt)) if h]
            if not halted:
                break
            halts += 1
            own_halts += halt is not None
            mgr.close()
            mgr = fresh_manager()
            _log(f"halt #{halts}: {halted[0]} — restarting from the checkpoint")
            if halts > args.max_restarts:
                raise RuntimeError(f"soak exceeded {args.max_restarts} restarts") from halt
    mgr.close()  # drain the background writer: every flush event must land
    wall_s = time.perf_counter() - wall0
    for report in reports:
        for i, v in enumerate(report.losses):
            if v is not None:
                losses[i] = v
    steps_executed = sum(r.steps_executed for r in reports)

    ops_healthz = None
    ops_port = plane.port if plane is not None else None
    if plane is not None:
        # One end-of-run scrape proves the endpoints served a real run.
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{plane.port}/healthz", timeout=5) as r:
                body = r.read().decode()
        except urllib.error.HTTPError as e:
            body = e.read().decode()  # 503 = a served "critical" verdict
        ops_healthz = json.loads(body).get("status")

    monitor.set_event_log(None)
    summary, diags = replay_events(log, storm_threshold=64)
    errors = [d for d in diags if d.severity >= Severity.ERROR]
    for line in format_replay(summary, diags).splitlines():
        _log(line)

    # Ops-plane accounting, all from durable artifacts: anomaly counts from
    # the replayed log; detection lead from decisions whose evidence cites
    # a detector anomaly (decision ts − anomaly ts > 0 means the detectors
    # saw the fault coming); flight-recorder dumps validated file by file
    # against the same schema + correlation rules.
    anomalies = dict(summary.get("anomalies") or {})
    leads: list = []
    cited = 0
    injected: set = set()
    with open(log) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "fault_injected":
                injected.add(rec.get("seam"))
            if rec.get("kind") != "autopilot_decision":
                continue
            ev = rec.get("evidence")
            an = ev.get("anomaly") if isinstance(ev, dict) else None
            if not an:
                continue
            cited += 1
            try:
                leads.append(float(rec["ts"]) - float(an["ts"]))
            except (KeyError, TypeError, ValueError):
                pass
    positive_leads = [lead for lead in leads if lead > 0]
    detection_lead = round(max(positive_leads), 3) if positive_leads else 0.0
    undetected = sorted(
        seam for seam, kinds in DETECTED_FAULT_CLASSES.items()
        if by_seam.get(seam) and seam not in not_armed and not any(anomalies.get(k) for k in kinds)
    )
    import glob as _glob

    dump_paths = sorted(_glob.glob(os.path.join(flightrec_dir, "flightrec-*.jsonl")))
    n_invalid = 0
    dump_reasons: dict = {}
    for p in dump_paths:
        _, ddiags = replay_events(p)
        if any(d.severity >= Severity.ERROR for d in ddiags):
            n_invalid += 1
        with open(p) as f:
            last = f.readlines()[-1]
        try:
            reason = str(json.loads(last).get("reason"))
        except ValueError:
            reason = "?"
        dump_reasons[reason] = dump_reasons.get(reason, 0) + 1
    timeouts = int(summary.get("kinds", {}).get("collective_timeout") or 0)
    dumps_missing = (
        max(0, timeouts - dump_reasons.get("collective_timeout", 0))
        + max(0, own_halts - dump_reasons.get("autopilot_halt", 0))
    ) if plane is not None else 0
    if plane is not None:
        from thunder_tpu_torch.observability import opsplane

        opsplane.disable()

    # Every rank's own log must replay clean: the verdicts are summed.
    verdicts = _gather((len(summary.get("unrecovered_faults") or []),
                        len(summary.get("unactuated_decisions") or []), len(errors), n_invalid, dumps_missing))
    unrecovered, unactuated, replay_errors, n_invalid, dumps_missing = (sum(v) for v in zip(*verdicts))

    useful_tokens = args.steps * tokens_per_step
    tps = useful_tokens / wall_s if wall_s else 0.0
    goodput = tps * (1.0 - overhead_pct / 100.0)
    ratio = goodput / ideal_tps if ideal_tps else 0.0
    # Wall time not spent on ideal-speed useful steps, charged per fault:
    # the machine-portable cost-of-a-fault number.
    n_faults = len(summary.get("faults_injected") or []) or 1
    recovery_per_fault_s = max(0.0, wall_s - args.steps * ideal_step_s) / n_faults
    if obsm.enabled():
        obsm.SOAK_GOODPUT.set(goodput)
    # The goodput record goes to the log AFTER replay on purpose: the
    # summary it carries (unrecovered/unactuated) is the replay's verdict.
    monitor.set_event_log(log)
    from thunder_tpu_torch.observability.events import emit_event

    emit_event(
        "goodput", goodput_tokens_per_sec=round(goodput, 1),
        tokens_per_sec=round(tps, 1), useful_tokens=useful_tokens,
        wall_s=round(wall_s, 2), overhead_pct=round(overhead_pct, 2),
        steps=args.steps,
    )
    monitor.set_event_log(None)

    result = {
        "metric": "soak_goodput",
        "value": round(goodput, 1),
        "unit": "tokens/s",
        "seed": args.seed,
        "n_devices": world,
        "mesh": mesh_shape(mesh),
        "model": args.model,
        "batch": args.batch,
        "seq": args.seq,
        "steps": args.steps,
        "device": str(args.device),
        "soak_goodput_tokens_per_sec": round(goodput, 1),
        "soak_tokens_per_sec": round(tps, 1),
        "soak_ideal_tokens_per_sec": round(ideal_tps, 1),
        "soak_goodput_ratio": round(ratio, 4),
        "resilience_overhead_pct": round(overhead_pct, 2),
        "soak_wall_s": round(wall_s, 2),
        "soak_recovery_per_fault_s": round(recovery_per_fault_s, 2),
        "soak_faults_injected": len(summary.get("faults_injected") or []),
        "soak_fault_seams": by_seam,
        "soak_seams_not_armed": not_armed,
        "soak_seams_not_fired": sorted(s for s in by_seam if s not in not_armed and s not in injected),
        "soak_straggler_delay_s": round(strag_s, 4),
        "soak_overlapping_pairs": n_overlap,
        "soak_decisions": summary.get("autopilot_decisions") or {},
        "soak_unrecovered": unrecovered,
        "soak_unactuated": unactuated,
        "soak_replay_errors": replay_errors,
        "soak_restarts": halts,
        "soak_steps_executed": steps_executed,
        "soak_final_loss": losses[-1],
        # Tiered checkpointing, all derived from the replayed event log:
        # the amortized hot-path stall of the snapshot cadence, where
        # restores landed on the tier ladder, and how many fell through an
        # invalid tier.
        "checkpoint_stall_ms_per_step": round(
            float(summary.get("snapshot_stall_ms_total") or 0.0) / args.steps, 3),
        # On ranks a snapshot first waits for the other ranks at a barrier,
        # outside its stall: the rank skew, which the step still pays.
        "checkpoint_peer_wait_ms_per_step": round(
            float(summary.get("snapshot_peer_wait_ms_total") or 0.0) / args.steps, 3),
        "snapshot_every": args.snapshot_every,
        "soak_snapshots": summary.get("snapshots") or 0,
        "soak_restore_tiers": summary.get("restore_tiers") or {},
        "soak_restore_fallthroughs": summary.get("restore_fallthroughs") or 0,
        # Live ops plane: streaming-detector anomalies, the detection lead,
        # detector coverage per fault class, and the flight recorder's
        # per-fault dumps (validated one by one).
        "soak_ops_port": ops_port,
        "soak_ops_healthz": ops_healthz,
        "soak_anomalies": anomalies,
        "soak_anomalies_total": sum(anomalies.values()),
        "soak_detection_lead": detection_lead,
        "soak_decisions_citing_anomaly": cited,
        "soak_undetected_detector_classes": len(undetected),
        "soak_detector_classes_missed": undetected,
        "soak_flightrec_dumps": len(dump_paths),
        "soak_flightrec_by_reason": dump_reasons,
        "soak_flightrec_invalid": n_invalid,
        "soak_flightrec_missing": dumps_missing,
        "events_log": log,
    }
    _log(f"goodput {goodput:.0f} tok/s ({ratio * 100:.1f}% of ideal "
         f"{ideal_tps:.0f}) over {wall_s:.1f}s wall; "
         f"{result['soak_faults_injected']} faults, "
         f"{sum(result['soak_decisions'].values())} decisions, "
         f"{halts} restart(s), unrecovered={result['soak_unrecovered']}, "
         f"unactuated={result['soak_unactuated']}")
    _log(f"tiers: {result['soak_snapshots']} snapshots "
         f"(stall {result['checkpoint_stall_ms_per_step']:.2f} ms/step, peer wait "
         f"{result['checkpoint_peer_wait_ms_per_step']:.2f} ms/step), "
         f"restores "
         + (", ".join(f"{t}×{n}" for t, n in
                      sorted(result['soak_restore_tiers'].items())) or "none")
         + f", {result['soak_restore_fallthroughs']} fall-through(s)")
    if plane is not None:
        _log("ops: anomalies "
             + (", ".join(f"{k}×{n}" for k, n in sorted(anomalies.items()))
                or "none")
             + f"; detection lead {detection_lead:.2f}s over {cited} cited "
             "decision(s); dumps "
             + (", ".join(f"{r}×{n}" for r, n in sorted(dump_reasons.items()))
                or "none")
             + f" ({n_invalid} invalid, {dumps_missing} missing); "
             f"healthz={ops_healthz}")
    return result


# =============================================================================
# The command line
# =============================================================================


def soak_ok(result: dict) -> bool:
    """The soak's pass condition (the acceptance gate): nothing unrecovered,
    nothing unactuated, no replay errors, a finite final loss — and, with
    the ops plane on, every detector-covered fault class raised an anomaly,
    detection lead is positive, and every timeout/halt produced a
    schema-valid flight-recorder dump."""
    loss = result.get("soak_final_loss")
    ok = (
        result.get("soak_unrecovered") == 0
        and result.get("soak_unactuated") == 0
        and result.get("soak_replay_errors") == 0
        and loss is not None and loss == loss  # not NaN
    )
    if ok and result.get("soak_ops_port") is not None:
        ok = (
            result.get("soak_undetected_detector_classes") == 0
            and result.get("soak_detection_lead", 0) > 0
            and result.get("soak_flightrec_invalid") == 0
            and result.get("soak_flightrec_missing") == 0
        )
    return ok


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="soak_fleet",
        description="Goodput-gated chaos soak, one process a rank",
    )
    p.add_argument("--devices", type=int, default=None,
                   help="ranks: default 8 gloo ranks on the CPU (--smoke: 4), one NCCL rank a card on cuda "
                        "(--smoke: 1)")
    p.add_argument("--model", default="gpt-tiny")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--faults", type=int, default=14)
    p.add_argument("--overlap-pairs", type=int, default=2)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--snapshot-every", type=int, default=3,
                   help="RAM-snapshot cadence in steps (a fault loses at most this many steps instead of "
                        "save-every)")
    p.add_argument("--snapshot-ring", type=int, default=4,
                   help="snapshots kept per RAM tier (local ring and buddy replica ring)")
    p.add_argument("--watchdog-timeout-s", type=float, default=2.0)
    p.add_argument("--hysteresis-window-s", type=float, default=15.0,
                   help="cap on every policy's hysteresis window (the production defaults span the whole run)")
    p.add_argument("--regrow-after", type=int, default=15,
                   help="healthy steps on a shrunk mesh before resharding back up to the full mesh (0 disables)")
    p.add_argument("--max-restarts", type=int, default=8)
    p.add_argument("--ops-plane", action=argparse.BooleanOptionalAction, default=True,
                   help="live ops plane: /metrics + /healthz on an ephemeral port, flight-recorder dumps per "
                        "fault, streaming detectors feeding the autopilot")
    p.add_argument("--smoke", action="store_true",
                   help="CI-sized run: 40 steps, 11 faults (lint_traces --soak)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--_rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--_store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    on_cpu = args.device == "cpu"
    if args.smoke:
        # 11 faults = every required seam + one filler slot, which the
        # schedule turns into the second oom the recompile-storm detector
        # needs.
        args.steps, args.faults, args.save_every = 40, 11, 5
        args.snapshot_every = 2
        args.regrow_after = 10
        if args.devices is None:
            args.devices = 4 if on_cpu else 1
    if args.devices is None:
        if on_cpu:
            args.devices = 8
        else:
            import torch

            args.devices = torch.cuda.device_count() or 1
    if not args.regrow_after:
        args.regrow_after = None
    return args


def drive(argv: list, module: str, parse_args, run, ok) -> int:
    """The soak scripts' ``main``: parse ``argv``; with more than one rank
    and no ``--_rank``, spawn the ranks of ``module`` on a shared work
    directory and print rank 0's line; else join this rank's group, ``run``
    the soak and (rank 0) print its JSON line, also into ``--out``. Exit 0
    when ``ok(result)``."""
    import tempfile

    import thunder_tpu_torch.distributed as td
    from thunder_tpu_torch.scripts import ranks

    args = parse_args(argv)
    os.environ.setdefault("THUNDER_TPU_RETRY_BACKOFF_S", "0")
    if args.devices > 1 and args._rank is None:
        workdir = args.workdir or tempfile.mkdtemp(prefix="ttpu_soak_")
        rank_argv = argv + ([] if args.workdir else ["--workdir", workdir]) + ["--devices", str(args.devices)]
        codes, timed_out, logs = ranks.spawn_ranks(
            module, lambda r, store: rank_argv + ["--_rank", str(r), "--_store", store], args.devices, workdir,
            SPAWN_TIMEOUT_S, cpu=args.device == "cpu")
        for r, c in enumerate(codes):
            if r and c:
                _log(f"rank {r} exited {c}: " + " | ".join(ranks.tail(logs[r], 8)))
        rc = 124 if timed_out else next((c for c in codes if c), 0)
        with open(logs[0]) as f:
            lines = f.read().strip().splitlines()
        sys.stderr.write("\n".join(ln for ln in lines if ln.startswith("#"))[-8000:] + "\n")
        if rc not in (0, 1):
            print(f"{module} ranks failed ({rc}):\n" + "\n".join(lines[-40:]), file=sys.stderr)
            return rc
        result = json.loads(lines[-1])  # malformed output must fail loudly
        print(lines[-1], flush=True)
        return 0 if ok(result) else 1

    args.workdir = args.workdir or tempfile.mkdtemp(prefix="ttpu_soak_")
    rank = args._rank or 0
    ranks.join_group(args.device, rank, args.devices if args._rank is not None else 1,
                     args._store or os.path.join(args.workdir, "store"))
    try:
        result = run(args)
    finally:
        td.shutdown()
    if rank:
        return 0  # rank 0 prints the line
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok(result) else 1


def main(argv=None) -> int:
    return drive(list(sys.argv[1:] if argv is None else argv), "thunder_tpu_torch.scripts.soak_fleet", parse_args,
                 run_soak, soak_ok)


if __name__ == "__main__":
    raise SystemExit(main())
