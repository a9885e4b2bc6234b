#!/usr/bin/env python
"""Pod soak: federated slice-failure abuse, with a goodput number.

The counterpart of ``scripts/soak_pod.py``. It runs the data-parallel
federated GPT workload as ``--slices`` emulated slices and scripts the four
slice seams through one run (a whole-slice loss, a DCN partition, a slow
slice, a flapping slice), the fleet controller
(``resilience/federation.py``) deciding every shrink and regrow through the
autopilot. The run must end back at full width with zero unrecovered
faults, zero unactuated decisions and no process restart; its headline is
the fleet soak's goodput shape::

    goodput = (useful_tokens / wall_s) x (1 - resilience_overhead_pct/100)

While shrunk, the survivors pay the loss-equivalent gradient-accumulation
rescale (``ceil(accum x W / w)`` micro-steps an optimizer step), so the
measured degraded tokens/s is lower: reduced throughput, the same global
batch.

Invariants proven from the replayed event log: every slice-loss recovery
restored from the cross-slice buddy's peer-RAM tier (disk read only for the
step-0 anchor); the flapping slice cost one ``shrink_dp`` and one deferred
``regrow_dp``; the fleet regrew to full width with no restart; the slow
slice raised a ``slice_spread`` anomaly.

Ranks: one process a rank. ``--device cpu`` spawns ``--devices`` gloo ranks
(default 8; ``--smoke``: 4, 2 slices of 2), each writing its output to a
file of its own, and prints rank 0's result. Width w is the grid
dp=w x fsdp=ranks-per-slice over the first ranks; the ranks of a lost slice
run the same width-w step as a replica grid of their own, so at the regrow
their RAM holds the survivors' state (the JAX package reshards its global
arrays onto the returning devices). On the card (``--smoke``: one NCCL
rank) every slice is emulated by the one rank, on its one-rank mesh at
every width.

The controller's rejoin window is ``--rejoin-backoff-s`` when it is given,
else REJOIN_STEPS clean steps as measured (the JAX script's fixed 0.05 s
outlasts the smoke's remaining steps on a card, which then never regrows);
on ranks the controllers read one clock, the ranks' largest
``time.monotonic()``, so every rank decides at the same step.

Output: one JSON line on stdout, with every key the JAX script emits;
``--critpath-out`` also writes the fleet critical-path record.

Usage::

    python -m thunder_tpu_torch.scripts.soak_pod --smoke                 # the card, 2 slices of one rank
    python -m thunder_tpu_torch.scripts.soak_pod --smoke --device cpu    # 2 slices x 2 gloo ranks
    python -m thunder_tpu_torch.scripts.soak_pod --steps 60 --seed 1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from thunder_tpu_torch.scripts.soak_fleet import _gather, _world, drive


# The rejoin window in clean steps, unless --rejoin-backoff-s gives it (see run_pod).
REJOIN_STEPS = 2


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


# =============================================================================
# The scripted slice-seam schedule
# =============================================================================


def make_spec(args) -> str:
    """The chaos spec for one pod soak — exact-step slice seams, so the
    episode structure (loss -> regrow -> partition -> slow window -> flap)
    is deterministic per seed and the gate can count episodes exactly.

    Full shape (``--steps`` >= 40): a whole-slice loss in the first third,
    a DCN partition at the midpoint (healing after ``heal`` steps while
    training continues in-slice), a count-limited slow window on slice 1
    (always active — the spread detector must flag it, and the fleet
    timeline's straggler-band ``bottleneck_shift`` must name it), and a
    flap at the two-thirds mark. The slow window sits on the SAME slice
    the loss takes out and covers the loss step: the critical-path ledger
    had already measured that slice dragging the fleet, so its
    ``bottleneck_shift`` verdict is the newest host-matched evidence in
    the ring when the ``slice_loss`` decision lands. Smoke shape: the slice
    loss alone — one scripted loss, shrink -> degraded training -> regrow."""
    loss_at = max(3, args.steps // 4)
    if args.smoke:
        return f"slice_loss@{loss_at},slice=1;seed={args.seed}"
    part_at = max(loss_at + args.recover_after + 6, args.steps // 2)
    flap_at = max(part_at + 6, (2 * args.steps) // 3)
    heal = 4
    slow_n = loss_at + 3  # count-limited: covers every step up to the loss
    return (
        f"slice_loss@{loss_at},slice=1"
        f";dcn_partition@{part_at}~{heal}"
        f";slice_slow@slice=1~{args.slow_delay_s}*{slow_n}"
        f";slice_flap@{flap_at},slice=1"
        f";seed={args.seed}"
    )


def _measure_pod_overheads(step_fn, state, *, mesh, specs, snapshot_every: int, n: int = 6):
    """(ideal step seconds, resilience_overhead_pct, state) for the
    federated driver: its steady resilience cost is the cross-slice
    snapshot pipeline (gather to the host + checksum + buddy replication
    every ``snapshot_every`` steps), not the fleet soak's SDC guard.
    Measured directly (median against median) against a scratch 2-store
    ring, so the real ring stays clean. Every rank calls it alike."""
    from thunder_tpu_torch.resilience.snapshot import Snapshot, SnapshotStore, pytree_crc32, to_host

    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    steps = []
    for _ in range(max(4, n)):
        t0 = time.perf_counter()
        state, _ = step_fn(state)
        steps.append(time.perf_counter() - t0)
    scratch = [SnapshotStore(host=i, ring=2) for i in range(2)]
    SnapshotStore.make_ring(scratch)
    snaps = []
    for i in range(4):
        t0 = time.perf_counter()
        host_state = to_host(state, mesh=mesh, specs=specs)
        scratch[0].put(Snapshot(step=i, state=host_state, crcs=pytree_crc32(host_state)))
        snaps.append(time.perf_counter() - t0)
    step_s, snap_s = med(steps), med(snaps)
    per_step = snap_s / max(1, snapshot_every)
    overhead_pct = (per_step / step_s * 100.0) if step_s else 0.0
    return step_s, overhead_pct, state


def agreed_clock() -> float:
    """``time.monotonic()``, the largest of every rank's (one all-reduce;
    one process: its own): the controllers of all ranks read one clock."""
    rank, world = _world()
    if world == 1:
        return time.monotonic()
    import torch
    import torch.distributed as dist

    t = torch.tensor([time.monotonic()], dtype=torch.float64,
                     device="cuda" if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def width_grid(width: int, ranks_per_slice: int):
    """The grid of ``width`` slices on this rank: dp=width x
    fsdp=ranks_per_slice over the first ranks, and, on the ranks beyond it,
    replica grids of the same shape (every rank of the world builds them
    all, in order, as ``make_mesh`` requires). One rank: its own mesh at
    every width."""
    from thunder_tpu_torch.parallel import make_mesh

    rank, world = _world()
    if world == 1:
        return make_mesh()
    n = width * ranks_per_slice
    if world % n:
        raise ValueError(f"width {width} x {ranks_per_slice} ranks does not tile the world of {world} ranks")
    mine = None
    for first in range(0, world, n):
        mesh = make_mesh(dp=width, fsdp=ranks_per_slice, devices=list(range(first, first + n)))
        if first <= rank < first + n:
            mine = mesh
    return mine


# =============================================================================
# The pod run
# =============================================================================


def run_pod(args) -> dict:
    """The pod soak on this rank (every rank of the process group calls it
    alike; on ranks ``args.workdir`` must be shared). Returns rank 0's
    result, the replay verdicts summed over every rank's own log."""
    import tempfile

    import numpy as np
    import torch

    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.analysis import Severity
    from thunder_tpu_torch.analysis.events import format_replay, replay_events
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.models import gpt as m
    from thunder_tpu_torch.parallel import build_train_step, shard_pytree
    from thunder_tpu_torch.parallel.sharding import gpt_param_specs
    from thunder_tpu_torch.parallel.train import opt_state_specs
    from thunder_tpu_torch.resilience import chaos
    from thunder_tpu_torch.resilience import federation as fed
    from thunder_tpu_torch.resilience.autopilot import Autopilot
    from thunder_tpu_torch.resilience.elastic import mesh_shape
    from thunder_tpu_torch.resilience.preemption import CheckpointManager
    from thunder_tpu_torch.resilience.snapshot import SnapshotStore

    rank, world = _world()
    tmp = args.workdir or tempfile.mkdtemp(prefix="ttpu_pod_")
    log = os.path.join(tmp, f"events{rank}.jsonl" if world > 1 else "events.jsonl")
    monitor.set_event_log(log)

    plane = None
    if args.ops_plane:
        from thunder_tpu_torch.observability import opsplane
        from thunder_tpu_torch.observability.detect import DetectorConfig

        plane = opsplane.enable(
            port=0, serve=True,
            flightrec_dir=os.path.join(tmp, f"flightrec{rank}" if world > 1 else "flightrec"),
            detectors=DetectorConfig(
                min_samples=4, cooldown=8,
                spread_min_steps=3, spread_consecutive=2,
                # Compressed-timescale critpath band: the base step dwarfs
                # the injected delay (and the 2-slice median halves it), so
                # the absolute straggler band sits low; re-alerting every
                # step (consecutive=1, cooldown=0) keeps the band verdict
                # the newest host-matched evidence when the slice_loss
                # decision lands.
                critpath_min_steps=4, critpath_straggler_frac=0.06,
                critpath_consecutive=1, critpath_cooldown=0,
            ),
        )
        _log(f"ops plane: http://127.0.0.1:{plane.port} (/metrics /healthz /debug/state)")

    # ---- the federated workload -------------------------------------------
    ranks_per_slice = max(1, world // args.slices)
    dev = devices.resolve_device(args.device)
    cfg = m.name_to_config(args.model)
    params = m.init_params(cfg, dtype=torch.float32, seed=0, device=dev)
    rng = np.random.RandomState(args.seed)
    idx_np = rng.randint(0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    tgt = torch.from_numpy(np.roll(idx_np, -1, axis=1)).to(dev)

    def mesh_for_width(w):
        # Width w slices == a dp=w group of fsdp blocks: each emulated
        # slice owns one fsdp block of ranks, and losing a slice shrinks dp.
        mesh = width_grid(w, ranks_per_slice)
        p_specs = gpt_param_specs(cfg, mesh)
        return mesh, (p_specs, opt_state_specs(p_specs))

    step_cache: dict = {}
    raw_step_cache: dict = {}
    opt_cache: dict = {}

    def base_step_for(mesh):
        key = tuple(sorted((mesh_shape(mesh) or {}).items()))
        if key in step_cache:
            return step_cache[key]
        specs = gpt_param_specs(cfg, mesh)
        step, opt_cache[key] = build_train_step(cfg, shard_pytree(params, mesh, specs), idx, tgt, mesh=mesh,
                                                param_specs=specs, lr=1e-2, executors=["torch"], donate=False)
        raw_step_cache[key] = step  # the step the audit prices

        def step_fn(state):
            p, o = state
            p, o, loss = step(p, o, idx, tgt)
            return (p, o), float(loss)

        step_cache[key] = step_fn
        return step_fn

    accum_seen: list = []

    def build_for_width(mesh, width, accum):
        base = base_step_for(mesh)
        accum_seen.append(accum)
        if accum <= 1:
            return base

        # The loss-equivalent rescale made physical: the survivors run
        # `accum` micro-steps per driver step, so the degraded window's
        # measured tokens/s honestly drops with the width.
        def step_fn(state):
            loss = float("nan")
            for _ in range(accum):
                state, loss = base(state)
            return state, loss

        return step_fn

    full_mesh, full_specs = mesh_for_width(args.slices)
    full_key = tuple(sorted((mesh_shape(full_mesh) or {}).items()))
    # The full width's step first: its build gives the initial opt state.
    full_step = base_step_for(full_mesh)
    state0 = (shard_pytree(params, full_mesh, full_specs[0]), opt_cache[full_key])
    tokens_per_step = args.batch * args.seq
    _log(f"workload: {args.model} B={args.batch} T={args.seq} slices={args.slices} "
         f"mesh={mesh_shape(full_mesh)} rank {rank} of {world} on {args.device}")

    # Warm the full-width step, then price the ideal step + resilience
    # overhead OUTSIDE the soak wall clock.
    state, _ = full_step(state0)
    ideal_step_s, overhead_pct, _ = _measure_pod_overheads(
        full_step, state, mesh=full_mesh, specs=full_specs, snapshot_every=args.snapshot_every)
    ideal_step_s, overhead_pct = _gather((ideal_step_s, overhead_pct))[0]
    ideal_tps = tokens_per_step / ideal_step_s if ideal_step_s else 0.0
    _log(f"ideal step {ideal_step_s * 1e3:.1f}ms -> {ideal_tps:.0f} tok/s; "
         f"resilience overhead {overhead_pct:.2f}%")

    # ---- the fleet critical-path timeline ---------------------------------
    # Per-slice clocks are EMULATED, so the run injects known per-slice
    # offsets and the skew estimator must recover them from the
    # lockstep-barrier rendezvous records.
    from thunder_tpu_torch.analysis.hlo_audit import audit_jitted
    from thunder_tpu_torch.observability import timeline as tl_mod

    skew_rng = np.random.RandomState(args.seed * 7919 + 13)
    injected_skew = {
        sid: round(float(skew_rng.uniform(-0.4, 0.4)), 6)
        for sid in range(args.slices)
    }
    recorder = tl_mod.enable(
        bank=plane.bank if plane is not None else None,
        emulated_skew_s=injected_skew,
        host_label=lambda s: f"slice{s}",
    )
    # Wire classes come from the audit's static price of the full-width
    # step: the emulated fleet cannot measure per-leg wire time, so the
    # recorder charges exposed intra/inter-slice time by the audit's split.
    hrep = audit_jitted(raw_step_cache[full_key], state[0], state[1], idx, tgt)
    wire_us = hrep.exposed_us if hrep.exposed_us > 0 else sum(s.wire_us for s in hrep.sites)
    split = tl_mod.split_static_wire(hrep.sites, ranks_per_slice)
    f_total = min(0.5, (wire_us * 1e-6) / ideal_step_s) if ideal_step_s and wire_us > 0 else 0.0
    static_note = "no wire to price"
    if f_total > 0:
        recorder.set_static_wire(f_total * split["ici_frac"], f_total * split["dcn_frac"],
                                 static_exposed_pct=100.0 * f_total)
        static_note = (f"{len(hrep.sites)} site(s), exposed {100.0 * f_total:.2f}% of step "
                       f"(ici:dcn {split['ici_frac']:.2f}:{split['dcn_frac']:.2f})")
    if recorder.static_exposed_pct is None:
        # Datasheet placeholder so the wire classes stay observable when
        # the audit finds nothing to price (one rank: no collective).
        recorder.set_static_wire(0.03, 0.01, static_exposed_pct=4.0)
    _log(f"critpath timeline armed: injected skew "
         f"{ {f'slice{k}': v for k, v in injected_skew.items()} }; static wire {static_note}")

    # ---- the controller + cross-slice snapshot ring -----------------------
    # The rejoin window: the flag's seconds, else REJOIN_STEPS clean steps,
    # so a fleet of fast steps still regrows inside the run. On ranks every
    # controller reads the ranks' agreed clock, so all take each decision at
    # the same step.
    rejoin_s = args.rejoin_backoff_s if args.rejoin_backoff_s is not None else REJOIN_STEPS * ideal_step_s
    ledger = fed.FederationLedger(args.slices, clock=agreed_clock)
    autopilot = Autopilot()
    controller = fed.FleetController(ledger, autopilot, rejoin_backoff_s=rejoin_s, hysteresis_s=rejoin_s)
    stores = [SnapshotStore(host=i, ring=args.snapshot_ring) for i in range(args.slices)]
    SnapshotStore.make_ring(stores)
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep=3, backoff_s=0.01, store=stores[0])

    spec = make_spec(args)
    _log(f"schedule (seed={args.seed}): {spec}")

    # Per-width wall-time buckets for the degraded-goodput split.
    t_last = [time.perf_counter()]
    width_wall: dict = {}
    width_steps: dict = {}
    min_width = [args.slices]

    def on_step(step, loss, width):
        now = time.perf_counter()
        width_wall[width] = width_wall.get(width, 0.0) + (now - t_last[0])
        width_steps[width] = width_steps.get(width, 0) + 1
        t_last[0] = now
        min_width[0] = min(min_width[0], width)

    slice_feed = plane.bank.note_slice_step if (plane is not None and plane.bank is not None) else None

    wall0 = time.perf_counter()
    t_last[0] = wall0
    halted = None
    with chaos.chaos_scope(spec):
        try:
            state, report = fed.run_federated_training(
                controller, build_for_width, state0, args.steps,
                manager=mgr, mesh_for_width=mesh_for_width, stores=stores,
                snapshot_every=args.snapshot_every,
                recover_after=args.recover_after, on_step=on_step,
                slice_step_time=slice_feed, timeline=recorder,
            )
        except fed.AutopilotHalt as e:
            halted = str(e)
            report = getattr(e, "report", None) or fed.FleetReport(
                losses=[], full_width=args.slices, final_width=0)
    wall_s = time.perf_counter() - wall0
    mgr.close()

    ops_healthz = None
    ops_federation = None
    ops_port = plane.port if plane is not None else None
    if plane is not None:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{plane.port}/healthz", timeout=5) as r:
                body = r.read().decode()
        except urllib.error.HTTPError as e:
            body = e.read().decode()
        ops_healthz = json.loads(body).get("status")
        with urllib.request.urlopen(f"http://127.0.0.1:{plane.port}/debug/state", timeout=5) as r:
            dbg = json.loads(r.read().decode())
        fed_dbg = dbg.get("federation") or {}
        ops_federation = {"width": fed_dbg.get("width"), "n_slices": fed_dbg.get("n_slices")}
    fed.install_ledger(None)

    monitor.set_event_log(None)
    summary, diags = replay_events(log, storm_threshold=64)
    errors = [d for d in diags if d.severity >= Severity.ERROR]
    for line in format_replay(summary, diags).splitlines():
        _log(line)

    # ---- ledger-derived invariants ----------------------------------------
    recs = []
    with open(log) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except ValueError:
                continue
    restores = [r for r in recs if r.get("kind") == "restore" and r.get("ok")]
    # Each slice-loss episode's recovery restore: the first ok restore
    # after the fault_injected record. Must be the buddy's peer-RAM tier.
    loss_tiers = []
    shrink_latencies = []
    for i, r in enumerate(recs):
        if r.get("kind") == "fault_injected" and r.get("seam") in ("slice_loss", "slice_flap"):
            nxt = next((q for q in recs[i + 1:] if q.get("kind") == "restore" and q.get("ok")), None)
            if nxt is not None:
                loss_tiers.append(nxt["tier"])
                shrink_latencies.append(float(nxt["ts"]) - float(r["ts"]))
    disk_after_anchor = sum(1 for r in restores[1:] if r.get("tier") == "disk")
    flap_refailures = sum(
        1 for r in recs if r.get("kind") == "slice_state"
        and r.get("from") == "cooldown" and r.get("to") == "lost")
    # Regrow-to-full-width latency per episode: lost slice_state -> the
    # regrow decision's elastic_resume back at full width.
    regrow_s = 0.0
    lost_ts = None
    for r in recs:
        if r.get("kind") == "slice_state" and r.get("to") == "lost" and lost_ts is None:
            lost_ts = float(r["ts"])
        if r.get("kind") == "autopilot_decision" and r.get("actuator") == "regrow_dp" and lost_ts is not None:
            regrow_s = max(regrow_s, float(r["ts"]) - lost_ts)
            lost_ts = None
    anomalies = dict(summary.get("anomalies") or {})

    # ---- the critical-path record -----------------------------------------
    # Read the recorder BEFORE tearing it down: EWMA class fractions, the
    # recovered per-slice skew (checked against what this run injected),
    # the static-vs-measured cross-check, and the detector/autopilot joins
    # proven from the replayed log.
    ledger_snap = recorder.ledger.snapshot()
    skew_est = recorder.skew_estimates()
    crosscheck = recorder.crosscheck()
    fracs = recorder.ledger.fractions()
    strag_hosts = ledger_snap.get("straggler_hosts") or {}
    strag_host = max(strag_hosts, key=strag_hosts.get) if strag_hosts else None
    strag_label = None if strag_host is None else f"slice{strag_host}"
    # Injected offsets re-centered to the fleet-median clock — the frame
    # the estimator reports in.
    inj = {s: injected_skew.get(s, 0.0) for s in skew_est}
    inj_sorted = sorted(inj.values())
    inj_med = (0.0 if not inj_sorted else
               (inj_sorted[(len(inj_sorted) - 1) // 2] + inj_sorted[len(inj_sorted) // 2]) / 2.0)
    inj_centered = {s: v - inj_med for s, v in inj.items()}
    recovery_err_ms = max((abs(e.offset_s - inj_centered[s]) * 1e3 for s, e in skew_est.items()),
                          default=float("nan"))
    conf = [e.confidence for e in skew_est.values() if not e.outlier]
    cited = sum(
        1 for r in recs
        if r.get("kind") == "autopilot_decision"
        and isinstance(r.get("evidence"), dict)
        and isinstance(r["evidence"].get("anomaly"), dict)
        and r["evidence"]["anomaly"].get("anomaly") == "bottleneck_shift")
    critpath = {
        "metric": "critpath_exposed_pct",
        "value": crosscheck.get("measured_exposed_pct"),
        "unit": "%",
        "seed": args.seed,
        "n_devices": world,
        "n_slices": args.slices,
        "model": args.model,
        "steps": args.steps,
        "critpath_steps": ledger_snap.get("steps"),
        "critpath_nonzero_classes": sum(1 for v in (ledger_snap.get("totals_s") or {}).values() if v > 0),
        "critpath_frac_sum": round(sum(fracs.values()), 4),
        "critpath_dominant": recorder.ledger.dominant(),
        # The straggler-wait attribution: the seeded slow slice must own
        # the straggler-credited steps.
        "critpath_straggler_host": strag_label,
        "critpath_expected_slow_host": "slice1",
        "critpath_straggler_host_match": int(strag_label == "slice1"),
        # Clock alignment, falsified against the injected offsets.
        "critpath_skew": {f"slice{s}": e.as_dict() for s, e in sorted(skew_est.items())},
        "critpath_skew_injected_ms": {f"slice{s}": round(v * 1e3, 3) for s, v in sorted(inj_centered.items())},
        "critpath_skew_recovery_err_ms": round(recovery_err_ms, 3),
        "critpath_skew_min_confidence": round(min(conf), 4) if conf else 0.0,
        "critpath_skew_outlier_hosts": sum(1 for e in skew_est.values() if e.outlier),
        # Static-vs-measured exposed-collective cross-check.
        "critpath_measured_exposed_pct": crosscheck.get("measured_exposed_pct"),
        "critpath_static_exposed_pct": crosscheck.get("static_exposed_pct"),
        "critpath_delta_static_pct": crosscheck.get("delta_static_pct"),
        # Detector + autopilot joins from the replayed log.
        "critpath_bottleneck_shift_anomalies": int(anomalies.get("bottleneck_shift") or 0),
        "critpath_cited_decisions": cited,
        "critpath_per_step": list(ledger_snap.get("last_steps") or []),
        "events_log": log,
    }
    for c, f in fracs.items():
        critpath[f"critpath_{c}_frac"] = round(f, 4)
    if getattr(args, "critpath_out", None) and rank == 0:
        with open(args.critpath_out, "w") as f:
            f.write(json.dumps(critpath) + "\n")
        _log(f"critpath record -> {args.critpath_out}")
    _log("critpath: " + json.dumps(
        {k: critpath[k] for k in (
            "critpath_steps", "critpath_nonzero_classes", "critpath_dominant", "critpath_straggler_host",
            "critpath_skew_recovery_err_ms", "critpath_bottleneck_shift_anomalies", "critpath_cited_decisions")}))
    tl_mod.disable()

    if plane is not None:
        from thunder_tpu_torch.observability import opsplane

        opsplane.disable()

    # Every rank's own log must replay clean: the verdicts are summed.
    verdicts = _gather((len(summary.get("unrecovered_faults") or []),
                        len(summary.get("unactuated_decisions") or []), len(errors)))
    unrecovered, unactuated, replay_errors = (sum(v) for v in zip(*verdicts))

    useful_tokens = args.steps * tokens_per_step
    tps = useful_tokens / wall_s if wall_s else 0.0
    goodput = tps * (1.0 - overhead_pct / 100.0)
    ratio = goodput / ideal_tps if ideal_tps else 0.0
    degraded_wall = sum(s for w, s in width_wall.items() if w < args.slices)
    degraded_steps = sum(n for w, n in width_steps.items() if w < args.slices)
    degraded_tps = degraded_steps * tokens_per_step / degraded_wall if degraded_wall else 0.0
    full_wall = sum(s for w, s in width_wall.items() if w == args.slices)
    full_steps = sum(n for w, n in width_steps.items() if w == args.slices)

    result = {
        "metric": "soak_pod_goodput",
        "value": round(goodput, 1),
        "unit": "tokens/s",
        "seed": args.seed,
        "n_devices": world,
        "n_slices": args.slices,
        "mesh": mesh_shape(full_mesh),
        "model": args.model,
        "batch": args.batch,
        "seq": args.seq,
        "steps": args.steps,
        "device": str(args.device),
        "soak_pod_goodput_tokens_per_sec": round(goodput, 1),
        "soak_pod_tokens_per_sec": round(tps, 1),
        "soak_pod_ideal_tokens_per_sec": round(ideal_tps, 1),
        "soak_pod_goodput_ratio": round(ratio, 4),
        "resilience_overhead_pct": round(overhead_pct, 2),
        "soak_pod_wall_s": round(wall_s, 2),
        # Degraded-mode honesty: tokens/s measured INSIDE the reduced-width
        # window, with the accum-rescale micro-steps charged to it; the
        # full-width window's beside it.
        "soak_pod_degraded_steps": degraded_steps,
        "soak_pod_degraded_tokens_per_sec": round(degraded_tps, 1),
        "soak_pod_full_width_tokens_per_sec": round(full_steps * tokens_per_step / full_wall, 1) if full_wall else 0.0,
        "soak_pod_grad_accum_max": max(accum_seen) if accum_seen else 1,
        "soak_pod_rejoin_backoff_s": round(rejoin_s, 4),
        "soak_pod_partitioned_steps": report.partitioned_steps,
        # Fleet trajectory: shrank, trained degraded, regrew to full width,
        # in ONE process.
        "soak_pod_full_width": report.full_width,
        "soak_pod_final_width": report.final_width,
        "soak_pod_min_width": min_width[0],
        "soak_pod_shrinks": report.shrinks,
        "soak_pod_regrows": report.regrows,
        "soak_pod_flap_refailures": flap_refailures,
        # Which optional seams this run's schedule carried.
        "soak_pod_flap_injected": int(not args.smoke),
        "soak_pod_slow_injected": int(not args.smoke),
        "soak_pod_restarts": 0 if halted is None else 1,
        "soak_pod_halted": halted,
        "soak_pod_steps_executed": report.steps_executed,
        "soak_pod_final_loss": next((v for v in reversed(report.losses) if v is not None), None),
        # The tier proof: every slice-loss recovery read the cross-slice
        # buddy's RAM; disk served only the step-0 anchor.
        "soak_pod_slice_loss_restores": len(loss_tiers),
        "soak_pod_slice_loss_restore_tiers": loss_tiers,
        "soak_pod_slice_loss_nonpeer_restores": sum(1 for t in loss_tiers if t != "peer"),
        "soak_pod_disk_restores_after_anchor": disk_after_anchor,
        "soak_pod_restore_tiers": summary.get("restore_tiers") or {},
        "soak_pod_shrink_latency_s": round(max(shrink_latencies), 3) if shrink_latencies else 0.0,
        "soak_pod_regrow_to_full_s": round(regrow_s, 3),
        "soak_pod_faults_injected": len(summary.get("faults_injected") or []),
        "soak_pod_decisions": summary.get("autopilot_decisions") or {},
        "soak_pod_unrecovered": unrecovered,
        "soak_pod_unactuated": unactuated,
        "soak_pod_replay_errors": replay_errors,
        # Ops plane: the DCN-tier spread detector's verdicts + the
        # federation rollup served over HTTP during the run.
        "soak_pod_anomalies": anomalies,
        "soak_pod_slice_spread_anomalies": int(anomalies.get("slice_spread") or 0),
        "soak_pod_bottleneck_shift_anomalies": int(anomalies.get("bottleneck_shift") or 0),
        "soak_pod_ops_port": ops_port,
        "soak_pod_ops_healthz": ops_healthz,
        "soak_pod_ops_federation": ops_federation,
        "events_log": log,
    }
    _log(f"goodput {goodput:.0f} tok/s ({ratio * 100:.1f}% of ideal {ideal_tps:.0f}) over {wall_s:.1f}s wall; "
         f"degraded window {degraded_steps} step(s) at {degraded_tps:.0f} tok/s; "
         f"{report.shrinks} shrink(s), {report.regrows} regrow(s), {flap_refailures} flap re-failure(s), "
         f"unrecovered={result['soak_pod_unrecovered']}, unactuated={result['soak_pod_unactuated']}")
    _log(f"tiers: slice-loss restores {loss_tiers or 'none'}, {disk_after_anchor} disk restore(s) after the "
         f"anchor; slice_spread anomalies {result['soak_pod_slice_spread_anomalies']}")
    return result


# =============================================================================
# The command line
# =============================================================================


def pod_ok(result: dict) -> bool:
    """The pod soak's pass condition (the acceptance gate)."""
    loss = result.get("soak_pod_final_loss")
    ok = (
        result.get("soak_pod_unrecovered") == 0
        and result.get("soak_pod_unactuated") == 0
        and result.get("soak_pod_replay_errors") == 0
        and result.get("soak_pod_restarts") == 0
        and loss is not None and loss == loss  # not NaN
        # Training continued through the loss and regrew to full DP width.
        and result.get("soak_pod_degraded_steps", 0) > 0
        and result.get("soak_pod_min_width", 0)
        < result.get("soak_pod_full_width", 0)
        and result.get("soak_pod_final_width")
        == result.get("soak_pod_full_width")
        and result.get("soak_pod_shrinks", 0)
        == result.get("soak_pod_regrows", -1) > 0
        # Every slice-loss recovery came from the buddy's peer RAM.
        and result.get("soak_pod_slice_loss_restores", 0) > 0
        and all(t == "peer"
                for t in result.get("soak_pod_slice_loss_restore_tiers", ()))
        and result.get("soak_pod_disk_restores_after_anchor") == 0
    )
    if ok and result.get("soak_pod_flap_refailures", 0) > 0:
        # The flap episode must not have bought extra shrinks: episodes
        # (loss + flap) == 2 decisions each way, never 3.
        ok = result.get("soak_pod_shrinks") == result.get("soak_pod_regrows")
    if ok and result.get("soak_pod_ops_port") is not None \
            and result.get("soak_pod_anomalies", {}).get("slice_spread") is not None:
        ok = result.get("soak_pod_ops_healthz") not in (None, "")
    return ok


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="soak_pod",
        description="Slice-failure soak on the federated fleet, one process a rank",
    )
    p.add_argument("--devices", type=int, default=None,
                   help="ranks: default 8 gloo ranks on the CPU (--smoke: 4), one NCCL rank a card on cuda "
                        "(--smoke: 1, every slice emulated by it)")
    p.add_argument("--slices", type=int, default=2)
    p.add_argument("--model", default="gpt-tiny")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--snapshot-every", type=int, default=2)
    p.add_argument("--snapshot-ring", type=int, default=4)
    p.add_argument("--recover-after", type=int, default=6,
                   help="steps after a slice_loss before the victim reports healthy (the scheduler re-grant "
                        "stand-in)")
    p.add_argument("--rejoin-backoff-s", type=float, default=None,
                   help="controller rejoin backoff == hysteresis window (default: REJOIN_STEPS clean steps, "
                        "as measured)")
    p.add_argument("--slow-delay-s", type=float, default=0.05,
                   help="per-step inflation of the slice_slow window")
    p.add_argument("--ops-plane", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--smoke", action="store_true",
                   help="CI-sized run: 2 slices, 16 steps, one scripted slice loss (lint_traces --federation)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--critpath-out", default=None, help="write the fleet critical-path record here")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--_rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--_store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    on_cpu = args.device == "cpu"
    if args.smoke:
        args.steps = 16
        args.recover_after = 4
        if args.devices is None:
            args.devices = 4 if on_cpu else 1
    if args.devices is None:
        if on_cpu:
            args.devices = 8
        else:
            import torch

            args.devices = torch.cuda.device_count() or 1
    if args.devices > 1 and args.devices % args.slices:
        p.error("--devices must divide evenly into --slices")
    return args


def main(argv=None) -> int:
    return drive(list(sys.argv[1:] if argv is None else argv), "thunder_tpu_torch.scripts.soak_pod", parse_args,
                 run_pod, pod_ok)


if __name__ == "__main__":
    raise SystemExit(main())
