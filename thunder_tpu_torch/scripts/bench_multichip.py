#!/usr/bin/env python
"""Multichip benchmark: the FSDP x TP training step, measured.

The counterpart of ``scripts/bench_multichip.py``: one full training step
(fw+bw+AdamW, ``parallel.build_train_step``) over a mesh of ranks, and what
the step's record holds: its seconds under the three timing protocols, its
MFU, the compile-phase decomposition, the compiled program's audit
(``analysis/hlo_audit.py``), and per collective family its measured time
split into hidden under compute and exposed, from the attribution of a
profiled run (``observability/attribution.py``).

Two workloads per run:

1. **the FSDP x TP step** (``bench_fsdp_tp``): timings, MFU, the audit's
   static collective table, the profiled collective rows;
2. **the explicit-collective FSDP x TP step** (``bench_overlap``): a
   4-layer program whose collectives are trace-level ``dist_prims``, each
   on its own line. It runs unscheduled (the measured table fits each
   collective class an effective wire rate, ``analysis.cost.calibrate_ici``),
   then through the comm scheduler (``transforms/comm_schedule.py``) with
   the calibrated prices; the overlap table joins the scheduler's static
   per-site hidden/exposed prediction with the measured lines.

Ranks: one process a rank. ``--device cpu`` spawns ``--devices`` gloo ranks
(default 8), each writing its output to a file of its own, and prints rank
0's line; on the card, one NCCL rank a card (one by default). The mesh is
``mesh_factors(ranks)``. Each rank traces its own blocks (the JAX script
traces the global program), so ``train_flops_per_step`` is the ranks'
programs' operations summed, and MFU is that over (iteration x ranks x the
spec's bf16 peak). At one rank every collective is the identity and
launches no kernel, so there are no collective rows. The compile phases
keep the JAX names; their seats are ``scripts/bench.py``'s (the first two
calls of the staged step, the capture, the kernel library's build
directory).

Output: one JSON line on stdout with every key ``lint_traces --multichip``
requires, also into ``--out``; ``perf_report --history
H100_MULTICHIP_BENCH_r*.json`` gates the series.

Usage::

    python -m thunder_tpu_torch.scripts.bench_multichip                       # the card, one NCCL rank
    python -m thunder_tpu_torch.scripts.bench_multichip --device cpu --devices 4 --iters 3 --profile-steps 2
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np

from thunder_tpu_torch.scripts.bench import _log, _sync
from thunder_tpu_torch.scripts.soak_fleet import _gather, _world, drive

# The step's shapes are a tiny model's: the torch executor, as the JAX
# script's CPU mesh runs its jax executor.
EXECUTORS = ["torch"]
# Rows of the per-site overlap table (the sites dropped are counted).
OVERLAP_TOP_K = 16


def mesh_factors(n: int) -> dict:
    """n ranks as fsdp x tp, fsdp first: 8 -> fsdp4-tp2, 4 -> fsdp2-tp2,
    2 -> fsdp2, odd -> fsdp=n."""
    tp = 2 if n % 2 == 0 and n > 2 else 1
    return {"fsdp": n // tp, "tp": tp}


# =============================================================================
# Workload 1: the FSDP x TP training step
# =============================================================================


def _resilience_overhead(step, p, o, idx, tgt, mesh, specs, n_sync: int, dev, result: dict):
    """The steady cost of the watchdog and the SDC guard a step (each
    measured alone over the median guarded step), and the tiered
    checkpoint's snapshot stall against a synchronous save. Returns the
    state."""
    import shutil
    import tempfile

    from thunder_tpu_torch.parallel.train import opt_state_specs
    from thunder_tpu_torch.resilience.preemption import CheckpointManager
    from thunder_tpu_torch.resilience.snapshot import SnapshotStore
    from thunder_tpu_torch.resilience.watchdog import SDCGuard, guard_call

    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    state_specs = (specs, opt_state_specs(specs))
    guard = SDCGuard(check_every=1, mesh=mesh, specs=state_specs)
    plain, checks = [], []
    for _ in range(max(6, n_sync)):
        t0 = time.perf_counter()
        p, o, loss = guard_call(step, (p, o, idx, tgt), fn_name="train_step", timeout_s=120.0)
        float(loss)
        tc = time.perf_counter()
        plain.append(tc - t0)
        guard.check_state((p, o))
        checks.append(time.perf_counter() - tc)
    spawn = []
    for _ in range(50):
        t0 = time.perf_counter()
        guard_call(lambda: None, (), fn_name="noop", timeout_s=120.0)
        spawn.append(time.perf_counter() - t0)
    step_s, check_s, spawn_s = med(plain), med(checks), med(spawn)
    overhead_pct = ((check_s + spawn_s) / step_s * 100.0) if step_s else 0.0
    result["resilience_iter_s"] = round(step_s + check_s + spawn_s, 4)
    result["resilience_overhead_pct"] = round(overhead_pct, 2)
    result["sdc_check_us_per_step"] = round(check_s * 1e6, 1)
    result["watchdog_dispatch_us"] = round(spawn_s * 1e6, 1)
    _log(f"resilience overhead: sdc check {check_s * 1e6:.0f}us + watchdog {spawn_s * 1e6:.0f}us over a "
         f"{step_s * 1e3:.1f}ms median step = {overhead_pct:+.2f}%")

    rank, _ = _world()
    ck_dir = _gather(tempfile.mkdtemp(prefix="ttpu_bench_ck_"))[0]
    try:
        store = SnapshotStore(host=rank, ring=2)
        SnapshotStore.pair(store, SnapshotStore(host=rank + 1, ring=2))
        cmgr = CheckpointManager(ck_dir, backoff_s=0, store=store, async_flush=True)
        stalls = []
        for i in range(6):
            t0 = time.perf_counter()
            cmgr.snapshot((p, o), i, mesh=mesh, specs=state_specs)
            stalls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cmgr.save((p, o), 99, mesh=mesh, specs=state_specs)
        sync_save_s = time.perf_counter() - t0
        cmgr.close()
    finally:
        _gather(None)
        if rank == 0:
            shutil.rmtree(ck_dir, ignore_errors=True)
    result["checkpoint_stall_ms_per_step"] = round(med(stalls) * 1e3, 3)
    result["checkpoint_sync_save_ms"] = round(sync_save_s * 1e3, 2)
    _log(f"checkpoint tiers: snapshot stall {med(stalls) * 1e3:.2f}ms vs {sync_save_s * 1e3:.0f}ms synchronous save")
    return p, o


def bench_fsdp_tp(args, result: dict) -> None:
    import torch

    from thunder_tpu_torch.analysis.cost import resolve_device_spec, trace_cost
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.observability.attribution import attribute, scope_map_of
    from thunder_tpu_torch.observability.profile import profile
    from thunder_tpu_torch.parallel import build_train_step, make_mesh, shard_pytree
    from thunder_tpu_torch.parallel.sharding import gpt_param_specs
    from thunder_tpu_torch.scripts.bench import _kernel_cache

    dev = devices.resolve_device(args.device)
    _, n = _world()
    factors = mesh_factors(n)
    mesh = make_mesh(**factors)
    cfg = gpt.name_to_config(args.model)
    params = gpt.init_params(cfg, dtype=torch.float32, seed=0, device=dev)
    B = args.batch or max(2, 2 * factors["fsdp"])
    idx_np = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, args.seq))
    idx = torch.from_numpy(idx_np).to(dev)
    tgt = torch.from_numpy(np.roll(idx_np, -1, axis=1)).to(dev)
    specs = gpt_param_specs(cfg, mesh)
    blocks = shard_pytree(params, mesh, specs)

    t0 = time.perf_counter()
    step, opt, extrace = build_train_step(cfg, blocks, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-3,
                                          executors=EXECUTORS, donate=False, return_extrace=True)
    trace_s = time.perf_counter() - t0

    # The static planner over the rank's claimed program: its liveness
    # peak (the rank's own blocks) and its schedule certificate.
    from thunder_tpu_torch.analysis import liveness, schedule

    t0 = time.perf_counter()
    predicted_peak = int(liveness.plan_liveness(extrace, include_rows=False).peak_bytes)
    schedule.stamp(extrace)
    static_s = time.perf_counter() - t0

    cache = _kernel_cache(dev)
    t0 = time.perf_counter()
    p, o, loss = step(blocks, opt, idx, tgt)  # the eager warm-up
    loss0 = float(loss)
    p, o, loss = step(p, o, idx, tgt)  # the capture and its first replay on the card
    float(loss)
    first_s = time.perf_counter() - t0
    compile_s = trace_s + first_s
    if not math.isfinite(loss0):
        raise RuntimeError(f"bench_multichip: the first loss is {loss0}")

    p, o, loss = step(p, o, idx, tgt)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        p, o, loss = step(p, o, idx, tgt)
    loss_last = float(loss)
    iter_s = (time.perf_counter() - t0) / args.iters

    n_sync = max(3, args.iters // 2)
    t0 = time.perf_counter()
    prev = None
    for _ in range(n_sync):
        p, o, loss = step(p, o, idx, tgt)
        if prev is not None:
            float(prev)
        prev = loss
    float(prev)
    synced_s = (time.perf_counter() - t0) / n_sync
    t0 = time.perf_counter()
    for _ in range(n_sync):
        p, o, loss = step(p, o, idx, tgt)
        _sync(dev)
    strict_s = (time.perf_counter() - t0) / n_sync
    if not math.isfinite(loss_last):
        raise RuntimeError(f"bench_multichip: the last loss is {loss_last}")

    if args.resilience_overhead:
        p, o = _resilience_overhead(step, p, o, idx, tgt, mesh, specs, n_sync, dev, result)

    spec = resolve_device_spec(dev)
    flops = float(sum(_gather(trace_cost(extrace, spec).total_flops)))
    # The slowest rank's iteration is the step's.
    iter_s, synced_s, strict_s = (max(_gather(x)) for x in (iter_s, synced_s, strict_s))
    mfu = flops / (iter_s * n * spec.peak_flops["bf16"]) if iter_s else 0.0
    st = getattr(step, "staging", None)
    _log(f"fsdp_tp mesh={factors} B={B} T={args.seq} compile {compile_s:.1f}s iter {iter_s * 1e3:.1f}ms (synced "
         f"{synced_s * 1e3:.1f}ms, strict {strict_s * 1e3:.1f}ms) loss {loss0:.3f}->{loss_last:.3f} MFU "
         f"{mfu * 100:.2f}% [{spec.name} x{n}]")
    result.update({
        "metric": "multichip_fsdp_tp_train_iter",
        "value": round(iter_s, 4),
        "unit": "s",
        "n_devices": n,
        "mesh": factors,
        "model": args.model,
        "batch": B,
        "seq": args.seq,
        "train_iter_s": round(iter_s, 4),
        "train_iter_synced_s": round(synced_s, 4),
        "train_iter_strict_sync_s": round(strict_s, 4),
        "train_tokens_per_sec": round(B * args.seq / iter_s) if iter_s else 0,
        "train_mfu": round(mfu, 5),
        "device_spec": spec.name,
        "train_flops_per_step": flops,
        "multichip_trace_claim_s": round(trace_s, 2),
        "multichip_xla_compile_s": round(compile_s, 2),
        "compile_phases": {
            "trace_claim_s": round(trace_s, 2),
            "static_analysis_s": round(static_s, 3),
            "predicted_peak_bytes": predicted_peak,
            "xla_backend_compile_s": round(st.capture_s if st is not None else 0.0, 2),
            **cache,
        },
    })

    # The compiled program's audit: its collective sites from the staged
    # graph (the card) or the profiler's op record of one call (gloo),
    # priced and classified per family.
    from thunder_tpu_torch.analysis.hlo_audit import audit_jitted
    from thunder_tpu_torch.observability.timeline import split_static_wire

    t0 = time.perf_counter()
    hrep = audit_jitted(step, p, o, idx, tgt, device=spec)
    audit_s = time.perf_counter() - t0
    result["spmd_collective_exposed_pct_static"] = round(hrep.exposed_pct, 2)
    result["hlo_inserted_collectives"] = hrep.inserted_collectives
    result["hlo_static_collectives"] = {
        fam: {"count": agg["count"], "wire_bytes": int(agg["wire_bytes"]), "inserted": agg["inserted"]}
        for fam, agg in sorted(hrep.by_family.items())}
    result["compile_phases"]["hlo_audit_s"] = round(audit_s, 3)
    tier = split_static_wire(hrep.sites, factors["tp"])
    result["hlo_wire_ici_us_static"] = round(tier["ici_us"], 2)
    result["hlo_wire_dcn_us_static"] = round(tier["dcn_us"], 2)
    result["hlo_wire_ici_frac_static"] = round(tier["ici_frac"], 4)
    _log(f"hlo audit: {len(hrep.sites)} collective sites ({hrep.inserted_collectives} inserted), static exposed "
         f"{result['spmd_collective_exposed_pct_static']}% in {audit_s:.2f}s: "
         + ", ".join(f"{f}={a['count']}" for f, a in sorted(hrep.by_family.items())))

    if args.no_profile:
        return
    # The profiled run: each collective line's time and its overlap split.
    lmap = scope_map_of(step.eager, p, o, idx, tgt) if dev.type == "cuda" else None
    res = profile(step, p, o, idx, tgt, steps=args.profile_steps, warmup=1, launch_map=lmap)
    attr = attribute(res["trace_dir"], launch_map=lmap)
    steps = args.profile_steps
    coll = {cls: {"us_per_step": round(row.us / steps, 1), "hidden_us_per_step": round(row.hidden_us / steps, 1),
                  "exposed_us_per_step": round(row.exposed_us / steps, 1), "calls": row.count}
            for cls, row in sorted(attr.collective_summary().items())}
    busy = attr.device_busy_us / steps
    result["collectives"] = coll
    result["device_busy_us_per_step"] = round(busy, 1)
    result["collective_us_per_step"] = round(attr.collective_us / steps, 1)
    result["spmd_collective_exposed_pct"] = round(attr.exposed_collective_us / steps / busy * 100.0, 2) if busy else 0.0
    _log(f"collectives: {attr.collective_us / steps:.0f}us/step ({result['spmd_collective_exposed_pct']}% of "
         f"{'device' if attr.mode == 'cuda' else 'host op'} time exposed): "
         + (", ".join(f"{c}={v['us_per_step']}us" for c, v in coll.items()) or "none launched"))


# =============================================================================
# Workload 2: the explicit-collective step, predicted against measured
# =============================================================================


def bench_overlap(args, result: dict) -> None:
    """The explicit-collective FSDP x TP step through the comm scheduler: a
    4-layer program where each layer's fsdp ``synchronize`` gathers its
    weight and a tp ``all_reduce`` combines the activations (the grad
    transform adds the ``reduce_scatter``s). Profiled unscheduled, each
    collective class's effective wire rate fitted from the measured table;
    scheduled with those prices, profiled again; the scheduler's static
    per-site prediction (at the bench's device spec) joined with the
    measured lines. The headline ``collective_exposed_pct`` is the static
    exposed share of the scheduled trace."""
    import torch

    import thunder_tpu_torch.clang as clang
    from thunder_tpu_torch.analysis import schedule as sched_mod
    from thunder_tpu_torch.analysis.cost import calibrate_ici, collective_sym_class, resolve_device_spec, trace_cost
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives, stage_collective_trace
    from thunder_tpu_torch.observability.attribution import attribute, parse_scope
    from thunder_tpu_torch.observability.profile import profile
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.transforms.comm_schedule import schedule_collectives

    dev = devices.resolve_device(args.device)
    _, n = _world()
    factors = mesh_factors(n)
    fsdp_g, tp_g = factors["fsdp"], factors["tp"]
    mesh = make_mesh(**factors)
    rng = np.random.RandomState(0)
    layers, d, B = 4, 256, 64
    ws = [torch.from_numpy(rng.randn(d, d).astype(np.float32) * (1.0 / np.sqrt(d))).to(dev) for _ in range(layers)]
    x = torch.from_numpy(rng.randn(B, d).astype(np.float32)).to(dev)

    def loss_traced(*flat_in):
        *w_shards, xv = flat_in
        h = xv
        for w_shard in w_shards:
            w_full = dist.synchronize(w_shard, "fsdp", fsdp_g, "fsdp")
            h = clang.matmul(h, clang.transpose(w_full, 0, 1))
            if tp_g > 1:
                # avg: the identity on replicated activations, but the tp
                # wire pattern (and its grad all_reduce) in the trace.
                h = dist.all_reduce(h, "tp", tp_g, op="avg")
            h = clang.tanh(h)
        return clang.mean(clang.mul(h, h))

    # Traced on this rank's block shapes; called with the global tensors.
    shards = tuple(w[: d // fsdp_g] for w in ws)
    w_spec = P("fsdp", None)
    in_specs = tuple([w_spec] * layers + [P()])
    out_specs = (P(), tuple([w_spec] * layers + [P()]))
    jf0, extrace = compile_with_collectives(loss_traced, shards + (x,), mesh, in_specs, out_specs, grad=True)
    flat = [*ws, x]
    jf0(*flat)
    _sync(dev)
    spec = resolve_device_spec(dev)
    steps = max(1, args.profile_steps)

    def measured_by_line(jf) -> dict:
        """{trace line: [measured us/step, lane-hidden us/step]} of the
        collective lines of one profile of ``jf``."""
        attr = attribute(profile(jf, *flat, steps=steps, warmup=1)["trace_dir"])
        out = {}
        for key, row in attr.collectives.items():
            ref = parse_scope(key)
            if ref is not None:
                got = out.setdefault(ref.line, [0.0, 0.0])
                got[0] += row.us / steps
                got[1] += row.hidden_us / steps
        return out, attr

    meas0, _ = measured_by_line(jf0)
    cost0 = trace_cost(extrace, spec)
    samples = [(collective_sym_class(r.sym), r.comm_bytes, meas0[r.index][0] / 1e6) for r in cost0.rows
               if r.kind == "collective" and r.comm_bytes and meas0.get(r.index, (0.0,))[0] > 0]
    calibrated = calibrate_ici(spec, samples)
    if calibrated.ici_class_bw:
        result["ici_calibration"] = {
            "source": "fitted from this run's measured per-collective table (unscheduled profile)",
            "datasheet_ici_bw": spec.ici_bw,
            "effective_bw_by_class": {k: round(v, 1) for k, v in calibrated.ici_class_bw.items()},
        }
        _log("ici calibration: " + ", ".join(f"{k}={v / 1e6:.2f}MB/s (datasheet {spec.ici_bw / 1e9:.0f}GB/s)"
                                             for k, v in calibrated.ici_class_bw.items()))

    scheduled, srep = schedule_collectives(extrace, device=calibrated)
    if srep is not None:
        for line in srep.format().splitlines():
            _log(line)
        result["comm_schedule"] = {k: v for k, v in srep.to_tag().items() if k != "sites"}
    jf1 = stage_collective_trace(scheduled, mesh, in_specs, out_specs)
    jf1(*flat)
    _sync(dev)
    meas1, attr1 = measured_by_line(jf1)

    pred_before = sched_mod.predict_overlap(extrace, device=spec)
    pred_after = sched_mod.predict_overlap(scheduled, device=spec)
    cal_wire = {r.index: r.roofline_s * 1e6 for r in trace_cost(scheduled, calibrated).rows if r.kind == "collective"}
    moves = {s.key: s for s in srep.sites} if srep is not None else {}
    rows = []
    for so in sorted(pred_after.sites, key=lambda s: -s.wire_us):
        m = meas1.get(so.index, (None, None))
        mv = moves.get(so.key)
        rows.append({
            "collective": so.label(),
            "class": collective_sym_class(so.sym) or so.sym,
            "axis": so.axis,
            "moved_from": mv.index_before if mv and mv.moved else None,
            "predicted_wire_us": round(so.wire_us, 2),
            "predicted_wire_us_calibrated": round(cal_wire.get(so.index, 0.0), 1),
            "predicted_hidden_us": round(so.hidden_us, 2),
            "predicted_exposed_us": round(so.exposed_us, 2),
            "window_us": round(so.window_us, 2),
            "measured_us_per_step": round(m[0], 1) if m[0] is not None else None,
            "measured_hidden_lane_us_per_step": round(m[1], 1) if m[1] is not None else None,
        })
    # The table is the top k by predicted wire; the sites dropped are counted.
    k = OVERLAP_TOP_K
    result["overlap"] = rows[:k]
    result["overlap_sites_total"] = len(rows)
    result["overlap_sites_shown"] = min(k, len(rows))
    result["overlap_sites_dropped"] = max(0, len(rows) - k)
    if result["overlap_sites_dropped"]:
        _log(f"overlap table: showing {k} of {len(rows)} collective sites ({result['overlap_sites_dropped']} "
             "dropped)")
    result["collective_exposed_pct"] = round(pred_after.exposed_pct, 2)
    result["collective_exposed_pct_unscheduled"] = round(pred_before.exposed_pct, 2)
    result["collective_exposed_basis"] = (
        f"static schedule prediction (exposed wire / total wire at device_spec={spec.name}) over the "
        "comm-scheduled trace; per-site join vs measured lines in 'overlap'")
    if attr1.device_busy_us:
        result["collective_exposed_pct_measured_lanes"] = round(
            attr1.exposed_collective_us / attr1.device_busy_us * 100.0, 2)
    result["overlap_predicted_wire_s"] = round(cost0.comm_s, 6)
    _log(f"overlap: static exposed {pred_before.exposed_pct:.1f}% -> {pred_after.exposed_pct:.1f}% of wire after "
         f"scheduling ({srep.moves if srep else 0} moves)")


# =============================================================================
# The driver
# =============================================================================


def run(args) -> dict:
    """Both workloads on this rank (every rank of the group calls it
    alike); the result. A failure of the overlap workload is recorded as
    ``overlap_error`` (which ``lint_traces --multichip`` counts as an
    error), not lost with the timing series."""
    from thunder_tpu_torch.scripts.bench import annotated

    result: dict = {}
    with annotated():  # collective lines carry their profiler ranges
        bench_fsdp_tp(args, result)
        try:
            bench_overlap(args, result)
        except Exception as e:  # noqa: BLE001 — recorded in the result, which the smoke holds to it
            _log(f"overlap workload failed ({type(e).__name__}: {e})")
            result["overlap_error"] = f"{type(e).__name__}: {e}"
    return result


def bench_ok(result: dict) -> bool:
    return bool(result.get("metric")) and math.isfinite(result.get("value", float("nan")))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="bench_multichip", description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=None,
                   help="ranks: default 8 gloo ranks on the CPU, one NCCL rank a card on cuda")
    p.add_argument("--model", default="llama-tiny")
    p.add_argument("--batch", type=int, default=0, help="global batch (0 = auto)")
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--profile-steps", type=int, default=3)
    p.add_argument("--no-profile", action="store_true")
    p.add_argument("--resilience-overhead", action="store_true",
                   help="also measure the watchdog and SDC guard's steady cost a step and the snapshot stall")
    p.add_argument("--out", default=None, help="also write the JSON line here")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--_rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--_store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.devices is None:
        if args.device == "cpu":
            args.devices = 8
        else:
            import torch

            args.devices = torch.cuda.device_count() or 1
    return args


def main(argv=None) -> int:
    return drive(list(sys.argv[1:] if argv is None else argv), "thunder_tpu_torch.scripts.bench_multichip",
                 parse_args, run, bench_ok)


if __name__ == "__main__":
    raise SystemExit(main())
