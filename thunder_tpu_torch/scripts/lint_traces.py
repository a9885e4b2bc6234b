#!/usr/bin/env python
"""Run the static trace verifier over the example programs.

The counterpart of ``scripts/lint_traces.py``, the entry point of the
analysis framework (``thunder_tpu_torch/analysis``): every program below is
traced and pushed through the default pass pipeline (acquisition, DCE, CSE,
claiming, del_last_used) with ``examine.lint`` and the torch executor, and
the gradient workloads are compiled end to end with ``debug_checks=True``,
so each transform pass (the autodiff joint rewrite, autocast, the keyed RNG)
is verified where it runs.

Exit status: 1 if any ERROR diagnostic is found, 2 on a usage error.

Usage:
    python -m thunder_tpu_torch.scripts.lint_traces [pattern] [--device cpu]
        # every program (or those whose name holds pattern)
    python -m thunder_tpu_torch.scripts.lint_traces --events LOG.jsonl [LOG2.jsonl ...] [--storm-threshold N]
        # replay event logs (jit(events=...), THUNDER_TPU_EVENTS): the JSONL
        # schema and recompile storms; several logs merge in a stable order
    --static        the liveness planner: the predicted peak within 15% of
                    instrument="memory"'s measured one; the fsdp4-tp2
                    schedule certificate and its seeded faults; the de-opt
                    ladder under the chaos oom@<3 ceiling reaching its
                    fitting level in fewer failed compiles than a blind climb
    --schedule      the comm scheduler on the fsdp4-tp2 grad trace: hidden
                    wire > 0, the certified order kept, hoists backing off
                    under a capacity squeeze, sched_bad and compile_fail
                    falling back cleanly
    --chaos         the GPT gradient pipeline under a canned fault schedule
                    (kernel raise, compile failure, OOM, NaN poison): every
                    fault recovers or raises its typed error, and the event
                    log pairs each injection with its recovery
    --ops           the ops plane's HTTP endpoint against a chaos'd GPT
                    step: /healthz flips on a straggler, /metrics scrapes
                    mid-run, a hang leaves a flight-recorder dump, the
                    plane's cost stays under 1% of the step
    --roofline      the duty-cycled roofline ledger: schema-valid rows,
                    /debug/roofline, a mispriced op tripping
                    cost_model_drift, the armed cost under 1% of the step
    --critpath      the fleet critical-path ledger on a synthetic 4-host
                    fleet: skew recovery, the straggler named, the
                    exposed-collective cross-check, /debug/critpath
    --chaos-multihost   gpt-tiny's fsdp2-tp2 step on 4 gloo ranks under a
                    collective hang, a host loss (elastic resume on fsdp2
                    over the first 2 ranks) and an SDC injection
    --hlo           the compiled-program audit of gpt-tiny's fsdp2-tp2 step
                    on 4 gloo ranks: every collective site explicit but the
                    loss all-reduce, a planted one named inserted, the
                    report schema-valid
    --soak          the fleet soak smoke (``scripts/soak_fleet.py --smoke
                    --seed 7`` on 4 gloo ranks): nothing unrecovered or
                    unactuated, every policy class decided, the schedule's
                    seams and overlaps, the snapshot stall, RAM and disk
                    restores with a fall-through, the detectors and the
                    flight recorder; then the torn-write fall-through in
                    this process
    --federation    the pod soak smoke (``scripts/soak_pod.py --smoke --seed
                    7``, 2 slices of 2 gloo ranks) inside 60 s: one shrink
                    and one regrow, the slice-loss restore from the peer
                    tier, a clean replay
    --multichip     ``scripts/bench_multichip --iters 3 --profile-steps 2``
                    on 4 gloo ranks (fsdp2-tp2): the result's schema, the
                    collective rows with their overlap split, the comm
                    scheduler moving a site and cutting the static exposed
                    share

``--device`` (default ``cuda``) is where the programs run; the rank modes run
on the CPU's gloo ranks. Without a card and without ``--device cpu`` a mode
that runs a program raises.

The series gates: ``--multichip``, ``--soak``, ``--federation``,
``--roofline`` and ``--critpath`` end with ``perf_report --history --gate``
over the committed rounds of their series, and the unfiltered default run
over all six (``perf_report.series_paths``: the port's own series,
``H100_BENCH_r*.json`` and so on, never a JAX round). A series with fewer
rounds than its gate needs prints one line and counts no error; ``--soak``
also holds its per-fault recovery seconds to the newest round of
``H100_SOAK_r*``, where one exists.
"""

from __future__ import annotations

import os
import sys

import numpy as np

SPAWN_TIMEOUT_S = 300  # each spawn of gloo ranks
RANKS = 4
_DEVICE = "cuda"


def _dev():
    from thunder_tpu_torch.core import devices

    return devices.resolve_device(_DEVICE)


def _tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(_dev())


def _jit(fn, **kw):
    import thunder_tpu_torch as tt

    return tt.jit(fn, device=_DEVICE, **kw)


def _value_and_grad(fn, **kw):
    import thunder_tpu_torch as tt

    return tt.value_and_grad(fn, device=_DEVICE, **kw)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _gpt_tiny(batch: int = 2, seq: int = 16):
    """gpt-tiny's config, float32 params from seed 0, and a batch of ids
    and their shift by one from numpy seed 0, on the device."""
    import torch

    from thunder_tpu_torch.models import gpt as m

    rng = np.random.RandomState(0)
    cfg = m.name_to_config("gpt-tiny")
    params = m.init_params(cfg, dtype=torch.float32, seed=0, device=_dev())
    idx = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    tgt = np.roll(idx, -1, axis=1).astype(np.int32)
    return m, cfg, params, _tensor(idx), _tensor(tgt)


def _programs():
    """(name, fn, args): the example-program corpus, the ops of the example
    trainer's step and small representative programs."""
    import thunder_tpu_torch.torch as ttorch

    rng = np.random.RandomState(0)
    x44 = _tensor(rng.randn(4, 4).astype(np.float32))
    x48 = _tensor(rng.randn(4, 8).astype(np.float32))
    w86 = _tensor(rng.randn(6, 8).astype(np.float32))
    m, cfg, params, idx, tgt = _gpt_tiny()

    return [
        ("elementwise-chain", lambda a: ((a * 2.0).tanh() + a).sum(), (x44,)),
        ("linear-gelu", lambda a, w: ttorch.sum(ttorch.gelu(ttorch.linear(a, w))), (x48, w86)),
        ("reduction-mix", lambda a: (a.sum(0) * a.mean()).sum(), (x44,)),
        ("dropout-rng", lambda a: ttorch.dropout(a, p=0.5, training=True).sum(), (x44,)),
        ("inplace-functionalized", _inplace_prog, (x44,)),
        ("gpt-tiny-forward", lambda p, i: m.forward(p, i, cfg), (params, idx)),
        ("gpt-tiny-loss", lambda p, i, t: m.loss_fn(p, i, t, cfg), (params, idx, tgt)),
    ]


def _inplace_prog(a):
    import thunder_tpu_torch.torch as ttorch

    b = ttorch.abs(a)
    b += 1.0
    return ttorch.sum(b)


def _grad_workloads():
    """(name, compiled callable, args) compiled with the verifier on: the
    grad, autocast and RNG passes that the pipeline-level lint stages do not
    reach."""
    m, cfg, params, idx, tgt = _gpt_tiny()

    def loss(p, i, t):
        return m.loss_fn(p, i, t, cfg)

    return [
        ("gpt-tiny-backward", _value_and_grad(loss, executors=["torch"], debug_checks=True), (params, idx, tgt)),
        ("gpt-tiny-backward-autocast",
         _value_and_grad(loss, executors=["torch"], debug_checks=True, autocast="bfloat16"), (params, idx, tgt)),
    ]


def _replay(paths: list, storm_threshold: int) -> int:
    from thunder_tpu_torch.analysis import Severity
    from thunder_tpu_torch.analysis.events import format_replay, replay_events

    # One path keeps single-log semantics (per-line diagnostics); several
    # merge in a stable (ts, host, pid, seq) order before the replay.
    source = paths[0] if len(paths) == 1 else paths
    summary, diags = replay_events(source, storm_threshold=storm_threshold)
    print(format_replay(summary, diags))
    n_errors = sum(1 for d in diags if d.severity >= Severity.ERROR)
    print(f"\nlint_traces --events: {n_errors} error(s), "
          f"{sum(1 for d in diags if d.severity == Severity.WARNING)} warning(s)")
    return 1 if n_errors else 0


def _get(port: int, route: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _forward_step_s(jf, params, idx, repeats: int = 5) -> float:
    """One compiled gpt-tiny forward's seconds, the least of ``repeats``
    calls after a first (load on the host only adds time): the denominator
    of the overhead budgets."""
    import time

    _host(jf(params, idx))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _host(jf(params, idx))
        best = min(best, time.perf_counter() - t0)
    return best


# =============================================================================
# --static
# =============================================================================


def _static_smoke() -> int:
    """--static: the static planner smoke. Three parts:

    1. **Liveness prediction**: gpt-tiny's forward and fwd+bwd compile with
       ``instrument="memory"``; the prediction sits within 15% of the
       measured high-water (on the card the entry's planned peak against
       the allocator's peak over the run less what was allocated before it;
       on the CPU the plan's eager-allocation total against the hook's
       cumulative estimate, the same quantity).
    2. **Collective-schedule safety**: an fsdp4-tp2 gradient trace
       certifies; an uncertified same-axis reorder is flagged; seeded-bad
       donation and alias traces each trip their rule.
    3. **Planner-guided de-opt**: under the chaos ``oom@<3`` ceiling with
       ``THUNDER_TPU_HBM_BYTES`` between the padded and exact-shape
       predicted peaks, the ladder jumps L0 -> L3 in one recompile, fewer
       failed compiles than a blind climb (4 to reach L3).
    """
    import json
    import tempfile

    import torch

    os.environ.setdefault("THUNDER_TPU_RETRY_BACKOFF_S", "0")

    import thunder_tpu_torch.clang as clang
    import thunder_tpu_torch.core.prims as tprims
    from thunder_tpu_torch.analysis import Severity, plan_liveness, verify
    from thunder_tpu_torch.analysis import schedule as sched_mod
    from thunder_tpu_torch.core import devices, dtypes
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.observability.instrument import instrument_reports

    n_errors = 0
    rng = np.random.RandomState(0)
    m, cfg, params, idx, tgt = _gpt_tiny()
    dev = _dev()

    # -- 1. liveness prediction against the measured high-water ---------------
    workloads = [
        ("gpt-fwd", _jit(lambda p, i: m.forward(p, i, cfg), executors=["torch"], instrument="memory"),
         (params, idx)),
        ("gpt-fwd+bwd", _value_and_grad(lambda p, i, t: m.loss_fn(p, i, t, cfg), executors=["torch"],
                                        instrument="memory"), (params, idx, tgt)),
    ]
    for name, jf, wargs in workloads:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        jf(*wargs)
        entry = jf._lc_cs.cache_entries[0]
        rep = next((r for r in instrument_reports(jf) if r["hook"] == "MemoryHighWater"), None)
        if rep is None or not entry.computation_traces:
            n_errors += 1
            print(f"    FAILED: {name}: no prediction or no memory hook (hook "
                  f"{'present' if rep else 'absent'})")
            continue
        plan = plan_liveness(entry.computation_traces[-1], include_rows=False, block_bytes=1)
        if rep["exact"]:
            predicted, measured, what = plan.peak_bytes, rep["peak_bytes"] - base + plan.input_bytes, "peak"
        else:
            predicted, measured, what = plan.eager_alloc_bytes, rep["peak_bytes"], "eager-alloc"
        err = abs(predicted - measured) / max(measured, 1)
        line = (f"{name}: predicted {what} {predicted / 1e6:.3f} MB vs measured {measured / 1e6:.3f} MB "
                f"({err * 100:+.1f}%), static peak {plan.peak_bytes / 1e6:.3f} MB")
        if err > 0.15:
            n_errors += 1
            print(f"    FAILED (OOM-misprediction >15%): {line}")
        else:
            print(f"    {line}")

    # -- 2. schedule certificate and the sanitizer's seeded faults ------------
    print("--- static smoke: fsdp4-tp2 schedule certificate")

    def _cpu_t(shape):
        return TensorProxy(shape=shape, dtype=dtypes.float32, device=devices.Device("cpu"))

    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.transforms.autodiff import grad_transform
    from thunder_tpu_torch.transforms.common import dce

    w = torch.from_numpy(rng.randn(4, 8).astype(np.float32))  # the fsdp block of a (16, 8) weight
    x = torch.from_numpy(rng.randn(4, 8).astype(np.float32))

    def fsdp_tp_loss(w_shard, xv):
        w_full = dist.synchronize(w_shard, "fsdp", 4, "fsdp")
        h = clang.matmul(xv, clang.transpose(w_full, 0, 1))
        h = dist.all_reduce(h, "tp", 2)
        return clang.mean(clang.mul(h, h))

    _, comp = trace_program(fsdp_tp_loss, (w, x), {})
    comp = grad_transform(dce(comp), return_value=True)
    extrace = transform_for_execution(comp, resolve_executors(["torch"]))
    cert = sched_mod.stamp(extrace)
    axes = set(cert.axis_order)
    syms = [s.sym for s in cert.sites]
    if {"fsdp", "tp"} <= axes and "reduce_scatter" in syms:
        print(f"    certificate OK: {len(cert.sites)} sites on axes {sorted(axes)}, grad reduce_scatter present, "
              f"{len(cert.movable_sites())} movable")
    else:
        n_errors += 1
        print(f"    FAILED: certificate incomplete (axes={axes}, syms={syms})")
    if any(d.severity >= Severity.ERROR for d in verify(extrace)):
        n_errors += 1
        print("    FAILED: planner rules fired on the clean fsdp-tp trace")

    coll_idx = [s.index for s in cert.sites if s.axis == "fsdp"]
    if len(coll_idx) >= 2:
        bad = from_trace(extrace)
        bs = list(extrace.bound_symbols)
        i, j = coll_idx[0], coll_idx[1]
        bs[i], bs[j] = bs[j], bs[i]
        bad.bound_symbols = bs
        if any(d.rule == "sched.uncertified-reorder" for d in verify(bad, pass_name="uncertified reorder pass")):
            print("    uncertified same-axis reorder flagged OK")
        else:
            n_errors += 1
            print("    FAILED: uncertified collective reorder NOT flagged")
    else:
        n_errors += 1
        print("    FAILED: expected >=2 fsdp collectives to exercise reorder")

    def _seeded_bads():
        t1 = TraceCtx()
        with tracectx(t1):
            a = _cpu_t((4, 4))
            t1.args = (a,)
            out = clang.mul(a, a)
            tprims.python_return(out)
            t1.output = out
        t1.tags["donated_inputs"] = (a.name,)
        t1.tags["rerun_reads_inputs"] = True
        yield "donation.use-after-donation", t1

        t2 = TraceCtx()
        with tracectx(t2):
            a = _cpu_t((4, 4))
            t2.args = (a,)
            tprims.python_return(a)
            t2.output = a
        t2.tags["donated_inputs"] = (a.name,)
        yield "donation.donated-output", t2

        t3 = TraceCtx()
        with tracectx(t3):
            src = _cpu_t((4, 4))
            dst = _cpu_t((4, 4))
            t3.args = (src, dst)
            written = _cpu_t((4, 4))
        t3.bound_symbols.append(tprims.copy_.bind(src, dst, output=written))
        with tracectx(t3):
            tprims.python_return(dst)
        t3.output = dst
        yield "alias.entry-aliasing", t3

    for rule_id, trc in _seeded_bads():
        if any(d.rule == rule_id and d.severity >= Severity.ERROR for d in verify(trc)):
            print(f"    {rule_id} fired on seeded-bad trace OK")
        else:
            n_errors += 1
            print(f"    FAILED: {rule_id} did not fire on its seeded-bad trace")

    # -- 3. the planner-guided de-opt ladder under the chaos oom ceiling ------
    print("--- static smoke: de-opt ladder jump under oom@<3")
    from thunder_tpu_torch.analysis.liveness import predict_level_peaks

    xb = _tensor(rng.randn(100, 64).astype(np.float32))  # batch 100 -> pow2 bucket 128
    wb = _tensor(rng.randn(64, 64).astype(np.float32))

    def chain(xv, wv):
        h = clang.tanh(clang.matmul(xv, wv))
        h = clang.matmul(h, wv)
        return clang.sum(clang.mul(h, h))

    baseline = float(_jit(chain, executors=["torch"])(xb, wb))
    probe = _jit(chain, cache="symbolic values", symbolic_dims={0: (0,)}, executors=["torch"])
    probe(xb, wb)
    pe = probe._lc_cs.cache_entries[0]
    peaks = predict_level_peaks(pe.computation_traces[-1], sym_spec=pe.sym_spec, true_extents=pe.last_true_extents)
    if not (peaks[3] and peaks[1] and peaks[3] < peaks[1]):
        n_errors += 1
        print(f"    FAILED: exact-shape peak should undercut padded ({peaks})")
        print(f"\nlint_traces --static: {n_errors} error(s)")
        return n_errors
    capacity = (peaks[1] + peaks[3]) // 2
    was = os.environ.get("THUNDER_TPU_HBM_BYTES")
    os.environ["THUNDER_TPU_HBM_BYTES"] = str(int(capacity))
    log = os.path.join(tempfile.mkdtemp(prefix="ttpu_static_"), "events.jsonl")
    try:
        jf = _jit(chain, cache="symbolic values", symbolic_dims={0: (0,)}, executors=["torch"],
                  chaos="oom@<3*inf", events=log)
        out = float(jf(xb, wb))
        cs = jf._lc_cs
        level = jf._lc_cd._deopt_level
        deopts = [r for r in map(json.loads, open(log)) if r.get("kind") == "compile_deopt"]
        blind_compiles = 1 + 3  # a blind climb pays one failed compile a level to L3
        ok = (abs(out - baseline) < 1e-3 * max(abs(baseline), 1.0) and level == 3
              and cs.compile_count < blind_compiles and len(deopts) == 1
              and deopts[0].get("skipped_levels") == [1, 2] and deopts[0].get("predicted_peak_bytes"))
        if ok:
            print(f"    ladder jump OK: L0 -> L3 in {cs.compile_count} compiles (blind: {blind_compiles}), "
                  f"skipped {deopts[0]['skipped_levels']}, predicted "
                  f"{deopts[0]['predicted_peak_bytes'] / 1e3:.1f} KB vs capacity {capacity / 1e3:.1f} KB")
        else:
            n_errors += 1
            print(f"    FAILED: level={level} compiles={cs.compile_count} (blind={blind_compiles}) "
                  f"deopts={deopts} out={out} baseline={baseline}")
    finally:
        if was is None:
            os.environ.pop("THUNDER_TPU_HBM_BYTES", None)
        else:
            os.environ["THUNDER_TPU_HBM_BYTES"] = was

    print(f"\nlint_traces --static: {n_errors} error(s)")
    return n_errors


# =============================================================================
# --schedule
# =============================================================================


def _schedule_smoke() -> int:
    """--schedule: the comm-scheduler smoke. Four parts:

    1. the fsdp4-tp2 grad trace schedules with at least one hoist,
       re-certifies with the same per-axis order, passes the verifier, and
       its prediction hides wire time for the top fsdp ``synchronize`` and
       a grad ``reduce_scatter``;
    2. with ``capacity_bytes`` between the unscheduled and the fully hoisted
       peaks the hoists back off to a placement that fits;
    3. the chaos ``sched_bad`` corrupts a placement: the pass's validation
       rejects it, the unscheduled order stays, and the event log pairs the
       fault with its ``sharp_edge``;
    4. a chaos ``compile_fail`` climbs to L1, where the scheduler is off.
    """
    import json
    import tempfile

    import torch

    os.environ.setdefault("THUNDER_TPU_RETRY_BACKOFF_S", "0")

    import thunder_tpu_torch.clang as clang
    from thunder_tpu_torch.analysis import Severity, verify
    from thunder_tpu_torch.analysis import schedule as sched_mod
    from thunder_tpu_torch.analysis.liveness import plan_liveness
    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.resilience import chaos as chaos_mod
    from thunder_tpu_torch.transforms.autodiff import grad_transform
    from thunder_tpu_torch.transforms.comm_schedule import schedule_collectives
    from thunder_tpu_torch.transforms.common import dce

    n_errors = 0
    rng = np.random.RandomState(0)
    layers, d, B, fsdp_g, tp_g = 3, 64, 16, 4, 2
    ws = [torch.from_numpy(rng.randn(d // fsdp_g, d).astype(np.float32)) for _ in range(layers)]
    x = torch.from_numpy(rng.randn(B, d).astype(np.float32))

    def fsdp_tp_loss(*flat_in):
        *w_shards, xv = flat_in
        h = xv
        for w_shard in w_shards:
            w_full = dist.synchronize(w_shard, "fsdp", fsdp_g, "fsdp")
            h = clang.matmul(h, clang.transpose(w_full, 0, 1))
            h = dist.all_reduce(h, "tp", tp_g, op="avg")
            h = clang.tanh(h)
        return clang.mean(clang.mul(h, h))

    def build(grad=True):
        _, comp = trace_program(fsdp_tp_loss, (*ws, x), {})
        comp = dce(comp)
        if grad:
            comp = grad_transform(comp, return_value=True)
        return transform_for_execution(comp, resolve_executors(["torch"]))

    # -- 1. schedule, re-certify, hidden wire for sync and reduce_scatter ----
    print("--- schedule smoke: fsdp4-tp2 grad trace through the scheduler")
    extrace = build()
    cert0 = sched_mod.stamp(extrace)
    scheduled, rep = schedule_collectives(extrace, device="cpu")
    pred = sched_mod.predict_overlap(scheduled, device="cpu")
    top_sync = max((s for s in pred.sites if s.sym == "synchronize"), key=lambda s: s.hidden_us, default=None)
    top_rs = max((s for s in pred.sites if s.sym == "reduce_scatter"), key=lambda s: s.hidden_us, default=None)
    cert1 = sched_mod.certify(scheduled)
    errors = [dg for dg in verify(scheduled) if dg.severity >= Severity.ERROR]
    ok = (rep is not None and rep.moves >= 1 and cert1.axis_order == cert0.axis_order
          and scheduled.tags.get("collective_order") == cert1.axis_order and not errors
          and top_sync is not None and top_sync.hidden_us > 0 and top_rs is not None and top_rs.hidden_us > 0)
    if ok:
        print(f"    scheduled OK: {rep.moves} move(s), axis order preserved, verifier clean; hidden "
              f"{top_sync.label()}={top_sync.hidden_us:.1f}us, {top_rs.label()}={top_rs.hidden_us:.1f}us "
              f"(exposed {rep.exposed_pct_before:.0f}% -> {rep.exposed_pct_after:.0f}%)")
    else:
        n_errors += 1
        print(f"    FAILED: moves={getattr(rep, 'moves', None)} order_ok={cert1.axis_order == cert0.axis_order} "
              f"errors={errors} sync={top_sync} rs={top_rs}")

    # -- 2. liveness back-off under a capacity squeeze ------------------------
    # The forward alone: the grad trace's peak sits in the backward, and
    # hoisting every synchronize holds all the full weights at once.
    print("--- schedule smoke: capacity squeeze forces hoist back-off")
    fwd0 = build(grad=False)
    sched_free, _ = schedule_collectives(fwd0, device="cpu")
    p0 = plan_liveness(fwd0, include_rows=False).peak_bytes
    p1 = plan_liveness(sched_free, include_rows=False).peak_bytes
    if not p1 > p0:
        n_errors += 1
        print(f"    FAILED: hoisting should raise the predicted peak ({p0} -> {p1})")
    else:
        cap = (p0 + p1) // 2
        sched_cap, rep_cap = schedule_collectives(build(grad=False), device="cpu", capacity_bytes=cap)
        p_cap = plan_liveness(sched_cap, include_rows=False).peak_bytes
        if rep_cap is not None and rep_cap.backoffs >= 1 and p_cap <= cap:
            print(f"    back-off OK: free peak {p1 / 1e3:.1f}KB > capacity {cap / 1e3:.1f}KB -> "
                  f"{rep_cap.backoffs} back-off(s), constrained peak {p_cap / 1e3:.1f}KB fits")
        else:
            n_errors += 1
            print(f"    FAILED: backoffs={getattr(rep_cap, 'backoffs', None)} peak {p_cap} vs capacity {cap} "
                  f"(free {p1})")

    # -- 3. chaos sched_bad: a corrupted placement demotes to unscheduled ----
    print("--- schedule smoke: sched_bad chaos falls back cleanly")
    from thunder_tpu_torch.analysis.events import replay_events
    from thunder_tpu_torch.observability import events as obs_events

    log = os.path.join(tempfile.mkdtemp(prefix="ttpu_sched_"), "events.jsonl")
    extrace = build()
    order_before = sched_mod.certify(extrace).axis_order
    with obs_events.event_scope(obs_events.log_for_path(log)):
        with chaos_mod.chaos_scope("sched_bad*1"):
            fell_back, rep_bad = schedule_collectives(extrace, device="cpu")
    recs = [json.loads(line) for line in open(log)]
    injected = any(r.get("kind") == "fault_injected" and r.get("seam") == "sched_bad" for r in recs)
    rejected = any(r.get("kind") == "sharp_edge" and r.get("policy") == "comm_schedule_fallback" for r in recs)
    _, replay_diags = replay_events(log)
    uncorrelated = [dg for dg in replay_diags if dg.rule == "events.unrecovered-fault"]
    if (fell_back is extrace and rep_bad is None and sched_mod.certify(fell_back).axis_order == order_before
            and injected and rejected and not uncorrelated):
        print("    sched_bad OK: corrupted placement rejected, unscheduled order kept, fault_injected + "
              "sharp_edge correlated")
    else:
        n_errors += 1
        print(f"    FAILED: fell_back={fell_back is extrace} rep={rep_bad} injected={injected} "
              f"rejected={rejected} kinds={[r.get('kind') for r in recs]}")

    # -- 4. compile_fail climbs the ladder; L1 compiles without the scheduler -
    print("--- schedule smoke: compile_fail de-opts to L1 (scheduler off)")
    xb = _tensor(rng.randn(8, 8).astype(np.float32))

    def chain(xv):
        h = clang.tanh(clang.matmul(xv, xv))
        return clang.sum(clang.mul(h, h))

    baseline = float(_jit(chain, executors=["torch"])(xb))
    jf = _jit(chain, executors=["torch"], chaos="compile_fail*1;seed=3")
    out = float(jf(xb))
    level = jf._lc_cd._deopt_level
    if abs(out - baseline) < 1e-6 * max(abs(baseline), 1.0) and level == 1:
        print("    de-opt OK: recovered at L1 (residual pair and comm-schedule off), result matches baseline")
    else:
        n_errors += 1
        print(f"    FAILED: level={level} out={out} baseline={baseline}")

    print(f"\nlint_traces --schedule: {n_errors} error(s)")
    return n_errors


# =============================================================================
# --chaos
# =============================================================================


def _chaos_smoke() -> int:
    """--chaos: the GPT gradient pipeline under a canned fault schedule
    (an executor's kernel raise, a compile failure, an OOM, NaN poison):
    every fault recovers to the un-faulted baseline bit for bit, or raises
    the typed error naming its seam, and the event log carries the
    ``fault_injected`` -> recovery pair of each injection (the replay's
    ``events.unrecovered-fault`` rule). Returns the error count."""
    import tempfile

    os.environ.setdefault("THUNDER_TPU_RETRY_BACKOFF_S", "0")

    import torch

    from thunder_tpu_torch.analysis import Severity
    from thunder_tpu_torch.analysis.events import format_replay, replay_events
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.extend import OperatorExecutor, get_executor, register_executor
    from thunder_tpu_torch.resilience import NonFiniteOutputError, chaos, demotion

    demotion.clear_quarantine()
    m, cfg, params, idx, tgt = _gpt_tiny()

    def loss(p, i, t):
        return m.loss_fn(p, i, t, cfg)

    log = os.path.join(tempfile.mkdtemp(prefix="ttpu_chaos_"), "events.jsonl")
    n_errors = 0

    def flat(out):
        return [_host(x) for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]

    print("--- chaos smoke: un-faulted baseline")
    baseline = flat(_value_and_grad(loss, executors=["torch"])(params, idx, tgt))

    # A chaos-armed executor claiming the erf prim (inside the MLP's gelu):
    # the kernel-raise seam on a program that needs no kernel of the card.
    # Its impl is the torch executor's, so an un-demoted claim is bitwise the
    # baseline.
    smoke_ex = get_executor("chaos_smoke")
    if smoke_ex is None:
        smoke_ex = OperatorExecutor("chaos_smoke")
        register_executor(smoke_ex)
        base_erf = get_executor("torch").get_impl(PrimIDs.ERF)

        def _smoke_erf(a, _base=base_erf):
            chaos.kernel_seam("chaos_smoke", "erf")
            return _base(a)

        smoke_ex.register_implementation(PrimIDs.ERF, fn=_smoke_erf)

    schedules = [
        ("kernel_raise (executor demotion)", ["chaos_smoke", "torch"], "kernel_raise@chaos_smoke*1", None),
        ("compile_fail + oom (de-opt ladder)", ["torch"], "compile_fail*1;oom*1", None),
        ("nan poison (isfinite guard)", ["torch"], "nan@matmul*1", "rerun-instrumented"),
    ]
    for name, executors, spec, on_nan in schedules:
        print(f"--- chaos smoke: {name} [{spec}]")
        jf = _value_and_grad(loss, executors=executors, events=log, chaos=spec, on_nan=on_nan)
        try:
            out = flat(jf(params, idx, tgt))
        except NonFiniteOutputError as e:
            if on_nan is None:
                n_errors += 1
                print(f"    FAILED: unexpected NonFiniteOutputError: {e}")
            else:
                print(f"    recovered loudly: {type(e).__name__} attributed to {e.symbol!r}")
            continue
        except Exception as e:  # noqa: BLE001 — an unrecovered fault escaped: that is the failure
            n_errors += 1
            print(f"    FAILED (unrecovered fault): {type(e).__name__}: {e}")
            continue
        if on_nan is not None:
            n_errors += 1
            print("    FAILED: nan poison did not trip the isfinite guard")
        elif len(out) != len(baseline) or any(not np.array_equal(a, b) for a, b in zip(out, baseline)):
            n_errors += 1
            print("    FAILED: recovered run is not bitwise-equal to baseline")
        else:
            print("    recovered, bitwise-equal to baseline")

    print("--- chaos smoke: event-log replay (correlation rule)")
    # Recompiles are the recovery under chaos (every demotion and de-opt
    # recompiles), so the storm heuristic gets headroom; the correlation
    # rule is what this replay is for.
    summary, diags = replay_events(log, storm_threshold=16)
    print(format_replay(summary, diags))
    n_errors += sum(1 for dg in diags if dg.severity >= Severity.ERROR)
    if not summary.get("faults_injected"):
        n_errors += 1
        print("    FAILED: no fault_injected events recorded")
    demotion.clear_quarantine()
    print(f"\nlint_traces --chaos: {n_errors} error(s)")
    return n_errors


# =============================================================================
# --ops
# =============================================================================


def _ops_smoke() -> int:
    """--ops: the live ops plane against a chaos'd GPT step. /healthz flips
    degraded on a seeded straggler (the streaming detectors), /metrics
    scrapes mid-run with host labels and the always-exported drop counter,
    an injected hang leaves a schema-valid flight-recorder dump, and the
    plane's cost stays under 1% of the step, with no tap installed once it
    is shut down. Returns the error count."""
    import glob
    import json
    import tempfile
    import time

    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.analysis import Severity
    from thunder_tpu_torch.analysis.events import replay_events
    from thunder_tpu_torch.observability import events as obs_events
    from thunder_tpu_torch.observability.detect import DetectorConfig
    from thunder_tpu_torch.resilience import chaos, watchdog
    from thunder_tpu_torch.resilience.preemption import CheckpointManager, run_training

    n_errors = 0
    tmp = tempfile.mkdtemp(prefix="ttpu_ops_")
    fr_dir = os.path.join(tmp, "flightrec")
    plane = monitor.serve(port=0, flightrec_dir=fr_dir, detectors=DetectorConfig(min_samples=6, cooldown=20))
    print(f"--- ops smoke: server on 127.0.0.1:{plane.port}")

    m, cfg, params, _, _ = _gpt_tiny()
    idx = _tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    jf = _jit(lambda p, i: m.forward(p, i, cfg), executors=["torch"])

    def step_fn(state):
        return state, float(jf(params, idx).mean())

    step_s = _forward_step_s(jf, params, idx)
    _, body = _get(plane.port, "/healthz")
    before = json.loads(body)["status"]

    # Clean steps, then a seeded straggler (a sub-timeout slowdown inside
    # the guarded step) the detectors must flag; /metrics is scraped
    # mid-run from the step callback.
    ccfg = chaos.ChaosConfig(rules=[], seed=0)
    scraped = {}

    def on_loss(step, loss):
        if step == 11:
            ccfg.rules.append(chaos.FaultRule("straggler", target="step", count=6, delay_s=max(0.25, step_s * 4)))
        if step == 18:
            scraped["code"], scraped["body"] = _get(plane.port, "/metrics")

    with chaos.chaos_scope(ccfg):
        run_training(step_fn, None, 24, manager=CheckpointManager(os.path.join(tmp, "ck")),
                     watchdog_timeout_s=60.0, on_loss=on_loss)

    _, body = _get(plane.port, "/healthz")
    after = json.loads(body)
    anomalies = [a.kind for a in plane.bank.recent_anomalies()]
    if before != "ok" or after["status"] == "ok" or not anomalies:
        n_errors += 1
        print(f"    FAILED: healthz did not flip on the straggler (before={before}, after={after['status']}, "
              f"anomalies={anomalies})")
    else:
        print(f"    healthz OK: ok -> {after['status']} on anomalies {sorted(set(anomalies))}")

    mtext = scraped.get("body") or ""
    if scraped.get("code") != 200 or "thunder_tpu_event_log_dropped_total" not in mtext or 'host="' not in mtext:
        n_errors += 1
        print(f"    FAILED: mid-run /metrics scrape (code={scraped.get('code')}, drop-counter present: "
              f"{'thunder_tpu_event_log_dropped_total' in mtext}, host label present: {'host=' in mtext})")
    else:
        print(f"    /metrics OK mid-run: {len(mtext.splitlines())} lines, host-labelled, always-export drop "
              f"counter present")

    # An injected hang turns into a typed timeout and a schema-valid
    # flight-recorder dump carrying its preceding context.
    with chaos.chaos_scope("collective_hang~30"):
        try:
            watchdog.guard_call(lambda: None, (), fn_name="gpt_step", timeout_s=0.2)
            n_errors += 1
            print("    FAILED: injected hang did not raise")
        except watchdog.CollectiveTimeoutError:
            pass
    dumps = glob.glob(os.path.join(fr_dir, "*collective_timeout.jsonl"))
    if not dumps:
        n_errors += 1
        print("    FAILED: no flight-recorder dump for the hang")
    else:
        summary, diags = replay_events(dumps[-1])
        errs = [dg for dg in diags if dg.severity >= Severity.ERROR]
        kinds = summary.get("kinds", {})
        if errs or not kinds.get("collective_timeout") or not summary.get("flightrec_dumps"):
            n_errors += 1
            print(f"    FAILED: dump replay ({len(errs)} error(s), kinds={kinds})")
        else:
            print(f"    flight recorder OK: {os.path.basename(dumps[-1])} ({summary['lines']} records, "
                  f"schema-valid, 0 correlation errors)")
    code, body = _get(plane.port, "/debug/flightrec")
    if code != 200 or not json.loads(body).get("path"):
        n_errors += 1
        print(f"    FAILED: /debug/flightrec ({code}: {body[:120]})")
    code, body = _get(plane.port, "/debug/state")
    state = json.loads(body) if code == 200 else {}
    if code != 200 or "cache" not in state or "autopilot" not in state:
        n_errors += 1
        print(f"    FAILED: /debug/state ({code})")

    # The plane's cost a step is one tap an emitted event (one step_time
    # event a step), composed against the measured step: an A/B wall-clock
    # difference under 1% would drown in the host's noise. Both sides are
    # the least of several repeats, since load on the host only adds time.
    N, REPEATS = 4_000, 5
    tap_ns = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(N):
            obs_events.emit_event("step_time", fn="overhead_probe", step=0, s=0.01)
        tap_ns = min(tap_ns, (time.perf_counter() - t0) / N * 1e9)
    ops_pct = tap_ns / (step_s * 1e9) * 100.0
    monitor.shutdown_ops()
    if obs_events.ops_active():
        n_errors += 1
        print("    FAILED: taps still installed after shutdown_ops()")
    if ops_pct >= 1.0:
        n_errors += 1
        print(f"    FAILED: ops-plane overhead {ops_pct:.3f}% of the {step_s * 1e3:.1f}ms step (budget < 1%)")
    else:
        print(f"    overhead OK: {tap_ns:.0f}ns/event = {ops_pct:.4f}% of the {step_s * 1e3:.1f}ms step (< 1%); "
              f"plane off installs zero taps")

    print(f"\nlint_traces --ops: {n_errors} error(s)")
    return n_errors


# =============================================================================
# --roofline
# =============================================================================


def _roofline_smoke() -> int:
    """--roofline: the continuous roofline ledger. A duty-cycled sampler on
    gpt-tiny's forward gives a schema-valid per-op ledger (at least 10 rows,
    every row in ``roofline.ROW_FIELDS``) served live at /debug/roofline; an
    op whose static bound is deflated 8x trips a typed ``cost_model_drift``
    through the detector bank; the armed-but-not-due cost a step stays under
    1% of the step; with sampling off no probe runs; then the gate of the
    port's ``ROOFLINE`` series (one round suffices). Returns the error
    count."""
    import json
    import time

    # Before any jit: annotated code generation stamps the L<idx>.<sym>
    # ranges that attribute the profiler's rows back to trace lines.
    os.environ.setdefault("THUNDER_TPU_ANNOTATE_TRACES", "1")

    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.observability.detect import DetectorConfig
    from thunder_tpu_torch.observability.roofline import ROW_FIELDS, RooflineSampler

    n_errors = 0
    plane = monitor.serve(port=0, detectors=DetectorConfig(min_samples=6, cooldown=20))
    print(f"--- roofline smoke: ops server on 127.0.0.1:{plane.port}")

    m, cfg, params, _, _ = _gpt_tiny()
    idx = _tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    jf = _jit(lambda p, i: m.forward(p, i, cfg), executors=["torch"])
    step_s = _forward_step_s(jf, params, idx)

    off = RooflineSampler(jf)
    for _ in range(8):
        off.maybe_sample(jf, params, idx)
    if off.every != 0 or off.probes != 0 or len(off.ledger) != 0:
        n_errors += 1
        print(f"    FAILED: sampler off still probed (every={off.every}, probes={off.probes})")
    else:
        print("    off OK: every=0 by default, 8 steps, zero probes")

    sampler = monitor.roofline(jf, every=4)
    for _ in range(12):
        sampler.maybe_sample(jf, params, idx)
    snap = sampler.ledger.snapshot()
    bad_rows = [r for r in snap["rows"] if set(r) != set(ROW_FIELDS)]
    priced = [r for r in snap["rows"] if r["roofline_us"] is not None]
    if sampler.probes != 3 or snap["ops"] < 10 or bad_rows or len(priced) < 10:
        n_errors += 1
        print(f"    FAILED: ledger (probes={sampler.probes}, ops={snap['ops']}, schema violations={len(bad_rows)}, "
              f"priced rows={len(priced)})")
    else:
        print(f"    ledger OK: 12 steps -> 3 probes, {snap['ops']} op rows, schema-valid, {len(priced)} with "
              f"roofline ceilings")

    code, body = _get(plane.port, "/debug/roofline")
    live = json.loads(body) if code == 200 else {}
    if code != 200 or not live.get("enabled") or live.get("ledger", {}).get("ops") != snap["ops"]:
        n_errors += 1
        print(f"    FAILED: /debug/roofline ({code}: {body[:120]})")
    else:
        print(f"    /debug/roofline OK: live ledger, {live['ledger']['ops']} ops, {live['probes']} probes")

    # A seeded mispriced op: the hottest op's static bound deflated 8x in
    # the sampler's cost rows (a TraceCost a pass of the step) walks the
    # measured/predicted ratio out of its band, and the detector bank raises
    # cost_model_drift.
    top = sampler.ledger.rows()[0]
    seeded = 0
    for tag, cost in sampler._cost.items():
        if top.pass_name is not None and tag != top.pass_name:
            continue
        for r in cost.rows:
            if r.sym == top.sym and r.index == top.line:
                r.roofline_s /= 8.0
                seeded += 1
    tripped = None
    kinds = []
    for i in range(10):
        sampler.sample(jf, params, idx)
        kinds = [a.kind for a in plane.bank.recent_anomalies()]
        if "cost_model_drift" in kinds:
            tripped = i + 1
            break
    if not seeded or tripped is None:
        n_errors += 1
        print(f"    FAILED: seeded mispriced op ({top.label}, {seeded} cost row(s) deflated) raised no "
              f"cost_model_drift (anomalies={sorted(set(kinds))})")
    else:
        a = next(a for a in plane.bank.recent_anomalies() if a.kind == "cost_model_drift")
        print(f"    drift OK: {top.label} deflated 8x -> cost_model_drift ({a.severity}, ratio "
              f"{a.value / a.baseline:.1f}x baseline) after {tripped} probe(s)")

    N = 50_000
    armed = RooflineSampler(jf, every=10**9)
    t0 = time.perf_counter()
    for _ in range(N):
        armed.tick()
    tick_ns = (time.perf_counter() - t0) / N * 1e9
    tick_pct = tick_ns / (step_s * 1e9) * 100.0
    if tick_pct >= 1.0:
        n_errors += 1
        print(f"    FAILED: armed duty-cycle overhead {tick_pct:.3f}% of the {step_s * 1e3:.1f}ms step (budget < 1%)")
    else:
        print(f"    overhead OK: {tick_ns:.0f}ns/step armed = {tick_pct:.4f}% of the {step_s * 1e3:.1f}ms step (< 1%)")

    monitor.shutdown_roofline()
    monitor.shutdown_ops()
    n_errors += _bench_history_gate("ROOFLINE", min_rounds=1)
    print(f"\nlint_traces --roofline: {n_errors} error(s)")
    return n_errors


# =============================================================================
# --critpath
# =============================================================================


def _critpath_smoke() -> int:
    """--critpath: the fleet critical-path ledger on a synthetic 4-host
    fleet through the armed timeline recorder. Injected clock skews are
    recovered from the barrier records; the per-step breakdowns make a
    schema-valid ledger served at /debug/critpath (and a ``timeline``
    component of /healthz); a seeded straggler host trips a host-named
    ``bottleneck_shift``; the exposed-collective cross-check agrees within
    the noise floor; the armed cost a step stays under 1% of a measured
    gpt-tiny step; then the gate of the port's ``CRITPATH`` series (one round
    suffices). Returns the error count."""
    import json
    import time

    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.observability.detect import DetectorConfig
    from thunder_tpu_torch.observability.timeline import CLASSES

    n_errors = 0
    plane = monitor.serve(port=0, detectors=DetectorConfig(min_samples=6, cooldown=20, critpath_min_steps=4,
                                                           critpath_straggler_frac=0.25, critpath_cooldown=0))
    print(f"--- critpath smoke: ops server on 127.0.0.1:{plane.port}")

    m, cfg, params, _, _ = _gpt_tiny()
    idx = _tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    step_s = _forward_step_s(_jit(lambda p, i: m.forward(p, i, cfg), executors=["torch"]), params, idx)

    # event_sample=8: the emitted events and gauges ride a 1-in-8 duty
    # cycle while the estimator, ledger and detectors see every step (the
    # checks below read in-process state).
    injected = {"h0": 0.0, "h1": 0.12, "h2": -0.08, "h3": 0.04}
    rec = monitor.critpath(bank=plane.bank, emulated_skew_s=injected, event_sample=8)
    rec.set_static_wire(0.10, 0.05, static_exposed_pct=15.0)
    rec.predicted_exposed_pct = 15.0

    BASE, DELAY, STALL = 0.050, 0.030, 0.004
    hosts = sorted(injected)
    for step in range(16):
        spans = {}
        for h in hosts:
            sp = dict(rec.static_spans(BASE))
            d = DELAY if (h == "h3" and 6 <= step < 14) else 0.0
            stall = STALL if step % 2 == 0 else 0.0
            sp["total_s"] = BASE + d + stall
            sp["stall_s"] = stall
            spans[h] = sp
            rec.note_collective(h, step, fn="fleet_step", s=0.0, step=step)
        rec.record_step(step, spans)

    # The estimates are relative to the fleet-median clock: compare with
    # the injected offsets centred the same way.
    ests = rec.skew_estimates()
    med = sorted(injected.values())
    med = (med[1] + med[2]) / 2.0
    centered = {h: v - med for h, v in injected.items()}
    err_ms = max(abs(e.offset_s - centered[h]) * 1e3 for h, e in ests.items()) if ests else float("inf")
    outliers = [h for h, e in ests.items() if e.outlier]
    if len(ests) != 4 or err_ms > 5.0 or outliers:
        n_errors += 1
        print(f"    FAILED: skew recovery (hosts={len(ests)}, err={err_ms:.3f}ms, outliers={outliers})")
    else:
        print(f"    skew OK: 4 hosts recovered within {err_ms:.3f}ms of injected (120/-80/40ms spread), no false "
              f"outliers")

    snap = rec.ledger.snapshot(last=16)
    rows = snap["last_steps"]
    bad = [r for r in rows if set(r) != {"step", "total_s", "classes", "slowest_host", "n_hosts"}
           or not set(r["classes"]) <= set(CLASSES)]
    fsum = sum(snap["fractions"].values())
    strag = snap["straggler_hosts"]
    if snap["steps"] != 16 or bad or abs(fsum - 1.0) > 0.02 or strag.get("h3", 0) < 6:
        n_errors += 1
        print(f"    FAILED: ledger (steps={snap['steps']}, schema violations={len(bad)}, frac_sum={fsum:.3f}, "
              f"straggler_hosts={strag})")
    else:
        print(f"    ledger OK: 16 steps, schema-valid rows, fractions sum {fsum:.3f}, straggler-wait on h3 "
              f"x{strag['h3']}")

    shifts = [a for a in plane.bank.recent_anomalies() if a.kind == "bottleneck_shift"]
    named = [a for a in shifts if a.suspect_host == "h3"]
    if not named:
        n_errors += 1
        print(f"    FAILED: seeded straggler h3 raised no host-named bottleneck_shift "
              f"(got {[(a.kind, a.suspect_host) for a in shifts]})")
    else:
        a = named[0]
        print(f"    detector OK: bottleneck_shift ({a.severity}, {a.detector}) names h3, straggler frac "
              f"{a.value:.2f} vs band {a.baseline:.2f}")

    cc = rec.crosscheck()
    d_static, d_pred = cc.get("delta_static_pct"), cc.get("delta_predicted_pct")
    if d_static is None or abs(d_static) > 10.0 or d_pred is None or abs(d_pred) > 10.0:
        n_errors += 1
        print(f"    FAILED: exposed-pct cross-check ({cc})")
    else:
        print(f"    crosscheck OK: measured {cc['measured_exposed_pct']:.1f}% vs static "
              f"{cc['static_exposed_pct']:.1f}% (d {d_static:+.2f}) / scheduler {cc['predicted_exposed_pct']:.1f}% "
              f"(d {d_pred:+.2f})")

    code, body = _get(plane.port, "/debug/critpath")
    live = json.loads(body) if code == 200 else {}
    if (code != 200 or not live.get("enabled") or live.get("ledger", {}).get("steps") != 16
            or "skew" not in live or "crosscheck" not in live):
        n_errors += 1
        print(f"    FAILED: /debug/critpath ({code}: {body[:120]})")
    else:
        print(f"    /debug/critpath OK: live ledger, {live['ledger']['steps']} steps, {len(live['skew'])} skew "
              f"estimates")
    code, body = _get(plane.port, "/healthz")
    verdict = json.loads(body) if body else {}
    tl_comp = (verdict.get("components") or {}).get("timeline")
    if tl_comp is None or tl_comp.get("hosts") != 4:
        n_errors += 1
        print(f"    FAILED: /healthz timeline component missing or wrong ({tl_comp})")
    else:
        print(f"    /healthz OK: timeline component {tl_comp.get('status')}, {tl_comp['hosts']} hosts, min "
              f"confidence {tl_comp.get('min_confidence')}")

    # This one process plays all four hosts; a deployment spreads the
    # barrier records over its processes and only the driver folds, so the
    # budget holds the per-host share under 1% of the step.
    N = 2_000
    spans = {h: dict(rec.static_spans(BASE), total_s=BASE) for h in hosts}
    t0 = time.perf_counter()
    for i in range(N):
        for h in hosts:
            rec.note_collective(h, 1000 + i, fn="fleet_step", s=0.0, step=1000 + i)
        rec.record_step(1000 + i, spans)
    per_step_ns = (time.perf_counter() - t0) / N * 1e9
    per_host_ns = per_step_ns / len(hosts)
    pct = per_host_ns / (step_s * 1e9) * 100.0
    if pct >= 1.0:
        n_errors += 1
        print(f"    FAILED: armed per-host cost {per_host_ns:.0f}ns = {pct:.3f}% of the {step_s * 1e3:.1f}ms step "
              f"(budget < 1%; full {len(hosts)}-host emulation {per_step_ns:.0f}ns)")
    else:
        print(f"    overhead OK: {per_host_ns:.0f}ns/step/host armed = {pct:.4f}% of the {step_s * 1e3:.1f}ms step "
              f"(< 1%; full {len(hosts)}-host emulation {per_step_ns:.0f}ns)")

    monitor.shutdown_critpath()
    monitor.shutdown_ops()
    n_errors += _bench_history_gate("CRITPATH", min_rounds=1)
    print(f"\nlint_traces --critpath: {n_errors} error(s)")
    return n_errors


# =============================================================================
# The rank modes: --chaos-multihost and --hlo on 4 gloo ranks
# =============================================================================


def _rank_smoke(mode: str, what: str) -> int:
    """Run ``mode`` as 4 gloo ranks of this module (``ranks.spawn_ranks``,
    in a temporary directory). Prints rank 0's output and returns 1 if any
    rank failed or the spawn outlasted ``SPAWN_TIMEOUT_S``."""
    import tempfile

    from thunder_tpu_torch.scripts import ranks

    out = tempfile.mkdtemp(prefix="ttpu_ranks_")
    print(f"--- {what} ({RANKS} gloo ranks)")
    codes, timed_out, logs = ranks.spawn_ranks(
        "thunder_tpu_torch.scripts.lint_traces", lambda r, store: [mode, str(r), str(RANKS), store, out],
        RANKS, out, SPAWN_TIMEOUT_S, cpu=True)
    for line in ranks.tail(logs[0], 60):
        print(f"    {line}")
    failed = [r for r, c in enumerate(codes) if c != 0]
    if timed_out:
        print(f"    FAILED: the ranks outlasted {SPAWN_TIMEOUT_S} s")
    for r in failed:
        if r:
            print(f"    rank {r}: " + " | ".join(ranks.tail(logs[r], 8)))
        print(f"    FAILED: rank {r} exited {codes[r]}")
    return 1 if timed_out or failed else 0


def _chaos_multihost_rank(rank: int, world: int, out: str) -> int:
    """The mesh-wide chaos matrix on 4 gloo ranks, gpt-tiny's fsdp2-tp2
    AdamW step: a collective hang raises the typed watchdog timeout naming
    its trace line and the suspected host; a host loss checkpoints, and the
    first 2 ranks resume it elastically on fsdp2 and reproduce the
    uninterrupted losses; an SDC injection is caught by the replica checksum
    and re-run, bit for bit; every fault_injected has its recovery in the
    ranks' merged event logs."""
    import json

    import torch
    import torch.distributed as tdist

    import thunder_tpu_torch.clang as clang
    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.analysis import Severity
    from thunder_tpu_torch.analysis.events import format_replay, replay_events
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed import runtime
    from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
    from thunder_tpu_torch.parallel import build_train_step, make_mesh, shard_pytree
    from thunder_tpu_torch.parallel.sharding import gpt_param_specs
    from thunder_tpu_torch.parallel.train import adamw_init, opt_state_specs
    from thunder_tpu_torch.resilience import chaos, elastic, watchdog
    from thunder_tpu_torch.resilience.preemption import CheckpointManager, HostLost, run_training

    log = os.path.join(out, f"events{rank}.jsonl")
    monitor.set_event_log(log)
    n_errors = 0
    N_STEPS, LOSS_STEP = 5, 2
    m, cfg, params, _, _ = _gpt_tiny()
    rng = np.random.RandomState(0)
    idx_np = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    idx, tgt = torch.from_numpy(idx_np), torch.from_numpy(np.roll(idx_np, -1, axis=1))

    def build(mesh):
        specs = gpt_param_specs(cfg, mesh)
        blocks = shard_pytree(params, mesh, specs)
        step, opt0 = build_train_step(cfg, blocks, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2,
                                      executors=["torch"], donate=False)

        def step_fn(state):
            p, o = state
            p, o, loss = step(p, o, idx, tgt)
            return (p, o), float(loss)

        return step_fn, (blocks, opt0), specs

    mesh4 = make_mesh(fsdp=2, tp=2)
    step4, state0, specs4 = build(mesh4)
    state_specs4 = (specs4, opt_state_specs(specs4))

    print("--- chaos-multihost: un-faulted baseline trajectory")
    _, baseline = run_training(step4, state0, N_STEPS, manager=CheckpointManager(os.path.join(out, "base")))
    print(f"    losses: {['%.4f' % x for x in baseline]}")

    print("--- chaos-multihost: collective hang -> typed watchdog timeout")
    # Synthetic per-host step logs make host 3 the straggler; the timeout
    # names it.
    hl = []
    for host in range(4):
        p = os.path.join(out, f"host{host}-{rank}.jsonl")
        with open(p, "w") as f:
            for s in range(4):
                f.write(json.dumps({"v": 1, "ts": float(s), "seq": s, "pid": 1, "host": host, "kind": "step_time",
                                    "fn": "step", "step": s, "s": 0.4 if host == 3 else 0.1}) + "\n")
        hl.append(p)
    summary, _ = monitor.host_health(hl)
    meshf = make_mesh(fsdp=world)
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32) * 0.1)
    x = torch.from_numpy(rng.randn(4, 8).astype(np.float32))

    def loss_traced(w_shard, xv):
        w_full = dist.synchronize(w_shard, "fsdp", world, "fsdp")
        h = clang.matmul(xv, clang.transpose(w_full, 0, 1))
        return clang.mean(clang.mul(h, h))

    jf, _ = compile_with_collectives(loss_traced, (w[:16 // world], x), meshf, (P("fsdp", None), P()),
                                     (P(), (P("fsdp", None), P())), grad=True)
    watchdog.configure(0.25)
    try:
        with chaos.chaos_scope("collective_hang~3.0"):
            jf(w, x)
        n_errors += 1
        print("    FAILED: hang did not time out")
    except watchdog.CollectiveTimeoutError as e:
        ok_line = any("synchronize" in ln for ln in e.trace_lines)
        ok_host = e.suspected_host == summary["stragglers"][0]
        if ok_line and ok_host:
            print(f"    typed timeout OK: lines={e.trace_lines[:2]} suspect=host{e.suspected_host}")
        else:
            n_errors += 1
            print(f"    FAILED: lines={e.trace_lines} suspect={e.suspected_host}")
    finally:
        watchdog.configure(None)
    # The abandoned worker ends its sleep and skips its call, on every rank.
    for t in list(watchdog._abandoned):
        t.join(timeout=30)
    tdist.barrier()

    print("--- chaos-multihost: host loss -> checkpoint -> elastic resume (fsdp2 on ranks 0-1)")
    mgr = CheckpointManager(os.path.join(out, "elastic"))
    try:
        with chaos.chaos_scope(f"host_loss@{LOSS_STEP}"):
            run_training(step4, state0, N_STEPS, manager=mgr, mesh=mesh4, specs=state_specs4)
        n_errors += 1
        print("    FAILED: host loss did not fire")
    except HostLost:
        survivors = [0, 1]
        job = tdist.new_group(survivors)
        mesh2 = make_mesh(fsdp=2, devices=survivors)
        if rank in survivors:
            specs2 = gpt_param_specs(cfg, mesh2)
            with runtime.job_scope(job):
                st, start = elastic.elastic_resume(mgr, (params, adamw_init(params)), mesh=mesh2,
                                                   specs=(specs2, opt_state_specs(specs2)))
            step2 = build(mesh2)[0]
            if start != LOSS_STEP:
                n_errors += 1
                print(f"    FAILED: resumed at {start}, expected {LOSS_STEP}")
            cont = []
            for _ in range(start, N_STEPS):
                st, loss = step2(st)
                cont.append(loss)
            if np.allclose(cont, baseline[LOSS_STEP:], rtol=1e-5):
                print(f"    elastic resume OK: {['%.4f' % v for v in cont]} matches the uninterrupted trajectory "
                      f"(reduction-order tolerance)")
            else:
                n_errors += 1
                print(f"    FAILED: resumed trajectory {cont} != baseline {baseline[LOSS_STEP:]}")
        else:
            print(f"    rank {rank} sat out the shrunk mesh")
    tdist.barrier()

    print("--- chaos-multihost: SDC injection -> checksum guard -> re-run")
    try:
        with chaos.chaos_scope("sdc*1"):
            _, sdc_losses = run_training(step4, state0, N_STEPS, manager=CheckpointManager(os.path.join(out, "sdc")),
                                         mesh=mesh4, specs=state_specs4, sdc_guard=True)
        if sdc_losses == baseline:
            print("    SDC quarantine + re-run OK: trajectory bitwise-equal")
        else:
            n_errors += 1
            print(f"    FAILED: SDC trajectory {sdc_losses} != {baseline}")
    except Exception as e:  # noqa: BLE001 — an escaped fault is the failure
        n_errors += 1
        print(f"    FAILED: {type(e).__name__}: {e}")

    monitor.set_event_log(None)
    tdist.barrier()
    if rank == 0:
        print("--- chaos-multihost: event-log replay of the ranks' merged logs (correlation rule)")
        summary, diags = replay_events([os.path.join(out, f"events{r}.jsonl") for r in range(world)],
                                       storm_threshold=16)
        print(format_replay(summary, diags))
        n_errors += sum(1 for dg in diags if dg.severity >= Severity.ERROR)
        need = ("fault_injected", "collective_timeout", "host_loss", "checkpoint_save", "elastic_resume",
                "sdc_suspect", "sdc_rerun")
        missing = [k for k in need if not summary["kinds"].get(k)]
        if missing:
            n_errors += 1
            print(f"    FAILED: missing event kinds: {missing}")
        if summary.get("unrecovered_faults"):
            n_errors += 1
            print(f"    FAILED: unrecovered faults: {summary['unrecovered_faults']}")
    print(f"\nlint_traces --chaos-multihost: {n_errors} error(s) on rank {rank}")
    return n_errors


# Keys every report's to_json() and each of its sites carry.
_HLO_REPORT_REQUIRED_KEYS = (
    "v", "module", "device", "n_ops", "n_computations", "collectives", "inserted_collectives",
    "explicit_collectives", "fusions", "layout_copies", "host_transfers", "flops", "comm_bytes", "wire_us",
    "hidden_us", "exposed_us", "exposed_pct", "sites",
)
_HLO_SITE_REQUIRED_KEYS = (
    "name", "opcode", "family", "computation", "group_size", "wire_bytes", "wire_us", "hidden_us", "exposed_us",
    "inserted", "derived",
)


def _hlo_rank(rank: int, world: int, out: str) -> int:
    """The compiled-program audit of gpt-tiny's fsdp2-tp2
    ``build_train_step`` on 4 gloo ranks, from the op record of one real
    step: the port spells its collectives in the trace, so every collective
    site is an explicit line of it with that line's wire bytes, but the
    loss's all-reduce over the data axis (summed outside the claimed
    program), which the audit names inserted; an all-reduce launched beside
    the step is named inserted too; the report's ``to_json()`` is
    schema-valid; and text that is not a program raises ``ValueError``."""
    import json

    import torch
    import torch.distributed as tdist

    from thunder_tpu_torch.analysis import hlo_audit
    from thunder_tpu_torch.analysis.cost import trace_cost
    from thunder_tpu_torch.parallel import build_train_step, gpt_param_specs, make_mesh, shard_pytree

    n_errors = 0
    m, cfg, params, _, _ = _gpt_tiny()
    idx_np = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    idx, tgt = torch.from_numpy(idx_np), torch.from_numpy(np.roll(idx_np, -1, axis=1))

    print("--- hlo smoke: audit the fsdp2-tp2 build_train_step step")
    mesh = make_mesh(fsdp=2, tp=2)
    specs = gpt_param_specs(cfg, mesh)
    p = shard_pytree(params, mesh, specs)
    step, opt, extrace = build_train_step(cfg, p, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2,
                                          executors=["torch"], donate=False, return_extrace=True)
    p, opt, _ = step(p, opt, idx, tgt)
    rep = hlo_audit.audit_jitted(step, p, opt, idx, tgt)
    rows = {extrace.scope_of(r.index): r for r in trace_cost(extrace, "cpu").rows}
    lines = sorted(sc for sc, r in rows.items() if r.sym in ("all_gather", "all_reduce", "reduce_scatter",
                                                              "synchronize"))
    explicit = [s for s in rep.sites if not s.inserted]
    inserted = [(s.family, s.wire_bytes, s.group_size) for s in rep.sites if s.inserted]
    ok = (lines and sorted({s.scope for s in explicit}) == lines and rep.explicit_collectives == len(lines)
          and all(s.wire_bytes == rows[s.scope].comm_bytes for s in explicit)
          and all(rep.by_family.get(f, {}).get("count", 0) >= 1 for f in ("all-gather", "reduce-scatter"))
          and inserted == [("all-reduce", 4 * 1.5, 4)])
    if ok:
        print(f"    sites OK: {rep.explicit_collectives} explicit collective sites, each a collective line of the "
              f"trace ({', '.join(f'{f} x{a['count']}' for f, a in sorted(rep.by_family.items()))}); the one "
              f"inserted site is the loss's all-reduce over the data ranks")
    else:
        n_errors += 1
        print(f"    FAILED: explicit={rep.explicit_collectives} lines={len(lines)} inserted={inserted} "
              f"families={sorted(rep.by_family)}")

    def planted(*args):
        res = step(*args)
        tdist.all_reduce(torch.ones(1024))  # launched outside the trace
        return res

    rep2 = hlo_audit.audit_record(planted, p, opt, idx, tgt)
    got = sorted(s.wire_bytes for s in rep2.sites if s.inserted)
    if got == [6.0, 4096 * 1.5] and rep2.explicit_collectives == rep.explicit_collectives:
        print("    planted OK: the all-reduce launched beside the step is named inserted")
    else:
        n_errors += 1
        print(f"    FAILED: planted all-reduce (inserted wire bytes {got}, explicit {rep2.explicit_collectives})")

    js = rep.to_json()
    missing = [k for k in _HLO_REPORT_REQUIRED_KEYS if k not in js]
    site_missing = [k for k in _HLO_SITE_REQUIRED_KEYS for s in js["sites"][:1] if k not in s]
    json.dumps(js)  # serializable end to end
    if missing or site_missing or not js["sites"]:
        n_errors += 1
        print(f"    FAILED: report schema (missing={missing}, site_missing={site_missing}, sites={len(js['sites'])})")
    else:
        print(f"    schema OK: {len(_HLO_REPORT_REQUIRED_KEYS)} report keys, {len(js['sites'])} sites serialized")

    try:
        hlo_audit.audit_hlo("this is not a program at all")
        n_errors += 1
        print("    FAILED: audit_hlo accepted garbage without a ValueError")
    except ValueError:
        print("    garbage OK: audit_hlo raises ValueError")
    tdist.barrier()
    print(f"\nlint_traces --hlo: {n_errors} error(s) on rank {rank}")
    return n_errors


# =============================================================================
# The soak smokes: --soak and --federation on 4 gloo ranks
# =============================================================================

# The soak result's schema: the keys the JAX CLI requires
# (scripts/lint_traces.py ``_SOAK_REQUIRED_KEYS``).
_SOAK_REQUIRED_KEYS = (
    "metric", "value", "unit", "seed", "n_devices", "mesh", "model", "steps",
    "soak_goodput_tokens_per_sec", "soak_tokens_per_sec",
    "soak_ideal_tokens_per_sec", "soak_goodput_ratio",
    "resilience_overhead_pct", "soak_wall_s", "soak_recovery_per_fault_s",
    "soak_faults_injected",
    "soak_fault_seams", "soak_overlapping_pairs", "soak_decisions",
    "soak_unrecovered", "soak_unactuated",
    # Tiered checkpointing.
    "checkpoint_stall_ms_per_step", "snapshot_every", "soak_snapshots",
    "soak_restore_tiers", "soak_restore_fallthroughs",
    # Live ops plane.
    "soak_ops_port", "soak_anomalies", "soak_anomalies_total",
    "soak_detection_lead", "soak_decisions_citing_anomaly",
    "soak_undetected_detector_classes", "soak_flightrec_dumps",
    "soak_flightrec_invalid", "soak_flightrec_missing",
)

# The hot loop's amortized checkpoint cost must stay snapshot-shaped (a
# device→host copy every few steps). A synchronous disk save leaking back
# onto the hot path costs ~100ms+ per cadence hit — far past this cap.
_SOAK_STALL_MS_PER_STEP_CAP = 25.0

# The four autopilot policy classes the smoke must see decided at least
# once (the schedule's REQUIRED_SEAMS guarantee the triggering faults).
_SOAK_POLICY_CLASSES = (
    "elastic_resume", "quarantine_rerun", "deopt_escalate", "checkpoint_halt",
)

# The pod result's schema: the keys the JAX CLI requires
# (scripts/lint_traces.py ``_POD_REQUIRED_KEYS``).
_POD_REQUIRED_KEYS = (
    "metric", "value", "unit", "n_devices", "n_slices", "mesh", "model",
    "steps", "soak_pod_goodput_tokens_per_sec", "soak_pod_wall_s",
    "soak_pod_degraded_steps", "soak_pod_degraded_tokens_per_sec",
    "soak_pod_full_width", "soak_pod_final_width", "soak_pod_min_width",
    "soak_pod_shrinks", "soak_pod_regrows", "soak_pod_restarts",
    "soak_pod_slice_loss_restores", "soak_pod_slice_loss_nonpeer_restores",
    "soak_pod_disk_restores_after_anchor", "soak_pod_restore_tiers",
    "soak_pod_decisions", "soak_pod_unrecovered", "soak_pod_unactuated",
    "soak_pod_replay_errors",
)

# The federation smoke's wall: shrink -> degraded training -> regrow, on
# the CPU, compiles for both widths included.
_FEDERATION_WALL_S = 60.0


def _bench_history_gate(series: str = "BENCH", min_rounds: int = 2, root=None) -> int:
    """``perf_report --history --gate`` over the committed rounds of the
    port's ``series`` (``perf_report.series_paths``) under ``root`` (default:
    the repo's root). Returns the error count: 0 when fewer than
    ``min_rounds`` rounds exist (the pod, roofline and critpath series pass
    1: their absolute invariants gate from the first round)."""
    from thunder_tpu_torch.scripts import perf_report

    paths = perf_report.series_paths(series, root)
    pattern = os.path.basename(perf_report.series_glob(series, root))
    if len(paths) < min_rounds:
        print(f"--- series gate [{pattern}]: {len(paths)} round(s), fewer than {min_rounds}; no error counted")
        return 0
    print(f"--- bench regression gate (perf_report --history --gate) [{pattern}]")
    return perf_report.run_history_gate(paths, gate=True)


def _soak_per_fault_check(result: dict, root=None) -> int:
    """The soak's recovery seconds a fault against the newest committed
    round of the port's ``SOAK`` series, within twice the soak series'
    noise floor (the smoke's shorter run amortizes one-off rebuilds over
    fewer faults); nothing to compare without a round. The goodput ratio
    swings with the machine's ideal step, so the recovery cost is the
    portable comparator. Returns the error count."""
    import json

    from thunder_tpu_torch.scripts import perf_report

    committed = perf_report.series_paths("SOAK", root)
    per_fault = result.get("soak_recovery_per_fault_s")
    if not committed or not isinstance(per_fault, (int, float)):
        print(f"    recovery {per_fault} s/fault; {len(committed)} round(s) of "
              f"{os.path.basename(perf_report.series_glob('SOAK', root))} to compare with")
        return 0
    with open(committed[-1]) as f:
        doc = json.load(f)
    ref = doc.get("parsed", doc).get("soak_recovery_per_fault_s")
    floor = 2 * perf_report.noise_floor("per_fault_s", "soak_goodput")
    if isinstance(ref, (int, float)) and abs(per_fault - ref) > floor:
        print(f"    FAILED: recovery cost {per_fault:.2f}s/fault vs committed {ref:.2f} (floor ±{floor:.1f}s)")
        return 1
    print(f"    recovery OK: {per_fault:.2f}s/fault (committed {ref}, {os.path.basename(committed[-1])}, floor "
          f"±{floor:.1f}s)")
    return 0



def _run_driver(module: str, what: str, timeout_s: float, args: tuple = ("--smoke", "--seed", "7")) -> tuple:
    """``python -m module *args --device cpu --out F`` (4 gloo ranks); its
    stderr's tail printed. Returns (rc, result or None, seconds)."""
    import json
    import subprocess
    import tempfile
    import time

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out_path = os.path.join(tempfile.mkdtemp(prefix="ttpu_smoke_"), "result.json")
    cmd = [sys.executable, "-m", module, *args, "--device", "cpu", "--out", out_path]
    print(f"--- {what}: " + " ".join(cmd[1:]))
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, env=env, cwd=repo)
    elapsed = time.perf_counter() - t0
    for line in r.stderr.strip().splitlines()[-20:]:
        print(f"    {line}")
    if r.returncode != 0:
        print(f"    FAILED: {module.rsplit('.', 1)[-1]} exited {r.returncode}")
    result = None
    if os.path.exists(out_path):
        with open(out_path) as f:
            result = json.load(f)
    return r.returncode, result, elapsed


def _torn_fallthrough_check() -> int:
    """Deterministic torn-write disk fall-through: a ``snap_torn`` background
    flush leaves its step directory WITHOUT the META commit marker; the
    tiered restore must skip the incomplete step and land on the older
    complete one — asserted from the replayed event log, not from
    in-process state. In this process, on the CPU. Returns the error
    count."""
    import json
    import tempfile

    import torch

    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.analysis.events import replay_events
    from thunder_tpu_torch.resilience import chaos, elastic
    from thunder_tpu_torch.resilience.preemption import CheckpointManager

    tmp = tempfile.mkdtemp(prefix="ttpu_torn_")
    log = os.path.join(tmp, "ev.jsonl")
    n_errors = 0
    monitor.set_event_log(log)
    try:
        mgr = CheckpointManager(os.path.join(tmp, "ck"), backoff_s=0, async_flush=True)
        state = {"p": torch.arange(8, dtype=torch.float32)}
        mgr.save(state, 10)
        with chaos.chaos_scope("snap_torn"):
            mgr.snapshot(state, 20, flush=True)
            mgr.close()  # drain: the torn flush's events are in the log
        _, meta, tier, _tried = elastic.tiered_restore(mgr)
    finally:
        monitor.set_event_log(None)
    if not (tier == "disk" and meta["step"] == 10):
        n_errors += 1
        print(f"    FAILED: torn fall-through restored {tier}@{meta['step']} (want disk@10)")
    summary, _ = replay_events(log)
    records = [json.loads(line) for line in open(log)]
    torn_flush = any(r["kind"] == "snapshot_flush" and not r["ok"] and r.get("reason") == "torn" for r in records)
    skipped = any(r["kind"] == "checkpoint_restore" and not r["ok"] for r in records)
    if not (torn_flush and skipped):
        n_errors += 1
        print(f"    FAILED: torn-write log shape (torn_flush={torn_flush}, incomplete-skip={skipped})")
    if summary.get("unrecovered_faults"):
        n_errors += 1
        print(f"    FAILED: snap_torn unrecovered: {summary['unrecovered_faults']}")
    if not n_errors:
        print("    torn-write fall-through OK: flush tore at step 20, restore skipped it and landed on disk@10")
    return n_errors


def soak_checks(result: dict) -> int:
    """The checks of ``--soak`` on a fleet soak result (the JAX CLI's, but
    the committed-series comparisons): the schema, zero unrecovered and
    unactuated, every policy class decided, the schedule's diversity, the
    snapshot stall, the restore tiers and a fall-through, the detectors and
    the flight recorder, a usable goodput. Returns the error count."""
    n_errors = 0
    missing = [k for k in _SOAK_REQUIRED_KEYS if k not in result]
    if missing:
        n_errors += 1
        print(f"    FAILED: soak JSON missing keys: {missing}")
    else:
        print(f"    schema OK ({len(_SOAK_REQUIRED_KEYS)} required keys)")

    if result.get("soak_unrecovered") or result.get("soak_unactuated"):
        n_errors += 1
        print(f"    FAILED: unrecovered={result.get('soak_unrecovered')} unactuated={result.get('soak_unactuated')}")
    else:
        print("    correlation OK: zero unrecovered faults, zero unactuated decisions")

    decisions = result.get("soak_decisions") or {}
    absent = [c for c in _SOAK_POLICY_CLASSES if not decisions.get(c)]
    if absent:
        n_errors += 1
        print(f"    FAILED: policy classes never decided: {absent} (got {decisions})")
    else:
        print("    policy coverage OK: " + ", ".join(f"{c}×{decisions[c]}" for c in _SOAK_POLICY_CLASSES))

    from thunder_tpu_torch.scripts.soak_fleet import seams_expected_not_fired

    scheduled = result.get("soak_fault_seams") or {}
    not_fired = result.get("soak_seams_not_fired")
    expected = seams_expected_not_fired(scheduled, int(result.get("n_devices") or 0))
    if not isinstance(not_fired, list) or sorted(not_fired) != expected:
        n_errors += 1
        print(f"    FAILED: seams armed and never fired {not_fired}, expected {expected} at "
              f"{result.get('n_devices')} rank(s)")
    else:
        print(f"    firing OK: every armed seam fired" + (f" but {expected} (silent on ranks)" if expected else ""))
    # The schedule's diversity, counted on the seams that were injected.
    seams = [s for s in scheduled
             if s not in (result.get("soak_seams_not_armed") or {}) and s not in (not_fired or [])]
    if len(seams) < 5 or not result.get("soak_overlapping_pairs"):
        n_errors += 1
        print(f"    FAILED: schedule diversity (injected seams={sorted(seams)}, "
              f"overlaps={result.get('soak_overlapping_pairs')})")
    else:
        print(f"    schedule OK: {result.get('soak_faults_injected')} faults across {len(seams)} injected seam kinds, "
              f"{result['soak_overlapping_pairs']} overlapping pair(s)")

    stall = result.get("checkpoint_stall_ms_per_step")
    # On ranks each snapshot first waits for the others, outside its stall:
    # printed beside it, since the step pays that wait too.
    peer_wait = result.get("checkpoint_peer_wait_ms_per_step")
    if not isinstance(stall, (int, float)) or not (0.0 < stall <= _SOAK_STALL_MS_PER_STEP_CAP):
        n_errors += 1
        print(f"    FAILED: checkpoint_stall_ms_per_step={stall} not in (0, {_SOAK_STALL_MS_PER_STEP_CAP}] — "
              f"snapshots missing, or disk IO leaked back onto the hot path (peer wait {peer_wait} ms/step)")
    else:
        print(f"    stall OK: {stall:.2f} ms/step over {result.get('soak_snapshots')} snapshots "
              f"(peer wait {peer_wait} ms/step, outside the stall)")
    tiers = result.get("soak_restore_tiers") or {}
    ram = (tiers.get("local") or 0) + (tiers.get("peer") or 0)
    if not ram or not tiers.get("disk"):
        n_errors += 1
        print(f"    FAILED: restore-tier coverage {tiers} (need >=1 RAM-tier and >=1 disk-tier restore)")
    elif not result.get("soak_restore_fallthroughs"):
        n_errors += 1
        print(f"    FAILED: no restore fell through an invalid tier (snap_corrupt must force the checksum gate; "
              f"tiers={tiers})")
    else:
        print("    tiers OK: " + ", ".join(f"{t}×{n}" for t, n in sorted(tiers.items()))
              + f"; {result['soak_restore_fallthroughs']} fall-through(s)")
    # The detectors must have flagged every detector-covered fault class, an
    # anomaly must PRECEDE the decision citing it (positive detection lead),
    # and every timeout/halt must have left a schema-valid flight dump.
    anomalies = result.get("soak_anomalies") or {}
    if result.get("soak_undetected_detector_classes") or not anomalies:
        n_errors += 1
        print(f"    FAILED: detector coverage (anomalies={anomalies}, "
              f"missed={result.get('soak_detector_classes_missed')})")
    elif not (isinstance(result.get("soak_detection_lead"), (int, float)) and result["soak_detection_lead"] > 0):
        n_errors += 1
        print(f"    FAILED: detection lead {result.get('soak_detection_lead')} not > 0 (no decision cited a "
              "preceding anomaly)")
    else:
        print("    detectors OK: " + ", ".join(f"{k}×{n}" for k, n in sorted(anomalies.items()))
              + f"; lead {result['soak_detection_lead']:.2f}s over {result.get('soak_decisions_citing_anomaly')} "
              "cited decision(s)")
    if (result.get("soak_flightrec_invalid") or result.get("soak_flightrec_missing")
            or not result.get("soak_flightrec_dumps")):
        n_errors += 1
        print(f"    FAILED: flight recorder (dumps={result.get('soak_flightrec_dumps')}, "
              f"invalid={result.get('soak_flightrec_invalid')}, missing={result.get('soak_flightrec_missing')})")
    else:
        print("    flight recorder OK: "
              + ", ".join(f"{r}×{n}" for r, n in sorted((result.get("soak_flightrec_by_reason") or {}).items()))
              + " dump(s), all schema-valid")
    goodput = result.get("soak_goodput_tokens_per_sec")
    if not isinstance(goodput, (int, float)) or goodput <= 0:
        n_errors += 1
        print(f"    FAILED: no usable goodput ({goodput})")
    else:
        print(f"    goodput OK: {goodput:.0f} tok/s; recovery {result.get('soak_recovery_per_fault_s')} s/fault")
    return n_errors


def _soak_smoke() -> int:
    """--soak: the fleet soak smoke. Runs ``thunder_tpu_torch.scripts.soak_fleet
    --smoke --seed 7`` on 4 gloo ranks and holds its result to
    :func:`soak_checks`, then the torn-write fall-through
    (:func:`_torn_fallthrough_check`), the per-fault recovery against the
    newest round of the port's ``SOAK`` series (:func:`_soak_per_fault_check`)
    and the series' gate. Returns the error count."""
    rc, result, _ = _run_driver("thunder_tpu_torch.scripts.soak_fleet", "soak smoke", 1500)
    if rc != 0 or result is None:
        return 1
    n_errors = soak_checks(result) + _torn_fallthrough_check() + _soak_per_fault_check(result)
    n_errors += _bench_history_gate("SOAK")
    print(f"\nlint_traces --soak: {n_errors} error(s)")
    return n_errors


def federation_checks(result: dict, elapsed_s: float) -> int:
    """The checks of ``--federation`` on a pod soak result and its wall
    seconds: the schema, the 60 s wall, one shrink and one regrow through a
    degraded window back to full width with no restart, the slice-loss
    restores from the peer tier and no disk restore after the anchor, a
    clean replay. Returns the error count."""
    n_errors = 0
    missing = [k for k in _POD_REQUIRED_KEYS if k not in result]
    if missing:
        n_errors += 1
        print(f"    FAILED: pod JSON missing keys: {missing}")
    else:
        print(f"    schema OK ({len(_POD_REQUIRED_KEYS)} required keys)")

    if elapsed_s >= _FEDERATION_WALL_S:
        n_errors += 1
        print(f"    FAILED: smoke took {elapsed_s:.1f}s (budget {_FEDERATION_WALL_S:.0f}s)")
    else:
        print(f"    budget OK: shrink->train->regrow in {elapsed_s:.1f}s")

    full = result.get("soak_pod_full_width")
    if not (result.get("soak_pod_shrinks") == 1
            and result.get("soak_pod_regrows") == 1
            and result.get("soak_pod_degraded_steps", 0) > 0
            and result.get("soak_pod_min_width", full) < full
            and result.get("soak_pod_final_width") == full
            and not result.get("soak_pod_restarts")):
        n_errors += 1
        print(f"    FAILED: elastic cycle (shrinks={result.get('soak_pod_shrinks')} "
              f"regrows={result.get('soak_pod_regrows')} degraded={result.get('soak_pod_degraded_steps')} widths "
              f"{result.get('soak_pod_min_width')}->{result.get('soak_pod_final_width')}/{full})")
    else:
        print(f"    elastic cycle OK: width {full}->{result.get('soak_pod_min_width')}->{full}, "
              f"{result.get('soak_pod_degraded_steps')} degraded step(s)")

    if (not result.get("soak_pod_slice_loss_restores")
            or result.get("soak_pod_slice_loss_nonpeer_restores")
            or result.get("soak_pod_disk_restores_after_anchor")):
        n_errors += 1
        print(f"    FAILED: peer-tier proof (restores={result.get('soak_pod_slice_loss_restores')} "
              f"nonpeer={result.get('soak_pod_slice_loss_nonpeer_restores')} "
              f"disk_after_anchor={result.get('soak_pod_disk_restores_after_anchor')})")
    else:
        print(f"    peer-tier proof OK: tiers {result.get('soak_pod_restore_tiers')}")

    if result.get("soak_pod_unrecovered") or result.get("soak_pod_unactuated") or result.get("soak_pod_replay_errors"):
        n_errors += 1
        print(f"    FAILED: replay (unrecovered={result.get('soak_pod_unrecovered')} "
              f"unactuated={result.get('soak_pod_unactuated')} errors={result.get('soak_pod_replay_errors')})")
    else:
        print("    correlation OK: zero unrecovered faults, zero unactuated decisions")
    return n_errors


def _federation_smoke() -> int:
    """--federation: the slice-failure-domain smoke. Runs
    ``thunder_tpu_torch.scripts.soak_pod --smoke --seed 7`` (2 slices of 2
    gloo ranks, one scripted whole-slice loss) and holds its result and
    wall seconds to :func:`federation_checks`, then gates the port's
    ``SOAK_POD`` series (one round suffices). Returns the error count."""
    rc, result, elapsed = _run_driver("thunder_tpu_torch.scripts.soak_pod", "federation smoke", 600)
    if rc != 0 or result is None:
        return 1
    n_errors = federation_checks(result, elapsed) + _bench_history_gate("SOAK_POD", min_rounds=1)
    print(f"\nlint_traces --federation: {n_errors} error(s)")
    return n_errors


# =============================================================================
# --multichip on 4 gloo ranks
# =============================================================================

# The multichip result's schema: the keys the JAX CLI requires
# (scripts/lint_traces.py ``_MULTICHIP_REQUIRED_KEYS``).
_MULTICHIP_REQUIRED_KEYS = (
    "metric", "value", "unit", "n_devices", "mesh", "model", "batch", "seq",
    "train_iter_s", "train_iter_synced_s", "train_iter_strict_sync_s",
    "train_tokens_per_sec", "train_mfu", "device_spec", "train_flops_per_step",
    "multichip_trace_claim_s", "multichip_xla_compile_s", "compile_phases",
)


def multichip_checks(result: dict) -> int:
    """The checks of ``--multichip`` on a ``bench_multichip`` result: the
    schema; collective rows from the profiled attribution, each with its
    hidden/exposed split; the overlap workload ran, its table counts its
    sites, and the comm scheduler moved at least one site and cut the
    static exposed share. Returns the error count."""
    n_errors = 0
    missing = [k for k in _MULTICHIP_REQUIRED_KEYS if k not in result]
    if missing:
        n_errors += 1
        print(f"    FAILED: bench JSON missing keys: {missing}")
    else:
        print(f"    schema OK ({len(_MULTICHIP_REQUIRED_KEYS)} required keys)")

    colls = result.get("collectives") or {}
    bad = [c for c, v in colls.items()
           if not all(k in v for k in ("us_per_step", "hidden_us_per_step", "exposed_us_per_step", "calls"))]
    if not colls:
        n_errors += 1
        print("    FAILED: no collective rows in the profiled attribution (expected all-gather/all-reduce/... on the "
              "FSDP x TP step)")
    elif bad:
        n_errors += 1
        print(f"    FAILED: collective rows missing overlap fields: {bad}")
    else:
        print(f"    collective rows OK: {sorted(colls)} ({result.get('spmd_collective_exposed_pct')}% of the step's "
              "time exposed)")

    if result.get("overlap_error"):
        n_errors += 1
        print(f"    FAILED: overlap workload errored: {result['overlap_error']}")
    elif not result.get("overlap"):
        n_errors += 1
        print("    FAILED: no overlap table")
    else:
        shown, total = result.get("overlap_sites_shown"), result.get("overlap_sites_total")
        moves = (result.get("comm_schedule") or {}).get("moves", 0)
        exp, exp_raw = result.get("collective_exposed_pct"), result.get("collective_exposed_pct_unscheduled")
        if total is None or shown is None:
            n_errors += 1
            print("    FAILED: overlap table lacks its site counts (overlap_sites_total/shown)")
        elif moves < 1 or exp is None or exp_raw is None or exp >= exp_raw:
            n_errors += 1
            print(f"    FAILED: scheduler must move sites and cut the static exposed pct (moves={moves}, "
                  f"{exp_raw} -> {exp})")
        else:
            print(f"    overlap table OK: {shown}/{total} site(s), {moves} scheduler move(s), static exposed "
                  f"{exp_raw}% -> {exp}%")
    return n_errors


def _multichip_smoke() -> int:
    """--multichip: the distributed observatory's smoke. Runs
    ``thunder_tpu_torch.scripts.bench_multichip --iters 3 --profile-steps
    2`` on 4 gloo ranks (fsdp2-tp2), holds its result to
    :func:`multichip_checks`, then gates the port's ``MULTICHIP_BENCH``
    series. Returns the error count."""
    rc, result, _ = _run_driver("thunder_tpu_torch.scripts.bench_multichip", "multichip smoke", 600,
                                ("--devices", str(RANKS), "--iters", "3", "--profile-steps", "2"))
    if rc != 0 or result is None:
        return 1
    n_errors = multichip_checks(result) + _bench_history_gate("MULTICHIP_BENCH")
    print(f"\nlint_traces --multichip: {n_errors} error(s)")
    return n_errors


# =============================================================================
# main
# =============================================================================

_USAGE = ("usage: lint_traces [pattern] [--device cpu|cuda] | --static | --schedule | --chaos | --chaos-multihost | "
          "--hlo | --ops | --roofline | --critpath | --soak | --federation | --multichip | --events <log.jsonl> [...] "
          "[--storm-threshold N]")
_SMOKES = {
    "--static": _static_smoke, "--schedule": _schedule_smoke, "--ops": _ops_smoke,
    "--roofline": _roofline_smoke, "--critpath": _critpath_smoke, "--chaos": _chaos_smoke,
    "--soak": _soak_smoke, "--federation": _federation_smoke, "--multichip": _multichip_smoke,
}
_RANK_MODES = {"--_chaos-multihost-rank": _chaos_multihost_rank, "--_hlo-rank": _hlo_rank}


def _take_device(argv: list):
    """Remove ``--device X`` from ``argv``; X, None when absent, or False
    when the flag has no value."""
    if "--device" not in argv:
        return None
    i = argv.index("--device")
    if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
        return False
    dev = argv[i + 1]
    del argv[i:i + 2]
    return dev


def main(argv=None) -> int:
    global _DEVICE
    argv = list(sys.argv[1:] if argv is None else argv)
    # Every call resolves its own device: the card unless it asks otherwise.
    _DEVICE = "cuda"

    if argv and argv[0] in _RANK_MODES:
        import thunder_tpu_torch.distributed as td

        from thunder_tpu_torch.scripts.ranks import join_group

        _DEVICE = "cpu"
        # [mode, rank, world, store, outdir], as _rank_smoke passes them.
        rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
        join_group("cpu", rank, world, store)
        try:
            return 1 if _RANK_MODES[argv[0]](rank, world, out) else 0
        finally:
            td.shutdown()

    dev = _take_device(argv)
    if dev is False:
        print(_USAGE, file=sys.stderr)
        return 2
    if dev is not None:
        _DEVICE = dev

    if "--hlo" in argv:
        return _rank_smoke("--_hlo-rank", "hlo smoke")
    if "--chaos-multihost" in argv:
        return _rank_smoke("--_chaos-multihost-rank", "chaos-multihost smoke")
    for mode, smoke in _SMOKES.items():
        if mode in argv:
            if mode == "--static":
                print("--- static smoke: liveness prediction vs instrument='memory'")
            return 1 if smoke() else 0

    if "--events" in argv:
        i = argv.index("--events")
        paths = []
        for a in argv[i + 1:]:
            if a.startswith("--"):
                break
            paths.append(a)
        storm = 4
        if "--storm-threshold" in argv:
            j = argv.index("--storm-threshold")
            try:
                storm = int(argv[j + 1])
            except (IndexError, ValueError):
                print(_USAGE, file=sys.stderr)
                return 2
        if not paths:
            print(_USAGE, file=sys.stderr)
            return 2
        try:
            return _replay(paths, storm)
        except OSError as e:
            print(f"lint_traces --events: cannot read {paths}: {e}", file=sys.stderr)
            return 2

    if any(a.startswith("--") for a in argv) or len(argv) > 1:
        print(_USAGE, file=sys.stderr)
        return 2
    pattern = argv[0] if argv else ""

    from thunder_tpu_torch.analysis import Severity, TraceVerificationError
    from thunder_tpu_torch.examine import lint

    n_errors = n_warnings = 0
    for name, fn, args in _programs():
        if pattern not in name:
            continue
        print(f"--- lint: {name}")
        # The torch executor claims every prim, which is what the pipeline's
        # verification needs; the kernel executors are the card's.
        diags = lint(fn, *args, executors=["torch"], verbose=False)
        errs = [d for d in diags if d.severity >= Severity.ERROR]
        warns = [d for d in diags if d.severity == Severity.WARNING]
        n_errors += len(errs)
        n_warnings += len(warns)
        for d in errs + warns:
            print(d.format())
        print(f"    {len(errs)} error(s), {len(warns)} warning(s)")

    for name, staged, args in _grad_workloads():
        if pattern not in name:
            continue
        print(f"--- verify (compiled, debug_checks=True): {name}")
        try:
            staged(*args)
            print("    all passes verified clean")
        except TraceVerificationError as e:
            n_errors += 1
            print(f"    FAILED: {e}")

    # The series gates, as the JAX CLI's unfiltered run ends.
    if not pattern:
        n_errors += _bench_history_gate("BENCH")
        n_errors += _bench_history_gate("MULTICHIP_BENCH")
        n_errors += _bench_history_gate("SOAK")
        n_errors += _bench_history_gate("SOAK_POD", min_rounds=1)
        n_errors += _bench_history_gate("ROOFLINE", min_rounds=1)
        n_errors += _bench_history_gate("CRITPATH", min_rounds=1)

    print(f"\nlint_traces: {n_errors} error(s), {n_warnings} warning(s)")
    return 1 if n_errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
