#!/usr/bin/env python
"""The benchmark driver: one JSON line.

The counterpart of ``bench.py``. Its workload is the reference's
single-device training benchmark: open_llama_3b, bf16-true,
SGD(lr=6e-4, wd=0.1, no momentum), B=2 x T=2048, 45 timed iterations
(``benchmarks/train.py``'s step, staged whole as one CUDA graph on the
card), then the forward-only pass at B=10 x T=2048 (5 runs). Beside them:
the dispatch path's recompiles and warm lookup under bucketed symbolic
caching, the observability layer's and the ops plane's cost a call, the
forward's device time attributed to its trace lines and joined with the
cost model (``observability/attribution.py``), and the deltas against the
newest round of the port's own ``H100_BENCH`` series
(``scripts/perf_report.py``; ``vs_rev: null`` and no deltas when there is
none).

``vs_baseline`` is the reference Thunder's time on an A100-40GB over ours
(BASELINE.md: 21.9 s for 45 iterations, 0.4867 s an iteration; its forward
1.27 s), as in ``bench.py``. MFU is 6·N FLOP a trained token (2·N a
forward token) over the iteration at the DeviceSpec's bf16 peak
(``analysis/cost.py``: 989 TFLOP/s on the H100), N the model's params.

Three timing protocols for the step, all reported: ``async`` (the
iterations back to back, one sync at the end), ``synced`` (every loss read
on the host as a float, the read of loss i-1 overlapped with iteration i:
its copy to pinned memory waits on an event, not on the stream) and
``strict`` (a synchronize after every step).

The JSON line has every key of ``bench.py``'s line, and ``device_spec``.
Keys that name an XLA phase keep their names, so the schemas stay one; the
port's seat of each:

- ``fwd_xla_compile_s``, ``train_xla_compile_s``: the staged program's
  first two calls, each ending in a synchronize: the eager warm-up and the
  CUDA-graph capture with its first replay (the JAX number is the compile
  and the first run);
- ``train_compile_phases``: ``staging_s`` is the stage's first-call
  seconds (``StagingStats.first_call_s + capture_s``);
  ``xla_backend_compile_s`` the capture's (``capture_s``);
  ``persistent_cache_get_s``, ``_hits``, ``_misses`` the kernel library's
  build directory (``executors/_build.py``: the seconds ``build()`` took,
  a hit when it found the library built); ``comm_schedule_moves`` the comm
  scheduler's moves over the claimed forward and backward (0: one device
  has no collective);
- ``train_trace_claim_s``: ``build_train``'s trace, autodiff, residuals,
  remat and claim seconds.

Usage::

    python -m thunder_tpu_torch.scripts.bench                         # the card, bench.py's workload
    python -m thunder_tpu_torch.scripts.bench --model gpt-tiny --layers 2 --seq 64 --iters 3 --device cpu
    python -m thunder_tpu_torch.scripts.bench --roofline-out R.json [--model gpt-tiny] [--every 2] [--probes 3]

``--roofline-out`` runs only the light roofline bench: a duty-cycled
``RooflineSampler`` on a jitted forward, its folded ledger written as a
round of the port's ``ROOFLINE`` series; ``THUNDER_TPU_ROOFLINE_OUT`` makes
the full bench write its forward's ledger as one. ``--out`` also writes the
JSON line to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time
from typing import Optional

import numpy as np

REF_TRAIN_ITER_A100_S = 21.9 / 45  # the reference Thunder, open_llama_3b, A100-40GB (BASELINE.md)
REF_FWD_A100_S = 1.27  # its B=10 forward on the same card (BASELINE.md)
REF_PEAK_A100_TFLOPS = 312.0  # A100 dense bf16
TRAIN_B, TRAIN_T = 2, 2048
FWD_B = 10
FWD_RUNS = 5
ITERS = 45
ROOFLINE_ENV = "THUNDER_TPU_ROOFLINE_OUT"
ANNOTATE_ENV = "THUNDER_ANNOTATE_TRACES"

# The keys of bench.py's JSON line (``prev_round`` beside them when there is
# a round to compare with), and of its ``train_compile_phases``.
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "train_synced_mfu_vs_ref_mfu", "train_mfu_vs_ref_mfu",
    "ref_train_mfu_a100", "train_45iters_s", "train_tokens_per_sec", "train_mfu", "train_synced_mfu",
    "timing_protocol", "ref_timing_protocol", "train_iter_synced_s", "train_iter_strict_sync_s", "fwd_b10_s",
    "fwd_vs_baseline", "fwd_mfu", "fwd_trace_claim_s", "fwd_xla_compile_s", "train_trace_claim_s",
    "train_xla_compile_s", "train_compile_phases", "recompile_count", "trace_cache_lookup_us",
    "obs_gpt_block_dispatch_us", "obs_disabled_overhead_pct", "obs_metrics_overhead_pct", "ops_overhead_pct",
    "ops_off_overhead_pct", "attribution", "metrics", "vs_rev", "deltas_vs_prev", "regressions_vs_prev",
)
COMPILE_PHASE_KEYS = (
    "trace_claim_s", "static_analysis_s", "predicted_peak_bytes", "comm_schedule_moves", "staging_s",
    "xla_backend_compile_s", "persistent_cache_get_s", "persistent_cache_hits", "persistent_cache_misses",
)


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def annotated():
    """Within the block, programs are generated with each line in its
    profiler range (``THUNDER_ANNOTATE_TRACES=1`` unless the caller set it),
    which the attribution of a profile reads; the variable is as it was
    after."""
    was = os.environ.get(ANNOTATE_ENV)
    os.environ.setdefault(ANNOTATE_ENV, "1")
    try:
        yield
    finally:
        if was is None:
            os.environ.pop(ANNOTATE_ENV, None)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def protocol_iters(iters: int) -> tuple[int, int]:
    """(synced, strict) iterations beside ``iters`` async ones: bench.py's
    20 and 10 at 45, in proportion below."""
    return max(2, round(iters * 20 / 45)), max(2, round(iters * 10 / 45))


def _kernel_cache(dev) -> dict:
    """The persistent-cache phase's seat: the kernel library's build
    directory. None of it on the CPU, which launches no kernel."""
    if dev.type != "cuda":
        return {"persistent_cache_get_s": 0.0, "persistent_cache_hits": 0, "persistent_cache_misses": 0}
    from thunder_tpu_torch.executors import _build

    t0 = time.perf_counter()
    info = _build.build()
    return {"persistent_cache_get_s": round(time.perf_counter() - t0, 2),
            "persistent_cache_hits": int(info.seconds == 0.0), "persistent_cache_misses": int(info.seconds > 0.0)}


# =============================================================================
# The forward
# =============================================================================


def build_forward(cfg, batch: int, seq: int, dev):
    """``gpt.forward`` of ``cfg`` at (batch, seq), traced, claimed with the
    default executors and staged: ``(staged, eager, flat_args, init_s,
    trace_s, extrace)``."""
    import torch

    from thunder_tpu_torch import api
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.executors import staging
    from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.transforms.common import cse, dce

    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq))).to(dev)
    t0 = time.perf_counter()
    with devices.default_device(dev):
        _, comp = api.trace_program(lambda p, i: gpt.forward(p, i, cfg), (params, idx), {})
        extrace = del_last_used(transform_for_execution(cse(dce(comp)), api.DEFAULT_EXECUTORS))
    eager = extrace.python_callable()
    trace_s = time.perf_counter() - t0
    flat_args = [a for a in tree_flatten(((params, idx), {}))[0] if isinstance(a, torch.Tensor)]
    staged, _ = staging.stage(eager, [extrace], dev, name="forward")
    return staged, eager, flat_args, init_s, trace_s, extrace


def _bench_forward(cfg, seq: int, dev) -> dict:
    jfn, eager, flat_args, init_s, trace_s, extrace = build_forward(cfg, FWD_B, seq, dev)

    def run():
        return float(jfn(*flat_args)[0, 0, 0])

    t0 = time.perf_counter()
    run()  # the eager warm-up
    run()  # the capture and its first replay
    compile_s = time.perf_counter() - t0
    run()
    t0 = time.perf_counter()
    outs = [jfn(*flat_args) for _ in range(FWD_RUNS)]
    _sync(dev)
    avg = (time.perf_counter() - t0) / FWD_RUNS
    del outs
    _log(f"fwd param-init: {init_s:.1f}s trace+claim: {trace_s:.1f}s compile: {compile_s:.1f}s avg of {FWD_RUNS} "
         f"batched-dispatch runs: {avg:.4f}s")
    return dict(avg=avg, trace_s=trace_s, compile_s=compile_s, jfn=jfn, eager=eager, flat_args=flat_args,
                extrace=extrace, calls=3 + FWD_RUNS)


# =============================================================================
# The training step
# =============================================================================


def _static_analysis(traces) -> tuple[Optional[int], int]:
    """The liveness plan's peak over ``traces`` and each one's schedule
    certificate stamped; the comm scheduler's moves over them."""
    from thunder_tpu_torch.analysis import liveness, schedule
    from thunder_tpu_torch.transforms.comm_schedule import schedule_collectives

    peak = 0
    for trc in traces:
        peak = max(peak, liveness.plan_liveness(trc, include_rows=False).peak_bytes)
        schedule.stamp(trc)
    moves = 0
    for trc in traces:
        _, rep = schedule_collectives(trc)
        moves += rep.moves if rep is not None else 0
    return int(peak), moves


def _bench_train(cfg, batch: int, seq: int, iters: int, dev, params: Optional[dict] = None) -> dict:
    """The training step built (``params``: default ``gpt.init_params`` in
    bf16 from seed 0), staged and timed under the three protocols; its
    readings, the built step (``train``) and the steps it ran (``steps``)."""
    import torch

    from thunder_tpu_torch.benchmarks.train import build_train
    from thunder_tpu_torch.models import gpt

    t0 = time.perf_counter()
    if params is None:
        params = gpt.init_params(cfg, seed=0, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    tr = build_train(cfg, batch, seq, device=dev, params=params)
    trace_s = sum(tr.seconds.values())
    n_params = sum(p.numel() for p in tr.flat_params)

    t0 = time.perf_counter()
    predicted_peak, comm_moves = _static_analysis([tr.fw_trace, tr.bw_trace])
    static_s = time.perf_counter() - t0

    cache = _kernel_cache(dev)
    t0 = time.perf_counter()
    loss0 = float(tr.step())  # the eager warm-up
    float(tr.step())  # the capture and its first replay
    compile_s = time.perf_counter() - t0
    st = tr.staging
    phases = {
        "trace_claim_s": round(trace_s, 2),
        "static_analysis_s": round(static_s, 3),
        "predicted_peak_bytes": predicted_peak,
        "comm_schedule_moves": comm_moves,
        "staging_s": round(st.first_call_s + st.capture_s, 2),
        "xla_backend_compile_s": round(st.capture_s, 2),
        **cache,
    }
    _log(f"train compile phases: {phases}")

    t0 = time.perf_counter()
    for _ in range(iters):
        loss = tr.step()
    loss_last = float(loss)  # one sync at the end
    total = time.perf_counter() - t0
    avg = total / iters

    n_sync, n_strict = protocol_iters(iters)
    host_losses = []
    pinned = dev.type == "cuda"
    prev = None
    t0 = time.perf_counter()
    for _ in range(n_sync):
        loss = tr.step()
        if pinned:
            buf = torch.empty((), dtype=loss.dtype, pin_memory=True)
            buf.copy_(loss, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        if prev is not None:
            if pinned:
                prev[1].synchronize()
            host_losses.append(float(prev[0]))
        prev = (buf, ready) if pinned else (loss, None)
    if pinned:
        prev[1].synchronize()
    host_losses.append(float(prev[0]))
    synced_avg = (time.perf_counter() - t0) / n_sync
    if len(host_losses) != n_sync or not all(np.isfinite(x) for x in host_losses):
        raise RuntimeError(f"bench: the synced protocol read {host_losses}")

    t0 = time.perf_counter()
    for _ in range(n_strict):
        tr.step()
        _sync(dev)
    strict_avg = (time.perf_counter() - t0) / n_strict
    _log(f"train param-init: {init_s:.1f}s trace+claim: {trace_s:.1f}s compile: {compile_s:.1f}s {iters} iters: "
         f"{total:.2f}s avg iter: {avg:.4f}s (synced {synced_avg:.4f}s, strict {strict_avg:.4f}s) loss "
         f"{loss0:.3f}->{loss_last:.3f}")
    if not (np.isfinite(loss_last) and loss_last < loss0):
        raise RuntimeError(f"bench: the losses did not fall ({loss0} -> {loss_last})")
    return dict(avg=avg, synced=synced_avg, strict=strict_avg, total=total, trace_s=trace_s, compile_s=compile_s,
                phases=phases, n_params=n_params, loss0=loss0, loss_last=loss_last, train=tr,
                steps=2 + iters + n_sync + n_strict)


# =============================================================================
# The dispatch path and the observability layer
# =============================================================================


def _bench_cache(dev) -> tuple[int, float]:
    """Recompiles under bucketed symbolic caching over 8 batch sizes (one
    compile a pow2 bucket) and the warm O(1) lookup's µs."""
    import torch

    import thunder_tpu_torch as tt
    import thunder_tpu_torch.clang as clang

    def f(x):
        return clang.sum(clang.tanh(x))

    jf = tt.jit(f, cache="symbolic values", executors=["torch"], symbolic_dims={0: (0,)}, buckets={"batch": "pow2"},
                device=dev)
    xs = {b: torch.ones((b, 64), device=dev) for b in range(1, 9)}
    for x in xs.values():  # 8 batch sizes: one compile a pow2 bucket
        jf(x)
    for x in xs.values():  # the warm sweep learns every O(1) key
        jf(x)
    cs = tt.compile_stats(jf)
    n_warm = 200
    lookup_ns0 = cs.cache_lookup_ns
    for _ in range(n_warm):
        jf(xs[8])
    _sync(dev)
    lookup_us = (cs.cache_lookup_ns - lookup_ns0) / 1e3 / n_warm
    info = tt.cache_info(jf)
    _log(f"cache: {info['compiles']} compiles for 8 batch sizes, {info['fast_hits']} O(1) hits, warm lookup "
         f"{lookup_us:.1f}us")
    return info["recompiles"], lookup_us


def _min_ns(fn, n: int, repeats: int = 5) -> float:
    """The least ns a call of ``fn`` over ``repeats`` runs of ``n`` calls:
    load on the host only adds time."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e9)
    return best


def _bench_obs_overhead(dev) -> tuple:
    """The observability layer's cost a call against gpt-tiny's warm
    jitted forward, composed (an A/B wall-clock difference of a few µs
    drowns in the host's noise): the least µs a call of the forward, and
    the exact per-call work of the layer on the hit path (one ``enabled()``
    guard off; the guard, a counter and two histogram observations on), and
    of the ops plane (one event tap a step, on against off)."""
    import torch

    import thunder_tpu_torch as tt
    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.observability import events as obs_events
    from thunder_tpu_torch.observability import metrics as obsm
    from thunder_tpu_torch.observability import opsplane

    cfg = gpt.name_to_config("gpt-tiny")
    params = gpt.init_params(cfg, dtype=torch.float32, seed=0, device=dev)
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 64))).to(dev)
    jf = tt.jit(lambda p, i: gpt.forward(p, i, cfg), executors=["torch"], device=dev)

    def timed(n=100):
        t0 = time.perf_counter()
        for _ in range(n):
            jf(params, idx)
        _sync(dev)
        return (time.perf_counter() - t0) / n

    jf(params, idx)
    timed(20)  # warm the dispatch fast path (and the capture on the card)
    dispatch_us = min(timed() for _ in range(5)) * 1e6

    was_enabled = monitor.enabled()

    def block():
        if obsm.enabled():
            obsm.CACHE_HITS.inc(kind="fast")
            obsm.CACHE_LOOKUP_US.observe(12.0)
            obsm.DISPATCH_US.observe(120.0)

    monitor.disable()
    disabled_ns = _min_ns(block, 10_000)
    monitor.enable()
    enabled_ns = _min_ns(block, 10_000)
    # The synthetic samples must not pass for traffic in the line's snapshot.
    monitor.reset()
    (monitor.enable if was_enabled else monitor.disable)()

    def event():
        obs_events.emit_event("step_time", fn="ops_bench", step=0, s=0.01)

    saved_taps, saved_recorder = obs_events.ops_taps()
    obs_events.set_ops_taps((), recorder=None)
    ops_off_ns = _min_ns(event, 4_000)
    if saved_taps:
        obs_events.set_ops_taps(saved_taps, recorder=saved_recorder)
        ops_on_ns = _min_ns(event, 4_000)
    else:
        opsplane.enable(serve=False)
        ops_on_ns = _min_ns(event, 4_000)
        opsplane.disable()
    pct = lambda ns: ns / 1e3 / dispatch_us * 100.0  # noqa: E731
    _log(f"obs overhead: gpt-tiny warm dispatch {dispatch_us:.1f}us; obs code {disabled_ns:.0f}ns/call disabled "
         f"({pct(disabled_ns):.3f}%), {enabled_ns:.0f}ns/call metrics-on ({pct(enabled_ns):.3f}%); ops plane "
         f"{ops_off_ns:.0f}ns/event off ({pct(ops_off_ns):.4f}%), {ops_on_ns:.0f}ns/event on ({pct(ops_on_ns):.4f}%)")
    return dispatch_us, pct(disabled_ns), pct(enabled_ns), pct(ops_off_ns), pct(ops_on_ns)


# =============================================================================
# Attribution and the roofline round
# =============================================================================


def _bench_attribution(fwd: dict, dev, spec, steps: int = 2, top_k: int = 10) -> dict:
    """The forward's device time by trace line (two profiled calls of the
    staged forward, its graph's kernels placed by the eager program's
    launch-order map), joined with the cost model on ``spec``: ``{"coverage_pct",
    "top5", "topk", "_join"}``; ``_join`` is the live ``PerfJoin`` for the
    roofline round, popped before the line is printed."""
    from thunder_tpu_torch.analysis.cost import trace_cost
    from thunder_tpu_torch.observability.attribution import join_cost_attribution, scope_map_of
    from thunder_tpu_torch.observability.profile import profile

    args = fwd["flat_args"]
    lmap = scope_map_of(fwd["eager"], *args) if dev.type == "cuda" else None
    res = profile(fwd["jfn"], *args, steps=steps, warmup=0, launch_map=lmap)
    fwd["calls"] += steps + (lmap is not None)
    attr = res["attribution"]
    if attr is None:
        raise RuntimeError("bench: the forward's profile holds no L<idx>.<sym> range (THUNDER_ANNOTATE_TRACES "
                           "was not on when it was generated)")
    join = join_cost_attribution(attr, trace_cost(fwd["extrace"], spec), steps=steps)
    top5 = [{"line": ref.label, "sym": ref.sym, "pass": ref.pass_name, "us_per_step": round(us / steps, 1),
             "share_pct": round(us / attr.device_busy_us * 100.0, 1)} for ref, us in attr.top(5)]
    topk = [{"line": r.label, "sym": r.sym, "pass": r.pass_name, "us_per_step": round(r.measured_us, 1),
             "share_pct": round(r.share * 100.0, 1), "flops": r.flops, "bytes": r.bytes_moved,
             "roofline_us": round(r.roofline_us, 1) if r.roofline_us is not None else None,
             "achieved_frac": round(r.efficiency, 4) if r.efficiency is not None else None, "bound": r.bound}
            for r in join.rows[:top_k]]
    _log(f"fwd attribution (top 5 of {attr.device_busy_us / steps / 1e3:.1f} ms "
         f"{'device-busy' if attr.mode == 'cuda' else 'host op time'}/step, {attr.coverage * 100:.0f}% attributed):")
    for row in top5:
        _log(f"  {row['line']:<40} {row['us_per_step']:>9}us {row['share_pct']:>5}%")
    return {"coverage_pct": round(attr.coverage * 100.0, 1), "top5": top5, "topk": topk, "_join": join}


def _op_flat_key(label: str, taken: set) -> str:
    """``L154.exp#Delete_Last_Used`` -> ``op_L154_exp``: one op scope as a
    metric key stable across rounds (the pass dropped; a collision gets a
    numeric suffix)."""
    key = "op_" + re.sub(r"[^0-9A-Za-z]+", "_", label.split("#", 1)[0]).strip("_")
    base, n = key, 2
    while key in taken:
        key = f"{base}_{n}"
        n += 1
    taken.add(key)
    return key


def roofline_result(ledger, *, metric: str, device_spec, probes: int, coverage_pct, flat_top_k: int = 12) -> dict:
    """One round of the ``ROOFLINE`` series from a folded ledger: every row
    (``observability/roofline.py``'s ``ROW_FIELDS``) and the top rows'
    ``op_<line>_<sym>_us`` and ``_achieved_frac`` flattened to the top
    level, which ``perf_report``'s history gate compares."""
    from thunder_tpu_torch.observability.roofline import ROW_FIELDS

    rows = ledger.snapshot()["rows"]
    result = {
        "metric": metric,
        "value": round(sum(r["measured_us"] for r in rows) / 1e3, 4),
        "unit": "ms_device_busy_per_step",
        "device_spec": device_spec,
        "probes": probes,
        "roofline_rows": len(rows),
        "roofline_schema_ok": int(all(set(r) == set(ROW_FIELDS) for r in rows)),
        "roofline_coverage_pct": coverage_pct,
        "rows": rows,
    }
    taken: set = set()
    for r in rows[:flat_top_k]:
        key = _op_flat_key(r["label"], taken)
        result[f"{key}_us"] = r["measured_us"]
        if r["achieved_frac"] is not None:
            result[f"{key}_achieved_frac"] = r["achieved_frac"]
    return result


def _write_round(result: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")


def write_roofline_round(join, out_path: str, *, metric: str) -> dict:
    """Fold one ``PerfJoin`` into a fresh ledger and write it as a round of
    the ``ROOFLINE`` series."""
    from thunder_tpu_torch.observability.attribution import _costs
    from thunder_tpu_torch.observability.roofline import RooflineLedger

    ledger = RooflineLedger()
    ledger.fold(join)
    costs = _costs(join.cost)
    result = roofline_result(ledger, metric=metric, device_spec=costs[0].device.name if costs else None, probes=1,
                             coverage_pct=round(join.attribution.coverage * 100.0, 1))
    _write_round(result, out_path)
    _log(f"roofline round: {result['roofline_rows']} op rows ({result['value']:.3f} ms device-busy/step) -> "
         f"{out_path}")
    return result


# =============================================================================
# Deltas against the newest round of the port's series
# =============================================================================


def load_prev_round(root: Optional[str] = None) -> tuple:
    """(label, metrics) of the newest round of the port's ``BENCH`` series
    under ``root`` (default: the repo's root), or (None, None)."""
    from thunder_tpu_torch.scripts import perf_report

    paths = perf_report.series_paths("BENCH", root)
    return perf_report.load_round(paths[-1]) if paths else (None, None)


def add_deltas(result: dict, root: Optional[str] = None) -> dict:
    """``vs_rev``, ``deltas_vs_prev`` and ``regressions_vs_prev`` (and
    ``prev_round``) against the newest round of the series; the keys are
    always there: null and empty without a round."""
    from thunder_tpu_torch.scripts.perf_report import compare_rounds

    result.update(vs_rev=None, deltas_vs_prev={}, regressions_vs_prev=[])
    prev_label, prev = load_prev_round(root)
    if not prev:
        _log("no round of the port's BENCH series; deltas skipped (vs_rev=null)")
        return result
    deltas, regressions = compare_rounds(prev, dict(result, _metric_name=result["metric"]), threshold=0.10)
    result.update(prev_round=prev_label, vs_rev=prev_label, deltas_vs_prev=deltas, regressions_vs_prev=regressions)
    shown = sorted(deltas.items(), key=lambda kv: -abs(kv[1]))[:8]
    _log(f"deltas vs {prev_label}: " + ", ".join(f"{k} {v * 100:+.1f}%" for k, v in shown))
    for r in regressions:
        _log(f"WARNING: regression vs {prev_label}: {r}")
    return result


# =============================================================================
# The driver
# =============================================================================


def run(args, series_root: Optional[str] = None) -> dict:
    """The whole bench on ``args.device``; the JSON line's dict, with
    ``_train`` and ``_forward`` (the built programs, their readings and
    ``calls``: the training steps and forwards it ran) beside it for a
    caller in this process (``main`` drops them)."""
    with annotated():
        return _run(args, series_root)


def _run(args, series_root: Optional[str]) -> dict:
    import thunder_tpu_torch.monitor as monitor
    from thunder_tpu_torch.analysis.cost import resolve_device_spec
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.observability import metrics as obsm
    from thunder_tpu_torch.scripts.profile_train import config_of

    dev = devices.resolve_device(args.device)
    spec = resolve_device_spec(dev)
    cfg = config_of(args.model, args.layers)
    obs_dispatch_us, obs_disabled_pct, obs_metrics_pct, ops_off_pct, ops_pct = _bench_obs_overhead(dev)
    monitor.enable()  # on for the rest of the run: the line carries its snapshot
    recompile_count, lookup_us = _bench_cache(dev)
    fwd = _bench_forward(cfg, args.seq, dev)
    train = _bench_train(cfg, args.batch, args.seq, args.iters, dev)
    # Profiled last, after every compile-seconds reading.
    attribution = _bench_attribution(fwd, dev, spec)
    fwd_join = attribution.pop("_join")
    roofline_out = os.environ.get(ROOFLINE_ENV)
    if roofline_out:
        write_roofline_round(fwd_join, roofline_out, metric=f"roofline_{args.model.replace('-', '_')}_fwd")
    obsm.COMPILE_PHASE_S.observe(fwd["compile_s"], phase="bench_forward")
    obsm.COMPILE_PHASE_S.observe(train["compile_s"], phase="bench_train_step")

    peak = spec.peak_flops["bf16"] / 1e12
    n = train["n_params"]
    fwd_flops = 2.0 * n * FWD_B * args.seq
    train_flops = 6.0 * n * args.batch * args.seq
    avg, synced = train["avg"], train["synced"]
    train_mfu = train_flops / avg / 1e12 / peak
    synced_mfu = train_flops / synced / 1e12 / peak
    fwd_mfu = fwd_flops / fwd["avg"] / 1e12 / peak
    # The reference's training MFU on its A100, from the same FLOP model.
    ref_train_mfu = train_flops / REF_TRAIN_ITER_A100_S / 1e12 / REF_PEAK_A100_TFLOPS
    result = {
        "metric": f"{args.model}_train_iter_b{args.batch}_t{args.seq}" + (f"_l{cfg.n_layer}" if args.layers else ""),
        "value": round(avg, 4),
        "unit": "s",
        "vs_baseline": round(REF_TRAIN_ITER_A100_S / avg, 3),
        "train_synced_mfu_vs_ref_mfu": round(synced_mfu / ref_train_mfu, 3),
        "train_mfu_vs_ref_mfu": round(train_mfu / ref_train_mfu, 3),
        "ref_train_mfu_a100": round(ref_train_mfu, 3),
        "train_45iters_s": round(train["total"], 2),
        "train_tokens_per_sec": round(args.batch * args.seq / avg),
        "train_mfu": round(train_mfu, 3),
        "train_synced_mfu": round(synced_mfu, 3),
        "timing_protocol": f"async_{args.iters}iter_chain_single_sync",
        "ref_timing_protocol": "per_iter_loss_sync (reference train.py)",
        "train_iter_synced_s": round(synced, 4),
        "train_iter_strict_sync_s": round(train["strict"], 4),
        "fwd_b10_s": round(fwd["avg"], 4),
        "fwd_vs_baseline": round(REF_FWD_A100_S / fwd["avg"], 3),
        "fwd_mfu": round(fwd_mfu, 3),
        "fwd_trace_claim_s": round(fwd["trace_s"], 1),
        "fwd_xla_compile_s": round(fwd["compile_s"], 1),
        "train_trace_claim_s": round(train["trace_s"], 1),
        "train_xla_compile_s": round(train["compile_s"], 1),
        "train_compile_phases": train["phases"],
        "recompile_count": recompile_count,
        "trace_cache_lookup_us": round(lookup_us, 1),
        "obs_gpt_block_dispatch_us": round(obs_dispatch_us, 1),
        "obs_disabled_overhead_pct": round(obs_disabled_pct, 4),
        "obs_metrics_overhead_pct": round(obs_metrics_pct, 4),
        "ops_overhead_pct": round(ops_pct, 4),
        "ops_off_overhead_pct": round(ops_off_pct, 4),
        "attribution": attribution,
        "metrics": monitor.report_compact(),
        "device_spec": spec.name,
    }
    add_deltas(result, series_root)
    result["_train"], result["_forward"] = train, fwd
    return result


def roofline_main(argv: list) -> int:
    """``--roofline-out PATH [--model gpt-tiny] [--batch B] [--seq T]
    [--every N] [--probes K] [--device D]``: the light roofline bench. A
    duty-cycled ``RooflineSampler`` on a jitted forward runs ``every *
    probes`` steps, ``probes`` of them profiled, and its folded ledger is
    written as a round of the port's ``ROOFLINE`` series."""
    p = argparse.ArgumentParser(prog="bench --roofline-out")
    p.add_argument("--roofline-out", required=True)
    p.add_argument("--model", default="gpt-tiny")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--every", type=int, default=2)
    p.add_argument("--probes", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with annotated():
        return _roofline(args)


def _roofline(args) -> int:
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.models import gpt
    from thunder_tpu_torch.observability.roofline import RooflineSampler

    dev = devices.resolve_device(args.device)
    cfg = gpt.name_to_config(args.model)
    params = gpt.init_params(cfg, dtype=torch.float32, seed=0, device=dev)
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (args.batch, args.seq))).to(dev)
    jfn = tt.jit(lambda pr, i: gpt.forward(pr, i, cfg), executors=["torch"], device=dev)
    jfn(params, idx)  # compile outside the sampled loop
    sampler = RooflineSampler(jfn, every=args.every)
    for _ in range(args.every * args.probes):
        sampler.maybe_sample(jfn, params, idx)
    if sampler.probes != args.probes or len(sampler.ledger) == 0:
        _log(f"roofline bench failed: {sampler.probes}/{args.probes} probes, {len(sampler.ledger)} ledger ops")
        return 1
    costs = list(sampler._cost.values()) if isinstance(sampler._cost, dict) else [sampler._cost]
    coverage = round(sampler.last_coverage * 100.0, 1) if sampler.last_coverage is not None else None
    result = roofline_result(sampler.ledger, metric=f"roofline_{args.model.replace('-', '_')}_fwd",
                             device_spec=costs[0].device.name if costs and costs[0] is not None else None,
                             probes=sampler.probes, coverage_pct=coverage)
    _write_round(result, args.roofline_out)
    print(sampler.ledger.format(top_k=10), file=sys.stderr)
    _log(f"roofline round: {result['roofline_rows']} op rows -> {args.roofline_out}")
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}))
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="bench", description=__doc__.splitlines()[0])
    p.add_argument("--model", default="open_llama_3b")
    p.add_argument("--layers", type=int, default=None, help="cut the model to N layers (default: all)")
    p.add_argument("--batch", type=int, default=TRAIN_B, help="the training step's batch")
    p.add_argument("--seq", type=int, default=TRAIN_T)
    p.add_argument("--iters", type=int, default=ITERS, help="timed iterations of the async protocol")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=None, help="also write the JSON line here")
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--roofline-out" in argv:
        return roofline_main(argv)
    args = parse_args(argv)
    result = run(args)
    line = json.dumps({k: v for k, v in result.items() if not k.startswith("_")})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
