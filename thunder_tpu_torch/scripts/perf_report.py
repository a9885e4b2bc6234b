#!/usr/bin/env python
"""The benchmark series' regression gate, and the per-line attribution
report of a profile directory.

The counterpart of ``scripts/perf_report.py``. Two modes:

**History / regression gate**: the trajectory of one series of benchmark
rounds, each metric's delta between consecutive rounds flagged beyond a
threshold in its bad direction (times and counts: lower is better; MFU,
throughput, ratios against the baseline: higher is better), deltas under a
metric's noise floor ignored; the newest round's absolute invariants (the
ops plane of a soak round, the federation of a pod round, the per-op rows of
a roofline round, the critical path of a critpath round) checked too::

    python -m thunder_tpu_torch.scripts.perf_report --history H100_BENCH_r*.json
    python -m thunder_tpu_torch.scripts.perf_report --history H100_BENCH_r*.json --gate   # exit 1 on un-acked
    python -m thunder_tpu_torch.scripts.perf_report --history H100_SOAK_r*.json --gate --threshold 0.2

The port's series are its own: ``SERIES_PREFIX`` + the JAX series' names at
the root of the repo (``H100_BENCH_r*.json`` from ``scripts/bench.py``,
``H100_MULTICHIP_BENCH_r*.json`` from ``scripts/bench_multichip.py``,
``H100_SOAK_r*``, ``H100_SOAK_POD_r*``, ``H100_ROOFLINE_r*``,
``H100_CRITPATH_r*``), acknowledged regressions in ``H100_BENCH_ACK.json``
(``--ack`` to point elsewhere). :func:`series_paths` is the one glob; no
tool of the port reads a round of the JAX package's series. No round of
the port's series is committed yet.

**Attribution**: the measured device time of a ``torch.profiler`` trace
directory (``thunder_tpu_torch.profile()`` of a program generated with
``THUNDER_ANNOTATE_TRACES=1``, e.g. ``scripts/profile_train.py``'s) is
charged to trace lines, ``L<idx>.<sym>#<pass>`` rows, and the share of device
time attributed is printed. A CUDA graph's kernels are placed on their lines
by the launch-order map the profile wrote beside its trace
(``launch_map.json``). With ``--model`` the lines join the static cost model
(``analysis/cost.py``): the training step of ``benchmarks/train.py``, traced
on the CPU, each line beside its roofline bound. The step is the one
profiled, as ``meta.json`` records it (model, batch, seq, layers); a
``--model``, ``--batch`` or ``--seq`` that differs from it is refused (exit
2). A profile without ``meta.json`` joins at the flags (batch 2, seq 16,
the model's whole depth)::

    python -m thunder_tpu_torch.scripts.perf_report --trace-dir DIR [--steps N] [--top K]
    python -m thunder_tpu_torch.scripts.perf_report --trace-dir DIR --model open_llama_3b [--device h100]

``--steps`` defaults to the profile's own count (``meta.json``), else 1.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Optional

from thunder_tpu_torch.scripts.profile_train import LAUNCH_MAP, META, config_of

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# =============================================================================
# The port's series
# =============================================================================

# Every round the port writes, reads or gates is named SERIES_PREFIX + the
# JAX series' name, so that no glob of the port matches a JAX round.
SERIES_PREFIX = "H100_"
SERIES = ("BENCH", "MULTICHIP_BENCH", "SOAK", "SOAK_POD", "ROOFLINE", "CRITPATH")
ACK_FILE = SERIES_PREFIX + "BENCH_ACK.json"


def series_glob(series: str, root: Optional[str] = None) -> str:
    """The glob of the port's ``series`` (one of ``SERIES``) under ``root``
    (default: the repo's root)."""
    if series not in SERIES:
        raise ValueError(f"unknown series {series!r}; the port's are {SERIES}")
    return os.path.join(root or REPO, f"{SERIES_PREFIX}{series}_r*.json")


def series_paths(series: str, root: Optional[str] = None) -> list:
    """The rounds of the port's ``series``, oldest first."""
    return sorted(glob.glob(series_glob(series, root)))


# =============================================================================
# History / regression gate
# =============================================================================

# The direction and noise-floor tables are the JAX package's gate rules
# (``scripts/perf_report.py``), copied for parity: the same names and
# floors, series by series. The port's benchmark PR sets the card's own.
_HIGHER_SUBSTRINGS = ("mfu", "vs_baseline", "tokens_per_sec", "dots_passed",
                      "goodput", "achieved_frac", "coverage_pct")
_LOWER_SUFFIXES = ("_s", "_us", "_ms", "_pct", "_pct_static", "_seconds", "_ms_per_step")
_LOWER_EXACT = {"value", "recompile_count"}

_NOISE_FLOORS = (
    ("trace_claim_s", 1.0),
    ("xla_compile_s", 2.0),
    ("lookup_us", 5.0),
    ("dispatch_us", 20.0),
    ("overhead_pct", 0.5),
    ("exposed_pct", 5.0),
)
_MULTICHIP_NOISE_FLOORS = (
    ("value", 0.02),
    ("iter_s", 0.02),
    ("synced_s", 0.02),
    ("strict_sync_s", 0.02),
    ("mfu", 5e-4),
    ("tokens_per_sec", 4000.0),
    ("overhead_pct", 5.0),
    ("stall_ms_per_step", 3.0),
    ("exposed_pct_static", 2.0),
)
_SOAK_NOISE_FLOORS = (
    ("value", 800.0),
    ("tokens_per_sec", 800.0),
    ("goodput_ratio", 0.15),
    ("overhead_pct", 5.0),
    ("per_fault_s", 1.5),
    ("stall_ms_per_step", 3.0),
    ("wall_s", 60.0),
    ("_s", 60.0),
)
# Checked before the soak table ("soak_pod" starts with "soak").
_SOAK_POD_NOISE_FLOORS = (
    ("degraded_tokens_per_sec", 600.0),
    ("goodput_ratio", 0.05),
    ("shrink_latency_s", 0.05),
    ("regrow_to_full_s", 2.0),
)
_ROOFLINE_NOISE_FLOORS = (
    ("achieved_frac", 0.05),
    ("_us", 40.0),
    ("coverage_pct", 10.0),
    ("value", 0.2),
)
_CRITPATH_NOISE_FLOORS = (
    ("value", 5.0),
    ("exposed_pct", 5.0),
    ("_pct", 5.0),
    ("recovery_err_ms", 10.0),
    ("_ms", 10.0),
    ("_s", 60.0),
)
# (series prefix, its table), in the order they are tried.
_SERIES_FLOORS = (("multichip", _MULTICHIP_NOISE_FLOORS), ("soak_pod", _SOAK_POD_NOISE_FLOORS),
                  ("soak", _SOAK_NOISE_FLOORS), ("roofline", _ROOFLINE_NOISE_FLOORS),
                  ("critpath", _CRITPATH_NOISE_FLOORS))


def metric_direction(name: str, series: str = "") -> Optional[int]:
    """+1 = higher is better, -1 = lower is better, None = not gated.
    ``series`` (the round's headline ``metric`` name) resolves the fields
    whose direction follows the series: a soak round's ``value`` is goodput
    (up-good), every other series' ``value`` a time (down-good)."""
    low = name.lower()
    if series.lower().startswith("soak") and low == "value":
        return 1
    if any(s in low for s in _HIGHER_SUBSTRINGS):
        return 1
    if low in _LOWER_EXACT or low.endswith(_LOWER_SUFFIXES):
        return -1
    return None


def mfu_comparable(name: str, *rounds: dict) -> bool:
    """An MFU metric gates only when every round that reports it ran on a
    real device spec: against the ``cpu`` spec the peak is a made-up host
    number."""
    if "mfu" not in name.lower():
        return True
    return all(m.get("_device_spec") != "cpu" for m in rounds)


def noise_floor(name: str, series: str = "") -> float:
    """The least absolute delta of ``name`` that gates; ``series`` (the
    round's headline ``metric`` name) selects its series' table first."""
    low, ser = name.lower(), series.lower()
    for prefix, table in _SERIES_FLOORS:
        if ser.startswith(prefix):
            for suffix, floor in table:
                if low.endswith(suffix):
                    return floor
    for suffix, floor in _NOISE_FLOORS:
        if low.endswith(suffix):
            return floor
    return 0.0


# Headline fields whose meaning follows the round's "metric" name: compared
# only between rounds that benched the same thing.
_HEADLINE_KEYS = {"value", "vs_baseline", "tokens_per_sec", "mfu", "baseline_mfu_a100"}


def load_round(path: str) -> tuple[str, dict[str, float]]:
    """(round label, numeric metrics) of one round file: a wrapper
    ``{"n", "cmd", "rc", "tail", "parsed": {...}}`` or a bare JSON line of a
    bench script. The headline ``metric`` name is kept under
    ``_metric_name`` and ``device_spec`` under ``_device_spec``."""
    with open(path) as f:
        doc = json.load(f)
    metrics = doc.get("parsed", doc) if isinstance(doc, dict) else {}
    if not isinstance(metrics, dict):
        metrics = {}
    m = re.search(r"r(\d+)", os.path.basename(path))
    label = f"r{int(m.group(1)):02d}" if m else os.path.basename(path)
    out = {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float)) and not isinstance(v, bool)}
    if isinstance(metrics.get("metric"), str):
        out["_metric_name"] = metrics["metric"]  # type: ignore[assignment]
    if isinstance(metrics.get("device_spec"), str):
        out["_device_spec"] = metrics["device_spec"]  # type: ignore[assignment]
    return label, out


@dataclass
class Regression:
    metric: str
    frm: str
    to: str
    prev: float
    cur: float
    pct: float  # signed relative change
    acked: bool = False
    reason: str = ""

    @property
    def key(self) -> str:
        return f"{self.frm}->{self.to}:{self.metric}"

    def format(self) -> str:
        tag = "acked" if self.acked else "REGRESSION"
        note = f" ({self.reason})" if self.reason else ""
        return (f"{tag}: {self.metric} {self.prev:g} -> {self.cur:g} ({self.pct * 100:+.1f}%) over "
                f"{self.frm}->{self.to}{note}")


def load_ack(path: Optional[str]) -> dict[str, str]:
    """``{transition:metric -> reason}`` of an acknowledgement file."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    return {f"{e['transition']}:{e['metric']}": e.get("reason", "") for e in doc.get("acknowledged", [])}


def _gated(name: str, m0: dict, m1: dict, series: str) -> Optional[int]:
    """The direction ``name`` gates in between rounds ``m0`` and ``m1``, or
    None where it does not: no direction, a headline field of rounds that
    benched different things, or an MFU on the cpu spec."""
    direction = metric_direction(name, series)
    if direction is None:
        return None
    if name in _HEADLINE_KEYS and m0.get("_metric_name") != m1.get("_metric_name"):
        return None
    if not mfu_comparable(name, m0, m1):
        return None
    return direction


def analyze_history(rounds: list[tuple[str, dict[str, float]]], *, threshold: float = 0.10,
                    ack: Optional[dict[str, str]] = None) -> list[Regression]:
    """Regressions across every consecutive pair of rounds: a gated metric
    whose relative change passes ``threshold`` in its bad direction and
    whose absolute delta passes its noise floor."""
    ack = ack or {}
    out: list[Regression] = []
    for (l0, m0), (l1, m1) in zip(rounds, rounds[1:]):
        series = str(m0.get("_metric_name") or m1.get("_metric_name") or "")
        for name in sorted(set(m0) & set(m1)):
            direction = _gated(name, m0, m1, series)
            if direction is None:
                continue
            prev, cur = m0[name], m1[name]
            if prev == 0:
                continue
            pct = (cur - prev) / abs(prev)
            bad = pct > threshold if direction < 0 else pct < -threshold
            if not bad or abs(cur - prev) <= noise_floor(name, series):
                continue
            r = Regression(metric=name, frm=l0, to=l1, prev=prev, cur=cur, pct=pct)
            if r.key in ack:
                r.acked, r.reason = True, ack[r.key]
            out.append(r)
    return out


def compare_rounds(prev: dict[str, float], cur: dict[str, float], *,
                   threshold: float = 0.10) -> tuple[dict[str, float], list[str]]:
    """One transition, as ``scripts/bench.py`` compares its run with the
    newest round of its series: ``(deltas, regressions)``, each gated
    metric's signed relative change, and a line for each change beyond
    ``threshold`` in its bad direction (noise floors applied)."""
    series = str(prev.get("_metric_name") or cur.get("_metric_name") or "")
    deltas: dict[str, float] = {}
    regs: list[str] = []
    for name in sorted(set(prev) & set(cur)):
        direction = _gated(name, prev, cur, series)
        if direction is None:
            continue
        p, c = prev[name], cur[name]
        if not isinstance(p, (int, float)) or not isinstance(c, (int, float)) or p == 0:
            continue
        pct = (c - p) / abs(p)
        deltas[name] = round(pct, 4)
        bad = pct > threshold if direction < 0 else pct < -threshold
        if bad and abs(c - p) > noise_floor(name, series):
            regs.append(f"{name} {p:g} -> {c:g} ({pct * 100:+.1f}%)")
    return deltas, regs


def format_history(rounds: list[tuple[str, dict[str, float]]], regressions: list[Regression]) -> str:
    labels = [label for label, _ in rounds]
    series = str(next((m.get("_metric_name") for _, m in rounds if m.get("_metric_name")), ""))
    names = sorted({n for _, m in rounds for n in m if metric_direction(n, series) is not None})
    w = max((len(n) for n in names), default=10)
    lines = ["bench history: " + " -> ".join(labels), f"  {'metric':<{w}} " + " ".join(f"{l:>10}" for l in labels)]
    for n in names:
        cells = []
        for _, m in rounds:
            v = m.get(n)
            cells.append(f"{v:>10.4g}" if v is not None else f"{'-':>10}")
        arrow = {1: "^", -1: "v"}[metric_direction(n, series)]
        note = "" if mfu_comparable(n, *[m for _, m in rounds]) else " (cpu spec: not comparable, not gated)"
        lines.append(f"  {n:<{w}} " + " ".join(cells) + f"  [{arrow}]{note}")
    if regressions:
        lines.append("")
        lines.extend("  " + r.format() for r in regressions)
    else:
        lines.append("  no regressions beyond threshold")
    return "\n".join(lines)


def _invariant_failures(newest: tuple) -> list[str]:
    return _ops_plane_failures(newest) + _pod_failures(newest) + _roofline_failures(newest) + \
        _critpath_failures(newest)


def run_history_gate(paths: list[str], *, threshold: float = 0.10, ack_path: Optional[str] = None,
                     gate: bool = False, out=None) -> int:
    """Print the trajectory and its flags to ``out`` (default: stdout at
    the call); with ``gate``, 1 on an un-acknowledged regression or a failed
    invariant of the newest round, else 0. ``ack_path`` defaults to
    ``ACK_FILE`` at the repo's root."""
    out = out or sys.stdout
    rounds = [load_round(p) for p in sorted(paths)]
    rounds = [(label, m) for label, m in rounds if m]
    if not rounds:
        print("perf_report --history: no rounds with metrics", file=out)
        return 0
    if len(rounds) < 2:
        # Nothing to diff, but the newest round's absolute invariants gate
        # from the first round of a series.
        print("perf_report --history: need at least two rounds with metrics to diff; checking absolute "
              "invariants only", file=out)
        failures = _invariant_failures(rounds[-1])
        if failures:
            print("\nperf_report: acceptance failed on the newest round: " + ", ".join(failures), file=out)
        return 1 if (gate and failures) else 0
    if ack_path is None:
        ack_path = os.path.join(REPO, ACK_FILE)
    regs = analyze_history(rounds, threshold=threshold, ack=load_ack(ack_path))
    print(format_history(rounds, regs), file=out)
    fresh = [r for r in regs if not r.acked]
    if fresh:
        print(f"\nperf_report: {len(fresh)} un-acknowledged regression(s) (threshold {threshold * 100:.0f}%); "
              f"acknowledge deliberate ones in {os.path.basename(ack_path or ACK_FILE)}", file=out)
    failures = _invariant_failures(rounds[-1])
    if failures:
        print("\nperf_report: acceptance failed on the newest round: " + ", ".join(failures), file=out)
    return 1 if (gate and (fresh or failures)) else 0


def _ops_plane_failures(newest: tuple) -> list[str]:
    """The newest soak round's ops plane, pass/fail: every fault class with
    a streaming detector raised an anomaly, every timeout and halt left a
    schema-valid flight-recorder dump, the detection lead is positive.
    Rounds without the plane's keys are exempt."""
    label, m = newest
    if not str(m.get("_metric_name", "")).startswith("soak"):
        return []
    if "soak_undetected_detector_classes" not in m:
        return []
    out = []
    for key in ("soak_undetected_detector_classes", "soak_flightrec_invalid", "soak_flightrec_missing"):
        v = m.get(key)
        if v:
            out.append(f"{label}: {key}={v:g}")
    lead = m.get("soak_detection_lead")
    if lead is not None and lead <= 0:
        out.append(f"{label}: soak_detection_lead={lead:g} (need > 0: an anomaly must precede the decision "
                   f"citing it)")
    return out


def _pod_failures(newest: tuple) -> list[str]:
    """The newest pod round's federation, pass/fail: nothing unrecovered,
    unactuated, replayed in error or restarted; the fleet shrank through a
    degraded window and regrew to full width, as many regrows as shrinks;
    every slice-loss restore from the peer tier and no disk restore after
    the anchor; a flap's re-failure edge and a slow slice's spread anomaly
    where the schedule held them."""
    label, m = newest
    if not str(m.get("_metric_name", "")).startswith("soak_pod"):
        return []
    out = []
    for key in ("soak_pod_unrecovered", "soak_pod_unactuated", "soak_pod_replay_errors", "soak_pod_restarts",
                "soak_pod_slice_loss_nonpeer_restores", "soak_pod_disk_restores_after_anchor"):
        v = m.get(key)
        if v:
            out.append(f"{label}: {key}={v:g}")
    full, final = m.get("soak_pod_full_width"), m.get("soak_pod_final_width")
    if full is not None and final != full:
        out.append(f"{label}: final_width={final:g} != full_width={full:g} (fleet did not regrow)")
    if full is not None and not (m.get("soak_pod_min_width", full) < full and m.get("soak_pod_degraded_steps", 0) > 0):
        out.append(f"{label}: no degraded window (the soak never actually lost a slice)")
    shrinks, regrows = m.get("soak_pod_shrinks"), m.get("soak_pod_regrows")
    if shrinks is not None and not (shrinks == regrows and shrinks > 0):
        out.append(f"{label}: shrinks={shrinks:g} regrows={regrows:g} (need equal and > 0)")
    if not m.get("soak_pod_slice_loss_restores"):
        out.append(f"{label}: soak_pod_slice_loss_restores=0 (no peer-tier recovery was proven)")
    if m.get("soak_pod_flap_injected") and not m.get("soak_pod_flap_refailures"):
        out.append(f"{label}: flap injected but no cooldown->lost re-failure edge in the ledger")
    if m.get("soak_pod_slow_injected") and not m.get("soak_pod_slice_spread_anomalies"):
        out.append(f"{label}: slow slice injected but no slice_spread anomaly was raised")
    return out


def _critpath_failures(newest: tuple) -> list[str]:
    """The newest critpath round's ledger, pass/fail: at least 5 steps and
    5 nonzero time classes summing to ~1; the injected clock offsets
    recovered within 25 ms at confidence >= 0.5 and no outlier host; the
    straggler-wait on the seeded slow slice; a bottleneck_shift anomaly and
    a decision citing it; static and measured exposed shares within 10
    points."""
    label, m = newest
    if not str(m.get("_metric_name", "")).startswith("critpath"):
        return []
    out = []
    steps = m.get("critpath_steps", 0)
    if steps < 5:
        out.append(f"{label}: critpath_steps={steps:g} (need >= 5)")
    ncls = m.get("critpath_nonzero_classes", 0)
    if ncls < 5:
        out.append(f"{label}: critpath_nonzero_classes={ncls:g} (need >= 5 distinct time classes)")
    fsum = m.get("critpath_frac_sum")
    if fsum is not None and abs(fsum - 1.0) > 0.02:
        out.append(f"{label}: critpath_frac_sum={fsum:g} (breakdown must sum to ~1)")
    err = m.get("critpath_skew_recovery_err_ms")
    if err is None or not (err == err) or err > 25.0:
        out.append(f"{label}: critpath_skew_recovery_err_ms={err} (injected offsets not recovered within 25 ms)")
    conf = m.get("critpath_skew_min_confidence", 0.0)
    if conf < 0.5:
        out.append(f"{label}: critpath_skew_min_confidence={conf:g} (need >= 0.5)")
    if m.get("critpath_skew_outlier_hosts"):
        out.append(f"{label}: critpath_skew_outlier_hosts={m.get('critpath_skew_outlier_hosts'):g} (clean "
                   f"injected skews must not flag outliers)")
    if not m.get("critpath_straggler_host_match"):
        out.append(f"{label}: straggler-wait not attributed to the seeded slow slice")
    if not m.get("critpath_bottleneck_shift_anomalies"):
        out.append(f"{label}: no bottleneck_shift anomaly was raised")
    if not m.get("critpath_cited_decisions"):
        out.append(f"{label}: no autopilot decision cited bottleneck_shift")
    delta = m.get("critpath_delta_static_pct")
    if delta is None or abs(delta) > 10.0:
        out.append(f"{label}: critpath_delta_static_pct={delta} (static-vs-measured exposed pct disagree)")
    return out


def _roofline_failures(newest: tuple) -> list[str]:
    """The newest roofline round, pass/fail: at least 10 per-op rows, every
    row in ``observability/roofline.py``'s ``ROW_FIELDS`` (the round's
    ``roofline_schema_ok``), and at least 10 flattened
    ``op_*_achieved_frac`` keys for the per-op gate."""
    label, m = newest
    if not str(m.get("_metric_name", "")).startswith("roofline"):
        return []
    out = []
    rows = m.get("roofline_rows", 0)
    if rows < 10:
        out.append(f"{label}: roofline_rows={rows:g} (need >= 10 per-op rows)")
    if not m.get("roofline_schema_ok"):
        out.append(f"{label}: roofline_schema_ok={m.get('roofline_schema_ok', 0):g} (rows violate the ledger "
                   f"ROW_FIELDS schema)")
    n_flat = sum(1 for k in m if k.startswith("op_") and k.endswith("_achieved_frac"))
    if n_flat < 10:
        out.append(f"{label}: only {n_flat} flattened op_*_achieved_frac key(s) (need >= 10 for the per-op gate)")
    return out


# =============================================================================
# Attribution
# =============================================================================


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def model_costs(model: str, batch: int, seq: int, layers: Optional[int] = None, device: Optional[str] = None):
    """``{pass tag: TraceCost}`` of the training step of
    ``benchmarks/train.py`` for ``model`` at (batch, seq), cut to ``layers``:
    its forward and backward, traced and claimed on the CPU (the claims are
    those of the card) and priced on the ``device`` spec (default h100)."""
    os.environ["THUNDER_ANNOTATE_TRACES"] = "1"
    from thunder_tpu_torch.benchmarks.train import build_train
    from thunder_tpu_torch.observability.attribution import trace_costs

    tr = build_train(config_of(model, layers), batch, seq, device="cpu")
    return trace_costs([tr.fw_trace, tr.bw_trace], device or "h100")


def join_shape(meta: dict, model: str, batch: Optional[int] = None, seq: Optional[int] = None) -> tuple:
    """``(model, batch, seq, layers)`` of the cost join: the profiled step's,
    from its ``meta.json``, where a flag given beside it must agree; without
    one, the flags (batch 2, seq 16, every layer). Raises ``ValueError`` on
    a flag that differs from the profile."""
    if not meta:
        return model, batch or 2, seq or 16, None
    given = {"model": model, "batch": batch, "seq": seq}
    differ = {k: (v, meta[k]) for k, v in given.items() if v is not None and v != meta[k]}
    if differ:
        raise ValueError("the cost join must price the step profiled; meta.json has "
                         + ", ".join(f"{k}={m!r} where the flags give {v!r}" for k, (v, m) in differ.items()))
    return meta["model"], meta["batch"], meta["seq"], meta["layers"]


def attribution_of(trace_dir: str, *, steps: Optional[int] = None, model: Optional[str] = None,
                   batch: Optional[int] = None, seq: Optional[int] = None, device: Optional[str] = None):
    """The ``PerfJoin`` of the profile at ``trace_dir``: attributed per
    line, a graph's kernels placed by the directory's launch-order map,
    joined with the cost of the profiled step when ``model`` is given
    (:func:`join_shape`)."""
    from thunder_tpu_torch.observability.attribution import attribute, join_cost_attribution

    meta_path, map_path = os.path.join(trace_dir, META), os.path.join(trace_dir, LAUNCH_MAP)
    meta = _read_json(meta_path) if os.path.isfile(meta_path) else {}
    shape = join_shape(meta, model, batch, seq) if model else None
    lmap = [tuple(x) for x in _read_json(map_path)] if os.path.isfile(map_path) else None
    attr = attribute(trace_dir, launch_map=lmap)
    cost = model_costs(*shape, device) if shape else None
    return join_cost_attribution(attr, cost, steps=steps or meta.get("steps") or 1)


def run_attribution(trace_dir: str, *, steps: Optional[int] = None, top_k: int = 10, model: Optional[str] = None,
                    batch: Optional[int] = None, seq: Optional[int] = None, device: Optional[str] = None,
                    out=None) -> int:
    out = out or sys.stdout
    try:
        join = attribution_of(trace_dir, steps=steps, model=model, batch=batch, seq=seq, device=device)
    except (FileNotFoundError, ValueError) as e:
        print(f"perf_report: {e}", file=sys.stderr)
        return 2
    attr = join.attribution
    print(join.format(top_k), file=out)
    print(f"\nperf_report: {attr.coverage * 100:.1f}% of device time attributed to {len(attr.by_line)} trace lines"
          + (f"; graph kernels {attr.graph_placed} of {attr.graph_ops} placed" if attr.graph_ops else ""),
          file=out)
    if attr.coverage < 0.9 and attr.device_busy_us:
        print("perf_report: profile a program generated with THUNDER_ANNOTATE_TRACES=1, and a staged step with "
              "its launch-order map", file=out)
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="perf_report", description="Benchmark-series regression gate and profile "
                                                                "attribution reports")
    p.add_argument("--history", nargs="+", metavar="ROUND.json",
                   help=f"rounds of one of the port's series to diff ({SERIES_PREFIX}BENCH_r*.json, ...)")
    p.add_argument("--threshold", type=float, default=0.10, help="relative regression threshold (default 0.10)")
    p.add_argument("--ack", default=None, help=f"acknowledgement file (default: {ACK_FILE} at the repo's root)")
    p.add_argument("--gate", action="store_true", help="exit 1 on un-acknowledged regressions (CI mode)")
    p.add_argument("--trace-dir", default=None, help="profile dir (or one Chrome-trace JSON) to attribute")
    p.add_argument("--steps", type=int, default=None, help="steps the profile bracketed (default: meta.json's, else 1)")
    p.add_argument("--top", type=int, default=10, help="rows in the top-k table")
    p.add_argument("--device", default=None, help="device spec of the cost model (default h100)")
    p.add_argument("--model", default=None, help="GPT config name to build the cost model from (e.g. gpt-tiny)")
    p.add_argument("--batch", type=int, default=None, help="default: meta.json's, else 2")
    p.add_argument("--seq", type=int, default=None, help="default: meta.json's, else 16")
    args = p.parse_args(argv)

    if args.history:
        return run_history_gate(args.history, threshold=args.threshold, ack_path=args.ack, gate=args.gate)
    if args.trace_dir:
        return run_attribution(args.trace_dir, steps=args.steps, top_k=args.top, model=args.model,
                               batch=args.batch, seq=args.seq, device=args.device)
    p.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
