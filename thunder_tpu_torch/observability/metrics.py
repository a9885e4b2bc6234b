"""Low-overhead process-wide metrics registry.

The counterpart of ``thunder_tpu/observability/metrics.py``, a copy of its
stdlib-only code (the port imports nothing of the JAX package): counters,
gauges and histograms that the dispatch and compile paths update and
``thunder_tpu_torch.monitor.report()`` exports, as a nested dict, a JSON
dump, or Prometheus text.

- **Disabled must be free.** Every mutate method checks one module-level
  flag and returns; the dispatch hit path does all its metric work behind
  one ``enabled()`` check (``api._dispatch``).
- **No locks on the hot path.** CPython dict ops are atomic enough for
  monotonic counters; a torn read in ``report()`` costs one sample.
- **Process-wide, not per-function.** Per-function counters live on
  ``CompileStats`` (``thunder_tpu_torch.cache_info``); this registry
  aggregates across every compiled function.

The metric names are the JAX package's (``thunder_tpu_*``), so scrapes and
dashboards of both join; only the series this port emits are registered
(the autopilot and soak series and the ops plane's wait for the fleet
layer). Enable with
``THUNDER_TPU_METRICS=1`` or :func:`enable`.
"""

from __future__ import annotations

import json
import os
import time
from bisect import bisect_left
from typing import Any, Optional


_state = {
    "enabled": os.environ.get("THUNDER_TPU_METRICS", "").strip().lower()
    not in ("", "0", "false", "off")
}


def enable() -> None:
    _state["enabled"] = True


def disable() -> None:
    _state["enabled"] = False


def enabled() -> bool:
    return _state["enabled"]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items())) if labels else ()


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _escape_label_value(v: Any) -> str:
    """Prometheus text-exposition escaping for label values: backslash,
    double quote, and newline must be escaped or the scrape line is
    malformed (host/process labels carry hostnames — arbitrary strings)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str_prom(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"
    __slots__ = ("name", "help", "_values")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, Any] = {}

    def clear(self) -> None:
        self._values.clear()

    def series(self) -> dict[tuple, Any]:
        return dict(self._values)


class Counter(_Metric):
    """Monotonically increasing count (optionally labelled).

    ``always=True`` marks an *always-export* counter: its (unlabelled)
    series appears in ``prometheus_text`` as an explicit 0 even before the
    first increment and even with the metrics gate off — reserved for
    counters whose absence would hide a loss of observability itself (the
    event-log drop counter): a scrape-side alert on ``> 0`` only works if
    the 0 is on the wire to begin with."""

    kind = "counter"
    __slots__ = ("always",)

    def __init__(self, name: str, help: str = "", always: bool = False):
        super().__init__(name, help)
        self.always = bool(always)

    def inc(self, n: float = 1, **labels) -> None:
        if not _state["enabled"]:
            return
        k = tuple(sorted(labels.items())) if labels else ()
        self._values[k] = self._values.get(k, 0) + n

    def inc_always(self, n: float = 1, **labels) -> None:
        """Increment even with metrics disabled — reserved for counters
        whose silence would hide a loss of observability itself (e.g. the
        event-log drop counter): they must appear in ``monitor.report()``
        unconditionally."""
        k = tuple(sorted(labels.items())) if labels else ()
        self._values[k] = self._values.get(k, 0) + n

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Last-written value (optionally labelled); ``set_max`` keeps the peak."""

    kind = "gauge"
    __slots__ = ()

    def set(self, v: float, **labels) -> None:
        if not _state["enabled"]:
            return
        self._values[_label_key(labels)] = v

    def set_max(self, v: float, **labels) -> None:
        if not _state["enabled"]:
            return
        k = _label_key(labels)
        cur = self._values.get(k)
        if cur is None or v > cur:
            self._values[k] = v

    def value(self, **labels) -> Optional[float]:
        return self._values.get(_label_key(labels))


# Log-spaced default buckets: cover 1us..100s when observing microseconds.
_DEFAULT_BUCKETS = (1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8)


class Histogram(_Metric):
    """count/sum/min/max plus log-spaced bucket counts.

    Hot-path discipline: ``observe`` stores RAW per-bucket counts via one
    bisect (the last slot is the +Inf overflow); the Prometheus-style
    cumulative counts are derived at render time (``summary``/
    ``prometheus_text``), keeping the per-observation cost flat."""

    kind = "histogram"
    __slots__ = ("buckets",)

    def __init__(self, name: str, help: str = "", buckets: tuple = _DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(buckets)

    def observe(self, v: float, **labels) -> None:
        if not _state["enabled"]:
            return
        k = tuple(sorted(labels.items())) if labels else ()
        s = self._values.get(k)
        if s is None:
            s = self._values[k] = {
                "count": 0, "sum": 0.0, "min": v, "max": v,
                "raw_buckets": [0] * (len(self.buckets) + 1),
            }
            s["count"] = 1
            s["sum"] = v
            s["raw_buckets"][bisect_left(self.buckets, v)] = 1
            return
        s["count"] += 1
        s["sum"] += v
        if v < s["min"]:
            s["min"] = v
        elif v > s["max"]:
            s["max"] = v
        s["raw_buckets"][bisect_left(self.buckets, v)] += 1

    def _cumulative(self, raw: list) -> list:
        out = []
        acc = 0
        for c in raw[:-1]:  # last slot is the +Inf overflow
            acc += c
            out.append(acc)
        return out

    def summary(self, **labels) -> Optional[dict]:
        s = self._values.get(_label_key(labels))
        if s is None:
            return None
        out = {k: s[k] for k in ("count", "sum", "min", "max")}
        out["bucket_counts"] = self._cumulative(s["raw_buckets"])
        out["mean"] = s["sum"] / s["count"] if s["count"] else 0.0
        return out


class MetricsRegistry:
    """Name → metric, get-or-create. One process-wide instance (``REGISTRY``)
    plus constructible for tests."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, not {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "", always: bool = False) -> Counter:
        return self._get_or_create(Counter, name, help, always=always)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        """Clear every metric's values (definitions stay registered)."""
        for m in self._metrics.values():
            m.clear()

    # -- export ---------------------------------------------------------------

    def report(self) -> dict:
        """Nested snapshot: name -> {kind, help, values: {label_str: value}}.
        Histogram values are the count/sum/min/max/mean summaries."""
        out: dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            values: dict[str, Any] = {}
            for k in list(m._values):
                if isinstance(m, Histogram):
                    values[_label_str(k)] = m.summary(**dict(k))
                else:
                    values[_label_str(k)] = m._values.get(k)
            out[name] = {"kind": m.kind, "help": m.help, "values": values}
        return out

    def report_compact(self) -> dict:
        """Flat {name+labels: value} snapshot with empty series dropped —
        what a benchmark embeds in its JSON line."""
        out: dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            for k in list(m._values):
                if isinstance(m, Histogram):
                    s = m.summary(**dict(k))
                    if s:
                        out[f"{name}{_label_str(k)}"] = {
                            kk: s[kk] for kk in ("count", "sum", "mean", "min", "max")
                        }
                else:
                    out[f"{name}{_label_str(k)}"] = m._values.get(k)
        return out

    def prometheus_text(self, extra_labels: Optional[dict] = None) -> str:
        """Prometheus text exposition format (histograms as _bucket/_sum/_count).

        ``extra_labels`` are merged into every series: the host/process
        dimension for multi-host scrapes (``monitor.prometheus_text(
        include_host=True)`` passes ``{"host": ..., "pid": ...}``), so one
        aggregator can tell the writers of a fleet apart. Label values are
        escaped per the exposition format."""
        extra = dict(extra_labels) if extra_labels else {}
        lines: list[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if getattr(m, "always", False) and not m._values:
                # Always-export counters put their 0 on the wire so the
                # scrape side can alert on >0 even before anything went
                # wrong, and regardless of the metrics gate, as inc_always.
                lines.append(f"{name}{_label_str_prom(_label_key(extra))} 0")
            for k in list(m._values):
                base = dict(extra, **dict(k))
                lk = _label_str_prom(_label_key(base))
                if isinstance(m, Histogram):
                    s = m._values.get(k)
                    if s is None:
                        continue
                    for le, c in zip(m.buckets, m._cumulative(s["raw_buckets"])):
                        blk = _label_str_prom(_label_key(dict(base, le=repr(le))))
                        lines.append(f"{name}_bucket{blk} {c}")
                    blk = _label_str_prom(_label_key(dict(base, le="+Inf")))
                    lines.append(f"{name}_bucket{blk} {s['count']}")
                    lines.append(f"{name}_sum{lk} {s['sum']}")
                    lines.append(f"{name}_count{lk} {s['count']}")
                else:
                    lines.append(f"{name}{lk} {m._values.get(k)}")
        return "\n".join(lines) + "\n"

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"ts": time.time(), "metrics": self.report()}, f, indent=2, default=str)
            f.write("\n")


REGISTRY = MetricsRegistry()

# -- the framework's own metrics ----------------------------------------------
# Registered eagerly so report()/prometheus_text() list them (with empty
# series) even before traffic, and so hot paths share these handles instead
# of doing name lookups.

DISPATCH_US = REGISTRY.histogram(
    "thunder_tpu_dispatch_us",
    "Host-side dispatch wall time per compiled-function call (us), cache lookup through result",
)
CACHE_LOOKUP_US = REGISTRY.histogram(
    "thunder_tpu_cache_lookup_us", "Cache lookup (guard evaluation) time per call (us)"
)
CACHE_HITS = REGISTRY.counter(
    "thunder_tpu_cache_hits_total",
    "Cache hits across all compiled functions, labelled kind=fast|slow|same_input|module",
)
CACHE_MISSES = REGISTRY.counter(
    "thunder_tpu_cache_misses_total", "Cache misses (each triggers a compile)"
)
COMPILES = REGISTRY.counter(
    "thunder_tpu_compiles_total", "Trace compilations (acquisition through staging)"
)
RECOMPILES = REGISTRY.counter(
    "thunder_tpu_recompiles_total", "Compilations beyond a function's first: the storm signal"
)
COMPILE_MS = REGISTRY.histogram(
    "thunder_tpu_compile_ms", "End-to-end compile time per entry (ms)"
)
PASS_MS = REGISTRY.histogram(
    "thunder_tpu_pass_ms", "Per-transform-pass duration (ms), labelled by pass"
)
CLAIMED_BSYMS = REGISTRY.counter(
    "thunder_tpu_claimed_bsyms_total", "Executor-claim breakdown of execution traces, labelled by executor"
)
COLLECTIVE_BYTES = REGISTRY.counter(
    "thunder_tpu_collective_bytes_traced_total",
    "Bytes moved by collectives per traced program (static, from trace metadata)",
)
PADDING_WASTE_ELEMENTS = REGISTRY.counter(
    "thunder_tpu_padding_waste_elements_total",
    "Elements of bucket padding dispatched (padded minus true extents)",
)
BUCKET_COMPILES = REGISTRY.counter(
    "thunder_tpu_bucket_compiles_total", "Symbolic-values compiles, one per shape bucket"
)
SHARP_EDGES = REGISTRY.counter(
    "thunder_tpu_sharp_edges_total", "Sharp-edge observations during tracing"
)
NAN_WATCH_TRIPS = REGISTRY.counter(
    "thunder_tpu_nan_watch_trips_total", "NaN/Inf watch detections, labelled by symbol"
)
INSTRUMENTED_OP_US = REGISTRY.histogram(
    "thunder_tpu_instrumented_op_us", "Per-op wall time under the OpTimer hook (us), labelled by symbol"
)
DEVICE_MEM_HIGH_WATER = REGISTRY.gauge(
    "thunder_tpu_device_mem_high_water_bytes",
    "Peak device memory observed by the MemoryHighWater hook",
)
# The port's compile pipeline: trace/transforms/claim spans per compile,
# then the entry's first call (warmup: eager, as XLA compiles at an entry's
# first run) and, on the card, the CUDA-graph capture at its second.
COMPILE_PHASE_S = REGISTRY.histogram(
    "thunder_tpu_compile_phase_s",
    "Compile pipeline phase duration in seconds, labelled phase=trace|transforms|claim|warmup|capture",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0),
)
# Cross-host health (analysis/events.host_health over merged per-host logs).
HOST_STEP_TIME_S = REGISTRY.gauge(
    "thunder_tpu_host_step_time_s",
    "Mean training-step seconds per host from merged step_time events, labelled by host",
)
HOST_STEP_SPREAD = REGISTRY.gauge(
    "thunder_tpu_host_step_time_spread_ratio",
    "Slowest host mean step time over fleet median (straggler suspect when above threshold)",
)
# -- resilience (thunder_tpu_torch/resilience) ----------------------------------

FAULTS_INJECTED = REGISTRY.counter(
    "thunder_tpu_faults_injected_total",
    "Chaos-harness fault injections, labelled by seam",
)
EXECUTOR_DEMOTIONS = REGISTRY.counter(
    "thunder_tpu_executor_demotions_total",
    "Quarantined (sym, executor) pairs after kernel failures, labelled by executor",
)
COMPILE_DEOPTS = REGISTRY.counter(
    "thunder_tpu_compile_deopts_total",
    "Compile de-optimization ladder escalations, labelled by level",
)
NAN_GUARD_TRIPS = REGISTRY.counter(
    "thunder_tpu_nan_guard_trips_total",
    "Post-step isfinite guard trips (jit(on_nan=...))",
)
CHECKPOINT_RETRIES = REGISTRY.counter(
    "thunder_tpu_checkpoint_retries_total",
    "Checkpoint save attempts retried after transient I/O errors",
)
# Mesh-wide fault tolerance: the collective watchdog, elastic resume, and
# the SDC guard.
WATCHDOG_TIMEOUTS = REGISTRY.counter(
    "thunder_tpu_collective_watchdog_timeouts_total",
    "Guarded dispatches abandoned after the collective timeout, labelled by fn",
)
ELASTIC_RESUMES = REGISTRY.counter(
    "thunder_tpu_elastic_resumes_total",
    "Checkpoint restores resharded onto a different mesh shape",
)
SDC_SUSPECTS = REGISTRY.counter(
    "thunder_tpu_sdc_suspects_total",
    "Replica-checksum divergences (or loss spikes) flagged by the SDC guard",
)
SDC_RERUNS = REGISTRY.counter(
    "thunder_tpu_sdc_reruns_total",
    "Quarantined-step re-runs by the SDC guard, labelled ok=true|false",
)
WATCHDOG_UNGUARDED = REGISTRY.counter(
    "thunder_tpu_collective_watchdog_unguarded_total",
    "Guarded dispatches run UNguarded because the abandoned-worker cap "
    "(THUNDER_TPU_WATCHDOG_MAX_ABANDONED) was reached",
)
# Tiered checkpointing: the step-boundary snapshot stall (the only hot-path
# cost), the background writer's disk commits, and the restore-tier ladder.
SNAPSHOTS = REGISTRY.counter(
    "thunder_tpu_snapshots_total",
    "Step-boundary RAM snapshots taken (CheckpointManager.snapshot)",
)
CHECKPOINT_STALL_MS = REGISTRY.histogram(
    "thunder_tpu_checkpoint_stall_ms",
    "Milliseconds the training loop stalls per snapshot (device->host copy "
    "+ crc32; disk durability runs on the background writer)",
    buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0),
)
SNAPSHOT_FLUSHES = REGISTRY.counter(
    "thunder_tpu_snapshot_flushes_total",
    "Background/synchronous disk flushes of RAM snapshots, labelled "
    "ok=true|false",
)
RESTORES = REGISTRY.counter(
    "thunder_tpu_restores_total",
    "Tiered checkpoint restores, labelled by winning tier "
    "(local|peer|disk)",
)
# inc_always + always-export: a dropped event-log sink must be visible even
# with the metrics gate off.
EVENT_LOG_DROPPED = REGISTRY.counter(
    "thunder_tpu_event_log_dropped_total",
    "Event-log sinks disabled after I/O failure (each loses all later events)",
    always=True,
)
ANOMALIES = REGISTRY.counter(
    "thunder_tpu_anomalies_total",
    "Streaming-detector anomalies, labelled by kind "
    "(step_time_drift|goodput_drop|recompile_storm|host_spread)",
)
# Always-export. The JAX package counts ok="false" when its profiler plugin
# is missing and the bracket degrades to wall clock; the port never
# degrades on the card (a profiled CUDA call with no kernel events raises),
# so ok="false" counts only such raises.
PROFILE_CAPTURES = REGISTRY.counter(
    "thunder_tpu_profile_captures_total",
    "Profiler bracket attempts, labelled ok=true|false",
    always=True,
)
ROOFLINE_PROBES = REGISTRY.counter(
    "thunder_tpu_roofline_probes_total",
    "Duty-cycled roofline probes (one profiled step folded into the per-op ledger)",
    always=True,
)

# -- fleet critical-path ledger (observability/timeline.py) ---------------------

# Always-export: zero timeline steps with a run in flight means the recorder
# is dead or unarmed, visible on the wire with metrics off.
CRITPATH_STEPS = REGISTRY.counter(
    "thunder_tpu_critpath_steps_total",
    "Fleet steps folded into the critical-path ledger (observability/timeline.py)",
    always=True,
)
CRITPATH_FRACTION = REGISTRY.gauge(
    "thunder_tpu_critpath_fraction",
    "EWMA share of fleet step wall time on the critical path, labelled by "
    "class (compute|exposed_ici|exposed_dcn|straggler_wait|stall|idle)",
)
CRITPATH_SKEW_MS = REGISTRY.gauge(
    "thunder_tpu_critpath_clock_skew_ms",
    "Estimated per-host clock skew vs the fleet-median clock, from collective rendezvous alignment, labelled by host",
)
