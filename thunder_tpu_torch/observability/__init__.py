"""Runtime observability: metrics registry, event log, instrumentation,
profiler bracketing and device-time attribution.

The counterpart of ``thunder_tpu/observability/``, built on ``torch.profiler``,
``record_function`` ranges and ``torch.cuda``'s memory statistics:

- :mod:`~thunder_tpu_torch.observability.metrics`: process-wide counters,
  gauges and histograms (dispatch latency, cache hits by kind, misses,
  compiles, per-pass ms, padding waste, executor claims), exported through
  ``thunder_tpu_torch.monitor``. ``THUNDER_TPU_METRICS=1`` or
  ``monitor.enable()`` turns them on.
- :mod:`~thunder_tpu_torch.observability.events`: the structured JSONL event
  log (compile brackets, passes, compile phases, cache misses, bucket
  selection, sharp edges, NaN-watch trips, profile brackets), gated by
  ``THUNDER_TPU_EVENTS=<path>`` or ``jit(events=...)``; replayed by
  ``thunder_tpu_torch.analysis.events``.
- :mod:`~thunder_tpu_torch.observability.instrument`: the per-op
  instrumentation transform, ``jit(fn, debug_watch="nan")`` and
  ``instrument="time"``/``"memory"``/custom hooks.
- :mod:`~thunder_tpu_torch.observability.profile`:
  ``thunder_tpu_torch.profile(fn, *args)``, steps under ``torch.profiler``,
  a Chrome trace in ``trace_dir``.
- :mod:`~thunder_tpu_torch.observability.attribution`: the trace's device
  kernels charged back to trace lines (``L<idx>.<sym>#<pass>`` scopes), a
  CUDA graph's replay through the launch-order map of its annotated eager
  run, and the join with ``analysis/cost.py``.
- :mod:`~thunder_tpu_torch.observability.roofline`: the duty-cycled sampler
  folding probe joins into a bounded per-op ledger.
- :mod:`~thunder_tpu_torch.observability.detect`: streaming detectors.

- :mod:`~thunder_tpu_torch.observability.timeline`: the fleet critical
  path (clock skew from collective barriers, per-step class breakdowns, the
  bounded ledger), armed by ``monitor.critpath()``.

- :mod:`~thunder_tpu_torch.observability.opsplane`: the live ops plane:
  the flight recorder and the HTTP endpoints (``/metrics``, ``/healthz``,
  ``/debug/state``, ``/debug/flightrec``), armed by ``monitor.serve()``.

``metrics``, ``events``, ``detect`` and ``timeline`` are stdlib-only (safe to import from
``core/trace.py`` and ``common.py``); the others load lazily here.
"""

from __future__ import annotations

from thunder_tpu_torch.observability import events, metrics  # noqa: F401
from thunder_tpu_torch.observability.events import EventLog, emit_event  # noqa: F401
from thunder_tpu_torch.observability.metrics import REGISTRY, MetricsRegistry  # noqa: F401

_LAZY = {
    "DetectorBank": "thunder_tpu_torch.observability.detect",
    "DetectorConfig": "thunder_tpu_torch.observability.detect",
    "HostHealthAccumulator": "thunder_tpu_torch.observability.detect",
    "BandDetector": "thunder_tpu_torch.observability.detect",
    "NaNWatcher": "thunder_tpu_torch.observability.instrument",
    "NaNWatchError": "thunder_tpu_torch.observability.instrument",
    "OpTimer": "thunder_tpu_torch.observability.instrument",
    "MemoryHighWater": "thunder_tpu_torch.observability.instrument",
    "InstrumentationHook": "thunder_tpu_torch.observability.instrument",
    "instrument_reports": "thunder_tpu_torch.observability.instrument",
    "profile": "thunder_tpu_torch.observability.profile",
    "Attribution": "thunder_tpu_torch.observability.attribution",
    "ScopeRef": "thunder_tpu_torch.observability.attribution",
    "attribute": "thunder_tpu_torch.observability.attribution",
    "parse_scope": "thunder_tpu_torch.observability.attribution",
    "scope_map_of": "thunder_tpu_torch.observability.attribution",
    "join_cost_attribution": "thunder_tpu_torch.observability.attribution",
    "RooflineSampler": "thunder_tpu_torch.observability.roofline",
    "RooflineLedger": "thunder_tpu_torch.observability.roofline",
    "RooflineEntry": "thunder_tpu_torch.observability.roofline",
    "FlightRecorder": "thunder_tpu_torch.observability.opsplane",
    "OpsServer": "thunder_tpu_torch.observability.opsplane",
    "TimelineRecorder": "thunder_tpu_torch.observability.timeline",
    "CritPathLedger": "thunder_tpu_torch.observability.timeline",
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    val = getattr(importlib.import_module(target), name)
    globals()[name] = val
    return val
