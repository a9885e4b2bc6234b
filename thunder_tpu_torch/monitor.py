"""``thunder_tpu_torch.monitor``: the operator-facing metrics facade.

The counterpart of ``thunder_tpu/monitor.py``. Flip metrics on, read a
snapshot, scrape Prometheus text, dump JSON, point the event log somewhere,
and read the measured-against-predicted report of a profile:

    import thunder_tpu_torch.monitor as monitor

    monitor.enable()                  # or THUNDER_TPU_METRICS=1
    ... serve traffic ...
    monitor.report()                  # nested dict snapshot
    monitor.prometheus_text()         # text exposition for a /metrics endpoint
    monitor.dump_json("metrics.json")

``configure_watchdog`` arms the collective watchdog and
``last_host_health`` reads the straggler record it names. Not yet here:
``serve``/``ops_health``/``ops_state``/``flight_dump`` and
``shutdown_ops`` (the ops plane, with the fleet layer).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from thunder_tpu_torch.observability.metrics import (  # noqa: F401
    REGISTRY,
    MetricsRegistry,
    disable,
    enable,
    enabled,
)


def _host_labels() -> dict:
    """``{"host", "pid"}`` of this process: the writer identity the event
    log stamps, reused as the metrics host/process dimension."""
    from thunder_tpu_torch.observability.events import host_identity

    ident = host_identity()
    return {"host": str(ident["host"]), "pid": str(ident["pid"])}


def report(include_host: bool = False) -> dict:
    """Full snapshot of every registered metric (histograms summarized).
    ``include_host=True`` adds the writer identity under ``"host_identity"``."""
    out = REGISTRY.report()
    if include_host:
        out["host_identity"] = _host_labels()
    return out


def report_compact() -> dict:
    """Flat {metric+labels: value} snapshot with empty series dropped."""
    return REGISTRY.report_compact()


def prometheus_text(include_host: bool = False) -> str:
    """Prometheus text exposition format. ``include_host=True`` stamps
    ``host=``/``pid=`` labels onto every series."""
    return REGISTRY.prometheus_text(extra_labels=_host_labels() if include_host else None)


def host_health(source, *, spread_threshold: float = 1.5):
    """Cross-host health over merged per-host event logs
    (``analysis.events.host_health``): ``(summary, diagnostics)``."""
    from thunder_tpu_torch.analysis.events import host_health as _hh

    return _hh(source, spread_threshold=spread_threshold)


def configure_watchdog(timeout_s) -> None:
    """Arm (None disarms) the collective watchdog process-wide: the
    programmatic spelling of ``THUNDER_TPU_COLLECTIVE_TIMEOUT_S``. A
    dispatch holding collectives that exceeds the timeout raises a typed
    ``CollectiveTimeoutError`` naming the pending collective trace lines and
    the suspected host (from the last :func:`host_health` summary) instead
    of hanging forever (thunder_tpu/monitor.py:120-130)."""
    from thunder_tpu_torch.resilience import watchdog

    watchdog.configure(timeout_s)


def last_host_health():
    """The most recent :func:`host_health` summary this process computed:
    the straggler record the collective watchdog joins its timeout errors
    against. None until ``host_health`` has run."""
    from thunder_tpu_torch.resilience import watchdog

    return watchdog.last_host_health()


def dump_json(path: str) -> None:
    """Write the full snapshot (with a timestamp) as JSON to ``path``."""
    REGISTRY.dump_json(path)


def reset() -> None:
    """Zero every metric (definitions stay). Tests and epoch boundaries."""
    REGISTRY.reset()


def set_event_log(path: Optional[str]) -> None:
    """Point the process-wide JSONL event log at ``path`` (None disables):
    the programmatic spelling of ``THUNDER_TPU_EVENTS``."""
    from thunder_tpu_torch.observability.events import set_global_path

    set_global_path(path)


def attribution_report(
    trace_dir: str,
    *,
    jfn=None,
    trace=None,
    traces: Optional[Sequence] = None,
    device: Any = None,
    steps: int = 1,
    launch_map: Optional[list] = None,
):
    """The roofline report over a profile directory: measured per-line
    device time (``observability/attribution.py``) joined with the static
    cost model (``analysis/cost.py``).

    ``trace_dir`` is a ``thunder_tpu_torch.profile()`` output dir; profile a
    program generated with ``THUNDER_ANNOTATE_TRACES=1`` so its lines run in
    named ranges, and pass ``launch_map`` (``attribution.scope_map_of``) for a
    staged step. Pass ``jfn`` (a compiled function), ``trace`` (its
    execution trace) or ``traces`` (the traces one step runs, e.g. a split
    step's forward and backward) to add each line's predicted bound;
    ``device`` is the cost model's spec (default: the local card's);
    ``steps`` is how many steps the profile bracketed. Returns a
    ``PerfJoin``; ``print(report)`` or ``report.format(top_k)`` renders it."""
    from thunder_tpu_torch.observability.attribution import attribute, join_cost_attribution, trace_costs

    if traces is None and trace is None and jfn is not None:
        cs = getattr(jfn, "_lc_cs", None)
        if cs is not None and getattr(cs, "last_traces", None):
            trace = cs.last_traces[-1]
    if traces is None and trace is not None:
        traces = [trace]
    cost = trace_costs(traces, device) if traces else None
    return join_cost_attribution(attribute(trace_dir, launch_map=launch_map), cost, steps=steps)


def roofline(jfn=None, *, every: Optional[int] = None, **options):
    """Arm the continuous roofline ledger: install a process-wide
    duty-cycled sampler that, every ``every`` steps, runs one step under
    the profiler bracket, joins measured per-line time with the static cost
    model and folds the result into the bounded per-op ledger.

        sampler = monitor.roofline(jfn, every=200)
        for batch in data:
            loss = sampler.maybe_sample(jfn, params, batch)

    ``every=None`` reads ``THUNDER_TPU_ROOFLINE_EVERY`` (unset/0 = never
    probes). ``options`` forward to ``observability.roofline.enable``
    (``device``, ``traces``, ``eager``, ``ledger``, ``bank``)."""
    from thunder_tpu_torch.observability import roofline as roofline_mod

    return roofline_mod.enable(jfn, every=every, **options)


def roofline_report(top_k: int = 10) -> Optional[str]:
    """The live roofline ledger as a printable table (None when no sampler
    is installed)."""
    from thunder_tpu_torch.observability import roofline as roofline_mod

    sampler = roofline_mod.current()
    return sampler.ledger.format(top_k) if sampler is not None else None


def shutdown_roofline() -> None:
    """Uninstall the process-wide roofline sampler."""
    from thunder_tpu_torch.observability import roofline as roofline_mod

    roofline_mod.disable()


def critpath(**options):
    """Arm the fleet critical-path timeline recorder: per-step host spans
    fold into a skew-aligned fleet timeline whose critical path decomposes
    into typed classes (compute / exposed-ICI / exposed-DCN /
    straggler-wait / stall / idle), exported as
    ``thunder_tpu_critpath_fraction{class=}`` gauges and streamed into the
    detectors as ``bottleneck_shift`` anomalies. A driver feeds the
    returned recorder (``record_step``, ``note_collective``); ``options``
    forward to ``observability.timeline.enable`` (bank, emulated_skew_s,
    ...)."""
    from thunder_tpu_torch.observability import timeline as timeline_mod

    return timeline_mod.enable(**options)


def critpath_report() -> Optional[str]:
    """The live fleet critical-path ledger as a printable report (EWMA
    class fractions and trend, per-host clock-skew estimates with
    confidence, the static-vs-measured exposed-collective cross-check).
    None when no timeline recorder is installed."""
    from thunder_tpu_torch.observability import timeline as timeline_mod

    recorder = timeline_mod.current()
    return recorder.format_report() if recorder is not None else None


def shutdown_critpath() -> None:
    """Uninstall the process-wide timeline recorder."""
    from thunder_tpu_torch.observability import timeline as timeline_mod

    timeline_mod.disable()
