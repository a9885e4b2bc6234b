"""Event-log replay: validate and analyze an observability JSONL log.

The counterpart of ``thunder_tpu/analysis/events.py``, the offline half of
the event pipeline (``observability/events.py`` writes, this module reads):
:func:`replay_events` replays a log captured under
``THUNDER_TPU_EVENTS``/``jit(events=...)`` and flags

- schema violations (unparseable lines, unknown kinds, missing fields,
  wrong schema version);
- **recompile storms**: one function compiling more than
  ``storm_threshold`` times for exact shapes, or one shape bucket compiled
  more than twice (one compile a bucket is the steady state of
  ``cache="symbolic values"``), or a module under ``seq_bucket`` past four
  times the threshold;
- unbalanced compile brackets (a ``compile_start`` whose ``compile_end``
  never arrived: a crash or exception mid-compile);
- **unrecovered faults**: a chaos ``fault_injected`` with no later recovery
  event of its seam (:data:`FAULT_RECOVERY_KINDS`); a failed save, re-run,
  flush or restore does not count as a recovery.

:func:`merge_event_logs` merges per-process logs; :func:`host_health`
summarizes per-host step times over ``detect.HostHealthAccumulator``.

- **unactuated decisions**: an ``autopilot_decision`` with no later
  recovery event of its actuator (:data:`DECISION_RECOVERY_KINDS`).

A ``flightrec_dump`` trailer (the last record of a flight-recorder dump)
satisfies both correlation rules for the faults and decisions before it:
the dump is a capture taken while their recovery was still in flight. The
summary also carries the checkpoint, snapshot and restore record: where
restores landed, how many fell through an invalid candidate, and the
snapshots' stall. Findings reuse
:class:`~thunder_tpu_torch.analysis.diagnostics.Diagnostic`.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from thunder_tpu_torch.analysis.diagnostics import Diagnostic, Severity

# kind -> required fields (the JAX package's, for the kinds the port writes).
SCHEMA: dict[str, frozenset] = {
    "cache_miss": frozenset({"fn", "call"}),
    "compile_start": frozenset({"compile_id", "fn", "cache_option", "call"}),
    "compile_end": frozenset({"compile_id", "fn", "ms", "n_bsyms"}),
    "pass": frozenset({"compile_id", "name", "ms", "n_bsyms", "trace"}),
    "bucket_select": frozenset({"compile_id", "buckets", "marks"}),
    "sharp_edge": frozenset({"message", "policy"}),
    "nan_watch": frozenset({"value_kind", "symbol", "bsym_index", "line", "provenance"}),
    "profile_start": frozenset({"dir", "steps"}),
    "profile_stop": frozenset({"steps", "total_s", "avg_s", "profiler"}),
    "compile_phase": frozenset({"compile_id", "phase", "s"}),
    "step_time": frozenset({"fn", "step", "s"}),
    "straggler_suspect": frozenset({"host", "mean_s", "ratio"}),
    "anomaly": frozenset({"anomaly", "severity", "value", "baseline"}),
    "roofline_probe": frozenset({"step", "ops", "probe_s"}),
    # The fleet timeline (observability/timeline.py): one rendezvous record
    # a collective completion (the clock-alignment anchor; in_slice_s and
    # cross_slice_s, when present, split its wire legs), and one
    # critical-path breakdown a step.
    "collective": frozenset({"fn", "cid", "s"}),
    "critpath_step": frozenset({"step", "total_s", "classes", "slowest_host"}),
    # The recovery layer (thunder_tpu_torch/resilience).
    "fault_injected": frozenset({"seam", "target", "n"}),
    "executor_demoted": frozenset({"sym", "executor", "ttl_s", "reason"}),
    "compile_deopt": frozenset({"level", "action", "reason", "attempt"}),
    "nan_guard": frozenset({"action"}),
    "checkpoint_save": frozenset({"path", "step", "ok", "attempt"}),
    "checkpoint_restore": frozenset({"path", "step", "ok"}),
    "preemption": frozenset({"signal", "step"}),
    "cache_repair": frozenset({"action", "path", "reason"}),
    "collective_timeout": frozenset({"fn", "timeout_s", "lines", "suspected_host"}),
    "host_loss": frozenset({"step", "host"}),
    # Every elastic_resume names the restore tier it landed on.
    "elastic_resume": frozenset({"step", "from_mesh", "to_mesh", "resharded", "tier"}),
    "sdc_suspect": frozenset({"step", "leaves"}),
    "sdc_rerun": frozenset({"step", "ok"}),
    # Tiered checkpointing: the step-boundary device-to-host snapshot
    # (stall_ms is the only hot-path cost), the background writer's disk
    # commit, the per-tier restore verdicts, and the restore-entry sweep of
    # orphan tmp dirs.
    "snapshot": frozenset({"step", "stall_ms"}),
    "snapshot_flush": frozenset({"step", "ok"}),
    "restore": frozenset({"step", "tier", "ok"}),
    "ckpt_tmp_sweep": frozenset({"count"}),
    # The fleet autopilot (resilience/autopilot.py): one record a policy
    # decision, with its evidence; a soak run summarizes itself with one
    # goodput record.
    "autopilot_decision": frozenset({"decision_id", "signal", "actuator"}),
    "goodput": frozenset({"goodput_tokens_per_sec", "useful_tokens", "wall_s"}),
    # The ops plane (observability/opsplane.py): the trailer a flight
    # recorder dump ends with, present only in flightrec-*.jsonl dumps.
    "flightrec_dump": frozenset({"reason", "records"}),
    # The federation (resilience/federation.py): one record a transition of
    # the slice-membership ledger.
    "slice_state": frozenset({"slice", "from", "to", "reason"}),
}

# The chaos correlation contract (thunder_tpu/analysis/events.py:112-160):
# every injected fault must be followed by its recovery event, the seams
# mapped to the kinds that prove the runtime degraded instead of dying.
# Seams absent here (straggler, and the fleet layer's dcn_partition and
# slice_slow) recover by simply completing.
FAULT_RECOVERY_KINDS: dict[str, frozenset] = {
    "kernel_raise": frozenset({"executor_demoted"}),
    "compile_fail": frozenset({"compile_deopt", "executor_demoted"}),
    "compile_timeout": frozenset({"compile_deopt"}),
    "oom": frozenset({"compile_deopt"}),
    "nan": frozenset({"nan_guard"}),
    "ckpt_io": frozenset({"checkpoint_save"}),
    "preempt": frozenset({"checkpoint_save"}),
    "cache_corrupt": frozenset({"cache_repair"}),
    # A hung collective is recovered by the watchdog turning it into a
    # typed, attributed timeout; a host loss by the survivors' agreed
    # checkpoint (the elastic resume happens in the NEXT process); an SDC
    # injection by the guard's quarantine + re-run, or an elastic restore
    # that discards the poisoned state.
    "collective_hang": frozenset({"collective_timeout"}),
    "host_loss": frozenset({"checkpoint_save"}),
    "sdc": frozenset({"sdc_rerun", "elastic_resume"}),
    # A corrupted comm-scheduler placement is recovered by the pass's own
    # validation falling back to the unscheduled trace: a sharp_edge record
    # with policy="comm_schedule_fallback" (only those count).
    "sched_bad": frozenset({"sharp_edge"}),
    # A torn background flush is recovered when the checkpoint pipeline
    # keeps working (a later commit, or a restore past the incomplete
    # step); a slow flush by its own eventual commit; a corrupted RAM
    # replica by the tier ladder landing a restore on a clean tier.
    "snap_torn": frozenset({"snapshot_flush", "checkpoint_save", "restore"}),
    "snap_slow": frozenset({"snapshot_flush", "checkpoint_save"}),
    "snap_corrupt": frozenset({"restore"}),
    # The fleet layer's seams: a whole-slice loss by the survivors' elastic
    # resume, a flapping slice by the federation ledger's transition.
    "slice_loss": frozenset({"elastic_resume"}),
    "slice_flap": frozenset({"slice_state"}),
}

# The autopilot correlation contract: every autopilot_decision must be
# followed by its actuator's recovery event. checkpoint_halt and
# quarantine_rerun count only successful saves and re-runs (ok=true); an
# interrupted quarantine re-run may instead be superseded by an elastic
# restore, which discards the poisoned state.
DECISION_RECOVERY_KINDS: dict[str, frozenset] = {
    "elastic_resume": frozenset({"elastic_resume"}),
    "quarantine_rerun": frozenset({"sdc_rerun", "elastic_resume"}),
    "deopt_escalate": frozenset({"compile_deopt"}),
    "checkpoint_halt": frozenset({"checkpoint_save"}),
    # The fleet actuators actuate as the elastic resume that re-enters
    # training at the new data-parallel width.
    "shrink_dp": frozenset({"elastic_resume"}),
    "regrow_dp": frozenset({"elastic_resume"}),
}


def _parse_log_lines(path: str, diags: list[Diagnostic]) -> list[tuple[int, dict]]:
    """(lineno, record) pairs from one JSONL log; malformed lines become
    diagnostics (tagged with the path when several logs are merged)."""
    out: list[tuple[int, dict]] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                diags.append(Diagnostic(
                    rule="events.malformed-line", severity=Severity.ERROR,
                    message=f"{path}:{lineno}: not valid JSON ({e})",
                ))
                continue
            out.append((lineno, rec))
    return out


def merge_event_logs(
    paths: list[str],
    offsets: Optional[dict] = None,
) -> tuple[list[dict], list[Diagnostic]]:
    """Merge several per-host JSONL logs (multi-process jobs write one log
    per process; every record carries ``pid``/``host``: observability/events.py)
    into one deterministically-ordered stream.

    Ordering is stable across re-runs of the merge: (ts, host, pid, seq) —
    wall-clock first so interleaved compiles read chronologically, then
    writer identity, then the writer's own monotonic ``seq`` to break
    same-timestamp ties. Returns (records, parse diagnostics).

    **Caveat: unaligned clocks.** Each host stamps ``ts`` from its own
    wall clock. Pass ``offsets`` (``{host: seconds the host's clock runs
    ahead of the fleet}``) to sort on skew-corrected time (``ts − offset``);
    record contents are not rewritten, only the ordering."""
    def num(v, cast) -> float:
        # A record with a non-numeric ts/host/pid/seq is still one record:
        # the schema validator downstream flags it; the merge must not die.
        try:
            return cast(v or 0)
        except (TypeError, ValueError):
            return cast(0)

    diags: list[Diagnostic] = []
    records: list[tuple[tuple, int, dict]] = []
    offsets = offsets or {}
    for path in paths:
        for lineno, rec in _parse_log_lines(path, diags):
            if isinstance(rec, dict):
                off = offsets.get(rec.get("host")) or 0.0
                key = (
                    num(rec.get("ts"), float) - num(off, float),
                    num(rec.get("host"), int),
                    num(rec.get("pid"), int),
                    num(rec.get("seq"), int),
                )
            else:
                key = (0.0, 0, 0, 0)
            records.append((key, lineno, rec))
    records.sort(key=lambda t: (t[0], t[1]))
    return [rec for _, _, rec in records], diags


def host_health(
    source,
    *,
    spread_threshold: float = 1.5,
) -> tuple[dict, list[Diagnostic]]:
    """Cross-host health summary over merged per-host event logs: per-host
    step-time statistics from ``step_time`` events, the fleet spread ratio
    (slowest host mean / fleet median), and straggler suspects.

    ``source``: a list of per-host log paths (merged via
    :func:`merge_event_logs`), or an already-merged record list. A host
    whose mean step time exceeds ``spread_threshold`` × the fleet median is
    flagged with an ``events.straggler-suspect`` diagnostic; the spread is
    surfaced as the ``thunder_tpu_host_step_time_spread_ratio`` gauge (per-
    host means as ``thunder_tpu_host_step_time_s{host=...}``) and each
    suspect emits a ``straggler_suspect`` event to the active log — so the
    coordinator that runs the merge republishes fleet health through the
    same metrics/events pipe everything else uses."""
    diags: list[Diagnostic] = []
    if isinstance(source, (list, tuple)) and source and isinstance(source[0], str):
        records, diags0 = merge_event_logs(list(source))
        diags.extend(diags0)
    else:
        records = list(source)

    # The incremental accumulator (observability/detect.py): one class owns
    # the per-host stats and spread math for both this offline summary and
    # the online spread detector.
    from thunder_tpu_torch.observability.detect import HostHealthAccumulator

    acc = HostHealthAccumulator()
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") != "step_time":
            continue
        try:
            s = float(rec["s"])
        except (KeyError, TypeError, ValueError):
            continue
        acc.add(rec.get("host") or 0, s)

    hosts = acc.host_stats()
    summary: dict[str, Any] = {"hosts": hosts, "spread_ratio": None, "stragglers": []}
    if hosts:
        # True median (even fleets average the middle pair): taking the
        # upper-middle element would make the slow host of a 2-host fleet
        # its own baseline and hide the skew entirely (the accumulator
        # implements exactly that).
        median, spread = acc.spread()
        summary["spread_ratio"] = round(spread, 4)
        from thunder_tpu_torch.observability import metrics as obsm
        from thunder_tpu_torch.observability.events import emit_event

        if obsm.enabled():
            obsm.HOST_STEP_SPREAD.set(spread)
            for h, st in hosts.items():
                obsm.HOST_STEP_TIME_S.set(st["mean_s"], host=str(h))
        for h, st in sorted(hosts.items()):
            if median and st["mean_s"] > spread_threshold * median:
                ratio = st["mean_s"] / median
                summary["stragglers"].append(h)
                emit_event("straggler_suspect", host=h,
                           mean_s=round(st["mean_s"], 6), ratio=round(ratio, 4))
                diags.append(Diagnostic(
                    rule="events.straggler-suspect", severity=Severity.WARNING,
                    message=(
                        f"host {h} mean step time {st['mean_s'] * 1e3:.2f} ms is "
                        f"{ratio:.2f}x the fleet median ({median * 1e3:.2f} ms) "
                        f"over {st['steps']} steps — straggler suspect"
                    ),
                    hint="per-host step logs merge via merge_event_logs; the "
                         "spread gauge is thunder_tpu_host_step_time_spread_ratio",
                ))
    # The collective watchdog names the first straggler of the last summary
    # in its timeout errors (resilience/watchdog.py); the installed
    # autopilot consumes the same summary: a host flagged in consecutive
    # summaries loses its gentle same-mesh rung on the next hang.
    from thunder_tpu_torch.resilience import autopilot as _autopilot
    from thunder_tpu_torch.resilience import watchdog as _watchdog

    _watchdog.note_host_health(summary)
    ap = _autopilot.current()
    if ap is not None:
        ap.note_host_health(summary)
    return summary, diags


def replay_events(
    path,
    *,
    storm_threshold: int = 4,
    strict_kinds: bool = False,
) -> tuple[dict, list[Diagnostic]]:
    """Parse and validate ``path`` (one log path, or a list of per-host log
    paths merged via :func:`merge_event_logs`); return
    ``(summary, diagnostics)``.

    ``summary``: event/kind counts, per-function compile counts, per-pass
    total milliseconds, compile-phase seconds, bucket selections, sharp-edge
    messages, anomalies by kind. ``storm_threshold``: compiles per function
    above which a recompile-storm ERROR fires. ``strict_kinds`` upgrades
    unknown kinds to errors (default: warning)."""
    diags: list[Diagnostic] = []
    kinds: dict[str, int] = {}
    compiles_by_fn: dict[str, int] = {}
    exact_compiles_by_fn: dict[str, int] = {}
    recompiles_by_fn: dict[str, int] = {}
    pass_ms: dict[str, float] = {}
    phase_s: dict[str, float] = {}
    seq_bucket_compiles_by_fn: dict[str, int] = {}
    open_compiles: dict[Any, str] = {}
    cache_option_by_cid: dict[Any, str] = {}
    bucket_by_cid: dict[Any, str] = {}
    bucket_compile_counts: dict[tuple, int] = {}  # (fn, bucket desc) -> compiles
    buckets: list[str] = []
    sharp_edges: list[str] = []
    anomaly_counts: dict[str, int] = {}
    fault_events: list[tuple[int, str, dict]] = []  # (lineno, seam, record)
    decision_events: list[tuple[int, str, dict]] = []  # (lineno, actuator, record)
    recovery_positions: dict[str, list[int]] = {}  # recovery kind -> linenos
    dump_positions: list[int] = []  # flightrec_dump trailers (dump files only)
    restore_tiers: dict[str, int] = {}  # tier -> ok restores
    restore_fallthroughs = 0  # ok restores that skipped an invalid candidate
    snapshot_stall_ms = 0.0
    snapshot_peer_wait_ms = 0.0
    n_snapshots = 0
    n_lines = 0

    merged = isinstance(path, (list, tuple)) and len(path) != 1
    if isinstance(path, (list, tuple)):
        src = ", ".join(path)
        records, parse_diags = merge_event_logs(list(path))
        diags.extend(parse_diags)
        labeled = list(enumerate(records, 1))
    else:
        src = path
        labeled = _parse_log_lines(path, diags)

    def _writer(rec: dict) -> tuple:
        # compile_id is a per-process counter: correlation keys on the
        # writer identity too once several processes' logs are merged.
        return (rec.get("host") or 0, rec.get("pid") or 0)

    def _fn_key(rec: dict, fn: str) -> str:
        return f"h{rec.get('host') or 0}:{fn}" if merged else fn

    for lineno, rec in labeled:
        n_lines += 1
        if not isinstance(rec, dict) or "kind" not in rec:
            diags.append(Diagnostic(
                rule="events.malformed-record", severity=Severity.ERROR,
                message=f"line {lineno}: not an event object (no 'kind')",
            ))
            continue
        if rec.get("v") != 1:
            diags.append(Diagnostic(
                rule="events.schema-version", severity=Severity.ERROR,
                message=f"line {lineno}: unsupported schema version {rec.get('v')!r}",
            ))
            continue
        kind = rec["kind"]
        kinds[kind] = kinds.get(kind, 0) + 1
        required = SCHEMA.get(kind)
        if required is None:
            diags.append(Diagnostic(
                rule="events.unknown-kind",
                severity=Severity.ERROR if strict_kinds else Severity.WARNING,
                message=f"line {lineno}: unknown event kind {kind!r}",
            ))
            continue
        missing = required - set(rec)
        if missing:
            diags.append(Diagnostic(
                rule="events.missing-fields", severity=Severity.ERROR,
                message=f"line {lineno}: {kind} event missing fields {sorted(missing)}",
            ))
            continue

        if kind == "compile_start":
            fn = _fn_key(rec, str(rec["fn"]))
            cid = (*_writer(rec), rec["compile_id"])
            compiles_by_fn[fn] = compiles_by_fn.get(fn, 0) + 1
            open_compiles[cid] = fn
            cache_option_by_cid[cid] = str(rec["cache_option"])
        elif kind == "compile_end":
            fn = _fn_key(rec, str(rec["fn"]))
            cid = (*_writer(rec), rec["compile_id"])
            open_compiles.pop(cid, None)
            if rec.get("recompile"):
                recompiles_by_fn[fn] = recompiles_by_fn.get(fn, 0) + 1
            # Storm accounting by compile class: symbolic compiles count per
            # (fn, bucket), a module's seq_bucket compiles per fn against a
            # higher threshold, exact-shape compiles per fn.
            if rec.get("symbolic"):
                bkey = (fn, bucket_by_cid.get(cid, "?"))
                bucket_compile_counts[bkey] = bucket_compile_counts.get(bkey, 0) + 1
            elif cache_option_by_cid.get(cid, "").endswith("+seq_bucket"):
                seq_bucket_compiles_by_fn[fn] = seq_bucket_compiles_by_fn.get(fn, 0) + 1
            else:
                exact_compiles_by_fn[fn] = exact_compiles_by_fn.get(fn, 0) + 1
        elif kind == "pass":
            if rec["ms"] is not None:
                pass_ms[rec["name"]] = pass_ms.get(rec["name"], 0.0) + float(rec["ms"])
        elif kind == "compile_phase":
            if rec["s"] is not None:
                key = str(rec["phase"])
                if rec.get("cache"):
                    key = f"{key}[{rec['cache']}]"
                phase_s[key] = phase_s.get(key, 0.0) + float(rec["s"])
        elif kind == "bucket_select":
            buckets.append(str(rec["buckets"]))
            bucket_by_cid[(*_writer(rec), rec["compile_id"])] = str(rec["buckets"])
        elif kind == "sharp_edge":
            sharp_edges.append(str(rec["message"]))
            # The comm scheduler's fallback record is the recovery event of
            # an injected sched_bad placement; other sharp edges are not.
            if rec.get("policy") == "comm_schedule_fallback":
                recovery_positions.setdefault("sharp_edge", []).append(lineno)
        elif kind == "anomaly":
            a = str(rec.get("anomaly"))
            anomaly_counts[a] = anomaly_counts.get(a, 0) + 1
        elif kind == "fault_injected":
            fault_events.append((lineno, str(rec["seam"]), rec))
        elif kind == "autopilot_decision":
            decision_events.append((lineno, str(rec["actuator"]), rec))
        elif kind == "flightrec_dump":
            dump_positions.append(lineno)
        elif kind in ("executor_demoted", "compile_deopt", "nan_guard", "cache_repair", "collective_timeout",
                      "elastic_resume", "slice_state"):
            recovery_positions.setdefault(kind, []).append(lineno)
        elif kind in ("checkpoint_save", "sdc_rerun", "snapshot_flush", "restore"):
            # Only a SUCCESSFUL save/re-run/flush/restore proves recovery.
            if rec.get("ok"):
                recovery_positions.setdefault(kind, []).append(lineno)
            if kind == "restore" and rec.get("ok"):
                tier = str(rec.get("tier"))
                restore_tiers[tier] = restore_tiers.get(tier, 0) + 1
                if rec.get("tried"):
                    restore_fallthroughs += 1
        elif kind == "snapshot":
            n_snapshots += 1
            try:
                snapshot_stall_ms += float(rec.get("stall_ms") or 0.0)
                snapshot_peer_wait_ms += float(rec.get("peer_wait_ms") or 0.0)
            except (TypeError, ValueError):
                pass

    for fn, n in sorted(exact_compiles_by_fn.items()):
        if n > storm_threshold:
            diags.append(Diagnostic(
                rule="events.recompile-storm", severity=Severity.ERROR,
                message=(
                    f"{fn!r} compiled {n} times for exact shapes (threshold "
                    f"{storm_threshold}) — guards are churning; consider "
                    f"cache='symbolic values'"
                ),
                hint="thunder_tpu_torch.cache_info(fn) shows per-entry guard fails",
            ))
    for fn, n in sorted(seq_bucket_compiles_by_fn.items()):
        # Bucket identity is not in the module frontend's log: flag only well
        # past any plausible bucket count, and as a WARNING.
        if n > storm_threshold * 4:
            diags.append(Diagnostic(
                rule="events.recompile-storm", severity=Severity.WARNING,
                message=(
                    f"{fn!r} (module, seq_bucket) compiled {n} times — more "
                    f"than {storm_threshold * 4} sequence buckets is unusual; "
                    f"check for value-guard churn"
                ),
                hint="thunder_tpu_torch.cache_info(tm) shows entry counts",
            ))
    for (fn, desc), n in sorted(bucket_compile_counts.items()):
        if n > 2:
            diags.append(Diagnostic(
                rule="events.recompile-storm", severity=Severity.ERROR,
                message=(
                    f"{fn!r} compiled shape bucket {desc} {n} times — one "
                    f"compile per bucket is steady state; repeats mean value "
                    f"guards or marks are churning"
                ),
                hint="check symbolic_dims/buckets configuration; "
                     "thunder_tpu_torch.cache_info(fn) shows per-entry guard fails",
            ))
    for cid, fn in open_compiles.items():
        diags.append(Diagnostic(
            rule="events.unclosed-compile", severity=Severity.WARNING,
            message=f"compile {cid[-1]} of {fn!r} has no compile_end (crashed mid-compile?)",
        ))
    # Chaos correlation: every injected fault with a declared recovery must
    # be followed by its recovery event; a fault_injected with none after it
    # means the runtime died or the recovery path lost its event.
    unrecovered: list[str] = []
    for lineno, seam, rec in fault_events:
        expected = FAULT_RECOVERY_KINDS.get(seam)
        if not expected:
            continue
        if any(pos > lineno for pos in dump_positions):
            # A flight-recorder dump landed after this injection: the log is
            # a capture taken at fault time, and the recovery runs in the
            # process that continues, outside it.
            continue
        if not any(pos > lineno for k in expected for pos in recovery_positions.get(k, [])):
            unrecovered.append(f"{seam}@{rec.get('target')}")
            diags.append(Diagnostic(
                rule="events.unrecovered-fault", severity=Severity.ERROR,
                message=(
                    f"line {lineno}: fault_injected seam={seam!r} "
                    f"target={rec.get('target')!r} has no subsequent "
                    f"{'/'.join(sorted(expected))} event — the fault was not "
                    f"recovered (or the recovery path lost its event)"
                ),
                hint="analysis.events.FAULT_RECOVERY_KINDS lists the expected recovery event per seam",
            ))
    # The autopilot correlation: every decision must be followed by its
    # actuator's recovery event, the fault rule one layer up.
    unactuated: list[str] = []
    decisions_by_actuator: dict[str, int] = {}
    for lineno, actuator, rec in decision_events:
        decisions_by_actuator[actuator] = decisions_by_actuator.get(actuator, 0) + 1
        expected = DECISION_RECOVERY_KINDS.get(actuator)
        if not expected:
            continue
        if any(pos > lineno for pos in dump_positions):
            continue  # a capture taken while the recovery was in flight
        if not any(pos > lineno for k in expected for pos in recovery_positions.get(k, [])):
            unactuated.append(f"{actuator}<-{rec.get('signal')}")
            diags.append(Diagnostic(
                rule="events.unactuated-decision", severity=Severity.ERROR,
                message=(
                    f"line {lineno}: autopilot_decision "
                    f"id={rec.get('decision_id')} actuator={actuator!r} "
                    f"(signal {rec.get('signal')!r}) has no subsequent "
                    f"{'/'.join(sorted(expected))} event — the chosen "
                    f"recovery never ran (or lost its event)"
                ),
                hint="analysis.events.DECISION_RECOVERY_KINDS lists the recovery event per actuator",
            ))

    summary = {
        "path": src,
        "lines": n_lines,
        "kinds": kinds,
        "compiles_by_fn": compiles_by_fn,
        "exact_compiles_by_fn": exact_compiles_by_fn,
        "seq_bucket_compiles_by_fn": seq_bucket_compiles_by_fn,
        "bucket_compiles": {f"{fn}: {d}": n for (fn, d), n in sorted(bucket_compile_counts.items())},
        "recompiles_by_fn": recompiles_by_fn,
        "pass_ms_total": {k: round(v, 3) for k, v in sorted(pass_ms.items())},
        "compile_phase_s_total": {k: round(v, 4) for k, v in sorted(phase_s.items())},
        "bucket_selects": buckets,
        "sharp_edges": sharp_edges,
        "anomalies": anomaly_counts,
        "faults_injected": [f"{seam}@{rec.get('target')}" for _, seam, rec in fault_events],
        "unrecovered_faults": unrecovered,
        "autopilot_decisions": decisions_by_actuator,
        "unactuated_decisions": unactuated,
        # Tiered checkpointing: where restores landed, how many fell
        # through an invalid candidate, and the snapshots' stall.
        "restore_tiers": restore_tiers,
        "restore_fallthroughs": restore_fallthroughs,
        "snapshots": n_snapshots,
        "snapshot_stall_ms_total": round(snapshot_stall_ms, 3),
        # On ranks, the wait for the other ranks before each snapshot's
        # gather (outside its stall_ms).
        "snapshot_peer_wait_ms_total": round(snapshot_peer_wait_ms, 3),
        # Flight-recorder dump markers (non-zero only for a dump file).
        "flightrec_dumps": len(dump_positions),
    }
    return summary, diags


def format_replay(summary: dict, diags: list[Diagnostic]) -> str:
    """Human-readable replay report."""
    lines = [
        f"events: {summary['lines']} records from {summary['path']}",
        "  kinds: " + ", ".join(f"{k}={v}" for k, v in sorted(summary["kinds"].items())),
    ]
    if summary["compiles_by_fn"]:
        lines.append("  compiles: " + ", ".join(
            f"{fn}×{n}" for fn, n in sorted(summary["compiles_by_fn"].items())
        ))
    if summary["pass_ms_total"]:
        lines.append("  pass time (ms): " + ", ".join(
            f"{k}={v}" for k, v in summary["pass_ms_total"].items()
        ))
    if summary.get("compile_phase_s_total"):
        lines.append("  compile phases (s): " + ", ".join(
            f"{k}={v}" for k, v in summary["compile_phase_s_total"].items()
        ))
    if summary["bucket_selects"]:
        lines.append(f"  bucket selects: {len(summary['bucket_selects'])}")
    if summary["sharp_edges"]:
        lines.append(f"  sharp edges: {len(summary['sharp_edges'])}")
    if summary.get("faults_injected"):
        lines.append(
            f"  faults injected: {len(summary['faults_injected'])} "
            f"({', '.join(summary['faults_injected'])}); "
            f"unrecovered: {len(summary.get('unrecovered_faults') or [])}"
        )
    if summary.get("autopilot_decisions"):
        lines.append(
            "  autopilot decisions: " + ", ".join(
                f"{a}×{n}" for a, n in sorted(summary["autopilot_decisions"].items())
            ) + f"; unactuated: {len(summary.get('unactuated_decisions') or [])}"
        )
    if summary.get("restore_tiers"):
        lines.append(
            "  restores by tier: " + ", ".join(
                f"{t}×{n}" for t, n in sorted(summary["restore_tiers"].items())
            ) + f"; fall-throughs: {summary.get('restore_fallthroughs', 0)}"
        )
    if summary.get("snapshots"):
        lines.append(
            f"  snapshots: {summary['snapshots']} "
            f"(stall total {summary.get('snapshot_stall_ms_total', 0.0)} ms"
            + (f", peer wait total {summary['snapshot_peer_wait_ms_total']} ms"
               if summary.get("snapshot_peer_wait_ms_total") else "")
            + ")"
        )
    if summary.get("anomalies"):
        lines.append(
            "  anomalies: " + ", ".join(
                f"{k}×{n}" for k, n in sorted(summary["anomalies"].items())
            )
        )
    for d in diags:
        lines.append("  " + d.format().replace("\n", "\n  "))
    return "\n".join(lines)
