"""Streaming anomaly detection: the online half of the telemetry pipeline.

The counterpart of ``thunder_tpu/observability/detect.py``, a copy of its
stdlib-only code: incremental EWMA/CUSUM detectors over step time,
recompile rate, goodput and per-host spread that fire while a run is still
going.

- :class:`EwmaStat` / :class:`CusumDetector` / :class:`DriftDetector` /
  :class:`BandDetector` / :class:`RateDetector`: the incremental
  statistics, one value at a time, O(1) memory;
- :class:`HostHealthAccumulator`: per-host step stats and fleet spread,
  shared by the offline ``analysis/events.host_health`` and the online
  spread detector;
- :class:`DetectorBank`: watches ``step_time`` and ``compile_end`` records
  and raises typed ``anomaly`` events (kind, severity, value, baseline,
  evidence window), bumps ``thunder_tpu_anomalies_total{kind=}`` and keeps
  each anomaly in a bounded ring.

Anomaly kinds: ``step_time_drift`` (CUSUM over per-step seconds),
``goodput_drop`` (fast over slow EWMA of step time), ``recompile_storm``
(recompile ``compile_end`` records inside a window), ``host_spread`` and
``slice_spread`` (slowest host or slice over the median), ``bottleneck_shift``
(a critical path's dominant class flipped), ``kernel_regression`` and
``cost_model_drift`` (a roofline op's measured/predicted ratio out of its
band).

The ops plane (``observability/opsplane.py``) installs the bank as an event
tap, and every anomaly is routed into the installed autopilot
(``resilience/autopilot.py``: ``note_anomaly``), whose decisions cite it.
Module-top imports are stdlib-only.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

SEVERITIES = ("info", "warn", "critical")


# =============================================================================
# Incremental statistics
# =============================================================================


class EwmaStat:
    """Exponentially-weighted mean + variance, one float at a time."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n == 1:
            self.mean = x
            self.var = 0.0
            return
        d = x - self.mean
        self.mean += self.alpha * d
        # West's EWM variance: decays old spread, charges the new deviation.
        self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)

    def sigma(self, *, rel_floor: float = 0.05) -> float:
        """Std-dev estimate, floored at ``rel_floor``×mean so a perfectly
        steady warm-up cannot make every later jitter look infinitely
        anomalous."""
        return max(math.sqrt(max(self.var, 0.0)), abs(self.mean) * rel_floor, 1e-12)


class CusumDetector:
    """One-sided (high) CUSUM over sigma-normalized deviations.

    ``update(x)`` returns an evidence dict when the cumulative sum of
    ``(x - mean)/sigma - drift`` exceeds ``threshold`` — a sustained upward
    drift, not a single spike. The baseline EWMA is FROZEN while a sample
    deviates past ``freeze_k`` sigmas (an anomaly must not teach the
    baseline that slow is normal), the sum resets after firing, and a
    ``cooldown`` of samples must pass before the detector re-arms — one
    drift raises one anomaly (then a periodic re-alert if it persists),
    not one per subsequent slow step."""

    __slots__ = ("stat", "drift", "threshold", "min_samples", "freeze_k",
                 "cooldown", "cusum", "window", "_quiet")

    def __init__(self, *, alpha: float = 0.2, drift: float = 0.5,
                 threshold: float = 6.0, min_samples: int = 8,
                 freeze_k: float = 4.0, cooldown: int = 16, window: int = 8):
        self.stat = EwmaStat(alpha)
        self.drift = float(drift)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.freeze_k = float(freeze_k)
        self.cooldown = int(cooldown)
        self.cusum = 0.0
        self.window: deque = deque(maxlen=int(window))
        self._quiet = 0

    def update(self, x: float) -> Optional[dict]:
        x = float(x)
        self.window.append(x)
        if self.stat.n < self.min_samples:
            self.stat.update(x)
            return None
        sigma = self.stat.sigma()
        z = (x - self.stat.mean) / sigma
        if z < self.freeze_k:
            self.stat.update(x)
        if self._quiet > 0:
            self._quiet -= 1
            return None
        self.cusum = max(0.0, self.cusum + z - self.drift)
        if self.cusum <= self.threshold:
            return None
        out = {
            "value": x,
            "baseline": self.stat.mean,
            "cusum": round(self.cusum, 3),
            "window": [round(v, 6) for v in self.window],
        }
        self.cusum = 0.0
        self._quiet = self.cooldown
        return out


class DriftDetector:
    """Sustained-ratio detector: a fast EWMA tracking the recent level
    against a slow EWMA baseline; fires when fast/slow exceeds ``factor``
    for ``consecutive`` samples. The goodput shape: tokens/sec is
    tokens/step-seconds, so a sustained step-time ratio IS an inverse
    throughput ratio, without needing token counts on the stream."""

    __slots__ = ("fast", "slow", "factor", "consecutive", "min_samples",
                 "cooldown", "_hits", "_quiet", "window")

    def __init__(self, *, fast_alpha: float = 0.5, slow_alpha: float = 0.05,
                 factor: float = 1.6, consecutive: int = 4,
                 min_samples: int = 8, cooldown: int = 16, window: int = 8):
        self.fast = EwmaStat(fast_alpha)
        self.slow = EwmaStat(slow_alpha)
        self.factor = float(factor)
        self.consecutive = int(consecutive)
        self.min_samples = int(min_samples)
        self.cooldown = int(cooldown)
        self._hits = 0
        self._quiet = 0
        self.window: deque = deque(maxlen=int(window))

    def update(self, x: float) -> Optional[dict]:
        x = float(x)
        self.window.append(x)
        self.fast.update(x)
        if self.slow.n < self.min_samples:
            self.slow.update(x)
            return None
        ratio = self.fast.mean / self.slow.mean if self.slow.mean else 0.0
        if ratio < self.factor:
            # Only a healthy sample teaches the baseline: absorbing the
            # degraded level would silently redefine it as normal.
            self.slow.update(x)
            self._hits = 0
            return None
        if self._quiet > 0:
            self._quiet -= 1
            return None
        self._hits += 1
        if self._hits < self.consecutive:
            return None
        self._hits = 0
        self._quiet = self.cooldown
        return {
            "value": self.fast.mean,
            "baseline": self.slow.mean,
            "ratio": round(ratio, 3),
            "window": [round(v, 6) for v in self.window],
        }


class BandDetector:
    """Two-sided ratio-band detector for slow-cadence streams (the roofline
    duty cycle feeds one sample per probe, not per step): a slow EWMA
    baseline; fires when ``value/baseline`` leaves ``[1/factor, factor]``
    for ``consecutive`` samples. Two-sided because both directions are
    verdicts — an op running slower than its history is a kernel
    regression, an op running *faster* than the cost model ever predicted
    means the pricing is stale. Only in-band samples teach the baseline,
    and a fired detector stays quiet for ``cooldown`` samples (sample
    count, not wall clock: at one probe every N steps a time-based
    cooldown would never be reached)."""

    __slots__ = ("slow", "factor", "consecutive", "min_samples",
                 "cooldown", "_hits", "_quiet", "window")

    def __init__(self, *, slow_alpha: float = 0.2, factor: float = 1.5,
                 consecutive: int = 2, min_samples: int = 3,
                 cooldown: int = 16, window: int = 8):
        self.slow = EwmaStat(slow_alpha)
        self.factor = float(factor)
        self.consecutive = int(consecutive)
        self.min_samples = int(min_samples)
        self.cooldown = int(cooldown)
        self._hits = 0
        self._quiet = 0
        self.window: deque = deque(maxlen=int(window))

    def update(self, x: float) -> Optional[dict]:
        x = float(x)
        self.window.append(x)
        if self.slow.n < self.min_samples:
            self.slow.update(x)
            return None
        ratio = x / self.slow.mean if self.slow.mean else 0.0
        if ratio > 0 and (1.0 / self.factor) <= ratio <= self.factor:
            self.slow.update(x)
            self._hits = 0
            return None
        if self._quiet > 0:
            self._quiet -= 1
            return None
        self._hits += 1
        if self._hits < self.consecutive:
            return None
        self._hits = 0
        self._quiet = self.cooldown
        return {
            "value": x,
            "baseline": self.slow.mean,
            "ratio": round(ratio, 3),
            "window": [round(v, 6) for v in self.window],
        }


class RateDetector:
    """Events-per-window threshold (the recompile-storm shape): ``tick(ts)``
    fires when ``threshold`` ticks land inside ``window_s``. The tick
    history clears on firing so one storm raises one anomaly."""

    __slots__ = ("window_s", "threshold", "_ticks")

    def __init__(self, *, window_s: float = 60.0, threshold: int = 4):
        self.window_s = float(window_s)
        self.threshold = int(threshold)
        self._ticks: deque = deque()

    def tick(self, ts: Optional[float] = None) -> Optional[dict]:
        ts = time.time() if ts is None else float(ts)
        self._ticks.append(ts)
        while self._ticks and ts - self._ticks[0] > self.window_s:
            self._ticks.popleft()
        if len(self._ticks) < self.threshold:
            return None
        out = {
            "value": float(len(self._ticks)),
            "baseline": float(self.threshold),
            "window": [round(t, 3) for t in self._ticks],
        }
        self._ticks.clear()
        return out


# =============================================================================
# Host-health accumulator (shared with analysis/events.host_health)
# =============================================================================


class HostHealthAccumulator:
    """Incremental per-host step-time statistics + fleet spread.

    Factored out of ``analysis/events.host_health``:
    the offline replay feeds it one merged record at a time and reads the
    SAME numbers the old from-scratch recompute produced (running sum in
    record order ⇒ identical floats), while the online spread detector
    (:class:`DetectorBank`) feeds it live ``step_time`` events. O(hosts)
    memory, O(1) per sample."""

    def __init__(self):
        # host -> [steps, sum_s, max_s]; insertion order = first-seen order,
        # which the offline summary's "hosts" dict preserves.
        self._hosts: dict[Any, list] = {}

    def add(self, host: Any, s: float) -> None:
        st = self._hosts.get(host)
        if st is None:
            self._hosts[host] = [1, s, s]
            return
        st[0] += 1
        st[1] += s
        if s > st[2]:
            st[2] = s

    def __len__(self) -> int:
        return len(self._hosts)

    def host_stats(self) -> dict:
        """``{host: {"steps", "mean_s", "max_s"}}`` in first-seen order —
        the exact per-host block of the offline summary."""
        return {
            h: {"steps": n, "mean_s": total / n, "max_s": mx}
            for h, (n, total, mx) in self._hosts.items()
        }

    def spread(self) -> tuple[float, float]:
        """(fleet median of per-host means, slowest mean / median). (0, 0)
        with no hosts. True median — even fleets average the middle pair,
        so a 2-host fleet's slow half cannot be its own baseline."""
        if not self._hosts:
            return 0.0, 0.0
        means = sorted(total / n for n, total, _ in self._hosts.values())
        mid = len(means) // 2
        median = means[mid] if len(means) % 2 else 0.5 * (means[mid - 1] + means[mid])
        return median, (max(means) / median if median else 0.0)


# =============================================================================
# The detector bank
# =============================================================================


@dataclass
class DetectorConfig:
    """Tuning knobs, the JAX package's. The defaults are sized for
    production step cadences."""

    step_alpha: float = 0.2
    step_cusum_drift: float = 0.5
    step_cusum_threshold: float = 6.0
    min_samples: int = 8
    goodput_drop_factor: float = 1.6
    goodput_consecutive: int = 4
    recompile_window_s: float = 60.0
    recompile_threshold: int = 4
    spread_threshold: float = 1.5
    spread_min_steps: int = 4
    spread_consecutive: int = 3
    # Cross-slice (DCN-tier) spread: lower bar than the in-slice host
    # spread — a whole slice lagging is a federation-level event.
    slice_spread_threshold: float = 1.3
    # Roofline duty-cycle streams: per-op measured/predicted
    # ratio band. Sized for *rare* samples — one per duty-cycled probe —
    # so the trip thresholds are much lower than the per-step detectors'.
    roofline_band_factor: float = 1.5
    roofline_consecutive: int = 2
    roofline_min_samples: int = 3
    # Fleet critical-path ledger: bottleneck_shift fires when
    # the EWMA-dominant time class flips after warmup, or the
    # straggler-wait fraction exceeds its absolute band (naming the slowest
    # host into the autopilot strike ledger).
    critpath_min_steps: int = 6
    critpath_straggler_frac: float = 0.25
    critpath_consecutive: int = 2
    # The critpath feed is per fleet STEP (the spread detectors see one
    # sample per host per step), so its re-arm cadence gets its own knob;
    # None inherits ``cooldown``. 0 = re-alert every ``critpath_consecutive``
    # steps while the band violation persists.
    critpath_cooldown: Optional[int] = None
    # Samples a tripped detector stays quiet before re-arming (one drift =
    # one anomaly, then periodic re-alerts while it persists).
    cooldown: int = 16
    # value/baseline past this ratio upgrades warn -> critical.
    critical_factor: float = 4.0
    max_anomalies: int = 128


@dataclass
class Anomaly:
    """One detector verdict, mirrored into the typed ``anomaly`` event."""

    kind: str
    severity: str
    value: float
    baseline: float
    ts: float
    detector: str
    window: list = field(default_factory=list)
    suspect_host: Optional[Any] = None
    fn: Optional[str] = None

    def as_event_fields(self) -> dict:
        out = {
            "anomaly": self.kind,
            "severity": self.severity,
            "value": round(float(self.value), 6),
            "baseline": round(float(self.baseline), 6),
            "detector": self.detector,
            "window": self.window,
        }
        if self.suspect_host is not None:
            out["suspect_host"] = self.suspect_host
        if self.fn:
            out["fn"] = self.fn
        return out


class DetectorBank:
    """Consumes event records (``consume(kind, fields)``: the ops plane's
    tap in the JAX package) and raises anomalies.

    Per ``step_time`` stream (keyed by fn) it runs a CUSUM drift detector
    and a goodput-ratio detector; per ``compile_end{recompile}`` a rate
    detector; per-host step times feed the shared
    :class:`HostHealthAccumulator` for the online spread check. Every
    anomaly is (1) an ``anomaly`` event on the active log, (2) a
    ``thunder_tpu_anomalies_total{kind=}`` bump, and (3) kept in a
    bounded ring. Consumption is locked and exception-proof: a detector
    bug must never take the workload down."""

    def __init__(self, config: Optional[DetectorConfig] = None):
        self.config = config or DetectorConfig()
        self._lock = threading.Lock()
        self._step: dict[str, CusumDetector] = {}
        self._goodput: dict[str, DriftDetector] = {}
        self._recompiles = RateDetector(
            window_s=self.config.recompile_window_s,
            threshold=self.config.recompile_threshold,
        )
        self._spread_acc = HostHealthAccumulator()
        self._spread_hits = 0
        self._spread_quiet = 0
        self._slice_acc = HostHealthAccumulator()
        self._slice_hits = 0
        self._slice_quiet = 0
        self._roofline: dict[str, BandDetector] = {}
        self._critpath = {
            "ewma": {}, "steps": 0, "dom": None, "dom_hits": 0,
            "dom_quiet": 0, "strag_hits": 0, "strag_quiet": 0,
        }
        self.anomalies: deque = deque(maxlen=self.config.max_anomalies)
        self.consumed = 0

    # -- the tap ---------------------------------------------------------------

    def consume(self, kind: str, fields: dict) -> None:
        if kind == "anomaly":
            return  # our own output flowing back through the tap
        raised: list[Anomaly] = []
        with self._lock:
            self.consumed += 1
            if kind == "step_time":
                raised = self._on_step(fields)
            elif kind == "compile_end" and fields.get("recompile"):
                raised = self._on_recompile()
        for a in raised:
            self._publish(a)

    # -- per-kind handlers (under the lock) ------------------------------------

    def _on_step(self, fields: dict) -> list:
        cfg = self.config
        try:
            s = float(fields["s"])
        except (KeyError, TypeError, ValueError):
            return []
        fn = str(fields.get("fn") or "step")
        out: list[Anomaly] = []
        det = self._step.get(fn)
        if det is None:
            det = self._step[fn] = CusumDetector(
                alpha=cfg.step_alpha, drift=cfg.step_cusum_drift,
                threshold=cfg.step_cusum_threshold,
                min_samples=cfg.min_samples, cooldown=cfg.cooldown,
            )
        hit = det.update(s)
        if hit:
            out.append(self._anomaly("step_time_drift", "cusum", hit, fn=fn))
        good = self._goodput.get(fn)
        if good is None:
            good = self._goodput[fn] = DriftDetector(
                factor=cfg.goodput_drop_factor,
                consecutive=cfg.goodput_consecutive,
                min_samples=cfg.min_samples, cooldown=cfg.cooldown,
            )
        hit = good.update(s)
        if hit:
            out.append(self._anomaly("goodput_drop", "ewma_ratio", hit, fn=fn))
        out.extend(self._on_spread(fields, s))
        out.extend(self._on_slice_spread(fields, s))
        return out

    def _on_spread(self, fields: dict, s: float) -> list:
        cfg = self.config
        host = fields.get("host")
        if host is None:
            from thunder_tpu_torch.observability.events import host_identity

            host = host_identity()["host"]
        self._spread_acc.add(host, s)
        if len(self._spread_acc) < 2:
            return []
        stats = self._spread_acc.host_stats()
        if min(st["steps"] for st in stats.values()) < cfg.spread_min_steps:
            return []
        median, spread = self._spread_acc.spread()
        if spread <= cfg.spread_threshold:
            self._spread_hits = 0
            return []
        if self._spread_quiet > 0:
            self._spread_quiet -= 1
            return []
        self._spread_hits += 1
        if self._spread_hits < cfg.spread_consecutive:
            return []
        self._spread_hits = 0
        self._spread_quiet = cfg.cooldown
        slow = max(stats, key=lambda h: stats[h]["mean_s"])
        return [self._anomaly(
            "host_spread", "spread",
            {"value": spread, "baseline": cfg.spread_threshold,
             "window": [round(st["mean_s"], 6) for st in stats.values()]},
            suspect_host=slow,
        )]

    def _on_slice_spread(self, fields: dict, s: float) -> list:
        cfg = self.config
        sl = fields.get("slice")
        if sl is None:
            try:
                from thunder_tpu_torch.resilience.chaos import slice_id

                sl = slice_id()
            except Exception:
                return []
        self._slice_acc.add(int(sl), s)
        if len(self._slice_acc) < 2:
            return []
        stats = self._slice_acc.host_stats()
        if min(st["steps"] for st in stats.values()) < cfg.spread_min_steps:
            return []
        median, spread = self._slice_acc.spread()
        if spread <= cfg.slice_spread_threshold:
            self._slice_hits = 0
            return []
        if self._slice_quiet > 0:
            self._slice_quiet -= 1
            return []
        self._slice_hits += 1
        if self._slice_hits < cfg.spread_consecutive:
            return []
        self._slice_hits = 0
        self._slice_quiet = cfg.cooldown
        slow = max(stats, key=lambda h: stats[h]["mean_s"])
        return [self._anomaly(
            "slice_spread", "spread",
            {"value": spread, "baseline": cfg.slice_spread_threshold,
             "window": [round(st["mean_s"], 6) for st in stats.values()]},
            suspect_host=f"slice{slow}",
        )]

    def note_slice_step(self, slice_: int, s: float) -> None:
        """Direct per-slice step-time feed for federated drivers:
        the emulated fleet runs every slice in one process, so host-keyed
        ``step_time`` events cannot separate the slices — the driver calls
        this instead with the per-slice wall time (the ``slice_step_time``
        hook of ``run_federated_training``)."""
        raised: list[Anomaly] = []
        with self._lock:
            raised = self._on_slice_spread({"slice": int(slice_)}, float(s))
        for a in raised:
            self._publish(a)

    def note_roofline_op(self, label: str, measured_us: float,
                         roofline_us: float, *,
                         executor: Optional[str] = None) -> None:
        """Direct per-op feed from the roofline sampler: each
        duty-cycled probe reports every ledger op's measured device time
        against its static roofline bound. The measured/predicted ratio
        streams into a per-op :class:`BandDetector`; a sustained walk out
        of the band is ``kernel_regression`` when an executor claimed the
        op (a regressed Pallas/custom kernel) and ``cost_model_drift``
        otherwise (the pricing no longer describes the hardware). Direct
        feed, not an event tap: probe joins are already in-process objects
        and the per-op fanout would be noise on the event log."""
        try:
            measured = float(measured_us)
            predicted = float(roofline_us)
        except (TypeError, ValueError):
            return
        if measured <= 0 or predicted <= 0:
            return
        cfg = self.config
        claimed = executor not in (None, "", "jax")
        raised: list[Anomaly] = []
        with self._lock:
            det = self._roofline.get(label)
            if det is None:
                det = self._roofline[label] = BandDetector(
                    factor=cfg.roofline_band_factor,
                    consecutive=cfg.roofline_consecutive,
                    min_samples=cfg.roofline_min_samples,
                    cooldown=cfg.cooldown,
                )
            hit = det.update(measured / predicted)
            if hit:
                kind = "kernel_regression" if claimed else "cost_model_drift"
                raised = [self._anomaly(kind, "roofline_band", hit, fn=label)]
        for a in raised:
            self._publish(a)

    def note_critpath_step(self, step: int, fractions: dict, *,
                           slowest_host: Optional[Any] = None) -> None:
        """Direct per-step feed from the fleet timeline recorder: class
        fractions of one step's critical path. Two triggers raise
        ``bottleneck_shift``:

        - the EWMA-dominant class flips after ``critpath_min_steps`` warmup
          (``fn`` carries ``old->new``; fleet-level, so no suspect host —
          any relevant autopilot decision may cite it);
        - the straggler-wait fraction exceeds ``critpath_straggler_frac``
          for ``critpath_consecutive`` steps, naming ``slowest_host`` so
          the strike ledger accumulates against the lagging host."""
        raised: list[Anomaly] = []
        cfg = self.config
        cp_cooldown = (cfg.cooldown if cfg.critpath_cooldown is None
                       else cfg.critpath_cooldown)
        with self._lock:
            cp = self._critpath
            alpha = cfg.step_alpha
            for c, f in fractions.items():
                try:
                    f = float(f)
                except (TypeError, ValueError):
                    continue
                prev = cp["ewma"].get(c)
                cp["ewma"][c] = f if prev is None else prev + alpha * (f - prev)
            cp["steps"] += 1
            if cp["steps"] >= cfg.critpath_min_steps and cp["ewma"]:
                window = [round(cp["ewma"][c], 4) for c in sorted(cp["ewma"])]
                dom = max(cp["ewma"], key=lambda c: cp["ewma"][c])
                if cp["dom"] is None:
                    cp["dom"] = dom
                elif dom != cp["dom"]:
                    if cp["dom_quiet"] > 0:
                        cp["dom_quiet"] -= 1
                    else:
                        cp["dom_hits"] += 1
                        if cp["dom_hits"] >= cfg.critpath_consecutive:
                            raised.append(self._anomaly(
                                "bottleneck_shift", "critpath_dominant",
                                {"value": cp["ewma"][dom],
                                 "baseline": cp["ewma"].get(cp["dom"], 0.0),
                                 "window": window},
                                fn=f"{cp['dom']}->{dom}",
                            ))
                            cp["dom"] = dom
                            cp["dom_hits"] = 0
                            cp["dom_quiet"] = cp_cooldown
                else:
                    cp["dom_hits"] = 0
                try:
                    strag = float(fractions.get("straggler_wait") or 0.0)
                except (TypeError, ValueError):
                    strag = 0.0
                if strag <= cfg.critpath_straggler_frac:
                    cp["strag_hits"] = 0
                elif cp["strag_quiet"] > 0:
                    cp["strag_quiet"] -= 1
                else:
                    cp["strag_hits"] += 1
                    if cp["strag_hits"] >= cfg.critpath_consecutive:
                        cp["strag_hits"] = 0
                        cp["strag_quiet"] = cp_cooldown
                        raised.append(self._anomaly(
                            "bottleneck_shift", "critpath_straggler_band",
                            {"value": strag,
                             "baseline": cfg.critpath_straggler_frac,
                             "window": window},
                            suspect_host=slowest_host,
                        ))
        for a in raised:
            self._publish(a)

    def _on_recompile(self) -> list:
        hit = self._recompiles.tick()
        if not hit:
            return []
        return [self._anomaly("recompile_storm", "rate", hit)]

    def _anomaly(self, kind: str, detector: str, hit: dict, *,
                 fn: Optional[str] = None,
                 suspect_host: Optional[Any] = None) -> Anomaly:
        cfg = self.config
        value = float(hit.get("value") or 0.0)
        baseline = float(hit.get("baseline") or 0.0)
        severity = "warn"
        if baseline > 0 and value / baseline >= cfg.critical_factor:
            severity = "critical"
        if suspect_host is None and kind in ("step_time_drift", "goodput_drop"):
            from thunder_tpu_torch.observability.events import host_identity

            suspect_host = host_identity()["host"]
        return Anomaly(
            kind=kind, severity=severity, value=value, baseline=baseline,
            ts=time.time(), detector=detector,
            window=list(hit.get("window") or ()),
            suspect_host=suspect_host, fn=fn,
        )

    # -- publication (outside the lock) ----------------------------------------

    def _publish(self, a: Anomaly) -> None:
        self.anomalies.append(a)
        try:
            from thunder_tpu_torch.observability import events as obs_events
            from thunder_tpu_torch.observability import metrics as obsm

            if obsm.enabled():
                obsm.ANOMALIES.inc(kind=a.kind)
            obs_events.emit_event("anomaly", **a.as_event_fields())
        except Exception:
            pass
        try:
            from thunder_tpu_torch.resilience import autopilot as ap_mod

            ap = ap_mod.current()
            if ap is not None:
                ap.note_anomaly({
                    "anomaly": a.kind, "severity": a.severity, "ts": a.ts,
                    "value": a.value, "baseline": a.baseline,
                    "suspect_host": a.suspect_host,
                })
        except Exception:
            pass

    # -- introspection ---------------------------------------------------------

    def recent_anomalies(self, *, within_s: Optional[float] = None) -> list:
        now = time.time()
        return [
            a for a in list(self.anomalies)
            if within_s is None or now - a.ts <= within_s
        ]

    def spread_state(self) -> Optional[dict]:
        """Online fleet-spread snapshot (None until ≥2 hosts reported)."""
        with self._lock:
            if len(self._spread_acc) < 2:
                return None
            median, spread = self._spread_acc.spread()
            stats = self._spread_acc.host_stats()
        return {
            "spread_ratio": round(spread, 4),
            "hosts": len(stats),
            "stragglers": [
                h for h, st in sorted(stats.items(), key=lambda kv: str(kv[0]))
                if median and st["mean_s"] > self.config.spread_threshold * median
            ],
        }

    def slice_spread_state(self) -> Optional[dict]:
        """Online slice-spread snapshot (None until ≥2 slices reported)."""
        with self._lock:
            if len(self._slice_acc) < 2:
                return None
            median, spread = self._slice_acc.spread()
            stats = self._slice_acc.host_stats()
        return {
            "spread_ratio": round(spread, 4),
            "slices": len(stats),
            "slow_slices": [
                sl for sl, st in sorted(stats.items(), key=lambda kv: str(kv[0]))
                if median
                and st["mean_s"] > self.config.slice_spread_threshold * median
            ],
        }

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "consumed": self.consumed,
                "step_streams": sorted(self._step),
                "roofline_streams": len(self._roofline),
                "slices": len(self._slice_acc),
                "critpath_steps": self._critpath["steps"],
                "critpath_dominant": self._critpath["dom"],
                "recompile_window": len(self._recompiles._ticks),
                "anomalies": [
                    dict(a.as_event_fields(), ts=round(a.ts, 3))
                    for a in list(self.anomalies)[-16:]
                ],
            }
