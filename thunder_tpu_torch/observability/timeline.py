"""Fleet critical-path ledger: skew-aligned cross-rank step timelines.

The counterpart of ``thunder_tpu/observability/timeline.py``, stdlib at
module top as there. Where the roofline ledger (``observability/roofline.py``)
explains per-op time, this module answers the fleet-level question: where
one training step's wall time goes across all ranks. A driver (the training
loop, ``chip_smoke.py``) feeds the recorder; the port's step has no hook of
its own, as the JAX package's has none.

Three layers, as in the JAX package:

1. **Clock alignment** (:func:`estimate_skew`). Each rank's event log
   carries its host's wall clock. A collective's completion is a rendezvous
   barrier, so matched ``collective`` records with a shared ``(fn, cid)``
   give one offset sample per rank per barrier (rank ts minus the fleet's
   median ts). The median offset, its MAD spread and a least-squares drift
   make a :class:`SkewEstimate` per rank with a confidence in ``(0, 1]``; a
   rank whose residuals are wide is flagged ``outlier``. Feed the offsets to
   ``analysis/events.merge_event_logs(paths, offsets=...)`` before any
   cross-rank join.

2. **Step timeline assembly** (:func:`decompose_step`,
   :func:`assemble_timeline`). Each step's per-rank spans fold into one
   breakdown of the slowest rank's lane, in the classes of :data:`CLASSES`,
   which keep the JAX package's names so that the two packages' replayed
   logs compare. On the card they mean:

   - ``compute``: the step's kernels and the host time that overlaps them;
   - ``exposed_ici``: collective time inside one node (NCCL over NVLink on
     the H100 host; the JAX package's in-slice ICI) that no compute hides;
   - ``exposed_dcn``: the exposed share of collectives that leave the node
     (NCCL over the network; the JAX package's cross-slice DCN);
   - ``straggler_wait``: the slowest rank's excess over the median lane;
   - ``stall``: checkpoint writes, recompiles and watchdog waits;
   - ``idle``: the unaccounted rest, when compute is measured.

   The classes sum to the step's wall time.

3. **Bounded ledger and detection** (:class:`CritPathLedger`,
   :class:`TimelineRecorder`). A ring of breakdowns with EWMA fractions and
   trend; each folded step feeds ``DetectorBank.note_critpath_step``, which
   raises ``bottleneck_shift`` when the dominant class flips or the
   straggler wait leaves its band. :meth:`TimelineRecorder.crosscheck` sets
   the measured exposed-collective share beside a static price and the comm
   scheduler's prediction.

Surfaces: ``monitor.critpath()``/``critpath_report()``, the
``thunder_tpu_critpath_fraction{class=}`` and ``..._clock_skew_ms`` gauges,
the always-export ``thunder_tpu_critpath_steps_total`` counter, and the
``collective``/``critpath_step`` event records. The ops plane's
``/debug/critpath`` and ``/healthz`` component come with the fleet layer
(slice 6b): :func:`debug_state` and :func:`health_state` return their dicts.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# The typed time classes of one fleet step's critical path, in report order.
CLASSES = (
    "compute",
    "exposed_ici",
    "exposed_dcn",
    "straggler_wait",
    "stall",
    "idle",
)

# Event kinds whose completion is a rendezvous barrier (offset anchors).
_BARRIER_KINDS = ("collective", "hier_all_reduce")


def _median(vals: list) -> float:
    """True median (even lists average the middle pair) — the same
    convention as HostHealthAccumulator.spread, so a 2-host fleet's slow
    half cannot be its own baseline."""
    vs = sorted(vals)
    if not vs:
        return 0.0
    mid = len(vs) // 2
    return vs[mid] if len(vs) % 2 else 0.5 * (vs[mid - 1] + vs[mid])


# =============================================================================
# Clock alignment
# =============================================================================


@dataclass
class SkewEstimate:
    """One host's clock offset vs the (re-centered) fleet-median clock.

    ``offset_s`` > 0 means this host's clock runs AHEAD of the fleet:
    subtract it from the host's timestamps before any cross-host join.
    ``mad_s`` is the median absolute residual across barrier samples — the
    estimator's own consistency check; ``confidence`` shrinks with few
    samples or wide residuals; ``outlier`` flags a host whose residuals are
    too wide for its offset to mean anything (an unstable clock)."""

    host: Any
    offset_s: float
    mad_s: float
    samples: int
    confidence: float
    drift_s_per_s: float = 0.0
    outlier: bool = False

    def as_dict(self) -> dict:
        return {
            "host": self.host,
            "offset_s": round(self.offset_s, 6),
            "mad_s": round(self.mad_s, 6),
            "samples": self.samples,
            "confidence": round(self.confidence, 4),
            "drift_s_per_s": round(self.drift_s_per_s, 9),
            "outlier": self.outlier,
        }


def collect_offset_samples(records) -> dict:
    """``{host: [(barrier_ts, offset_sample_s), ...]}`` from barrier-kind
    records. Records are grouped by ``(kind, fn, cid)`` (``cid`` falls back
    to ``step``); a group with ≥2 hosts yields, per host, ``host ts − group
    median ts``. The first record per host per group wins (a retried
    collective is a different rendezvous, not a better sample)."""
    groups: dict[tuple, dict] = {}
    for rec in records:
        if not isinstance(rec, dict) or rec.get("kind") not in _BARRIER_KINDS:
            continue
        host = rec.get("host")
        cid = rec.get("cid", rec.get("step"))
        try:
            ts = float(rec.get("ts"))
        except (TypeError, ValueError):
            continue
        if host is None or cid is None:
            continue
        key = (rec.get("kind"), rec.get("fn"), cid)
        groups.setdefault(key, {}).setdefault(host, ts)
    samples: dict[Any, list] = {}
    for per_host in groups.values():
        if len(per_host) < 2:
            continue
        ref = _median(list(per_host.values()))
        for host, ts in per_host.items():
            samples.setdefault(host, []).append((ref, ts - ref))
    return samples


def _drift_slope(pairs: list) -> float:
    """Least-squares slope of offset vs barrier time (s of skew per s of
    wall clock) — 0 with <4 samples or a degenerate time span."""
    if len(pairs) < 4:
        return 0.0
    ts = [t for t, _ in pairs]
    xs = [x for _, x in pairs]
    tm = sum(ts) / len(ts)
    xm = sum(xs) / len(xs)
    den = sum((t - tm) ** 2 for t in ts)
    if den <= 1e-9:
        return 0.0
    return sum((t - tm) * (x - xm) for t, x in zip(ts, xs)) / den


def estimate_skew(
    records,
    *,
    min_samples: int = 3,
    outlier_mad_s: float = 0.05,
    full_confidence_samples: int = 8,
) -> dict:
    """Per-host :class:`SkewEstimate` from barrier rendezvous records.

    Robust by construction: the per-barrier reference is the median host
    timestamp (one wild clock cannot drag it), the per-host offset is the
    median of its samples, and ``mad_s`` (median absolute residual) both
    feeds the confidence and flags outliers (``mad_s > outlier_mad_s`` —
    the clock is inconsistent barrier-to-barrier, so no constant offset
    describes it). Offsets are re-centered so the median non-outlier host
    sits at 0. Hosts with fewer than ``min_samples`` barriers are omitted."""
    raw = collect_offset_samples(records)
    ests: dict[Any, SkewEstimate] = {}
    for host, pairs in raw.items():
        if len(pairs) < min_samples:
            continue
        offs = [x for _, x in pairs]
        med = _median(offs)
        mad = _median([abs(x - med) for x in offs])
        outlier = mad > outlier_mad_s
        confidence = min(len(pairs), full_confidence_samples) / float(
            full_confidence_samples
        )
        confidence /= 1.0 + mad / max(outlier_mad_s, 1e-9)
        ests[host] = SkewEstimate(
            host=host,
            offset_s=med,
            mad_s=mad,
            samples=len(pairs),
            confidence=confidence,
            drift_s_per_s=_drift_slope(pairs),
            outlier=outlier,
        )
    good = [e.offset_s for e in ests.values() if not e.outlier]
    center = _median(good) if good else 0.0
    for e in ests.values():
        e.offset_s -= center
    return ests


def offsets_for_merge(estimates: dict) -> dict:
    """The plain ``{host: offset_s}`` map ``merge_event_logs(offsets=...)``
    takes (outlier hosts included: a shifted ordering beats an unshifted
    one even when the offset is noisy)."""
    return {h: e.offset_s for h, e in estimates.items()}


def apply_offsets(records, offsets: dict) -> list:
    """Copies of ``records`` with each host's offset subtracted from ``ts``
    — the cross-host join happens on aligned time, never raw clocks."""
    out = []
    for rec in records:
        if isinstance(rec, dict):
            off = offsets.get(rec.get("host"))
            if off:
                try:
                    rec = dict(rec, ts=float(rec["ts"]) - off)
                except (KeyError, TypeError, ValueError):
                    pass
        out.append(rec)
    return out


# =============================================================================
# Step decomposition
# =============================================================================


@dataclass
class StepBreakdown:
    """One fleet step's critical path, decomposed into :data:`CLASSES`.
    ``classes`` sums to ``total_s`` (the slowest host's lane = the step's
    fleet wall time under lockstep collectives)."""

    step: int
    total_s: float
    classes: dict = field(default_factory=dict)
    slowest_host: Any = None
    n_hosts: int = 0

    def fractions(self) -> dict:
        t = self.total_s
        return {c: (v / t if t > 0 else 0.0) for c, v in self.classes.items()}

    def dominant(self) -> Optional[str]:
        if not self.classes:
            return None
        return max(self.classes, key=lambda c: self.classes[c])

    def as_dict(self) -> dict:
        return {
            "step": self.step,
            "total_s": round(self.total_s, 6),
            "classes": {c: round(v, 6) for c, v in self.classes.items()},
            "slowest_host": self.slowest_host,
            "n_hosts": self.n_hosts,
        }


def decompose_step(step: int, host_spans: dict) -> Optional[StepBreakdown]:
    """Fold per-host spans for one global step into a critical-path
    breakdown.

    ``host_spans``: ``{host: {"total_s": wall seconds (required),
    "ici_s"/"dcn_s"/"stall_s"/"compute_s": typed seconds (optional)}}``.
    The slowest host's lane is the critical path: ``straggler_wait`` is its
    excess over the fleet-median lane (what every other host spends blocked
    at the next collective), and the median-lane budget splits into the
    slowest host's typed spans. When ``compute_s`` is measured, the
    unaccounted remainder is ``idle``; otherwise compute absorbs it (typed
    spans are capped, proportionally, at the budget — accounting must sum
    to the wall time). None when no host reported a positive total."""
    totals = {}
    for host, sp in host_spans.items():
        try:
            t = float(sp["total_s"])
        except (KeyError, TypeError, ValueError):
            continue
        if t > 0:
            totals[host] = t
    if not totals:
        return None
    slowest = max(totals, key=lambda h: totals[h])
    total = totals[slowest]
    median = _median(list(totals.values()))
    straggler = max(0.0, total - median)
    budget = total - straggler  # the median-lane window
    sp = host_spans.get(slowest) or {}

    def span(key):
        try:
            return max(0.0, float(sp.get(key) or 0.0))
        except (TypeError, ValueError):
            return 0.0

    ici, dcn, stall = span("ici_s"), span("dcn_s"), span("stall_s")
    compute = span("compute_s") if sp.get("compute_s") is not None else None
    typed = ici + dcn + stall + (compute or 0.0)
    if typed > budget > 0:
        scale = budget / typed
        ici, dcn, stall = ici * scale, dcn * scale, stall * scale
        if compute is not None:
            compute *= scale
        typed = budget
    if compute is None:
        compute = max(0.0, budget - ici - dcn - stall)
        idle = 0.0
    else:
        idle = max(0.0, budget - typed)
    return StepBreakdown(
        step=int(step),
        total_s=total,
        classes={
            "compute": compute,
            "exposed_ici": ici,
            "exposed_dcn": dcn,
            "straggler_wait": straggler,
            "stall": stall,
            "idle": idle,
        },
        slowest_host=slowest,
        n_hosts=len(totals),
    )


# =============================================================================
# Bounded ledger
# =============================================================================


class CritPathLedger:
    """Bounded ring of :class:`StepBreakdown` + EWMA class fractions.

    Per class it tracks a fast EWMA (the live fraction the gauges export)
    and a slow EWMA; ``trend()`` is fast − slow per class, so a class
    *taking over* shows positive before the dominant flip lands. Locked:
    the recorder folds from the training thread while /debug/critpath
    snapshots from the ops server thread."""

    def __init__(self, capacity: int = 512, alpha: float = 0.2):
        self.ring: deque = deque(maxlen=int(capacity))
        self.alpha = float(alpha)
        self.steps = 0
        self._fast: dict[str, float] = {}
        self._slow: dict[str, float] = {}
        self._totals: dict[str, float] = {}
        self._straggler_hosts: dict[Any, int] = {}
        self._lock = threading.Lock()

    def fold(self, bd: StepBreakdown) -> None:
        fr = bd.fractions()
        with self._lock:
            self.ring.append(bd)
            self.steps += 1
            for c, f in fr.items():
                prev = self._fast.get(c)
                self._fast[c] = f if prev is None else prev + self.alpha * (f - prev)
                prev = self._slow.get(c)
                slow_a = self.alpha * 0.25
                self._slow[c] = f if prev is None else prev + slow_a * (f - prev)
                self._totals[c] = self._totals.get(c, 0.0) + bd.classes.get(c, 0.0)
            if bd.classes.get("straggler_wait", 0.0) > 0 and bd.slowest_host is not None:
                self._straggler_hosts[bd.slowest_host] = (
                    self._straggler_hosts.get(bd.slowest_host, 0) + 1
                )

    def fractions(self) -> dict:
        with self._lock:
            return dict(self._fast)

    def trend(self) -> dict:
        with self._lock:
            return {
                c: self._fast[c] - self._slow.get(c, self._fast[c])
                for c in self._fast
            }

    def dominant(self) -> Optional[str]:
        fr = self.fractions()
        return max(fr, key=fr.get) if fr else None

    def totals(self) -> dict:
        with self._lock:
            return dict(self._totals)

    def snapshot(self, last: int = 8) -> dict:
        with self._lock:
            ring = list(self.ring)
            out = {
                "steps": self.steps,
                "fractions": {c: round(f, 4) for c, f in self._fast.items()},
                "trend": {
                    c: round(self._fast[c] - self._slow.get(c, self._fast[c]), 4)
                    for c in self._fast
                },
                "totals_s": {c: round(v, 6) for c, v in self._totals.items()},
                "straggler_hosts": dict(self._straggler_hosts),
            }
        out["dominant"] = (
            max(out["fractions"], key=out["fractions"].get)
            if out["fractions"] else None
        )
        out["last_steps"] = [bd.as_dict() for bd in ring[-last:]]
        return out

    def format(self) -> str:
        snap = self.snapshot()
        lines = [
            f"critical path over {snap['steps']} fleet steps "
            f"(dominant: {snap['dominant']})",
            f"  {'class':<16} {'ewma_frac':>10} {'trend':>8} {'total_s':>10}",
        ]
        for c in CLASSES:
            if c not in snap["fractions"]:
                continue
            lines.append(
                f"  {c:<16} {snap['fractions'][c]:>10.3f} "
                f"{snap['trend'][c]:>+8.3f} {snap['totals_s'].get(c, 0.0):>10.4f}"
            )
        if snap["straggler_hosts"]:
            worst = max(snap["straggler_hosts"], key=snap["straggler_hosts"].get)
            lines.append(
                f"  straggler-wait attributed to: {worst} "
                f"({snap['straggler_hosts'][worst]}/{snap['steps']} steps)"
            )
        return "\n".join(lines)


# =============================================================================
# The in-loop recorder
# =============================================================================


class TimelineRecorder:
    """The live half of the ledger: fleet drivers feed it per-step spans
    and per-barrier collective records; it folds breakdowns, exports the
    gauges, emits ``critpath_step``/``collective`` events, and streams
    class fractions into ``DetectorBank.note_critpath_step``.

    ``emulated_skew_s`` injects known per-host clock offsets onto emitted
    barrier timestamps — an emulated single-process fleet shares one clock,
    so without injection the alignment loop would be vacuously correct; with
    it, the estimator must *recover* the injected offsets, and the tests
    hold the recovery error (a falsifiable instrument, not a tautology).
    On the card each rank is a process of its own, sharing the host's
    clock with the others, so the injection is what the estimator finds.
    ``host_label`` maps span keys to the suspect-host spelling the
    detectors report.

    Skew estimates are recomputed lazily (a dirty flag set per barrier
    record, resolved at report/debug/health time) so the per-step hot-path
    cost stays O(classes).

    ``event_sample`` duty-cycles the *emitted* side only: ``collective`` /
    ``critpath_step`` events and the gauge export fire for 1-in-N
    rendezvous/step ids (deterministic by id, so a sampled barrier is
    sampled on EVERY host and offline alignment groups stay complete).
    The in-process estimator, ledger, and detector feed always see every
    barrier and every step — sampling trades offline log density for
    hot-path cost at scale, never measurement fidelity."""

    def __init__(
        self,
        *,
        capacity: int = 512,
        alpha: float = 0.2,
        bank=None,
        emit_events: bool = True,
        event_sample: int = 1,
        emulated_skew_s: Optional[dict] = None,
        host_label: Optional[Callable[[Any], str]] = None,
        skew_min_samples: int = 3,
        skew_outlier_mad_s: float = 0.05,
        max_skew_groups: int = 256,
        static_exposed_pct: Optional[float] = None,
        predicted_exposed_pct: Optional[float] = None,
    ):
        self.ledger = CritPathLedger(capacity=capacity, alpha=alpha)
        self.bank = bank
        self.emit_events = bool(emit_events)
        self.event_sample = max(1, int(event_sample))
        self.emulated_skew_s = dict(emulated_skew_s or {})
        self._label = host_label or str
        self.skew_min_samples = int(skew_min_samples)
        self.skew_outlier_mad_s = float(skew_outlier_mad_s)
        self.static_exposed_pct = static_exposed_pct
        self.predicted_exposed_pct = predicted_exposed_pct
        self._wire_fracs = (0.0, 0.0)  # (ici, dcn) static shares of compute work
        self._groups: deque = deque(maxlen=int(max_skew_groups))
        self._open: dict[tuple, dict] = {}
        self._hosts_seen: set = set()
        self._skew: dict = {}
        self._skew_dirty = False
        self._lock = threading.Lock()

    def _sampled(self, key) -> bool:
        """Deterministic 1-in-``event_sample`` pick by rendezvous/step id —
        id-keyed (not call-counted) so every host agrees on which barriers
        get emitted and offline groups stay complete. Non-integer ids are
        always emitted (no cross-host-stable hash for them)."""
        if self.event_sample == 1:
            return True
        try:
            return int(key) % self.event_sample == 0
        except (TypeError, ValueError):
            return True

    # -- static wire pricing ---------------------------------------------------

    def set_static_wire(
        self,
        ici_frac: float,
        dcn_frac: float,
        *,
        static_exposed_pct: Optional[float] = None,
    ) -> None:
        """Install a static wire split: per-tier shares of one step's work
        the driver uses to charge ``exposed_ici`` / ``exposed_dcn`` when
        per-leg measurements are unavailable, plus the static exposed-pct
        the cross-check compares the measured ledger against (the JAX
        package prices them from its HLO audit; the port has no HLO, and a
        driver may price them from ``analysis/cost.py``)."""
        self._wire_fracs = (max(0.0, float(ici_frac)), max(0.0, float(dcn_frac)))
        if static_exposed_pct is not None:
            self.static_exposed_pct = float(static_exposed_pct)

    def static_spans(self, work_s: float) -> dict:
        """Split ``work_s`` of one host's compute-step time by the static
        wire fractions: ``{"ici_s", "dcn_s", "compute_s"}``."""
        ici_f, dcn_f = self._wire_fracs
        ici = work_s * ici_f
        dcn = work_s * dcn_f
        return {
            "ici_s": ici,
            "dcn_s": dcn,
            "compute_s": max(0.0, work_s - ici - dcn),
        }

    # -- barrier records (clock-alignment anchors) -----------------------------

    def note_collective(
        self,
        host: Any,
        cid: Any,
        *,
        fn: str = "train_step",
        s: float = 0.0,
        in_slice_s: float = 0.0,
        cross_slice_s: float = 0.0,
        step: Optional[int] = None,
    ) -> None:
        """One host's completion of rendezvous ``(fn, cid)``. The emitted
        ``collective`` event's ``ts`` carries the host's (possibly
        emulated-skewed) clock; the sample feeds the in-process skew
        estimator."""
        ts = time.time() + float(self.emulated_skew_s.get(host, 0.0))
        with self._lock:
            self._hosts_seen.add(host)
            key = (fn, cid)
            group = self._open.get(key)
            if group is None:
                group = self._open[key] = {}
                while len(self._open) > 8:
                    oldest = next(iter(self._open))
                    self._groups.append(self._open.pop(oldest))
            group.setdefault(host, ts)
            self._skew_dirty = True
        if self.emit_events and self._sampled(cid):
            try:
                from thunder_tpu_torch.observability.events import emit_event

                fields = {
                    "fn": fn, "cid": cid, "s": round(float(s), 6),
                    "host": host, "ts": ts,
                }
                if in_slice_s:
                    fields["in_slice_s"] = round(float(in_slice_s), 6)
                if cross_slice_s:
                    fields["cross_slice_s"] = round(float(cross_slice_s), 6)
                if step is not None:
                    fields["step"] = int(step)
                emit_event("collective", **fields)
            except Exception:
                pass

    def skew_estimates(self) -> dict:
        """Per-host :class:`SkewEstimate` over the barrier samples seen so
        far (lazily recomputed)."""
        with self._lock:
            if not self._skew_dirty:
                return dict(self._skew)
            groups = list(self._groups) + list(self._open.values())
            self._skew_dirty = False
        records = []
        for i, per_host in enumerate(groups):
            for host, ts in per_host.items():
                records.append(
                    {"kind": "collective", "fn": "_", "cid": i, "host": host,
                     "ts": ts}
                )
        ests = estimate_skew(
            records,
            min_samples=self.skew_min_samples,
            outlier_mad_s=self.skew_outlier_mad_s,
        )
        with self._lock:
            self._skew = ests
        try:
            from thunder_tpu_torch.observability import metrics as obsm

            if obsm.enabled():
                for h, e in ests.items():
                    obsm.CRITPATH_SKEW_MS.set(
                        e.offset_s * 1e3, host=self._label(h)
                    )
        except Exception:
            pass
        return dict(ests)

    # -- per-step fold ---------------------------------------------------------

    def record_step(self, step: int, host_spans: dict) -> Optional[StepBreakdown]:
        """Fold one fleet step (``host_spans`` as in :func:`decompose_step`)
        into the ledger; export gauges, emit the ``critpath_step`` event,
        and stream fractions into the detector bank. Returns the breakdown
        (None when no host reported)."""
        bd = decompose_step(step, host_spans)
        if bd is None:
            return None
        with self._lock:
            self._hosts_seen.update(host_spans)
        self.ledger.fold(bd)
        fractions = bd.fractions()
        slowest = self._label(bd.slowest_host)
        sampled = self._sampled(step)
        try:
            from thunder_tpu_torch.observability import metrics as obsm

            obsm.CRITPATH_STEPS.inc_always()
            if sampled and obsm.enabled():
                # EWMA fractions change slowly vs any scrape interval, so
                # the gauge refresh rides the same duty cycle as events.
                for c, f in self.ledger.fractions().items():
                    obsm.CRITPATH_FRACTION.set(f, **{"class": c})
        except Exception:
            pass
        if self.emit_events and sampled:
            try:
                from thunder_tpu_torch.observability.events import emit_event

                emit_event(
                    "critpath_step",
                    step=bd.step,
                    total_s=round(bd.total_s, 6),
                    classes={c: round(v, 6) for c, v in bd.classes.items()},
                    slowest_host=slowest,
                    n_hosts=bd.n_hosts,
                )
            except Exception:
                pass
        if self.bank is not None:
            try:
                self.bank.note_critpath_step(
                    bd.step, fractions, slowest_host=slowest
                )
            except Exception:
                pass
        return bd

    # -- cross-checks and reporting --------------------------------------------

    def measured_exposed_pct(self) -> Optional[float]:
        """Exposed-collective share of the critical path's *working* time
        (compute + exposed wire; straggler/stall/idle excluded so the
        number is commensurable with the HLO auditor's static
        ``exposed_pct`` and the comm scheduler's prediction)."""
        fr = self.ledger.fractions()
        wire = fr.get("exposed_ici", 0.0) + fr.get("exposed_dcn", 0.0)
        denom = fr.get("compute", 0.0) + wire
        if denom <= 0:
            return None
        return 100.0 * wire / denom

    def crosscheck(self) -> dict:
        """Static-vs-measured exposed-collective disagreement, surfaced as
        numbers: the measured ledger share vs the HLO auditor's static
        price and the comm scheduler's predicted exposed-pct."""
        measured = self.measured_exposed_pct()
        out: dict[str, Any] = {
            "measured_exposed_pct": None if measured is None else round(measured, 3)
        }
        if self.static_exposed_pct is not None:
            out["static_exposed_pct"] = round(self.static_exposed_pct, 3)
            if measured is not None:
                out["delta_static_pct"] = round(measured - self.static_exposed_pct, 3)
        if self.predicted_exposed_pct is not None:
            out["predicted_exposed_pct"] = round(self.predicted_exposed_pct, 3)
            if measured is not None:
                out["delta_predicted_pct"] = round(
                    measured - self.predicted_exposed_pct, 3
                )
        return out

    def health_state(self) -> dict:
        """The /healthz ``timeline`` component's raw state: host count,
        folded steps, and the weakest non-outlier alignment confidence."""
        ests = self.skew_estimates()
        with self._lock:
            hosts = len(self._hosts_seen)
        good = [e.confidence for e in ests.values() if not e.outlier]
        return {
            "enabled": True,
            "hosts": hosts,
            "steps": self.ledger.steps,
            "min_confidence": round(min(good), 4) if good else None,
            "outlier_hosts": sorted(
                (self._label(h) for h, e in ests.items() if e.outlier), key=str
            ),
        }

    def debug_state(self) -> dict:
        """The ``GET /debug/critpath`` payload."""
        out = {
            "enabled": True,
            "ledger": self.ledger.snapshot(),
            "skew": {
                self._label(h): e.as_dict()
                for h, e in sorted(
                    self.skew_estimates().items(), key=lambda kv: str(kv[0])
                )
            },
            "crosscheck": self.crosscheck(),
        }
        out["health"] = self.health_state()
        return out

    def format_report(self) -> str:
        """The printable spelling of /debug/critpath: ledger table + skew
        estimates + the static-vs-measured cross-check."""
        lines = [self.ledger.format()]
        ests = self.skew_estimates()
        if ests:
            lines.append("  clock skew (vs fleet-median clock):")
            for h, e in sorted(ests.items(), key=lambda kv: str(kv[0])):
                flag = "  OUTLIER" if e.outlier else ""
                lines.append(
                    f"    {self._label(h):<10} offset {e.offset_s * 1e3:+8.2f} ms"
                    f"  mad {e.mad_s * 1e3:6.2f} ms  conf {e.confidence:.2f}"
                    f"  n={e.samples}{flag}"
                )
        cc = self.crosscheck()
        if cc.get("measured_exposed_pct") is not None:
            parts = [f"measured {cc['measured_exposed_pct']:.1f}%"]
            if "static_exposed_pct" in cc:
                parts.append(
                    f"static {cc['static_exposed_pct']:.1f}% "
                    f"(Δ {cc.get('delta_static_pct', 0.0):+.1f})"
                )
            if "predicted_exposed_pct" in cc:
                parts.append(
                    f"scheduler {cc['predicted_exposed_pct']:.1f}% "
                    f"(Δ {cc.get('delta_predicted_pct', 0.0):+.1f})"
                )
            lines.append("  exposed-collective: " + ", ".join(parts))
        return "\n".join(lines)


# =============================================================================
# Offline assembly (merged logs -> breakdowns)
# =============================================================================


def assemble_timeline(
    records,
    *,
    skew: Optional[dict] = None,
    min_skew_samples: int = 3,
    outlier_mad_s: float = 0.05,
) -> tuple:
    """Offline twin of the recorder: fold merged (or to-be-merged) event
    records into per-step breakdowns. Estimates per-host skew from the
    barrier records (unless ``skew`` supplies estimates), aligns timestamps,
    then assembles per-step host spans from ``step_time`` (wall),
    ``collective`` (wire legs), ``snapshot`` (stall), recompile
    ``compile_end`` and ``collective_timeout`` (stall at the host's last
    seen step). Returns ``(breakdowns, skew_estimates)``."""
    recs = [r for r in records if isinstance(r, dict)]
    ests = skew if skew is not None else estimate_skew(
        recs, min_samples=min_skew_samples, outlier_mad_s=outlier_mad_s
    )
    if ests:
        recs = apply_offsets(recs, offsets_for_merge(ests))
    spans: dict[int, dict] = {}
    last_step: dict[Any, int] = {}

    def span(step, host):
        return spans.setdefault(int(step), {}).setdefault(
            host, {"total_s": 0.0, "ici_s": 0.0, "dcn_s": 0.0, "stall_s": 0.0}
        )

    def fnum(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return 0.0

    for rec in recs:
        kind = rec.get("kind")
        host = rec.get("host")
        if kind == "step_time" and rec.get("step") is not None:
            sp = span(rec["step"], host)
            sp["total_s"] += fnum(rec.get("s"))
            last_step[host] = int(rec["step"])
        elif kind in _BARRIER_KINDS:
            step = rec.get("step", rec.get("cid"))
            if step is None:
                continue
            try:
                step = int(step)
            except (TypeError, ValueError):
                continue
            sp = span(step, host)
            in_s = fnum(rec.get("in_slice_s"))
            cross_s = fnum(rec.get("cross_slice_s"))
            if not in_s and not cross_s:
                in_s = fnum(rec.get("s"))
            sp["ici_s"] += in_s
            sp["dcn_s"] += cross_s
            last_step[host] = step
        elif kind == "snapshot" and rec.get("step") is not None:
            span(rec["step"], host)["stall_s"] += fnum(rec.get("stall_ms")) / 1e3
        elif kind == "compile_end" and rec.get("recompile"):
            if host in last_step:
                span(last_step[host], host)["stall_s"] += fnum(rec.get("ms")) / 1e3
        elif kind == "collective_timeout":
            if host in last_step:
                span(last_step[host], host)["stall_s"] += fnum(rec.get("timeout_s"))
    breakdowns = []
    for step in sorted(spans):
        bd = decompose_step(step, spans[step])
        if bd is not None:
            breakdowns.append(bd)
    return breakdowns, ests


def ledger_from_records(records, **kw) -> tuple:
    """Fold :func:`assemble_timeline`'s breakdowns into a fresh
    :class:`CritPathLedger` — the lint smoke's offline path. Returns
    ``(ledger, breakdowns, skew_estimates)``."""
    breakdowns, ests = assemble_timeline(records, **kw)
    ledger = CritPathLedger()
    for bd in breakdowns:
        ledger.fold(bd)
    return ledger, breakdowns, ests


# =============================================================================
# Static wire-tier split (HLO auditor join)
# =============================================================================


def split_static_wire(sites, devices_per_slice: int) -> dict:
    """Split collective sites (each with ``wire_us`` and ``group_size``)
    into interconnect tiers by group size: a group that fits inside one
    node (``devices_per_slice`` cards: NVLink) is charged to ``ici``, a
    larger (or unknown-size) one to ``dcn`` (the network between nodes). A
    group of exactly ``devices_per_slice`` devices *could* be a cross-node
    DP group of the same cardinality — the heuristic charges it to ICI
    (conservative: understates DCN), which the cross-check's delta then
    carries as measurement disagreement rather than hiding. Returns wire
    microseconds and fractions per tier."""
    dps = max(1, int(devices_per_slice))
    ici_us = dcn_us = 0.0
    for site in sites:
        wire = float(getattr(site, "wire_us", 0.0) or 0.0)
        size = getattr(site, "group_size", None)
        if size is not None and int(size) <= dps:
            ici_us += wire
        else:
            dcn_us += wire
    total = ici_us + dcn_us
    return {
        "ici_us": round(ici_us, 3),
        "dcn_us": round(dcn_us, 3),
        "ici_frac": round(ici_us / total, 6) if total else 0.0,
        "dcn_frac": round(dcn_us / total, 6) if total else 0.0,
    }


# =============================================================================
# Module lifecycle (the roofline pattern: one process-wide recorder)
# =============================================================================

_state: dict = {"recorder": None}


def current() -> Optional[TimelineRecorder]:
    return _state["recorder"]


def enable(**options) -> TimelineRecorder:
    """Install the process-wide recorder (options forward to
    :class:`TimelineRecorder`). Installing a DetectorBank-armed recorder is
    how ``bottleneck_shift`` reaches the autopilot."""
    rec = TimelineRecorder(**options)
    _state["recorder"] = rec
    return rec


def disable() -> None:
    _state["recorder"] = None


def debug_state() -> dict:
    rec = current()
    return rec.debug_state() if rec is not None else {"enabled": False}


def health_state() -> Optional[dict]:
    rec = current()
    return rec.health_state() if rec is not None else None
