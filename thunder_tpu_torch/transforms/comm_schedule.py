"""Certificate-driven static collective-overlap scheduler.

The counterpart of ``thunder_tpu/transforms/comm_schedule.py``. The schedule
certificate (``analysis/schedule.py``) gives each collective site of a
claimed trace its legal placement interval ``[earliest, latest]`` under data
dependencies, future/wait pairing, per-axis program order and in-place
anti-dependencies. This pass prices candidate placements with the cost model
(``analysis/cost.py``: wire time against the roofline time of the compute a
placement would overlap) and moves each site to maximize its predicted
hidden wire time:

- an fsdp ``synchronize`` (a trace-level all-gather) hoists ahead of the
  compute before its consuming GEMM: a prefetch in flight while earlier
  layers compute;
- a grad ``reduce_scatter`` is consumed only by the return, so its window
  already spans the rest of the backward; it stays put.

In the JAX package the pass is a no-op on the sharded step, whose
collectives GSPMD places. In the port it acts there: the sharded step's
fsdp gathers and tp reductions are trace-level
(``parallel/train.py``). A move only reorders the trace inside certified
intervals, so every result keeps its bits.

Moves are held by the liveness planner (``analysis/liveness.py``): a
hoisted gather materializes the full tensor earlier, so a move that pushes
the predicted peak past the device's capacity is walked back toward its
original position until the plan fits (a back-off). Every rewrite is
re-stamped through ``schedule.recertify`` (the one pass licensed to re-bless
a collective order); the ``sched.exposed-collective`` rule reports each
site's predicted hidden and exposed µs.

The pass is advisory: an internal failure falls back to the unscheduled
trace and emits a ``sharp_edge`` event (``policy="comm_schedule_fallback"``),
the JAX package's logged policy; it never happens silently. The chaos
``sched_bad`` seam and the de-opt ladder that disables the pass come with
the resilience slice of the port. Kill switch: ``THUNDER_TPU_COMM_SCHEDULE=0``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, wrap_in_trace_provenance

ENV_KNOB = "THUNDER_TPU_COMM_SCHEDULE"

PASS_NAME = "Comm schedule"


def enabled(default: bool = True) -> bool:
    """Whether the scheduler runs (``THUNDER_TPU_COMM_SCHEDULE``; default
    on — the pass is a no-op on traces without collectives)."""
    v = os.environ.get(ENV_KNOB, "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "off", "no")


class PlacementError(ValueError):
    """A requested placement falls outside the site's certified
    ``[earliest, latest]`` interval — applying it could deadlock the mesh
    (cross-host order divergence) or read stale buffers."""


@dataclass
class SiteMove:
    """One site's scheduling outcome (JSON-able via ``to_dict``)."""

    key: str
    sym: str
    axis: Optional[str]
    index_before: int
    index_after: int
    earliest: int
    latest: int
    first_consumer: Optional[int]
    wire_us: float
    hidden_us_before: float
    hidden_us_after: float
    window_us_after: float
    backed_off: bool = False
    # True only when the SCHEDULER placed this site (a site can still drift
    # by an index when another site is hoisted across it — not a move).
    moved: bool = False

    @property
    def exposed_us_after(self) -> float:
        return max(0.0, self.wire_us - self.hidden_us_after)

    def to_dict(self) -> dict:
        return {
            "key": self.key, "sym": self.sym, "axis": self.axis,
            "from": self.index_before, "to": self.index_after,
            "earliest": self.earliest, "latest": self.latest,
            "first_consumer": self.first_consumer,
            "wire_us": round(self.wire_us, 3),
            "hidden_us_before": round(self.hidden_us_before, 3),
            "hidden_us_after": round(self.hidden_us_after, 3),
            "exposed_us_after": round(self.exposed_us_after, 3),
            "window_us_after": round(self.window_us_after, 3),
            "moved": self.moved, "backed_off": self.backed_off,
        }


@dataclass
class CommSchedule:
    """The pass's report: per-site moves + trace-level predicted overlap,
    stamped on the scheduled trace as ``tags["comm_schedule"]`` (a plain
    dict) for the bench/cache_info to read."""

    device: str
    sites: list = field(default_factory=list)   # SiteMove
    predicted_peak_bytes_before: Optional[int] = None
    predicted_peak_bytes_after: Optional[int] = None
    capacity_bytes: Optional[int] = None

    @property
    def moves(self) -> int:
        return sum(1 for s in self.sites if s.moved)

    @property
    def backoffs(self) -> int:
        return sum(1 for s in self.sites if s.backed_off)

    @property
    def wire_us(self) -> float:
        return sum(s.wire_us for s in self.sites)

    @property
    def hidden_us_before(self) -> float:
        return sum(s.hidden_us_before for s in self.sites)

    @property
    def hidden_us_after(self) -> float:
        return sum(s.hidden_us_after for s in self.sites)

    @property
    def exposed_pct_before(self) -> float:
        w = self.wire_us
        return (w - self.hidden_us_before) / w * 100.0 if w else 0.0

    @property
    def exposed_pct_after(self) -> float:
        w = self.wire_us
        return (w - self.hidden_us_after) / w * 100.0 if w else 0.0

    def to_tag(self) -> dict:
        return {
            "device": self.device,
            "moves": self.moves,
            "backoffs": self.backoffs,
            "wire_us": round(self.wire_us, 3),
            "hidden_us_before": round(self.hidden_us_before, 3),
            "hidden_us_after": round(self.hidden_us_after, 3),
            "exposed_pct_before": round(self.exposed_pct_before, 2),
            "exposed_pct_after": round(self.exposed_pct_after, 2),
            "predicted_peak_bytes_before": self.predicted_peak_bytes_before,
            "predicted_peak_bytes_after": self.predicted_peak_bytes_after,
            "capacity_bytes": self.capacity_bytes,
            "sites": [s.to_dict() for s in self.sites],
        }

    def format(self) -> str:
        lines = [
            f"comm schedule [{self.device}]: {self.moves} move(s), "
            f"{self.backoffs} back-off(s); predicted exposed "
            f"{self.exposed_pct_before:.1f}% -> {self.exposed_pct_after:.1f}% "
            f"of {self.wire_us:.1f}us wire",
        ]
        for s in self.sites:
            arrow = (f"L{s.index_before}->L{s.index_after}" if s.moved
                     else f"L{s.index_before} (pinned)" if s.earliest == s.latest
                     else f"L{s.index_before}")
            note = " BACKED-OFF" if s.backed_off else ""
            lines.append(
                f"  {s.sym:<16} [{s.axis or '-':<5}] {arrow:<12} "
                f"wire {s.wire_us:>8.2f}us hidden {s.hidden_us_before:>8.2f}"
                f"->{s.hidden_us_after:<8.2f}us{note}"
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()


def _move(bsyms: list, i: int, p: int) -> list:
    """A new bsym list with the op at ``i`` re-placed at position ``p``."""
    out = list(bsyms)
    b = out.pop(i)
    out.insert(p, b)
    return out


def _validate_placement(site, position: int) -> None:
    """THE interval check — one copy, shared by :func:`apply_placement`
    and the scheduler's own move application, so the seeded-bad rejection
    cannot drift between the two."""
    if not (site.earliest <= position <= site.latest):
        raise PlacementError(
            f"placement L{position} for {site.key} outside its certified "
            f"interval [L{site.earliest}, L{site.latest}] — refusing an "
            "unprovable reorder"
        )


def apply_placement(trace: TraceCtx, site_key: str, position: int) -> TraceCtx:
    """Move one collective site to ``position``, validating against a fresh
    certificate: a placement outside the site's ``[earliest, latest]``
    interval raises :class:`PlacementError` (the seeded-bad rejection the
    scheduler and its tests rely on). Returns a new re-certified trace."""
    from thunder_tpu_torch.analysis import schedule as sched_mod

    cert = sched_mod.certify(trace)
    site = next((s for s in cert.sites if s.key == site_key), None)
    if site is None:
        raise PlacementError(f"no collective site with key {site_key!r}")
    _validate_placement(site, position)
    new = from_trace(trace)
    new.bound_symbols = _move(list(trace.bound_symbols), site.index, position)
    sched_mod.recertify(new)
    return new


def schedule_collectives(
    trace: TraceCtx,
    *,
    device: Any = None,
    capacity_bytes: Optional[int] = None,
) -> tuple[TraceCtx, Optional[CommSchedule]]:
    """Schedule ``trace``'s collectives for compute/comm overlap.

    Returns ``(scheduled trace, report)``. The input trace is returned
    unchanged (report may still be attached) when there is nothing to move;
    on any internal failure the unscheduled trace comes back with a
    ``sharp_edge`` event — the pass is advisory and must never break a
    compile. Run it on the **claimed, pre-del** execution trace (explicit
    ``python_del``s would need re-derivation; ``del_last_used`` runs after).

    ``capacity_bytes`` overrides the detected device capacity for the
    liveness back-off. The JAX package also takes shard divisors of the
    inputs; the port traces each rank's program on its own blocks, so the
    liveness plan prices per-rank bytes as it is."""
    start = time.perf_counter_ns()
    try:
        return _schedule(trace, device=device, capacity_bytes=capacity_bytes,
                         start_ns=start)
    except Exception as e:  # noqa: BLE001 — advisory: fall back, never wedge
        try:
            from thunder_tpu_torch.observability import events as obs_events

            obs_events.emit_event(
                "sharp_edge",
                message=(
                    f"comm_schedule rejected for {trace.name}: "
                    f"{type(e).__name__}: {e} — compiling the unscheduled "
                    "certified order"
                ),
                policy="comm_schedule_fallback",
            )
        except Exception:  # noqa: BLE001
            pass
        return trace, None


def _schedule(trace: TraceCtx, *, device, capacity_bytes,
              start_ns) -> tuple[TraceCtx, Optional[CommSchedule]]:
    from thunder_tpu_torch.analysis import schedule as sched_mod
    from thunder_tpu_torch.analysis.cost import resolve_device_spec
    from thunder_tpu_torch.analysis.liveness import device_capacity_bytes, plan_liveness
    from thunder_tpu_torch.distributed.prims import is_collective_bsym

    bsyms = list(trace.bound_symbols)
    if not any(is_collective_bsym(b) for b in bsyms):
        return trace, None
    if any(b.sym.id is PrimIDs.DEL for b in bsyms):
        # Scheduling runs pre-del (the pipeline's del_last_used re-derives
        # dels afterwards); a del-carrying trace would need its dels moved
        # with the ops — refuse rather than risk a stale free.
        return trace, None

    dev = resolve_device_spec(device)
    capacity = capacity_bytes if capacity_bytes is not None else (
        device_capacity_bytes(dev)
    )

    def plan_peak(bs) -> Optional[int]:
        cand = from_trace(trace)
        cand.bound_symbols = bs
        return int(plan_liveness(cand, device=dev, include_rows=False).peak_bytes)

    report = CommSchedule(device=dev.name)
    base_pred = sched_mod.predict_overlap(
        _as_trace(trace, bsyms), device=dev
    )
    try:
        base_peak = plan_peak(bsyms)
    except Exception:  # noqa: BLE001 — no liveness means no back-off, not no pass
        base_peak = None
    report.predicted_peak_bytes_before = base_peak
    report.capacity_bytes = int(capacity) if capacity else None

    # Sites by descending wire time: the biggest transfers claim the compute
    # budget (and the liveness headroom) first.
    order = [s.key for s in sorted(base_pred.sites, key=lambda s: -s.wire_us)]
    cur_peak = base_peak
    moves: dict[str, SiteMove] = {}

    # cert/pred only change when a move lands — recompute on demand, not
    # per site (a deep trace has dozens of sites; each recompute is a full
    # O(trace) analysis inside the timed static_analysis phase).
    cert = pred = None

    for key in order:
        if cert is None:
            cert = sched_mod.certify(_as_trace(trace, bsyms))
            pred = sched_mod.predict_overlap(
                _as_trace(trace, bsyms), device=dev, cert=cert
            )
        site = next((s for s in cert.sites if s.key == key), None)
        so = pred.by_key().get(key)
        if site is None or so is None:
            continue
        move = SiteMove(
            key=key, sym=site.sym, axis=site.axis,
            index_before=site.index, index_after=site.index,
            earliest=site.earliest, latest=site.latest,
            first_consumer=site.first_consumer,
            wire_us=so.wire_us, hidden_us_before=so.hidden_us,
            hidden_us_after=so.hidden_us, window_us_after=so.window_us,
        )
        moves[key] = move
        if so.wire_us <= 0.0 or site.first_consumer is None:
            continue
        if so.hidden_us >= so.wire_us or site.earliest >= site.index:
            continue  # already fully hidden, or nowhere to hoist

        # Hoist: latest position whose grown window fully hides the wire;
        # all the way to `earliest` when none does (maximal window). New
        # window rows are priced at the prediction's RESIDUAL budget, so a
        # GEMM an earlier (bigger-wire) site already claimed is not counted
        # toward this site's hiding.
        p = site.earliest
        gained = 0.0
        for q in range(site.index - 1, site.earliest - 1, -1):
            gained += pred.residual_budget.get(q, 0.0)
            if so.hidden_us + gained >= so.wire_us:
                p = q
                break
        _validate_placement(site, p)

        # Liveness back-off: retreat the hoist toward the original index
        # until the predicted per-device peak fits the capacity (a hoisted
        # gather materializes the full tensor earlier — the plan sees it).
        # The peak is non-increasing as the placement retreats, so binary
        # search finds the deepest fitting hoist in O(log distance) plans
        # instead of one O(trace) replan per index.
        def peak_at(pos):
            try:
                return plan_peak(_move(bsyms, site.index, pos))
            except Exception:  # noqa: BLE001
                return None

        def fits(pos) -> bool:
            if not capacity or cur_peak is None:
                return True
            peak = peak_at(pos)
            return peak is None or peak <= capacity or peak <= cur_peak

        wanted = p
        if not fits(p):
            lo, hi = p + 1, site.index  # fits(site.index) trivially: no move
            while lo < hi:
                mid = (lo + hi) // 2
                if fits(mid):
                    hi = mid
                else:
                    lo = mid + 1
            p = hi
        move.backed_off = p != wanted
        if p >= site.index:
            continue  # backed off all the way: no move survives the squeeze
        chosen = (_move(bsyms, site.index, p), peak_at(p))
        bsyms, cur_peak = chosen[0], (
            chosen[1] if chosen[1] is not None else cur_peak
        )
        move.index_after = p
        move.moved = True
        cert = pred = None  # positions shifted: re-derive before the next site

    if not any(m.moved for m in moves.values()):
        report.sites = [moves[k] for k in sorted(moves, key=lambda k: moves[k].index_before)]
        report.predicted_peak_bytes_after = base_peak
        trace.tags["comm_schedule"] = report.to_tag()
        return trace, report

    new = from_trace(trace)
    new.bound_symbols = bsyms
    # The scheduler is the pass licensed to re-bless the order it proved:
    # re-stamp via recertify so the sched.uncertified-reorder rule accepts
    # the new baseline (per-axis order is preserved by construction — same-
    # axis peers bound each other's intervals).
    final_cert = sched_mod.recertify(new)
    final_pred = sched_mod.predict_overlap(new, device=dev, cert=final_cert)
    by_key = final_pred.by_key()
    for m in moves.values():
        so = by_key.get(m.key)
        if so is not None:
            m.index_after = so.index
            m.hidden_us_after = so.hidden_us
            m.window_us_after = so.window_us
    report.sites = sorted(moves.values(), key=lambda m: m.index_after)
    report.predicted_peak_bytes_after = cur_peak
    new.tags["comm_schedule"] = report.to_tag()
    return wrap_in_trace_provenance(new, PASS_NAME, start_ns), report


def _as_trace(template: TraceCtx, bsyms: list) -> TraceCtx:
    t = from_trace(template)
    t.bound_symbols = bsyms
    return t
