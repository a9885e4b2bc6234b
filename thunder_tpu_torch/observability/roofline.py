"""Continuous roofline ledger: duty-cycled in-loop profiling.

The counterpart of ``thunder_tpu/observability/roofline.py``. A
:class:`RooflineSampler` rides the training loop and, every N steps
(``THUNDER_TPU_ROOFLINE_EVERY``, off by default), runs ONE step under the
:func:`~thunder_tpu_torch.observability.profile.profile` bracket, attributes
its kernels to trace lines (a staged step's graph kernels through the
launch-order map that the first probe takes, running the step eagerly), joins the
measured per-line time against the static cost model (``analysis/cost.py``
on the card's spec) and folds the result into a bounded in-memory
:class:`RooflineLedger`: line scope -> measured us/step, flops, bytes,
roofline bound, achieved fraction, bound class and a trend over recent
probes. ``thunder_tpu_torch.monitor.roofline_report()`` prints it.

Each probed op's measured/predicted ratio streams into a detector bank:
the one passed as ``bank=``, else the installed ops plane's
(``observability/opsplane.py``), where it can raise ``kernel_regression``
or ``cost_model_drift``.

Off-path cost: when no probe is due, :meth:`RooflineSampler.maybe_sample`
is one counter bump and a modulo; with ``every=0`` (the default) no probe
ever runs. A probe's step is the caller's step: the first runs it eagerly,
later ones replay its graph (never recaptured).
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import sys
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

ENV_EVERY = "THUNDER_TPU_ROOFLINE_EVERY"

# The row schema: every ledger row carries exactly these fields (the JAX
# package's, so the two ledgers' rows join).
ROW_FIELDS = (
    "label", "sym", "line", "measured_us", "flops", "bytes",
    "roofline_us", "achieved_frac", "bound", "share", "executor",
    "samples", "trend",
)

# |mean(newer half) - mean(older half)| of the achieved-fraction history
# below this is "flat" — achieved fractions live in [0, 1] so an absolute
# band beats a relative one near zero.
TREND_EPS = 0.05


@dataclass
class RooflineEntry:
    """One op scope's ledger row: the latest probe's measurement joined
    with its static bound, plus a bounded achieved-fraction history that
    classifies the trend across probes."""

    label: str
    sym: str
    line: int
    pass_name: Optional[str] = None
    measured_us: float = 0.0  # latest probe, per step
    share: float = 0.0  # of device-busy time, latest probe
    flops: Optional[float] = None
    bytes: Optional[float] = None
    roofline_us: Optional[float] = None  # static ceiling
    achieved_frac: Optional[float] = None  # roofline/measured, capped at 1
    bound: Optional[str] = None  # operations|bytes|free
    executor: Optional[str] = None  # claiming executor
    samples: int = 0  # probes that saw this op
    last_ts: float = 0.0
    history: deque = field(
        default_factory=lambda: deque(maxlen=32), repr=False)

    @property
    def trend(self) -> str:
        """``improving`` / ``degrading`` / ``flat`` over the achieved-
        fraction history (newer-half mean vs older-half mean)."""
        h = [v for v in self.history if v is not None]
        if len(h) < 4:
            return "flat"
        half = len(h) // 2
        old = sum(h[:half]) / half
        new = sum(h[half:]) / (len(h) - half)
        if new - old > TREND_EPS:
            return "improving"
        if old - new > TREND_EPS:
            return "degrading"
        return "flat"

    def as_row(self) -> dict:
        """JSON-safe row in the committed ``ROW_FIELDS`` schema."""
        return {
            "label": self.label,
            "sym": self.sym,
            "line": self.line,
            "measured_us": round(self.measured_us, 3),
            "flops": self.flops,
            "bytes": self.bytes,
            "roofline_us": (
                round(self.roofline_us, 3)
                if self.roofline_us is not None else None),
            "achieved_frac": (
                round(self.achieved_frac, 4)
                if self.achieved_frac is not None else None),
            "bound": self.bound,
            "share": round(self.share, 4),
            "executor": self.executor,
            "samples": self.samples,
            "trend": self.trend,
        }


class RooflineLedger:
    """Bounded per-op ledger folded from probe joins.

    Keyed by scope label; at most ``max_ops`` entries — on overflow the
    cheapest op (smallest measured time) is evicted, since the ledger
    exists to watch the ops that own the step. Thread-compatible with the
    sampler's single-probe-at-a-time discipline; reads
    (:meth:`snapshot` / :meth:`rows`) copy under no lock because folds
    replace scalar fields atomically."""

    def __init__(self, *, max_ops: int = 256, history: int = 32,
                 clock: Callable[[], float] = time.time):
        self.max_ops = int(max_ops)
        self.history = int(history)
        self._clock = clock
        self._entries: dict[str, RooflineEntry] = {}
        self.folds = 0

    def __len__(self) -> int:
        return len(self._entries)

    def fold(self, join: Any, *,
             executor_by_sym: Optional[dict] = None) -> list[RooflineEntry]:
        """Fold one :class:`~thunder_tpu_torch.observability.attribution.PerfJoin`
        (one probe) into the ledger; returns the entries it touched."""
        now = self._clock()
        touched: list[RooflineEntry] = []
        for row in join.rows:
            e = self._entries.get(row.label)
            if e is None:
                e = self._entries[row.label] = RooflineEntry(
                    label=row.label, sym=row.sym, line=row.line,
                    pass_name=row.pass_name,
                    history=deque(maxlen=self.history),
                )
            e.measured_us = float(row.measured_us)
            e.share = float(row.share)
            e.flops = row.flops
            e.bytes = getattr(row, "bytes_moved", None)
            e.roofline_us = row.roofline_us
            e.achieved_frac = row.efficiency
            e.bound = row.bound
            if executor_by_sym:
                e.executor = executor_by_sym.get(row.sym, e.executor)
            e.samples += 1
            e.last_ts = now
            e.history.append(row.efficiency)
            touched.append(e)
        while len(self._entries) > self.max_ops:
            cheapest = min(self._entries.values(), key=lambda x: x.measured_us)
            del self._entries[cheapest.label]
        self.folds += 1
        return touched

    def rows(self) -> list[RooflineEntry]:
        return sorted(self._entries.values(), key=lambda e: -e.measured_us)

    def snapshot(self) -> dict:
        """JSON-safe state of the ledger."""
        return {
            "folds": self.folds,
            "ops": len(self._entries),
            "schema": list(ROW_FIELDS),
            "rows": [e.as_row() for e in self.rows()],
        }

    def format(self, top_k: int = 10) -> str:
        lines = [
            f"roofline ledger: {len(self._entries)} op(s), "
            f"{self.folds} probe(s) folded",
            f"  {'op':<34} {'us/step':>9} {'achieved':>9} {'bound':>8} "
            f"{'trend':>10} {'n':>3}",
        ]
        for e in self.rows()[:top_k]:
            ach = (f"{e.achieved_frac * 100:.0f}%"
                   if e.achieved_frac is not None else "-")
            lines.append(
                f"  {e.label:<34.34} {e.measured_us:>9.1f} {ach:>9} "
                f"{e.bound or '-':>8} {e.trend:>10} {e.samples:>3}"
            )
        return "\n".join(lines)


class RooflineSampler:
    """Duty-cycled in-loop profiler feeding the ledger.

    Wrap the step::

        sampler = monitor.roofline(jfn, every=200)
        for batch in data:
            loss = sampler.maybe_sample(jfn, params, batch)

    Every ``every``-th call runs under the profile bracket (one step, no
    warmup), attributes the trace to scopes, joins with ``trace_cost`` of
    the executed traces and folds into the ledger. All other calls pay one
    counter bump. ``every <= 0`` (the default when
    ``THUNDER_TPU_ROOFLINE_EVERY`` is unset) never probes.

    The static half is resolved at the first probe: ``traces`` (the claimed
    traces one step runs; default the ``jfn``'s last trace) price through
    ``trace_cost``. A staged step's launch-order map comes from the first
    probe itself, which runs the step eagerly: ``eager`` in place of ``fn``
    (a callable running the same annotated step unstaged on the same
    arguments, e.g. ``Train.step_eager`` for ``Train.step``), else ``fn``
    with ``jfn``'s staged entries running their eager programs
    (``attribution.eager_stages``). That probe is the caller's step all the
    same: the sampler runs no step the caller did not ask for, so sampled
    training updates its params and draws its random keys as unsampled
    training does. Later probes profile the graph and place its kernels by
    the map."""

    def __init__(self, jfn: Any = None, *, every: Optional[int] = None,
                 device: Any = None, traces: Optional[list] = None,
                 eager: Optional[Callable] = None,
                 ledger: Optional[RooflineLedger] = None,
                 bank: Any = None, step_name: str = "roofline_probe"):
        if every is None:
            try:
                every = int(os.environ.get(ENV_EVERY, "0") or 0)
            except ValueError:
                every = 0
        self.every = max(0, int(every))
        self.jfn = jfn
        self.device = device
        self.step_name = step_name
        self.ledger = ledger if ledger is not None else RooflineLedger()
        self._bank = bank
        self._traces = traces
        self._eager = eager
        self._cost: Any = None
        self._launch_map: Optional[list] = None
        self._mapped = False  # the eager probe that takes the map has run
        self._executor_by_sym: Optional[dict] = None
        self._resolved = False
        self._step = 0
        self.probes = 0
        self.last_coverage: Optional[float] = None  # of the last probe's join
        self.last_join: Any = None

    # -- duty cycle ------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.every > 0

    def tick(self) -> bool:
        """Advance the duty cycle; True when the next step is a probe."""
        if self.every <= 0:
            return False
        self._step += 1
        return self._step % self.every == 0

    def maybe_sample(self, fn: Callable, *args, **kwargs) -> Any:
        """Call in place of ``fn(*args, **kwargs)``; returns ``fn``'s
        output either way. Probes when the duty cycle says so."""
        if not self.tick():
            return fn(*args, **kwargs)
        return self.sample(fn, *args, **kwargs)

    # -- the probe -------------------------------------------------------------

    def _resolve(self, fn: Callable) -> None:
        """One-shot: the cost of the traces the step runs and which executor
        claimed each symbol."""
        if self._resolved:
            return
        self._resolved = True
        from thunder_tpu_torch.observability.attribution import trace_costs

        traces = self._traces
        cs = getattr(self.jfn, "_lc_cs", None)
        if traces is None and cs is not None and cs.last_traces:
            traces = [cs.last_traces[-1]]
        if not traces:
            log.warning("roofline: no traces for %r; probing without the static cost model", fn)
        else:
            self._cost = trace_costs(traces, self.device)
            self._executor_by_sym = {
                b.sym.name: b.sym.executor.name
                for trc in traces for b in trc.bound_symbols
                if getattr(b.sym, "executor", None) is not None
            }

    def sample(self, fn: Callable, *args, **kwargs) -> Any:
        """Run one probed step now (ignores the duty cycle): profile →
        attribute → join → fold. Returns ``fn``'s output (the first probe's
        from the eager step that takes the launch-order map)."""
        from thunder_tpu_torch.observability import metrics as obsm
        from thunder_tpu_torch.observability.attribution import (
            eager_stages,
            join_cost_attribution,
            launch_map_of_trace,
        )
        from thunder_tpu_torch.observability.events import emit_event
        from thunder_tpu_torch.observability.profile import profile as profile_bracket

        self._resolve(fn)
        mapping = not self._mapped
        step = self._eager if mapping and self._eager is not None else fn
        box: dict[str, Any] = {}

        def _probe_step():
            box["out"] = step(*args, **kwargs)
            return box["out"]

        trace_dir = tempfile.mkdtemp(prefix="thunder_tpu_torch_roofline_")
        t0 = time.perf_counter()
        try:
            with eager_stages(self.jfn) if mapping else contextlib.nullcontext():
                res = profile_bracket(
                    _probe_step, trace_dir=trace_dir, steps=1, warmup=0,
                    step_name=self.step_name, launch_map=self._launch_map)
            self.probes += 1
            obsm.ROOFLINE_PROBES.inc_always()
            touched: list[RooflineEntry] = []
            attr = res["attribution"]
            if mapping:
                self._mapped = True
                # An eager step's kernels, each launched in its line's range;
                # a probe that still replayed a graph gives no whole map.
                if attr is not None and attr.mode == "cuda" and not attr.graph_ops:
                    self._launch_map = launch_map_of_trace(trace_dir) or None
            if attr is not None:
                join = join_cost_attribution(attr, self._cost, steps=1)
                self.last_join = join
                self.last_coverage = attr.coverage
                touched = self.ledger.fold(join, executor_by_sym=self._executor_by_sym)
                self._feed_bank(touched)
            emit_event(
                "roofline_probe", step=self._step, ops=len(touched),
                probe_s=round(time.perf_counter() - t0, 6))
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        return box.get("out")

    def _feed_bank(self, touched: list[RooflineEntry]) -> None:
        bank = self._bank
        if bank is None:
            # The installed ops plane's bank; with the plane never armed its
            # module was never imported, and the probe imports nothing.
            opsplane = sys.modules.get("thunder_tpu_torch.observability.opsplane")
            plane = opsplane.current() if opsplane is not None else None
            bank = plane.bank if plane is not None else None
        if bank is None:
            return
        for e in touched:
            if e.roofline_us and e.measured_us:
                bank.note_roofline_op(
                    e.label, e.measured_us, e.roofline_us,
                    executor=e.executor)

    # -- introspection ---------------------------------------------------------

    def debug_state(self) -> dict:
        return {
            "enabled": self.enabled,
            "every": self.every,
            "steps": self._step,
            "probes": self.probes,
            "ledger": self.ledger.snapshot(),
        }


# =============================================================================
# Module singleton (the monitor facade's hookup)
# =============================================================================

_state: dict[str, Optional[RooflineSampler]] = {"sampler": None}


def current() -> Optional[RooflineSampler]:
    return _state["sampler"]


def enable(jfn: Any = None, *, every: Optional[int] = None,
           **kwargs) -> RooflineSampler:
    """Install (and return) the process-wide sampler:
    ``thunder_tpu_torch.monitor.roofline(...)`` forwards here. ``every=None``
    reads ``THUNDER_TPU_ROOFLINE_EVERY`` (unset/0 = armed object, no
    probes)."""
    sampler = RooflineSampler(jfn, every=every, **kwargs)
    _state["sampler"] = sampler
    return sampler


def disable() -> None:
    _state["sampler"] = None


def debug_state() -> dict:
    s = current()
    if s is None:
        return {"enabled": False}
    return s.debug_state()
