"""Collective-schedule safety: happens-before over the dist prims.

The counterpart of ``thunder_tpu/analysis/schedule.py``. Every rank runs the
same trace, and a collective completes only when every rank of its group
reaches it, so two collectives of one axis that ranks issue in different
orders deadlock. A pass that moves a collective needs a proof that the move
keeps:

1. data dependencies (the operands exist, the consumers follow);
2. future/wait pairing (a ``wait`` never crosses before its future);
3. the per-axis program order between collectives (the cross-rank
   agreement that one trace can certify).

:func:`certify` builds that proof, a :class:`ScheduleCertificate`: for each
collective site its legal interval ``[earliest, latest]``, and the per-axis
order with its fingerprint. A pass that legally reorders collectives
re-stamps its output with :func:`recertify`; the ``sched.uncertified-reorder``
rule compares every pass's output with the stamped order
(``trace.tags["collective_order"]``, which ``from_trace`` carries on) and
names the pass that inverted two. :func:`predict_overlap` prices each site's
wire time (``analysis/cost.py``) against the compute before its first
consumer. ``distributed/runtime.stage_collective_trace`` stamps the order of
each staged trace and keeps its per-axis labels for the collective watchdog
of a later slice.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

from thunder_tpu_torch.analysis.context import VerifyContext
from thunder_tpu_torch.analysis.diagnostics import Severity
from thunder_tpu_torch.analysis.registry import register_rule
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.trace import TraceCtx


def _collective_axis(bsym) -> Optional[str]:
    """Axis of a collective site for scheduling purposes: the shared
    calling-convention helper (analysis/collectives.collective_axis), with
    two schedule-specific guards — a wait pairs with its future rather than
    an axis slot, and a malformed non-str axis (dist.axis reports it) has
    no ordering lane."""
    from thunder_tpu_torch.analysis.collectives import collective_axis_of
    from thunder_tpu_torch.distributed.prims import DistOpIDs

    if bsym.sym.id is DistOpIDs.WAIT:
        return None
    ax = collective_axis_of(bsym)
    return ax if isinstance(ax, str) else None


def _site_key(index: int, bsym, axis: Optional[str]) -> str:
    """Stable identity of a collective across passes: sym name + axis +
    output proxy name (from_trace shares the name pool, so output names
    survive pass rewrites that don't rebuild the op)."""
    out = next(iter(bsym.flat_proxy_outs), None)
    out_name = getattr(out, "name", f"@{index}")
    return f"{bsym.sym.name}[{axis or '-'}]->{out_name}"


@dataclass
class CollectiveSite:
    """One collective dispatch site and its legal placement interval."""

    index: int
    sym: str
    axis: Optional[str]
    key: str
    line: str
    earliest: int          # first bsym index the site may legally occupy
    latest: int            # last bsym index the site may legally occupy
    deps_before: tuple = ()   # bsym indexes that must precede (data + axis)
    deps_after: tuple = ()    # bsym indexes that must follow
    # First bsym index that consumes one of the site's outputs (the RETURN
    # index when only the return reads it): the right end of the overlap
    # window — compute strictly between the site and this line can hide the
    # wire transfer (predict_overlap; the comm scheduler maximizes it).
    first_consumer: Optional[int] = None

    @property
    def hoistable(self) -> bool:
        return self.earliest < self.index

    @property
    def sinkable(self) -> bool:
        return self.latest > self.index

    def label(self) -> str:
        return f"L{self.index}.{self.sym}"


@dataclass
class ScheduleCertificate:
    """The proof object: per-site movable ranges + the per-axis order whose
    preservation is the cross-rank safety invariant."""

    trace_name: str
    pass_name: Optional[str]
    sites: list = field(default_factory=list)
    axis_order: dict = field(default_factory=dict)  # axis -> (site key, ...)
    fingerprint: str = ""

    def site_at(self, index: int) -> Optional[CollectiveSite]:
        return next((s for s in self.sites if s.index == index), None)

    def movable_sites(self) -> list:
        return [s for s in self.sites if s.sinkable or s.hoistable]

    def axis_labels(self) -> dict:
        """{axis: [L<i>.<sym>, ...]} — the watchdog's pending-line context:
        everything left of a pending collective must already have completed
        on every healthy rank. Memoized: the certificate is immutable once
        built and this sits on the per-dispatch watchdog path."""
        cached = getattr(self, "_axis_labels_cache", None)
        if cached is not None:
            return cached
        by_index = {s.key: s for s in self.sites}
        cached = {
            axis: [by_index[k].label() for k in keys if k in by_index]
            for axis, keys in self.axis_order.items()
        }
        self._axis_labels_cache = cached
        return cached

    def legal_order(self, new_axis_order: dict) -> bool:
        """Whether another trace's per-axis order is a legal evolution of
        this certificate's: sites present in both keep their relative order
        per axis (additions and deletions are fine — grad transforms add
        reduce_scatters, DCE drops dead collectives)."""
        for axis, old in self.axis_order.items():
            new = new_axis_order.get(axis, ())
            pos = {k: p for p, k in enumerate(new)}
            common = [pos[k] for k in old if k in pos]
            if common != sorted(common):
                return False
        return True

    def format(self) -> str:
        lines = [
            f"schedule certificate [{self.trace_name}"
            + (f" after {self.pass_name}" if self.pass_name else "")
            + f"]: {len(self.sites)} collective site(s), "
            f"fingerprint {self.fingerprint[:12]}"
        ]
        for s in self.sites:
            move = []
            if s.hoistable:
                move.append(f"hoistable to L{s.earliest}")
            if s.sinkable:
                move.append(f"sinkable to L{s.latest}")
            lines.append(
                f"  {s.label():<24} axis={s.axis or '-':<6} "
                + (", ".join(move) if move else "pinned")
            )
        for axis, keys in sorted(self.axis_order.items()):
            lines.append(f"  order[{axis}]: " + " -> ".join(keys))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()


def _axis_key_order(bsyms) -> dict:
    """{axis: (site key, ...)} in program order — the comparison object the
    ``sched.uncertified-reorder`` rule stamps and checks."""
    from thunder_tpu_torch.distributed.prims import is_collective_bsym

    order: dict[str, list] = {}
    for i, bsym in enumerate(bsyms):
        if not is_collective_bsym(bsym):
            continue
        axis = _collective_axis(bsym)
        if axis is None:
            continue
        order.setdefault(axis, []).append(_site_key(i, bsym, axis))
    return {a: tuple(ks) for a, ks in order.items()}


def certify(trace: TraceCtx, *, ctx: Optional[VerifyContext] = None) -> ScheduleCertificate:
    """Build the :class:`ScheduleCertificate` for ``trace``.

    Placement intervals: ``earliest`` is one past the last producer of any
    operand (and the previous same-axis collective, and any earlier
    in-place mutation of an operand's buffer); ``latest`` is one before the
    first consumer of any output (and the next same-axis collective, and
    any later in-place mutation of an operand's buffer — anti-dependencies:
    moving a read across a ``copy_`` changes which value it reads); an
    output that is a trace output pins ``latest`` to the return. DEL sites
    do not count as consumers (a sunk collective's del sinks with it)."""
    from thunder_tpu_torch.analysis.liveness import alias_root_fn
    from thunder_tpu_torch.analysis.rules import INPLACE_MUTATED_ARG
    from thunder_tpu_torch.core.prims import OpTags
    from thunder_tpu_torch.distributed.prims import is_collective_bsym

    if ctx is None:
        ctx = VerifyContext(trace)
    bsyms = ctx.bsyms
    n = len(bsyms)
    return_idx = next(
        (i for i, b in enumerate(bsyms) if b.sym.id is PrimIDs.RETURN), n
    )

    # In-place writes, alias-rooted: (index, mutated buffer's root name).
    root = alias_root_fn(bsyms)
    inplace_writes: list = []
    for m, b in enumerate(bsyms):
        if not b.has_tag(OpTags.IN_PLACE):
            continue
        idx = INPLACE_MUTATED_ARG.get(b.sym.id, 0)
        if idx < len(b.args) and hasattr(b.args[idx], "name"):
            inplace_writes.append((m, root(b.args[idx].name)))

    cert = ScheduleCertificate(
        trace_name=trace.name, pass_name=ctx.pass_name
    )
    coll_idx = [i for i, b in enumerate(bsyms) if is_collective_bsym(b)]
    by_axis: dict[str, list] = {}
    for i in coll_idx:
        axis = _collective_axis(bsyms[i])
        if axis is not None:
            by_axis.setdefault(axis, []).append(i)

    for i in coll_idx:
        bsym = bsyms[i]
        axis = _collective_axis(bsym)
        deps_before: set[int] = set()
        deps_after: set[int] = set()

        earliest = 0
        for p in bsym.flat_proxy_args:
            d = ctx.defs.get(p.name)
            if d is not None and d[0] < i:
                deps_before.add(d[0])
                earliest = max(earliest, d[0] + 1)

        latest = max(return_idx - 1, i)
        pinned_out = False
        consumers: list[int] = []
        for o in bsym.flat_proxy_outs:
            name = getattr(o, "name", None)
            if name is None:
                continue
            if name in ctx.output_names:
                pinned_out = True
            first_live = ctx.consumed_after(name, i)  # DELs excluded
            if first_live is not None:
                deps_after.add(first_live)
                latest = min(latest, first_live - 1)
                consumers.append(first_live)
        if pinned_out:
            latest = min(latest, return_idx - 1)
            consumers.append(return_idx)

        # Anti-dependencies: an in-place write to an operand's buffer pins
        # the site between the mutations it must read between.
        if inplace_writes:
            operand_roots = {
                root(p.name) for p in bsym.flat_proxy_args
                if hasattr(p, "name")
            }
            for m, w in inplace_writes:
                if w not in operand_roots or m == i:
                    continue
                if m < i:
                    deps_before.add(m)
                    earliest = max(earliest, m + 1)
                else:
                    deps_after.add(m)
                    latest = min(latest, m - 1)

        peers = by_axis.get(axis, ()) if axis is not None else ()
        if axis is not None:
            pos = peers.index(i)
            if pos > 0:
                deps_before.add(peers[pos - 1])
                earliest = max(earliest, peers[pos - 1] + 1)
            if pos + 1 < len(peers):
                deps_after.add(peers[pos + 1])
                latest = min(latest, peers[pos + 1] - 1)

        cert.sites.append(CollectiveSite(
            index=i, sym=bsym.sym.name, axis=axis,
            key=_site_key(i, bsym, axis), line=bsym.one_line(),
            earliest=earliest, latest=max(latest, earliest),
            deps_before=tuple(sorted(deps_before)),
            deps_after=tuple(sorted(deps_after)),
            first_consumer=min(consumers) if consumers else None,
        ))

    cert.axis_order = _axis_key_order(bsyms)
    cert.fingerprint = hashlib.sha1(
        repr(sorted(cert.axis_order.items())).encode()
    ).hexdigest()
    return cert


def stamp(trace: TraceCtx, cert: Optional[ScheduleCertificate] = None) -> ScheduleCertificate:
    """Record ``cert``'s per-axis order on the trace
    (``tags["collective_order"]``) — the baseline the
    ``sched.uncertified-reorder`` rule compares later passes against.
    ``from_trace`` copies tags, so every downstream pass inherits it."""
    if cert is None:
        cert = certify(trace)
    trace.tags["collective_order"] = dict(cert.axis_order)
    return cert


def recertify(trace: TraceCtx) -> ScheduleCertificate:
    """What a pass that legally reorders collectives calls on its output:
    re-derive the certificate and replace the stamped order, so the
    verifier accepts the new schedule as the baseline going forward."""
    return stamp(trace)


# =============================================================================
# Static overlap prediction — the compile-time twin of the measured lane
# segmentation (observability/attribution.py)
# =============================================================================


@dataclass
class SiteOverlap:
    """Predicted wire/hidden/exposed time of one collective site.

    ``wire_us`` prices the site's ring-factor traffic at the device spec's
    (possibly calibrated) per-family link rate; ``window_us`` is the
    roofline compute time of the non-collective bsyms strictly between the
    site and its first consumer — the compute a latency-hiding runtime can
    provably run while the transfer is in flight, because the certificate
    says nothing in the window depends on the collective's output."""

    index: int
    sym: str
    axis: Optional[str]
    key: str
    wire_us: float
    window_us: float
    hidden_us: float
    first_consumer: Optional[int] = None

    @property
    def exposed_us(self) -> float:
        return max(0.0, self.wire_us - self.hidden_us)

    @property
    def hidden_frac(self) -> float:
        return self.hidden_us / self.wire_us if self.wire_us else 0.0

    def label(self) -> str:
        return f"L{self.index}.{self.sym}"


@dataclass
class OverlapPrediction:
    """Per-site predicted hidden/exposed wire time over one trace."""

    device: str
    sites: list = field(default_factory=list)
    # Per-line compute budget (µs) left after every site consumed its
    # share — what the comm scheduler's hoist scan must price NEW window
    # rows at, so two sites never count the same GEMM twice.
    residual_budget: dict = field(default_factory=dict)

    @property
    def wire_us(self) -> float:
        return sum(s.wire_us for s in self.sites)

    @property
    def hidden_us(self) -> float:
        return sum(s.hidden_us for s in self.sites)

    @property
    def exposed_us(self) -> float:
        return sum(s.exposed_us for s in self.sites)

    @property
    def exposed_pct(self) -> float:
        """Exposed fraction of total predicted wire time (percent)."""
        return self.exposed_us / self.wire_us * 100.0 if self.wire_us else 0.0

    def by_key(self) -> dict:
        return {s.key: s for s in self.sites}

    def format(self) -> str:
        lines = [
            f"predicted overlap [{self.device}]: {self.wire_us:.1f}us wire, "
            f"{self.hidden_us:.1f}us hidden, {self.exposed_us:.1f}us exposed "
            f"({self.exposed_pct:.1f}%)",
            f"  {'site':<26} {'axis':<6} {'wire us':>9} {'window':>9} "
            f"{'hidden':>9} {'exposed':>9}",
        ]
        for s in sorted(self.sites, key=lambda s: -s.wire_us):
            lines.append(
                f"  {s.label():<26.26} {s.axis or '-':<6} {s.wire_us:>9.2f} "
                f"{s.window_us:>9.2f} {s.hidden_us:>9.2f} {s.exposed_us:>9.2f}"
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()


def predict_overlap(trace: TraceCtx, *, device: Any = None,
                    cert: Optional[ScheduleCertificate] = None) -> OverlapPrediction:
    """Predict, per collective site, how much of its wire time hides under
    the compute between the site and its first consumer.

    Model: a collective issued at its trace position completes no later
    than its first consumer; the roofline time of the non-collective bsyms
    strictly between the two is the overlap window (certified independent —
    they neither produce the site's operands nor consume its outputs).
    Windows share compute: each line's budget is consumed by sites in
    program order, so two collectives cannot both claim the same GEMM.
    ``hidden = min(wire, window-budget consumed)``; the rest is exposed.
    The comm scheduler (``transforms/comm_schedule.py``) moves sites inside
    their certified intervals to maximize exactly this number, and the
    ``sched.exposed-collective`` rule reports it per site."""
    from thunder_tpu_torch.analysis.cost import resolve_device_spec, trace_cost

    dev = resolve_device_spec(device)
    if cert is None:
        cert = certify(trace)
    tc = trace_cost(trace, dev)
    compute_us: dict[int, float] = {}
    wire_by_index: dict[int, float] = {}
    for r in tc.rows:
        if r.kind == "collective":
            wire_by_index[r.index] = r.roofline_s * 1e6
        else:
            compute_us[r.index] = r.roofline_s * 1e6

    pred = OverlapPrediction(device=dev.name)
    budget = dict(compute_us)
    for site in sorted(cert.sites, key=lambda s: s.index):
        wire = wire_by_index.get(site.index, 0.0)
        c = site.first_consumer
        window = 0.0
        hidden = 0.0
        if c is not None:
            for j in range(site.index + 1, c):
                avail = budget.get(j, 0.0)
                window += compute_us.get(j, 0.0)
                if avail and hidden < wire:
                    take = min(avail, wire - hidden)
                    budget[j] = avail - take
                    hidden += take
        pred.sites.append(SiteOverlap(
            index=site.index, sym=site.sym, axis=site.axis, key=site.key,
            wire_us=wire, window_us=window, hidden_us=min(hidden, wire),
            first_consumer=c,
        ))
    pred.residual_budget = budget
    return pred


def _bsym_index_of_key(bsyms, key: str) -> Optional[int]:
    from thunder_tpu_torch.distributed.prims import is_collective_bsym

    for i, bsym in enumerate(bsyms):
        if is_collective_bsym(bsym) and _site_key(i, bsym, _collective_axis(bsym)) == key:
            return i
    return None


# =============================================================================
# Verifier rule
# =============================================================================


@register_rule(
    "sched.uncertified-reorder",
    "Collectives keep their certified per-axis program order across passes",
)
def uncertified_reorder(ctx: VerifyContext) -> None:
    """Compares the trace's per-axis collective order against the stamped
    baseline. Additions (grad's reduce_scatters) and deletions (DCE) are
    legal; an *inversion* of two surviving same-axis collectives is the
    cross-rank deadlock shape and is an ERROR attributed to the pass —
    unless the pass re-certified (``schedule.recertify``) its output.
    First sight of a trace with collectives stamps the baseline."""
    current = _axis_key_order(ctx.bsyms)
    tagged = ctx.trace.tags.get("collective_order")
    if tagged is None:
        if current:
            ctx.trace.tags["collective_order"] = current
        return
    found_inversion = False
    for axis, old in tagged.items():
        new = current.get(axis, ())
        pos = {k: p for p, k in enumerate(new)}
        common = [k for k in old if k in pos]
        positions = [pos[k] for k in common]
        inversion = next(
            (
                (common[j], common[j + 1])
                for j in range(len(common) - 1)
                if positions[j] > positions[j + 1]
            ),
            None,
        )
        if inversion is not None:
            found_inversion = True
            first, second = inversion
            ctx.report(
                "sched.uncertified-reorder",
                Severity.ERROR,
                f"axis {axis!r}: collectives {first} and {second} swapped their "
                "certified program order — ranks agreeing on the OLD order would "
                "deadlock against ranks running this trace",
                bsym_index=_bsym_index_of_key(ctx.bsyms, first),
                hint="a pass moving collectives must prove the move via "
                "analysis.schedule.certify (movable range) and re-stamp with "
                "schedule.recertify(trace)",
            )
    # Refresh the baseline so the next pass diffs against THIS trace —
    # but never adopt an order we just flagged: only schedule.recertify
    # (a pass that PROVED its move) may bless a reorder, otherwise a
    # re-verify of the same flagged trace would report clean.
    if not found_inversion:
        ctx.trace.tags["collective_order"] = current


# Sub-µs wire predictions are bookkeeping noise (replicated synchronize,
# zero-factor ops) — the advisory rule only reports sites worth scheduling.
_EXPOSED_RULE_MIN_WIRE_US = 1.0


@register_rule(
    "sched.exposed-collective",
    "Collective wire time is predicted hidden under certified-independent compute",
)
def exposed_collective(ctx: VerifyContext) -> None:
    """Advisory (INFO): per collective site, the statically predicted
    hidden/exposed wire time (:func:`predict_overlap`) — the compile-time
    twin of the measured lane segmentation. A site whose predicted wire
    time is mostly exposed is a scheduling opportunity the comm scheduler
    (``thunder_tpu/transforms/comm_schedule.py``, not yet ported) either already declined (pinned, or
    a liveness back-off) or has not seen. Never an error: exposure is a
    speed bug, not a correctness one."""
    from thunder_tpu_torch.distributed.prims import is_collective_bsym

    if not any(is_collective_bsym(b) for b in ctx.bsyms):
        return
    try:
        pred = predict_overlap(ctx.trace, cert=certify(ctx.trace, ctx=ctx))
    except Exception:  # noqa: BLE001 — advisory prediction must never break verify
        return
    for s in pred.sites:
        if s.wire_us < _EXPOSED_RULE_MIN_WIRE_US or s.exposed_us <= 0.0:
            continue
        ctx.report(
            "sched.exposed-collective",
            Severity.INFO,
            f"{s.label()} [{s.axis or '-'}]: predicted {s.exposed_us:.1f}us of "
            f"{s.wire_us:.1f}us wire exposed ({s.hidden_us:.1f}us hidden under "
            f"the {s.window_us:.1f}us window to its consumer"
            + (f" at L{s.first_consumer}" if s.first_consumer is not None else "")
            + ")",
            bsym_index=s.index,
            hint="a collective scheduler (thunder_tpu/transforms/comm_schedule.py) moves the site "
            "inside its certified [earliest, latest] interval to grow the "
            "window; a pinned or backed-off site needs more independent "
            "compute or a smaller transfer (quantized collectives)",
        )
