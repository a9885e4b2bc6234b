"""Static trace verification, liveness and cost (the counterpart of ``thunder_tpu/analysis/``).

A rule-based verifier over :class:`~thunder_tpu_torch.core.trace.TraceCtx`:
the trace is walked once into a :class:`VerifyContext` and a registry of
named rules checks the invariants every pass must preserve:

- ``ssa.*``       def-use discipline (use-before-def, redefinition, live outputs)
- ``meta.*``      output shape/dtype/device against re-running the prim's meta
- ``alias.*``     in-place ops whose destination is still consumed later
- ``dce.*``       side-effect-free symbols with no consumers
- ``names.*``     name-registry hygiene
- ``donation.*``  donated-buffer hazards (the port donates nothing: silent)
- ``mem.*``       predicted peak device memory against the card's capacity
- ``dist.*``      collective axes and group sizes, future/wait pairing, the
                  forward and backward collective balance (``collectives.py``)
- ``sched.*``     the per-axis collective order against the stamped schedule
                  certificate (``schedule.py``)
- ``hlo.*``       advisory findings of the compiled-program audit
                  (``hlo_audit.py``: a staged entry's CUDA graph or one call's
                  op record, read below the trace), from the report the
                  ``hlo_audit`` compile phase puts in the trace's tags

Pipeline wiring: with ``THUNDER_TPU_CHECKS=1`` or ``jit(debug_checks=True)``
(``grad``, ``value_and_grad``, ``vmap``, ``jit(module)``) every pass's
``wrap_in_trace_provenance``/``mark`` (``core/trace.py``) runs
:func:`verify_or_raise` on its output, naming the pass that broke a trace.
User-facing: ``thunder_tpu_torch.examine.lint(fn, *args)``.
"""

from __future__ import annotations

from typing import Iterable, Optional

from thunder_tpu_torch.analysis.context import VerifyContext, pass_name_of  # noqa: F401
from thunder_tpu_torch.analysis.cost import (  # noqa: F401
    DEVICE_SPECS,
    DeviceSpec,
    OpCost,
    TraceCost,
    bsym_cost,
    calibrate_ici,
    collective_sym_class,
    cost_report,
    kernel_costs,
    resolve_device_spec,
    trace_cost,
)
from thunder_tpu_torch.analysis.diagnostics import (  # noqa: F401
    Diagnostic,
    Severity,
    TraceVerificationError,
    attach_trace_lines,
    max_severity,
)
from thunder_tpu_torch.analysis.hlo_audit import (  # noqa: F401
    HloCollectiveSite,
    HloScheduleReport,
    audit_hlo,
    audit_jitted,
    ops_of_record,
    parse_graph_dump,
)
from thunder_tpu_torch.analysis.liveness import (  # noqa: F401
    MemoryPlan,
    device_capacity_bytes,
    memory_report,
    plan_fw_bw,
    plan_liveness,
    predict_level_peaks,
)
from thunder_tpu_torch.analysis.registry import (  # noqa: F401
    Rule,
    all_rules,
    enabled_rules,
    get_rule,
    register_rule,
    set_rule_enabled,
)
from thunder_tpu_torch.analysis.schedule import (  # noqa: F401
    CollectiveSite,
    OverlapPrediction,
    ScheduleCertificate,
    SiteOverlap,
    certify,
    predict_overlap,
    recertify,
)
from thunder_tpu_torch.core.trace import TraceCtx, tracectx


def verify(trace: TraceCtx, *, pass_name: Optional[str] = None, disable: Iterable[str] = (),
           with_trace_lines: bool = False) -> list[Diagnostic]:
    """Run every enabled rule over ``trace``; return its diagnostics.

    ``pass_name`` overrides the provenance-derived attribution; ``disable``
    suppresses rule ids. Rules run under a detached (None) trace context, so
    a meta re-run never records into, or mints names in, a live trace."""
    off = set(disable)
    ctx = VerifyContext(trace, pass_name=pass_name)
    with tracectx(None):
        for rule in enabled_rules(disable=off):
            rule.fn(ctx)
    diags = [d for d in ctx.diagnostics if d.rule not in off]
    if with_trace_lines:
        attach_trace_lines(diags, trace)
    return diags


def verify_or_raise(trace: TraceCtx, *, pass_name: Optional[str] = None, disable: Iterable[str] = (),
                    min_severity: Severity = Severity.ERROR) -> list[Diagnostic]:
    """Verify ``trace``; raise :class:`TraceVerificationError` if any
    diagnostic reaches ``min_severity``, else return the diagnostics."""
    diags = verify(trace, pass_name=pass_name, disable=disable, with_trace_lines=True)
    if any(d.severity >= min_severity for d in diags):
        raise TraceVerificationError(diags, pass_name=pass_name or pass_name_of(trace))
    return diags
