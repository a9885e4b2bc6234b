"""Built-in verifier rules: SSA/def-use, meta consistency, alias hazards,
DCE safety, donation and name-registry hygiene (a copy of
``thunder_tpu/analysis/rules.py``, less its collective rules, which wait for
the port's distributed prims).

Each rule consumes the precomputed :class:`VerifyContext` indexes — the trace
itself is walked exactly once, by the context. Severities: structural breaks
(use-before-def, redefinition, metadata drift, in-place hazards) are ERRORs —
a pass emitting them produced a program that cannot mean what the source
meant. Dead symbols are WARNINGs (legitimate pre-DCE, a bug post-DCE), and
orphaned registry names are INFO (``from_trace`` shares the name pool on
purpose, so stale names are expected after elimination passes).
"""

from __future__ import annotations

from thunder_tpu_torch.analysis.context import VerifyContext, needs_definition
from thunder_tpu_torch.analysis.diagnostics import Severity
from thunder_tpu_torch.analysis.registry import register_rule
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten


# =============================================================================
# (1) SSA / def-use
# =============================================================================


@register_rule("ssa.use-before-def", "Every consumed proxy is produced earlier or is a trace input")
def ssa_use_before_def(ctx: VerifyContext) -> None:
    for i, bsym in enumerate(ctx.bsyms):
        for p in bsym.flat_proxy_args:
            if not needs_definition(p):
                continue
            if not ctx.defined_before(p.name, i):
                where = "never defined" if p.name not in ctx.defs else f"defined later (bsym {ctx.defs[p.name][0]})"
                ctx.report(
                    "ssa.use-before-def",
                    Severity.ERROR,
                    f"{bsym.sym.qualname} consumes {p.name!r}, which is {where} and is not a trace input",
                    bsym_index=i,
                    hint="the producing symbol was dropped or reordered by the pass; "
                    "check its swap map / liveness set",
                )


@register_rule("ssa.redefinition", "No proxy name is produced twice")
def ssa_redefinition(ctx: VerifyContext) -> None:
    for i, name, prev in ctx.redefs:
        ctx.report(
            "ssa.redefinition",
            Severity.ERROR,
            f"{ctx.bsyms[i].sym.qualname} redefines {name!r}, already produced by bsym {prev}",
            bsym_index=i,
            hint="a rewriting pass must mint fresh proxies (trace.make_name) for new outputs",
        )


@register_rule("ssa.undefined-output", "Every trace output proxy has a producer (outputs are live)")
def ssa_undefined_output(ctx: VerifyContext) -> None:
    for p in ctx.output_proxies:
        if not needs_definition(p):
            continue
        if p.name not in ctx.input_names and p.name not in ctx.defs:
            ctx.report(
                "ssa.undefined-output",
                Severity.ERROR,
                f"trace output {p.name!r} is produced by no symbol and is not an input",
                hint="the pass rewired outputs without updating trace.output (or DCE'd the producer)",
            )


# =============================================================================
# (2) Metadata consistency (shape/dtype/device vs the prim's meta function)
# =============================================================================

# Prims whose metas are structural/guard plumbing over concrete caller data,
# or (synchronize) read trace-time proxy attributes a later pass may not
# preserve — re-running them is not a well-defined oracle.
_META_EXEMPT_IDS = {
    PrimIDs.UNPACK_TRIVIAL,
    PrimIDs.UNPACK_SEQUENCE,
    PrimIDs.UNPACK_KEY,
    PrimIDs.UNPACK_ATTR,
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA,
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    PrimIDs.CHECK_STRING_VALUE,
    PrimIDs.CHECK_LEN,
    PrimIDs.CHECK_KEYS,
    PrimIDs.CHECK_NONE,
    # Symbolic-values guards: structural plumbing over concrete caller data,
    # like the checks above (and unpack_dim's output is a NumberProxy, which
    # the meta rules do not model).
    PrimIDs.UNPACK_DIM,
    PrimIDs.CHECK_DIM_BUCKET,
}


def _meta_exempt(bsym) -> bool:
    return bsym.sym.id in _META_EXEMPT_IDS


def _meta_findings(ctx: VerifyContext) -> list[tuple]:
    """One shared meta-re-run walk per verify() call, cached on the context:
    both meta rules consume it, so disabling either rule id (per-call or
    process-wide) suppresses exactly its findings without a second walk."""
    cached = getattr(ctx, "_meta_findings_cache", None)
    if cached is not None:
        return cached
    findings: list[tuple] = []  # (kind, bsym_index, message, hint)
    for i, bsym in enumerate(ctx.bsyms):
        sym = bsym.sym
        if not sym.is_prim or sym.meta is None or _meta_exempt(bsym):
            continue
        got = [t for t in bsym.flat_outs if isinstance(t, TensorProxy)]
        if not got:
            continue
        try:
            expected = sym.meta(*bsym.args, **bsym.kwargs)
        except Exception as e:  # noqa: BLE001 — the meta rejecting its own recorded args IS the finding
            findings.append(
                (
                    "reject",
                    i,
                    f"{sym.qualname} meta rejects the recorded operands: {type(e).__name__}: {e}",
                    "a pass substituted operands the op cannot accept (shape/dtype drift upstream)",
                )
            )
            continue
        exp = [t for t in tree_flatten(expected)[0] if isinstance(t, TensorProxy)]
        if len(exp) != len(got):
            findings.append(
                (
                    "mismatch",
                    i,
                    f"{sym.qualname} records {len(got)} tensor output(s) but its meta produces {len(exp)}",
                    None,
                )
            )
            continue
        for e_t, g_t in zip(exp, got):
            drift = []
            if tuple(e_t.shape) != tuple(g_t.shape):
                drift.append(f"shape {tuple(g_t.shape)} != expected {tuple(e_t.shape)}")
            if e_t.dtype != g_t.dtype:
                drift.append(f"dtype {g_t.dtype} != expected {e_t.dtype}")
            if e_t.device != g_t.device:
                drift.append(f"device {g_t.device} != expected {e_t.device}")
            if drift:
                findings.append(
                    (
                        "mismatch",
                        i,
                        f"{sym.qualname} output {g_t.name!r}: " + "; ".join(drift),
                        "the pass rewrote operands without re-deriving the output proxy "
                        "(use the symbol call, not bind, when operand metadata changes)",
                    )
                )
    ctx._meta_findings_cache = findings
    return findings


@register_rule("meta.mismatch", "Recorded output metadata matches re-running the prim's meta function")
def meta_mismatch(ctx: VerifyContext) -> None:
    for kind, i, message, hint in _meta_findings(ctx):
        if kind == "mismatch":
            ctx.report("meta.mismatch", Severity.ERROR, message, bsym_index=i, hint=hint)


@register_rule("meta.reject", "The prim's meta function accepts its recorded operands")
def meta_reject(ctx: VerifyContext) -> None:
    for kind, i, message, hint in _meta_findings(ctx):
        if kind == "reject":
            ctx.report("meta.reject", Severity.ERROR, message, bsym_index=i, hint=hint)


# =============================================================================
# (3) Alias / in-place hazards
# =============================================================================

# For IN_PLACE-tagged prims: which positional arg is the mutated destination.
INPLACE_MUTATED_ARG: dict = {PrimIDs.COPY_: 1}


@register_rule("alias.inplace-hazard", "No in-place op's destination is consumed later in program order")
def inplace_hazard(ctx: VerifyContext) -> None:
    from thunder_tpu_torch.core.proxies import Proxy

    for i, bsym in enumerate(ctx.bsyms):
        if not bsym.has_tag(OpTags.IN_PLACE):
            continue
        idx = INPLACE_MUTATED_ARG.get(bsym.sym.id, 0)
        if idx >= len(bsym.args) or not isinstance(bsym.args[idx], Proxy):
            continue
        dst = bsym.args[idx]
        later = ctx.consumed_after(dst.name, i)
        if later is not None:
            ctx.report(
                "alias.inplace-hazard",
                Severity.ERROR,
                f"{bsym.sym.qualname} mutates {dst.name!r} in place, but bsym {later} "
                f"({ctx.bsyms[later].sym.qualname}) still consumes the pre-mutation value",
                bsym_index=i,
                hint="functionalize: consume the op's output instead of the mutated operand, "
                "or reorder the consumer before the mutation",
            )


# =============================================================================
# (3b) Donation / entry-aliasing sanitizer
#
# The JAX package's compile pipeline stamps donation metadata on the claimed
# execution trace (tags["donated_inputs"] naming the input proxies whose
# buffers XLA may reuse, tags["rerun_reads_inputs"] when the entry can re-run
# those buffers unstaged). The port stages no donated input: a staged graph
# reads a caller's tensor in place by address and never frees it
# (executors/staging.py), so no trace carries the tags and the two donation
# rules find nothing, as they should. They stay, so that a pass that starts
# stamping donation is checked from its first trace.
# =============================================================================


@register_rule(
    "donation.use-after-donation",
    "No rerun-capable entry donates the input buffers its rerun would re-read",
)
def use_after_donation(ctx: VerifyContext) -> None:
    donated = ctx.trace.tags.get("donated_inputs") or ()
    if not donated or not ctx.trace.tags.get("rerun_reads_inputs"):
        return
    sample = ", ".join(list(donated)[:4]) + ("…" if len(donated) > 4 else "")
    ctx.report(
        "donation.use-after-donation",
        Severity.ERROR,
        f"entry re-runs its inputs unstaged (on_nan rerun / SDC re-run) but "
        f"donates {len(donated)} input buffer(s) ({sample}) — a donated "
        "buffer is reused by the staged run, so the re-run would read "
        "overwritten memory",
        hint="disable donation for rerun-capable entries "
        "(api._compile_entry_impl does; a pass re-enabling it must clear the "
        "rerun_reads_inputs tag)",
    )


def _alias_root_fn(ctx: VerifyContext):
    """name -> root-buffer name through the view chain — the SAME alias
    model the liveness planner uses (one shared helper), so a hazard hidden
    behind a view is still a hazard and the sanitizer can never disagree
    with the planner about what aliases what."""
    from thunder_tpu_torch.analysis.liveness import alias_root_fn

    return alias_root_fn(ctx.bsyms)


@register_rule(
    "donation.donated-output",
    "No donated input buffer (or a view of one) is returned as a trace output",
)
def donated_output(ctx: VerifyContext) -> None:
    donated = set(ctx.trace.tags.get("donated_inputs") or ())
    if not donated:
        return
    root = _alias_root_fn(ctx)
    for out_name in sorted(ctx.output_names):
        r = root(out_name)
        if r in donated:
            via = "" if r == out_name else f" (via view {out_name!r})"
            ctx.report(
                "donation.donated-output",
                Severity.ERROR,
                f"input {r!r} is donated but its buffer is a trace "
                f"output{via} — the caller would receive a buffer the "
                "executable may already have reused",
                hint="drop the leaf from the donate set, or return a copy",
            )


@register_rule(
    "alias.entry-aliasing",
    "No in-place op mutates a trace input that is also (a view of) a trace output",
)
def entry_aliasing(ctx: VerifyContext) -> None:
    """The across-entry alias hazard: an input mutated in place AND returned
    (directly or through a view) means the caller's buffer and the entry's
    output alias — a later entry (or the caller) observes the mutation
    through a value it believes is functional."""
    from thunder_tpu_torch.core.proxies import Proxy

    root = None
    for i, bsym in enumerate(ctx.bsyms):
        if not bsym.has_tag(OpTags.IN_PLACE):
            continue
        idx = INPLACE_MUTATED_ARG.get(bsym.sym.id, 0)
        if idx >= len(bsym.args) or not isinstance(bsym.args[idx], Proxy):
            continue
        dst = bsym.args[idx]
        if root is None:
            root = _alias_root_fn(ctx)
        # The mutated DESTINATION may itself be a view of an input — the
        # caller's buffer is what gets written either way.
        dst_root = root(dst.name)
        if dst_root not in ctx.input_names:
            continue
        escaping = next(
            (n for n in sorted(ctx.output_names) if root(n) == dst_root), None
        )
        if escaping is not None:
            via = "" if escaping == dst_root else f" (through view {escaping!r})"
            ctx.report(
                "alias.entry-aliasing",
                Severity.ERROR,
                f"{bsym.sym.qualname} mutates trace input {dst_root!r} in place "
                f"and that buffer is a trace output{via} — the mutation "
                "aliases across the entry boundary",
                bsym_index=i,
                hint="functionalize: return the op's output proxy instead of "
                "the mutated input",
            )


# =============================================================================
# (4) DCE safety & orphan detection
# =============================================================================


@register_rule("dce.dead-symbol", "No side-effect-free symbol's outputs are all unused")
def dead_symbol(ctx: VerifyContext) -> None:
    defs_by_bsym: dict[int, list[str]] = {}
    for n, (j, _) in ctx.defs.items():
        defs_by_bsym.setdefault(j, []).append(n)
    for i, bsym in enumerate(ctx.bsyms):
        if bsym.has_tag(OpTags.DONT_DCE) or bsym.has_tag(OpTags.SIDE_EFFECT):
            continue
        defined = defs_by_bsym.get(i)
        if not defined:
            continue
        live = any(
            ctx.is_live_output(n) or ctx.consumed_after(n, i) is not None for n in defined
        )
        if not live:
            ctx.report(
                "dce.dead-symbol",
                Severity.WARNING,
                f"{bsym.sym.qualname} produces {defined!r} but nothing consumes them and "
                "the op carries no side-effect tag",
                bsym_index=i,
                hint="expected before DCE; after DCE this is a liveness bug in the pass "
                "(or the op needs an OpTags.SIDE_EFFECT/DONT_DCE tag)",
            )


@register_rule("names.orphan", "Registered names refer to proxies that exist in the trace")
def orphan_names(ctx: VerifyContext) -> None:
    seen = set(ctx.input_names) | set(ctx.output_names) | set(ctx.defs) | set(ctx.uses)
    orphans = sorted(n for n in ctx.trace._names if n not in seen)
    if orphans:
        sample = ", ".join(orphans[:8]) + ("…" if len(orphans) > 8 else "")
        ctx.report(
            "names.orphan",
            Severity.INFO,
            f"{len(orphans)} registered name(s) have no referent in this trace ({sample})",
            hint="expected after DCE/from_trace name-pool sharing; a fresh trace with "
            "orphans indicates names registered but never materialized",
        )
