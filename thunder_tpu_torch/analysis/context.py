"""VerifyContext: one walk over a trace, shared by every rule (a copy of ``thunder_tpu/analysis/context.py``).

The context precomputes the def/use structure of the top-level bound symbols
— producing bsym per proxy name, every consuming site, trace inputs (signature
params + arg/kwarg proxies), trace outputs — so each rule is a cheap pass over
indexes rather than another O(trace) walk with its own pytree flattening.
"""

from __future__ import annotations

from typing import Any, Optional

from thunder_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import (
    AnyProxy,
    CollectionProxy,
    FutureTensorProxy,
    NumberProxy,
    Proxy,
    TensorProxy,
)
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.trace import TraceCtx


def pass_name_of(trace: TraceCtx) -> Optional[str]:
    """The provenance pass name, stripped of the timing suffix."""
    if trace.provenance is None:
        return None
    return trace.provenance.pss.split(" (took ")[0]


def needs_definition(p: Proxy) -> bool:
    """Whether a consumed proxy must have a producer (or be a trace input).

    Tensor/future/collection proxies always flow through defs. Number and
    string proxies with a *known* value are guard-baked constants — legal to
    reference without a producer — but an unknown number (e.g. ``item()``'s
    result) must be produced in-trace. ``AnyProxy`` wraps unguardable baked
    leaves and is exempt.
    """
    if isinstance(p, (TensorProxy, CollectionProxy)):
        return True
    if isinstance(p, NumberProxy):
        return p.value is None
    return False


class VerifyContext:
    def __init__(self, trace: TraceCtx, pass_name: Optional[str] = None):
        self.trace = trace
        self.pass_name = pass_name if pass_name is not None else pass_name_of(trace)
        self.diagnostics: list[Diagnostic] = []
        self.bsyms = list(trace.bound_symbols)

        # -- trace inputs ----------------------------------------------------
        self.input_names: set[str] = set()
        flat_inputs, _ = tree_flatten((trace.args, trace.kwargs))
        for p in flat_inputs:
            if isinstance(p, Proxy):
                self.input_names.add(p.name)
        sig = trace.siginfo
        self.input_names.update(n for n in sig.params if isinstance(n, str))
        if sig.varargs:
            self.input_names.add(sig.varargs)
        if sig.varkwargs:
            self.input_names.add(sig.varkwargs)

        # -- trace outputs ---------------------------------------------------
        self.output_names: set[str] = set()
        self.output_proxies: list[Proxy] = []
        flat_out, _ = tree_flatten(trace.output)
        for p in flat_out:
            if isinstance(p, Proxy):
                self.output_names.add(p.name)
                self.output_proxies.append(p)

        # -- one walk: defs, redefs, uses ------------------------------------
        # name -> (bsym index of producer, proxy object)
        self.defs: dict[str, tuple[int, Proxy]] = {}
        # (bsym index, name, index of previous producer)
        self.redefs: list[tuple[int, str, int]] = []
        # name -> all consuming bsym indexes (python_del included)
        self.uses: dict[str, list[int]] = {}
        # name -> consuming bsym indexes that keep the value live (del excluded)
        self.live_uses: dict[str, list[int]] = {}
        # names produced as FutureTensorProxy: name -> producer index
        self.future_defs: dict[str, int] = {}

        for i, bsym in enumerate(self.bsyms):
            is_del = bsym.sym.id is PrimIDs.DEL
            arg_names: set[str] = set()
            for p in bsym.flat_proxy_args:
                arg_names.add(p.name)
                sites = self.uses.setdefault(p.name, [])
                if not sites or sites[-1] != i:  # one entry per consuming bsym
                    sites.append(i)
                if not is_del:
                    live = self.live_uses.setdefault(p.name, [])
                    if not live or live[-1] != i:
                        live.append(i)
            seen_out: set[str] = set()
            for o in bsym.flat_proxy_outs:
                # Pass-through (output IS an operand, e.g. unpack_trivial or an
                # identity composite) is not a definition; so is the same proxy
                # repeated within one output tree (e.g. (t, t)).
                if o.name in arg_names or o.name in seen_out:
                    continue
                seen_out.add(o.name)
                prev = self.defs.get(o.name)
                if prev is not None:
                    self.redefs.append((i, o.name, prev[0]))
                    continue
                self.defs[o.name] = (i, o)
                if isinstance(o, FutureTensorProxy):
                    self.future_defs[o.name] = i

    # -- queries used by rules ------------------------------------------------

    def defined_before(self, name: str, index: int) -> bool:
        if name in self.input_names:
            return True
        d = self.defs.get(name)
        return d is not None and d[0] < index

    def is_live_output(self, name: str) -> bool:
        return name in self.output_names

    def consumed_after(self, name: str, index: int, *, live_only: bool = True) -> Optional[int]:
        """First bsym index > ``index`` consuming ``name`` (None if none)."""
        sites = (self.live_uses if live_only else self.uses).get(name, ())
        for i in sites:
            if i > index:
                return i
        return None

    # -- reporting -------------------------------------------------------------

    def report(
        self,
        rule: str,
        severity: Severity,
        message: str,
        *,
        bsym_index: Optional[int] = None,
        hint: Optional[str] = None,
    ) -> None:
        self.diagnostics.append(
            Diagnostic(
                rule=rule,
                severity=severity,
                message=message,
                bsym_index=bsym_index,
                pass_name=self.pass_name,
                hint=hint,
            )
        )
