"""Trace pattern matching for custom peephole transforms.

The port's copy of ``thunder_tpu/core/patterns.py``.
Reference parity: thunder/core/patterns.py (`bind_names:19`, `match_all:364`)
— a small combinator API for finding op sequences in a trace and rewriting
them, used to prototype fusion/peephole passes without writing a full
visitor.

A :class:`Pattern` is an ordered list of per-op predicates. ``match_all``
scans the trace's top-level bound symbols in program order and returns
non-overlapping :class:`Match` es; steps may be separated by unrelated ops
(``allow_gaps=True``, the default) as long as the later step consumes a
proxy produced by an earlier matched step when ``connected=True``.

Rewrites go through :func:`replace`, which splices replacement bound symbols
(built inside a fresh trace context so new proxies get unique names) over a
match and leaves everything else untouched. DCE afterwards cleans dangling
producers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx


Predicate = Callable[[Any], bool]


def _to_pred(p: Union[Predicate, Any]) -> Predicate:
    """An op id (PrimIDs member / symbol-id string) or a callable predicate."""
    if callable(p) and not hasattr(p, "__self__"):
        # A plain callable predicate over the bound symbol.
        return p
    return lambda bsym, _id=p: bsym.sym.id == _id


@dataclass
class Match:
    """One pattern occurrence: the matched bound symbols (in program order),
    their trace indices, and name → bsym bindings."""

    bsyms: list
    indices: list
    bindings: dict = field(default_factory=dict)

    def __getitem__(self, name: str):
        return self.bindings[name]


class Pattern:
    """Ordered op-sequence pattern (reference: patterns.py).

    >>> p = Pattern().match(PrimIDs.MUL, "m").match(PrimIDs.ADD, "a")
    >>> for m in p.match_all(trace):
    ...     print(m["m"], m["a"])
    """

    def __init__(self):
        self._steps: list[tuple[Predicate, Optional[str]]] = []

    def match(self, op: Union[Predicate, Any], name: Optional[str] = None) -> "Pattern":
        """Append a step: ``op`` is a symbol id (e.g. ``PrimIDs.MUL``, the
        enum member, or a torchsymbol id string) or a predicate
        ``bsym -> bool``; ``name`` binds the matched bsym in the Match."""
        self._steps.append((_to_pred(op), name))
        return self

    def match_all(
        self,
        trace: TraceCtx,
        *,
        allow_gaps: bool = True,
        connected: bool = True,
    ) -> list[Match]:
        """All non-overlapping occurrences, scanning left to right.

        ``allow_gaps``: unrelated ops may sit between matched steps.
        ``connected``: each step after the first must consume at least one
        proxy produced by a previously matched step (the usual dataflow-chain
        pattern; set False for purely positional matching)."""
        bsyms = list(trace.bound_symbols)
        matches: list[Match] = []
        used: set[int] = set()
        i = 0
        while i < len(bsyms):
            m = self._try_from(bsyms, i, used, allow_gaps, connected)
            if m is not None:
                matches.append(m)
                used.update(m.indices)
                i = m.indices[0] + 1
            else:
                i += 1
        return matches

    def _try_from(self, bsyms, start, used, allow_gaps, connected) -> Optional[Match]:
        pred0, name0 = self._steps[0]
        if start in used or not pred0(bsyms[start]):
            return None
        matched = [bsyms[start]]
        indices = [start]
        bindings = {name0: bsyms[start]} if name0 else {}
        produced = {o.name for o in bsyms[start].flat_proxy_outs}
        j = start + 1
        for pred, name in self._steps[1:]:
            found = False
            while j < len(bsyms):
                b = bsyms[j]
                if j not in used and pred(b) and (
                    not connected
                    or any(a.name in produced for a in b.flat_proxy_args)
                ):
                    matched.append(b)
                    indices.append(j)
                    if name:
                        bindings[name] = b
                    produced |= {o.name for o in b.flat_proxy_outs}
                    j += 1
                    found = True
                    break
                if not allow_gaps:
                    return None
                j += 1
            if not found:
                return None
        return Match(matched, indices, bindings)


def replace(trace: TraceCtx, match: Match, builder: Callable[[Match], Any]) -> TraceCtx:
    """Rewrite one match: ``builder(match)`` runs inside a fresh trace scope
    and records replacement ops (it may call clang/prims/ltorch symbols); its
    recorded bound symbols are spliced in place of the match's first bsym and
    the remaining matched bsyms are dropped. The builder must end by mapping
    the old outputs — return a dict {old_proxy_name: new_proxy} and every
    downstream reference is swapped."""
    from thunder_tpu_torch.core.proxies import Proxy, variableify
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten

    new_trace = from_trace(trace)
    recorded: list = []
    with tracectx(new_trace):
        new_trace.push_scope(recorded)
        out_map = builder(match) or {}
        new_trace.pop_scope()

    swap = dict(out_map)
    swap_map = {
        variableify(old_proxy): new for old_proxy, new in _proxy_pairs(trace, swap)
    }

    drop = set(match.indices[1:])
    first = match.indices[0]

    # Refuse unsafe rewrites: an op OUTSIDE the match consuming a matched
    # intermediate that the builder did not remap would reference an
    # undefined proxy after the splice (allow_gaps matches permit exactly
    # this shape).
    matched_set = set(match.indices)
    dropped_outs = {
        o.name
        for i in matched_set
        for o in trace.bound_symbols[i].flat_proxy_outs
        if o.name not in swap
    }
    surviving = [
        b for i, b in enumerate(trace.bound_symbols) if i not in matched_set
    ]
    # The builder's own recorded ops are spliced in too — they may also not
    # reference a dropped matched intermediate (its producer is gone).
    for bsym in list(surviving) + recorded:
        for a in bsym.flat_proxy_args:
            if a.name in dropped_outs:
                raise ValueError(
                    f"replace(): op {bsym.sym.name!r} consumes matched "
                    f"intermediate {a.name!r} whose producer is removed by the "
                    f"rewrite; have the builder return a mapping for it, use "
                    f"the match's original inputs, or match the consumer too"
                )
    flat_trace_out, _ = tree_flatten(trace.output)
    for p in flat_trace_out:
        if isinstance(p, Proxy) and p.name in dropped_outs:
            raise ValueError(
                f"replace(): trace output {p.name!r} is a matched intermediate "
                f"with no replacement mapping"
            )
    out_bsyms = []
    for i, bsym in enumerate(trace.bound_symbols):
        if i == first:
            out_bsyms.extend(recorded)
            continue
        if i in drop:
            continue
        if swap_map:
            bsym = bsym.from_bsym_swap_proxies(swap_map, skip_output=True)
        out_bsyms.append(bsym)
    new_trace.bound_symbols = out_bsyms

    # Outputs may reference replaced proxies.
    flat_out, spec = tree_flatten(new_trace.output)
    new_trace.output = tree_unflatten(
        [swap.get(p.name, p) if isinstance(p, Proxy) else p for p in flat_out], spec
    )
    return new_trace


def _proxy_pairs(trace: TraceCtx, swap: dict):
    """(old_proxy, new_proxy) pairs for names in ``swap``, resolved from the
    trace's producers/args."""
    by_name = {}
    for a in trace.args:
        if hasattr(a, "name"):
            by_name[a.name] = a
    for b in trace.bound_symbols:
        for o in b.flat_proxy_outs:
            by_name[o.name] = o
    return [(by_name[n], p) for n, p in swap.items() if n in by_name]
