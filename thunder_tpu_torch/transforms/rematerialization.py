"""Rematerialization: trade recompute for saved-for-backward memory.

Reference parity: thunder/core/rematerialization.py — the min-cut
recompute-vs-save decision between forward and backward
(`rematerialize_forward_and_backward:567`). The counterpart of
``thunder_tpu/transforms/rematerialization.py``: a saved tensor is
recomputed in the backward when its producer closure contains only cheap ops
(elementwise / shape / creation / cast) and the closure's inputs cost fewer
saved bytes than the tensor itself; the save boundary is the s-t min cut of
``_min_cut_saved_set``. Matmul/reduction/random results are never
recomputed. Run eagerly, each recomputed op is one more kernel in the
backward, paid for with the saved bytes it frees.
"""

from __future__ import annotations

import time
from typing import Optional

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, wrap_in_trace_provenance
from thunder_tpu_torch.transforms.common import dce

# Ops worth recomputing: one elementwise or shape pass each. Everything else
# (matrix products, reductions, gathers, RNG, collectives) stays saved.
_CHEAP_TAGS = {OpTags.ELEMENTWISE_UNARY_OP, OpTags.ELEMENTWISE_BINARY_OP, OpTags.SHAPE_OP}
_CHEAP_IDS = {
    PrimIDs.CONVERT_ELEMENT_TYPE,
    PrimIDs.FULL,
    PrimIDs.IOTA,
    PrimIDs.WHERE,
    PrimIDs.BROADCAST_IN_DIM,
    PrimIDs.SHALLOW_COPY,
}

_MAX_CHAIN = 64  # recompute-chain length bound


def _is_cheap(bsym) -> bool:
    if bsym.sym.id in _CHEAP_IDS:
        return True
    return any(t in _CHEAP_TAGS for t in bsym.sym.tags)


def rematerialize_forward_and_backward(fw_trace: TraceCtx, bw_trace: TraceCtx, *, remat_collectives: bool = False):
    """Shrink saved-for-backward by recomputing cheap chains in backward.

    Returns (new_fw, new_bw). fw's output structure stays
    ``(outputs, saved_tuple)``; bw's args stay ``saved... + cotangents...``.

    ``remat_collectives=True`` is FSDP's ZERO3 (thunder_tpu/transforms/
    rematerialization.py:83-125): a ``synchronize`` or ``all_gather`` of a
    trace argument (a parameter's dim-0 shard) counts as cheap, so the
    backward gathers the parameter again from its shard instead of saving
    the full parameter.
    """
    start = time.perf_counter_ns()

    saved_names: list[str] = list(fw_trace.tags.get("saved_for_backward", []))
    if not saved_names:
        return fw_trace, bw_trace

    producers: dict[str, object] = {}
    for bsym in fw_trace.bound_symbols:
        for o in bsym.flat_proxy_outs:
            producers.setdefault(o.name, bsym)

    arg_proxies = {a.name: a for a in fw_trace.args if isinstance(a, TensorProxy)}

    if remat_collectives:
        from thunder_tpu_torch.distributed.prims import DistOpIDs

        def is_cheap(bsym) -> bool:
            if bsym.sym.id in (DistOpIDs.SYNCHRONIZE, DistOpIDs.ALL_GATHER):
                a = next(iter(bsym.flat_proxy_args), None)
                return a is not None and a.name in arg_proxies
            return _is_cheap(bsym)
    else:
        is_cheap = _is_cheap

    # Closure analysis: name → (chain bsyms in topo order, frontier names) or None.
    memo: dict[str, Optional[tuple]] = {}

    def closure(name: str):
        if name in memo:
            return memo[name]
        if name in arg_proxies:
            memo[name] = ([], {name})
            return memo[name]
        bsym = producers.get(name)
        if bsym is None or not is_cheap(bsym):
            memo[name] = None  # must be saved / is a frontier
            return None
        chain: list = []
        frontier: set[str] = set()
        for a in bsym.flat_proxy_args:
            sub = closure(a.name)
            if sub is None:
                frontier.add(a.name)
            else:
                sub_chain, sub_frontier = sub
                for b in sub_chain:
                    if b not in chain:
                        chain.append(b)
                frontier |= sub_frontier
        chain.append(bsym)
        if len(chain) > _MAX_CHAIN:
            memo[name] = None
            return None
        memo[name] = (chain, frontier)
        return memo[name]

    def size_of(name: str) -> int:
        p = arg_proxies.get(name)
        if p is None:
            b = producers.get(name)
            p = next((o for o in b.flat_proxy_outs if o.name == name), None) if b else None
        return p.size_bytes if isinstance(p, TensorProxy) else 0

    def closure_until(name: str, stops: set[str]):
        """Recompute chain for ``name`` walking cheap producers, stopping at
        ``stops``/args. Returns (chain, frontier) or None if blocked."""
        chain: list = []
        frontier: set[str] = set()
        visiting: set[str] = set()

        def walk(n: str) -> bool:
            if n in stops or n in arg_proxies:
                frontier.add(n)
                return True
            if n in visiting:
                return True
            visiting.add(n)
            b = producers.get(n)
            if b is None or not is_cheap(b):
                return False
            for a in b.flat_proxy_args:
                if not walk(a.name):
                    return False
            if b not in chain:
                chain.append(b)
            return True

        return (chain, frontier) if walk(name) else None

    keep: list[str] = []
    recompute: dict[str, tuple] = {}
    cut_set = _min_cut_saved_set(saved_names, producers, arg_proxies, closure, size_of, is_cheap)

    if cut_set is not None:
        # Min-cut chose the optimal save boundary (possibly mid-chain).
        stops = set(cut_set)
        for name in saved_names:
            if name in cut_set or name in arg_proxies:
                if name not in keep:
                    keep.append(name)
                continue
            c = closure_until(name, stops)
            if c is None or not c[0]:
                keep.append(name)
            else:
                recompute[name] = c
        # Cut nodes that aren't original saved values become new saved values
        # via the recompute frontiers (handled below).
    else:
        for name in saved_names:
            c = closure(name)
            if c is None or not c[0]:
                keep.append(name)
                continue
            chain, frontier = c
            # Greedy fallback: frontier tensors not already saved/args become
            # extra saved values; recompute only if it's a net win in bytes.
            extra = [f for f in frontier if f not in saved_names and f not in arg_proxies and f not in keep]
            extra_bytes = sum(size_of(f) for f in extra)
            if extra_bytes >= size_of(name):
                keep.append(name)
                continue
            recompute[name] = (chain, frontier)

    if not recompute:
        return fw_trace, bw_trace

    # New saved set: kept names + all recompute frontiers not already
    # available. Frontiers are sets — iterate them SORTED so the saved-tuple
    # order is identical across processes (unsorted iteration varies with
    # the per-process hash seed).
    new_saved: list[str] = list(keep)
    for name, (chain, frontier) in recompute.items():
        for f in sorted(frontier):
            if f not in new_saved and f not in arg_proxies:
                new_saved.append(f)
    # Frontier values that are fw *args* must still be passed to bw.
    needed_args = sorted(
        {f for _, (c, fr) in recompute.items() for f in fr if f in arg_proxies}
    )
    for f in needed_args:
        if f not in new_saved:
            new_saved.append(f)

    def proxy_of(name: str) -> TensorProxy:
        if name in arg_proxies:
            return arg_proxies[name]
        b = producers[name]
        return next(o for o in b.flat_proxy_outs if o.name == name)

    # --- rebuild bw: original body, each recomputed op just before its first
    # consumer (deduped, fw order) ---
    chain_bsyms: list = []
    seen = set()
    for name, (chain, _) in recompute.items():
        for b in chain:
            if id(b) not in seen:
                seen.add(id(b))
                chain_bsyms.append(b)
    fw_order = {id(b): i for i, b in enumerate(fw_trace.bound_symbols)}
    chain_bsyms.sort(key=lambda b: fw_order.get(id(b), 0))

    cotangents = list(bw_trace.args[len(saved_names):])

    new_bw = from_trace(bw_trace)
    new_bw.args = tuple(proxy_of(n) for n in new_saved) + tuple(cotangents)
    new_bw.bound_symbols.extend(_sink(chain_bsyms, bw_trace.bound_symbols))
    new_bw = dce(new_bw)

    # --- rebuild fw: same body, new saved tuple in the output -----------------
    new_fw = from_trace(fw_trace)
    primal_out = fw_trace.output[0]
    saved_tuple = tuple(proxy_of(n) for n in new_saved)
    new_fw.bound_symbols.extend(
        b for b in fw_trace.bound_symbols if b.sym.id is not PrimIDs.RETURN
    )
    from thunder_tpu_torch.core import prims as _prims
    from thunder_tpu_torch.core.trace import tracectx

    new_out = (primal_out, saved_tuple)
    with tracectx(new_fw):
        _prims.python_return(new_out)
    new_fw.output = new_out
    new_fw = dce(new_fw)
    new_fw.tags["saved_for_backward"] = list(new_saved)

    new_fw = wrap_in_trace_provenance(new_fw, "Rematerialization (fw)", start)
    new_bw = wrap_in_trace_provenance(new_bw, "Rematerialization (bw)", start)
    return new_fw, new_bw


def _min_cut_saved_set(saved_names, producers, arg_proxies, closure, size_of, is_cheap=_is_cheap):
    """Optimal save boundary via s-t min cut (reference:
    rematerialization.py:245 — igraph max-flow; here the in-repo C++ Dinic,
    thunder_tpu_torch/csrc/mincut.cpp, or the same algorithm in Python).

    Node-split graph over the cheap recompute region:
      S → seed_in (∞) for every available value (fw arg / expensive output),
      v_in → v_out (bytes(v)) for every region proxy — cutting = saving v,
      x_out → w_in (∞) along cheap dataflow,
      v_out → T (∞) for every currently-saved value.
    The min cut is the cheapest set of proxies that separates availability
    from the backward's needs; everything on the sink side recomputes.
    Returns the save set (names), or None when the region is trivial.
    """
    from thunder_tpu_torch.transforms.mincut import INF_CAP, min_cut

    # Region discovery: union of all saved values' cheap closures.
    region: set[str] = set()
    seeds: set[str] = set()
    targets: set[str] = set()
    for name in saved_names:
        c = closure(name)
        if c is None or not c[0]:
            seeds.add(name)
            targets.add(name)
            continue
        chain, frontier = c
        targets.add(name)
        seeds |= frontier
        region.add(name)
        for b in chain:
            for o in b.flat_proxy_outs:
                region.add(o.name)
            for a in b.flat_proxy_args:
                region.add(a.name)
    if not region or len(region) > 4096:
        return None

    all_nodes = sorted(region | seeds | targets)
    idx: dict[str, int] = {}
    n = 2  # 0 = S, 1 = T
    for name in all_nodes:
        idx[name] = n
        n += 2  # v_in = idx, v_out = idx + 1

    edges: list[tuple] = []
    for name in all_nodes:
        vi, vo = idx[name], idx[name] + 1
        cap = max(size_of(name), 1)
        edges.append((vi, vo, cap))
        if name in seeds or name in arg_proxies:
            edges.append((0, vi, INF_CAP))
        if name in targets:
            edges.append((vo, 1, INF_CAP))
        b = producers.get(name)
        if name not in seeds and name not in arg_proxies and b is not None and is_cheap(b):
            for a in b.flat_proxy_args:
                if a.name in idx:
                    edges.append((idx[a.name] + 1, vi, INF_CAP))

    _, source_side = min_cut(n, edges, 0, 1)

    cut = {name for name in all_nodes if idx[name] in source_side and idx[name] + 1 not in source_side}
    if not cut:
        return None
    return cut


def _sink(chain: list, body: list) -> list:
    """``body`` with each op of ``chain`` (in dependency order) placed just
    before its first consumer. Run eagerly, a recomputed tensor then lives
    from just before its first use; computed all at the top of the backward,
    the recomputed tensors of every layer would be live at once beside the
    saved ones, and remat would raise the peak instead of lowering it."""
    producer = {o.name: b for b in chain for o in b.flat_proxy_outs}
    emitted: set[int] = set()
    out: list = []

    def emit_inputs(b) -> None:
        for a in b.flat_proxy_args:
            p = producer.get(a.name)
            if p is not None and id(p) not in emitted:
                emitted.add(id(p))
                emit_inputs(p)
                out.append(p)

    for b in body:
        emit_inputs(b)
        out.append(b)
    return out
