"""Static device-memory liveness planner over claimed execution traces.

The counterpart of ``thunder_tpu/analysis/liveness.py``: every
value-producing BoundSymbol's tensor outputs are assigned byte sizes from
their proxy metadata alone (dtype-aware; a symbolic trace's shapes are the
padded bucket ceilings), and an interval walk over the program computes the
live set after each line and its peak: the predicted high-water of running
the trace, which ``torch.cuda.max_memory_allocated`` reads on the card.

Lifetime model (the JAX package's, so that the two give the same bytes on
the same program, with the differences below stated and tested):

- trace inputs are live from entry and, not donated, to the end (the caller
  holds them). A donated input dies at its last use; the port stages no
  donated input (``analysis/rules.py``), so this applies only to a plan
  asked for with ``donated=``;
- every produced tensor goes live at its producing line and dies after its
  last consumer, alias-extended (a view's use keeps its root buffer alive);
  the ``python_del``s of ``del_last_used`` are ignored for freeing (per
  name; the interval analysis frees at the same point when no view remains);
- trace outputs never die (they are returned);
- layout/alias ops (reshape, squeeze, broadcast, shallow copy, stop
  gradient) charge nothing and extend their root's life;
- bookkeeping prims (unpacks, guards, del, return, comment) allocate nothing.

Where PyTorch differs from XLA, the port's model charges:

- the caching allocator's rounding: each buffer is charged its bytes
  rounded up to ``BLOCK_BYTES`` (512, the allocator's smallest block step);
  ``block_bytes=1`` gives the JAX package's exact bytes;
- saved tensors: a split forward/backward (the module frontend's) is planned
  as one program by :func:`plan_fw_bw`, the forward's outputs (its saved
  tensors among them) live into the backward until their last use there;
  ``grad``'s joint trace is one trace already;
- not charged: a ``reshape`` of a non-contiguous tensor copies in PyTorch.
  The trace's ``transpose`` is charged as a buffer (XLA's model) and the
  reshape after it as a view: the same bytes, one line earlier than torch
  allocates them. Workspace (cuBLAS's, the kernels' scratch), the
  allocator's fragmentation and the CUDA context are not charged, so the
  prediction is a lower bound on ``max_memory_allocated``.

Consumers: ``examine.memory_report(fn, *args)``, the ``mem.predicted-oom``
verifier rule (``THUNDER_TPU_CHECKS=1`` / ``jit(debug_checks=True)`` /
``examine.lint``), and :func:`predict_level_peaks` (the JAX package's
de-opt ladder's levels, of which the port has L0 = L1 = L2: no donation, no
ladder yet).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.analysis.cost import DeviceSpec, resolve_device_spec
from thunder_tpu_torch.analysis.diagnostics import Severity
from thunder_tpu_torch.analysis.registry import register_rule
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.trace import TraceCtx, debug_checks

BLOCK_BYTES = 512  # PyTorch's CUDA caching allocator rounds every block up to this

# Prims that allocate nothing and touch no tensor lifetimes (guards,
# unpacks, control plumbing). DEL/RETURN are handled explicitly.
_BOOKKEEPING_IDS = {
    PrimIDs.COMMENT, PrimIDs.PRINT,
    PrimIDs.UNPACK_TRIVIAL, PrimIDs.UNPACK_SEQUENCE, PrimIDs.UNPACK_KEY,
    PrimIDs.UNPACK_ATTR, PrimIDs.UNPACK_DIM,
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    PrimIDs.CHECK_STRING_VALUE, PrimIDs.CHECK_LEN, PrimIDs.CHECK_KEYS,
    PrimIDs.CHECK_NONE, PrimIDs.CHECK_DIM_BUCKET,
}

# Layout/alias ops that are views: zero bytes; output aliases arg 0.
_ALIAS_IDS = {
    PrimIDs.RESHAPE, PrimIDs.SQUEEZE, PrimIDs.BROADCAST_IN_DIM,
    PrimIDs.SHALLOW_COPY, PrimIDs.STOP_GRADIENT,
}


def build_alias_roots(bsyms) -> dict:
    """``{view name: immediate source name}`` for every alias-op output (the
    first tensor operand is the root): the one view model, shared by the
    liveness walk and the donation/alias rules."""
    alias: dict = {}
    for bsym in bsyms:
        if bsym.sym.id not in _ALIAS_IDS:
            continue
        src = next((p for p in bsym.flat_proxy_args if isinstance(p, TensorProxy)), None)
        if src is None:
            continue
        for o in bsym.flat_proxy_outs:
            if isinstance(o, TensorProxy) and o.name != src.name:
                alias[o.name] = src.name
    return alias


def alias_root_fn(bsyms):
    """``root(name) -> name`` resolving through the full view chain."""
    alias = build_alias_roots(bsyms)

    def root(name: str) -> str:
        while name in alias:
            name = alias[name]
        return name

    return root


@dataclass
class LivenessRow:
    """One value-producing trace line's live-set accounting."""

    index: int
    sym: str
    live_bytes: int       # live-set bytes AFTER this line executes
    alloc_bytes: int      # bytes this line's outputs charge
    freed_bytes: int      # bytes whose last use was this line
    line: str = ""


@dataclass
class MemoryPlan:
    """Predicted device-memory occupancy of one trace (or of a forward and
    its backward). ``peak_bytes`` is the maximum live set over the program;
    ``eager_alloc_bytes`` sums every tensor an op-by-op run materializes
    (produced tensors only, inputs excluded)."""

    device: DeviceSpec
    peak_bytes: int = 0
    peak_index: Optional[int] = None
    peak_sym: Optional[str] = None
    input_bytes: int = 0
    output_bytes: int = 0
    total_alloc_bytes: int = 0
    eager_alloc_bytes: int = 0
    donated_names: tuple = ()
    rows: list = field(default_factory=list)

    def format(self, top_k: int = 8) -> str:
        cap = device_capacity_bytes(self.device)
        lines = [
            f"memory plan [{self.device.name}" + (f": {cap / 1e9:.1f} GB]" if cap else "]"),
            f"  predicted peak: {self.peak_bytes / 1e6:.2f} MB"
            + (f" at L{self.peak_index} ({self.peak_sym})" if self.peak_index is not None else "")
            + (f" — {self.peak_bytes / cap * 100:.1f}% of device" if cap else ""),
            f"  inputs {self.input_bytes / 1e6:.2f} MB"
            + (f" ({len(self.donated_names)} donated)" if self.donated_names else "")
            + f", outputs {self.output_bytes / 1e6:.2f} MB, total allocated {self.total_alloc_bytes / 1e6:.2f} MB",
        ]
        hottest = sorted(self.rows, key=lambda r: r.live_bytes, reverse=True)[:top_k]
        if hottest:
            lines.append(f"  {'line':>6} {'sym':<28} {'live MB':>10} {'alloc MB':>10}")
            for r in hottest:
                lines.append(f"  L{r.index:>5} {r.sym:<28.28} {r.live_bytes / 1e6:>10.3f} {r.alloc_bytes / 1e6:>10.3f}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()


def device_capacity_bytes(device: Any = None) -> Optional[int]:
    """Usable device-memory bytes: the ``THUNDER_TPU_HBM_BYTES`` override
    first (re-read every call, as in the JAX package), then the allocator's
    limit when a CUDA device is present (``device``: a torch device or
    index; the current one by default): the card's ``total_memory`` times
    the fraction ``torch.cuda.set_per_process_memory_fraction`` set (the
    seat of the JAX backend's ``bytes_limit``), then the spec's datasheet
    capacity (0, unknown, for "cpu"). None when nothing is known."""
    env = os.environ.get("THUNDER_TPU_HBM_BYTES", "").strip()
    if env:
        try:
            return int(float(env))
        except ValueError:
            pass
    import torch

    if not isinstance(device, (DeviceSpec, str)) and torch.cuda.is_available():
        index = device.index if isinstance(device, torch.device) else device
        index = torch.cuda.current_device() if index is None else index
        total = torch.cuda.get_device_properties(index).total_memory
        fraction = getattr(torch.cuda, "get_per_process_memory_fraction", None)
        return int(total * (fraction(index) if fraction is not None else 1.0))
    try:
        spec = resolve_device_spec(device)
    except Exception:
        return None
    return int(spec.hbm_bytes) or None


def _tensor_bytes(p: TensorProxy, block: int) -> int:
    b = int(p.size_bytes)
    return -(-b // block) * block if block > 1 else b


def plan_liveness(trace: TraceCtx, *, device: Any = None, donated: Sequence[str] = (), include_rows: bool = True,
                  block_bytes: int = BLOCK_BYTES, live_in: Optional[dict] = None,
                  batched: Optional[tuple] = None) -> MemoryPlan:
    """Interval-based liveness walk over ``trace`` → :class:`MemoryPlan`.

    ``donated`` names input proxies that die at their last use (the trace's
    ``donated_inputs`` tag when empty). ``block_bytes`` rounds each buffer
    (the allocator's block; 1 for the JAX package's exact bytes).
    ``live_in`` maps names already live before the trace starts (a
    forward's outputs, for its backward) to their bytes: they count in the
    peak, and die at their last use here unless the trace returns them.
    ``batched=(V, input names)`` plans ``vmap`` of the trace over V slices
    (the trace is one slice's): the named inputs, and every tensor computed
    from one of them, are charged V times; the others once."""
    vmap_n, vmapped = (1, set()) if batched is None else (int(batched[0]), set(batched[1]))
    dev = resolve_device_spec(device)
    plan = MemoryPlan(device=dev)
    if donated == () and trace.tags.get("donated_inputs"):
        donated = tuple(trace.tags["donated_inputs"])
    plan.donated_names = tuple(donated)
    live_in = dict(live_in or {})
    dying_inputs = set(plan.donated_names) | set(live_in)

    bsyms = list(trace.bound_symbols)
    alias_root = build_alias_roots(bsyms)

    def root_of(name: str) -> str:
        while name in alias_root:
            name = alias_root[name]
        return name

    sizes: dict[str, int] = dict(live_in)
    inputs = [a for a in tree_flatten((trace.args, trace.kwargs))[0] if isinstance(a, TensorProxy)]
    for a in inputs:
        sizes.setdefault(a.name, _tensor_bytes(a, block_bytes) * (vmap_n if a.name in vmapped else 1))
    input_names = {a.name for a in inputs} | set(live_in)
    plan.input_bytes = sum(sizes[n] for n in input_names)
    out_names = {p.name for p in tree_flatten(trace.output)[0] if isinstance(p, TensorProxy)}

    # The last consumer of each root buffer, through aliases (dels ignored).
    last_use: dict[str, int] = {}
    for i, bsym in enumerate(bsyms):
        if bsym.sym.id is PrimIDs.DEL:
            continue
        for p in bsym.flat_proxy_args:
            if isinstance(p, TensorProxy):
                last_use[root_of(p.name)] = i
    dying_at: dict[int, list] = {}
    for name, i in last_use.items():
        dying_at.setdefault(i, []).append(name)

    live: dict[str, int] = {n: sizes[n] for n in input_names}
    cur = sum(live.values())
    plan.peak_bytes = cur
    plan.total_alloc_bytes = cur

    def free(name: str) -> int:
        """Free ``name`` if it may die: never outputs; inputs only when
        donated or handed in live."""
        r = root_of(name)
        if r in out_names or (r in input_names and r not in dying_inputs):
            return 0
        return live.pop(r, 0)

    for i, bsym in enumerate(bsyms):
        sid = bsym.sym.id
        if sid is PrimIDs.RETURN:
            break
        if sid is PrimIDs.DEL or sid in _BOOKKEEPING_IDS:
            continue
        alloc = eager = 0
        arg_names = {p.name for p in bsym.flat_proxy_args}
        per_slice = not vmapped.isdisjoint(arg_names)
        for o in bsym.flat_proxy_outs:
            if not isinstance(o, TensorProxy) or o.name in arg_names:
                continue
            if per_slice:
                vmapped.add(o.name)
            b = _tensor_bytes(o, block_bytes) * (vmap_n if per_slice else 1)
            sizes.setdefault(o.name, b)
            eager += b
            if sid in _ALIAS_IDS or o.name in alias_root:
                continue  # view: no new buffer
            if o.name not in live:
                live[o.name] = b
                alloc += b
        cur += alloc
        plan.total_alloc_bytes += alloc
        plan.eager_alloc_bytes += eager
        if cur > plan.peak_bytes:
            plan.peak_bytes, plan.peak_index, plan.peak_sym = cur, i, bsym.sym.name
        freed = 0
        out_here = {o.name for o in bsym.flat_proxy_outs if isinstance(o, TensorProxy)}
        for name in dying_at.get(i, ()):
            if name not in out_here:
                freed += free(name)
        cur -= freed
        if include_rows and (alloc or freed or bsym.flat_proxy_outs):
            plan.rows.append(LivenessRow(index=i, sym=bsym.sym.name, live_bytes=int(cur), alloc_bytes=int(alloc),
                                         freed_bytes=int(freed)))

    plan.output_bytes = sum(sizes.get(root_of(n), 0) for n in out_names)
    return plan


def plan_fw_bw(fw: TraceCtx, bw: TraceCtx, *, device: Any = None, block_bytes: int = BLOCK_BYTES) -> MemoryPlan:
    """One plan over a split step: the forward, then the backward with the
    forward's outputs (its result and its saved tensors) live into it, each
    dying at its last use there. The backward's saved inputs are matched to
    the forward's outputs by position (``bw.args[0]`` is the saved tuple,
    the forward's second output, as the module frontend splits them)."""
    f = plan_liveness(fw, device=device, include_rows=False, block_bytes=block_bytes)
    fw_outs = [p for p in tree_flatten(fw.output)[0] if isinstance(p, TensorProxy)]
    saved_fw = [p for p in tree_flatten(fw.output[1] if isinstance(fw.output, (tuple, list)) and len(fw.output) == 2
                                         else ())[0] if isinstance(p, TensorProxy)]
    saved_bw = [p for p in tree_flatten(bw.args[0] if bw.args else ())[0] if isinstance(p, TensorProxy)]
    live_in = {b.name: _tensor_bytes(s, block_bytes) for s, b in zip(saved_fw, saved_bw)}
    # The forward's other outputs (the loss, the returned activations) stay
    # with the caller through the backward.
    held = sum(_tensor_bytes(p, block_bytes) for p in fw_outs if p.name not in {s.name for s in saved_fw})
    b = plan_liveness(bw, device=device, include_rows=False, block_bytes=block_bytes, live_in=live_in)
    plan = MemoryPlan(device=f.device, input_bytes=f.input_bytes, output_bytes=b.output_bytes + held)
    plan.peak_bytes = max(f.peak_bytes, f.input_bytes + held + b.peak_bytes)
    fw_wins = f.peak_bytes >= plan.peak_bytes
    plan.peak_index, plan.peak_sym = (f.peak_index, f.peak_sym) if fw_wins else (b.peak_index, b.peak_sym)
    plan.total_alloc_bytes = f.total_alloc_bytes + b.total_alloc_bytes
    plan.eager_alloc_bytes = f.eager_alloc_bytes + b.eager_alloc_bytes
    return plan


def _marked_bytes(sym_spec, true_extents: Optional[dict], arg_proxies: Optional[Sequence]) -> Optional[tuple]:
    """(padded_bytes, exact_bytes) summed over the marked input leaves: full
    numel times dtype bytes with marked dims at the bucket ceiling against
    the failing call's exact extents (two marked dims of one leaf multiply).
    None when the spec, extents or shapes are unknown."""
    if sym_spec is None or not true_extents:
        return None
    padded = 0.0
    exact = 0.0
    for li, dims in sym_spec.marks.items():
        if arg_proxies is None or li >= len(arg_proxies):
            return None
        p = arg_proxies[li]
        if not isinstance(p, TensorProxy):
            return None
        padded_numel = float(p.numel)
        exact_numel = padded_numel
        for _d, (_lo, hi, cid) in dims.items():
            e = true_extents.get(cid)
            if e is None or not hi:
                return None
            exact_numel *= float(e) / float(hi)
        padded += padded_numel * p.dtype.bytes
        exact += exact_numel * p.dtype.bytes
    if not padded:
        return None
    return padded, exact


def exact_shape_scale(sym_spec, true_extents: Optional[dict], arg_proxies: Optional[Sequence] = None) -> Optional[float]:
    """Byte ratio exact/padded over the marked input leaves: how much the
    de-opt ladder's L3 (exact shapes) shrinks the bucket-padded activations.
    Each marked leaf weighs in with its full numel times dtype bytes, marked
    dims at the padded ceiling against the failing call's exact extents, so
    a tiny mask leaf cannot dilute a large activation's shrinkage.
    ``arg_proxies`` are the trace's tensor args, aligned with the spec's
    leaf indices. None when the spec, extents or shapes are unknown: the
    caller treats that level as unprovable, never skippable."""
    mb = _marked_bytes(sym_spec, true_extents, arg_proxies)
    if mb is None:
        return None
    return _scale_of(*mb)


def _scale_of(padded_bytes: float, exact_bytes: float) -> float:
    """The clamped byte ratio, shared by :func:`exact_shape_scale` and the L3
    pricing of :func:`predict_level_peaks`."""
    return max(min(exact_bytes / padded_bytes, 1.0), 1e-3)


def predict_level_peaks(
    trace: TraceCtx,
    *,
    sym_spec=None,
    donated: Sequence[str] = (),
    true_extents: Optional[dict] = None,
    device: Any = None,
    bucketing_unknown: bool = False,
) -> dict[int, Optional[int]]:
    """Predicted peak bytes at each level of the de-opt ladder
    (``resilience/deopt.py``; ``thunder_tpu/analysis/liveness.py``): L0 as
    compiled (with ``donated``), L1 donation off, L2 the joint program
    rematerialized as the ladder compiles it (``rematerialize_joint`` under
    ``aggressive_remat``; L1's plan when it recomputes nothing), L3 exact
    shapes: L2's plan with the marked inputs at their exact bytes and the
    activation share scaled by the exact/padded byte ratio, so it stays a
    lower bound. A ``None`` peak means unknown, never skipped:
    ``bucketing_unknown=True`` forces L3 unknown (a symbolic-cache function
    failing before its entry exists may hold a padded trace), as does a
    padded entry whose extents are unknown. With no ``sym_spec`` the entry
    has no padding and L3 is L2. The ladder uses the peaks to skip a level
    that cannot fit."""
    from thunder_tpu_torch.executors.passes import del_last_used
    from thunder_tpu_torch.transforms.rematerialization import aggressive_remat, rematerialize_joint

    base = plan_liveness(trace, device=device, donated=donated, include_rows=False)
    if donated or trace.tags.get("donated_inputs"):
        tag = trace.tags.pop("donated_inputs", None)
        try:
            no_don = plan_liveness(trace, device=device, include_rows=False)
        finally:
            if tag is not None:
                trace.tags["donated_inputs"] = tag
    else:
        no_don = base
    with aggressive_remat(), debug_checks(False):
        remat = rematerialize_joint(trace)
    l2 = no_don if remat is trace else plan_liveness(del_last_used(remat), device=device, include_rows=False)
    peaks: dict[int, Optional[int]] = {0: base.peak_bytes, 1: no_don.peak_bytes, 2: l2.peak_bytes,
                                       3: l2.peak_bytes}
    args = [a for a in tree_flatten((trace.args, trace.kwargs))[0] if isinstance(a, TensorProxy)]
    mb = _marked_bytes(sym_spec, true_extents, args)
    if bucketing_unknown:
        peaks[3] = None
    elif mb is not None:
        # The marked inputs shrink to their exact bytes and the activations
        # by the byte ratio; unmarked inputs (weights) do not. A ratio of 1.0
        # (the call sits at its bucket ceilings) is a known peak equal to
        # L2's, so L3 is proven unfit when L2 is.
        padded_m, exact_m = mb
        scale = _scale_of(padded_m, exact_m)
        inputs_l3 = max(l2.input_bytes - padded_m + exact_m, 0.0)
        act = max(l2.peak_bytes - l2.input_bytes, 0)
        peaks[3] = int(inputs_l3 + act * scale)
    elif sym_spec is not None:
        peaks[3] = None  # a padded entry with unknown extents proves nothing
    return peaks


# =============================================================================
# examine.memory_report
# =============================================================================


def claimed_trace(fn: Callable, args: tuple, kwargs: dict, executors: Any = None):
    """The execution trace ``jit`` would run for ``fn`` on the example
    inputs (acquisition → DCE → CSE → the compiled function's trace
    transforms (grad, autocast) → claiming → ``del_last_used``), built with
    the verifier off. A function compiled by ``jit``/``grad`` is traced
    through its original function and transforms, with its executors unless
    ``executors`` is given."""
    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.transforms.common import cse, dce

    transforms = ()
    cd = getattr(fn, "_lc_cd", None)
    if cd is not None:
        fn, transforms = cd.fn, tuple(cd.trace_transforms)
        executors = cd.executors_list if executors is None else executors
    with debug_checks(False):
        _, comp = trace_program(fn, args, kwargs)
        comp = cse(dce(comp))
        for transform in transforms:
            comp = transform(comp)
        return del_last_used(transform_for_execution(comp, resolve_executors(executors)))


def memory_report(fn: Callable, *args, executors: Any = None, device: Any = None, **kwargs) -> MemoryPlan:
    """The :class:`MemoryPlan` of the execution trace ``fn`` compiles to on
    the example inputs (:func:`claimed_trace`), before anything runs on the
    device. ``examine.memory_report`` re-exports this."""
    return plan_liveness(claimed_trace(fn, args, kwargs, executors), device=device)


# =============================================================================
# Verifier rule: predicted OOM
# =============================================================================

# Traces smaller than this are guard/prologue plumbing.
_MIN_RULE_BSYMS = 4


@register_rule("mem.predicted-oom", "The trace's predicted peak live set fits the device's capacity")
def predicted_oom(ctx) -> None:
    """WARNING when the static live-set peak exceeds the device's capacity:
    a run is predicted to fail for memory before any allocation. A warning,
    not an error: the plan is a lower bound on what the allocator takes,
    so a plan over capacity cannot fit, but one under it may still not."""
    if len(ctx.bsyms) < _MIN_RULE_BSYMS:
        return
    try:
        cap = device_capacity_bytes()
        if not cap:
            return
        plan = plan_liveness(ctx.trace, include_rows=False)
    except Exception:  # noqa: BLE001 — planning must never break verification
        return
    if plan.peak_bytes > cap:
        ctx.report(
            "mem.predicted-oom",
            Severity.WARNING,
            f"predicted peak live-set {plan.peak_bytes / 1e9:.2f} GB exceeds the {plan.device.name} device capacity "
            f"{cap / 1e9:.2f} GB" + (f" (peak at L{plan.peak_index}.{plan.peak_sym})"
                                     if plan.peak_index is not None else ""),
            bsym_index=plan.peak_index,
            hint="expect an out-of-memory error; use a smaller batch or sequence, or rematerialize more of the "
                 "forward",
        )
