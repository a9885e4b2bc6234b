"""Pad-mask threading for symbolic-values caching.

The port's copy of ``thunder_tpu/transforms/padmask.py``: the same rules
over the port's prims.

Under ``cache="symbolic values"`` the trace is acquired on BUCKET-PADDED
inputs (core/bucketing.py): a marked dim's extent in the trace is the bucket
ceiling, and the dispatcher zero-pads real inputs up to it. Padding is exact
for row-independent compute (elementwise, matmul over non-padded contractions,
causal attention), but a REDUCTION over a padded dim would fold the pad rows
into the result. This pass makes those reductions exact for every extent in
the bucket:

1. **Dim provenance**: starting from the marked input dims, track which dims
   of every intermediate carry padding, through shape ops (broadcast,
   transpose, reshape-merge), elementwise ops, matmuls, gathers and
   reductions. A reshape that merges a padded dim keeps its factor structure
   so the mask can be rebuilt in the merged layout (``(B,T,V)->(B*T,V)``).

2. **Masked rewrites**: ``sum``/``prod``/``amax``/``amin``/``argmax``/
   ``argmin``/``topk`` over a padded dim are rewritten against a validity
   mask built from the RUNTIME true extent — a fresh 0-d int32 input appended
   to the trace (``iota(P) < n_true``) — so ONE staged program serves the whole
   bucket with exact reduction semantics. A matmul whose contracted dim is
   padded gets the mask multiplied into its left operand (zeros contribute
   nothing to the contraction).

3. **Mean-count fix**: ``div(sum(x), k)`` / ``mul(sum(x), 1/k)`` where ``k``
   is the padded element count is re-pointed at the runtime true count, so
   means (cross-entropy losses included) match the unpadded computation.
   Known sharp edge: a USER literal that happens to equal the padded element
   count is indistinguishable from a shape-derived count and is re-pointed
   too (``sum(x, 0) / 4.0`` with a bucket ceiling of 4 divides by the true
   extent). Shape-derived counts (``x.shape[0]`` or ``mean``) are what this
   targets; keep literal divisors away from padded-dim sums or use exact
   caching for those dims (documented in docs/caching.md).

Ops the propagator does not model drop tracking for their outputs with a
one-time warning — downstream reductions over those values then see padded
rows (same behavior as no masking at all, but LOUD). The pass also returns a
crop plan: which output dims carry padding (and which bucket class), so the
dispatcher can slice outputs back to the true extents.
"""

from __future__ import annotations

import time
from numbers import Number
from typing import Any, Optional

from thunder_tpu_torch.core import dtypes, prims
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import NumberProxy, Proxy, TensorProxy, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx, wrap_in_trace_provenance

# factors: tuple of (class_id | None, padded_extent) — a dim is "tracked" when
# at least one factor has a class id. Single-factor dims crop; multi-factor
# dims are reshape-merges (mask rebuilt, crop impossible).

_IDENTITY_IDS = {
    PrimIDs.CONVERT_ELEMENT_TYPE,
    PrimIDs.STOP_GRADIENT,
    PrimIDs.SHALLOW_COPY,
    PrimIDs.DEVICE_PUT,
    # Padding sits at the END of each dim, so prefix scans over real rows are
    # unaffected (zero/garbage only enters at padded positions, which crop).
    PrimIDs.CUMSUM,
    PrimIDs.CUMPROD,
}

_PASS_IDS = {PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.PRINT, PrimIDs.TENSOR_CONSTANT}

# Composites that are safe to keep whole (so kernel executors can still claim
# them) with known dim semantics. Keyed by symbol NAME.
_SAFE_COMPOSITES = {"apply_rope"}


def _is_tracked(factors: tuple) -> bool:
    return any(cid is not None for cid, _ in factors)


class _PadMasker:
    def __init__(self, trace: TraceCtx, spec, analyze_only: bool = False):
        self.trace = trace
        self.spec = spec
        # analyze_only: propagate provenance (for the crop plan) WITHOUT
        # rewriting — used on grad-transformed traces, whose reductions were
        # already masked before differentiation.
        self.analyze_only = analyze_only
        # from_trace gives an EMPTY trace whose scope stack aliases its
        # bound_symbols list — never reassign it, or Symbol.__call__ records
        # into a dead list.
        self.ntrace = from_trace(trace)
        self.swap_map: dict = {}
        # proxy name -> {dim: factors}
        self.tracked: dict[str, dict[int, tuple]] = {}
        self.ext_proxies: dict[int, TensorProxy] = {}  # class id -> 0-d int32 input
        self.ext_order: list[int] = []
        self.dim_mask_cache: dict = {}  # factors -> bool mask proxy (1-D, merged layout)
        self.sum_info: dict[str, tuple] = {}  # masked-sum name -> (padded_count, class ids, const count)
        # Scalar constants materialized as tensors (full / broadcast / convert
        # chains): clang's true_divide turns a Python count into a 0-d full,
        # so the mean-count fix must see through it.
        self.const_vals: dict[str, float] = {}
        self.warnings: list[str] = []
        self._warned: set[str] = set()

        for li, dims in spec.marks.items():
            p = trace.args[li]
            self.tracked[p.name] = {d: ((cid, hi),) for d, (lo, hi, cid) in dims.items()}

    # -- helpers --------------------------------------------------------------

    def warn(self, key: str, msg: str) -> None:
        if key not in self._warned:
            self._warned.add(key)
            self.warnings.append(msg)

    def t(self, p) -> dict:
        if isinstance(p, Proxy):
            return self.tracked.get(p.name, {})
        return {}

    def set_tracking(self, p, dims: dict) -> None:
        dims = {d: f for d, f in dims.items() if _is_tracked(f)}
        if dims and isinstance(p, TensorProxy):
            self.tracked[p.name] = dims

    def ext_proxy(self, cid: int, device) -> TensorProxy:
        p = self.ext_proxies.get(cid)
        if p is None:
            p = TensorProxy(shape=(), device=device, dtype=dtypes.int32, prefix="extent")
            self.ext_proxies[cid] = p
            self.ext_order.append(cid)
        return p

    def dim_mask(self, factors: tuple, device) -> TensorProxy:
        """Boolean validity mask of shape (prod(factor extents),) — True at
        positions whose coordinate along every tracked factor is < the
        runtime true extent."""
        hit = self.dim_mask_cache.get(factors)
        if hit is not None:
            return hit
        fshape = tuple(n for _, n in factors)
        mask = None
        for idx, (cid, n) in enumerate(factors):
            if cid is None:
                continue
            iv = prims.iota(n, start=0, step=1, device=device, dtype=dtypes.int32)
            ext = self.ext_proxy(cid, device)
            extb = prims.broadcast_in_dim(ext, (n,), ())
            mi = prims.lt(iv, extb)
            if len(factors) > 1:
                mi = prims.broadcast_in_dim(mi, fshape, (idx,))
            mask = mi if mask is None else prims.bitwise_and(mask, mi)
        if len(factors) > 1:
            total = 1
            for n in fshape:
                total *= n
            mask = prims.reshape(mask, (total,))
        self.dim_mask_cache[factors] = mask
        return mask

    def full_mask(self, a: TensorProxy, dims: list[int]) -> TensorProxy:
        """Boolean mask broadcast to a.shape, AND-ed over the given dims."""
        atrack = self.t(a)
        mask = None
        for d in dims:
            m = self.dim_mask(atrack[d], a.device)
            mb = prims.broadcast_in_dim(m, tuple(a.shape), (d,))
            mask = mb if mask is None else prims.bitwise_and(mask, mb)
        return mask

    def masked_value(self, a: TensorProxy, dims: list[int], neutral) -> TensorProxy:
        """a with padded positions along ``dims`` replaced by ``neutral``
        (0 via a multiply, anything else via where)."""
        mask = self.full_mask(a, dims)
        if neutral == 0:
            out = prims.mul(a, prims.convert_element_type(mask, a.dtype))
        else:
            fill = prims.full(tuple(a.shape), neutral, device=a.device, dtype=a.true_dtype)
            out = prims.where(mask, a, fill)
        # Masking replaces values, not layout: the result carries a's dims.
        self.set_tracking(out, dict(self.t(a)))
        return out

    # -- per-op handling ------------------------------------------------------

    def run(self):
        with tracectx(self.ntrace):
            self.walk(self.trace.bound_symbols)
        # Rewire the output through the swap map.
        flat_out, out_spec = tree_flatten(self.trace.output)
        flat_out = [
            self.swap_map.get(variableify(p), p) if isinstance(p, Proxy) else p for p in flat_out
        ]
        self.ntrace.output = tree_unflatten(out_spec, flat_out)
        self.ntrace.args = tuple(self.trace.args) + tuple(
            self.ext_proxies[cid] for cid in self.ext_order
        )
        crop_plan = self.crop_plan(flat_out)
        return self.ntrace, tuple(self.ext_order), crop_plan, self.warnings

    def crop_plan(self, flat_out) -> list:
        plan = []
        for i, p in enumerate(flat_out):
            if not isinstance(p, TensorProxy):
                continue
            dims = {}
            for d, factors in self.t(p).items():
                if len(factors) == 1 and factors[0][0] is not None:
                    dims[d] = factors[0][0]
                elif _is_tracked(factors):
                    self.warn(
                        f"crop-merged-{i}-{d}",
                        f"output {p.name} dim {d} interleaves padded data (a reshape "
                        "merged a padded dim); it cannot be cropped back — reshape "
                        "after the jit boundary or mark fewer dims symbolic",
                    )
            if dims:
                plan.append((i, dims))
        return plan

    def walk(self, bsyms) -> None:
        for bsym in bsyms:
            self.handle(bsym.from_bsym_swap_proxies(self.swap_map))

    def emit(self, bsym) -> None:
        self.ntrace.bound_symbols.append(bsym)

    def handle(self, bsym) -> None:
        sid = bsym.sym.id
        if sid in _PASS_IDS:
            self.emit(bsym)
            return
        if sid is PrimIDs.FULL and isinstance(bsym.args[1], Number):
            self.const_vals[bsym.output.name] = float(bsym.args[1])
        elif sid in (PrimIDs.BROADCAST_IN_DIM, PrimIDs.CONVERT_ELEMENT_TYPE):
            src = bsym.args[0]
            if isinstance(src, Proxy) and src.name in self.const_vals:
                self.const_vals[bsym.output.name] = self.const_vals[src.name]
        # Follow masked-sum outputs too: a FULL reduction's result carries no
        # tracked dims, but its consumers must still be expanded so the
        # div-by-count of a mean can be re-pointed at the true count.
        has_tracked_arg = any(
            a.name in self.tracked or a.name in self.sum_info for a in bsym.flat_proxy_args
        )
        if not has_tracked_arg:
            self.emit(bsym)
            return

        handler = _HANDLERS.get(sid)
        if handler is not None:
            handler(self, bsym)
            return
        name = getattr(bsym.sym, "name", "")
        if name == "scaled_dot_product_attention" and self._sdpa_causal(bsym):
            self._prop_sdpa(bsym)
            return
        if name == "cross_entropy" and self._rewrite_cross_entropy(bsym):
            return
        if name in _SAFE_COMPOSITES:
            # Shape-preserving composite: output dims mirror the first arg.
            out = bsym.flat_proxy_outs
            a = next((x for x in bsym.flat_proxy_args if isinstance(x, TensorProxy)), None)
            self.emit(bsym)
            if a is not None:
                for o in out:
                    if isinstance(o, TensorProxy) and tuple(o.shape) == tuple(a.shape):
                        self.set_tracking(o, dict(self.t(a)))
            return
        if bsym.subsymbols:
            # Unknown composite consuming padded dims: expand so the prim
            # rules below see the reductions inside it.
            self.walk(bsym.subsymbols)
            return
        self.warn(
            f"op-{bsym.sym.qualname}",
            f"{bsym.sym.qualname} consumes a padded dim but has no provenance "
            "rule; padding is no longer tracked through its outputs (reductions "
            "downstream may include padded rows)",
        )
        self.emit(bsym)

    def _rewrite_cross_entropy(self, bsym) -> bool:
        """Cross-entropy over padded rows, kept whole so the fused kernel
        still claims it: the targets of pad rows become ``ignore_index``,
        so the kernel gives them zero loss and leaves them out of the mean's
        count. (The JAX package expands the composite and masks its sums;
        the two give the same mean.) False, to expand it, where the classes
        dim is padded or class weights are given."""
        a = _bind_cross_entropy(*bsym.args, **bsym.kwargs)
        logits, target = a["input"], a["target"]
        if not (isinstance(logits, TensorProxy) and isinstance(target, TensorProxy)) or a["weight"] is not None:
            return False
        if 1 in self.t(logits) or not (0 in self.t(target) or 0 in self.t(logits)):
            return False
        factors = self.t(target).get(0) or self.t(logits)[0]
        if self.analyze_only:
            self.emit(bsym)
        else:
            mask = self.dim_mask(factors, target.device)
            fill = prims.full(tuple(target.shape), int(a["ignore_index"]), device=target.device,
                              dtype=target.true_dtype)
            new_out = bsym.sym(logits, prims.where(mask, target, fill), None, a["ignore_index"], a["reduction"],
                               a["label_smoothing"])
            self.swap_map[variableify(bsym.output)] = new_out
        out = self.swap_map.get(variableify(bsym.output), bsym.output)
        if a["reduction"] == "none":
            self.set_tracking(out, {0: factors})
        return True

    @staticmethod
    def _sdpa_causal(bsym) -> bool:
        if bsym.kwargs.get("is_causal"):
            return True
        # is_causal is the 5th positional arg of the torch signature.
        return len(bsym.args) > 5 and bool(bsym.args[5])

    def _prop_sdpa(self, bsym) -> None:
        # Causal SDPA is exactly tail-padding-safe: a real query position i
        # only attends keys <= i, and every padded key sits at a position
        # > i, already masked to -inf by the causal mask; padded query rows
        # produce garbage that the crop removes. Keep the composite whole so
        # the flash executor can still claim it.
        self.emit(bsym)
        q = bsym.args[0]
        out = bsym.flat_proxy_outs
        if isinstance(q, TensorProxy):
            for o in out:
                if isinstance(o, TensorProxy) and tuple(o.shape) == tuple(q.shape):
                    self.set_tracking(o, dict(self.t(q)))


def _bind_cross_entropy(input, target, weight=None, ignore_index=-100, reduction="mean", label_smoothing=0.0):
    return dict(input=input, target=target, weight=weight, ignore_index=ignore_index, reduction=reduction,
                label_smoothing=label_smoothing)


# -- propagation rules ---------------------------------------------------------


def _carry_sum_info(pm: _PadMasker, src, out) -> None:
    """Value-preserving reshapes/casts/broadcasts of a masked sum keep the
    mean-count link alive (clang's keepdim path reshapes between the sum and
    its div; the dtype conversion of mean sits there too)."""
    if isinstance(src, TensorProxy) and isinstance(out, TensorProxy):
        info = pm.sum_info.get(src.name)
        if info is not None:
            pm.sum_info[out.name] = info


_VALUE_PRESERVING_IDS = {
    PrimIDs.CONVERT_ELEMENT_TYPE,
    PrimIDs.STOP_GRADIENT,
    PrimIDs.SHALLOW_COPY,
    PrimIDs.DEVICE_PUT,
}


def _prop_identity(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a = next((x for x in bsym.flat_proxy_args if isinstance(x, TensorProxy)), None)
    if a is None:
        return
    if bsym.sym.id in _VALUE_PRESERVING_IDS:  # not the scans: they change values
        _carry_sum_info(pm, a, bsym.output)
    for o in bsym.flat_proxy_outs:
        if isinstance(o, TensorProxy) and tuple(o.shape) == tuple(a.shape):
            pm.set_tracking(o, dict(pm.t(a)))


def _prop_elementwise(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    outs = [o for o in bsym.flat_proxy_outs if isinstance(o, TensorProxy)]
    for o in outs:
        merged: dict[int, tuple] = {}
        for a in bsym.flat_proxy_args:
            if isinstance(a, TensorProxy) and tuple(a.shape) == tuple(o.shape):
                for d, f in pm.t(a).items():
                    merged.setdefault(d, f)
        pm.set_tracking(o, merged)


def _prop_broadcast(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a, shape, bdims = bsym.args[0], bsym.args[1], bsym.args[2]
    o = bsym.output
    if not isinstance(o, TensorProxy) or not isinstance(a, TensorProxy):
        return
    _carry_sum_info(pm, a, o)
    out: dict[int, tuple] = {}
    for i, d in enumerate(tuple(bdims)):
        f = pm.t(a).get(i)
        if f is not None and int(a.shape[i]) == int(tuple(shape)[d]):
            out[d] = f
    pm.set_tracking(o, out)


def _prop_transpose(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a, perm = bsym.args[0], tuple(bsym.args[1])
    o = bsym.output
    out = {j: pm.t(a)[perm[j]] for j in range(len(perm)) if perm[j] in pm.t(a)}
    pm.set_tracking(o, out)


def _prop_squeeze(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a, dims = bsym.args[0], set(int(d) for d in bsym.args[1])
    o = bsym.output
    out: dict[int, tuple] = {}
    j = 0
    for i in range(a.ndim):
        if i in dims:
            continue
        if i in pm.t(a):
            out[j] = pm.t(a)[i]
        j += 1
    pm.set_tracking(o, out)


def _reshape_tracking(in_shape, in_track: dict, out_shape) -> Optional[dict]:
    """Greedy left-to-right alignment of a reshape: equal dims carry over,
    merges concatenate factor lists, splits of a TRACKED dim (and unaligned
    permuting reshapes) return None."""
    out: dict[int, tuple] = {}
    i = j = 0
    n_in, n_out = len(in_shape), len(out_shape)
    while i < n_in and j < n_out:
        if int(in_shape[i]) == int(out_shape[j]):
            if i in in_track:
                out[j] = in_track[i]
            i += 1
            j += 1
            continue
        if int(in_shape[i]) < int(out_shape[j]):
            # merge input dims i..k-1 into output dim j
            prod = int(in_shape[i])
            k = i + 1
            while prod < int(out_shape[j]) and k < n_in:
                prod *= int(in_shape[k])
                k += 1
            if prod != int(out_shape[j]):
                return None
            factors: list = []
            tracked = False
            for t_i in range(i, k):
                fs = in_track.get(t_i)
                if fs is not None:
                    factors.extend(fs)
                    tracked = True
                else:
                    factors.append((None, int(in_shape[t_i])))
            if tracked:
                out[j] = tuple(factors)
            i = k
            j += 1
            continue
        # split: input dim i covers output dims j..k2-1
        prod = int(out_shape[j])
        k2 = j + 1
        while prod < int(in_shape[i]) and k2 < n_out:
            prod *= int(out_shape[k2])
            k2 += 1
        if prod != int(in_shape[i]):
            return None
        if i in in_track:
            return None  # splitting a padded dim scatters the padding
        i += 1
        j = k2
    return out


def _prop_reshape(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a, shape = bsym.args[0], tuple(bsym.args[1])
    o = bsym.output
    _carry_sum_info(pm, a, o)
    track = pm.t(a)
    if not track:
        return
    out = _reshape_tracking(tuple(a.shape), track, shape)
    if out is None:
        pm.warn(
            f"reshape-{o.name}",
            f"reshape {tuple(a.shape)} -> {shape} splits or reorders a padded "
            "dim; padding is no longer tracked through it",
        )
        return
    pm.set_tracking(o, out)


def _prop_matmul(pm: _PadMasker, bsym) -> None:
    a, b = bsym.args[0], bsym.args[1]
    o = bsym.output
    # A padded CONTRACTED dim must contract zeros (intermediates like exp(x)
    # are nonzero at padded positions): mask whichever operand carries the
    # tracking — one zeroed factor suffices.
    ka = a.ndim - 1
    kb = b.ndim - 2 if isinstance(b, TensorProxy) and b.ndim >= 2 else None
    if not pm.analyze_only:
        if ka in pm.t(a) and _is_tracked(pm.t(a)[ka]):
            a = pm.masked_value(a, [ka], 0)
            bsym = bsym.from_bsym(args=(a, b) + tuple(bsym.args[2:]))
        elif kb is not None and kb in pm.t(b) and _is_tracked(pm.t(b)[kb]):
            b = pm.masked_value(b, [kb], 0)
            bsym = bsym.from_bsym(args=(a, b) + tuple(bsym.args[2:]))
    pm.emit(bsym)
    if not isinstance(o, TensorProxy):
        return
    out: dict[int, tuple] = {}
    orig_a = bsym.args[0]
    for d in range(o.ndim - 2):  # batch dims, aligned from the left for equal ranks
        for operand in (orig_a, b):
            if (
                isinstance(operand, TensorProxy)
                and operand.ndim == o.ndim
                and d in pm.t(operand)
                and int(operand.shape[d]) == int(o.shape[d])
            ):
                out.setdefault(d, pm.t(operand)[d])
    if o.ndim >= 2:
        if isinstance(orig_a, TensorProxy) and (orig_a.ndim - 2) in pm.t(orig_a):
            out[o.ndim - 2] = pm.t(orig_a)[orig_a.ndim - 2]
        if isinstance(b, TensorProxy) and (b.ndim - 1) in pm.t(b):
            out[o.ndim - 1] = pm.t(b)[b.ndim - 1]
    pm.set_tracking(o, out)


def _prop_linear(pm: _PadMasker, bsym) -> None:
    a, w = bsym.args[0], bsym.args[1]
    o = bsym.output
    # linear contracts a's last dim with w's dim 1: zero whichever operand
    # carries the padded-contraction tracking.
    ka = a.ndim - 1
    if not pm.analyze_only:
        if ka in pm.t(a) and _is_tracked(pm.t(a)[ka]):
            a = pm.masked_value(a, [ka], 0)
            bsym = bsym.from_bsym(args=(a,) + tuple(bsym.args[1:]))
        elif isinstance(w, TensorProxy) and 1 in pm.t(w) and _is_tracked(pm.t(w)[1]):
            w = pm.masked_value(w, [1], 0)
            bsym = bsym.from_bsym(args=(bsym.args[0], w) + tuple(bsym.args[2:]))
    pm.emit(bsym)
    orig_a = bsym.args[0]
    out = {d: f for d, f in pm.t(orig_a).items() if d < orig_a.ndim - 1}
    if isinstance(w, TensorProxy) and 0 in pm.t(w):
        out[o.ndim - 1] = pm.t(w)[0]
    pm.set_tracking(o, out)


def _prop_embedding(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    idx = bsym.args[0]
    o = bsym.output
    pm.set_tracking(o, dict(pm.t(idx)))


def _prop_take(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a, idx, dim = bsym.args[0], bsym.args[1], int(bsym.args[2])
    o = bsym.output
    out: dict[int, tuple] = {}
    for d, f in pm.t(a).items():
        if d < dim:
            out[d] = f
        elif d > dim:
            out[d + idx.ndim - 1] = f
    if isinstance(idx, TensorProxy):
        for d, f in pm.t(idx).items():
            out[dim + d] = f
    pm.set_tracking(o, out)


def _prop_gather(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a, idx, dim = bsym.args[0], bsym.args[1], int(bsym.args[2])
    o = bsym.output
    # Same-rank gathers: non-gather output dims align positionally with BOTH
    # the source and the index tensor — take tracking from either (the source
    # contributes when e.g. a batch-padded h is gathered with a constant idx).
    out: dict[int, tuple] = {}
    for operand in (idx, a):
        if not isinstance(operand, TensorProxy) or operand.ndim != o.ndim:
            continue
        for d, f in pm.t(operand).items():
            if d != dim and int(operand.shape[d]) == int(o.shape[d]):
                out.setdefault(d, f)
    pm.set_tracking(o, out)


def _prop_cat(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    tensors, dim = bsym.args[0], int(bsym.args[1])
    o = bsym.output
    first = tensors[0]
    dim = dim if dim >= 0 else dim + first.ndim
    # Union the operands' tracked non-cat dims: every operand shares those
    # extents, so a dim tracked on ANY of them is padded in the result; a
    # factor disagreement (different class) keeps the first seen — extents
    # match, and interacting classes carry equal runtime extents by
    # construction (the unpadded program would be shape-invalid otherwise).
    out: dict[int, tuple] = {}
    for t_ in tensors:
        if not isinstance(t_, TensorProxy):
            continue
        for d, f in pm.t(t_).items():
            if d == dim:
                pm.warn(
                    f"cat-{o.name}",
                    f"cat along padded dim {dim} interleaves padding; the result "
                    "is no longer tracked along that dim",
                )
                continue
            out.setdefault(d, f)
    pm.set_tracking(o, out)


def _prop_slice(pm: _PadMasker, bsym) -> None:
    pm.emit(bsym)
    a = bsym.args[0]
    starts, ends = tuple(bsym.args[1]), tuple(bsym.args[2])
    strides = tuple(bsym.args[3]) if len(bsym.args) > 3 and bsym.args[3] else (1,) * a.ndim
    o = bsym.output
    out: dict[int, tuple] = {}
    for d, f in pm.t(a).items():
        full = (
            int(starts[d]) == 0
            and int(ends[d]) == int(a.shape[d])
            and int(strides[d]) == 1
        )
        if full:
            out[d] = f
    pm.set_tracking(o, out)


# -- reduction rewrites --------------------------------------------------------


def _tracked_reduced(pm: _PadMasker, a, dims) -> list[int]:
    return [int(d) for d in dims if int(d) in pm.t(a) and _is_tracked(pm.t(a)[int(d)])]


def _survivor_tracking(pm: _PadMasker, a, dims) -> dict:
    reduced = {int(d) for d in dims}
    out: dict[int, tuple] = {}
    j = 0
    for i in range(a.ndim):
        if i in reduced:
            continue
        if i in pm.t(a):
            out[j] = pm.t(a)[i]
        j += 1
    return out


def _rewrite_reduction(pm: _PadMasker, bsym) -> None:
    a, dims = bsym.args[0], tuple(int(d) for d in bsym.args[1])
    sid = bsym.sym.id
    tdims = _tracked_reduced(pm, a, dims)
    if not tdims or pm.analyze_only:
        pm.emit(bsym)
        pm.set_tracking(bsym.output, _survivor_tracking(pm, a, dims))
        return
    if sid in (PrimIDs.AMAX, PrimIDs.AMIN) and not dtypes.is_inexact_dtype(a.dtype):
        pm.warn(
            f"intred-{bsym.output.name}",
            f"{bsym.sym.name} over a padded dim of an integer tensor cannot be "
            "masked (no +-inf neutral); padded rows participate",
        )
        pm.emit(bsym)
        return
    if sid is PrimIDs.SUM:
        am = pm.masked_value(a, tdims, 0)
        new_out = prims.sum_prim(am, dims)
        padded = 1
        for d in dims:
            padded *= int(a.shape[d])
        cids: list[int] = []
        const = 1
        for d in dims:
            for cid, n in pm.t(a).get(d, ((None, int(a.shape[d])),)):
                if cid is None:
                    const *= int(n)
                else:
                    cids.append(cid)
        pm.sum_info[new_out.name] = (padded, tuple(cids), const)
    elif sid is PrimIDs.PROD:
        am = pm.masked_value(a, tdims, 1)
        new_out = prims.prod(am, dims)
    elif sid is PrimIDs.AMAX:
        am = pm.masked_value(a, tdims, float("-inf"))
        new_out = prims.amax(am, dims)
    else:  # AMIN
        am = pm.masked_value(a, tdims, float("inf"))
        new_out = prims.amin(am, dims)
    pm.swap_map[variableify(bsym.output)] = new_out
    pm.set_tracking(new_out, _survivor_tracking(pm, a, dims))


def _rewrite_argminmax(pm: _PadMasker, bsym) -> None:
    a, dim = bsym.args[0], bsym.args[1]
    if dim is None:
        if any(_is_tracked(f) for f in pm.t(a).values()):
            pm.warn(
                f"arg-flat-{bsym.output.name}",
                f"{bsym.sym.name}(dim=None) over a padded tensor returns indices "
                "in PADDED coordinates; pass an explicit dim or use exact caching",
            )
        pm.emit(bsym)
        return
    dim = int(dim)
    tdims = _tracked_reduced(pm, a, (dim,))
    if not tdims or pm.analyze_only or not dtypes.is_inexact_dtype(a.dtype):
        pm.emit(bsym)
        pm.set_tracking(bsym.output, _survivor_tracking(pm, a, (dim,)))
        return
    neutral = float("-inf") if bsym.sym.id is PrimIDs.ARGMAX else float("inf")
    am = pm.masked_value(a, tdims, neutral)
    new_out = (prims.argmax if bsym.sym.id is PrimIDs.ARGMAX else prims.argmin)(am, dim)
    pm.swap_map[variableify(bsym.output)] = new_out
    pm.set_tracking(new_out, _survivor_tracking(pm, a, (dim,)))


def _rewrite_topk(pm: _PadMasker, bsym) -> None:
    a, k, dim = bsym.args[0], bsym.args[1], int(bsym.args[2])
    largest = bool(bsym.args[3]) if len(bsym.args) > 3 else True
    tdims = _tracked_reduced(pm, a, (dim,))
    if not tdims or pm.analyze_only or not dtypes.is_inexact_dtype(a.dtype):
        pm.emit(bsym)
        return
    pm.warn(
        f"topk-{bsym.output.name if hasattr(bsym.output, 'name') else dim}",
        f"topk over a padded dim is masked with ∓inf filler: a call whose "
        f"runtime extent is smaller than k={k} returns filler values/padded "
        "indices for the excess slots (exact caching would raise instead)",
    )
    am = pm.masked_value(a, tdims, float("-inf") if largest else float("inf"))
    new_bsym = bsym.from_bsym(args=(am,) + tuple(bsym.args[1:]))
    # Mint fresh outputs to keep SSA: re-run via the symbol call.
    new_outs = bsym.sym(*new_bsym.args, **new_bsym.kwargs)
    flat_new, _ = tree_flatten(new_outs)
    for old, new in zip(bsym.flat_proxy_outs, [x for x in flat_new if isinstance(x, Proxy)]):
        pm.swap_map[variableify(old)] = new


def _rewrite_var(pm: _PadMasker, bsym) -> None:
    a, dims = bsym.args[0], tuple(int(d) for d in bsym.args[1])
    if _tracked_reduced(pm, a, dims):
        pm.warn(
            f"var-{bsym.sym.name}",
            f"{bsym.sym.name} over a padded dim is not masked (normalize over "
            "unpadded dims, or mark fewer dims symbolic); padded rows "
            "participate in the statistics",
        )
        pm.emit(bsym)
        return
    pm.emit(bsym)
    for o in bsym.flat_proxy_outs:
        pm.set_tracking(o, _survivor_tracking(pm, a, dims))


def _true_count(pm: _PadMasker, cids: tuple, const: int, device) -> TensorProxy:
    tc = None
    for cid in cids:
        e = pm.ext_proxy(cid, device)
        tc = e if tc is None else prims.mul(tc, e)
    if const != 1:
        c = prims.full((), const, device=device, dtype=dtypes.int32)
        tc = c if tc is None else prims.mul(tc, c)
    return tc


def _fix_mean_count(pm: _PadMasker, bsym) -> bool:
    """div(masked_sum, padded_count) / mul(masked_sum, 1/padded_count) →
    divide by the runtime true count instead. Returns True when rewritten."""
    if pm.analyze_only:
        return False
    s, c = bsym.args[0], bsym.args[1]
    if not isinstance(s, TensorProxy):
        return False
    info = pm.sum_info.get(s.name)
    if info is None:
        return False
    padded, cids, const = info
    if not cids:
        return False
    if isinstance(c, TensorProxy):
        cval = pm.const_vals.get(c.name)
    else:
        cval = c.value if isinstance(c, NumberProxy) else c
    if not isinstance(cval, Number):
        return False
    if bsym.sym.id is PrimIDs.DIV:
        if float(cval) != float(padded):
            return False
    else:  # MUL
        if float(cval) == 0 or abs(float(cval) * float(padded) - 1.0) > 1e-12:
            return False
    tc = _true_count(pm, cids, const, s.device)
    tcf = prims.convert_element_type(tc, s.dtype)
    if s.ndim > 0:
        tcf = prims.broadcast_in_dim(tcf, tuple(s.shape), ())
    new_out = prims.div(s, tcf)
    pm.swap_map[variableify(bsym.output)] = new_out
    pm.set_tracking(new_out, dict(pm.t(s)))
    return True


def _prop_div(pm: _PadMasker, bsym) -> None:
    if _fix_mean_count(pm, bsym):
        return
    _prop_elementwise(pm, bsym)


def _prop_mul(pm: _PadMasker, bsym) -> None:
    if _fix_mean_count(pm, bsym):
        return
    _prop_elementwise(pm, bsym)


def _drop_with_warning(pm: _PadMasker, bsym) -> None:
    pm.warn(
        f"op-{bsym.sym.qualname}",
        f"{bsym.sym.qualname} consumes a padded dim; padding is not tracked "
        "through it",
    )
    pm.emit(bsym)


_HANDLERS: dict = {
    PrimIDs.BROADCAST_IN_DIM: _prop_broadcast,
    PrimIDs.TRANSPOSE: _prop_transpose,
    PrimIDs.SQUEEZE: _prop_squeeze,
    PrimIDs.RESHAPE: _prop_reshape,
    PrimIDs.MATMUL: _prop_matmul,
    PrimIDs.LINEAR: _prop_linear,
    PrimIDs.EMBEDDING: _prop_embedding,
    PrimIDs.TAKE: _prop_take,
    PrimIDs.TAKE_ALONG_AXIS: _prop_gather,
    PrimIDs.GATHER: _prop_gather,
    PrimIDs.CAT: _prop_cat,
    PrimIDs.SLICE: _prop_slice,
    PrimIDs.SUM: _rewrite_reduction,
    PrimIDs.PROD: _rewrite_reduction,
    PrimIDs.AMAX: _rewrite_reduction,
    PrimIDs.AMIN: _rewrite_reduction,
    PrimIDs.ARGMAX: _rewrite_argminmax,
    PrimIDs.ARGMIN: _rewrite_argminmax,
    PrimIDs.TOPK: _rewrite_topk,
    PrimIDs.VAR: _rewrite_var,
    PrimIDs.VAR_MEAN: _rewrite_var,
    PrimIDs.DIV: _prop_div,
    PrimIDs.MUL: _prop_mul,
    PrimIDs.SORT: _drop_with_warning,
    PrimIDs.ARGSORT: _drop_with_warning,
    PrimIDs.FLIP: _drop_with_warning,
    PrimIDs.PAD: _drop_with_warning,
    PrimIDs.SETITEM: _drop_with_warning,
    PrimIDs.INDEX_PUT: _drop_with_warning,
    PrimIDs.SCATTER_ADD: _drop_with_warning,
}

for _pid in _IDENTITY_IDS:
    _HANDLERS[_pid] = _prop_identity


def _install_elementwise_handlers() -> None:
    for _sym in vars(prims).values():
        sym_tags = getattr(_sym, "tags", None)
        sym_id = getattr(_sym, "id", None)
        if not sym_tags or not isinstance(sym_id, PrimIDs) or sym_id in _HANDLERS:
            continue
        if OpTags.ELEMENTWISE_UNARY_OP in sym_tags or OpTags.ELEMENTWISE_BINARY_OP in sym_tags:
            _HANDLERS[sym_id] = _prop_elementwise


_install_elementwise_handlers()
_HANDLERS[PrimIDs.WHERE] = _prop_elementwise


def analyze_crop_plan(trace: TraceCtx, spec) -> list:
    """Provenance-only pass over an already-masked (and possibly
    grad-transformed) trace: which output dims carry padding, and which
    bucket class each belongs to. No rewrites, no trace mutation — backward
    programs are prims too, so the same propagation rules cover cotangent
    flow (the forward masks zero padded cotangents, making cropped grads
    exact)."""
    pm = _PadMasker(trace, spec, analyze_only=True)
    _ntrace, _classes, crop_plan, _warns = pm.run()
    return crop_plan


def thread_pad_masks(trace: TraceCtx, spec):
    """Apply pad-mask threading for symbolic-values caching.

    Returns ``(new_trace, mask_class_ids, crop_plan, warnings)``: the class
    ids name the extra 0-d int32 TRUE-EXTENT inputs appended to the trace's
    args (in order); the crop plan maps flat output leaf indices to
    ``{dim: class_id}`` for post-execution cropping.
    """
    start = time.perf_counter_ns()
    pm = _PadMasker(trace, spec)
    ntrace, mask_classes, crop_plan, warns = pm.run()
    ntrace = wrap_in_trace_provenance(ntrace, "Pad-mask threading (symbolic values)", start)
    return ntrace, mask_classes, crop_plan, warns
