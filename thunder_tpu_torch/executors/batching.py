"""Batching rules: the kernels under ``torch.func.vmap``.

The JAX package stages ``jax.vmap`` of a claimed program
(``thunder_tpu/api.py:2137-2199``), and its Pallas kernels batch through
``pallas_call``'s batching rule. The port's kernels read their operands
through ``data_ptr()``, which a vmapped (batched) tensor does not have. So
each kernel wrapper that the default executors and ``norm`` claim has a
rule here: a ``torch.autograd.Function`` whose ``vmap`` staticmethod moves
the vmapped dim of each operand to the front, folds it into the kernel's own
batch or row dim, calls the same counted wrapper once (one launch a call
site, whatever the number of slices) and unfolds the result:

- flash attention (rows 1, 6, 7 and the legacy route's row 10): V·B of
  (B, H, T, D);
- masked attention (rows 8-9: the forward under segment ids and the
  recompute backward): V·B of q, k, v and the mask, so the segment ids stay
  a batch row's own. The mask's verdict is taken a slice, as ``lax.cond``
  under ``jax.vmap`` takes it: the slices of each verdict run together, one
  launch a verdict present (the exact branch for 0, the segment kernels for
  1 and 2). ``vmap`` takes the verdicts before it runs and gives them to
  the claims (``api._stage_vmapped``), so no rule reads the host;
- rope (rows 2, 5): V·B of x; cos and sin shared, or a table a slice
  (``csrc/rope.cu``'s segment stride);
- cross-entropy forward and backward (rows 3, 4): V·N rows;
- RMSNorm and LayerNorm forward (rows 11-12): V·N rows, the weight (and
  bias) shared or a row a slice (``csrc/norm.cu``'s segments);
- their backward: folding would sum dw (and db) over the slices, so the
  kernel is given V segments of rows and writes a dw row a segment, (V, D),
  reading a segment's own weight where the weight is batched;
- the int8 linear (the ``quant`` executor): the activation's rows are V
  segments, each quantized with its own amax and scale
  (``csrc/quantize.cu``); a batched weight folds into V·N rows of
  ``quantize_rows``; the GEMM runs V problems in one launch, an operand the
  slices share given once (``csrc/int8_gemm.cu``, ``int8_gemm_sync.cu``).
  Each slice's bits are those of the unbatched call on it.

An operand the call does not batch (k and v under ``in_axes=None``) is
expanded to the fold, except a weight, bias, table or GEMM operand, which
the kernels read once for every slice. A rule runs on the CPU too, where the
wrapper runs its plain version on the folded tensors, so the folding is the
same on both. Nested vmaps fold level by level: a rule that needs to know
the slices below it (norm segments, rope tables, verdict groups, GEMM
problems) is passed their count, and multiplies it by its own.

:func:`batched_callable` builds a claimed trace's callable for ``vmap``:
each claimed kernel op is bound to its implementation below, which calls
the rules where the executor's implementation calls the wrappers; the jit
path keeps calling the wrappers directly. A claimed kernel without a rule
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import pyval
from thunder_tpu_torch.executors import flashex, fusedex, normex, quantex

# =============================================================================
# Folding
# =============================================================================


def front(t: Optional[torch.Tensor], d: Optional[int], V: int) -> Optional[torch.Tensor]:
    """``t`` with its vmapped dim ``d`` first; an unbatched operand (``d``
    None) expanded to V slices."""
    if t is None:
        return None
    return t.unsqueeze(0).expand(V, *t.shape) if d is None else t.movedim(d, 0)


def fold(t: Optional[torch.Tensor], d: Optional[int], V: int) -> Optional[torch.Tensor]:
    """(V, B, ...) → (V·B, ...): the slices laid along the kernel's first dim."""
    t = front(t, d, V)
    return None if t is None else t.reshape(V * t.shape[1], *t.shape[2:])


def unfold(t: Optional[torch.Tensor], V: int) -> Optional[torch.Tensor]:
    """(V·B, ...) → (V, B, ...)."""
    return None if t is None else t.reshape(V, t.shape[0] // V, *t.shape[1:])


def per_segment(t: Optional[torch.Tensor], d: Optional[int], V: int, segments: int,
                rank: int) -> Optional[torch.Tensor]:
    """An operand that the kernel reads once for a segment of its rows (a
    norm weight or bias, rank 1; rope's tables or a GEMM operand, rank 2),
    for the level below: as it is where no level batches it (shared by every
    segment), else (V·segments, ...), this level's slices times the
    ``segments`` the levels below asked for, in the order the rows fold."""
    if t is None or (d is None and t.ndim == rank):
        return t
    t = front(t, d, V)
    if t.ndim == rank + 1 and segments > 1:  # a row a slice of this level, shared by the segments below
        t = t.unsqueeze(1).expand(V, segments, *t.shape[1:])
    return t.reshape(V * segments, *t.shape[-rank:])


def _alike(a: Optional[torch.Tensor], b: Optional[torch.Tensor], rank: int) -> tuple:
    """Two operands read together (cos and sin, a weight and its bias): a
    shared one expanded to the other's segments."""
    if a is not None and b is not None and a.ndim != b.ndim:
        a, b = (a.expand(b.shape[0], *a.shape) if a.ndim == rank else a,
                b.expand(a.shape[0], *b.shape) if b.ndim == rank else b)
    return a, b


def _rule(name: str, call: Callable, vmap: Callable) -> Callable:
    """A kernel wrapper's rule, applied as a function: ``call(*args)`` on
    plain tensors (the wrapper itself), ``vmap(apply, V, in_dims, *args)``
    under vmap, which calls ``apply`` (this rule again, one level down) once
    and returns ``(outputs, out_dims)``."""

    def _vmap(info, in_dims, *args):
        return vmap(Rule.apply, info.batch_size, in_dims, *args)

    def _no_grad(ctx, *grads):
        raise RuntimeError(f"{name}: the batching rule has no backward; the port's grads come from the trace")

    Rule = type(name, (torch.autograd.Function,), {
        "generate_vmap_rule": False,
        "forward": staticmethod(call),
        "setup_context": staticmethod(lambda ctx, inputs, output: None),
        "backward": staticmethod(_no_grad),
        "vmap": staticmethod(_vmap),
    })
    return Rule.apply


# =============================================================================
# The rules
# =============================================================================


def _attn_vmap(n_in: int, n_out: int):
    """Attention wrappers: the first ``n_in`` operands fold V into B, the
    rest (causal, scale) pass; ``n_out`` outputs unfold."""

    def vmap(apply, V, in_dims, *args):
        tensors = [fold(t, d, V) for t, d in zip(args[:n_in], in_dims[:n_in])]
        out = apply(*tensors, *args[n_in:])
        if n_out == 1:
            return unfold(out, V), 0
        return tuple(unfold(o, V) for o in out), (0,) * n_out

    return vmap


flash_fwd = _rule("FlashFwdRule", lambda q, k, v, causal, scale: flashex.flash_attention_fwd(
    q, k, v, causal=causal, scale=scale), _attn_vmap(3, 1))
flash_fwd_lse = _rule("FlashFwdLseRule", lambda q, k, v, causal, scale: flashex.flash_attention_fwd_lse(
    q, k, v, causal=causal, scale=scale), _attn_vmap(3, 2))
flash_bwd = _rule("FlashBwdRule", lambda dout, q, k, v, out, lse, causal, scale: flashex.flash_attention_bwd(
    dout, q, k, v, out, lse, causal=causal, scale=scale), _attn_vmap(6, 3))
flash_bwd_recompute = _rule(
    "FlashBwdRecomputeRule", lambda dout, q, k, v, causal, scale: flashex.flash_attention_bwd_recompute(
        dout, q, k, v, causal=causal, scale=scale), _attn_vmap(4, 3))
legacy_fwd = _rule("LegacyFlashFwdRule", lambda q, k, v, causal, scale: flashex.legacy_flash_fwd(
    q, k, v, causal=causal, scale=scale), _attn_vmap(3, 1))
legacy_bwd = _rule("LegacyFlashBwdRule", lambda dout, q, k, v, causal, scale: flashex.legacy_flash_bwd(
    dout, q, k, v, causal=causal, scale=scale), _attn_vmap(4, 3))


def _mask4(m: torch.Tensor, B: int) -> torch.Tensor:
    """A claimable mask ((Tkv,), (1 or B, 1, 1, Tkv), (1 or B, 1, Tq, Tkv))
    at (B, 1, tq, Tkv), as torch broadcasts it against the scores."""
    m = m.reshape((1,) * (4 - m.ndim) + tuple(m.shape))
    return m.expand(B, *m.shape[1:])


def _verdict_rows(q, k, m4, causal: bool, verdicts, groups: int) -> dict:
    """``{verdict: the batch rows of q that take it}`` (None: all of them)
    for q's batch in ``groups`` equal runs, a vmapped slice each. The
    verdicts are given (an int for every group, or one a group), or read
    here on the host, one read for all the groups."""
    B, Tq, Tkv = q.shape[0], q.shape[-2], k.shape[-2]
    rows = B // groups
    if verdicts is None:
        vs = torch.stack([flashex.mask_verdict(m4[g * rows:(g + 1) * rows], rows, Tq, Tkv, causal)
                          for g in range(groups)]).tolist()
        flashex.mask_plan.host_reads += 1
    elif isinstance(verdicts, int):
        vs = [verdicts] * groups
    else:
        vs = [int(v) for v in verdicts]
        if len(vs) != groups:
            raise ValueError(f"masked attention under vmap: {len(vs)} verdicts for {groups} slices")
    if len(set(vs)) == 1:
        return {vs[0]: None}
    return {val: torch.cat([torch.arange(g * rows, (g + 1) * rows, device=q.device) for g, x in enumerate(vs)
                            if x == val]) for val in sorted(set(vs))}


def _by_verdict(tensors: tuple, m4: torch.Tensor, q, k, causal: bool, verdicts, groups: int, run: Callable):
    """``run(verdict, rows' tensors, rows' mask)`` once a verdict present,
    its results put back in the rows it ran on."""
    plan = _verdict_rows(q, k, m4, causal, verdicts, groups)
    if len(plan) == 1:
        (val,) = plan
        return run(val, tensors, m4)
    outs = None
    for val, idx in plan.items():
        got = run(val, tuple(t.index_select(0, idx) for t in tensors), m4.index_select(0, idx))
        got = got if isinstance(got, tuple) else (got,)
        if outs is None:
            outs = [torch.empty((q.shape[0], *g.shape[1:]), dtype=g.dtype, device=g.device) for g in got]
        for o, g in zip(outs, got):
            o.index_copy_(0, idx, g)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _segments_of(m4: torch.Tensor, Tq: int, Tkv: int) -> tuple:
    _, _, _, q_valid, kv_valid = flashex._valid(m4, m4.shape[0], Tq, Tkv)
    return q_valid.to(torch.int32).contiguous(), kv_valid.to(torch.int32).contiguous()


def _masked_fwd(q, k, v, mask, causal, scale, verdicts, groups):
    """Masked attention, a verdict a slice (``_sdpa_runtime`` under
    ``jax.vmap``): the exact branch for 0, the segment kernel for 1 and 2."""
    Tq, Tkv = q.shape[-2], k.shape[-2]

    def run(val, tq, m4):
        if val == 0:
            return flashex.sdpa_exact(*tq, m4, causal=causal, scale=scale)
        q_seg, kv_seg = _segments_of(m4, Tq, Tkv)
        return flashex.flash_attention_fwd_seg(*tq, q_seg, kv_seg, causal=val == 2, scale=scale)

    return _by_verdict((q, k, v), _mask4(mask, q.shape[0]), q, k, causal, verdicts, groups, run)


def _masked_bwd(g, q, k, v, mask, causal, scale, verdicts, groups):
    """(dq, dk, dv) of :func:`_masked_fwd`: the exact branch's backward for
    0, the recompute backward under segment ids for 1 and 2."""
    Tq, Tkv = q.shape[-2], k.shape[-2]

    def run(val, t, m4):
        if val == 0:
            return tuple(flashex.sdpa_exact_bwd(*t, m4, causal=causal, scale=scale))
        q_seg, kv_seg = _segments_of(m4, Tq, Tkv)
        return flashex.flash_attention_bwd_recompute(*t, causal=val == 2, scale=scale, q_seg=q_seg, kv_seg=kv_seg)

    return _by_verdict((g, q, k, v), _mask4(mask, q.shape[0]), q, k, causal, verdicts, groups, run)


def _masked_vmap(n_in: int, n_out: int):
    """Masked attention: the first ``n_in`` operands fold V into B, the mask
    is brought to (B, 1, tq, Tkv) a slice and folds with them, and the
    verdict groups multiply by V."""

    def vmap(apply, V, in_dims, *args):
        tensors, mask, (causal, scale, verdicts, groups) = args[:n_in], args[n_in], args[n_in + 1:]
        B = front(tensors[-3], in_dims[n_in - 3], V).shape[1]  # q's batch a slice
        m = front(mask, in_dims[n_in], V)
        m = m.reshape(V, *((1,) * (5 - m.ndim)), *m.shape[1:])
        m = m.expand(V, B, *m.shape[2:]).reshape(V * B, *m.shape[2:])
        out = apply(*(fold(t, d, V) for t, d in zip(tensors, in_dims)), m, causal, scale, verdicts, V * groups)
        if n_out == 1:
            return unfold(out, V), 0
        return tuple(unfold(o, V) for o in out), (0,) * n_out

    return vmap


masked_fwd = _rule("MaskedFlashFwdRule", _masked_fwd, _masked_vmap(3, 1))
masked_bwd = _rule("MaskedFlashBwdRule", _masked_bwd, _masked_vmap(4, 3))


def _rope_vmap(apply, V, in_dims, x, cos, sin, segments=1):
    cos, sin = _alike(per_segment(cos, in_dims[1], V, segments, 2), per_segment(sin, in_dims[2], V, segments, 2), 2)
    return unfold(apply(fold(x, in_dims[0], V), cos, sin, V * segments), V), 0


rope = _rule("RopeRule", lambda x, cos, sin, segments=1: fusedex.apply_rope(x, cos, sin), _rope_vmap)


def _ce_rows_vmap(apply, V, in_dims, logits, target, ignore_index):
    return unfold(apply(fold(logits, in_dims[0], V), fold(target, in_dims[1], V), ignore_index), V), 0


def _ce_bwd_vmap(apply, V, in_dims, logits, target, row_scale):
    return unfold(apply(*(fold(t, d, V) for t, d in zip((logits, target, row_scale), in_dims))), V), 0


ce_rows = _rule("CrossEntropyRowsRule", lambda logits, target, ignore_index: fusedex.cross_entropy_rows(
    logits, target, ignore_index), _ce_rows_vmap)
ce_bwd = _rule("CrossEntropyBwdRule", lambda logits, target, row_scale: fusedex.cross_entropy_bwd(
    logits, target, row_scale), _ce_bwd_vmap)


def _norm_fwd_vmap(apply, V, in_dims, x, weight, bias, eps, layer_norm, segments=1):
    weight, bias = _alike(per_segment(weight, in_dims[1], V, segments, 1),
                          per_segment(bias, in_dims[2], V, segments, 1), 1)
    return apply(front(x, in_dims[0], V), weight, bias, eps, layer_norm, V * segments), 0


def _norm_fwd(x, weight, bias, eps, layer_norm, segments=1):
    if layer_norm:
        return normex.layer_norm_fwd(x, weight, bias, eps)
    return normex.rms_norm_fwd(x, weight, eps)


norm_fwd = _rule("NormFwdRule", _norm_fwd, _norm_fwd_vmap)


def _norm_bwd_vmap(apply, V, in_dims, g, x, weight, eps, layer_norm, with_bias, segments):
    """dx unfolds; dw (and db) come a row a slice: the kernel is given V
    segments of rows, each segment being this level's slice times the
    segments already asked for below it, and a batched weight a row a
    segment."""
    weight = per_segment(weight, in_dims[2], V, segments, 1)
    dx, dw, db = apply(front(g, in_dims[0], V), front(x, in_dims[1], V), weight, eps, layer_norm, with_bias,
                       V * segments)
    if segments > 1:  # an inner level's segments: (V·S, D) → (V, S, D)
        dw, db = unfold(dw, V), unfold(db, V)
    return (dx, dw, db), (0, 0, None if db is None else 0)


def _norm_bwd(g, x, weight, eps, layer_norm, with_bias, segments):
    if layer_norm:
        return normex.layer_norm_bwd(g, x, weight, eps, with_bias=with_bias, segments=segments)
    dx, dw = normex.rms_norm_bwd(g, x, weight, eps, segments)
    return dx, dw, None


norm_bwd = _rule("NormBwdRule", _norm_bwd, _norm_bwd_vmap)


def _quant_tensor_vmap(apply, V, in_dims, x, qmax, segments=1):
    """The activation's rows fold, a segment a slice: each slice keeps its
    own amax and scale, (V,) (or (V, S) under inner levels' S segments)."""
    q, scale = apply(fold(x, in_dims[0], V), qmax, V * segments)
    return (unfold(q, V), scale.reshape(V, *(() if segments == 1 else (segments,)))), (0, 0)


quant_tensor = _rule("QuantizeTensorRule", lambda x, qmax, segments=1: quantex.quantize_tensor(x, qmax, segments),
                     _quant_tensor_vmap)


def _quant_rows_vmap(apply, V, in_dims, w, qmax):
    q, scale = apply(fold(w, in_dims[0], V), qmax)
    return (unfold(q, V), unfold(scale, V)), (0, 0)


quant_rows = _rule("QuantizeRowsRule", lambda w, qmax: quantex.quantize_rows(w, qmax), _quant_rows_vmap)


def _gemm_vmap(apply, V, in_dims, qa, qw, scale, bias, dtype, problems=1):
    """V problems a level (times the ``problems`` asked for below): each
    batched operand a problem's own, a shared one given once."""
    ops = [per_segment(t, d, V, problems, r) for t, d, r in zip((qa, qw, scale, bias), in_dims, (2, 2, 1, 1))]
    out = apply(*ops, dtype, V * problems)
    return out.reshape(V, *((problems,) if problems > 1 else ()), *out.shape[-2:]), 0


int8_gemm = _rule("Int8GemmRule", lambda qa, qw, scale, bias, dtype, problems=1: quantex.int8_gemm(
    qa, qw, scale, bias, dtype), _gemm_vmap)


# =============================================================================
# The claimed ops' implementations under vmap
# =============================================================================


def _sdpa(*args, **kwargs):
    b = flashex._sdpa_bound(args, kwargs)
    q, k, v, mask = b["query"], b["key"], b["value"], b["attn_mask"]
    scale, causal = flashex._scale_of(q, b["scale"]), bool(b["is_causal"])
    if flashex._impl_name() == "legacy":
        return legacy_fwd(q, k, v, causal, scale)
    if mask is not None:
        return masked_fwd(q, k, v, mask, causal, scale, b["verdict"], 1)
    return flash_fwd(q, k, v, causal, scale)


def _sdpa_bwd(g, query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False, verdict=None):
    scale, causal = flashex._scale_of(query, scale), bool(is_causal)
    if flashex._impl_name() == "legacy":
        return legacy_bwd(g, query, key, value, causal, scale)
    if attn_mask is not None:
        return masked_bwd(g, query, key, value, attn_mask, causal, scale, verdict, 1)
    return flash_bwd_recompute(g, query, key, value, causal, scale)


def _sdpa_fwd_res(query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False):
    return flash_fwd_lse(query, key, value, bool(is_causal), flashex._scale_of(query, scale))


def _sdpa_bwd_res(g, query, key, value, out, lse, attn_mask=None, is_causal=False, scale=None, enable_gqa=False):
    return flash_bwd(g, query, key, value, out, lse, bool(is_causal), flashex._scale_of(query, scale))


def _ce_bwd(g, input, target, ignore_index=-100, reduction="mean"):
    return ce_bwd(input, target, fusedex.ce_row_scale(g, target, int(ignore_index), reduction))


def _rope(x, cos, sin):
    return rope(x, cos, sin, 1)


def _rms(a, normalized_shape, weight=None, eps=None):
    return norm_fwd(a, weight, None, normex.RMS_EPS if eps is None else float(pyval(eps)), False, 1)


def _rms_bwd(g, a, weight, eps):
    dx, dw, _ = norm_bwd(g, a, weight, float(pyval(eps)), False, False, 1)
    return dx, dw.to(weight.dtype)


def _ln(a, normalized_shape, weight=None, bias=None, eps=1e-5):
    return norm_fwd(a, weight, bias, float(pyval(eps)), True, 1)


def _ln_bwd(g, a, weight, bias, eps):
    dx, dw, db = norm_bwd(g, a, weight, float(pyval(eps)), True, bias is not None, 1)
    return dx, dw.to(weight.dtype), None if db is None else db.to(weight.dtype)


_quant_linear = functools.partial(quantex.quant_linear, tensor=quant_tensor, rows=quant_rows, gemm=int8_gemm)

# (executor name, symbol id) -> the implementation under vmap. The torch
# executor's operators batch by themselves; its draws (csrc/rng.cu) take the
# call's key unbatched, so every slice draws the same numbers, as under
# jax.vmap.
IMPLS: dict[tuple[str, str], Callable] = {
    ("flash", "torch.scaled_dot_product_attention"): _sdpa,
    ("flash", "torch.sdpa_bwd"): _sdpa_bwd,
    ("flash", "torch.sdpa_fwd_res"): _sdpa_fwd_res,
    ("flash", "torch.sdpa_bwd_res"): _sdpa_bwd_res,
    ("fused", "torch.apply_rope"): _rope,
    ("fused", "torch.cross_entropy"): functools.partial(fusedex._ce_impl, rows=ce_rows),
    ("fused", "torch.cross_entropy_bwd"): _ce_bwd,
    ("norm", "torch.rms_norm"): _rms,
    ("norm", "torch.rms_norm_bwd"): _rms_bwd,
    ("norm", "torch.layer_norm"): _ln,
    ("norm", "torch.layer_norm_bwd"): _ln_bwd,
    ("quant", "torch.linear"): _quant_linear,
    ("quant", PrimIDs.LINEAR): _quant_linear,
}


def batched_callable(extrace) -> Callable:
    """The claimed trace's callable with every kernel op bound to its
    implementation under vmap. Raises ``NotImplementedError`` naming the
    first claimed kernel that has no batching rule (an executor registered
    by a user, say)."""
    overrides = {}
    for bsym in extrace.bound_symbols:
        ex = bsym.sym.executor
        if ex is None or ex.name in ("torch", "python"):
            continue
        impl = IMPLS.get((ex.name, bsym.sym.id))
        if impl is None:
            raise NotImplementedError(f"vmap: the {ex.name} executor's {bsym.sym.name} has no batching rule "
                                      "(executors/batching.py IMPLS)")
        overrides[bsym.gen_call_target()[0]] = impl
    return extrace.python_callable(**overrides)
