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
- rope (rows 2, 5): V·B of x, cos and sin shared (per-slice cos/sin raise);
- cross-entropy forward and backward (rows 3, 4): V·N rows;
- RMSNorm and LayerNorm forward (rows 11-12): V·N rows, the weight shared;
- their backward: folding would sum dw (and db) over the slices, so the
  kernel is given V segments of rows and writes a dw row a segment, (V, D)
  (``csrc/norm.cu``).

An operand the call does not batch (k and v under ``in_axes=None``) is
expanded to the fold. A rule runs on the CPU too, where the wrapper runs its
plain version on the folded tensors, so the folding is the same on both.
Nested vmaps fold level by level.

:func:`batched_callable` builds a claimed trace's callable for ``vmap``:
each claimed kernel op is bound to its implementation below, which calls
the rules where the executor's implementation calls the wrappers; the jit
path keeps calling the wrappers directly. A claimed kernel without a rule
raises ``NotImplementedError`` naming it: masked attention (rows 8-9; the
mask's verdict is read per call on the host), and the int8 linear's GEMM and
quantization kernels (a per-tensor amax folded over slices would change the
scale every slice is quantized with).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from thunder_tpu_torch.core.proxies import pyval
from thunder_tpu_torch.executors import flashex, fusedex, normex

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


def _shared(kernel: str, what: str, *dims) -> None:
    """A rule that shares an operand across the slices refuses a batched one."""
    if any(d is not None for d in dims):
        raise NotImplementedError(f"{kernel} under vmap: a per-slice {what} has no batching rule; the kernel "
                                  "shares one across its batch (ROADMAP.md, queue A)")


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


def _rope_vmap(apply, V, in_dims, x, cos, sin):
    _shared("rope", "cos/sin table", in_dims[1], in_dims[2])
    return unfold(apply(fold(x, in_dims[0], V), cos, sin), V), 0


rope = _rule("RopeRule", lambda x, cos, sin: fusedex.apply_rope(x, cos, sin), _rope_vmap)


def _ce_rows_vmap(apply, V, in_dims, logits, target, ignore_index):
    return unfold(apply(fold(logits, in_dims[0], V), fold(target, in_dims[1], V), ignore_index), V), 0


def _ce_bwd_vmap(apply, V, in_dims, logits, target, row_scale):
    return unfold(apply(*(fold(t, d, V) for t, d in zip((logits, target, row_scale), in_dims))), V), 0


ce_rows = _rule("CrossEntropyRowsRule", lambda logits, target, ignore_index: fusedex.cross_entropy_rows(
    logits, target, ignore_index), _ce_rows_vmap)
ce_bwd = _rule("CrossEntropyBwdRule", lambda logits, target, row_scale: fusedex.cross_entropy_bwd(
    logits, target, row_scale), _ce_bwd_vmap)


def _norm_fwd_vmap(apply, V, in_dims, x, weight, bias, eps, layer_norm):
    _shared("rms_fwd/ln_fwd", "weight or bias", in_dims[1], in_dims[2])
    return apply(front(x, in_dims[0], V), weight, bias, eps, layer_norm), 0


def _norm_fwd(x, weight, bias, eps, layer_norm):
    if layer_norm:
        return normex.layer_norm_fwd(x, weight, bias, eps)
    return normex.rms_norm_fwd(x, weight, eps)


norm_fwd = _rule("NormFwdRule", _norm_fwd, _norm_fwd_vmap)


def _norm_bwd_vmap(apply, V, in_dims, g, x, weight, eps, layer_norm, with_bias, segments):
    """dx unfolds; dw (and db) come a row a slice: the kernel is given V
    segments of rows, each segment being this level's slice times the
    segments already asked for below it."""
    _shared("rms_bwd/ln_bwd", "weight", in_dims[2])
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


# =============================================================================
# The claimed ops' implementations under vmap
# =============================================================================


def _sdpa(*args, **kwargs):
    b = flashex._sdpa_bound(args, kwargs)
    q, k, v = b["query"], b["key"], b["value"]
    scale, causal = flashex._scale_of(q, b["scale"]), bool(b["is_causal"])
    if flashex._impl_name() == "legacy":
        return legacy_fwd(q, k, v, causal, scale)
    return flash_fwd(q, k, v, causal, scale)


def _sdpa_bwd(g, query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False, verdict=None):
    scale, causal = flashex._scale_of(query, scale), bool(is_causal)
    if flashex._impl_name() == "legacy":
        return legacy_bwd(g, query, key, value, causal, scale)
    return flash_bwd_recompute(g, query, key, value, causal, scale)


def _sdpa_fwd_res(query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False):
    return flash_fwd_lse(query, key, value, bool(is_causal), flashex._scale_of(query, scale))


def _sdpa_bwd_res(g, query, key, value, out, lse, attn_mask=None, is_causal=False, scale=None, enable_gqa=False):
    return flash_bwd(g, query, key, value, out, lse, bool(is_causal), flashex._scale_of(query, scale))


def _ce_bwd(g, input, target, ignore_index=-100, reduction="mean"):
    return ce_bwd(input, target, fusedex.ce_row_scale(g, target, int(ignore_index), reduction))


def _rms(a, normalized_shape, weight=None, eps=None):
    return norm_fwd(a, weight, None, normex.RMS_EPS if eps is None else float(pyval(eps)), False)


def _rms_bwd(g, a, weight, eps):
    dx, dw, _ = norm_bwd(g, a, weight, float(pyval(eps)), False, False, 1)
    return dx, dw.to(weight.dtype)


def _ln(a, normalized_shape, weight=None, bias=None, eps=1e-5):
    return norm_fwd(a, weight, bias, float(pyval(eps)), True)


def _ln_bwd(g, a, weight, bias, eps):
    dx, dw, db = norm_bwd(g, a, weight, float(pyval(eps)), True, bias is not None, 1)
    return dx, dw.to(weight.dtype), None if db is None else db.to(weight.dtype)


_QUANT = ("folding a per-tensor amax over the slices would change the scale each slice is quantized with "
          "(ROADMAP.md, queue A: batching rules still missing)")

# (executor name, symbol id) -> the implementation under vmap. The torch
# executor's operators batch by themselves; its draws (csrc/rng.cu) take the
# call's key unbatched, so every slice draws the same numbers, as under
# jax.vmap.
IMPLS: dict[tuple[str, str], Callable] = {
    ("flash", "torch.scaled_dot_product_attention"): _sdpa,
    ("flash", "torch.sdpa_bwd"): _sdpa_bwd,
    ("flash", "torch.sdpa_fwd_res"): _sdpa_fwd_res,
    ("flash", "torch.sdpa_bwd_res"): _sdpa_bwd_res,
    ("fused", "torch.apply_rope"): rope,
    ("fused", "torch.cross_entropy"): functools.partial(fusedex._ce_impl, rows=ce_rows),
    ("fused", "torch.cross_entropy_bwd"): _ce_bwd,
    ("norm", "torch.rms_norm"): _rms,
    ("norm", "torch.rms_norm_bwd"): _rms_bwd,
    ("norm", "torch.layer_norm"): _ln,
    ("norm", "torch.layer_norm_bwd"): _ln_bwd,
}


_MISSING = "ROADMAP.md, queue A: batching rules still missing"


def _mask_of(bsym):
    if bsym.sym.id == "torch.sdpa_bwd":
        return bsym.args[4] if len(bsym.args) > 4 else bsym.kwargs.get("attn_mask")
    return flashex._sdpa_bound(bsym.args, bsym.kwargs)["attn_mask"]


def _refusal(bsym) -> Optional[str]:
    """Why a claimed op cannot run under vmap, or None."""
    ex = bsym.sym.executor
    if ex is None or ex.name in ("torch", "python"):
        return None
    if ex.name == "quant":
        return f"the quant executor's {bsym.sym.name} (the int8 GEMM and quantization kernels): {_QUANT}"
    if (ex.name, bsym.sym.id) not in IMPLS:
        return f"the {ex.name} executor's {bsym.sym.name} ({_MISSING})"
    if bsym.sym.id in ("torch.scaled_dot_product_attention", "torch.sdpa_bwd") and _mask_of(bsym) is not None:
        return (f"the flash executor's masked {bsym.sym.name} (kernel rows 8-9, flash_fwd_seg and "
                f"flash_bwd_recompute under segment ids): the mask's verdict is read on the host per call "
                f"({_MISSING})")
    return None


def batched_callable(extrace) -> Callable:
    """The claimed trace's callable with every kernel op bound to its
    implementation under vmap. Raises ``NotImplementedError`` naming the
    first claimed kernel that has no batching rule."""
    overrides = {}
    for bsym in extrace.bound_symbols:
        why = _refusal(bsym)
        if why is not None:
            raise NotImplementedError(f"vmap: {why}")
        ex = bsym.sym.executor
        if ex is not None and (ex.name, bsym.sym.id) in IMPLS:
            overrides[bsym.gen_call_target()[0]] = IMPLS[(ex.name, bsym.sym.id)]
    return extrace.python_callable(**overrides)
