"""Fused kernels: rotary embedding and cross-entropy forward and backward.

The counterpart of ``thunder_tpu/executors/pallasex.py``, whose rope
(``_rope_kernel``) and cross-entropy forward and backward (``_ce_fwd_kernel``,
``_ce_bwd_kernel``) are Pallas TPU kernels. Here they are hand-written CUDA
kernels, ``csrc/rope.cu`` and ``csrc/cross_entropy.cu``. The opt-in norm
kernels of ``pallasex.py`` are a later part of the port (ROADMAP.md).

Claims:
- ``torch.apply_rope``: full-rotary rotate-half over (B, H, T, D) with
  (T, D) cos/sin, all one dtype (mixed dtypes are refused, not promoted),
  T % 8 == 0 — the checker of ``pallasex._rope_checker``. Its backward is
  ``apply_rope(g, cos, -sin)`` (the VJP rule in ``torch/__init__.py``),
  which this claim takes too, so the backward runs the same kernel;
- ``torch.cross_entropy`` with no class weights, no label smoothing and
  ``mean`` or ``sum`` reduction, on (N, V) f32 or bf16 logits with int32 or
  int64 targets. The kernel writes each row's loss in f32 (0 for an
  ignored row); the wrapper sums and, for the mean, divides by
  max(#valid, 1), as ``pallasex._ce_impl`` does;
- ``torch.cross_entropy_bwd`` under the same conditions: the kernel writes
  (softmax − onehot)·row_scale in the logits' dtype, with row_scale built
  on the device from the cotangent (no host sync), as
  ``pallasex._ce_bwd_impl`` builds it.

Each wrapper launches its kernel on CUDA tensors, or raises; on CPU tensors it
runs the plain PyTorch version beside it.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import pyval
from thunder_tpu_torch.executors import _build
from thunder_tpu_torch.extend import OperatorExecutor, register_executor

ex = OperatorExecutor("fused")
register_executor(ex)


# =============================================================================
# Rotary embedding
# =============================================================================


def rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x·cos + [−x2, x1]·sin, computed in f32 and rounded once to x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos.float() + rotated * sin.float()).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rope of x (B, H, T, D) with cos/sin (T, D). x may be a
    strided view (last dim contiguous); the result is contiguous."""
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin)
    if not (x.is_cuda and cos.device == x.device and sin.device == x.device):
        raise ValueError(f"rope: x, cos, sin must be on one CUDA device, got {x.device}, {cos.device}, {sin.device}")
    if not (x.dtype == cos.dtype == sin.dtype) or str(x.dtype).removeprefix("torch.") not in _build.DTYPE_CODES:
        raise ValueError(f"rope: x, cos, sin must share one of bf16/f16/f32, got {x.dtype}, {cos.dtype}, {sin.dtype}")
    B, H, T, D = x.shape
    if tuple(cos.shape) != (T, D) or tuple(sin.shape) != (T, D) or D % 2:
        raise ValueError(f"rope: unsupported shapes x {tuple(x.shape)}, cos {tuple(cos.shape)}, sin {tuple(sin.shape)}")
    x = x if x.stride(-1) == 1 else x.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    out = torch.empty((B, H, T, D), dtype=x.dtype, device=x.device)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        status = lib.thunder_rope(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), B, H, T, D,
            *x.stride()[:3], _build.dtype_code(x), _build.stream_of(x),
        )
    _build.check(status, "rope")
    apply_rope.launches += 1
    return out


apply_rope.launches = 0


def _rope_checker(x, cos, sin) -> bool:
    if len(getattr(x, "shape", ())) != 4 or len(getattr(cos, "shape", ())) != 2:
        return False
    if not (x.dtype == cos.dtype == sin.dtype):
        return False  # mixed dtypes promote in the decomposition; don't alter semantics
    if dtypes.to_dtype(x.dtype) not in (dtypes.bfloat16, dtypes.float16, dtypes.float32):
        return False
    T, n = cos.shape
    return tuple(sin.shape) == (T, n) and x.shape[-2] == T and x.shape[-1] == n and n % 2 == 0 and T % 8 == 0


ex.register_implementation("torch.apply_rope", fn=apply_rope, checker=_rope_checker)


# =============================================================================
# Cross-entropy forward
# =============================================================================


def cross_entropy_rows_plain(logits: torch.Tensor, target: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Per-row loss in f32: logsumexp − x[target], 0 for an ignored row, NaN
    for a target outside [0, V) that is not ignored."""
    x = logits.float()
    V = x.shape[-1]
    t = target.long()
    valid = t != ignore_index
    in_range = (t >= 0) & (t < V)
    picked = x.gather(1, t.clamp(0, V - 1)[:, None])[:, 0]
    loss = torch.logsumexp(x, dim=-1) - picked
    loss = torch.where(in_range, loss, torch.full_like(loss, float("nan")))
    return torch.where(valid, loss, torch.zeros_like(loss))


def cross_entropy_rows(logits: torch.Tensor, target: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Per-row loss (N,) in f32 of logits (N, V) against targets (N,)."""
    if logits.device.type == "cpu":
        return cross_entropy_rows_plain(logits, target, ignore_index)
    if not (logits.is_cuda and target.device == logits.device):
        raise ValueError(f"ce_fwd: logits and target must be on one CUDA device, got {logits.device}, {target.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16) or target.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ce_fwd: needs f32/bf16 logits and int32/int64 targets, got {logits.dtype}, {target.dtype}")
    if logits.ndim != 2 or target.shape != logits.shape[:1]:
        raise ValueError(f"ce_fwd: unsupported shapes logits {tuple(logits.shape)}, target {tuple(target.shape)}")
    logits = logits if logits.stride(-1) == 1 else logits.contiguous()
    N, V = logits.shape
    target = target.contiguous()
    loss = torch.empty((N,), dtype=torch.float32, device=logits.device)
    vec4 = V % 4 == 0 and logits.stride(0) % 4 == 0 and logits.data_ptr() % (4 * logits.element_size()) == 0
    lib = _build.lib()
    with torch.cuda.device(logits.device):
        status = lib.thunder_ce_fwd(
            logits.data_ptr(), target.data_ptr(), loss.data_ptr(), N, V, logits.stride(0),
            _build.dtype_code(logits), int(target.dtype == torch.int64), int(ignore_index), int(vec4),
            _build.stream_of(logits),
        )
    _build.check(status, "ce_fwd")
    cross_entropy_rows.launches += 1
    return loss


cross_entropy_rows.launches = 0


def _ce_checker(input, target, weight=None, ignore_index=-100, reduction="mean", label_smoothing=0.0) -> bool:
    if len(getattr(input, "shape", ())) != 2 or len(getattr(target, "shape", ())) != 1:
        return False
    in_dt, tgt_dt = dtypes.to_dtype(input.dtype), dtypes.to_dtype(target.dtype)
    return (
        weight is None
        and float(pyval(label_smoothing)) == 0.0
        and reduction in ("mean", "sum")
        and in_dt in (dtypes.float32, dtypes.bfloat16)
        and tgt_dt in (dtypes.int32, dtypes.int64)
    )


def _ce_impl(input, target, weight=None, ignore_index=-100, reduction="mean", label_smoothing=0.0):
    total = cross_entropy_rows(input, target, int(ignore_index)).sum()
    if reduction == "mean":
        count = (target != ignore_index).sum().to(torch.float32).clamp_min(1.0)
        total = total / count
    return total.to(input.dtype)


ex.register_implementation("torch.cross_entropy", fn=_ce_impl, checker=_ce_checker)


# =============================================================================
# Cross-entropy backward
# =============================================================================


def ce_row_scale(g, target: torch.Tensor, ignore_index: int, reduction: str) -> torch.Tensor:
    """Per-row scale (N,) f32 of dlogits, on target's device with no host
    sync: g·valid/max(#valid, 1) for the mean, g·valid for the sum."""
    valid = (target != ignore_index).to(torch.float32)
    scale = torch.as_tensor(g, device=target.device).to(torch.float32) * valid
    if reduction == "mean":
        scale = scale / valid.sum().clamp_min(1.0)
    return scale


def cross_entropy_bwd_plain(logits: torch.Tensor, target: torch.Tensor, row_scale: torch.Tensor) -> torch.Tensor:
    """(softmax(x) − onehot(target))·row_scale in f32, rounded once to the
    logits' dtype. A target outside [0, V) has no onehot column."""
    x = logits.float()
    cols = torch.arange(x.shape[-1], device=x.device)
    onehot = (cols[None, :] == target.long()[:, None]).to(torch.float32)
    return ((torch.softmax(x, dim=-1) - onehot) * row_scale[:, None]).to(logits.dtype)


def cross_entropy_bwd(logits: torch.Tensor, target: torch.Tensor, row_scale: torch.Tensor) -> torch.Tensor:
    """dlogits (N, V), contiguous, in the logits' dtype."""
    if logits.device.type == "cpu":
        return cross_entropy_bwd_plain(logits, target, row_scale)
    if not (logits.is_cuda and target.device == logits.device and row_scale.device == logits.device):
        raise ValueError(f"ce_bwd: logits, target, row_scale must be on one CUDA device, got {logits.device}, "
                         f"{target.device}, {row_scale.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16) or target.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ce_bwd: needs f32/bf16 logits and int32/int64 targets, got {logits.dtype}, {target.dtype}")
    if logits.ndim != 2 or target.shape != logits.shape[:1] or row_scale.shape != logits.shape[:1]:
        raise ValueError(f"ce_bwd: unsupported shapes logits {tuple(logits.shape)}, target {tuple(target.shape)}, "
                         f"row_scale {tuple(row_scale.shape)}")
    logits = logits if logits.stride(-1) == 1 else logits.contiguous()
    N, V = logits.shape
    target = target.contiguous()
    row_scale = row_scale.to(torch.float32).contiguous()
    out = torch.empty((N, V), dtype=logits.dtype, device=logits.device)
    vec4 = V % 4 == 0 and logits.stride(0) % 4 == 0 and logits.data_ptr() % (4 * logits.element_size()) == 0
    lib = _build.lib()
    with torch.cuda.device(logits.device):
        status = lib.thunder_ce_bwd(
            logits.data_ptr(), target.data_ptr(), row_scale.data_ptr(), out.data_ptr(), N, V, logits.stride(0),
            _build.dtype_code(logits), int(target.dtype == torch.int64), int(vec4), _build.stream_of(logits),
        )
    _build.check(status, "ce_bwd")
    cross_entropy_bwd.launches += 1
    return out


cross_entropy_bwd.launches = 0


def _ce_bwd_checker(g, input, target, ignore_index=-100, reduction="mean") -> bool:
    return _ce_checker(input, target, None, ignore_index, reduction)


def _ce_bwd_impl(g, input, target, ignore_index=-100, reduction="mean"):
    return cross_entropy_bwd(input, target, ce_row_scale(g, target, int(ignore_index), reduction))


ex.register_implementation("torch.cross_entropy_bwd", fn=_ce_bwd_impl, checker=_ce_bwd_checker)
