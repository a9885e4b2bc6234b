"""Fused kernels: rotary embedding and cross-entropy forward and backward.

The counterpart of ``thunder_tpu/executors/pallasex.py``, whose rope
(``_rope_kernel``) and cross-entropy forward and backward (``_ce_fwd_kernel``,
``_ce_bwd_kernel``) are Pallas TPU kernels. Here they are hand-written CUDA
kernels, ``csrc/rope.cu`` and ``csrc/cross_entropy.cu``. The opt-in norm
kernels of ``pallasex.py`` are ``normex.py``'s.

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

from dataclasses import dataclass

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


def _tables(t: torch.Tensor, B: int) -> torch.Tensor:
    """cos or sin in f32 against x (B, H, T, D): (T, D) as it is, a table a
    segment of the batch (S, T, D) as (B, 1, T, D), batch row b taking table
    b // (B / S)."""
    tf = t.float()
    return tf if tf.ndim == 2 else tf.repeat_interleave(B // tf.shape[0], 0)[:, None]


def rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x·cos + [−x2, x1]·sin, computed in f32 and rounded once to x's dtype;
    cos/sin (T, D), or (S, T, D) with a table a segment of x's batch."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * _tables(cos, x.shape[0]) + rotated * _tables(sin, x.shape[0])).to(x.dtype)


# The rope kernel's launch plan; the constants are those of csrc/rope.cu.
_ROPE_TILE_BYTES = 4096  # bytes of one head's tile of x (rows of t), at most
_ROPE_HEADS = 32  # heads a block walks, at most
_ROPE_STAGE = 8  # heads a stage (two stages of x in shared memory)
_ROPE_MIN_BLOCKS = 1  # blocks an SM at least, before heads a block are cut
_MAX_SMEM = 232448  # shared memory a block may ask for on sm_90


@dataclass(frozen=True)
class RopePlan:
    """How ``rope_kernel`` (csrc/rope.cu) walks x (B, H, T, D):

    - ``rows``, ``heads``: a block's tile of t (a power of two) and the
      group of heads it walks, in stages of ``stage`` heads, two of them in
      shared memory at once; ``grid`` is (tiles of t, head groups, B);
    - ``load``: bytes of each copy of x into shared memory (16, 8, 4, or
      the element size), ``flat``: a head's rows lie back to back, so its
      tile is copied as one run;
    - ``vec``: elements a thread computes and stores at once (16 bytes, or
      1), ``pair``: elements of the partner half read at once;
    - ``direct``: a row too wide for shared memory, read from device memory
      one element at a time (``rows`` = ``heads`` = ``vec`` = 1);
    - ``smem``: dynamic shared memory a block (cos, sin and two stages), bytes.
    """

    rows: int
    heads: int
    stage: int
    load: int
    flat: bool
    vec: int
    pair: int
    direct: bool
    grid: tuple[int, int, int]
    smem: int


def rope_plan(B: int, H: int, T: int, D: int, elem_size: int, strides: tuple[int, int, int], align: int,
              sm_count: int, table_align: int = 16) -> RopePlan:
    """The rope kernel's plan for x (B, H, T, D) of ``elem_size``-byte
    elements with element strides ``strides`` (b, h, t) whose base pointer
    ``align`` (a power of two up to 16) divides; ``table_align`` divides the
    base pointers of cos, sin and the output. A head's tile is the most rows
    (a power of two) that fit ``_ROPE_TILE_BYTES`` and shared memory; a
    block walks the largest divisor of H up to ``_ROPE_HEADS`` (fewer while
    the grid has under ``_ROPE_MIN_BLOCKS`` blocks an SM); every width is
    the widest that the pointers, strides and lengths allow."""
    es, row = elem_size, D * elem_size
    if (2 + 2) * row > _MAX_SMEM:  # cos, sin and two stages of one row
        return RopePlan(1, 1, 1, es, False, 1, 1, True, (T, H, B), 0)
    rows = 1 << max(0, min(_ROPE_TILE_BYTES // row, 1 << max(0, T - 1).bit_length()).bit_length() - 1)
    tile = rows * row
    heads = max(d for d in range(1, min(H, _ROPE_HEADS) + 1) if H % d == 0)
    blocks = lambda hg: B * -(-T // rows) * -(-H // hg)  # noqa: E731
    while heads > 1 and blocks(heads) < _ROPE_MIN_BLOCKS * sm_count:
        heads = -(-heads // 2)
    stage = min(heads, _ROPE_STAGE, (_MAX_SMEM // tile - 2) // 2)
    # A head's output tile, and the (rows, D) slice of cos and sin, start on
    # 16 bytes when every tile and every head does.
    vec = 16 // es if table_align % 16 == 0 and tile % 16 == 0 and (T * row) % 16 == 0 else 1
    pair = next(p for p in (8, 4, 2, 1) if p <= vec and (D // 2) % p == 0)
    sb, sh, st = strides
    flat = st == D or T == 1
    # Each copy's unit divides the base pointer, every stride of a dimension
    # with more than one index, and the runs: a row, or a flat tile (the last
    # one ragged) and the offset between tiles.
    used = [s for s, n in ((sb, B), (sh, H)) if n > 1] + ([] if flat else [st])
    runs = [rows * D, (T % rows) * D] if flat else [D]
    load = next((u for u in (16, 8, 4) if u >= es and align % u == 0
                 and all(s * es % u == 0 for s in used) and all(n * es % u == 0 for n in runs)), es)
    grid = (-(-T // rows), -(-H // heads), B)
    return RopePlan(rows, heads, stage, load, flat, vec, pair, False, grid, (2 + 2 * stage) * tile)


def rope_plan_of(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, out: torch.Tensor) -> RopePlan:
    """The plan for x (B, H, T, D), cos and sin (contiguous) and out on their CUDA device."""
    B, H, T, D = x.shape
    return rope_plan(B, H, T, D, x.element_size(), x.stride()[:3], _build.ptr_align(x),
                     _build.sm_count(x.device.index), _build.ptr_align(cos, sin, out))


@_build.counted
def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rope of x (B, H, T, D) with cos/sin (T, D), or (S, T, D):
    a table a segment of B / S batch rows (per-sample positions; a vmapped
    table). x may be a strided view (last dim contiguous); the result is
    contiguous."""
    _build.refuse_transformed("rope", x, cos, sin)
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin)
    if not (x.is_cuda and cos.device == x.device and sin.device == x.device):
        raise ValueError(f"rope: x, cos, sin must be on one CUDA device, got {x.device}, {cos.device}, {sin.device}")
    if not (x.dtype == cos.dtype == sin.dtype) or str(x.dtype).removeprefix("torch.") not in _build.DTYPE_CODES:
        raise ValueError(f"rope: x, cos, sin must share one of bf16/f16/f32, got {x.dtype}, {cos.dtype}, {sin.dtype}")
    B, H, T, D = x.shape
    S = cos.shape[0] if cos.ndim == 3 else 0
    if (tuple(cos.shape[-2:]) != (T, D) or sin.shape != cos.shape or cos.ndim not in (2, 3) or D % 2
            or (S and B % S)):
        raise ValueError(f"rope: unsupported shapes x {tuple(x.shape)}, cos {tuple(cos.shape)}, sin {tuple(sin.shape)}")
    x = x if x.stride(-1) == 1 else x.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    out = torch.empty((B, H, T, D), dtype=x.dtype, device=x.device)
    plan = rope_plan_of(x, cos, sin, out)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        status = lib.thunder_rope(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), B, H, T, D, *x.stride()[:3],
            plan.rows, plan.heads, plan.stage, plan.load, plan.vec, plan.pair, int(plan.flat), int(plan.direct),
            B // S if S else 0, _build.dtype_code(x), _build.stream_of(x),
        )
    _build.check(status, "rope")
    apply_rope.launches += 1
    return out


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


@_build.counted
def cross_entropy_rows(logits: torch.Tensor, target: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Per-row loss (N,) in f32 of logits (N, V) against targets (N,)."""
    _build.refuse_transformed("ce_fwd", logits, target)
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


def _ce_impl(input, target, weight=None, ignore_index=-100, reduction="mean", label_smoothing=0.0, *, rows=None):
    """The claimed cross-entropy: per-row losses from the kernel (``rows``,
    under vmap its batching rule; by default ``cross_entropy_rows``), then
    their sum or mean."""
    total = (rows or cross_entropy_rows)(input, target, int(ignore_index)).sum()
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
    sync and no copy to the device (a number ``g`` stays a 0-d CPU tensor):
    g·valid/max(#valid, 1) for the mean, g·valid for the sum."""
    valid = (target != ignore_index).to(torch.float32)
    scale = (g if isinstance(g, torch.Tensor) else torch.tensor(g)).to(torch.float32) * valid
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


@_build.counted
def cross_entropy_bwd(logits: torch.Tensor, target: torch.Tensor, row_scale: torch.Tensor) -> torch.Tensor:
    """dlogits (N, V), contiguous, in the logits' dtype."""
    _build.refuse_transformed("ce_bwd", logits, target, row_scale)
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


def _ce_bwd_checker(g, input, target, ignore_index=-100, reduction="mean") -> bool:
    return _ce_checker(input, target, None, ignore_index, reduction)


def _ce_bwd_impl(g, input, target, ignore_index=-100, reduction="mean"):
    return cross_entropy_bwd(input, target, ce_row_scale(g, target, int(ignore_index), reduction))


ex.register_implementation("torch.cross_entropy_bwd", fn=_ce_bwd_impl, checker=_ce_bwd_checker)
