"""Flash-attention executor: hand-written CUDA kernels claiming SDPA whole.

The counterpart of ``thunder_tpu/executors/flashex.py``, whose forward runs
JAX's splash-attention Pallas kernel (``_sdpa_impl`` → ``_sdpa_runtime`` →
``_splash_sdpa``), whose residual pair (``_sdpa_fwd_res_impl``,
``_sdpa_bwd_res_impl``) runs its forward with logsumexp and its backward,
and whose recompute-path backward (``_sdpa_bwd_impl``) differentiates the
forward again. Here the forward is ``csrc/flash_attn.cu`` (online-softmax
flash attention on ``mma.sync`` with register accumulators, no (B, H, S, S)
scores in device memory; it writes the per-row logsumexp when asked, and
takes optional segment ids) and the backward is ``csrc/flash_bwd.cu`` and
``csrc/flash_bwd_dq.cu`` (dq, dk, dv from an output and logsumexp, under the
same optional segment ids). Heads run padded to a size of
``_HEAD_BUCKETS``.

Claims:
- ``torch.scaled_dot_product_attention``: no dropout, half precision
  (bf16/f16, like the JAX package's checker and the reference's fused-SDPA
  executors: float32 stays decomposed), 4-D inputs with S and L ≥ 64 and
  D ≤ 256, GQA where H is a multiple of G, and a mask of one of these shape
  classes (``_mask_kind``; ``is_causal`` and a mask are mutually exclusive,
  and a mask that requires grad is refused):
  - none: causal or full attention;
  - key padding, bool or additive, of shape (L,), (B, 1, 1, L) or
    (1, 1, 1, L);
  - a 4-D (1|B, 1, S, L) mask, the shape HF builds for a padded batch;
- ``torch.sdpa_bwd``, the recompute-path backward, under the same
  conditions: masked, padded and Tq ≠ Tkv pairs that the attention-residual
  pass leaves alone;
- ``torch.sdpa_fwd_res`` / ``torch.sdpa_bwd_res``, the pair that the
  attention-residual pass (``transforms/attention_residuals.py``) swaps in
  for (sdpa, sdpa_bwd) when ``residual_eligible`` holds: no mask and S == L.

``THUNDER_FLASH_IMPL=legacy`` selects the JAX package's other route,
``_legacy_flash`` (the Pallas TPU ``flash_attention``; ``splash``, the
default, is the route above). Under it the two checkers claim what the JAX
package's claim (``flashex.py:171-193``): no mask, S == L, S % 128 == 0,
besides the conditions above; ``residual_eligible`` is False, so the
backward is the recompute route; and the claims run ``legacy_flash_fwd``
and ``legacy_flash_bwd``. The variable is read, as in the JAX package, when
a claim is checked and when it runs.

A mask's values are checked when the program runs, as ``_sdpa_runtime``
does (``_mask_plan``): a key-padding mask must leave every batch row a key
(additive entries must be 0 or ≤ −1e9), and a 4-D mask must equal
causal∧kv_valid or full∧kv_valid on every row whose query is valid. Such a
mask runs the kernels under segment ids (valid 1, pad 0); any other mask
(an ALiBi bias, say) takes the exact branch, ``sdpa_exact``: f32 scores and
torch's safe softmax, the JAX package's ``_xla_sdpa``. The exact branch is
the reference's semantics for masks the kernel cannot express, not a
fallback for a kernel that fails: a kernel that fails to build or launch
raises. JAX decides on the device with ``lax.cond``; here the verdict is
read on the host once per mask tensor and kept on the tensor
(``_thunder_flash_plan``, keyed on its ``_version`` and the shapes), so the
layers of one call, and the backward, which receives the same tensor, read
it once. The module frontend takes it when it compiles an entry and gives
it to the claims (:func:`with_verdicts`), which then read nothing; a value
guard holds later calls to it. Under segment ids a pad query attends the
pad keys it may see, where splash leaves it undefined; both are finite, and the consumers of a
padded batch read valid rows only.

Each wrapper launches its kernel on CUDA tensors, or raises; on CPU tensors it
runs its plain version, the same arithmetic in plain PyTorch. Strides: q, k
and v arrive as views of the fused qkv projection, and the backward's dout
may be strided too; the kernels read them through their strides and copy
nothing (only a tensor whose last dim is strided would be copied).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import pyval
from thunder_tpu_torch.core.trace import from_trace
from thunder_tpu_torch.executors import _build
from thunder_tpu_torch.extend import OperatorExecutor, register_executor
from thunder_tpu_torch.resilience import chaos

ex = OperatorExecutor("flash")
register_executor(ex)

_MIN_SEQ = 64  # below this the decomposition is as cheap as a kernel launch
_MAX_HEAD = 256
# The head sizes the kernels are built for (``csrc/flash_common.cuh``
# ``THUNDER_FLASH_HEAD_BUCKETS``): a head runs in the smallest bucket that
# holds it, padded with zeros.
_HEAD_BUCKETS = (32, 64, 112, 128, 256)
_TILE = 64  # query and key tiles of the kernels' grids
_MAX_TILES = 65535  # the grids' y extent, in tiles of the sequence
_NEG_BIG = -1e9  # additive-mask entries at or below this count as masked
_LEGACY_ALIGN = 128  # the legacy route's sequence quantum (the TPU kernel's block)


def _impl_name() -> str:
    """``THUNDER_FLASH_IMPL``: "splash" (the default) or "legacy"."""
    return os.environ.get("THUNDER_FLASH_IMPL", "splash")


# =============================================================================
# The kernels' plain versions
# =============================================================================


def _expand_heads(q: torch.Tensor, *kv: torch.Tensor) -> list[torch.Tensor]:
    """k/v (B, G, T, D) repeated to q's H heads (kv head h // (H / G))."""
    H, G = q.shape[1], kv[0].shape[1]
    return [t.repeat_interleave(H // G, dim=1) if G != H else t for t in kv]


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, scale: float, q_seg=None,
            kv_seg=None) -> torch.Tensor:
    """scale·q·kᵀ in f32 with the causal mask aligned bottom-right and, given
    segment ids, the pairs whose segments differ masked (−inf)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        Tq, Tkv = q.shape[-2], k.shape[-2]
        i = torch.arange(Tq, device=q.device)[:, None]
        j = torch.arange(Tkv, device=q.device)[None, :]
        s = s.masked_fill(j > i + (Tkv - Tq), -math.inf)
    if q_seg is not None:
        s = s.masked_fill(q_seg[:, None, :, None] != kv_seg[:, None, None, :], -math.inf)
    return s


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                              scale: float, q_seg=None, kv_seg=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_plain`` and the per-row logsumexp (B, H, Tq) in f32
    of the scaled, masked scores (natural log; −inf where a query sees no
    key)."""
    k, v = _expand_heads(q, k, v)
    s = _scores(q, k, causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float())
    o = torch.where(l > 0, o / l.clamp_min(torch.finfo(torch.float32).tiny), torch.zeros_like(o))
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                          scale: float, q_seg=None, kv_seg=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 scores scaled in f32,
    causal mask aligned bottom-right, query i seeing key j only where
    ``q_seg[b, i] == kv_seg[b, j]`` when segment ids are given, f32 softmax
    statistics, P rounded to the input type before P·V, and a zero row where
    a query sees no key."""
    return flash_attention_lse_plain(q, k, v, causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)[0]


def flash_attention_bwd_plain(dout, q, k, v, out, lse, *, causal: bool, scale: float, q_seg=None, kv_seg=None):
    """The backward kernel's arithmetic in plain PyTorch, from an output and
    its logsumexp: Di = rowsum(dout∘out), P = exp(scale·qkᵀ − lse)
    (masked by causality and segments, 0 where lse is −inf), dV = Pᵀ·dout,
    dP = dout·vᵀ, dS = P∘(dP − Di), dQ = scale·dS·k, dK = scale·dSᵀ·q, all
    in f32, with P and dS rounded to the input type before the products that
    take them, as the kernel's tensor-core products do. dk/dv are summed over
    the query heads of each kv group. Returns (dq, dk, dv) in the input
    dtype."""
    B, H, Tq, D = q.shape
    G, Tkv = k.shape[1], k.shape[2]
    ke, ve = _expand_heads(q, k, v)
    s = _scores(q, ke, causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
    lse_col = lse.float()[..., None]
    p = torch.exp(s - lse_col)
    p = torch.where((s > -math.inf) & (lse_col > -math.inf), p, torch.zeros_like(p))
    do = dout.float()
    di = (do * out.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, ve.float().transpose(-1, -2))
    ds = (p * (dp - di)).to(q.dtype).float()
    dq = torch.matmul(ds, ke.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    if G != H:
        dk = dk.reshape(B, G, H // G, Tkv, D).sum(2)
        dv = dv.reshape(B, G, H // G, Tkv, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_recompute_plain(dout, q, k, v, *, causal: bool, scale: float, q_seg=None, kv_seg=None):
    """The recompute-path backward's arithmetic: ``flash_attention_lse_plain``
    under the same segments, then ``flash_attention_bwd_plain`` from its
    output and logsumexp."""
    out, lse = flash_attention_lse_plain(q, k, v, causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
    return flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale, q_seg=q_seg,
                                     kv_seg=kv_seg)


# =============================================================================
# The kernels' wrappers
# =============================================================================


def _check_cuda_inputs(q, k, v, kernel: str) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{kernel}: q, k, v must be on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.bfloat16, torch.float16) or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"{kernel}: q, k, v must all be bf16 or all f16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{kernel}: q, k, v must be (B, H, T, D)")
    B, H, Tq, D = q.shape
    if k.shape[0] != B or v.shape != k.shape or k.shape[-1] != D or D > _MAX_HEAD or H % k.shape[1]:
        raise ValueError(f"{kernel}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not _seq_ok(Tq, k.shape[2]):
        raise ValueError(f"{kernel}: sequences of {Tq} and {k.shape[2]} exceed the grid's y limit")


def _seg_ptrs(q, k, q_seg, kv_seg, kernel: str) -> tuple:
    """The segment ids' pointers (None, None without segments), after
    checking them: int32 (B, Tq) and (B, Tkv), contiguous, on q's device."""
    if q_seg is None and kv_seg is None:
        return None, None
    if q_seg is None or kv_seg is None:
        raise ValueError(f"{kernel}: q_seg and kv_seg go together")
    B, Tq, Tkv = q.shape[0], q.shape[2], k.shape[2]
    for name, t, shape in (("q_seg", q_seg, (B, Tq)), ("kv_seg", kv_seg, (B, Tkv))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous int32 {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return q_seg.data_ptr(), kv_seg.data_ptr()


def _seq_ok(Tq: int, Tkv: int) -> bool:
    return -(-max(Tq, Tkv) // _TILE) <= _MAX_TILES


def _head_bucket(D: int) -> int:
    """The padded head size the kernels run a head of D columns in: the
    smallest of ``_HEAD_BUCKETS`` that holds it (100 → 112)."""
    for dp in _HEAD_BUCKETS:
        if 1 <= D <= dp:
            return dp
    raise ValueError(f"flash: head size {D} is outside 1..{_MAX_HEAD}")


def _vec_width(D: int, *ts: torch.Tensor) -> int:
    """Elements per global-to-shared copy (``cp.async`` of 16, 8 or 4 bytes;
    1 is a plain 2-byte load): the widest that D, every b/h/t stride and
    every base pointer are multiples of. A D = 100 row is 200 bytes, so the
    rows of a contiguous (B, H, T, 100) tensor start 8-byte aligned: 4."""
    for vec in (8, 4, 2):
        if D % vec == 0 and all(t.data_ptr() % (2 * vec) == 0 and all(s % vec == 0 for s in t.stride()[:3])
                                for t in ts):
            return vec
    return 1


def _launch_fwd(q, k, v, causal: bool, scale: float, lse, q_seg=None, kv_seg=None) -> torch.Tensor:
    _check_cuda_inputs(q, k, v, "flash_fwd")
    segs = _seg_ptrs(q, k, q_seg, kv_seg, "flash_fwd")
    # The kernel reads rows through the b/h/t strides; only a strided last
    # dim (never on the model's path) is copied.
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    B, H, Tq, D = q.shape
    G, Tkv = k.shape[1], k.shape[2]
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        status = lib.thunder_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            *segs, B, H, G, Tq, Tkv, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
            int(bool(causal)), _build.dtype_code(q), _vec_width(D, q, k, v), _head_bucket(D), _build.stream_of(q),
        )
    _build.check(status, "flash_fwd")
    return out


def _launch_bwd(dout, q, k, v, out, lse, causal: bool, scale: float, q_seg=None, kv_seg=None):
    _check_cuda_inputs(q, k, v, "flash_bwd")
    segs = _seg_ptrs(q, k, q_seg, kv_seg, "flash_bwd")
    B, H, Tq, D = q.shape
    G, Tkv = k.shape[1], k.shape[2]
    if not all(t.device == q.device for t in (dout, out, lse)):
        raise ValueError(f"flash_bwd: dout, out, lse must be on {q.device}, got {dout.device}, {out.device}, "
                         f"{lse.device}")
    if dout.dtype != q.dtype or out.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: dout/out must be {q.dtype} and lse float32, got {dout.dtype}, {out.dtype}, "
                         f"{lse.dtype}")
    if tuple(dout.shape) != (B, H, Tq, D) or tuple(out.shape) != (B, H, Tq, D) or tuple(lse.shape) != (B, H, Tq):
        raise ValueError(f"flash_bwd: unsupported shapes dout {tuple(dout.shape)}, out {tuple(out.shape)}, "
                         f"lse {tuple(lse.shape)}")
    q, k, v, out, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, G, Tkv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, G, Tkv, D), dtype=q.dtype, device=q.device)
    di = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        status = lib.thunder_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(), *segs, B, H, G, Tq, Tkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
            float(scale), int(bool(causal)), _build.dtype_code(q), _vec_width(D, q, k, v, out, dout), _head_bucket(D),
            _build.stream_of(q),
        )
    _build.check(status, "flash_bwd")
    return dq, dk, dv


@_build.counted
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        scale: float) -> torch.Tensor:
    """Causal or full attention of q (B, H, Tq, D) over k/v (B, G, Tkv, D)."""
    _build.refuse_transformed("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    out = _launch_fwd(q, k, v, causal, scale, None)
    flash_attention_fwd.launches += 1
    return out


@_build.counted
def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` that also returns the per-row logsumexp
    (B, H, Tq) in f32: the same kernel, told where to write it."""
    _build.refuse_transformed("flash_fwd_lse", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, causal, scale, lse)
    flash_attention_fwd_lse.launches += 1
    return out, lse


@_build.counted
def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, *, causal: bool,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention from the saved output and logsumexp; dk and
    dv (B, G, Tkv, D) are summed over the query heads of each kv group."""
    _build.refuse_transformed("flash_bwd", dout, q, k, v, out, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale)
    grads = _launch_bwd(dout, q, k, v, out, lse, causal, scale)
    flash_attention_bwd.launches += 1
    return grads


@_build.counted
def flash_attention_fwd_seg(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_seg: torch.Tensor,
                            kv_seg: torch.Tensor, *, causal: bool, scale: float) -> torch.Tensor:
    """Attention under segment ids: query i of batch row b sees key j only
    where ``q_seg[b, i] == kv_seg[b, j]`` (and, when causal, j ≤ i + Tkv −
    Tq). The forward kernel, given the segments' pointers."""
    _build.refuse_transformed("flash_fwd_seg", q, k, v, q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, q_seg=q_seg, kv_seg=kv_seg)
    out = _launch_fwd(q, k, v, causal, scale, None, q_seg, kv_seg)
    flash_attention_fwd_seg.launches += 1
    return out


@_build.counted
def flash_attention_bwd_recompute(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                  causal: bool, scale: float, q_seg: Optional[torch.Tensor] = None,
                                  kv_seg: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of attention with nothing saved: the forward kernel
    recomputes (out, lse) under the same segments, then the backward kernel
    runs from them. One count per call; the call launches both kernels."""
    _build.refuse_transformed("flash_bwd_recompute", dout, q, k, v, q_seg, kv_seg)
    if q.device.type == "cpu":
        return flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal, scale=scale, q_seg=q_seg,
                                                   kv_seg=kv_seg)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, causal, scale, lse, q_seg, kv_seg)
    grads = _launch_bwd(dout, q, k, v, out, lse, causal, scale, q_seg, kv_seg)
    flash_attention_bwd_recompute.launches += 1
    return grads


# =============================================================================
# Row 10: the legacy route (THUNDER_FLASH_IMPL=legacy)
# =============================================================================
#
# Replaces ``flashex._legacy_flash`` (``thunder_tpu/executors/flashex.py:422-
# 444``), the Pallas TPU ``flash_attention`` (forward; its backward is
# ``jax.vjp`` of it: the forward again with its residuals, then the dK/dV and
# dQ kernels). On the domain the legacy checkers claim (no mask, S == L,
# S % 128 == 0, half precision) it computes what rows 1 and 8 compute: f32
# scores scaled in f32 (``flash_attention.py:408-409``), causal as col <= row
# (``:432``), which for S == L is the bottom-right alignment of
# ``csrc/flash_attn.cu``. So the route launches those kernels, through
# wrappers of its own that count its launches. The JAX package expands k/v
# to H heads and sums dk/dv over each group; the kernels take G kv heads and
# sum inside (the same function). Bound: the forward's 4·B·H·D FLOP per
# causal (query, key) pair, the backward's 14 (the recomputed forward's 4 and
# the backward's 10), at the bf16 tensor-core rate.


@_build.counted
def legacy_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                     scale: float) -> torch.Tensor:
    """Row 10's forward: attention of q (B, H, S, D) over k/v (B, G, S, D),
    the row-1 kernel (``flash_attention_plain`` on CPU tensors)."""
    _build.refuse_transformed("legacy_flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    out = _launch_fwd(q, k, v, causal, scale, None)
    legacy_flash_fwd.launches += 1
    return out


@_build.counted
def legacy_flash_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                     scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row 10's backward, ``jax.vjp`` of ``_legacy_flash``: the forward
    kernel again with logsumexp, then the backward kernel (the row-8 route
    without segments; ``flash_attention_bwd_recompute_plain`` on CPU
    tensors). dk/dv (B, G, S, D) come summed over each kv group."""
    _build.refuse_transformed("legacy_flash_bwd", dout, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal, scale=scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, causal, scale, lse)
    grads = _launch_bwd(dout, q, k, v, out, lse, causal, scale)
    legacy_flash_bwd.launches += 1
    return grads


# =============================================================================
# The exact branch: masks the kernels cannot express
# =============================================================================


def _exact_sdpa(q, k, v, mask, *, causal: bool, scale: float) -> torch.Tensor:
    k, v = _expand_heads(q, k, v)
    s = _scores(q, k, causal=causal, scale=scale)
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf) if mask.dtype == torch.bool else s + mask.float()
    # torch-sdpa safe softmax: a fully masked row gives zeros, not NaN.
    dead = s.amax(-1, keepdim=True) == -math.inf
    p = torch.where(dead, torch.zeros_like(s), torch.softmax(s, dim=-1))
    return torch.matmul(p.to(q.dtype), v)


@_build.counted
def sdpa_exact(q, k, v, mask, *, causal: bool, scale: float) -> torch.Tensor:
    """SDPA with f32 scores and torch's safe softmax, in plain PyTorch: the
    JAX package's ``_xla_sdpa``, the branch of ``_sdpa_runtime`` for masks
    that fail the value checks. Every call counts, on any device."""
    sdpa_exact.launches += 1
    return _exact_sdpa(q, k, v, mask, causal=causal, scale=scale)


def sdpa_exact_bwd(g, q, k, v, mask, *, causal: bool, scale: float):
    """(dq, dk, dv) of ``sdpa_exact``, by autograd over its arithmetic (the
    JAX package differentiates ``_xla_sdpa``); dk and dv are summed over the
    query heads of each kv group. Counts on ``sdpa_exact``."""
    sdpa_exact.launches += 1
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        out = _exact_sdpa(qr, kr, vr, mask, causal=causal, scale=scale)
        return torch.autograd.grad(out, (qr, kr, vr), g)


# =============================================================================
# Mask classification and the runtime verdict
# =============================================================================


def _is_bool(m) -> bool:
    if isinstance(m, torch.Tensor):
        return m.dtype == torch.bool
    return dtypes.is_boolean_dtype(m.dtype)


def _mask_kind_of(shape: tuple, is_bool: bool, B: int, Tq: int, Tkv: int) -> str:
    if shape in {(Tkv,), (B, 1, 1, Tkv), (1, 1, 1, Tkv)}:
        return "keypad" if is_bool else "keypad_verify"
    if len(shape) == 4 and shape[0] in (1, B) and shape[1] == 1 and shape[2] == Tq and shape[3] == Tkv:
        return "verify4d"
    return "no"


def _mask_kind(m, q, k) -> str:
    """'none' | 'keypad' | 'keypad_verify' | 'verify4d' | 'no', from shapes
    alone (``flashex.py:119-137`` of the JAX package): key-padding shapes
    are those torch broadcasts to (B, H, Tq, Tkv) constant over the query
    axis; a 2-D (X, Tkv) mask aligns X with the query axis, so it is not one.
    A mask that requires grad is refused (the kernels give no mask
    cotangent)."""
    if m is None:
        return "none"
    if not hasattr(m, "shape") or getattr(m, "requires_grad", False):
        return "no"
    return _mask_kind_of(tuple(m.shape), _is_bool(m), q.shape[0], q.shape[-2], k.shape[-2])


@dataclass(frozen=True)
class MaskPlan:
    """How one SDPA call runs: the kernels (causal or full, under segment
    ids valid 1 / pad 0) or, when ``flash`` is False, the exact branch."""

    flash: bool
    causal: bool = False
    q_seg: Optional[torch.Tensor] = None
    kv_seg: Optional[torch.Tensor] = None


def _valid(m: torch.Tensor, B: int, Tq: int, Tkv: int) -> tuple:
    """``(kind, mm, visible, q_valid, kv_valid)`` of a mask the checker has
    classed: ``mm`` the mask at (B, Tkv) or (B, Tq, Tkv), ``visible`` what
    each query may see, and the valid queries and keys."""
    kind = _mask_kind_of(tuple(m.shape), m.dtype == torch.bool, B, Tq, Tkv)
    if kind in ("keypad", "keypad_verify"):
        mm = m.reshape(-1, Tkv).expand(B, Tkv)
        kv_valid = mm if kind == "keypad" else mm == 0
        return kind, mm, kv_valid, torch.ones((B, Tq), dtype=torch.bool, device=m.device), kv_valid
    mm = m.expand(B, 1, Tq, Tkv)[:, 0]
    visible = mm if mm.dtype == torch.bool else mm == 0
    kv_valid = visible[:, -1, :]  # the last query sees every valid key, causal or not
    return kind, mm, visible, kv_valid[:, Tkv - Tq:], kv_valid  # self-attention: the queries are the last Tq keys


def mask_verdict(m: torch.Tensor, B: int, Tq: int, Tkv: int, causal: bool) -> torch.Tensor:
    """The value checks of ``_sdpa_runtime`` (``flashex.py:342-414``) as a
    0-d int64 tensor on the mask's device, not read here: 0 for the exact
    branch, 1 for the kernels without causality, 2 for them causal."""
    kind, mm, visible, q_valid, kv_valid = _valid(m, B, Tq, Tkv)
    if kind in ("keypad", "keypad_verify"):
        # A row with no valid key takes the exact branch: torch's safe
        # softmax gives zeros there, and an all-(-1e9) additive row attends
        # uniformly, where segments would mask everything.
        ok = kv_valid.any(-1).all()
        if kind == "keypad_verify":
            ok = ok & (kv_valid | (mm <= _NEG_BIG)).all()
        return ok.to(torch.int64) * (2 if causal else 1)
    i = torch.arange(Tq, device=m.device)[:, None]
    j = torch.arange(Tkv, device=m.device)[None, :]
    tri = i + (Tkv - Tq) >= j
    pad_row = ~q_valid[:, :, None]  # only rows with a valid query must match
    ok_causal = (((tri[None] & kv_valid[:, None, :]) == visible) | pad_row).all()
    ok_full = ((kv_valid[:, None, :] == visible) | pad_row).all()
    if mm.dtype != torch.bool:
        exact = (visible | (mm <= _NEG_BIG)).all()
        ok_causal, ok_full = ok_causal & exact, ok_full & exact
    return torch.where(ok_causal, 2, ok_full.to(torch.int64))


def mask_plan(m: Optional[torch.Tensor], q: torch.Tensor, k: torch.Tensor, causal: bool,
              verdict: Optional[int] = None) -> MaskPlan:
    """The plan of one masked SDPA call. Its :func:`mask_verdict` is
    ``verdict`` when the claim was given one (the module frontend takes it
    when it compiles and guards it), else read on the host once per mask
    tensor and kept on it, keyed on its ``_version`` and the shapes, so every
    layer that receives the same mask in one call, and the backward, which
    receives it again, read the host once. ``mask_plan.host_reads`` counts
    the reads."""
    if m is None:
        return MaskPlan(True, causal)
    B, Tq, Tkv = q.shape[0], q.shape[-2], k.shape[-2]
    key = (m._version, B, Tq, Tkv, causal, verdict)
    memo = getattr(m, "_thunder_flash_plan", None)
    if memo is not None and memo[0] == key:
        return memo[1]
    if verdict is None:
        verdict = int(mask_verdict(m, B, Tq, Tkv, causal))
        mask_plan.host_reads += 1
    plan = MaskPlan(False)
    if verdict:
        _, _, _, q_valid, kv_valid = _valid(m, B, Tq, Tkv)
        plan = MaskPlan(True, verdict == 2, q_valid.to(torch.int32).contiguous(), kv_valid.to(torch.int32).contiguous())
    m._thunder_flash_plan = (key, plan)
    return plan


mask_plan.host_reads = 0


def _masked_site(bsym):
    """``(mask proxy, (B, Tq, Tkv, causal))`` of a claim of this executor
    that reads its mask's verdict on the host, else None."""
    if bsym.sym.executor is not ex or not ex.reads_host(bsym):
        return None
    if bsym.sym.id == "torch.sdpa_bwd":
        b = {"is_causal": False, **dict(zip(("g", "query", "key", "value", "attn_mask", "is_causal"), bsym.args)),
             **bsym.kwargs}
    else:
        b = _sdpa_bound(bsym.args, bsym.kwargs)
    q, k = b["query"], b["key"]
    return b["attn_mask"], (q.shape[0], q.shape[-2], k.shape[-2], bool(pyval(b["is_causal"])))


def masked_sites(trace) -> list:
    """:func:`_masked_site` of each distinct mask in ``trace``, in the order
    the trace first passes it."""
    sites = {}
    for bsym in trace.bound_symbols:
        site = _masked_site(bsym)
        if site is not None and site[0].name not in sites:
            sites[site[0].name] = site
    return list(sites.values())


def with_verdicts(trace, verdicts: dict):
    """``trace`` with each masked claim of this executor given its mask's
    verdict (``verdicts``: mask name to :func:`mask_verdict`'s value), so
    that none reads the host when it runs."""
    new = from_trace(trace)
    for bsym in trace.bound_symbols:
        site = _masked_site(bsym)
        if site is not None:
            bsym = bsym.from_bsym(kwargs={**bsym.kwargs, "verdict": verdicts[site[0].name]})
        new.bound_symbols.append(bsym)
    return new


# =============================================================================
# Claiming
# =============================================================================


def _sdpa_bound(args, kwargs) -> dict:
    names = ("query", "key", "value", "attn_mask", "dropout_p", "is_causal", "scale", "enable_gqa")
    defaults = {"attn_mask": None, "dropout_p": 0.0, "is_causal": False, "scale": None, "enable_gqa": False,
                "verdict": None}
    b = dict(defaults)
    b.update(zip(names, args))
    b.update(kwargs)
    return b


def _half(t) -> bool:
    return dtypes.to_dtype(t.dtype) in (dtypes.bfloat16, dtypes.float16)


def _shapes_ok(q, k, v, enable_gqa) -> bool:
    if not (len(q.shape) == len(k.shape) == len(v.shape) == 4):
        return False
    if not (_half(q) and q.dtype == k.dtype == v.dtype):
        return False
    B, H, S, D = q.shape
    G, L = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[-1] != D:
        return False
    if G != H and not (bool(pyval(enable_gqa)) and H % G == 0):
        return False
    return D <= _MAX_HEAD and S >= _MIN_SEQ and L >= _MIN_SEQ and _seq_ok(S, L)


def _mask_ok(mask, q, k, is_causal) -> bool:
    """torch: ``is_causal`` and a mask are mutually exclusive."""
    kind = _mask_kind(mask, q, k)
    return kind != "no" and (kind == "none" or not bool(pyval(is_causal)))


def _legacy_ok(mask, q, k) -> bool:
    """The legacy route's domain (``flashex.py:177-179``, ``:191-193``)."""
    S, L = q.shape[-2], k.shape[-2]
    return mask is None and S == L and S % _LEGACY_ALIGN == 0


def _route_ok(mask, q, k, is_causal) -> bool:
    if _impl_name() == "legacy":
        return _legacy_ok(mask, q, k)
    return _mask_ok(mask, q, k, is_causal)


def _sdpa_checker(*args, **kwargs) -> bool:
    b = _sdpa_bound(args, kwargs)
    q, k, v = b["query"], b["key"], b["value"]
    if float(pyval(b["dropout_p"])) != 0.0:
        return False
    return _shapes_ok(q, k, v, b["enable_gqa"]) and _route_ok(b["attn_mask"], q, k, b["is_causal"])


def _bwd_checker(g, query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False) -> bool:
    return (_shapes_ok(query, key, value, enable_gqa) and g.dtype == query.dtype
            and tuple(g.shape) == tuple(query.shape) and _route_ok(attn_mask, query, key, is_causal))


def _scale_of(q, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _sdpa_impl(*args, **kwargs):
    chaos.kernel_seam("flash", "sdpa")
    b = _sdpa_bound(args, kwargs)
    q, k, v, mask = b["query"], b["key"], b["value"], b["attn_mask"]
    scale, causal = _scale_of(q, b["scale"]), bool(b["is_causal"])
    if _impl_name() == "legacy":
        return legacy_flash_fwd(q, k, v, causal=causal, scale=scale)
    if mask is None:
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    plan = mask_plan(mask, q, k, causal, b["verdict"])
    if not plan.flash:
        return sdpa_exact(q, k, v, mask, causal=causal, scale=scale)
    return flash_attention_fwd_seg(q, k, v, plan.q_seg, plan.kv_seg, causal=plan.causal, scale=scale)


def _sdpa_bwd_impl(g, query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False, verdict=None):
    """The recompute-path backward (``flashex.py:474-496`` of the JAX
    package): the forward again with logsumexp under the same plan, then the
    backward kernel; dk/dv come summed over each kv group."""
    chaos.kernel_seam("flash", "sdpa_bwd")
    scale, causal = _scale_of(query, scale), bool(is_causal)
    if _impl_name() == "legacy":
        return legacy_flash_bwd(g, query, key, value, causal=causal, scale=scale)
    plan = mask_plan(attn_mask, query, key, causal, verdict)
    if not plan.flash:
        return sdpa_exact_bwd(g, query, key, value, attn_mask, causal=causal, scale=scale)
    return flash_attention_bwd_recompute(g, query, key, value, causal=plan.causal, scale=scale, q_seg=plan.q_seg,
                                         kv_seg=plan.kv_seg)


def _sdpa_reads_host(*args, **kwargs) -> bool:
    """A masked claim reads its mask's verdict on the host (``mask_plan``),
    unless it was given one (:func:`with_verdicts`)."""
    b = _sdpa_bound(args, kwargs)
    return b["attn_mask"] is not None and b["verdict"] is None


def _bwd_reads_host(g, query, key, value, attn_mask=None, *args, verdict=None, **kwargs) -> bool:
    return attn_mask is not None and verdict is None


ex.register_implementation("torch.scaled_dot_product_attention", fn=_sdpa_impl, checker=_sdpa_checker,
                           reads_host=_sdpa_reads_host)
ex.register_implementation("torch.sdpa_bwd", fn=_sdpa_bwd_impl, checker=_bwd_checker, reads_host=_bwd_reads_host)


# =============================================================================
# Residual-saving pair (transforms/attention_residuals.py; reference:
# cudnnex.py:375 — the bwd graph consumes the fwd's saved softmax stats)
# =============================================================================


def residual_eligible(q, k, v, *, enable_gqa=False) -> bool:
    """The attention-residual pass asks before rewriting: the forward
    checker's conditions plus S == L (no mask, D ≤ 256), as the JAX package
    asks (``thunder_tpu/executors/flashex.py:505-514``). The legacy route has
    no residual pair (``:509``)."""
    if _impl_name() != "splash" or not _sdpa_checker(q, k, v, None, 0.0, True, None, enable_gqa):
        return False
    return q.shape[-2] == k.shape[-2]


def _fwd_res_checker(query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False) -> bool:
    return attn_mask is None and residual_eligible(query, key, value, enable_gqa=enable_gqa)


def _bwd_res_checker(g, query, key, value, out, lse, attn_mask=None, is_causal=False, scale=None,
                     enable_gqa=False) -> bool:
    return (
        attn_mask is None
        and residual_eligible(query, key, value, enable_gqa=enable_gqa)
        and g.dtype == out.dtype == query.dtype
        and dtypes.to_dtype(lse.dtype) == dtypes.float32
    )


def _sdpa_fwd_res_impl(query, key, value, attn_mask=None, is_causal=False, scale=None, enable_gqa=False):
    chaos.kernel_seam("flash", "sdpa")
    return flash_attention_fwd_lse(query, key, value, causal=bool(is_causal), scale=_scale_of(query, scale))


def _sdpa_bwd_res_impl(g, query, key, value, out, lse, attn_mask=None, is_causal=False, scale=None,
                       enable_gqa=False):
    chaos.kernel_seam("flash", "sdpa_bwd")
    return flash_attention_bwd(g, query, key, value, out, lse, causal=bool(is_causal),
                               scale=_scale_of(query, scale))


ex.register_implementation("torch.sdpa_fwd_res", fn=_sdpa_fwd_res_impl, checker=_fwd_res_checker)
ex.register_implementation("torch.sdpa_bwd_res", fn=_sdpa_bwd_res_impl, checker=_bwd_res_checker)
