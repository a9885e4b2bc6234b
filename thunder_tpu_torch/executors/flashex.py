"""Flash-attention executor: hand-written CUDA kernels claiming SDPA whole.

The counterpart of ``thunder_tpu/executors/flashex.py``, whose forward runs
JAX's splash-attention Pallas kernel (``_sdpa_impl`` → ``_sdpa_runtime`` →
``_splash_sdpa``) and whose residual pair (``_sdpa_fwd_res_impl``,
``_sdpa_bwd_res_impl``) runs its forward with logsumexp and its backward.
Here the forward is ``csrc/flash_attn.cu`` (online-softmax flash attention
with tensor-core WMMA, no (B, H, S, S) scores in device memory; it also
writes the per-row logsumexp when asked) and the backward is
``csrc/flash_bwd.cu`` (dq, dk, dv from the saved output and logsumexp).

Claims:
- ``torch.scaled_dot_product_attention`` with no mask (causal or full), no
  dropout, half precision (bf16/f16, like the JAX package's checker and the
  reference's fused-SDPA executors: float32 stays decomposed), 4-D inputs
  with S and L ≥ 64 and D ≤ 256, and GQA where H is a multiple of G;
- ``torch.sdpa_fwd_res`` / ``torch.sdpa_bwd_res``, the pair that the
  attention-residual pass (``transforms/attention_residuals.py``) swaps in
  for (sdpa, sdpa_bwd) when ``residual_eligible`` holds: the checks above
  plus S == L.
Masked and padded cases and the recompute-path backward (``sdpa_bwd``) are
later parts of the port (ROADMAP.md).

Each wrapper launches its kernel on CUDA tensors, or raises; on CPU tensors it
runs its plain version, the same arithmetic in plain PyTorch. Strides: q, k
and v arrive as views of the fused qkv projection, and the backward's dout
may be strided too; the kernels read them through their strides and copy
nothing (only a tensor whose last dim is strided would be copied).
"""

from __future__ import annotations

import math

import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import pyval
from thunder_tpu_torch.executors import _build
from thunder_tpu_torch.extend import OperatorExecutor, register_executor

ex = OperatorExecutor("flash")
register_executor(ex)

_MIN_SEQ = 64  # below this the decomposition is as cheap as a kernel launch
_MAX_HEAD = 256
_MAX_BH = 65535  # the grid's y extent


# =============================================================================
# The kernel and its plain version
# =============================================================================


def _expand_heads(q: torch.Tensor, *kv: torch.Tensor) -> list[torch.Tensor]:
    """k/v (B, G, T, D) repeated to q's H heads (kv head h // (H / G))."""
    H, G = q.shape[1], kv[0].shape[1]
    return [t.repeat_interleave(H // G, dim=1) if G != H else t for t in kv]


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, scale: float) -> torch.Tensor:
    """scale·q·kᵀ in f32 with the causal mask aligned bottom-right (−inf)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        Tq, Tkv = q.shape[-2], k.shape[-2]
        i = torch.arange(Tq, device=q.device)[:, None]
        j = torch.arange(Tkv, device=q.device)[None, :]
        s = s.masked_fill(j > i + (Tkv - Tq), -math.inf)
    return s


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_plain`` and the per-row logsumexp (B, H, Tq) in f32
    of the scaled, masked scores (natural log; −inf where a query sees no
    key)."""
    k, v = _expand_heads(q, k, v)
    s = _scores(q, k, causal=causal, scale=scale)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float())
    o = torch.where(l > 0, o / l.clamp_min(torch.finfo(torch.float32).tiny), torch.zeros_like(o))
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                          scale: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 scores scaled in f32,
    causal mask aligned bottom-right, f32 softmax statistics, P rounded to the
    input type before P·V, and a zero row where a query sees no key."""
    return flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)[0]


def flash_attention_bwd_plain(dout, q, k, v, out, lse, *, causal: bool, scale: float):
    """The backward kernel's arithmetic in plain PyTorch, from the saved
    output and logsumexp: Di = rowsum(dout∘out), P = exp(scale·qkᵀ − lse)
    (masked, 0 where lse is −inf), dV = Pᵀ·dout, dP = dout·vᵀ,
    dS = P∘(dP − Di), dQ = scale·dS·k, dK = scale·dSᵀ·q, all in f32, with P
    and dS rounded to the input type before the products that take them, as
    the kernel's tensor-core products do. dk/dv are summed over the query
    heads of each kv group. Returns (dq, dk, dv) in the input dtype."""
    B, H, Tq, D = q.shape
    G, Tkv = k.shape[1], k.shape[2]
    ke, ve = _expand_heads(q, k, v)
    s = _scores(q, ke, causal=causal, scale=scale)
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


def _check_cuda_inputs(q, k, v, kernel: str) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{kernel}: q, k, v must be on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.bfloat16, torch.float16) or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"{kernel}: q, k, v must all be bf16 or all f16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{kernel}: q, k, v must be (B, H, T, D)")
    B, H, _, D = q.shape
    if k.shape[0] != B or v.shape != k.shape or k.shape[-1] != D or D > _MAX_HEAD or H % k.shape[1]:
        raise ValueError(f"{kernel}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if B * H > _MAX_BH:
        raise ValueError(f"{kernel}: B*H = {B * H} exceeds the grid's y limit")


def _vec4_ok(D: int, *ts: torch.Tensor) -> bool:
    """8-byte loads need D, the b/h/t strides and the base pointers to be
    multiples of 4 elements (8 bytes)."""
    return D % 4 == 0 and all(t.data_ptr() % 8 == 0 and all(s % 4 == 0 for s in t.stride()[:3]) for t in ts)


def _launch_fwd(q, k, v, causal: bool, scale: float, lse) -> torch.Tensor:
    _check_cuda_inputs(q, k, v, "flash_fwd")
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
            B, H, G, Tq, Tkv, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale),
            int(bool(causal)), _build.dtype_code(q), int(_vec4_ok(D, q, k, v)), _build.stream_of(q),
        )
    _build.check(status, "flash_fwd")
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        scale: float) -> torch.Tensor:
    """Causal or full attention of q (B, H, Tq, D) over k/v (B, G, Tkv, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    out = _launch_fwd(q, k, v, causal, scale, None)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` that also returns the per-row logsumexp
    (B, H, Tq) in f32: the same kernel, told where to write it."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal, scale=scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, causal, scale, lse)
    flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0


def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, *, causal: bool,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention from the saved output and logsumexp; dk and
    dv (B, G, Tkv, D) are summed over the query heads of each kv group."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale)
    _check_cuda_inputs(q, k, v, "flash_bwd")
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
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(), B, H, G, Tq, Tkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
            float(scale), int(bool(causal)), _build.dtype_code(q), int(_vec4_ok(D, q, k, v, out, dout)),
            _build.stream_of(q),
        )
    _build.check(status, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# =============================================================================
# Claiming
# =============================================================================


def _sdpa_bound(args, kwargs) -> dict:
    names = ("query", "key", "value", "attn_mask", "dropout_p", "is_causal", "scale", "enable_gqa")
    defaults = {"attn_mask": None, "dropout_p": 0.0, "is_causal": False, "scale": None, "enable_gqa": False}
    b = dict(defaults)
    b.update(zip(names, args))
    b.update(kwargs)
    return b


def _half(t) -> bool:
    return dtypes.to_dtype(t.dtype) in (dtypes.bfloat16, dtypes.float16)


def _sdpa_checker(*args, **kwargs) -> bool:
    b = _sdpa_bound(args, kwargs)
    q, k, v = b["query"], b["key"], b["value"]
    if b["attn_mask"] is not None or float(pyval(b["dropout_p"])) != 0.0:
        return False
    if not (len(q.shape) == len(k.shape) == len(v.shape) == 4):
        return False
    if not (_half(q) and q.dtype == k.dtype == v.dtype):
        return False
    B, H, S, D = q.shape
    G, L = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[-1] != D:
        return False
    if G != H and not (bool(pyval(b["enable_gqa"])) and H % G == 0):
        return False
    return D <= _MAX_HEAD and S >= _MIN_SEQ and L >= _MIN_SEQ and B * H <= _MAX_BH


def _scale_of(q, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _sdpa_impl(*args, **kwargs):
    b = _sdpa_bound(args, kwargs)
    q = b["query"]
    return flash_attention_fwd(q, b["key"], b["value"], causal=bool(b["is_causal"]), scale=_scale_of(q, b["scale"]))


ex.register_implementation("torch.scaled_dot_product_attention", fn=_sdpa_impl, checker=_sdpa_checker)


# =============================================================================
# Residual-saving pair (transforms/attention_residuals.py; reference:
# cudnnex.py:375 — the bwd graph consumes the fwd's saved softmax stats)
# =============================================================================


def residual_eligible(q, k, v, *, enable_gqa=False) -> bool:
    """The attention-residual pass asks before rewriting: the forward
    checker's conditions plus S == L (no mask, D ≤ 256), as the JAX package
    asks (``thunder_tpu/executors/flashex.py:505-514``)."""
    if not _sdpa_checker(q, k, v, None, 0.0, True, None, enable_gqa):
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
    return flash_attention_fwd_lse(query, key, value, causal=bool(is_causal), scale=_scale_of(query, scale))


def _sdpa_bwd_res_impl(g, query, key, value, out, lse, attn_mask=None, is_causal=False, scale=None,
                       enable_gqa=False):
    return flash_attention_bwd(g, query, key, value, out, lse, causal=bool(is_causal),
                               scale=_scale_of(query, scale))


ex.register_implementation("torch.sdpa_fwd_res", fn=_sdpa_fwd_res_impl, checker=_fwd_res_checker)
ex.register_implementation("torch.sdpa_bwd_res", fn=_sdpa_bwd_res_impl, checker=_bwd_res_checker)
