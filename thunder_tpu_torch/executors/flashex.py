"""Flash-attention executor: a hand-written CUDA kernel claiming SDPA whole.

The counterpart of ``thunder_tpu/executors/flashex.py``, whose forward runs
JAX's splash-attention Pallas kernel (``_sdpa_impl`` → ``_sdpa_runtime`` →
``_splash_sdpa``). Here the forward is ``csrc/flash_attn.cu``: online-softmax
flash attention with tensor-core WMMA, no (B, H, S, S) scores in device
memory.

Claims ``torch.scaled_dot_product_attention`` with no mask (causal or full),
no dropout, half precision (bf16/f16, like the JAX package's checker and the
reference's fused-SDPA executors: float32 stays decomposed), 4-D inputs with
S and L ≥ 64 and D ≤ 256, and GQA where H is a multiple of G. Masked, padded
and backward cases are later parts of the port (ROADMAP.md).

``flash_attention_fwd`` launches the kernel on CUDA tensors, or raises; on
CPU tensors it runs ``flash_attention_plain``, the same arithmetic in plain
PyTorch. Strides: q, k and v arrive as views of the fused qkv projection;
the kernel reads them through their strides and copies nothing (only a
tensor whose last dim is strided would be copied).
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                          scale: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 scores scaled in f32,
    causal mask aligned bottom-right, f32 softmax statistics, P rounded to the
    input type before P·V, and a zero row where a query sees no key."""
    H, G = q.shape[1], k.shape[1]
    if G != H:
        k = k.repeat_interleave(H // G, dim=1)
        v = v.repeat_interleave(H // G, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    Tq, Tkv = q.shape[-2], k.shape[-2]
    if causal:
        i = torch.arange(Tq, device=q.device)[:, None]
        j = torch.arange(Tkv, device=q.device)[None, :]
        s = s.masked_fill(j > i + (Tkv - Tq), -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float())
    o = torch.where(l > 0, o / l.clamp_min(torch.finfo(torch.float32).tiny), torch.zeros_like(o))
    return o.to(q.dtype)


def _check_cuda_inputs(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_fwd: q, k, v must be on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.bfloat16, torch.float16) or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"flash_fwd: q, k, v must all be bf16 or all f16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_fwd: q, k, v must be (B, H, T, D)")
    B, H, _, D = q.shape
    if k.shape[0] != B or v.shape != k.shape or k.shape[-1] != D or D > _MAX_HEAD or H % k.shape[1]:
        raise ValueError(f"flash_fwd: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if B * H > _MAX_BH:
        raise ValueError(f"flash_fwd: B*H = {B * H} exceeds the grid's y limit")


def _vec4_ok(D: int, *ts: torch.Tensor) -> bool:
    """8-byte loads need D, the b/h/t strides and the base pointers to be
    multiples of 4 elements (8 bytes)."""
    return D % 4 == 0 and all(t.data_ptr() % 8 == 0 and all(s % 4 == 0 for s in t.stride()[:3]) for t in ts)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        scale: float) -> torch.Tensor:
    """Causal or full attention of q (B, H, Tq, D) over k/v (B, G, Tkv, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda_inputs(q, k, v)
    # The kernel reads rows through the b/h/t strides; only a strided last
    # dim (never on the model's path) is copied.
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    B, H, Tq, D = q.shape
    G, Tkv = k.shape[1], k.shape[2]
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        status = lib.thunder_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, G, Tq, Tkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale), int(bool(causal)),
            _build.dtype_code(q), int(_vec4_ok(D, q, k, v)), _build.stream_of(q),
        )
    _build.check(status, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


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


def _sdpa_impl(*args, **kwargs):
    b = _sdpa_bound(args, kwargs)
    q = b["query"]
    scale = float(b["scale"]) if b["scale"] is not None else 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_fwd(q, b["key"], b["value"], causal=bool(b["is_causal"]), scale=scale)


ex.register_implementation("torch.scaled_dot_product_attention", fn=_sdpa_impl, checker=_sdpa_checker)
