"""The int8 linear: an opt-in executor whose products run in int8.

The counterpart of ``thunder_tpu/executors/quantex.py``: activations get
one per-tensor scale and weights a scale per output channel (row), both
from the current call's amax (no delayed history), and the backward stays
in the original dtype (straight-through: autodiff decomposes ``linear``
before claiming, so the grad trace's products fall to the torch executor).
The quantization is torch code on the device, in the reference's order of
operations, so ``q`` and the scales have its bits (``torch.round`` rounds
half to even, as ``jnp.round`` does); the int8 × int8 → int32 product with
its rescale and bias is the kernel ``csrc/int8_gemm.cu``, in the seat of the
reference's ``lax.dot_general`` (``quantex.py:134-142``).

Opt-in (it changes numerics)::

    thunder_tpu_torch.jit(fn, executors=["quant", "flash", "fused", "torch"])
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.executors import _build
from thunder_tpu_torch.extend import OperatorExecutor, register_executor

ex = OperatorExecutor("quant")
register_executor(ex)

_MIN_K = 64  # too-small contractions are not worth quantizing


@dataclass
class QuantRecipe:
    """``margin`` backs the scale off by 2**margin (headroom against amax
    growth), ``per_channel_weights`` picks a scale per weight row or one for
    the whole weight, ``skip_out_features`` keeps linears of those output
    widths in the original dtype (the lm_head, by its vocabulary width)."""

    margin: int = 0
    per_channel_weights: bool = True
    skip_out_features: tuple = ()

    @property
    def qmax(self) -> float:
        return 127.0 / (2.0 ** self.margin)


_recipe = QuantRecipe()


def set_recipe(recipe: QuantRecipe) -> None:
    """Install the recipe; it takes effect at the next trace (compiled
    entries keep the recipe they were traced with)."""
    global _recipe
    _recipe = recipe


def get_recipe() -> QuantRecipe:
    return _recipe


_QUANTIZABLE = (dtypes.float32, dtypes.bfloat16, dtypes.float16)


def _linear_checker(a, w, bias=None) -> bool:
    if not (hasattr(a, "shape") and hasattr(w, "shape")):
        return False
    if len(w.shape) != 2 or w.shape[1] < _MIN_K:
        return False
    if int(w.shape[0]) in _recipe.skip_out_features:
        return False
    return dtypes.to_dtype(a.dtype) in _QUANTIZABLE and dtypes.to_dtype(w.dtype) in _QUANTIZABLE


# =============================================================================
# Quantization (torch ops, the reference's order of operations)
# =============================================================================


def _div(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """x / qmax rounded once, on any device: CUDA divides a tensor by a
    Python number as a product with its reciprocal, rounded twice."""
    return x / torch.full_like(x, qmax)


def quantize_per_tensor(x: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-d f32): scale = max(amax, 1e-6) / qmax."""
    scale = _div(torch.clamp_min(x.abs().amax(), 1e-6), qmax)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def quantize_per_channel(w: torch.Tensor, qmax: float, per_channel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale (out, 1) f32) of an (out, in) weight."""
    if not per_channel:
        q, s = quantize_per_tensor(w, qmax)
        return q, s.expand(w.shape[0], 1)
    scale = _div(torch.clamp_min(w.abs().amax(dim=1, keepdim=True), 1e-6), qmax)
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


# =============================================================================
# The kernel's wrapper
# =============================================================================


def int8_gemm_plain(qa: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                    dtype: torch.dtype) -> torch.Tensor:
    """The int32 product exactly, in f64 (every partial sum is far below
    2**53), then float(sum) * scale (+ bias), each rounded in f32."""
    acc = (qa.double() @ qw.double().T).float()
    out = acc * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


@_build.counted
def int8_gemm(qa: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
    """out (M, N) of ``dtype`` = float(qa (M, K) · qw (N, K)ᵀ) · scale (N,)
    (+ bias (N,), added in f32): ``csrc/int8_gemm.cu`` on CUDA tensors, the
    plain version on CPU tensors."""
    if qa.device.type == "cpu":
        return int8_gemm_plain(qa, qw, scale, bias, dtype)
    M, K = qa.shape
    N = qw.shape[0]
    ts = (qa, qw, scale) + (() if bias is None else (bias,))
    if not all(t.is_cuda and t.device == qa.device for t in ts):
        raise ValueError(f"int8_gemm: every tensor must be on one CUDA device, got {[str(t.device) for t in ts]}")
    if qa.dtype != torch.int8 or qw.dtype != torch.int8 or tuple(qw.shape) != (N, K) or qa.ndim != 2:
        raise ValueError(f"int8_gemm: expected int8 qa (M, K) and qw (N, K), got {qa.dtype} {tuple(qa.shape)} "
                         f"and {qw.dtype} {tuple(qw.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,):
        raise ValueError(f"int8_gemm: expected an f32 scale of shape ({N},), got {scale.dtype} {tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"int8_gemm: expected a bias of shape ({N},), got {tuple(bias.shape)}")
    if str(dtype).removeprefix("torch.") not in _build.DTYPE_CODES:
        raise ValueError(f"int8_gemm: no output type {dtype}")
    qa, qw, scale = qa.contiguous(), qw.contiguous(), scale.contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out = torch.empty((M, N), dtype=dtype, device=qa.device)
    aligned = int(K % 16 == 0 and _build.ptr_align(qa, qw) == 16)
    status = _build.lib().thunder_int8_gemm(
        ctypes.c_void_p(qa.data_ptr()), ctypes.c_void_p(qw.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
        ctypes.c_void_p(None if bias is None else bias.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        M, N, K, _build.DTYPE_CODES[str(dtype).removeprefix("torch.")], aligned, _build.stream_of(qa))
    _build.check(status, "int8_gemm")
    int8_gemm.launches += 1
    return out


# =============================================================================
# Claiming
# =============================================================================


def quant_linear(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``linear(a, w, bias)`` with a and w quantized to int8 (thunder_tpu/
    executors/quantex.py:123 ``_quant_linear_impl``)."""
    r = _recipe
    qa, sa = quantize_per_tensor(a.float(), r.qmax)
    qw, sw = quantize_per_channel(w.float(), r.qmax, r.per_channel_weights)
    out = int8_gemm(qa.reshape(-1, a.shape[-1]), qw, sa * sw[:, 0], bias, a.dtype)
    return out.reshape(*a.shape[:-1], w.shape[0])


ex.register_implementation("torch.linear", fn=quant_linear, checker=_linear_checker)
# Autodiff flattens composites to prims, so the forward of a grad trace
# carries prims.linear: claim that too (the backward's products stay).
ex.register_implementation(PrimIDs.LINEAR, fn=quant_linear, checker=_linear_checker)
