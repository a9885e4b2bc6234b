"""The int8 linear: an opt-in executor whose products run in int8.

The counterpart of ``thunder_tpu/executors/quantex.py``: activations get
one per-tensor scale and weights a scale per output channel (row), both
from the current call's amax (no delayed history), and the backward stays
in the original dtype (straight-through: autodiff decomposes ``linear``
before claiming, so the grad trace's products fall to the torch executor).
On the card the quantization is the kernel ``csrc/quantize.cu``, in the seat
of the XLA fusions of the reference's ``_quantize_per_tensor`` and
``_quantize_per_channel`` (``quantex.py:101-119``): one pass over the
operand in its own type, with the bits of the plain versions here, which
follow the reference's order of operations (``torch.round`` rounds half to
even, as ``jnp.round`` does). The int8 × int8 → int32 product with its
rescale and bias is the kernel ``csrc/int8_gemm.cu`` (``wgmma``, TMA), in the
seat of the reference's ``lax.dot_general`` (``quantex.py:134-142``).

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
from thunder_tpu_torch.resilience import chaos

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
# Quantization: the plain versions (torch ops, the reference's order of
# operations) and the wrappers of csrc/quantize.cu
# =============================================================================


def _div(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """x / qmax rounded once, on any device: CUDA divides a tensor by a
    Python number as a product with its reciprocal, rounded twice."""
    return x / torch.full_like(x, qmax)


def quantize_per_tensor(x: torch.Tensor, qmax: float, segments: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``quantize_tensor``: (q int8, scale 0-d f32),
    scale = max(amax, 1e-6) / qmax, all in f32; with ``segments`` > 1 the
    elements are that many equal runs, each with its own scale, (segments,)."""
    x = x.float()
    if segments > 1:
        runs = x.reshape(segments, -1)
        scale = _div(torch.clamp_min(runs.abs().amax(1), 1e-6), qmax)
        q = torch.clamp(torch.round(runs / scale[:, None]), -127, 127).to(torch.int8)
        return q.reshape(x.shape), scale
    scale = _div(torch.clamp_min(x.abs().amax(), 1e-6), qmax)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def quantize_per_channel(w: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``quantize_rows``: (q int8, scale (out, 1) f32)
    of an (out, in) weight, all in f32."""
    w = w.float()
    scale = _div(torch.clamp_min(w.abs().amax(dim=1, keepdim=True), 1e-6), qmax)
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def _quantize_operand(x: torch.Tensor, name: str) -> tuple[torch.Tensor, int, bool]:
    """(x as a 2-D matrix with its last dim innermost, its row stride in
    elements, whether the kernels may read it as 16-byte vectors)."""
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{name}: expected an f32, bf16 or f16 tensor, got {x.dtype}")
    x2 = x.reshape(-1, x.shape[-1]) if x.ndim != 2 else x
    if x2.stride(-1) != 1 or (x2.shape[0] > 1 and x2.stride(0) < x2.shape[1]):
        x2 = x2.contiguous()
    ld = x2.stride(0) if x2.shape[0] > 1 else x2.shape[1]
    per = 16 // x2.element_size()
    return x2, ld, x2.shape[1] % per == 0 and ld % per == 0 and x2.data_ptr() % 16 == 0


def _quantize_rows_launch(w: torch.Tensor, qmax: float, fault_reciprocal: bool = False):
    w2, ld, vec = _quantize_operand(w, "quantize_rows")
    N, K = w2.shape
    q = torch.empty((N, K), dtype=torch.int8, device=w.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=w.device)
    status = _build.lib().thunder_quantize_rows(
        ctypes.c_void_p(w2.data_ptr()), ld, N, K, qmax, _build.dtype_code(w2), int(vec), int(fault_reciprocal),
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(scale.data_ptr()), _build.stream_of(w2))
    _build.check(status, "quantize_rows")
    return q, scale


@_build.counted
def quantize_rows(w: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8 of w's shape, scale (rows, 1) f32) of a (rows, K) weight, a
    scale a row: ``csrc/quantize.cu`` on a CUDA tensor (one pass, in w's own
    type), the plain version on a CPU tensor."""
    _build.refuse_transformed("quantize_rows", w)
    if w.device.type == "cpu":
        return quantize_per_channel(w, qmax)
    if not w.is_cuda or w.ndim != 2 or w.numel() == 0:
        raise ValueError(f"quantize_rows: expected a non-empty 2-D CUDA tensor, got {tuple(w.shape)} on {w.device}")
    out = _quantize_rows_launch(w, qmax)
    quantize_rows.launches += 1
    return out


def _quantize_tensor_launch(x: torch.Tensor, qmax: float, fault_reciprocal: bool = False, segments: int = 1):
    x2, ld, vec = _quantize_operand(x, "quantize_tensor")
    rows, cols = x2.shape
    if ld == cols:  # contiguous: one flat row
        rows, cols = 1, rows * cols
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(() if segments == 1 else (segments,), dtype=torch.float32, device=x.device)
    amax = torch.empty((segments,), dtype=torch.int32, device=x.device)
    per = 16 // x2.element_size() if vec else 1
    per_seg = -(-rows * cols // (segments * per * 256))
    blocks = max(1, min(per_seg, 8 * _build.sm_count(x.device.index or 0) // segments))
    status = _build.lib().thunder_quantize_tensor(
        ctypes.c_void_p(x2.data_ptr()), ld, rows, cols, qmax, _build.dtype_code(x2), int(vec), int(fault_reciprocal),
        ctypes.c_void_p(amax.data_ptr()), ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(scale.data_ptr()), blocks,
        segments, _build.stream_of(x2))
    _build.check(status, "quantize_tensor")
    return q, scale


@_build.counted
def quantize_tensor(x: torch.Tensor, qmax: float, segments: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8 of x's shape, scale 0-d f32), one scale for the whole tensor:
    ``csrc/quantize.cu`` on a CUDA tensor (a grid amax, then one pass, in
    x's own type), the plain version on a CPU tensor. With ``segments`` > 1
    (vmap's slices, ``executors/batching.py``) x's rows are that many equal
    runs, each quantized with its own scale: scale (segments,)."""
    _build.refuse_transformed("quantize_tensor", x)
    rows = x.numel() // x.shape[-1] if x.ndim and x.shape[-1] else 0
    if segments < 1 or (x.ndim and rows % segments):
        raise ValueError(f"quantize_tensor: the {rows} rows of {tuple(x.shape)} do not split into {segments} "
                         "equal segments")
    if x.device.type == "cpu":
        return quantize_per_tensor(x, qmax, segments)
    if not x.is_cuda or x.ndim == 0 or x.numel() == 0:
        raise ValueError(f"quantize_tensor: expected a non-empty CUDA tensor of at least one dim, got "
                         f"{tuple(x.shape)} on {x.device}")
    out = _quantize_tensor_launch(x, qmax, segments=segments)
    quantize_tensor.launches += 1
    return out


# =============================================================================
# The product's wrappers: csrc/int8_gemm.cu (wgmma/TMA) and, for operands TMA
# cannot describe, csrc/int8_gemm_sync.cu (mma.sync)
# =============================================================================


def _per_problem(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A scale or bias against the (..., M, N) product: (N,) as it is, a row
    a problem (P, N) as (P, 1, N)."""
    return t if t is None or t.ndim == 1 else t[:, None, :]


def int8_gemm_plain(qa: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                    dtype: torch.dtype) -> torch.Tensor:
    """The int32 product exactly, in f64 (every partial sum is far below
    2**53), then float(sum) * scale (+ bias), each rounded in f32; operands
    as ``int8_gemm`` takes them."""
    acc = (qa.double() @ qw.double().transpose(-1, -2)).float()
    out = acc * _per_problem(scale)
    if bias is not None:
        out = out + _per_problem(bias).float()
    return out.to(dtype)


def _gemm_operands(qa, qw, scale, bias, dtype):
    """Check the operands of a CUDA call; return them contiguous, the bias
    in f32, and the problem count P (1 when every operand is 2-D/1-D)."""
    M, K = qa.shape[-2:]
    N = qw.shape[-2]
    ts = (qa, qw, scale) + (() if bias is None else (bias,))
    P = max([1] + [t.shape[0] for t, r in ((qa, 3), (qw, 3), (scale, 2), (bias, 2)) if t is not None and t.ndim == r])
    if not all(t.is_cuda and t.device == qa.device for t in ts):
        raise ValueError(f"int8_gemm: every tensor must be on one CUDA device, got {[str(t.device) for t in ts]}")
    if (qa.dtype != torch.int8 or qw.dtype != torch.int8 or tuple(qw.shape[-1:]) != (K,)
            or tuple(qa.shape) not in ((M, K), (P, M, K)) or tuple(qw.shape) not in ((N, K), (P, N, K))):
        raise ValueError(f"int8_gemm: expected int8 qa (M, K) or (P, M, K) and qw (N, K) or (P, N, K), got "
                         f"{qa.dtype} {tuple(qa.shape)} and {qw.dtype} {tuple(qw.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) not in ((N,), (P, N)):
        raise ValueError(f"int8_gemm: expected an f32 scale of shape ({N},) or ({P}, {N}), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) not in ((N,), (P, N)):
        raise ValueError(f"int8_gemm: expected a bias of shape ({N},) or ({P}, {N}), got {tuple(bias.shape)}")
    if str(dtype).removeprefix("torch.") not in _build.DTYPE_CODES:
        raise ValueError(f"int8_gemm: no output type {dtype}")
    bias = None if bias is None else bias.float().contiguous()
    return qa.contiguous(), qw.contiguous(), scale.contiguous(), bias, P


def _gemm_args(qa, qw, scale, bias, dtype, P):
    """A fresh (M, N) output, or (P, M, N) for P problems or any batched
    operand, and the C entry points' leading arguments."""
    M, K = qa.shape[-2:]
    N = qw.shape[-2]
    batched = any(t is not None and t.ndim == r for t, r in ((qa, 3), (qw, 3), (scale, 2), (bias, 2)))
    out = torch.empty((P, M, N) if batched else (M, N), dtype=dtype, device=qa.device)
    return out, (ctypes.c_void_p(qa.data_ptr()), ctypes.c_void_p(qw.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
                 ctypes.c_void_p(None if bias is None else bias.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                 M, N, K, _build.DTYPE_CODES[str(dtype).removeprefix("torch.")])


def _problem_args(qa, qw, scale, bias, P) -> tuple:
    """The C entry points' problem arguments: P, whether qa and qw are
    shared, and the scale's and bias's steps a problem (0: shared)."""
    N = qw.shape[-2]
    return (P, int(qa.ndim == 2), int(qw.ndim == 2), N if scale.ndim == 2 else 0,
            N if bias is not None and bias.ndim == 2 else 0)


def tma_describes(qa: torch.Tensor, qw: torch.Tensor) -> bool:
    """Whether TMA can read both contiguous int8 operands: 16-byte-aligned
    bases and rows (K % 16 == 0). Decided from shapes and pointers alone."""
    return qa.shape[-1] % 16 == 0 and _build.ptr_align(qa, qw) == 16


@_build.counted
def int8_gemm_sync(qa: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                   dtype: torch.dtype) -> torch.Tensor:
    """``int8_gemm`` on the ``mma.sync`` kernel (``csrc/int8_gemm_sync.cu``),
    which reads any operand: the route for what TMA cannot describe."""
    _build.refuse_transformed("int8_gemm_sync", qa, qw, scale, bias)
    qa, qw, scale, bias, P = _gemm_operands(qa, qw, scale, bias, dtype)
    out, args = _gemm_args(qa, qw, scale, bias, dtype, P)
    status = _build.lib().thunder_int8_gemm_sync(*args, int(tma_describes(qa, qw)),
                                                 *_problem_args(qa, qw, scale, bias, P), _build.stream_of(qa))
    _build.check(status, "int8_gemm_sync")
    int8_gemm_sync.launches += 1
    return out


@_build.counted
def int8_gemm(qa: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: torch.dtype) -> torch.Tensor:
    """out (M, N) of ``dtype`` = float(qa (M, K) · qw (N, K)ᵀ) · scale (N,)
    (+ bias (N,), added in f32): the plain version on CPU tensors; on CUDA
    tensors ``csrc/int8_gemm.cu`` (``wgmma``, TMA) where ``tma_describes``
    the operands, else ``int8_gemm_sync``. Each route counts its own launches.

    P problems in one launch (vmap's batching rule,
    ``executors/batching.py``): qa (P, M, K), qw (P, N, K), scale and bias
    (P, N), each operand given once (2-D, 1-D) where the problems share it;
    out is then (P, M, N), problem p's rows rescaled with scale row p."""
    _build.refuse_transformed("int8_gemm", qa, qw, scale, bias)
    if qa.device.type == "cpu":
        return int8_gemm_plain(qa, qw, scale, bias, dtype)
    qa, qw, scale, bias, P = _gemm_operands(qa, qw, scale, bias, dtype)
    if not tma_describes(qa, qw):
        return int8_gemm_sync(qa, qw, scale, bias, dtype)
    out, args = _gemm_args(qa, qw, scale, bias, dtype, P)
    status = _build.lib().thunder_int8_gemm(*args, *_problem_args(qa, qw, scale, bias, P), _build.stream_of(qa))
    _build.check(status, "int8_gemm")
    int8_gemm.launches += 1
    return out


# =============================================================================
# Claiming
# =============================================================================


def quant_linear(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 tensor=None, rows=None, gemm=None) -> torch.Tensor:
    """``linear(a, w, bias)`` with a and w quantized to int8 in their own
    types (thunder_tpu/executors/quantex.py:123 ``_quant_linear_impl``).
    ``tensor``, ``rows`` and ``gemm`` are the batching rules under vmap
    (``executors/batching.py``); by default the wrappers in this module's
    seats, looked up at each call."""
    chaos.kernel_seam("quant", "linear")
    tensor, rows, gemm = tensor or quantize_tensor, rows or quantize_rows, gemm or int8_gemm
    r = _recipe
    qa, sa = tensor(a.reshape(-1, a.shape[-1]), r.qmax)
    if r.per_channel_weights:
        qw, sw = rows(w, r.qmax)
        sw = sw[:, 0]
    else:
        qw, sw = tensor(w, r.qmax)
        sw = sw.expand(w.shape[0])
    out = gemm(qa, qw, sa * sw, bias, a.dtype)
    return out.reshape(*a.shape[:-1], w.shape[0])


ex.register_implementation("torch.linear", fn=quant_linear, checker=_linear_checker)
# Autodiff flattens composites to prims, so the forward of a grad trace
# carries prims.linear: claim that too (the backward's products stay).
ex.register_implementation(PrimIDs.LINEAR, fn=quant_linear, checker=_linear_checker)
