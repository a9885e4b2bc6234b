"""Fused RMSNorm and LayerNorm, forward and backward: the opt-in ``"norm"`` executor.

The counterpart of the ``"norm"`` executor of
``thunder_tpu/executors/pallasex.py``, whose RMSNorm (``_rms_fwd_kernel``,
``_rms_bwd_kernel``) and LayerNorm (``_ln_fwd_kernel``, ``_ln_bwd_kernel``)
are Pallas TPU kernels. Here they are the hand-written CUDA kernels of
``csrc/norm.cu``. As in the JAX package the executor is registered but is
not one of ``api.DEFAULT_EXECUTORS``: a program asks for it by name
(``executors=["norm", ...]``).

Claims ``torch.rms_norm``, ``torch.rms_norm_bwd``, ``torch.layer_norm`` and
``torch.layer_norm_bwd`` (the composites and VJP rules of
``torch/__init__.py``) when the norm is over the last dim only (a 1-D
``normalized_shape``), the weight is given with shape (D,), the bias (if
any) has shape (D,), and input, weight and bias share one of bf16, f16 and
f32. The shared type is this port's condition: the decomposition promotes a
mixed weight, the kernel would not, so a mixed one stays decomposed. The JAX
checkers' ``D % 128`` and ``rows % 8`` are dropped: they are the TPU's lane
and sublane tiling, and the CUDA kernels mask any D and any row count.

Each kernel computes what the Pallas kernel computes, not the ltorch
decomposition: everything in f32, the weight (and bias) applied in f32 and
the result rounded once (the decomposition rounds the normed value to the
input's type before the weight multiply, one ulp of difference); a two-pass
variance; RMSNorm's eps 1e-6 when none is given; the backward recomputes
rstd from x, since nothing is saved; dw and db are f32 sums of per-block
partials, cast once to the weight's type; db is None without a bias.

Each wrapper launches its kernel on CUDA tensors, or raises; on CPU tensors
it runs the plain PyTorch version beside it. The backward wrappers return dw
and db in f32; the claimed implementations cast them. Under vmap
(``executors/batching.py``) the wrappers also take a weight (and bias) a
segment of the rows, (S, D): the rows are S equal runs, one a slice, each
normed with its own row of the weight.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import pyval
from thunder_tpu_torch.executors import _build
from thunder_tpu_torch.extend import OperatorExecutor, register_executor

ex = OperatorExecutor("norm")
register_executor(ex)

RMS_EPS = 1e-6  # RMSNorm's eps when none is given (pallasex._rms_impl)

# The backward's launch plan; the constants are those of csrc/norm.cu.
_WARPS = 8  # warps a block, one block an SM
_MAX_DEPTH = 3  # ring slots a row group
_LANE_COLS = 32  # columns a lane keeps its dw/db sums of in registers
_MAX_SMEM = 232448  # shared memory a block may ask for on sm_90


@dataclass(frozen=True)
class BwdPlan:
    """How ``norm_bwd_kernel`` walks the rows (csrc/norm.cu):

    - ``mode``: "ring" (rows copied into shared memory by the Tensor Memory
      Accelerator, ``depth`` slots a row group), "direct" (read from device
      memory in 4-byte units) or "scalar" (one element at a time);
    - ``warps_per_row``: the warps of a row group, ``groups`` of them a block;
    - ``ctas``: blocks, one an SM at most;
    - ``registers``: whether a lane keeps its column sums in registers (else
      in the block's partial row in device memory, one group a block);
    - ``smem``: dynamic shared memory a block, bytes.
    """

    mode: str
    warps_per_row: int
    groups: int
    depth: int
    ctas: int
    registers: bool
    smem: int


def bwd_plan(N: int, D: int, elem_size: int, layer_norm: bool, sm_count: int, align: int,
             segments: int = 1) -> BwdPlan:
    """The backward's plan for N rows of D elements of ``elem_size`` bytes on
    a card of ``sm_count`` SMs, where ``align`` (16, 4 or 1) divides every
    row's byte offset and base pointer. A row group is the fewest warps
    (1, 2, 4, 8) whose lanes hold at most 32 columns each; the ring takes
    as many slots (up to 3) as fit beside the fold buffers, and a row too
    wide for one slot is read directly. With sums in registers, each group
    has D f32 of fold buffer (2·D for LayerNorm) beside its ring. The rows
    of ``segments`` equal segments (vmap's slices) are walked by equal sets
    of blocks, a set a segment: ``ctas`` is a multiple of ``segments``."""
    unit = 1 if align < 4 else max(1, 4 // elem_size)
    nunits = D // unit
    kmax = _LANE_COLS // unit
    wpr = next((w for w in (1, 2, 4) if math.ceil(nunits / (32 * w)) <= kmax), _WARPS)
    registers = math.ceil(nunits / (32 * wpr)) <= kmax
    groups = _WARPS // wpr
    fold = -(-groups * D * 4 * (2 if layer_norm else 1) // 16) * 16 if registers else 0
    slot = 2 * D * elem_size
    depth = min(_MAX_DEPTH, (_MAX_SMEM - fold) // (groups * slot)) if align >= 16 else 0
    mode = "ring" if depth > 0 else "direct" if align >= 4 else "scalar"
    ctas = segments * max(1, min(sm_count // segments, math.ceil(N // segments / groups)))
    return BwdPlan(mode, wpr, groups, depth, ctas, registers, fold + groups * depth * slot)


_MODES = {"ring": 0, "direct": 1, "scalar": 2}


@dataclass(frozen=True)
class FwdPlan:
    """How the forward walks the rows (csrc/norm.cu):

    - ``mode``: "rows" (``norm_fwd_kernel``: a row in the registers of a
      group of ``warps_per_row`` warps, ``groups`` of them a block, on a
      persistent grid of ``ctas`` blocks), "block" (``norm_fwd_kernel_block``:
      a block a row, the row cached in shared memory as f32) or "stream"
      (a block a row, read from device memory twice);
    - ``unit``: elements of each load and store (16 bytes, 4 bytes or one).
    """

    mode: str
    unit: int
    warps_per_row: int
    groups: int
    ctas: int


def fwd_unit(elem_size: int, align: int) -> int:
    """Elements of the register route's loads: 16 bytes, 4 bytes or one."""
    return 16 // elem_size if align >= 16 else max(1, 4 // elem_size) if align >= 4 else 1


def fwd_plan(N: int, D: int, elem_size: int, sm_count: int, align: int, blocks_per_sm: int) -> FwdPlan:
    """The forward's plan for N rows of D elements of ``elem_size`` bytes on
    a card of ``sm_count`` SMs, ``align`` (16, 4 or 1) as in ``bwd_plan``,
    where an SM holds ``blocks_per_sm`` blocks of the register route's
    kernel at once (its register count decides; csrc/norm.cu reports it). A
    row group is the fewest warps (1, 2, 4, 8) whose lanes hold at most 32
    columns each, in units of ``fwd_unit``; the grid is one wave, every
    block resident at once, so each group walks its rows with the next one
    in flight. A row wider than 8 warps' registers takes a block, "stream"
    when its f32 copy would not fit in shared memory."""
    unit = fwd_unit(elem_size, align)
    nunits = D // unit
    wpr = next((w for w in (1, 2, 4, 8) if math.ceil(nunits / (32 * w)) <= _LANE_COLS // unit), None)
    if wpr is None:
        mode = "stream" if D * 4 > _MAX_SMEM else "block"
        return FwdPlan(mode, 16 // elem_size if align >= 16 else 1, _WARPS, 1, N)
    groups = _WARPS // wpr
    return FwdPlan("rows", unit, wpr, groups, max(1, min(math.ceil(N / groups), sm_count * blocks_per_sm)))


@functools.lru_cache(maxsize=None)
def fwd_blocks_per_sm(layer_norm: bool, dtype_code: int, unit: int) -> int:
    """Blocks of the register route's kernel that an SM holds at once."""
    n = _build.lib().thunder_norm_fwd_blocks_per_sm(int(layer_norm), dtype_code, unit)
    if n < 1:
        raise RuntimeError(f"norm forward: no block of the register route fits an SM (CUDA error {-n})")
    return n


_FWD_MODES = {"rows": 0, "block": 1, "stream": 2}


# =============================================================================
# Plain versions
# =============================================================================


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).float()


def _param_rows(p: torch.Tensor, N: int) -> torch.Tensor:
    """A weight or bias in f32 against N rows: (D,) as it is, (S, D) one row
    a row of x, segment s of the rows taking row s."""
    pf = p.float()
    return pf if pf.ndim == 1 else pf.repeat_interleave(N // pf.shape[0], 0)


def _stats(xf: torch.Tensor, eps: float, layer_norm: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(mu, rstd) per row in f32; mu is 0 for RMSNorm. The variance takes
    two passes: the mean, then the mean of the centred squares."""
    if not layer_norm:
        return torch.zeros_like(xf[:, :1]), torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    return mu, torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)


def norm_fwd_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float, *,
                   layer_norm: bool) -> torch.Tensor:
    """(x − mu)·rstd·w (+ b) in f32, rounded once to x's dtype; w and b (D,)
    or a row a segment of the rows, (S, D)."""
    xf = _rows(x)
    mu, rstd = _stats(xf, eps, layer_norm)
    y = (xf - mu) * rstd * _param_rows(weight, xf.shape[0])
    if bias is not None:
        y = y + _param_rows(bias, xf.shape[0])
    return y.to(x.dtype).reshape(x.shape)


def norm_bwd_plain(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, eps: float, *, layer_norm: bool,
                   with_bias: bool = False, segments: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx in x's dtype, dw in f32, db in f32 or None) with mu and rstd
    recomputed from x: dx = rstd·(wg − m1 − xhat·m2), m2 = mean(wg·xhat),
    m1 = mean(wg) for LayerNorm and 0 for RMSNorm; dw = Σ g·xhat and
    db = Σ g over the rows, (D,), or with ``segments`` > 1 over each of
    that many equal runs of rows, (segments, D). The kernel sums dw and db
    by blocks of rows; the two differ only in summation order. The weight
    may be a row a segment, (segments, D)."""
    xf, gf = _rows(x), _rows(g)
    mu, rstd = _stats(xf, eps, layer_norm)
    xhat = (xf - mu) * rstd
    wg = gf * _param_rows(weight, xf.shape[0])
    m2 = (wg * xhat).mean(-1, keepdim=True)
    m1 = wg.mean(-1, keepdim=True) if layer_norm else 0.0
    dx = (rstd * (wg - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)

    def colsum(t):
        return t.sum(0) if segments == 1 else t.reshape(segments, -1, t.shape[-1]).sum(1)

    db = colsum(gf) if layer_norm and with_bias else None
    return dx, colsum(gf * xhat), db


# =============================================================================
# The kernels' wrappers
# =============================================================================


def _check_cuda(kernel: str, x: torch.Tensor, g: Optional[torch.Tensor], *params: Optional[torch.Tensor]) -> None:
    """x and g (..., D), weight and bias (D,) or both (S, D) with S dividing
    the rows: one CUDA device, one type."""
    params = tuple(p for p in params if p is not None)
    ts = (x,) + (() if g is None else (g,)) + params
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError(f"{kernel}: every tensor must be on one CUDA device, got {[str(t.device) for t in ts]}")
    if str(x.dtype).removeprefix("torch.") not in _build.DTYPE_CODES or any(t.dtype != x.dtype for t in ts):
        raise ValueError(f"{kernel}: every tensor must share one of bf16/f16/f32, got {[t.dtype for t in ts]}")
    D = x.shape[-1] if x.ndim else 0
    N = x.numel() // D if D else 0
    shape = params[0].shape if params else (D,)
    if (D < 1 or (g is not None and g.shape != x.shape) or any(p.shape != shape for p in params)
            or shape[-1] != D or len(shape) > 2 or (len(shape) == 2 and (shape[0] < 1 or N % shape[0]))):
        raise ValueError(f"{kernel}: unsupported shapes {[tuple(t.shape) for t in ts]} (D >= 1, the weight and "
                         "bias (D,) or (S, D) with S dividing the rows)")


def _align(D: int, *ts: Optional[torch.Tensor]) -> int:
    """The largest of 16, 4 and 1 bytes that divides every row's offset
    (D elements, rows contiguous) and every base pointer."""
    return next(a for a in (16, 4, 1) if all(
        t is None or (D * t.element_size() % a == 0 and t.data_ptr() % a == 0) for t in ts))


def fwd_plan_of(x2: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], y: torch.Tensor,
                layer_norm: bool) -> FwdPlan:
    """The forward's plan for rows x2 (N, D), weight, bias and output y on
    their CUDA device."""
    D = x2.shape[-1]
    align = _align(D, x2, w, b, y)
    with torch.cuda.device(x2.device):
        per_sm = fwd_blocks_per_sm(layer_norm, _build.dtype_code(x2), fwd_unit(x2.element_size(), align))
    return fwd_plan(x2.shape[0], D, x2.element_size(), _build.sm_count(x2.device.index), align, per_sm)


def _launch_fwd(kernel: str, x, weight, bias, eps: float, layer_norm: bool) -> torch.Tensor:
    _check_cuda(kernel, x, None, weight, bias)
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    w, b = weight.contiguous(), None if bias is None else bias.contiguous()
    y = torch.empty_like(x2)
    plan = fwd_plan_of(x2, w, b, y, layer_norm)
    seg_rows = x2.shape[0] // w.shape[0] if w.ndim == 2 else 0
    lib = _build.lib()
    with torch.cuda.device(x.device):
        status = lib.thunder_norm_fwd(
            x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(), x2.shape[0], D,
            seg_rows, float(eps), int(layer_norm), _build.dtype_code(x), _FWD_MODES[plan.mode], plan.unit,
            plan.warps_per_row, plan.ctas, _build.stream_of(x),
        )
    _build.check(status, kernel)
    return y.reshape(x.shape)


def _launch_bwd(kernel: str, g, x, weight, eps: float, layer_norm: bool, with_bias: bool, segments: int = 1):
    """dx, and dw and db in f32 ((D,), or (segments, D)), from two launches:
    the row kernel, which writes each block's partial column sums, and the
    kernel that sums them, a segment's blocks into its own row."""
    _check_cuda(kernel, x, g, weight)
    D = x.shape[-1]
    x2, g2, w = x.reshape(-1, D).contiguous(), g.reshape(-1, D).contiguous(), weight.contiguous()
    N = x2.shape[0]
    if segments < 1 or N % segments or (w.ndim == 2 and w.shape[0] != segments):
        raise ValueError(f"{kernel}: {N} rows do not split into {segments} equal segments, a weight row each "
                         f"(weight {tuple(w.shape)})")
    dx = torch.empty_like(x2)
    plan = bwd_plan(N, D, x.element_size(), layer_norm, _build.sm_count(x.device.index), _align(D, g2, x2, w, dx),
                    segments)
    f32 = dict(dtype=torch.float32, device=x.device)
    sums = (D,) if segments == 1 else (segments, D)
    dw, dw_part = torch.empty(sums, **f32), torch.empty((plan.ctas, D), **f32)
    db, db_part = (torch.empty(sums, **f32), torch.empty((plan.ctas, D), **f32)) if with_bias else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.lib()
    with torch.cuda.device(x.device):
        status = lib.thunder_norm_bwd(
            g2.data_ptr(), x2.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(), ptr(db), dw_part.data_ptr(),
            ptr(db_part), N, D, segments, int(w.ndim == 2), plan.ctas, plan.warps_per_row, plan.depth,
            _MODES[plan.mode], float(eps),
            int(layer_norm), _build.dtype_code(x), _build.stream_of(x),
        )
    _build.check(status, kernel)
    return dx.reshape(x.shape), dw, db


@_build.counted
def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """RMSNorm of x (..., D) over its last dim, times weight (D,) or (S, D)
    (a row a segment of the rows)."""
    _build.refuse_transformed("rms_fwd", x, weight)
    if x.device.type == "cpu":
        return norm_fwd_plain(x, weight, None, eps, layer_norm=False)
    y = _launch_fwd("rms_fwd", x, weight, None, eps, False)
    rms_norm_fwd.launches += 1
    return y


@_build.counted
def rms_norm_bwd(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                 eps: float = RMS_EPS, segments: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw in f32) of RMSNorm from its cotangent g; dw (D,), or with
    ``segments`` > 1 one row a segment of the rows, (segments, D). The
    weight is (D,), or (segments, D), a row a segment."""
    _build.refuse_transformed("rms_bwd", g, x, weight)
    if x.device.type == "cpu":
        return norm_bwd_plain(g, x, weight, eps, layer_norm=False, segments=segments)[:2]
    dx, dw, _ = _launch_bwd("rms_bwd", g, x, weight, eps, False, False, segments)
    rms_norm_bwd.launches += 1
    return dx, dw


@_build.counted
def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of x (..., D) over its last dim, times weight (D,), plus
    bias (D,) when given; both may be (S, D), a row a segment of the rows."""
    _build.refuse_transformed("ln_fwd", x, weight, bias)
    if x.device.type == "cpu":
        return norm_fwd_plain(x, weight, bias, eps, layer_norm=True)
    y = _launch_fwd("ln_fwd", x, weight, bias, eps, True)
    layer_norm_fwd.launches += 1
    return y


@_build.counted
def layer_norm_bwd(g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
                   with_bias: bool, segments: int = 1) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dw in f32, db in f32 or None) of LayerNorm from its cotangent g;
    dw and db per segment of the rows as ``rms_norm_bwd``'s."""
    _build.refuse_transformed("ln_bwd", g, x, weight)
    if x.device.type == "cpu":
        return norm_bwd_plain(g, x, weight, eps, layer_norm=True, with_bias=with_bias, segments=segments)
    out = _launch_bwd("ln_bwd", g, x, weight, eps, True, with_bias, segments)
    layer_norm_bwd.launches += 1
    return out


# =============================================================================
# Claiming
# =============================================================================


def _shapes_ok(a, weight, bias=None) -> bool:
    shape = getattr(a, "shape", ())
    if len(shape) < 1 or weight is None:
        return False
    D = shape[-1]
    dt = dtypes.to_dtype(a.dtype)
    if dt not in (dtypes.bfloat16, dtypes.float16, dtypes.float32):
        return False
    return all(t is None or (tuple(t.shape) == (D,) and dtypes.to_dtype(t.dtype) == dt) for t in (weight, bias))


def _rms_fwd_checker(a, normalized_shape, weight=None, eps=None) -> bool:
    return len(tuple(normalized_shape)) == 1 and _shapes_ok(a, weight)


def _rms_bwd_checker(g, a, weight, eps) -> bool:
    return _shapes_ok(a, weight) and _shapes_ok(g, weight)


def _ln_fwd_checker(a, normalized_shape, weight=None, bias=None, eps=1e-5) -> bool:
    return len(tuple(normalized_shape)) == 1 and _shapes_ok(a, weight, bias)


def _ln_bwd_checker(g, a, weight, bias, eps) -> bool:
    return _shapes_ok(a, weight, bias) and _shapes_ok(g, weight)


def _rms_impl(a, normalized_shape, weight=None, eps=None):
    return rms_norm_fwd(a, weight, RMS_EPS if eps is None else float(pyval(eps)))


def _rms_bwd_impl(g, a, weight, eps):
    dx, dw = rms_norm_bwd(g, a, weight, float(pyval(eps)))
    return dx, dw.to(weight.dtype)


def _ln_impl(a, normalized_shape, weight=None, bias=None, eps=1e-5):
    return layer_norm_fwd(a, weight, bias, float(pyval(eps)))


def _ln_bwd_impl(g, a, weight, bias, eps):
    dx, dw, db = layer_norm_bwd(g, a, weight, float(pyval(eps)), with_bias=bias is not None)
    return dx, dw.to(weight.dtype), None if db is None else db.to(weight.dtype)


ex.register_implementation("torch.rms_norm", fn=_rms_impl, checker=_rms_fwd_checker)
ex.register_implementation("torch.rms_norm_bwd", fn=_rms_bwd_impl, checker=_rms_bwd_checker)
ex.register_implementation("torch.layer_norm", fn=_ln_impl, checker=_ln_fwd_checker)
ex.register_implementation("torch.layer_norm_bwd", fn=_ln_bwd_impl, checker=_ln_bwd_checker)
