"""The torch operator executor: prims lowered to torch operators.

Reference parity: thunder/executors/torchex.py (`ex:40` — the default
operator executor); it takes the seat that ``executors/jaxex.py`` holds in
the JAX package. The claimed trace runs eagerly, one torch call per line.

It covers the prims that the GPT forward and loss reach, the elementwise,
reduction and shape prims around them, and those that the nn.Module
frontend's models reach besides: indexed updates (``setitem``,
``index_put``), convolution and pooling, and their backwards. A prim
without a lowering here is not claimed, and the claiming pass raises "No
executor for primitive ..." for it (the random-number prims, for one). The
full OpInfo matrix is a later part of the port.

Numeric notes, as in the JAX package:
- ``prims.div`` is true division for floats and *floor* division for
  integers (clang routes int true-division through a float convert);
- bool/int sums, products and cumulative sums accumulate in int64, and
  int64 stays exact;
- a reduction over an empty dim list reduces nothing (torch would reduce
  every dim).
"""

from __future__ import annotations

import math
from numbers import Number

import torch
import torch.nn.functional as F

from thunder_tpu_torch.core import devices, dtypes
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.extend import OperatorExecutor, register_executor

ex = OperatorExecutor("torch")
register_executor(ex)


def _td(d: dtypes.dtype) -> torch.dtype:
    return dtypes.to_torch_dtype(d)


def _dev(device) -> torch.device:
    return devices.to_device(device).torch_device()


def _reg(prim_id: PrimIDs, fn) -> None:
    ex.register_implementation(prim_id, fn=fn)


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, int)


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    """A number as a 0-d tensor of ``like``'s dtype on the CPU: it takes the
    number in the tensor's type, as JAX's weak typing does, and torch passes
    a 0-d CPU tensor to a CUDA kernel as an argument, so it needs no copy to
    the device (which a CUDA graph could not hold)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=like.dtype)


def _on_numbers(fn):
    """Lift a torch function of tensors to Python-number operands: two
    numbers compute as 0-d tensors and come back as a number; one number
    beside a tensor becomes a 0-d CPU tensor of the tensor's dtype."""

    def lowered(*args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors:
            return fn(*(torch.as_tensor(a) for a in args)).item()
        return fn(*(_as_tensor(a, tensors[0]) for a in args))

    return lowered


# -- data movement ------------------------------------------------------------


def _convert_element_type(a, dtype):
    if isinstance(a, Number):
        return dtypes.dtype_to_numbertype(dtype)(a)
    return a.to(_td(dtype))


_reg(PrimIDs.CONVERT_ELEMENT_TYPE, _convert_element_type)
_reg(PrimIDs.DEVICE_PUT, lambda a, device: a.to(_dev(device)))
_reg(PrimIDs.ITEM, lambda a: a.item())
_reg(PrimIDs.SHALLOW_COPY, lambda a: a)
_reg(PrimIDs.STOP_GRADIENT, lambda a: a.detach())


def _copy_(src, dst):
    if not isinstance(src, torch.Tensor):
        return torch.full(dst.shape, src, dtype=dst.dtype, device=dst.device)
    return src.to(dst.dtype).expand(dst.shape).clone()


_reg(PrimIDs.COPY_, _copy_)


# -- creation -----------------------------------------------------------------

_reg(PrimIDs.FULL, lambda shape, v, *, device, dtype: torch.full(tuple(shape), v, dtype=_td(dtype), device=_dev(device)))


def _iota(length, *, start, step, device, dtype):
    idx = torch.arange(int(length), device=_dev(device), dtype=torch.int64)
    return (idx * step + start).to(_td(dtype))


_reg(PrimIDs.IOTA, _iota)


def _tensor_from_sequence(seq, *, device, dtype):
    """The sequence's values on the host; on a card each is filled in by a
    kernel, with no copy from host memory (which a CUDA graph could not
    hold)."""
    host = torch.tensor(seq, dtype=_td(dtype) if dtype else None)
    dev = _dev(device)
    if dev.type == "cpu":
        return host
    out = torch.empty(host.shape, dtype=host.dtype, device=dev)
    for i, v in enumerate(host.reshape(-1).tolist()):
        out.view(-1)[i].fill_(v)
    return out


_reg(PrimIDs.TENSOR_FROM_SEQUENCE, _tensor_from_sequence)


# -- shape --------------------------------------------------------------------


def _broadcast_in_dim(a, shape, bdims):
    shape = tuple(int(s) for s in shape)
    view = [1] * len(shape)
    for src, dst in enumerate(bdims):
        view[dst] = a.shape[src]
    return a.reshape(view).expand(shape)


def _pad(a, padding_value, padding_config):
    if any(int(d) for _, _, d in padding_config):
        # Interior padding: spread the elements d apart, then pad the edges.
        shape = [n + (n - 1) * int(d) if n else 0 for n, (_, _, d) in zip(a.shape, padding_config)]
        out = torch.full(shape, padding_value, dtype=a.dtype, device=a.device)
        out[tuple(slice(None, None, int(d) + 1) for _, _, d in padding_config)] = a
        a = out
    pads = []
    for lo, hi, _ in reversed(padding_config):
        pads += [int(lo), int(hi)]
    return F.pad(a, pads, value=padding_value)


def _slice(a, starts, ends, strides=None):
    strides = strides or [1] * len(starts)
    return a[tuple(slice(int(s), int(e), int(st)) for s, e, st in zip(starts, ends, strides))]


def _take(a, idx, dim):
    out = a.index_select(dim, idx.reshape(-1).long())
    return out.squeeze(dim) if idx.ndim == 0 else out


_reg(PrimIDs.BROADCAST_IN_DIM, _broadcast_in_dim)
_reg(PrimIDs.CAT, lambda tensors, dim: torch.cat(list(tensors), dim))
_reg(PrimIDs.FLIP, lambda a, dims: torch.flip(a, tuple(dims)))
_reg(PrimIDs.PAD, _pad)
_reg(PrimIDs.RESHAPE, lambda a, shape: a.reshape(tuple(int(s) for s in shape)))
_reg(PrimIDs.SLICE, _slice)
_reg(PrimIDs.SQUEEZE, lambda a, dims: a.squeeze(tuple(dims)) if dims else a)
_reg(PrimIDs.TRANSPOSE, lambda a, perm: a.permute(tuple(perm)))
_reg(PrimIDs.TAKE, _take)
_reg(PrimIDs.TAKE_ALONG_AXIS, lambda a, idx, dim: torch.take_along_dim(a, idx.long(), dim))
_reg(PrimIDs.GATHER, lambda a, idx, dim: torch.take_along_dim(a, idx.long(), dim))


# Accumulating scatters must give the same bits on every run, as
# ``.at[idx].add`` does in the JAX package. On CUDA, ``index_add_`` and
# ``scatter_add`` add with atomics in no fixed order, while ``index_put``
# with ``accumulate=True`` sorts the indices stably and adds each run of
# equal indices in order, one writer per row (the kernel that
# ``torch.use_deterministic_algorithms`` routes the other two to), with no
# host sync and no data-dependent shape, so a CUDA-graph capture takes it.
# On the CPU it is the other way round: ``index_put`` adds large f32 inputs
# from parallel threads with atomics, ``index_add_`` and ``scatter_add`` in
# order.
def _scatter_add_sorted(a, idx, val, dim):
    """``a.scatter_add(dim, idx, val)`` as ``index_put``: ``idx`` along
    ``dim`` and each other dim's own position (the JAX package's
    ``_scatter_add``); ``val`` is read over ``idx``'s extent, as torch reads
    it."""
    idx = idx.long()
    index = tuple(
        idx if d == dim else torch.arange(n, device=idx.device).view([-1 if e == d else 1 for e in range(idx.ndim)])
        for d, n in enumerate(idx.shape))
    val = val[tuple(slice(0, n) for n in idx.shape)]
    return a.index_put(index, val, accumulate=True)


def _scatter_add(a, idx, val, dim):
    if a.is_cuda:
        return _scatter_add_sorted(a, idx, val, dim)
    return a.scatter_add(dim, idx.long(), val)


_reg(PrimIDs.SCATTER_ADD, _scatter_add)


def _setitem(a, key, value):
    # Out of place; the value is cast to the target dtype, as torch's
    # setitem does (7.5 into an int32 tensor stores 7).
    out = a.clone()
    out[key] = value.to(a.dtype) if isinstance(value, torch.Tensor) else value
    return out


_reg(PrimIDs.SETITEM, _setitem)
# With ``accumulate``, on CUDA this is the sorted, in-order sum of
# ``_scatter_add_sorted``.
_reg(PrimIDs.INDEX_PUT, lambda a, indices, values, accumulate: a.index_put(tuple(indices), values, accumulate))
_reg(PrimIDs.ARGSORT, lambda a, dim, descending: torch.argsort(a, dim=dim, descending=descending, stable=True))
_reg(PrimIDs.SORT, lambda a, dim, descending: tuple(torch.sort(a, dim=dim, descending=descending, stable=True)))


def _widen_exact(a) -> dict:
    return {"dtype": torch.int64} if _is_int(a) else {}


_reg(PrimIDs.CUMSUM, lambda a, dim: torch.cumsum(a, dim, **_widen_exact(a)))
_reg(PrimIDs.CUMPROD, lambda a, dim: torch.cumprod(a, dim, **_widen_exact(a)))
_reg(PrimIDs.TOPK, lambda a, k, dim, largest, sorted: tuple(torch.topk(a, k, dim, largest=largest, sorted=sorted)))


# -- elementwise unary --------------------------------------------------------

_unary_table = {
    PrimIDs.ABS: torch.abs,
    PrimIDs.ACOS: torch.acos,
    PrimIDs.ACOSH: torch.acosh,
    PrimIDs.ASIN: torch.asin,
    PrimIDs.ASINH: torch.asinh,
    PrimIDs.ATAN: torch.atan,
    PrimIDs.ATANH: torch.atanh,
    PrimIDs.BITWISE_NOT: torch.bitwise_not,
    PrimIDs.CEIL: torch.ceil,
    PrimIDs.COS: torch.cos,
    PrimIDs.COSH: torch.cosh,
    PrimIDs.DIGAMMA: torch.digamma,
    PrimIDs.ERF: torch.erf,
    PrimIDs.ERFC: torch.erfc,
    PrimIDs.ERFINV: torch.erfinv,
    PrimIDs.EXP: torch.exp,
    PrimIDs.EXP2: torch.exp2,
    PrimIDs.EXPM1: torch.expm1,
    PrimIDs.FLOOR: torch.floor,
    PrimIDs.ISFINITE: torch.isfinite,
    PrimIDs.ISINF: torch.isinf,
    PrimIDs.ISNAN: torch.isnan,
    PrimIDs.LGAMMA: torch.lgamma,
    PrimIDs.LOG: torch.log,
    PrimIDs.LOG10: torch.log10,
    PrimIDs.LOG1P: torch.log1p,
    PrimIDs.LOG2: torch.log2,
    PrimIDs.NEG: torch.neg,
    PrimIDs.RECIPROCAL: torch.reciprocal,
    PrimIDs.ROUND: torch.round,
    PrimIDs.RSQRT: torch.rsqrt,
    PrimIDs.SIGN: torch.sign,
    PrimIDs.SIGNBIT: torch.signbit,
    PrimIDs.SIN: torch.sin,
    PrimIDs.SINH: torch.sinh,
    PrimIDs.SQRT: torch.sqrt,
    PrimIDs.TAN: torch.tan,
    PrimIDs.TANH: torch.tanh,
    PrimIDs.TRUNC: torch.trunc,
    PrimIDs.REAL: torch.real,
    PrimIDs.IMAG: torch.imag,
}
for _pid, _fn in _unary_table.items():
    _reg(_pid, _on_numbers(_fn))


# -- elementwise binary -------------------------------------------------------


def _div(a, b):
    if _is_int(a) and _is_int(b):
        return torch.div(a, b, rounding_mode="floor")
    return torch.true_divide(a, b)


_binary_table = {
    PrimIDs.ADD: torch.add,
    PrimIDs.ATAN2: torch.atan2,
    PrimIDs.BITWISE_AND: torch.bitwise_and,
    PrimIDs.BITWISE_OR: torch.bitwise_or,
    PrimIDs.BITWISE_XOR: torch.bitwise_xor,
    PrimIDs.BITWISE_LEFT_SHIFT: torch.bitwise_left_shift,
    PrimIDs.BITWISE_RIGHT_SHIFT: torch.bitwise_right_shift,
    PrimIDs.DIV: _div,
    PrimIDs.EQ: torch.eq,
    PrimIDs.FMOD: torch.fmod,
    PrimIDs.GE: torch.ge,
    PrimIDs.GT: torch.gt,
    PrimIDs.LE: torch.le,
    PrimIDs.LT: torch.lt,
    PrimIDs.MAXIMUM: torch.maximum,
    PrimIDs.MINIMUM: torch.minimum,
    PrimIDs.MUL: torch.mul,
    PrimIDs.NE: torch.ne,
    PrimIDs.NEXTAFTER: torch.nextafter,
    PrimIDs.POW: torch.pow,
    PrimIDs.REMAINDER: torch.remainder,
    PrimIDs.SUB: torch.sub,
    PrimIDs.COPYSIGN: torch.copysign,
    PrimIDs.ZETA: torch.special.zeta,
}
for _pid, _fn in _binary_table.items():
    _reg(_pid, _on_numbers(_fn))

_reg(PrimIDs.POLYGAMMA, lambda n, a: torch.polygamma(int(n), a))
_reg(PrimIDs.WHERE, lambda pred, a, b: torch.where(pred, a, b))


# -- reductions ---------------------------------------------------------------


def _reduction(fn):
    def lowered(a, dims):
        dims = tuple(dims)
        if not dims:
            return a.to(torch.int64) if fn in (torch.sum, _prod) and _is_int(a) else a
        return fn(a, dims)

    return lowered


def _prod(a, dims):
    # torch.prod reduces one dim at a time; innermost first keeps dims valid.
    for d in sorted((d % a.ndim for d in dims), reverse=True):
        a = torch.prod(a, d, **_widen_exact(a))
    return a


_reg(PrimIDs.AMAX, _reduction(torch.amax))
_reg(PrimIDs.AMIN, _reduction(torch.amin))
_reg(PrimIDs.SUM, _reduction(torch.sum))
_reg(PrimIDs.PROD, _reduction(_prod))
_reg(PrimIDs.VAR, lambda a, dims, *, correction: torch.var(a, tuple(dims), correction=correction))
_reg(PrimIDs.VAR_MEAN, lambda a, dims, *, correction: tuple(torch.var_mean(a, tuple(dims), correction=correction)))
_reg(PrimIDs.ARGMAX, lambda a, dim: torch.argmax(a, dim))
_reg(PrimIDs.ARGMIN, lambda a, dim: torch.argmin(a, dim))


# -- linear algebra / NN ------------------------------------------------------
#
# Plain matrix products go to torch.matmul, as the JAX package left them to
# XLA. float32 products run in full float32 on the card unless the caller
# enables TF32 (torch.backends.cuda.matmul.allow_tf32, default False).

_reg(PrimIDs.MATMUL, torch.matmul)
_reg(PrimIDs.LINEAR, lambda a, w, bias: F.linear(a, w, bias))
_reg(PrimIDs.EMBEDDING, lambda idx, w: F.embedding(idx, w))


def _embedding_backward(grad, idx, num_weights, embed_dim):
    """The rows of ``grad`` summed by index, in the order they come (see
    ``_scatter_add_sorted``): the same bits on every run."""
    out = torch.zeros((num_weights, embed_dim), dtype=grad.dtype, device=grad.device)
    idx, rows = idx.reshape(-1).long(), grad.reshape(-1, embed_dim)
    if grad.is_cuda:
        return out.index_put_((idx,), rows, accumulate=True)
    return out.index_add_(0, idx, rows)


_reg(PrimIDs.EMBEDDING_BACKWARD, _embedding_backward)


def _conv_args(a, stride, padding, dilation) -> tuple:
    """Per-spatial-dim stride, padding and dilation (a short list repeats
    its last entry, as the JAX package's lowering reads it)."""
    n = a.ndim - 2

    def per_dim(v):
        return [int(v[i] if i < len(v) else v[-1]) for i in range(n)]

    return per_dim(stride), per_dim(padding), per_dim(dilation), [0] * n


def _convolution(a, weight, bias, stride, padding, dilation, groups):
    stride, padding, dilation, out_pad = _conv_args(a, stride, padding, dilation)
    return torch.convolution(a, weight, bias, stride, padding, dilation, False, out_pad, groups)


def _convolution_bwd(g, a, weight, stride, padding, dilation, groups):
    stride, padding, dilation, out_pad = _conv_args(a, stride, padding, dilation)
    dx, dw, _ = torch.ops.aten.convolution_backward(g, a, weight, None, stride, padding, dilation, False, out_pad,
                                                    groups, [True, True, False])
    return dx, dw


_reg(PrimIDs.CONVOLUTION, _convolution)
_reg(PrimIDs.CONVOLUTION_BWD, _convolution_bwd)


def _pool(a, kind, window, strides, padding):
    """Max or average over windows of the trailing len(window) dims, with
    (lo, hi) padding per dim: -inf for max, zeros for average, which divides
    by the full window (count_include_pad, torch's default)."""
    k = len(window)
    lead, spatial = a.shape[: a.ndim - k], a.shape[a.ndim - k:]
    pad = [int(p) for lo_hi in reversed(padding) for p in lo_hi]
    if kind == "max":
        fill, pool = -math.inf, (F.max_pool1d, F.max_pool2d, F.max_pool3d)[k - 1]
    else:
        fill, pool = 0.0, (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[k - 1]
    out = pool(F.pad(a.reshape(-1, *spatial), pad, value=fill), tuple(window), tuple(strides))
    return out.reshape(*lead, *out.shape[1:])


def _pool_bwd(g, a, kind, window, strides, padding):
    """The pool's adjoint, by autograd over ``_pool``: torch's own routing
    of a max window's grad to the element its forward picked."""
    with torch.enable_grad():
        x = a.detach().requires_grad_()
        return torch.autograd.grad(_pool(x, kind, window, strides, padding), x, g)[0]


_reg(PrimIDs.POOL, _pool)
_reg(PrimIDs.POOL_BWD, _pool_bwd)

