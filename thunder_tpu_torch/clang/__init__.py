"""The core tensor language ("clang").

Reference parity: thunder/clang/__init__.py (113 `@clangop`s) — the
device-agnostic tensor language sitting between the torch-mirror layer and
prims. clang ops are plain Python functions (not symbols): they perform
broadcasting, Python-number/type promotion, dtype conversion, and index
canonicalization, then decompose into strict prims. Their calls inline into
the enclosing symbol's subsymbol scope.
"""

from __future__ import annotations

from functools import reduce
from numbers import Number
from typing import Any, Optional, Sequence

import thunder_tpu_torch.core.prims as prims
from thunder_tpu_torch.core import dtypes, devices, utils
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.langctxs import LanguageContext, Languages, register_langctx
from thunder_tpu_torch.core.proxies import NumberProxy, TensorProxy, pyval
from thunder_tpu_torch.core.utils import ELEMENTWISE_TYPE_PROMOTION_KIND as _K


_clang_ctx = LanguageContext(Languages.CLANG)
register_langctx(Languages.CLANG, _clang_ctx)

_method_names: dict[str, str] = {}


def clangop(method_name: Optional[str] = None):
    def decorator(fn):
        if method_name is not None:
            _clang_ctx.register_method(method_name, fn)
        return fn

    return decorator


# =============================================================================
# dtype and broadcasting helpers
# =============================================================================


def maybe_convert_to_dtype(a, dtype: dtypes.dtype):
    """Convert tensor/number to dtype if it differs (no-op otherwise)."""
    if isinstance(a, TensorProxy):
        if a.dtype != dtypes.to_strong(dtype):
            return prims.convert_element_type(a, dtypes.to_strong(dtype))
        return a
    # numbers
    typ = dtypes.dtype_to_numbertype(dtype)
    v = pyval(a)
    if v is not None and not isinstance(a, TensorProxy):
        return typ(v)
    return prims.convert_element_type(a, dtype)


@clangop()
def maybe_broadcast(*args):
    """Broadcast tensor args to their common shape (numbers pass through)."""
    shapes = [a.shape for a in args if isinstance(a, TensorProxy)]
    if not shapes:
        return args
    common = utils.compute_broadcast_shape(*shapes)

    def _maybe(a):
        if isinstance(a, TensorProxy) and tuple(a.shape) != common:
            return expand_to(a, common)
        return a

    return tuple(_maybe(a) for a in args)


def expand_to(a: TensorProxy, shape: Sequence[int]) -> TensorProxy:
    """Broadcast ``a`` to ``shape`` (right-aligned)."""
    shape = tuple(shape)
    if tuple(a.shape) == shape:
        return a
    offset = len(shape) - a.ndim
    check(offset >= 0, lambda: f"Cannot expand {a.shape} to smaller rank {shape}")
    bdims = tuple(range(offset, len(shape)))
    return prims.broadcast_in_dim(a, shape, bdims)


def _elementwise_binary_wrapper(a, b, *, prim, type_promotion_kind=_K.DEFAULT):
    computation_dtype, result_dtype = utils.elementwise_type_promotion(a, b, type_promotion_kind=type_promotion_kind)
    a, b = maybe_broadcast(a, b)
    if isinstance(a, TensorProxy) or isinstance(b, TensorProxy):
        # Embed numbers as same-dtype scalars via broadcast of a full()
        ta = a if isinstance(a, TensorProxy) else b
        if not isinstance(a, TensorProxy):
            a = full((), maybe_convert_to_dtype(a, computation_dtype), device=ta.device, dtype=computation_dtype)
            a = expand_to(a, ta.shape)
        if not isinstance(b, TensorProxy):
            b = full((), maybe_convert_to_dtype(b, computation_dtype), device=ta.device, dtype=computation_dtype)
            b = expand_to(b, ta.shape)
        a = maybe_convert_to_dtype(a, computation_dtype)
        b = maybe_convert_to_dtype(b, computation_dtype)
    result = prim(a, b)
    if isinstance(result, TensorProxy) and result.dtype != dtypes.to_strong(result_dtype):
        result = maybe_convert_to_dtype(result, result_dtype)
    return result


def _make_elementwise_binary(name: str, prim, *, tpk=_K.DEFAULT, method: Optional[str] = None):
    def op(a, b):
        return _elementwise_binary_wrapper(a, b, prim=prim, type_promotion_kind=tpk)

    op.__name__ = name
    if method:
        _clang_ctx.register_method(method, op)
    return op


def _make_elementwise_unary(name: str, prim, *, tpk=_K.DEFAULT, float_only: bool = False, method: Optional[str] = None):
    def op(a):
        computation_dtype, result_dtype = utils.elementwise_type_promotion(
            a, type_promotion_kind=_K.INT_TO_FLOAT if float_only else tpk
        )
        if isinstance(a, TensorProxy):
            a = maybe_convert_to_dtype(a, computation_dtype)
        result = prim(a)
        if isinstance(result, TensorProxy) and result.dtype != dtypes.to_strong(result_dtype):
            result = maybe_convert_to_dtype(result, result_dtype)
        return result

    op.__name__ = name
    if method:
        _clang_ctx.register_method(method, op)
    return op


# =============================================================================
# Elementwise ops
# =============================================================================

add = _make_elementwise_binary("add", prims.add, method="add")
atan2 = _make_elementwise_binary("atan2", prims.atan2, tpk=_K.INT_TO_FLOAT)
bitwise_and = _make_elementwise_binary("bitwise_and", prims.bitwise_and, method="bitwise_and")
bitwise_or = _make_elementwise_binary("bitwise_or", prims.bitwise_or, method="bitwise_or")
bitwise_xor = _make_elementwise_binary("bitwise_xor", prims.bitwise_xor, method="bitwise_xor")
eq = _make_elementwise_binary("eq", prims.eq, tpk=_K.ALWAYS_BOOL, method="eq")
fmod = _make_elementwise_binary("fmod", prims.fmod)
ge = _make_elementwise_binary("ge", prims.ge, tpk=_K.ALWAYS_BOOL, method="ge")
gt = _make_elementwise_binary("gt", prims.gt, tpk=_K.ALWAYS_BOOL, method="gt")
le = _make_elementwise_binary("le", prims.le, tpk=_K.ALWAYS_BOOL, method="le")
lt = _make_elementwise_binary("lt", prims.lt, tpk=_K.ALWAYS_BOOL, method="lt")
maximum = _make_elementwise_binary("maximum", prims.maximum)
minimum = _make_elementwise_binary("minimum", prims.minimum)
mul = _make_elementwise_binary("mul", prims.mul, method="mul")
ne = _make_elementwise_binary("ne", prims.ne, tpk=_K.ALWAYS_BOOL, method="ne")
nextafter = _make_elementwise_binary("nextafter", prims.nextafter, tpk=_K.INT_TO_FLOAT)
pow = _make_elementwise_binary("pow", prims.pow_prim, method="pow")
remainder = _make_elementwise_binary("remainder", prims.remainder, method="remainder")
sub = _make_elementwise_binary("sub", prims.sub, method="sub")
copysign = _make_elementwise_binary("copysign", prims.copysign, tpk=_K.INT_TO_FLOAT, method="copysign")
zeta = _make_elementwise_binary("zeta", prims.zeta, tpk=_K.INT_TO_FLOAT)
mod = remainder  # reference clang alias (clang/__init__.py `mod`)


@clangop()
def polygamma(n: int, a):
    check(isinstance(n, (int, NumberProxy)) and int(pyval(n)) >= 0, lambda: f"polygamma order must be a non-negative int, got {n}")
    computation_dtype, result_dtype = utils.elementwise_type_promotion(a, type_promotion_kind=_K.INT_TO_FLOAT)
    if isinstance(a, TensorProxy):
        a = maybe_convert_to_dtype(a, computation_dtype)
    return prims.polygamma(int(pyval(n)), a)


@clangop(method_name="logical_and")
def logical_and(a, b):
    return bitwise_and(ne(a, 0) if not _is_bool(a) else a, ne(b, 0) if not _is_bool(b) else b)


@clangop(method_name="logical_or")
def logical_or(a, b):
    return bitwise_or(ne(a, 0) if not _is_bool(a) else a, ne(b, 0) if not _is_bool(b) else b)


def _is_bool(x) -> bool:
    return isinstance(x, TensorProxy) and dtypes.is_boolean_dtype(x.dtype) or isinstance(x, bool)


@clangop(method_name="real")
def real(a):
    """Real part; identity on real-dtype tensors (no op emitted)."""
    if isinstance(a, TensorProxy) and not dtypes.is_complex_dtype(a.dtype):
        return a
    return prims.real(a)


@clangop()
def imag(a):
    return prims.imag(a)


@clangop(method_name="true_divide")
def true_divide(a, b):
    return _elementwise_binary_wrapper(a, b, prim=prims.div, type_promotion_kind=_K.INT_TO_FLOAT)


@clangop(method_name="floor_divide")
def floor_divide(a, b):
    r = _elementwise_binary_wrapper(a, b, prim=prims.div, type_promotion_kind=_K.DEFAULT)
    if isinstance(r, TensorProxy) and dtypes.is_float_dtype(r.dtype):
        return _make_elementwise_unary("floor", prims.floor)(r)
    return r


abs = _make_elementwise_unary("abs", prims.abs_prim, tpk=_K.COMPLEX_TO_FLOAT, method="abs")
acos = _make_elementwise_unary("acos", prims.acos, float_only=True, method="acos")
acosh = _make_elementwise_unary("acosh", prims.acosh, float_only=True)
asin = _make_elementwise_unary("asin", prims.asin, float_only=True, method="asin")
asinh = _make_elementwise_unary("asinh", prims.asinh, float_only=True)
atan = _make_elementwise_unary("atan", prims.atan, float_only=True, method="atan")
atanh = _make_elementwise_unary("atanh", prims.atanh, float_only=True)
bitwise_not = _make_elementwise_unary("bitwise_not", prims.bitwise_not, method="bitwise_not")
ceil = _make_elementwise_unary("ceil", prims.ceil, method="ceil")
cos = _make_elementwise_unary("cos", prims.cos, float_only=True, method="cos")
cosh = _make_elementwise_unary("cosh", prims.cosh, float_only=True)
digamma = _make_elementwise_unary("digamma", prims.digamma, float_only=True)
erf = _make_elementwise_unary("erf", prims.erf, float_only=True, method="erf")
erfc = _make_elementwise_unary("erfc", prims.erfc, float_only=True)
erfinv = _make_elementwise_unary("erfinv", prims.erfinv, float_only=True)
exp = _make_elementwise_unary("exp", prims.exp, float_only=True, method="exp")
exp2 = _make_elementwise_unary("exp2", prims.exp2, float_only=True)
expm1 = _make_elementwise_unary("expm1", prims.expm1, float_only=True)
floor = _make_elementwise_unary("floor", prims.floor, method="floor")
isfinite = _make_elementwise_unary("isfinite", prims.isfinite, tpk=_K.ALWAYS_BOOL)
isinf = _make_elementwise_unary("isinf", prims.isinf, tpk=_K.ALWAYS_BOOL)
isnan = _make_elementwise_unary("isnan", prims.isnan, tpk=_K.ALWAYS_BOOL)
lgamma = _make_elementwise_unary("lgamma", prims.lgamma, float_only=True)
log = _make_elementwise_unary("log", prims.log, float_only=True, method="log")
log10 = _make_elementwise_unary("log10", prims.log10, float_only=True)
log1p = _make_elementwise_unary("log1p", prims.log1p, float_only=True)
log2 = _make_elementwise_unary("log2", prims.log2, float_only=True)
neg = _make_elementwise_unary("neg", prims.neg, method="neg")
reciprocal = _make_elementwise_unary("reciprocal", prims.reciprocal, float_only=True, method="reciprocal")
round = _make_elementwise_unary("round", prims.round_prim, method="round")
rsqrt = _make_elementwise_unary("rsqrt", prims.rsqrt, float_only=True, method="rsqrt")
sign = _make_elementwise_unary("sign", prims.sign)
signbit = _make_elementwise_unary("signbit", prims.signbit, tpk=_K.ALWAYS_BOOL)
sin = _make_elementwise_unary("sin", prims.sin, float_only=True, method="sin")
sinh = _make_elementwise_unary("sinh", prims.sinh, float_only=True)
sqrt = _make_elementwise_unary("sqrt", prims.sqrt, float_only=True, method="sqrt")
tan = _make_elementwise_unary("tan", prims.tan, float_only=True)
tanh = _make_elementwise_unary("tanh", prims.tanh, float_only=True, method="tanh")
trunc = _make_elementwise_unary("trunc", prims.trunc)


@clangop(method_name="logical_not")
def logical_not(a):
    if isinstance(a, TensorProxy) and dtypes.is_boolean_dtype(a.dtype):
        return bitwise_not(a)
    return eq(a, 0)


@clangop()
def where(pred, a, b):
    computation_dtype, result_dtype = utils.elementwise_type_promotion(a, b, type_promotion_kind=_K.PRESERVE)
    pred, a, b = maybe_broadcast(pred, a, b)
    ref = next(x for x in (pred, a, b) if isinstance(x, TensorProxy))
    if not isinstance(pred, TensorProxy):
        pred = full((), bool(pyval(pred)), device=ref.device, dtype=dtypes.bool8)
        pred = expand_to(pred, ref.shape)
    if not isinstance(a, TensorProxy):
        a = expand_to(full((), maybe_convert_to_dtype(a, computation_dtype), device=ref.device, dtype=computation_dtype), ref.shape)
    if not isinstance(b, TensorProxy):
        b = expand_to(full((), maybe_convert_to_dtype(b, computation_dtype), device=ref.device, dtype=computation_dtype), ref.shape)
    a = maybe_convert_to_dtype(a, computation_dtype)
    b = maybe_convert_to_dtype(b, computation_dtype)
    return prims.where(pred, a, b)


@clangop(method_name="clamp")
def clamp(a, min=None, max=None):
    r = a
    if min is not None:
        r = maximum(r, min)
    if max is not None:
        r = minimum(r, max)
    return r


# =============================================================================
# Creation
# =============================================================================


@clangop()
def full(shape, fill_value, *, device=None, dtype=None):
    device = devices.to_device(device) if device is not None else devices.Device()
    if dtype is None:
        dtype = dtypes.to_strong(dtypes.numbertype_to_dtype(type(pyval(fill_value))))
        if dtype == dtypes.float64:
            dtype = dtypes.float32
    return prims.full(tuple(shape), pyval(fill_value), device=device, dtype=dtypes.to_strong(dtype))


@clangop()
def full_like(a, fill_value, *, device=None, dtype=None):
    return full(
        a.shape,
        fill_value,
        device=device if device is not None else a.device,
        dtype=dtype if dtype is not None else a.dtype,
    )


@clangop()
def zeros(shape, *, device=None, dtype=None):
    return full(shape, 0.0 if dtype is None or dtypes.is_inexact_dtype(dtypes.to_dtype(dtype)) else 0, device=device, dtype=dtype or dtypes.float32)


@clangop()
def ones(shape, *, device=None, dtype=None):
    return full(shape, 1.0 if dtype is None or dtypes.is_inexact_dtype(dtypes.to_dtype(dtype)) else 1, device=device, dtype=dtype or dtypes.float32)


@clangop()
def zeros_like(a, *, device=None, dtype=None):
    return full_like(a, 0 if dtypes.is_exact_dtype(a.dtype) and dtype is None else 0.0, device=device, dtype=dtype)


@clangop()
def ones_like(a, *, device=None, dtype=None):
    return full_like(a, 1 if dtypes.is_exact_dtype(a.dtype) and dtype is None else 1.0, device=device, dtype=dtype)


@clangop()
def arange(start, end=None, step=1, *, device=None, dtype=None):
    if end is None:
        start, end = 0, start
    device = devices.to_device(device) if device is not None else devices.Device()
    start_v, end_v, step_v = pyval(start), pyval(end), pyval(step)
    check(step_v != 0, "arange step must be nonzero")
    import math

    length = max(0, math.ceil((end_v - start_v) / step_v))
    if dtype is None:
        if any(isinstance(v, float) for v in (start_v, end_v, step_v)):
            dtype = dtypes.float32
        else:
            dtype = dtypes.int64
    return prims.iota(length, start=start_v, step=step_v, device=device, dtype=dtypes.to_strong(dtypes.to_dtype(dtype)))


@clangop()
def uniform(shape, minval=0.0, maxval=1.0, *, device=None, dtype=None):
    device = devices.to_device(device) if device is not None else devices.Device()
    dtype = dtypes.to_strong(dtypes.to_dtype(dtype)) if dtype is not None else dtypes.float32
    return prims.uniform(tuple(shape), pyval(minval), pyval(maxval), device=device, dtype=dtype)


@clangop()
def randn(shape, *, device=None, dtype=None):
    device = devices.to_device(device) if device is not None else devices.Device()
    dtype = dtypes.to_strong(dtypes.to_dtype(dtype)) if dtype is not None else dtypes.float32
    return prims.randn(tuple(shape), device=device, dtype=dtype)


@clangop()
def tensor_from_sequence(seq, *, device=None, dtype=None):
    device = devices.to_device(device) if device is not None else devices.Device()
    return prims.tensor_from_sequence(seq, device=device, dtype=dtype)


@clangop()
def diagonal_mask(n: int, m: int, *, offset: int = 0, upper: bool = True, device=None):
    """Boolean mask selecting the upper/lower triangle — building block for
    tril/triu/causal masks (reference: clang's tril/triu decomposition)."""
    device = devices.to_device(device) if device is not None else devices.Device()
    rows = prims.iota(n, start=0, step=1, device=device, dtype=dtypes.int32)
    cols = prims.iota(m, start=0, step=1, device=device, dtype=dtypes.int32)
    rows = prims.broadcast_in_dim(rows, (n, m), (0,))
    cols = prims.broadcast_in_dim(cols, (n, m), (1,))
    if upper:
        return ge(sub(cols, rows), offset)
    return le(sub(cols, rows), offset)


# =============================================================================
# dtype / device movement
# =============================================================================


@clangop(method_name="to")
def to(a, device=None, dtype=None):
    if dtype is not None:
        a = maybe_convert_to_dtype(a, dtypes.to_dtype(dtype))
    if device is not None and isinstance(a, TensorProxy):
        device = devices.to_device(device)
        if device != a.device:
            a = prims.device_put(a, device)
    return a


@clangop(method_name="type_as")
def type_as(a, b):
    return maybe_convert_to_dtype(a, b.dtype)


@clangop(method_name="item")
def item(a):
    return prims.item(a)


# =============================================================================
# Shape ops
# =============================================================================


@clangop(method_name="reshape")
def reshape(a, shape):
    shape = tuple(int(pyval(s)) for s in shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        inferred = a.numel // known
        shape = tuple(inferred if s == -1 else s for s in shape)
    if tuple(a.shape) == shape:
        return a
    return prims.reshape(a, shape)


@clangop(method_name="expand")
def expand(a, shape):
    shape = tuple(int(pyval(s)) for s in shape)
    offset = len(shape) - a.ndim
    shape = tuple(a.shape[i - offset] if s == -1 else s for i, s in enumerate(shape))
    return expand_to(a, shape)


@clangop(method_name="permute")
def permute(a, permutation):
    permutation = utils.canonicalize_dims(a.ndim, tuple(int(pyval(p)) for p in permutation))
    if permutation == tuple(range(a.ndim)):
        return a
    return prims.transpose(a, permutation)


@clangop(method_name="transpose")
def transpose(a, dim0: int, dim1: int):
    dim0 = utils.canonicalize_dim(a.ndim, dim0)
    dim1 = utils.canonicalize_dim(a.ndim, dim1)
    perm = list(range(a.ndim))
    perm[dim0], perm[dim1] = perm[dim1], perm[dim0]
    return permute(a, perm)


@clangop()
def matrix_transpose(a):
    check(a.ndim >= 2, "matrix_transpose requires rank >= 2")
    return transpose(a, -2, -1)


@clangop(method_name="movedim")
def movedim(a, source, destination):
    src = utils.canonicalize_dims(a.ndim, source if isinstance(source, (tuple, list)) else (source,))
    dst = utils.canonicalize_dims(a.ndim, destination if isinstance(destination, (tuple, list)) else (destination,))
    perm = [d for d in range(a.ndim) if d not in src]
    for s, d in sorted(zip(src, dst), key=lambda x: x[1]):
        perm.insert(d, s)
    return permute(a, perm)


@clangop(method_name="squeeze")
def squeeze(a, dims=None):
    if dims is None:
        dims = tuple(i for i, s in enumerate(a.shape) if s == 1)
    else:
        if isinstance(dims, int):
            dims = (dims,)
        dims = utils.canonicalize_dims(a.ndim, dims)
        dims = tuple(d for d in dims if a.shape[d] == 1)
    if not dims:
        return a
    return prims.squeeze(a, dims)


@clangop(method_name="unsqueeze")
def unsqueeze(a, dim: int):
    dim = utils.canonicalize_dim(a.ndim + 1, dim)
    shape = list(a.shape)
    shape.insert(dim, 1)
    return prims.reshape(a, tuple(shape))


@clangop(method_name="flatten")
def flatten(a, start_dim: int = 0, end_dim: int = -1):
    start_dim = utils.canonicalize_dim(a.ndim, start_dim)
    end_dim = utils.canonicalize_dim(a.ndim, end_dim)
    if a.ndim == 0:
        return reshape(a, (1,))
    mid = 1
    for s in a.shape[start_dim : end_dim + 1]:
        mid *= s
    shape = a.shape[:start_dim] + (mid,) + a.shape[end_dim + 1 :]
    return reshape(a, shape)


@clangop()
def stride_order(a, order=None):
    # Layout is the executor's concern; identity for parity.
    return a


@clangop()
def cat(tensors, dim: int = 0):
    tensors = list(tensors)
    check(len(tensors) > 0, "cat of empty list")
    if len(tensors) == 1:
        return tensors[0]
    st = reduce(lambda x, y: _promote_tensors(x, y), tensors)
    tensors = [maybe_convert_to_dtype(t, st) for t in tensors]
    return prims.cat(tensors, utils.canonicalize_dim(tensors[0].ndim, dim))


def _promote_tensors(x, y):
    if isinstance(x, dtypes.dtype):
        dx = x
    else:
        dx = x.dtype
    _, result = utils.elementwise_type_promotion(
        TensorProxy(shape=(), dtype=dx, device=(y.device if isinstance(y, TensorProxy) else devices.cpu)),
        y,
        type_promotion_kind=_K.PRESERVE,
    )
    return result


@clangop()
def stack(tensors, dim: int = 0):
    tensors = [unsqueeze(t, dim) for t in tensors]
    return cat(tensors, dim)


@clangop(method_name="chunk")
def chunk(a, chunks: int, dim: int = 0):
    dim = utils.canonicalize_dim(a.ndim, dim)
    size = a.shape[dim]
    chunk_size = (size + chunks - 1) // chunks
    return split(a, chunk_size, dim)


@clangop(method_name="split")
def split(a, split_size_or_sections, dim: int = 0):
    dim = utils.canonicalize_dim(a.ndim, dim)
    size = a.shape[dim]
    if isinstance(split_size_or_sections, int):
        sections = []
        pos = 0
        while pos < size:
            sections.append(min(split_size_or_sections, size - pos))
            pos += split_size_or_sections
    else:
        sections = list(split_size_or_sections)
    outs = []
    pos = 0
    for s in sections:
        outs.append(slice_in_dim(a, pos, pos + s, dim=dim))
        pos += s
    return tuple(outs)


@clangop()
def slice_in_dim(a, start: int, end: int, *, stride: int = 1, dim: int = 0):
    dim = utils.canonicalize_dim(a.ndim, dim)
    starts = [0] * a.ndim
    ends = list(a.shape)
    strides = [1] * a.ndim
    start = max(0, start + a.shape[dim] if start < 0 else start)
    end = min(a.shape[dim], end + a.shape[dim] if end < 0 else end)
    end = max(start, end)
    starts[dim] = start
    ends[dim] = end
    strides[dim] = stride
    return prims.slice_prim(a, starts, ends, strides)


@clangop()
def flip(a, dims):
    if isinstance(dims, int):
        dims = (dims,)
    return prims.flip(a, utils.canonicalize_dims(a.ndim, tuple(dims)))


@clangop()
def pad(a, padding_value, padding_config):
    return prims.pad(a, pyval(padding_value), tuple(tuple(p) for p in padding_config))


@clangop(method_name="getitem")
def getitem(a, key):
    """Basic indexing: int / slice / None / Ellipsis / tensor (advanced, via
    take). Reference parity: thunder/clang `_basic_indexing:556` +
    advanced-indexing subset."""
    if not isinstance(key, tuple):
        key = (key,)

    # Advanced indexing with a single integer tensor (common embedding case)
    if len(key) == 1 and isinstance(key[0], TensorProxy):
        idx = key[0]
        flat = reshape(idx, (idx.numel,))
        taken = prims.take(a, flat, 0)
        return reshape(taken, tuple(idx.shape) + tuple(a.shape[1:]))

    # Count specified dims (non-None, non-Ellipsis). Identity checks only:
    # `in`/`==` on a key containing TensorProxies would trace elementwise eq.
    n_spec = len([k for k in key if k is not None and k is not Ellipsis])
    check(n_spec <= a.ndim, "too many indices")
    # Expand Ellipsis
    ell = next((i for i, k in enumerate(key) if k is Ellipsis), None)
    if ell is not None:
        fill = a.ndim - n_spec
        key = key[:ell] + (slice(None),) * fill + key[ell + 1 :]
    else:
        key = key + (slice(None),) * (a.ndim - n_spec)

    # Multi-tensor advanced indexing over every dim (e.g. HF's
    # ``padding_mask[batch_idx, kv_idx]`` with broadcasting index tensors):
    # broadcast the indices together, linearize, and gather from the
    # flattened array.
    if len([k for k in key if isinstance(k, TensorProxy)]) >= 2:  # clang.sum shadows builtins.sum
        check(
            len(key) == a.ndim
            and all(isinstance(k, (TensorProxy, int, NumberProxy)) for k in key),
            lambda: "advanced-indexing subset: multiple tensor indices must cover every dim",
        )
        linear = None
        for k, size in zip(key, a.shape):
            if isinstance(k, TensorProxy):
                kk = where(lt(k, 0), add(k, size), k)
            else:
                kv = int(pyval(k))
                kk = kv + size if kv < 0 else kv
            linear = kk if linear is None else add(mul(linear, size), kk)
        if isinstance(linear, TensorProxy):
            out_shape = tuple(linear.shape)
            flat_idx = reshape(linear, (linear.numel,))
            taken = prims.take(reshape(a, (a.numel,)), flat_idx, 0)
            return reshape(taken, out_shape)
        return getitem(reshape(a, (a.numel,)), linear)

    starts, ends, strides = [], [], []
    squeeze_dims = []  # dims indexed by int → removed
    unsqueeze_positions = []  # positions of None → size-1 dims inserted
    dim = 0
    out_pos = 0
    for k in key:
        if k is None:
            unsqueeze_positions.append(out_pos)
            out_pos += 1
            continue
        size = a.shape[dim]
        if isinstance(k, (int, NumberProxy)):
            kv = int(pyval(k))
            kv = kv + size if kv < 0 else kv
            check(0 <= kv < size, lambda: f"index {k} out of range for dim {dim} of size {size}")
            starts.append(kv)
            ends.append(kv + 1)
            strides.append(1)
            squeeze_dims.append(dim)
            dim += 1
            continue
        if isinstance(k, slice):
            start, stop, stride = k.indices(size)
            check(stride > 0, "negative slice steps unsupported; use flip()")
            starts.append(start)
            ends.append(max(start, stop))
            strides.append(stride)
            dim += 1
            out_pos += 1
            continue
        raise NotImplementedError(f"Unsupported index element {k!r}")

    r = a
    if any(s != 0 for s in starts) or any(e != s for e, s in zip(ends, a.shape)) or any(st != 1 for st in strides):
        r = prims.slice_prim(a, starts, ends, strides)
    if squeeze_dims:
        r = prims.squeeze(r, tuple(squeeze_dims))
    for pos in unsqueeze_positions:
        r = unsqueeze(r, pos)
    return r


@clangop()
def take(a, indices, dim: int = 0):
    return prims.take(a, indices, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def take_along_axis(a, indices, dim: int = 0):
    return prims.take_along_axis(a, indices, utils.canonicalize_dim(a.ndim, dim))


@clangop(method_name="gather")
def gather(a, dim: int, indices):
    return prims.gather(a, indices, utils.canonicalize_dim(a.ndim, dim))


@clangop(method_name="scatter_add")
def scatter_add(a, dim: int, indices, value):
    return prims.scatter_add(a, indices, value, utils.canonicalize_dim(a.ndim, dim))


@clangop(method_name="index_put")
def index_put(a, indices, values, accumulate: bool = False):
    return prims.index_put(a, tuple(indices), values, accumulate)


@clangop()
def tril(a, diagonal: int = 0):
    check(a.ndim >= 2, "tril requires rank >= 2")
    mask = diagonal_mask(a.shape[-2], a.shape[-1], offset=diagonal, upper=False, device=a.device)
    mask = expand_to(mask, a.shape)
    return where(mask, a, zeros_like(a))


@clangop()
def triu(a, diagonal: int = 0):
    check(a.ndim >= 2, "triu requires rank >= 2")
    mask = diagonal_mask(a.shape[-2], a.shape[-1], offset=diagonal, upper=True, device=a.device)
    mask = expand_to(mask, a.shape)
    return where(mask, a, zeros_like(a))


# =============================================================================
# Reductions
# =============================================================================


def _reduction_dims(ndim: int, dims) -> tuple:
    if dims is None:
        return tuple(range(ndim))
    if isinstance(dims, int):
        dims = (dims,)
    return utils.canonicalize_dims(ndim, tuple(dims))


def _maybe_keepdim(r, orig_shape, dims, keepdim: bool):
    if not keepdim:
        return r
    shape = list(orig_shape)
    for d in dims:
        shape[d] = 1
    return reshape(r, tuple(shape))


def _make_reduction(name: str, prim, *, method=None):
    def op(a, dims=None, keepdim: bool = False):
        rdims = _reduction_dims(a.ndim, dims)
        r = prim(a, rdims)
        return _maybe_keepdim(r, a.shape, rdims, keepdim)

    op.__name__ = name
    if method:
        _clang_ctx.register_method(method, op)
    return op


amax = _make_reduction("amax", prims.amax, method="amax")
amin = _make_reduction("amin", prims.amin, method="amin")
prod = _make_reduction("prod", prims.prod, method="prod")


@clangop(method_name="sum")
def sum(a, dims=None, keepdim: bool = False, *, dtype=None):
    rdims = _reduction_dims(a.ndim, dims)
    if dtype is not None:
        a = maybe_convert_to_dtype(a, dtypes.to_dtype(dtype))
    elif dtypes.is_boolean_dtype(a.dtype):
        a = maybe_convert_to_dtype(a, dtypes.int64)
    r = prims.sum_prim(a, rdims)
    return _maybe_keepdim(r, a.shape, rdims, keepdim)


@clangop(method_name="mean")
def mean(a, dims=None, keepdim: bool = False, *, dtype=None):
    rdims = _reduction_dims(a.ndim, dims)
    count = 1
    for d in rdims:
        count *= a.shape[d]
    result_dtype = dtypes.to_dtype(dtype) if dtype is not None else (
        a.dtype if dtypes.is_inexact_dtype(a.dtype) else dtypes.float32
    )
    a = maybe_convert_to_dtype(a, result_dtype)
    r = sum(a, rdims, keepdim)
    return true_divide(r, count)


@clangop(method_name="var")
def var(a, dims=None, *, correction: Number = 1, keepdim: bool = False):
    rdims = _reduction_dims(a.ndim, dims)
    r = prims.var(a, rdims, correction=correction)
    return _maybe_keepdim(r, a.shape, rdims, keepdim)


@clangop()
def var_mean(a, dims=None, *, correction: Number = 1, keepdim: bool = False):
    rdims = _reduction_dims(a.ndim, dims)
    v, m = prims.var_mean(a, rdims, correction=correction)
    return _maybe_keepdim(v, a.shape, rdims, keepdim), _maybe_keepdim(m, a.shape, rdims, keepdim)


@clangop(method_name="std")
def std(a, dims=None, *, correction: Number = 1, keepdim: bool = False):
    return sqrt(var(a, dims, correction=correction, keepdim=keepdim))


@clangop(method_name="argmax")
def argmax(a, dim=None, keepdim: bool = False):
    r = prims.argmax(a, dim)
    if keepdim and dim is not None:
        r = unsqueeze(r, utils.canonicalize_dim(a.ndim, dim))
    return r


@clangop(method_name="argmin")
def argmin(a, dim=None, keepdim: bool = False):
    r = prims.argmin(a, dim)
    if keepdim and dim is not None:
        r = unsqueeze(r, utils.canonicalize_dim(a.ndim, dim))
    return r


@clangop(method_name="all")
def all_tensor(a, dims=None, keepdim: bool = False):
    r = logical_not(any_tensor(logical_not(a), dims, keepdim))
    return r


@clangop(method_name="any")
def any_tensor(a, dims=None, keepdim: bool = False):
    b = maybe_convert_to_dtype(ne(a, 0) if not dtypes.is_boolean_dtype(a.dtype) else a, dtypes.int64)
    return ne(sum(b, dims, keepdim), 0)


# =============================================================================
# Linear algebra / NN
# =============================================================================


@clangop(method_name="matmul")
def matmul(a, b):
    # Promote to a common dtype, then call the strict prim.
    _, result_dtype = utils.elementwise_type_promotion(a, b, type_promotion_kind=_K.PRESERVE)
    a = maybe_convert_to_dtype(a, result_dtype)
    b = maybe_convert_to_dtype(b, result_dtype)
    return prims.matmul(a, b)


@clangop()
def linear(a, w, bias=None):
    return prims.linear(a, w, bias)


@clangop()
def convolution(a, weight, bias, stride, padding, dilation, groups: int):
    return prims.convolution(a, weight, bias, tuple(stride), tuple(padding), tuple(dilation), int(groups))


@clangop()
def embedding(indices, weight):
    return prims.embedding(indices, weight)


@clangop()
def stop_gradient(a):
    return prims.stop_gradient(a)


@clangop(method_name="cumsum")
def cumsum(a, dim: int):
    return prims.cumsum(a, utils.canonicalize_dim(a.ndim, dim))


@clangop()
def topk(a, k: int, dim: int = -1, largest: bool = True, sorted: bool = True):
    return prims.topk(a, int(pyval(k)), utils.canonicalize_dim(a.ndim, dim), bool(largest), bool(sorted))


@clangop()
def sort(a, dim: int = -1, descending: bool = False):
    return prims.sort(a, utils.canonicalize_dim(a.ndim, dim), bool(descending))


@clangop()
def argsort(a, dim: int = -1, descending: bool = False):
    return prims.argsort(a, utils.canonicalize_dim(a.ndim, dim), bool(descending))


# -- reference-parity additions (thunder/clang public surface) ----------------
# Guard/unpack prims are re-exported so clang covers the reference's full
# public op list (reference: thunder/clang/__init__.py exposes check_*/
# unpack_* used by prologue construction).

check_tensor_shape_and_metadata = prims.check_tensor_shape_and_metadata
check_number_type_and_value = prims.check_number_type_and_value
check_string_value = prims.check_string_value
check_none = prims.check_none
check_len = prims.check_len
device_put = prims.device_put
unpack_sequence = prims.unpack_sequence
unpack_key = prims.unpack_key


# One broadcast-rule implementation for the whole stack (core/utils.py is
# what maybe_broadcast already consults).
compute_broadcast_shape = utils.compute_broadcast_shape


@clangop()
def sigmoid(a):
    # 1 / (1 + exp(-x)) — the simple composition; exp overflows to inf for
    # large -x and the quotient goes to 0, so the tails stay finite.
    return true_divide(1.0, add(exp(neg(a)), 1.0))


@clangop()
def silu(a):
    return mul(a, sigmoid(a))


@clangop()
def diagonal(a, offset: int = 0, dim1: int = 0, dim2: int = 1):
    """Torch-semantics diagonal: move (dim1, dim2) last, gather the diagonal
    along the joint index (the canonical decomposition; ltorch delegates
    here)."""
    from thunder_tpu_torch.core import dtypes as _dt
    from thunder_tpu_torch.core.baseutils import check as _check

    d1 = utils.canonicalize_dim(a.ndim, int(pyval(dim1)))
    d2 = utils.canonicalize_dim(a.ndim, int(pyval(dim2)))
    _check(d1 != d2, "diagonal dims must differ")
    k = int(pyval(offset))
    n, m = a.shape[d1], a.shape[d2]
    length = max(0, min(n, m - k) if k >= 0 else min(n + k, m))
    x = movedim(a, (d1, d2), (a.ndim - 2, a.ndim - 1))
    rows = arange(0, length, 1, device=a.device, dtype=_dt.int64)
    if k >= 0:
        ridx, cidx = rows, add(rows, k)
    else:
        ridx, cidx = add(rows, -k), rows
    x = prims.take(x, ridx, x.ndim - 2)
    cidx_full = expand_to(
        reshape(cidx, (1,) * (x.ndim - 2) + (length, 1)), tuple(x.shape[:-1]) + (1,)
    )
    return squeeze(take_along_axis(x, cidx_full, x.ndim - 1), (x.ndim - 1,))


def _index_to_scatter_idx(a, d: int, index, source):
    """(n,) index vector → scatter_add-shaped index matching ``source``."""
    return expand_to(
        reshape(index, (1,) * d + (index.shape[0],) + (1,) * (a.ndim - d - 1)),
        tuple(source.shape),
    )


@clangop()
def index_add(a, dim: int, index, source, alpha=1):
    """The canonical index_add decomposition (ltorch delegates here)."""
    d = utils.canonicalize_dim(a.ndim, int(pyval(dim)))
    if pyval(alpha) != 1:
        source = mul(source, alpha)
    return scatter_add(a, d, _index_to_scatter_idx(a, d, index, source), source)


@clangop()
def index_copy(a, dim: int, index, source):
    """scatter-set = scatter_add of (source - current values at index)."""
    d = utils.canonicalize_dim(a.ndim, int(pyval(dim)))
    idx = _index_to_scatter_idx(a, d, index, source)
    current = gather(a, d, idx)
    return scatter_add(a, d, idx, sub(source, current))


@clangop()
def erfcinv(a):
    """Inverse complementary error function: erfinv(1 - a)."""
    return erfinv(sub(1.0, a))


@clangop()
def ndtri(a):
    """Inverse standard-normal CDF: -sqrt(2)·erfinv(1 - 2a) (scipy.special
    ndtri semantics, the reference's clang op)."""
    return mul(erfinv(sub(mul(a, 2.0), 1.0)), 1.4142135623730951)


@clangop()
def uniform_like(a, minval=0.0, maxval=1.0, *, device=None, dtype=None):
    return uniform(tuple(a.shape), minval, maxval,
                   device=device or a.device, dtype=dtype or a.dtype)
