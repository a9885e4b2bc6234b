"""The torch-mirror language layer ("ltorch").

Reference parity: thunder/torch/__init__.py (168 `@torchsymbol`s mirroring the
`torch.*` / `torch.nn.functional.*` API, the `_torch_to_thunder_function_map`
at `:61` consumed by frontend lookasides, and method registration via
`torchsymbol:73`).

Each op here is a :class:`~thunder_tpu_torch.core.symbol.Symbol` whose meta function
*decomposes* into clang ops and prims while tracing — producing the
multi-level IR that lets high-priority executors (e.g. the flash-attention
executor) claim composite ops whole, while the terminal torch executor
claims the prims they decompose into.

The dtype/shape semantics mirror torch (type promotion, integer true-division
producing floats, `keepdim`, negative dims, ...); the decompositions use
static shapes and `where` instead of data-dependent branches.
"""

from __future__ import annotations

import functools
import math
from numbers import Number
from typing import Any, Callable, Optional, Sequence, Union

import thunder_tpu_torch.clang as clang
import thunder_tpu_torch.core.prims as prims
from thunder_tpu_torch.core import dtypes, devices, utils
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.langctxs import LanguageContext, Languages, register_langctx, resolve_language
from thunder_tpu_torch.core.proxies import AnyProxy, NumberProxy, StringProxy, TensorProxy, pyval
from thunder_tpu_torch.core.symbol import Symbol, register_module
from thunder_tpu_torch.core.utils import canonicalize_dim, canonicalize_dims

# -- language context ---------------------------------------------------------

_torch_ctx = LanguageContext(Languages.TORCH)
# The torch language is a superset of clang's method surface.
_clang_ctx = resolve_language(Languages.CLANG)
_torch_ctx._methods.update(_clang_ctx._methods)
register_langctx(Languages.TORCH, _torch_ctx)

# torch.foo / torch.Tensor.foo / F.foo → ltorch symbol. Consumed by the
# module frontend's __torch_function__ dispatch (reference: thunder/torch
# `_torch_to_thunder_function_map:61`).
_torch_to_thunder_function_map: dict[Any, Callable] = {}


def _resolve_torch_attr(path: str):
    """'torch.nn.functional.linear' → the live torch object, or None."""
    try:
        import torch
    except ImportError:
        return None
    obj = torch
    for part in path.split(".")[1:]:
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _unproxy_static(x):
    """Replace static-valued scalar/string/opaque input proxies with their
    concrete values, recursively through containers.

    Exact under CONSTANT_VALUES caching: the prologue guards every number/
    string input value, so the computation is already specialized to them —
    recording the value (not the proxy) in the bound symbol keeps dims,
    mode strings, slices etc. out of the generated program's free variables.
    NumberProxies with *unknown* values (e.g. `.item()` outputs — genuinely
    dynamic) are preserved."""
    if isinstance(x, (tuple, list)):
        return type(x)(_unproxy_static(v) for v in x)
    if isinstance(x, dict):
        return {k: _unproxy_static(v) for k, v in x.items()}
    if isinstance(x, NumberProxy):
        return x.value if x.value is not None else x
    if isinstance(x, (StringProxy, AnyProxy)):
        return x.value
    return x


def torchsymbol(*torch_paths: str, method_name: Optional[str] = None, id: Optional[str] = None):
    """Create an ltorch Symbol from a decomposition fn, registering it under
    the given torch dotted paths and optionally as a tensor method
    (reference: thunder/torch `torchsymbol:73`).

    The registered callable unwraps static scalar/string input proxies at
    the op boundary (see ``_unproxy_static``) before recording the symbol."""

    def decorator(fn: Callable) -> Symbol:
        sym = Symbol(fn.__name__, meta=fn, id=id if id is not None else f"torch.{fn.__name__}", module="ltorch")

        @functools.wraps(fn)
        def op(*args, **kwargs):
            return sym(*_unproxy_static(args), **_unproxy_static(kwargs))

        op._symbol = sym
        for path in torch_paths:
            obj = _resolve_torch_attr(path)
            if obj is not None:
                _torch_to_thunder_function_map[obj] = op
        if method_name is not None:
            _torch_ctx.register_method(method_name, op)
        return op

    return decorator


def to_dtype(x) -> Optional[dtypes.dtype]:
    return dtypes.to_dtype(x) if x is not None else None


# The module shadows several builtins with torch-mirror ops below.
builtins_abs, builtins_min, builtins_max, builtins_sum = abs, min, max, sum


def _dim_seq(dim) -> Optional[tuple]:
    if dim is None:
        return None
    if isinstance(dim, (int, NumberProxy)):
        return (int(pyval(dim)),)
    return tuple(int(pyval(d)) for d in dim)


# =============================================================================
# Tensor creation
# =============================================================================


@torchsymbol("torch.zeros")
def zeros(*size, dtype=None, device=None, requires_grad: bool = False):
    shape = size[0] if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
    return clang.full(tuple(shape), 0, device=device, dtype=to_dtype(dtype) or dtypes.float32)


@torchsymbol("torch.ones")
def ones(*size, dtype=None, device=None, requires_grad: bool = False):
    shape = size[0] if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
    return clang.full(tuple(shape), 1, device=device, dtype=to_dtype(dtype) or dtypes.float32)


@torchsymbol("torch.full")
def full(size, fill_value, *, dtype=None, device=None, requires_grad: bool = False):
    return clang.full(tuple(size), fill_value, device=device, dtype=to_dtype(dtype))


@torchsymbol("torch.empty")
def empty(*size, dtype=None, device=None, requires_grad: bool = False):
    shape = size[0] if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
    return clang.full(tuple(shape), 0, device=device, dtype=to_dtype(dtype) or dtypes.float32)


@torchsymbol("torch.zeros_like")
def zeros_like(a, *, dtype=None, device=None, requires_grad: bool = False):
    return clang.zeros_like(a, device=device, dtype=to_dtype(dtype))


def _new_factory_shape(size) -> tuple:
    if len(size) == 1 and isinstance(size[0], (tuple, list)):
        return tuple(size[0])
    return tuple(size)


@torchsymbol("torch.Tensor.new_zeros", method_name="new_zeros")
def new_zeros(a, *size, dtype=None, device=None, requires_grad: bool = False):
    return clang.full(_new_factory_shape(size), 0, device=device or a.device,
                      dtype=to_dtype(dtype) or a.dtype)


@torchsymbol("torch.Tensor.new_ones", method_name="new_ones")
def new_ones(a, *size, dtype=None, device=None, requires_grad: bool = False):
    return clang.full(_new_factory_shape(size), 1, device=device or a.device,
                      dtype=to_dtype(dtype) or a.dtype)


@torchsymbol("torch.Tensor.new_full", method_name="new_full")
def new_full(a, size, fill_value, *, dtype=None, device=None, requires_grad: bool = False):
    return clang.full(tuple(size), fill_value, device=device or a.device,
                      dtype=to_dtype(dtype) or a.dtype)


@torchsymbol("torch.Tensor.new_empty", method_name="new_empty")
def new_empty(a, *size, dtype=None, device=None, requires_grad: bool = False):
    return clang.full(_new_factory_shape(size), 0, device=device or a.device,
                      dtype=to_dtype(dtype) or a.dtype)


@torchsymbol("torch.ones_like")
def ones_like(a, *, dtype=None, device=None, requires_grad: bool = False):
    return clang.ones_like(a, device=device, dtype=to_dtype(dtype))


@torchsymbol("torch.full_like")
def full_like(a, fill_value, *, dtype=None, device=None, requires_grad: bool = False):
    return clang.full_like(a, fill_value, device=device, dtype=to_dtype(dtype))


@torchsymbol("torch.arange")
def arange(start, end=None, step=1, *, dtype=None, device=None, requires_grad: bool = False):
    return clang.arange(start, end, step, device=device, dtype=to_dtype(dtype))


@torchsymbol("torch.rand")
def rand(*size, dtype=None, device=None, requires_grad: bool = False, generator=None):
    shape = size[0] if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
    return clang.uniform(tuple(shape), 0.0, 1.0, device=device, dtype=to_dtype(dtype) or dtypes.float32)


@torchsymbol("torch.randn")
def randn(*size, dtype=None, device=None, requires_grad: bool = False, generator=None):
    shape = size[0] if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
    return clang.randn(tuple(shape), device=device, dtype=to_dtype(dtype) or dtypes.float32)


@torchsymbol("torch.tensor")
def tensor(data, *, dtype=None, device=None, requires_grad: bool = False):
    if isinstance(data, TensorProxy):
        return clang.to(data, device=device, dtype=to_dtype(dtype))
    if isinstance(data, (Number, NumberProxy)) and not isinstance(data, (list, tuple)):
        dt = to_dtype(dtype) or dtypes.to_strong(dtypes.numbertype_to_dtype(type(pyval(data))))
        return clang.full((), data, device=device, dtype=dt)
    return clang.tensor_from_sequence(data, device=device, dtype=to_dtype(dtype))


# =============================================================================
# Data movement / dtype casts
# =============================================================================


@torchsymbol("torch.Tensor.to", method_name="to")
def to(a, *args, **kwargs):
    device = kwargs.get("device")
    dtype = kwargs.get("dtype")
    for arg in args:
        if isinstance(arg, str) or type(arg).__name__ == "device" or isinstance(arg, devices.Device):
            device = arg
        elif arg is not None:
            dtype = arg
    return clang.to(a, device=device, dtype=to_dtype(dtype))


@torchsymbol("torch.Tensor.type_as", method_name="type_as")
def type_as(a, b):
    return clang.maybe_convert_to_dtype(a, b.dtype)


def _make_cast(name: str, dtype: dtypes.dtype) -> Symbol:
    def cast(a):
        return clang.maybe_convert_to_dtype(a, dtype)

    cast.__name__ = name
    sym = Symbol(name, meta=cast, id=f"torch.Tensor.{name}", module="ltorch")
    _torch_ctx.register_method(name, sym)
    obj = _resolve_torch_attr(f"torch.Tensor.{name}")
    if obj is not None:
        _torch_to_thunder_function_map[obj] = sym
    return sym


float_ = _make_cast("float", dtypes.float32)
double = _make_cast("double", dtypes.float64)
half = _make_cast("half", dtypes.float16)
bfloat16 = _make_cast("bfloat16", dtypes.bfloat16)
long = _make_cast("long", dtypes.int64)
int_ = _make_cast("int", dtypes.int32)
bool_ = _make_cast("bool", dtypes.bool8)


@torchsymbol("torch.Tensor.contiguous", method_name="contiguous")
def contiguous(a, *, memory_format=None):
    # Traced tensors are logically contiguous; layout is the executor's.
    return prims.shallow_copy(a)


@torchsymbol("torch.clone", method_name="clone")
def clone(a, *, memory_format=None):
    return prims.shallow_copy(a)


@torchsymbol("torch.Tensor.detach", method_name="detach")
def detach(a):
    return prims.stop_gradient(a)


@torchsymbol("torch.Tensor.item", method_name="item")
def item(a):
    return prims.item(a)


# =============================================================================
# Shape operations
# =============================================================================


@torchsymbol("torch.Tensor.view", method_name="view")
def view(a, *shape):
    shape = shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, list)) else shape
    return reshape(a, shape)


@torchsymbol("torch.reshape", method_name="reshape")
def reshape(a, *shape):
    shape = shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, list)) else shape
    shape = [int(pyval(s)) for s in shape]
    if -1 in shape:
        idx = shape.index(-1)
        known = 1
        for i, s in enumerate(shape):
            if i != idx:
                known *= s
        check(known != 0 and a.numel % known == 0, lambda: f"cannot reshape {a.shape} to {shape}")
        shape[idx] = a.numel // known
    return clang.reshape(a, tuple(shape))


@torchsymbol("torch.permute", method_name="permute")
def permute(a, *dims):
    dims = dims[0] if len(dims) == 1 and isinstance(dims[0], (tuple, list)) else dims
    return clang.permute(a, tuple(int(pyval(d)) for d in dims))


@torchsymbol("torch.transpose", method_name="transpose")
def transpose(a, dim0: int, dim1: int):
    return clang.transpose(a, int(pyval(dim0)), int(pyval(dim1)))


@torchsymbol("torch.Tensor.t", method_name="t")
def t(a):
    check(a.ndim <= 2, "t() requires rank <= 2")
    return clang.matrix_transpose(a) if a.ndim == 2 else a


@torchsymbol("torch.movedim", method_name="movedim")
def movedim(a, source, destination):
    return clang.movedim(a, source, destination)


@torchsymbol("torch.squeeze", method_name="squeeze")
def squeeze(a, dim=None):
    if dim is None:
        dims = tuple(i for i, s in enumerate(a.shape) if s == 1)
    else:
        d = canonicalize_dim(a.ndim, int(pyval(dim)))
        if a.shape[d] != 1:
            return a
        dims = (d,)
    return clang.squeeze(a, dims)


@torchsymbol("torch.unsqueeze", method_name="unsqueeze")
def unsqueeze(a, dim: int):
    return clang.unsqueeze(a, int(pyval(dim)))


@torchsymbol("torch.flatten", method_name="flatten")
def flatten(a, start_dim: int = 0, end_dim: int = -1):
    return clang.flatten(a, int(pyval(start_dim)), int(pyval(end_dim)))


@torchsymbol("torch.cat", "torch.concat")
def cat(tensors, dim: int = 0):
    # torch's legacy allowance: 1-D zero-element tensors are compatible with
    # anything in cat and contribute nothing (HF KV caches rely on this).
    tensors = [t for t in tensors if not (t.ndim == 1 and t.numel == 0)]
    check(len(tensors) > 0, "cat of only empty tensors")
    if len(tensors) == 1:
        return prims.shallow_copy(tensors[0])
    return clang.cat(list(tensors), int(pyval(dim)))


@torchsymbol("torch.stack")
def stack(tensors, dim: int = 0):
    return clang.stack(list(tensors), int(pyval(dim)))


@torchsymbol("torch.chunk", method_name="chunk")
def chunk(a, chunks: int, dim: int = 0):
    check(int(pyval(chunks)) > 0, lambda: f"chunk expects `chunks` to be greater than 0, got {chunks}")
    return clang.chunk(a, int(pyval(chunks)), int(pyval(dim)))


@torchsymbol("torch.split", method_name="split")
def split(a, split_size_or_sections, dim: int = 0):
    return clang.split(a, split_size_or_sections, int(pyval(dim)))


@torchsymbol("torch.Tensor.expand", method_name="expand")
def expand(a, *shape):
    shape = shape[0] if len(shape) == 1 and isinstance(shape[0], (tuple, list)) else shape
    shape = list(int(pyval(s)) for s in shape)
    offset = len(shape) - a.ndim
    for i, s in enumerate(shape):
        if s == -1:
            check(i >= offset, "cannot use -1 for a new leading dim in expand")
            shape[i] = a.shape[i - offset]
    return clang.expand(a, tuple(shape))


@torchsymbol("torch.Tensor.repeat", method_name="repeat")
def repeat(a, *sizes):
    sizes = sizes[0] if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)) else sizes
    sizes = tuple(int(pyval(s)) for s in sizes)
    check(len(sizes) >= a.ndim, "repeat requires at least a.ndim sizes")
    offset = len(sizes) - a.ndim
    r = a
    for _ in range(offset):
        r = clang.unsqueeze(r, 0)
    # tile by interleaving reshape/broadcast per dim
    for i, n in enumerate(sizes):
        if n != 1:
            r = clang.unsqueeze(r, i)
            target = list(r.shape)
            target[i] = n
            r = clang.expand(r, tuple(target))
            merged = list(r.shape)
            merged[i + 1] = merged[i] * merged[i + 1]
            del merged[i]
            r = clang.reshape(r, tuple(merged))
    return r


@torchsymbol("torch.flip", method_name="flip")
def flip(a, dims):
    return clang.flip(a, dims)


@torchsymbol("torch.Tensor.__getitem__", method_name="getitem")
def getitem(a, key):
    return clang.getitem(a, key)


@torchsymbol("torch.index_select", method_name="index_select")
def index_select(a, dim: int, index):
    return clang.take(a, index, int(pyval(dim)))


@torchsymbol("torch.gather", method_name="gather")
def gather(a, dim: int, index):
    return clang.gather(a, int(pyval(dim)), index)


@torchsymbol("torch.scatter_add", method_name="scatter_add")
def scatter_add(a, dim: int, index, src):
    return clang.scatter_add(a, int(pyval(dim)), index, src)


@torchsymbol("torch.take_along_dim", method_name="take_along_dim")
def take_along_dim(a, indices, dim: int):
    return clang.take_along_axis(a, indices, int(pyval(dim)))


def _normalize_index_key(key):
    """pyval static ints (incl. inside slices); keep TensorProxy indices."""
    def one(k):
        if isinstance(k, slice):
            return slice(one(k.start), one(k.stop), one(k.step))
        from thunder_tpu_torch.core.proxies import NumberProxy

        if isinstance(k, NumberProxy):
            return pyval(k)
        return k

    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


@torchsymbol("torch.setitem", method_name="setitem")
def setitem(a, key, value):
    """Out-of-place ``a[key] = value`` (a copy with the update applied);
    the in-place form functionalizes through ``TensorProxy.__setitem__``
    (HF T5's relative-position bucketing writes slices in place).

    Boolean-mask keys: ``a[mask] = scalar`` lowers to ``where`` (static
    shapes — a scatter would need concrete indices); a TENSOR
    value under a boolean mask is data-dependently shaped and rejected
    loudly."""
    from thunder_tpu_torch.core import dtypes as _dt

    keys = key if isinstance(key, tuple) else (key,)
    bool_masks = [
        k for k in keys
        if isinstance(k, TensorProxy) and _dt.is_boolean_dtype(_dt.to_dtype(k.dtype))
    ]
    if bool_masks:
        if len(keys) == 1 and not isinstance(value, TensorProxy):
            mask = bool_masks[0]
            # torch aligns mask dims with a's LEADING dims; expand trailing.
            while mask.ndim < a.ndim:
                mask = unsqueeze(mask, mask.ndim)
            fill = clang.full((), pyval(value), device=a.device, dtype=a.dtype)
            return clang.where(mask, fill, a)
        raise NotImplementedError(
            "setitem with a boolean mask and a tensor value (or a mask "
            "inside a tuple key) is data-dependently shaped; use "
            "masked_fill / torch.where, or index with integer tensors"
        )
    if isinstance(value, TensorProxy):
        value = clang.maybe_convert_to_dtype(value, a.dtype)
    else:
        value = pyval(value)
    return prims.setitem(a, _normalize_index_key(key), value)


@torchsymbol("torch.index_put", method_name="index_put")
def index_put(a, indices, values, accumulate: bool = False):
    return clang.index_put(a, indices, values, accumulate)


@torchsymbol("torch.tril", method_name="tril")
def tril(a, diagonal: int = 0):
    return clang.tril(a, int(pyval(diagonal)))


@torchsymbol("torch.triu", method_name="triu")
def triu(a, diagonal: int = 0):
    return clang.triu(a, int(pyval(diagonal)))


@torchsymbol("torch.Tensor.masked_fill", method_name="masked_fill")
def masked_fill(a, mask, value):
    return clang.where(mask, value, a)


@torchsymbol("torch.where")
def where(pred, a=None, b=None):
    check(a is not None and b is not None, "where() requires three arguments")
    return clang.where(pred, a, b)


@torchsymbol("torch.topk", method_name="topk")
def topk(a, k: int, dim: int = -1, largest: bool = True, sorted: bool = True):
    return clang.topk(a, k, dim, largest, sorted)


@torchsymbol("torch.sort", method_name="sort")
def sort(a, dim: int = -1, descending: bool = False):
    return clang.sort(a, dim, descending)


@torchsymbol("torch.argsort", method_name="argsort")
def argsort(a, dim: int = -1, descending: bool = False):
    return clang.argsort(a, dim, descending)


@torchsymbol("torch.cumsum", method_name="cumsum")
def cumsum(a, dim: int, *, dtype=None):
    r = clang.cumsum(a, int(pyval(dim)))
    if dtype is not None:
        r = clang.maybe_convert_to_dtype(r, to_dtype(dtype))
    return r


@torchsymbol("torch.repeat_interleave", method_name="repeat_interleave")
def repeat_interleave(a, repeats: int, dim: Optional[int] = None):
    check(isinstance(repeats, (int, NumberProxy)), "only int repeats supported")
    n = int(pyval(repeats))
    if dim is None:
        a = flatten(a)
        dim = 0
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    r = clang.unsqueeze(a, d + 1)
    target = list(r.shape)
    target[d + 1] = n
    r = clang.expand(r, tuple(target))
    merged = list(a.shape)
    merged[d] = merged[d] * n
    return clang.reshape(r, tuple(merged))


# =============================================================================
# Elementwise ops (torch.* functions; methods inherited from clang)
# =============================================================================


def _register_elementwise(name: str, clang_fn: Callable, torch_paths: Sequence[str], method: Optional[str] = None):
    def meta(*args, **kwargs):
        return clang_fn(*args, **kwargs)

    meta.__name__ = name
    sym = Symbol(name, meta=meta, id=f"torch.{name}", module="ltorch")
    for path in torch_paths:
        obj = _resolve_torch_attr(path)
        if obj is not None:
            _torch_to_thunder_function_map[obj] = sym
    if method is not None:
        _torch_ctx.register_method(method, sym)
    return sym


# unary
abs = _register_elementwise("abs", clang.abs, ["torch.abs", "torch.Tensor.abs"])
acos = _register_elementwise("acos", clang.acos, ["torch.acos"])
asin = _register_elementwise("asin", clang.asin, ["torch.asin"])
atan = _register_elementwise("atan", clang.atan, ["torch.atan"])
ceil = _register_elementwise("ceil", clang.ceil, ["torch.ceil"])
cos = _register_elementwise("cos", clang.cos, ["torch.cos", "torch.Tensor.cos"])
cosh = _register_elementwise("cosh", clang.cosh, ["torch.cosh"])
erf = _register_elementwise("erf", clang.erf, ["torch.erf"])
exp = _register_elementwise("exp", clang.exp, ["torch.exp", "torch.Tensor.exp"])
expm1 = _register_elementwise("expm1", clang.expm1, ["torch.expm1"])
floor = _register_elementwise("floor", clang.floor, ["torch.floor"])
isfinite = _register_elementwise("isfinite", clang.isfinite, ["torch.isfinite"])
isinf = _register_elementwise("isinf", clang.isinf, ["torch.isinf"])
isnan = _register_elementwise("isnan", clang.isnan, ["torch.isnan"])
log = _register_elementwise("log", clang.log, ["torch.log", "torch.Tensor.log"])
log1p = _register_elementwise("log1p", clang.log1p, ["torch.log1p"])
log2 = _register_elementwise("log2", clang.log2, ["torch.log2"])
neg = _register_elementwise("neg", clang.neg, ["torch.neg"])
reciprocal = _register_elementwise("reciprocal", clang.reciprocal, ["torch.reciprocal"])
round = _register_elementwise("round", clang.round, ["torch.round"])
rsqrt = _register_elementwise("rsqrt", clang.rsqrt, ["torch.rsqrt"])
sign = _register_elementwise("sign", clang.sign, ["torch.sign"])
sin = _register_elementwise("sin", clang.sin, ["torch.sin", "torch.Tensor.sin"])
sinh = _register_elementwise("sinh", clang.sinh, ["torch.sinh"])
sqrt = _register_elementwise("sqrt", clang.sqrt, ["torch.sqrt", "torch.Tensor.sqrt"])
tan = _register_elementwise("tan", clang.tan, ["torch.tan"])
tanh = _register_elementwise("tanh", clang.tanh, ["torch.tanh", "torch.Tensor.tanh"])
trunc = _register_elementwise("trunc", clang.trunc, ["torch.trunc"])
logical_not = _register_elementwise("logical_not", clang.logical_not, ["torch.logical_not"])
acosh = _register_elementwise("acosh", clang.acosh, ["torch.acosh", "torch.arccosh"])
asinh = _register_elementwise("asinh", clang.asinh, ["torch.asinh", "torch.arcsinh"])
atanh = _register_elementwise("atanh", clang.atanh, ["torch.atanh", "torch.arctanh"])
bitwise_not = _register_elementwise("bitwise_not", clang.bitwise_not, ["torch.bitwise_not"])
digamma = _register_elementwise("digamma", clang.digamma, ["torch.digamma", "torch.special.digamma"])
erfc = _register_elementwise("erfc", clang.erfc, ["torch.erfc", "torch.special.erfc"])
erfinv = _register_elementwise("erfinv", clang.erfinv, ["torch.erfinv", "torch.special.erfinv"])
exp2 = _register_elementwise("exp2", clang.exp2, ["torch.exp2", "torch.special.exp2"])
lgamma = _register_elementwise("lgamma", clang.lgamma, ["torch.lgamma", "torch.special.gammaln"])
log10 = _register_elementwise("log10", clang.log10, ["torch.log10"])
signbit = _register_elementwise("signbit", clang.signbit, ["torch.signbit"])
sgn = _register_elementwise("sgn", clang.sign, ["torch.sgn", "torch.Tensor.sgn"])


@torchsymbol("torch.square", method_name="square")
def square(a):
    return clang.mul(a, a)


@torchsymbol("torch.frac", method_name="frac")
def frac(a):
    return clang.sub(a, clang.trunc(a))


@torchsymbol("torch.rad2deg")
def rad2deg(a):
    return clang.mul(a, 180.0 / math.pi)


@torchsymbol("torch.deg2rad")
def deg2rad(a):
    return clang.mul(a, math.pi / 180.0)


@torchsymbol("torch.logit", "torch.special.logit")
def logit(a, eps: Optional[float] = None):
    if eps is not None:
        a = clang.clamp(a, eps, 1.0 - eps)
    return clang.log(clang.true_divide(a, clang.sub(1.0, a)))


@torchsymbol("torch.sinc", "torch.special.sinc")
def sinc(a):
    # sin(pi x)/(pi x), with the removable singularity patched at 0.
    px = clang.mul(a, math.pi)
    safe = clang.where(clang.eq(a, 0), clang.ones_like(px), px)
    return clang.where(clang.eq(a, 0), clang.ones_like(px), clang.true_divide(clang.sin(safe), safe))


@torchsymbol("torch.nan_to_num", method_name="nan_to_num")
def nan_to_num(a, nan: float = 0.0, posinf: Optional[float] = None, neginf: Optional[float] = None):
    check(isinstance(a, TensorProxy), "nan_to_num expects a tensor")
    if not dtypes.is_float_dtype(a.dtype):
        return prims.shallow_copy(a)
    if posinf is None:
        posinf = float(dtypes.finfo_max(a.dtype))
    if neginf is None:
        neginf = -float(dtypes.finfo_max(a.dtype))
    r = clang.where(clang.isnan(a), clang.full_like(a, 0.0 if nan is None else nan), a)
    r = clang.where(clang.eq(a, float("inf")), clang.full_like(a, posinf), r)
    return clang.where(clang.eq(a, float("-inf")), clang.full_like(a, neginf), r)


@torchsymbol("torch.polygamma", "torch.special.polygamma")
def polygamma(n: int, a):
    return clang.polygamma(int(pyval(n)), a)

# binary
@torchsymbol("torch.add", "torch.Tensor.add", method_name="add")
def add(a, b, *, alpha=None):
    if alpha is not None and pyval(alpha) != 1:
        b = clang.mul(b, alpha)
    return clang.add(a, b)


add_sym = add  # backwards-compatible alias


@torchsymbol("torch.sub", "torch.subtract", "torch.Tensor.sub", method_name="sub")
def sub(a, b, *, alpha=None):
    if alpha is not None and pyval(alpha) != 1:
        b = clang.mul(b, alpha)
    return clang.sub(a, b)


@torchsymbol("torch.rsub", "torch.Tensor.rsub", method_name="rsub")
def rsub(a, b, *, alpha=None):
    if alpha is not None and pyval(alpha) != 1:
        a = clang.mul(a, alpha)
    return clang.sub(b, a)


@torchsymbol("torch.div", "torch.true_divide", "torch.Tensor.div", method_name="div")
def div_sym(a, b, *, rounding_mode: Optional[str] = None):
    if rounding_mode is None:
        return clang.true_divide(a, b)
    if rounding_mode == "floor":
        return clang.floor_divide(a, b)
    check(rounding_mode == "trunc", lambda: f"Unknown rounding_mode {rounding_mode}")
    r = clang.true_divide(a, b)
    if dtypes.is_float_dtype(r.dtype):
        r = clang.trunc(r)
    from_int = all(
        not isinstance(x, TensorProxy) or dtypes.is_exact_dtype(x.dtype) for x in (a, b)
    ) and not any(isinstance(x, float) for x in (a, b) if not isinstance(x, TensorProxy))
    if from_int:
        ref = a if isinstance(a, TensorProxy) else b
        if isinstance(ref, TensorProxy) and dtypes.is_exact_dtype(ref.dtype):
            r = clang.maybe_convert_to_dtype(r, ref.dtype)
    return r


atan2 = _register_elementwise("atan2", clang.atan2, ["torch.atan2"])
bitwise_and = _register_elementwise("bitwise_and", clang.bitwise_and, ["torch.bitwise_and"])
bitwise_or = _register_elementwise("bitwise_or", clang.bitwise_or, ["torch.bitwise_or"])
bitwise_xor = _register_elementwise("bitwise_xor", clang.bitwise_xor, ["torch.bitwise_xor"])
div = div_sym
eq = _register_elementwise("eq", clang.eq, ["torch.eq"])
floor_divide = _register_elementwise("floor_divide", clang.floor_divide, ["torch.floor_divide"])
fmod = _register_elementwise("fmod", clang.fmod, ["torch.fmod"])
ge = _register_elementwise("ge", clang.ge, ["torch.ge"])
gt = _register_elementwise("gt", clang.gt, ["torch.gt"])
le = _register_elementwise("le", clang.le, ["torch.le"])
lt = _register_elementwise("lt", clang.lt, ["torch.lt"])
maximum = _register_elementwise("maximum", clang.maximum, ["torch.maximum"])
minimum = _register_elementwise("minimum", clang.minimum, ["torch.minimum"])
mul = _register_elementwise("mul", clang.mul, ["torch.mul", "torch.Tensor.mul"])
ne = _register_elementwise("ne", clang.ne, ["torch.ne"])
pow = _register_elementwise("pow", clang.pow, ["torch.pow", "torch.Tensor.pow"])
remainder = _register_elementwise("remainder", clang.remainder, ["torch.remainder"])
copysign = _register_elementwise("copysign", clang.copysign, ["torch.copysign"])
clamp = _register_elementwise("clamp", clang.clamp, ["torch.clamp", "torch.Tensor.clamp"])
clamp_min = _register_elementwise("clamp_min", lambda a, m: clang.clamp(a, m, None), ["torch.clamp_min", "torch.Tensor.clamp_min"], method="clamp_min")
clamp_max = _register_elementwise("clamp_max", lambda a, m: clang.clamp(a, None, m), ["torch.clamp_max", "torch.Tensor.clamp_max"], method="clamp_max")


@torchsymbol("torch.sigmoid", "torch.nn.functional.sigmoid", method_name="sigmoid")
def sigmoid(a):
    return clang.sigmoid(a)


@torchsymbol("torch.nn.functional.softplus")
def softplus(a, beta: float = 1.0, threshold: float = 20.0):
    scaled = clang.mul(a, beta)
    soft = clang.true_divide(clang.log1p(clang.exp(scaled)), beta)
    return clang.where(clang.gt(scaled, threshold), a, soft)


# =============================================================================
# Activations
# =============================================================================


@torchsymbol("torch.nn.functional.relu", method_name="relu")
def relu(a, inplace: bool = False):
    return clang.maximum(a, 0)


@torchsymbol("torch.nn.functional.leaky_relu")
def leaky_relu(a, negative_slope: float = 0.01, inplace: bool = False):
    return clang.where(clang.gt(a, 0), a, clang.mul(a, negative_slope))


@torchsymbol("torch.nn.functional.elu")
def elu(a, alpha: float = 1.0, inplace: bool = False):
    return clang.where(clang.gt(a, 0), a, clang.mul(alpha, clang.expm1(a)))


@torchsymbol("torch.nn.functional.gelu")
def gelu(a, approximate: str = "none"):
    if approximate == "tanh":
        inner = clang.mul(math.sqrt(2.0 / math.pi), clang.add(a, clang.mul(0.044715, clang.mul(a, clang.mul(a, a)))))
        return clang.mul(clang.mul(0.5, a), clang.add(1.0, clang.tanh(inner)))
    return clang.mul(clang.mul(0.5, a), clang.add(1.0, clang.erf(clang.mul(a, 1.0 / math.sqrt(2.0)))))


@torchsymbol("torch.nn.functional.silu")
def silu(a, inplace: bool = False):
    return clang.mul(a, sigmoid(a))


@torchsymbol("torch.nn.functional.mish")
def mish(a, inplace: bool = False):
    return clang.mul(a, clang.tanh(softplus(a)))


@torchsymbol("torch.nn.functional.hardswish")
def hardswish(a, inplace: bool = False):
    return clang.mul(a, clang.true_divide(clang.clamp(clang.add(a, 3.0), 0.0, 6.0), 6.0))


@torchsymbol("torch.softmax", "torch.nn.functional.softmax", method_name="softmax")
def softmax(a, dim: int, dtype=None, _stacklevel=3):
    # _stacklevel: torch-internal deprecation-warning plumbing
    # (F.softmax passes it through HF's T5 attention); accepted + ignored.
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    if dtype is not None:
        a = clang.maybe_convert_to_dtype(a, to_dtype(dtype))
    shifted = clang.sub(a, clang.amax(a, (d,), True))
    e = clang.exp(shifted)
    return clang.true_divide(e, clang.sum(e, (d,), True))


@torchsymbol("torch.log_softmax", "torch.nn.functional.log_softmax", method_name="log_softmax")
def log_softmax(a, dim: int, dtype=None, _stacklevel=3):
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    if dtype is not None:
        a = clang.maybe_convert_to_dtype(a, to_dtype(dtype))
    shifted = clang.sub(a, clang.amax(a, (d,), True))
    return clang.sub(shifted, clang.log(clang.sum(clang.exp(shifted), (d,), True)))


# =============================================================================
# Reductions
# =============================================================================


@torchsymbol("torch.sum", method_name="sum")
def sum(a, dim=None, keepdim: bool = False, *, dtype=None):
    return clang.sum(a, _dim_seq(dim), keepdim, dtype=to_dtype(dtype))


@torchsymbol("torch.mean", method_name="mean")
def mean(a, dim=None, keepdim: bool = False, *, dtype=None):
    return clang.mean(a, _dim_seq(dim), keepdim, dtype=to_dtype(dtype))


@torchsymbol("torch.prod", method_name="prod")
def prod(a, dim=None, keepdim: bool = False, *, dtype=None):
    r = clang.prod(a, _dim_seq(dim), keepdim)
    if dtype is not None:
        r = clang.maybe_convert_to_dtype(r, to_dtype(dtype))
    return r


@torchsymbol("torch.amax", method_name="amax")
def amax(a, dim=None, keepdim: bool = False):
    return clang.amax(a, _dim_seq(dim), keepdim)


@torchsymbol("torch.amin", method_name="amin")
def amin(a, dim=None, keepdim: bool = False):
    return clang.amin(a, _dim_seq(dim), keepdim)


@torchsymbol("torch.max", method_name="max")
def max(a, dim=None, keepdim: bool = False):
    if isinstance(dim, TensorProxy):
        return clang.maximum(a, dim)
    if dim is None:
        return clang.amax(a, None, False)
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    return clang.amax(a, (d,), keepdim), clang.argmax(a, d, keepdim)


@torchsymbol("torch.min", method_name="min")
def min(a, dim=None, keepdim: bool = False):
    if isinstance(dim, TensorProxy):
        return clang.minimum(a, dim)
    if dim is None:
        return clang.amin(a, None, False)
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    return clang.amin(a, (d,), keepdim), clang.argmin(a, d, keepdim)


@torchsymbol("torch.argmax", method_name="argmax")
def argmax(a, dim=None, keepdim: bool = False):
    return clang.argmax(a, dim if dim is None else int(pyval(dim)), keepdim)


@torchsymbol("torch.argmin", method_name="argmin")
def argmin(a, dim=None, keepdim: bool = False):
    return clang.argmin(a, dim if dim is None else int(pyval(dim)), keepdim)


@torchsymbol("torch.var", method_name="var")
def var(a, dim=None, *, correction: Number = 1, keepdim: bool = False):
    return clang.var(a, _dim_seq(dim), correction=correction, keepdim=keepdim)


@torchsymbol("torch.var_mean")
def var_mean(a, dim=None, *, correction: Number = 1, keepdim: bool = False):
    return clang.var_mean(a, _dim_seq(dim), correction=correction, keepdim=keepdim)


@torchsymbol("torch.std", method_name="std")
def std(a, dim=None, *, correction: Number = 1, keepdim: bool = False):
    return clang.std(a, _dim_seq(dim), correction=correction, keepdim=keepdim)


@torchsymbol("torch.all", method_name="all")
def all(a, dim=None, keepdim: bool = False):
    return clang.all_tensor(a, _dim_seq(dim), keepdim)


@torchsymbol("torch.any", method_name="any")
def any(a, dim=None, keepdim: bool = False):
    return clang.any_tensor(a, _dim_seq(dim), keepdim)


# =============================================================================
# Linear algebra / NN ops
# =============================================================================


@torchsymbol("torch.matmul", method_name="matmul")
def matmul(a, b):
    return clang.matmul(a, b)


@torchsymbol("torch.bmm", method_name="bmm")
def bmm(a, b):
    check(a.ndim == 3 and b.ndim == 3, "bmm requires rank-3 tensors")
    return clang.matmul(a, b)


@torchsymbol("torch.nn.functional.linear")
def linear(a, w, bias=None):
    return clang.linear(a, w, bias)


@torchsymbol("torch.outer", method_name="outer")
def outer(a, b):
    check(a.ndim == 1 and b.ndim == 1, "outer requires rank-1 tensors")
    return clang.mul(clang.unsqueeze(a, 1), clang.unsqueeze(b, 0))


@torchsymbol("torch.einsum")
def einsum(equation: str, *operands):
    """Einstein summation decomposed to transpose/reshape/matmul prims (so
    the contraction is one matrix product). Supports 1-2 operands, no repeated
    indices within an operand; '...' broadcasting is not supported yet."""
    if len(operands) == 1 and isinstance(operands[0], (tuple, list)):
        operands = tuple(operands[0])
    check("..." not in equation, "einsum ellipsis is not supported yet")
    eq = equation.replace(" ", "")
    if "->" in eq:
        lhs, out_spec = eq.split("->")
    else:
        lhs = eq
        # implicit output: non-repeated indices, sorted
        counts: dict[str, int] = {}
        for ch in lhs.replace(",", ""):
            counts[ch] = counts.get(ch, 0) + 1
        out_spec = "".join(sorted(ch for ch, n in counts.items() if n == 1))
    specs = lhs.split(",")
    check(len(specs) == len(operands), "einsum operand count mismatch")
    check(len(operands) in (1, 2), "einsum supports 1 or 2 operands")

    if len(operands) == 1:
        (spec,), (a,) = specs, operands
        check(len(set(spec)) == len(spec), "repeated in-operand indices unsupported")
        # sum out dims absent from output, then permute
        sum_dims = tuple(i for i, ch in enumerate(spec) if ch not in out_spec)
        if sum_dims:
            a = clang.sum(a, sum_dims)
            spec = "".join(ch for ch in spec if ch in out_spec)
        perm = tuple(spec.index(ch) for ch in out_spec)
        return clang.permute(a, perm) if perm != tuple(range(len(perm))) else a

    sa, sb = specs
    a, b = operands
    check(len(set(sa)) == len(sa) and len(set(sb)) == len(sb),
          "repeated in-operand indices unsupported")
    # classify indices
    batch = [ch for ch in sa if ch in sb and ch in out_spec]
    contract = [ch for ch in sa if ch in sb and ch not in out_spec]
    free_a = [ch for ch in sa if ch not in sb]
    free_b = [ch for ch in sb if ch not in sa]
    # sum out indices appearing in only one operand and not the output
    pre_a = tuple(i for i, ch in enumerate(sa) if ch in free_a and ch not in out_spec)
    if pre_a:
        a = clang.sum(a, pre_a)
        sa = "".join(ch for i, ch in enumerate(sa) if i not in pre_a)
        free_a = [ch for ch in free_a if ch in sa]
    pre_b = tuple(i for i, ch in enumerate(sb) if ch in free_b and ch not in out_spec)
    if pre_b:
        b = clang.sum(b, pre_b)
        sb = "".join(ch for i, ch in enumerate(sb) if i not in pre_b)
        free_b = [ch for ch in free_b if ch in sb]

    def dims_of(spec, chs):
        return {ch: spec.index(ch) for ch in chs}

    da, db = dims_of(sa, sa), dims_of(sb, sb)
    size = {}
    for spec, op in ((sa, a), (sb, b)):
        for i, ch in enumerate(spec):
            size[ch] = op.shape[i]

    def prod(chs):
        n = 1
        for ch in chs:
            n *= size[ch]
        return n

    # a → (batch, free_a, contract); b → (batch, contract, free_b)
    a_perm = tuple(da[ch] for ch in batch + free_a + contract)
    b_perm = tuple(db[ch] for ch in batch + contract + free_b)
    a2 = clang.reshape(clang.permute(a, a_perm), (prod(batch), prod(free_a), prod(contract)))
    b2 = clang.reshape(clang.permute(b, b_perm), (prod(batch), prod(contract), prod(free_b)))
    o = clang.matmul(a2, b2)  # (batch, free_a, free_b)
    o = clang.reshape(o, tuple(size[ch] for ch in batch) + tuple(size[ch] for ch in free_a)
                      + tuple(size[ch] for ch in free_b))
    cur = batch + free_a + free_b
    perm = tuple(cur.index(ch) for ch in out_spec)
    return clang.permute(o, perm) if perm != tuple(range(len(perm))) else o


@torchsymbol("torch.nn.functional.embedding")
def embedding(indices, weight, padding_idx=None, max_norm=None, norm_type: float = 2.0,
              scale_grad_by_freq: bool = False, sparse: bool = False):
    check(max_norm is None, "embedding max_norm is not supported")
    check(weight.ndim == 2, lambda: f"embedding weight must be rank 2, got shape {tuple(weight.shape)}")
    return clang.embedding(indices, weight)


@torchsymbol("torch.nn.functional.conv1d")
def conv1d(a, weight, bias=None, stride=1, padding=0, dilation=1, groups: int = 1):
    return _convnd(a, weight, bias, stride, padding, dilation, groups, 1)


@torchsymbol("torch.nn.functional.conv2d")
def conv2d(a, weight, bias=None, stride=1, padding=0, dilation=1, groups: int = 1):
    return _convnd(a, weight, bias, stride, padding, dilation, groups, 2)


@torchsymbol("torch.nn.functional.conv3d")
def conv3d(a, weight, bias=None, stride=1, padding=0, dilation=1, groups: int = 1):
    return _convnd(a, weight, bias, stride, padding, dilation, groups, 3)


def _convnd(a, weight, bias, stride, padding, dilation, groups, spatial):
    def _seq(x):
        return (x,) * spatial if isinstance(x, (int, NumberProxy)) else tuple(x)

    return clang.convolution(a, weight, bias, _seq(stride), _seq(padding), _seq(dilation), groups)


# =============================================================================
# Normalization
# =============================================================================


@torchsymbol("torch.nn.functional.layer_norm")
def layer_norm(a, normalized_shape, weight=None, bias=None, eps: float = 1e-5):
    n = len(tuple(normalized_shape))
    dims = tuple(range(a.ndim - n, a.ndim))
    # Compute statistics in f32 for bf16 inputs (torch's mixed-precision
    # layer_norm semantics).
    compute_dtype = dtypes.float32 if a.dtype in (dtypes.bfloat16, dtypes.float16) else a.dtype
    x = clang.maybe_convert_to_dtype(a, compute_dtype)
    v, m = clang.var_mean(x, dims, correction=0, keepdim=True)
    normed = clang.mul(clang.sub(x, m), clang.rsqrt(clang.add(v, eps)))
    normed = clang.maybe_convert_to_dtype(normed, a.dtype)
    if weight is not None:
        normed = clang.mul(normed, weight)
    if bias is not None:
        normed = clang.add(normed, bias)
    return normed


@torchsymbol("torch.nn.functional.rms_norm")
def rms_norm(a, normalized_shape, weight=None, eps: Optional[float] = None):
    if eps is None:
        eps = 1e-6
    n = len(tuple(normalized_shape))
    dims = tuple(range(a.ndim - n, a.ndim))
    compute_dtype = dtypes.float32 if a.dtype in (dtypes.bfloat16, dtypes.float16) else a.dtype
    x = clang.maybe_convert_to_dtype(a, compute_dtype)
    ms = clang.mean(clang.mul(x, x), dims, True)
    normed = clang.mul(x, clang.rsqrt(clang.add(ms, eps)))
    normed = clang.maybe_convert_to_dtype(normed, a.dtype)
    if weight is not None:
        normed = clang.mul(normed, weight)
    return normed


@torchsymbol("torch.nn.functional.group_norm")
def group_norm(a, num_groups: int, weight=None, bias=None, eps: float = 1e-5):
    check(a.ndim >= 2, "group_norm requires rank >= 2")
    N, C = a.shape[0], a.shape[1]
    check(C % num_groups == 0, "channels must divide num_groups")
    spatial = a.shape[2:]
    x = clang.reshape(a, (N, num_groups, C // num_groups) + tuple(spatial))
    dims = tuple(range(2, x.ndim))
    v, m = clang.var_mean(x, dims, correction=0, keepdim=True)
    normed = clang.mul(clang.sub(x, m), clang.rsqrt(clang.add(v, eps)))
    normed = clang.reshape(normed, tuple(a.shape))
    shape = (1, C) + (1,) * len(spatial)
    if weight is not None:
        normed = clang.mul(normed, clang.reshape(weight, shape))
    if bias is not None:
        normed = clang.add(normed, clang.reshape(bias, shape))
    return normed


# =============================================================================
# Dropout and losses
# =============================================================================


@torchsymbol("torch.nn.functional.dropout")
def dropout(a, p: float = 0.5, training: bool = True, inplace: bool = False):
    p = float(pyval(p))
    if not training or p == 0.0:
        return a
    check(0.0 <= p < 1.0, lambda: f"dropout p must be in [0, 1), got {p}")
    mask = clang.lt(clang.uniform(a.shape, 0.0, 1.0, device=a.device, dtype=a.dtype), 1.0 - p)
    return clang.mul(clang.where(mask, a, clang.zeros_like(a)), 1.0 / (1.0 - p))


@torchsymbol("torch.nn.functional.cross_entropy")
def cross_entropy(input, target, weight=None, ignore_index: int = -100, reduction: str = "mean",
                  label_smoothing: float = 0.0):
    """Fused-friendly cross-entropy: log_softmax + gather. Kept composite so
    the CE executor (executors/fusedex.py) can claim it whole (reference: the Triton/Apex
    cross-entropy executor seats, thunder/executors/triton_crossentropy.py)."""
    check(input.ndim == 2, "cross_entropy expects (N, C) logits (flatten upstream)")
    check(target.ndim == 1, "cross_entropy expects (N,) integer targets")
    check(weight is None, "cross_entropy class weights not supported yet")
    N, C = input.shape
    logp = log_softmax(input, 1)
    picked = clang.squeeze(clang.take_along_axis(logp, clang.reshape(clang.maximum(target, 0), (N, 1)), 1), (1,))
    nll = clang.neg(picked)
    if label_smoothing > 0.0:
        smooth = clang.neg(clang.mean(logp, (1,)))
        nll = clang.add(clang.mul(nll, 1.0 - label_smoothing), clang.mul(smooth, label_smoothing))
    valid = clang.ne(target, ignore_index)
    nll = clang.where(valid, nll, clang.zeros_like(nll))
    if reduction == "none":
        return nll
    total = clang.sum(nll, None)
    if reduction == "sum":
        return total
    count = clang.sum(clang.maybe_convert_to_dtype(valid, nll.dtype), None)
    return clang.true_divide(total, clang.maximum(count, 1.0))


@torchsymbol("torch.nn.functional.nll_loss")
def nll_loss(input, target, weight=None, ignore_index: int = -100, reduction: str = "mean"):
    check(input.ndim == 2 and target.ndim == 1, "nll_loss expects (N, C) and (N,)")
    check(weight is None, "nll_loss class weights not supported yet")
    N, C = input.shape
    picked = clang.squeeze(clang.take_along_axis(input, clang.reshape(clang.maximum(target, 0), (N, 1)), 1), (1,))
    nll = clang.neg(picked)
    valid = clang.ne(target, ignore_index)
    nll = clang.where(valid, nll, clang.zeros_like(nll))
    if reduction == "none":
        return nll
    total = clang.sum(nll, None)
    if reduction == "sum":
        return total
    count = clang.sum(clang.maybe_convert_to_dtype(valid, nll.dtype), None)
    return clang.true_divide(total, clang.maximum(count, 1.0))


@torchsymbol("torch.nn.functional.mse_loss")
def mse_loss(input, target, reduction: str = "mean"):
    d = clang.sub(input, target)
    sq = clang.mul(d, d)
    if reduction == "none":
        return sq
    if reduction == "sum":
        return clang.sum(sq, None)
    return clang.mean(sq, None)


# =============================================================================
# Attention
# =============================================================================


@torchsymbol("torch.nn.functional.scaled_dot_product_attention")
def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p: float = 0.0,
                                 is_causal: bool = False, scale: Optional[float] = None,
                                 enable_gqa: bool = False):
    """SDPA over (..., H, S, E) — decomposes to matmul/softmax/matmul; kept
    composite so the flash-attention executor claims it whole
    (reference: the cudnnex/sdpaex executor seats)."""
    check(dropout_p == 0.0, "sdpa dropout is not supported yet")
    E = query.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(E)

    if enable_gqa and key.shape[-3] != query.shape[-3]:
        rep = query.shape[-3] // key.shape[-3]
        key = repeat_interleave(key, rep, -3)
        value = repeat_interleave(value, rep, -3)

    # Attention scores in f32 for bf16 inputs: softmax accumulates in f32;
    # the two matmuls stay bf16.
    q = clang.mul(query, scale)
    scores = clang.matmul(q, clang.transpose(key, -2, -1))
    scores = clang.maybe_convert_to_dtype(scores, dtypes.float32)

    S, L = query.shape[-2], key.shape[-2]
    if is_causal:
        check(attn_mask is None, "is_causal and attn_mask are mutually exclusive")
        mask = clang.diagonal_mask(S, L, offset=L - S, upper=False, device=query.device)
        scores = clang.where(clang.expand_to(mask, scores.shape), scores, clang.full_like(scores, -float("inf")))
    elif attn_mask is not None:
        if dtypes.is_boolean_dtype(attn_mask.dtype):
            scores = clang.where(clang.expand_to(attn_mask, scores.shape), scores,
                                 clang.full_like(scores, -float("inf")))
        else:
            scores = clang.add(scores, clang.maybe_convert_to_dtype(attn_mask, dtypes.float32))

    probs = _safe_softmax(scores)
    probs = clang.maybe_convert_to_dtype(probs, value.dtype)
    return clang.matmul(probs, value)


def _safe_softmax(scores):
    """torch-sdpa semantics: a fully-masked row (all -inf) produces ZEROS,
    not NaN (torch's math backend safe-softmax) — without this, padding
    rows poison later layers through 0·NaN products."""
    row_max = clang.amax(scores, (-1,), True)
    probs = softmax(scores, -1)
    dead = clang.eq(row_max, -float("inf"))
    return clang.where(clang.expand_to(dead, probs.shape), clang.full_like(probs, 0.0), probs)


# =============================================================================
# Backward composites (claimable by fast executors; decompose for fallback)
# =============================================================================


@torchsymbol(id="torch.sdpa_bwd")
def sdpa_bwd(g, query, key, value, attn_mask=None, is_causal: bool = False,
             scale: Optional[float] = None, enable_gqa: bool = False):
    """(dq, dk, dv) of causal/masked/plain SDPA by recompute — the flash
    executor replaces this whole op with a flash-attention backward
    (reference analogue: cudnnex's sdpa backward graph, cudnnex.py:375,
    which likewise takes the attn-mask bias as an input)."""
    E = query.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(E)
    H = query.shape[-3]
    G = key.shape[-3]

    k, v = key, value
    if enable_gqa and G != H:
        rep = H // G
        k = repeat_interleave(k, rep, -3)
        v = repeat_interleave(v, rep, -3)

    qf = clang.maybe_convert_to_dtype(query, dtypes.float32)
    kf = clang.maybe_convert_to_dtype(k, dtypes.float32)
    vf = clang.maybe_convert_to_dtype(v, dtypes.float32)
    gf = clang.maybe_convert_to_dtype(g, dtypes.float32)

    s = clang.mul(clang.matmul(qf, clang.transpose(kf, -2, -1)), scale)
    S, L = query.shape[-2], key.shape[-2]
    if is_causal:
        cmask = clang.diagonal_mask(S, L, offset=L - S, upper=False, device=query.device)
        s = clang.where(clang.expand_to(cmask, s.shape), s, clang.full_like(s, -float("inf")))
    elif attn_mask is not None:
        if dtypes.is_boolean_dtype(attn_mask.dtype):
            s = clang.where(clang.expand_to(attn_mask, s.shape), s, clang.full_like(s, -float("inf")))
        else:
            s = clang.add(s, clang.maybe_convert_to_dtype(attn_mask, dtypes.float32))
    p = _safe_softmax(s)

    dv = clang.matmul(clang.transpose(p, -2, -1), gf)
    dp = clang.matmul(gf, clang.transpose(vf, -2, -1))
    ds = clang.mul(p, clang.sub(dp, clang.sum(clang.mul(dp, p), (-1,), True)))
    dq = clang.mul(clang.matmul(ds, kf), scale)
    dk = clang.mul(clang.matmul(clang.transpose(ds, -2, -1), qf), scale)

    if enable_gqa and G != H:
        rep = H // G
        bshape = tuple(dk.shape[:-3])
        dk = clang.sum(clang.reshape(dk, bshape + (G, rep) + tuple(dk.shape[-2:])), (len(bshape) + 1,))
        dv = clang.sum(clang.reshape(dv, bshape + (G, rep) + tuple(dv.shape[-2:])), (len(bshape) + 1,))

    dq = clang.maybe_convert_to_dtype(dq, query.dtype)
    dk = clang.maybe_convert_to_dtype(dk, key.dtype)
    dv = clang.maybe_convert_to_dtype(dv, value.dtype)
    return dq, dk, dv


@torchsymbol(id="torch.layer_norm_bwd")
def layer_norm_bwd(g, a, weight, bias, eps: float):
    """(dx, dw, db) of last-dim LayerNorm — composite for the fused-norm
    executor (reference seat: cudnn_layernormex.py:134)."""
    compute_dtype = dtypes.float32 if a.dtype in (dtypes.bfloat16, dtypes.float16) else a.dtype
    xf = clang.maybe_convert_to_dtype(a, compute_dtype)
    gf = clang.maybe_convert_to_dtype(g, compute_dtype)
    v, mu = clang.var_mean(xf, (-1,), correction=0, keepdim=True)
    rstd = clang.rsqrt(clang.add(v, eps))
    xhat = clang.mul(clang.sub(xf, mu), rstd)
    wg = gf if weight is None else clang.mul(gf, clang.maybe_convert_to_dtype(weight, compute_dtype))
    m1 = clang.mean(wg, (-1,), True)
    m2 = clang.mean(clang.mul(wg, xhat), (-1,), True)
    dx = clang.mul(rstd, clang.sub(clang.sub(wg, m1), clang.mul(xhat, m2)))
    dx = clang.maybe_convert_to_dtype(dx, a.dtype)
    red_dims = tuple(range(a.ndim - 1))
    dw = db = None
    if weight is not None:
        dw = clang.maybe_convert_to_dtype(
            clang.sum(clang.mul(gf, xhat), red_dims) if red_dims else clang.mul(gf, xhat),
            weight.dtype,
        )
    if bias is not None:
        db = clang.maybe_convert_to_dtype(
            clang.sum(gf, red_dims) if red_dims else gf, bias.dtype
        )
    return dx, dw, db


@torchsymbol(id="torch.rms_norm_bwd")
def rms_norm_bwd(g, a, weight, eps: float):
    """(dx, dw) of last-dim RMSNorm — kept composite so a fused
    norm kernel claims it whole (reference seat: the cudnn fused-norm
    executor, cudnn_layernormex.py:134)."""
    D = a.shape[-1]
    compute_dtype = dtypes.float32 if a.dtype in (dtypes.bfloat16, dtypes.float16) else a.dtype
    xf = clang.maybe_convert_to_dtype(a, compute_dtype)
    gf = clang.maybe_convert_to_dtype(g, compute_dtype)
    ms = clang.mean(clang.mul(xf, xf), (-1,), True)
    rstd = clang.rsqrt(clang.add(ms, eps))
    xhat = clang.mul(xf, rstd)
    wg = gf if weight is None else clang.mul(gf, clang.maybe_convert_to_dtype(weight, compute_dtype))
    dot = clang.mean(clang.mul(wg, xhat), (-1,), True)
    dx = clang.mul(rstd, clang.sub(wg, clang.mul(xhat, dot)))
    dx = clang.maybe_convert_to_dtype(dx, a.dtype)
    if weight is None:
        return dx, None
    red_dims = tuple(range(a.ndim - 1))
    dw = clang.sum(clang.mul(gf, xhat), red_dims) if red_dims else clang.mul(gf, xhat)
    dw = clang.maybe_convert_to_dtype(dw, weight.dtype)
    return dx, dw


@torchsymbol(id="torch.apply_rope")
def apply_rope(x, cos, sin):
    """Rotate-half rotary embedding over the last dim (HF NeoX/Llama
    convention; litgpt ``apply_rope``): x (..., T, hs), cos/sin (T, n) with
    n ≤ hs built as cat([freqs, freqs]) — features beyond n pass through.

    Kept composite so the rope kernel (executors/fusedex.py) claims it
    whole: the decomposed rotate-half is two half-width slices and a concat,
    each a pass over the tensor."""
    n = cos.shape[-1]
    half = n // 2
    rot = x[..., :n] if n != x.shape[-1] else x
    x1 = rot[..., :half]
    x2 = rot[..., half:]
    rotated = cat([-x2, x1], dim=-1)
    roped = rot * cos + rotated * sin
    if n == x.shape[-1]:
        return roped
    return cat([roped, x[..., n:]], dim=-1)


@torchsymbol(id="torch.sdpa_fwd_res")
def sdpa_fwd_res(query, key, value, attn_mask=None, is_causal: bool = False,
                 scale: Optional[float] = None, enable_gqa: bool = False):
    """SDPA returning ``(out, lse)`` where lse is the per-row logsumexp of
    the scaled (masked) scores, f32 of shape (..., H, Sq).

    This is the augmented forward the attention-residual pass
    (transforms/attention_residuals.py) swaps in so the flash backward can
    run from saved residuals instead of recomputing the forward kernel —
    the reference's cudnnex saves exactly this softmax_stats tensor between
    its fwd and bwd graphs (cudnnex.py:375)."""
    E = query.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(E)
    H = query.shape[-3]
    G = key.shape[-3]
    k, v = key, value
    if enable_gqa and G != H:
        rep = H // G
        k = repeat_interleave(k, rep, -3)
        v = repeat_interleave(v, rep, -3)

    s = clang.matmul(clang.mul(query, scale), clang.transpose(k, -2, -1))
    s = clang.maybe_convert_to_dtype(s, dtypes.float32)
    S, L = query.shape[-2], key.shape[-2]
    if is_causal:
        cmask = clang.diagonal_mask(S, L, offset=L - S, upper=False, device=query.device)
        s = clang.where(clang.expand_to(cmask, s.shape), s, clang.full_like(s, -float("inf")))
    elif attn_mask is not None:
        if dtypes.is_boolean_dtype(attn_mask.dtype):
            s = clang.where(clang.expand_to(attn_mask, s.shape), s, clang.full_like(s, -float("inf")))
        else:
            s = clang.add(s, clang.maybe_convert_to_dtype(attn_mask, dtypes.float32))
    m = clang.amax(s, (-1,), True)
    lse = clang.add(clang.log(clang.sum(clang.exp(clang.sub(s, m)), (-1,), True)), m)
    p = clang.exp(clang.sub(s, lse))
    dead = clang.eq(m, -float("inf"))
    p = clang.where(clang.expand_to(dead, p.shape), clang.full_like(p, 0.0), p)
    out = clang.matmul(clang.maybe_convert_to_dtype(p, value.dtype), v)
    return out, clang.squeeze(lse, (lse.ndim - 1,))


@torchsymbol(id="torch.sdpa_bwd_res")
def sdpa_bwd_res(g, query, key, value, out, lse, attn_mask=None, is_causal: bool = False,
                 scale: Optional[float] = None, enable_gqa: bool = False):
    """(dq, dk, dv) from saved residuals: probabilities are reconstructed as
    exp(s − lse) instead of a fresh softmax — one reduction cheaper, and the
    form the flash backward kernels consume (reference: cudnnex.py:375 feeds
    its bwd graph the saved softmax stats)."""
    E = query.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(E)
    H = query.shape[-3]
    G = key.shape[-3]
    k, v = key, value
    if enable_gqa and G != H:
        rep = H // G
        k = repeat_interleave(k, rep, -3)
        v = repeat_interleave(v, rep, -3)

    qf = clang.maybe_convert_to_dtype(query, dtypes.float32)
    kf = clang.maybe_convert_to_dtype(k, dtypes.float32)
    vf = clang.maybe_convert_to_dtype(v, dtypes.float32)
    gf = clang.maybe_convert_to_dtype(g, dtypes.float32)

    s = clang.mul(clang.matmul(qf, clang.transpose(kf, -2, -1)), scale)
    S, L = query.shape[-2], key.shape[-2]
    if is_causal:
        cmask = clang.diagonal_mask(S, L, offset=L - S, upper=False, device=query.device)
        s = clang.where(clang.expand_to(cmask, s.shape), s, clang.full_like(s, -float("inf")))
    elif attn_mask is not None:
        if dtypes.is_boolean_dtype(attn_mask.dtype):
            s = clang.where(clang.expand_to(attn_mask, s.shape), s, clang.full_like(s, -float("inf")))
        else:
            s = clang.add(s, clang.maybe_convert_to_dtype(attn_mask, dtypes.float32))
    lse_col = clang.unsqueeze(lse, lse.ndim)
    p = clang.exp(clang.sub(s, clang.maybe_convert_to_dtype(lse_col, dtypes.float32)))

    dv = clang.matmul(clang.transpose(p, -2, -1), gf)
    dp = clang.matmul(gf, clang.transpose(vf, -2, -1))
    # di = rowsum(dout * out) == rowsum(dp * p); the saved-out form avoids
    # materializing dp*p twice
    di = clang.sum(clang.mul(gf, clang.maybe_convert_to_dtype(out, dtypes.float32)), (-1,), True)
    ds = clang.mul(p, clang.sub(dp, di))
    dq = clang.mul(clang.matmul(ds, kf), scale)
    dk = clang.mul(clang.matmul(clang.transpose(ds, -2, -1), qf), scale)

    if enable_gqa and G != H:
        rep = H // G
        bshape = tuple(dk.shape[:-3])
        dk = clang.sum(clang.reshape(dk, bshape + (G, rep) + tuple(dk.shape[-2:])), (len(bshape) + 1,))
        dv = clang.sum(clang.reshape(dv, bshape + (G, rep) + tuple(dv.shape[-2:])), (len(bshape) + 1,))

    dq = clang.maybe_convert_to_dtype(dq, query.dtype)
    dk = clang.maybe_convert_to_dtype(dk, key.dtype)
    dv = clang.maybe_convert_to_dtype(dv, value.dtype)
    return dq, dk, dv


@torchsymbol(id="torch.cross_entropy_bwd")
def cross_entropy_bwd(g, input, target, ignore_index: int = -100, reduction: str = "mean"):
    """dlogits of fused cross-entropy: (softmax − onehot) · g/count. The
    CE executor replaces this whole op (reference analogue: the Triton
    CE backward kernels, triton_crossentropy.py:270,343)."""
    N, C = input.shape
    p = softmax(clang.maybe_convert_to_dtype(input, dtypes.float32), 1)
    cols = clang.expand_to(clang.arange(0, C, 1, device=input.device, dtype=dtypes.int64), (N, C))
    onehot = clang.maybe_convert_to_dtype(clang.eq(cols, clang.unsqueeze(clang.maximum(target, 0), 1)),
                                          dtypes.float32)
    valid = clang.ne(target, ignore_index)
    validf = clang.maybe_convert_to_dtype(valid, dtypes.float32)
    if reduction == "mean":
        count = clang.maximum(clang.sum(validf, None), 1.0)
        row_scale = clang.true_divide(clang.mul(g, validf), count)
    else:  # sum
        row_scale = clang.mul(g, validf)
    d = clang.mul(clang.sub(p, onehot), clang.unsqueeze(row_scale, 1))
    return clang.maybe_convert_to_dtype(d, input.dtype)


# The VJP rules of the composites above (sdpa, cross_entropy, the norms,
# apply_rope) register with the autodiff transform, which comes with the
# training slice of the port (ROADMAP.md).


# =============================================================================
# Additional binary / ternary ops
# =============================================================================


@torchsymbol("torch.logaddexp")
def logaddexp(a, b):
    m = clang.maximum(a, b)
    d = clang.neg(clang.abs(clang.sub(a, b)))
    r = clang.add(m, clang.log1p(clang.exp(d)))
    # When both are -inf the max is -inf and the sum is -inf, not nan.
    return clang.where(clang.isinf(m), m, r)


@torchsymbol("torch.logaddexp2")
def logaddexp2(a, b):
    ln2 = math.log(2.0)
    return clang.mul(logaddexp(clang.mul(a, ln2), clang.mul(b, ln2)), 1.0 / ln2)


@torchsymbol("torch.hypot")
def hypot(a, b):
    return clang.sqrt(clang.add(clang.mul(a, a), clang.mul(b, b)))


@torchsymbol("torch.logical_and", method_name="logical_and")
def logical_and(a, b):
    return clang.logical_and(a, b)


@torchsymbol("torch.logical_or", method_name="logical_or")
def logical_or(a, b):
    return clang.logical_or(a, b)


@torchsymbol("torch.logical_xor", method_name="logical_xor")
def logical_xor(a, b):
    ba = clang.ne(a, 0) if not dtypes.is_boolean_dtype(a.dtype) else a
    bb = clang.ne(b, 0) if not dtypes.is_boolean_dtype(b.dtype) else b
    return clang.ne(ba, bb)


@torchsymbol("torch.xlogy", "torch.special.xlogy")
def xlogy(a, b):
    safe = clang.where(clang.eq(a, 0), clang.ones_like(b), b)
    return clang.where(clang.eq(a, 0), clang.zeros_like(clang.mul(a, b)), clang.mul(a, clang.log(safe)))


@torchsymbol("torch.addcmul", method_name="addcmul")
def addcmul(a, t1, t2, *, value=1):
    prod_ = clang.mul(t1, t2)
    if pyval(value) != 1:
        prod_ = clang.mul(prod_, value)
    return clang.add(a, prod_)


@torchsymbol("torch.addcdiv", method_name="addcdiv")
def addcdiv(a, t1, t2, *, value=1):
    q = clang.true_divide(t1, t2)
    if pyval(value) != 1:
        q = clang.mul(q, value)
    return clang.add(a, q)


@torchsymbol("torch.lerp", method_name="lerp")
def lerp(start, end, weight):
    return clang.add(start, clang.mul(clang.sub(end, start), weight))


@torchsymbol("torch.isclose", method_name="isclose")
def isclose(a, b, rtol: float = 1e-5, atol: float = 1e-8, equal_nan: bool = False):
    close = clang.le(clang.abs(clang.sub(a, b)), clang.add(atol, clang.mul(rtol, clang.abs(b))))
    if equal_nan:
        close = clang.logical_or(close, clang.logical_and(clang.isnan(a), clang.isnan(b)))
    return close


@torchsymbol("torch.heaviside")
def heaviside(a, values):
    zero = clang.zeros_like(a)
    one = clang.ones_like(a)
    return clang.where(clang.gt(a, 0), one, clang.where(clang.lt(a, 0), zero, values))


# =============================================================================
# Additional shape / indexing ops
# =============================================================================


@torchsymbol("torch.narrow", method_name="narrow")
def narrow(a, dim: int, start: int, length: int):
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    s = int(pyval(start))
    if s < 0:
        s += a.shape[d]
    return clang.slice_in_dim(a, s, s + int(pyval(length)), dim=d)


@torchsymbol("torch.select", method_name="select")
def select(a, dim: int, index: int):
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    i = int(pyval(index))
    if i < 0:
        i += a.shape[d]
    return clang.squeeze(clang.slice_in_dim(a, i, i + 1, dim=d), (d,))


@torchsymbol("torch.unbind", method_name="unbind")
def unbind(a, dim: int = 0):
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    return tuple(select(a, d, i) for i in range(a.shape[d]))


@torchsymbol("torch.roll", method_name="roll")
def roll(a, shifts, dims=None):
    shifts = (int(pyval(shifts)),) if isinstance(shifts, (int, NumberProxy)) else tuple(int(pyval(s)) for s in shifts)
    if dims is None:
        check(len(shifts) == 1, "roll without dims takes a single shift")
        flat = flatten(a)
        return reshape(roll(flat, shifts, (0,)), tuple(a.shape))
    dims = (int(pyval(dims)),) if isinstance(dims, (int, NumberProxy)) else tuple(int(pyval(d)) for d in dims)
    check(len(shifts) == len(dims), "roll shifts/dims length mismatch")
    r = a
    for s, d in zip(shifts, dims):
        d = canonicalize_dim(r.ndim, d)
        n = r.shape[d]
        if n == 0:
            continue
        s = s % n
        if s == 0:
            continue
        head = clang.slice_in_dim(r, n - s, n, dim=d)
        tail = clang.slice_in_dim(r, 0, n - s, dim=d)
        r = clang.cat([head, tail], d)
    return r


@torchsymbol("torch.broadcast_to", method_name="broadcast_to")
def broadcast_to(a, shape):
    return clang.expand(a, tuple(int(pyval(s)) for s in shape))


@torchsymbol("torch.tile", method_name="tile")
def tile(a, *reps):
    reps = reps[0] if len(reps) == 1 and isinstance(reps[0], (tuple, list)) else reps
    reps = tuple(int(pyval(r)) for r in reps)
    if len(reps) < a.ndim:
        reps = (1,) * (a.ndim - len(reps)) + reps
    return repeat(a, *reps)


@torchsymbol("torch.swapaxes", "torch.swapdims", method_name="swapaxes")
def swapaxes(a, dim0: int, dim1: int):
    return clang.transpose(a, int(pyval(dim0)), int(pyval(dim1)))


@torchsymbol("torch.ravel", method_name="ravel")
def ravel(a):
    return flatten(a)


@torchsymbol("torch.unflatten", method_name="unflatten")
def unflatten(a, dim: int, sizes):
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    sizes = [int(pyval(s)) for s in sizes]
    if -1 in sizes:
        idx = sizes.index(-1)
        known = 1
        for i, s in enumerate(sizes):
            if i != idx:
                known *= s
        sizes[idx] = a.shape[d] // known
    return clang.reshape(a, tuple(a.shape[:d]) + tuple(sizes) + tuple(a.shape[d + 1 :]))


@torchsymbol("torch.Tensor.unfold", method_name="unfold")
def unfold(a, dimension: int, size: int, step: int):
    """Sliding windows along ``dimension``: dim is replaced by the window
    count and a trailing dim of ``size`` is appended (torch.Tensor.unfold)."""
    d = canonicalize_dim(a.ndim, int(pyval(dimension)))
    size, step = int(pyval(size)), int(pyval(step))
    L = a.shape[d]
    check(size <= L, lambda: f"unfold size {size} > dim size {L}")
    n = (L - size) // step + 1
    starts = clang.mul(clang.arange(0, n, 1, device=a.device, dtype=dtypes.int64), step)
    offs = clang.arange(0, size, 1, device=a.device, dtype=dtypes.int64)
    idx = clang.add(clang.unsqueeze(starts, 1), clang.unsqueeze(offs, 0))  # (n, size)
    moved = clang.movedim(a, d, -1)
    flat_idx = clang.reshape(idx, (n * size,))
    taken = prims.take(moved, flat_idx, moved.ndim - 1)
    win = clang.reshape(taken, tuple(moved.shape[:-1]) + (n, size))
    return clang.movedim(win, -2, d)


@torchsymbol("torch.diag")
def diag(a, diagonal: int = 0):
    k = int(pyval(diagonal))
    if a.ndim == 1:
        n = a.shape[0] + builtins_abs(k)
        rows = clang.arange(0, n, 1, device=a.device, dtype=dtypes.int64)
        cols = clang.arange(0, n, 1, device=a.device, dtype=dtypes.int64)
        eye_mask = clang.eq(clang.sub(clang.unsqueeze(cols, 0), clang.unsqueeze(rows, 1)), k)
        padded = a
        if k > 0:
            padded = prims.pad(a, 0, ((k, 0, 0),))
        elif k < 0:
            padded = prims.pad(a, 0, ((0, -k, 0),))
        return clang.where(eye_mask, clang.expand_to(clang.unsqueeze(padded, 0), (n, n)), 0)
    check(a.ndim == 2, "diag expects a 1D or 2D tensor")
    return diagonal_sym(a, k, 0, 1)


@torchsymbol("torch.diagonal", method_name="diagonal", id="torch.diagonal")
def diagonal_sym(a, offset: int = 0, dim1: int = 0, dim2: int = 1):
    return clang.diagonal(a, offset, dim1, dim2)


@torchsymbol("torch.index_add", method_name="index_add")
def index_add(a, dim: int, index, source, *, alpha=1):
    return clang.index_add(a, dim, index, source, alpha)


@torchsymbol("torch.index_copy", method_name="index_copy")
def index_copy(a, dim: int, index, source):
    return clang.index_copy(a, dim, index, source)


@torchsymbol("torch.hstack")
def hstack(tensors):
    tensors = list(tensors)
    return cat(tensors, 0 if tensors[0].ndim == 1 else 1)


@torchsymbol("torch.vstack", "torch.row_stack")
def vstack(tensors):
    tensors = [reshape(t, (1,) + tuple(t.shape)) if t.ndim == 1 else t for t in tensors]
    return cat(tensors, 0)


# =============================================================================
# Additional reductions
# =============================================================================


@torchsymbol("torch.logsumexp", method_name="logsumexp")
def logsumexp(a, dim, keepdim: bool = False):
    dims = _dim_seq(dim)
    m = clang.amax(a, dims, True)
    m = clang.where(clang.isfinite(m), m, clang.zeros_like(m))
    r = clang.add(clang.log(clang.sum(clang.exp(clang.sub(a, m)), dims, True)), m)
    if not keepdim:
        canon = tuple(canonicalize_dim(a.ndim, d) for d in dims)
        r = clang.squeeze(r, canon)
    return r


@torchsymbol("torch.cumprod", method_name="cumprod")
def cumprod(a, dim: int, *, dtype=None):
    r = prims.cumprod(a, canonicalize_dim(a.ndim, int(pyval(dim))))
    if dtype is not None:
        r = clang.maybe_convert_to_dtype(r, to_dtype(dtype))
    return r


@torchsymbol("torch.count_nonzero", method_name="count_nonzero")
def count_nonzero(a, dim=None):
    return clang.sum(clang.maybe_convert_to_dtype(clang.ne(a, 0), dtypes.int64), _dim_seq(dim))


@torchsymbol("torch.norm", "torch.linalg.vector_norm", method_name="norm")
def norm(a, p=2, dim=None, keepdim: bool = False, *, dtype=None):
    if dtype is not None:
        a = clang.maybe_convert_to_dtype(a, to_dtype(dtype))
    dims = _dim_seq(dim)
    if isinstance(p, str):
        check(p == "fro", lambda: f"Unsupported norm order {p}")
        p = 2
    p = pyval(p)
    if p == float("inf"):
        return clang.amax(clang.abs(a), dims, keepdim)
    if p == float("-inf"):
        return clang.amin(clang.abs(a), dims, keepdim)
    if p == 0:
        return clang.sum(clang.maybe_convert_to_dtype(clang.ne(a, 0), a.dtype), dims, keepdim)
    if p == 1:
        return clang.sum(clang.abs(a), dims, keepdim)
    if p == 2:
        return clang.sqrt(clang.sum(clang.mul(a, a), dims, keepdim))
    return clang.pow(clang.sum(clang.pow(clang.abs(a), p), dims, keepdim), 1.0 / p)


@torchsymbol("torch.std_mean")
def std_mean(a, dim=None, *, correction: Number = 1, keepdim: bool = False):
    v, m = clang.var_mean(a, _dim_seq(dim), correction=correction, keepdim=keepdim)
    return clang.sqrt(v), m


# =============================================================================
# Additional matmul family
# =============================================================================


@torchsymbol("torch.mm", method_name="mm")
def mm(a, b):
    check(a.ndim == 2 and b.ndim == 2, "mm requires rank-2 tensors")
    return clang.matmul(a, b)


@torchsymbol("torch.mv", method_name="mv")
def mv(a, b):
    check(a.ndim == 2 and b.ndim == 1, "mv requires a matrix and a vector")
    return clang.matmul(a, b)


@torchsymbol("torch.dot", method_name="dot")
def dot(a, b):
    check(a.ndim == 1 and b.ndim == 1, "dot requires rank-1 tensors")
    return clang.matmul(a, b)


@torchsymbol("torch.vdot", method_name="vdot")
def vdot(a, b):
    check(a.ndim == 1 and b.ndim == 1, "vdot requires rank-1 tensors")
    return clang.matmul(a, b)  # real dtypes only; conj is identity


@torchsymbol("torch.addmm", method_name="addmm")
def addmm(a, m1, m2, *, beta=1, alpha=1):
    r = clang.matmul(m1, m2)
    if pyval(alpha) != 1:
        r = clang.mul(r, alpha)
    if pyval(beta) == 0:
        return r
    return clang.add(r, a if pyval(beta) == 1 else clang.mul(a, beta))


@torchsymbol("torch.baddbmm", method_name="baddbmm")
def baddbmm(a, b1, b2, *, beta=1, alpha=1):
    check(b1.ndim == 3 and b2.ndim == 3, "baddbmm requires rank-3 batches")
    r = clang.matmul(b1, b2)
    if pyval(alpha) != 1:
        r = clang.mul(r, alpha)
    if pyval(beta) == 0:
        return r
    return clang.add(r, a if pyval(beta) == 1 else clang.mul(a, beta))


@torchsymbol("torch.addbmm", method_name="addbmm")
def addbmm(a, b1, b2, *, beta=1, alpha=1):
    r = clang.sum(clang.matmul(b1, b2), (0,))
    if pyval(alpha) != 1:
        r = clang.mul(r, alpha)
    if pyval(beta) == 0:
        return r
    return clang.add(r, a if pyval(beta) == 1 else clang.mul(a, beta))


# =============================================================================
# Additional creation ops
# =============================================================================


@torchsymbol("torch.empty_like")
def empty_like(a, *, dtype=None, device=None, requires_grad: bool = False):
    return clang.zeros_like(a, device=device, dtype=to_dtype(dtype))


@torchsymbol("torch.rand_like")
def rand_like(a, *, dtype=None, device=None, requires_grad: bool = False):
    dt = to_dtype(dtype) or a.dtype
    return clang.uniform(tuple(a.shape), 0.0, 1.0, device=device or a.device, dtype=dt)


@torchsymbol("torch.randn_like")
def randn_like(a, *, dtype=None, device=None, requires_grad: bool = False):
    dt = to_dtype(dtype) or a.dtype
    return clang.randn(tuple(a.shape), device=device or a.device, dtype=dt)


@torchsymbol("torch.randint")
def randint(low, high=None, size=None, *, dtype=None, device=None, requires_grad: bool = False, generator=None):
    if high is None:  # randint(high, size)
        low, high = 0, low
    check(size is not None, "randint requires a size")
    lo, hi = int(pyval(low)), int(pyval(high))
    u = clang.uniform(tuple(size), float(lo), float(hi), device=device, dtype=dtypes.float32)
    return clang.maybe_convert_to_dtype(clang.floor(u), to_dtype(dtype) or dtypes.int64)


@torchsymbol("torch.bernoulli")
def bernoulli(a, *, generator=None):
    u = clang.uniform(tuple(a.shape), 0.0, 1.0, device=a.device, dtype=a.dtype)
    return clang.maybe_convert_to_dtype(clang.lt(u, a), a.dtype)


@torchsymbol("torch.eye")
def eye(n: int, m: Optional[int] = None, *, dtype=None, device=None, requires_grad: bool = False):
    n = int(pyval(n))
    m = n if m is None else int(pyval(m))
    rows = clang.arange(0, n, 1, device=device, dtype=dtypes.int64)
    cols = clang.arange(0, m, 1, device=device, dtype=dtypes.int64)
    mask = clang.eq(clang.unsqueeze(rows, 1), clang.unsqueeze(cols, 0))
    return clang.maybe_convert_to_dtype(mask, to_dtype(dtype) or dtypes.float32)


@torchsymbol("torch.linspace")
def linspace(start, end, steps: int, *, dtype=None, device=None, requires_grad: bool = False):
    steps = int(pyval(steps))
    dt = to_dtype(dtype) or dtypes.float32
    if steps == 1:
        return clang.full((1,), start, device=device, dtype=dt)
    i = clang.arange(0, steps, 1, device=device, dtype=dtypes.float32)
    v = clang.add(clang.mul(i, (pyval(end) - pyval(start)) / (steps - 1)), pyval(start))
    return clang.maybe_convert_to_dtype(v, dt)


# =============================================================================
# Pooling (the pool prim; the prim seat matches the
# reference's torch max/avg_poolNd ATen calls, thunder/torch/__init__.py)
# =============================================================================


def _pool_nd(a, kind: str, kernel, stride, padding, spatial: int, ceil_mode: bool, dilation=1):
    def _seq(x):
        return (int(pyval(x)),) * spatial if isinstance(x, (int, NumberProxy)) else tuple(int(pyval(v)) for v in x)

    check(not ceil_mode, "pool ceil_mode is not supported yet")
    d = _seq(dilation)
    check(builtins_max(d) == 1, "pool dilation is not supported yet")
    k = _seq(kernel)
    s = _seq(stride) if stride is not None else k
    p = _seq(padding)
    for pi, ki in zip(p, k):
        check(pi <= ki // 2, "pool padding must be <= half the kernel size")
    check(a.ndim in (spatial + 1, spatial + 2), lambda: f"pool expects rank {spatial + 1} or {spatial + 2}")
    pad_cfg = tuple((pi, pi) for pi in p)
    return prims.pool(a, kind, k, s, pad_cfg)


@torchsymbol("torch.nn.functional.max_pool1d")
def max_pool1d(a, kernel_size, stride=None, padding=0, dilation=1, ceil_mode: bool = False,
               return_indices: bool = False):
    check(not return_indices, "max_pool return_indices is not supported yet")
    return _pool_nd(a, "max", kernel_size, stride, padding, 1, ceil_mode, dilation)


@torchsymbol("torch.nn.functional.max_pool2d")
def max_pool2d(a, kernel_size, stride=None, padding=0, dilation=1, ceil_mode: bool = False,
               return_indices: bool = False):
    check(not return_indices, "max_pool return_indices is not supported yet")
    return _pool_nd(a, "max", kernel_size, stride, padding, 2, ceil_mode, dilation)


@torchsymbol("torch.nn.functional.max_pool3d")
def max_pool3d(a, kernel_size, stride=None, padding=0, dilation=1, ceil_mode: bool = False,
               return_indices: bool = False):
    check(not return_indices, "max_pool return_indices is not supported yet")
    return _pool_nd(a, "max", kernel_size, stride, padding, 3, ceil_mode, dilation)


@torchsymbol("torch.nn.functional.avg_pool1d")
def avg_pool1d(a, kernel_size, stride=None, padding=0, ceil_mode: bool = False,
               count_include_pad: bool = True):
    check(count_include_pad, "avg_pool count_include_pad=False is not supported yet")
    return _pool_nd(a, "avg", kernel_size, stride, padding, 1, ceil_mode)


@torchsymbol("torch.nn.functional.avg_pool2d")
def avg_pool2d(a, kernel_size, stride=None, padding=0, ceil_mode: bool = False,
               count_include_pad: bool = True, divisor_override=None):
    check(count_include_pad, "avg_pool count_include_pad=False is not supported yet")
    check(divisor_override is None, "avg_pool divisor_override is not supported yet")
    return _pool_nd(a, "avg", kernel_size, stride, padding, 2, ceil_mode)


@torchsymbol("torch.nn.functional.avg_pool3d")
def avg_pool3d(a, kernel_size, stride=None, padding=0, ceil_mode: bool = False,
               count_include_pad: bool = True, divisor_override=None):
    check(count_include_pad, "avg_pool count_include_pad=False is not supported yet")
    check(divisor_override is None, "avg_pool divisor_override is not supported yet")
    return _pool_nd(a, "avg", kernel_size, stride, padding, 3, ceil_mode)


def _adaptive_avg_pool(a, output_size, spatial: int):
    out = (int(pyval(output_size)),) * spatial if isinstance(output_size, (int, NumberProxy)) else tuple(
        int(pyval(v)) for v in output_size
    )
    in_sizes = tuple(a.shape[-spatial:])
    for i, (s, o) in enumerate(zip(in_sizes, out)):
        check(s % o == 0, lambda: f"adaptive pool requires divisible sizes, got {s}->{o}")
    # Reshape each spatial dim (s,) -> (o, s//o) and mean the inner factor.
    lead = tuple(a.shape[: a.ndim - spatial])
    new_shape = lead + builtins_sum(((o, s // o) for s, o in zip(in_sizes, out)), ())
    r = clang.reshape(a, new_shape)
    red_dims = tuple(len(lead) + 2 * i + 1 for i in range(spatial))
    return clang.mean(r, red_dims)


@torchsymbol("torch.nn.functional.adaptive_avg_pool1d")
def adaptive_avg_pool1d(a, output_size):
    return _adaptive_avg_pool(a, output_size, 1)


@torchsymbol("torch.nn.functional.adaptive_avg_pool2d")
def adaptive_avg_pool2d(a, output_size):
    return _adaptive_avg_pool(a, output_size, 2)


@torchsymbol("torch.nn.functional.adaptive_avg_pool3d")
def adaptive_avg_pool3d(a, output_size):
    return _adaptive_avg_pool(a, output_size, 3)


# =============================================================================
# Padding
# =============================================================================


@torchsymbol("torch.nn.functional.pad")
def pad(a, pad, mode: str = "constant", value=None):
    """F.pad: ``pad`` pairs run last-dim-first. constant lowers to the pad
    prim (negative = crop); reflect/replicate/circular decompose to
    slice+flip+cat per dim."""
    pad = tuple(int(pyval(p)) for p in pad)
    check(len(pad) % 2 == 0, "pad takes (lo, hi) pairs")
    npairs = len(pad) // 2
    check(npairs <= a.ndim, "more pad pairs than dims")
    if mode == "constant":
        cfg = []
        pairs = list(zip(pad[0::2], pad[1::2]))  # last dim first
        for i in range(a.ndim):
            j = a.ndim - 1 - i
            if j < npairs:
                lo, hi = pairs[j]
                cfg.append((lo, hi, 0))
            else:
                cfg.append((0, 0, 0))
        return prims.pad(a, 0 if value is None else value, tuple(cfg))

    check(mode in ("reflect", "replicate", "circular"), lambda: f"Unknown pad mode {mode}")
    r = a
    for j in range(npairs):
        lo, hi = pad[2 * j], pad[2 * j + 1]
        if lo == 0 and hi == 0:
            continue
        d = r.ndim - 1 - j
        n = r.shape[d]
        check(lo >= 0 and hi >= 0, "negative padding only supported in constant mode")
        pieces = []
        if mode == "circular":
            check(lo <= n and hi <= n, "circular pad wider than dim")
            if lo:
                pieces.append(clang.slice_in_dim(r, n - lo, n, dim=d))
            pieces.append(r)
            if hi:
                pieces.append(clang.slice_in_dim(r, 0, hi, dim=d))
        elif mode == "replicate":
            if lo:
                edge = clang.slice_in_dim(r, 0, 1, dim=d)
                shape = list(edge.shape)
                shape[d] = lo
                pieces.append(clang.expand(edge, tuple(shape)))
            pieces.append(r)
            if hi:
                edge = clang.slice_in_dim(r, n - 1, n, dim=d)
                shape = list(edge.shape)
                shape[d] = hi
                pieces.append(clang.expand(edge, tuple(shape)))
        else:  # reflect
            check(lo < n and hi < n, "reflect pad must be < dim size")
            if lo:
                pieces.append(clang.flip(clang.slice_in_dim(r, 1, lo + 1, dim=d), (d,)))
            pieces.append(r)
            if hi:
                pieces.append(clang.flip(clang.slice_in_dim(r, n - 1 - hi, n - 1, dim=d), (d,)))
        r = clang.cat(pieces, d) if len(pieces) > 1 else pieces[0]
    return r


# =============================================================================
# One-hot / normalization / interpolation
# =============================================================================


@torchsymbol("torch.nn.functional.one_hot")
def one_hot(a, num_classes: int = -1):
    check(int(pyval(num_classes)) > 0, "one_hot requires an explicit num_classes under tracing")
    C = int(pyval(num_classes))
    cols = clang.arange(0, C, 1, device=a.device, dtype=dtypes.int64)
    shape_ones = (1,) * a.ndim
    cols = clang.reshape(cols, shape_ones + (C,))
    return clang.maybe_convert_to_dtype(
        clang.eq(clang.unsqueeze(a, a.ndim), cols), dtypes.int64
    )


@torchsymbol("torch.nn.functional.normalize")
def normalize(a, p: float = 2.0, dim: int = 1, eps: float = 1e-12):
    n = norm(a, p, dim, True)
    return clang.true_divide(a, clang.clamp(n, eps, None))


@torchsymbol(id="torch.batch_norm_stats")
def _batch_norm_stats(input, running_mean=None, running_var=None, weight=None, bias=None,
                      training: bool = False, momentum: float = 0.1, eps: float = 1e-5):
    """Functional batch_norm returning (out, new_running_mean, new_running_var)
    — the user-facing wrapper (``batch_norm``) forwards the running-stat
    proxies so buffer mutation functionalizes (reference: F.batch_norm's
    in-place running-stat update + epilogue replay, jit_ext.py:1302)."""
    check(input.ndim >= 2, "batch_norm expects (N, C, ...)")
    C = input.shape[1]
    red = (0,) + tuple(range(2, input.ndim))
    stat_shape = (1, C) + (1,) * (input.ndim - 2)
    compute_dtype = dtypes.float32 if input.dtype in (dtypes.bfloat16, dtypes.float16) else input.dtype
    x = clang.maybe_convert_to_dtype(input, compute_dtype)

    use_batch_stats = training or running_mean is None
    if use_batch_stats:
        var_b, mean = clang.var_mean(x, red, correction=0, keepdim=False)
        new_mean, new_var = None, None
        if training and running_mean is not None:
            m = float(pyval(momentum))
            n_elem = 1
            for d in red:
                n_elem *= input.shape[d]
            var_unbiased = clang.mul(var_b, n_elem / builtins_max(n_elem - 1, 1))
            new_mean = clang.add(clang.mul(clang.maybe_convert_to_dtype(mean, running_mean.dtype), m),
                                 clang.mul(running_mean, 1.0 - m))
            new_var = clang.add(clang.mul(clang.maybe_convert_to_dtype(var_unbiased, running_var.dtype), m),
                                clang.mul(running_var, 1.0 - m))
        use_mean, use_var = mean, var_b
    else:
        use_mean = clang.maybe_convert_to_dtype(running_mean, compute_dtype)
        use_var = clang.maybe_convert_to_dtype(running_var, compute_dtype)
        new_mean, new_var = None, None

    normed = clang.mul(
        clang.sub(x, clang.reshape(use_mean, stat_shape)),
        clang.rsqrt(clang.add(clang.reshape(use_var, stat_shape), eps)),
    )
    normed = clang.maybe_convert_to_dtype(normed, input.dtype)
    if weight is not None:
        normed = clang.mul(normed, clang.reshape(weight, stat_shape))
    if bias is not None:
        normed = clang.add(normed, clang.reshape(bias, stat_shape))
    return normed, new_mean, new_var


def batch_norm(input, running_mean=None, running_var=None, weight=None, bias=None,
               training: bool = False, momentum: float = 0.1, eps: float = 1e-5):
    out, new_mean, new_var = _batch_norm_stats(
        input, running_mean, running_var, weight, bias, training, momentum, eps
    )
    if new_mean is not None and isinstance(running_mean, TensorProxy):
        _mark_inplace(running_mean, new_mean)
    if new_var is not None and isinstance(running_var, TensorProxy):
        _mark_inplace(running_var, new_var)
    return out


for _path in ("torch.nn.functional.batch_norm", "torch.batch_norm"):
    _obj = _resolve_torch_attr(_path)
    if _obj is not None:
        _torch_to_thunder_function_map[_obj] = batch_norm


@torchsymbol("torch.nn.functional.instance_norm")
def instance_norm(input, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats: bool = True, momentum: float = 0.1, eps: float = 1e-5):
    check(running_mean is None and running_var is None,
          "instance_norm running stats are not supported yet")
    check(use_input_stats, "instance_norm requires use_input_stats without running stats")
    check(input.ndim >= 3, "instance_norm expects (N, C, ...)")
    red = tuple(range(2, input.ndim))
    compute_dtype = dtypes.float32 if input.dtype in (dtypes.bfloat16, dtypes.float16) else input.dtype
    x = clang.maybe_convert_to_dtype(input, compute_dtype)
    v, m = clang.var_mean(x, red, correction=0, keepdim=True)
    normed = clang.maybe_convert_to_dtype(
        clang.mul(clang.sub(x, m), clang.rsqrt(clang.add(v, eps))), input.dtype
    )
    C = input.shape[1]
    stat_shape = (1, C) + (1,) * (input.ndim - 2)
    if weight is not None:
        normed = clang.mul(normed, clang.reshape(weight, stat_shape))
    if bias is not None:
        normed = clang.add(normed, clang.reshape(bias, stat_shape))
    return normed


def _resize_dim(x, d: int, out_size: int, mode: str, align_corners: bool):
    L = x.shape[d]
    if out_size == L:
        return x
    if mode == "nearest":
        i = clang.arange(0, out_size, 1, device=x.device, dtype=dtypes.float32)
        idx = clang.maybe_convert_to_dtype(clang.floor(clang.mul(i, L / out_size)), dtypes.int64)
        return prims.take(x, idx, d)
    # linear
    i = clang.arange(0, out_size, 1, device=x.device, dtype=dtypes.float32)
    if align_corners and out_size > 1:
        src = clang.mul(i, (L - 1) / (out_size - 1))
    else:
        src = clang.clamp(clang.sub(clang.mul(clang.add(i, 0.5), L / out_size), 0.5), 0.0, float(L - 1))
    i0f = clang.floor(src)
    w = clang.sub(src, i0f)
    i0 = clang.maybe_convert_to_dtype(i0f, dtypes.int64)
    i1 = clang.clamp(clang.add(i0, 1), 0, L - 1)
    x0 = prims.take(x, i0, d)
    x1 = prims.take(x, i1, d)
    wshape = [1] * x.ndim
    wshape[d] = out_size
    w = clang.reshape(w, tuple(wshape))
    w = clang.maybe_convert_to_dtype(w, x0.dtype) if dtypes.is_float_dtype(x0.dtype) else w
    return clang.add(x0, clang.mul(clang.sub(x1, x0), w))


@torchsymbol("torch.nn.functional.interpolate")
def interpolate(a, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: Optional[bool] = None, recompute_scale_factor=None,
                antialias: bool = False):
    check(not antialias, "interpolate antialias is not supported yet")
    spatial = a.ndim - 2
    check(spatial >= 1, "interpolate expects (N, C, ...) input")
    check(mode in ("nearest", "linear", "bilinear", "trilinear"),
          lambda: f"interpolate mode {mode} is not supported yet")
    if size is not None:
        out = (int(pyval(size)),) * spatial if isinstance(size, (int, NumberProxy)) else tuple(
            int(pyval(s)) for s in size
        )
    else:
        check(scale_factor is not None, "interpolate needs size or scale_factor")
        sf = (float(pyval(scale_factor)),) * spatial if isinstance(scale_factor, (int, float, NumberProxy)) else tuple(
            float(pyval(s)) for s in scale_factor
        )
        out = tuple(int(math.floor(a.shape[2 + i] * sf[i])) for i in range(spatial))
    interp_mode = "nearest" if mode == "nearest" else "linear"
    ac = bool(align_corners) if align_corners is not None else False
    r = a
    for i in range(spatial):
        r = _resize_dim(r, 2 + i, out[i], interp_mode, ac)
    return r


# =============================================================================
# Additional activations
# =============================================================================


@torchsymbol("torch.nn.functional.glu")
def glu(a, dim: int = -1):
    d = canonicalize_dim(a.ndim, int(pyval(dim)))
    n = a.shape[d]
    check(n % 2 == 0, "glu dim must be even")
    x = clang.slice_in_dim(a, 0, n // 2, dim=d)
    g = clang.slice_in_dim(a, n // 2, n, dim=d)
    return clang.mul(x, sigmoid(g))


@torchsymbol("torch.nn.functional.hardtanh")
def hardtanh(a, min_val: float = -1.0, max_val: float = 1.0, inplace: bool = False):
    return clang.clamp(a, min_val, max_val)


@torchsymbol("torch.nn.functional.relu6")
def relu6(a, inplace: bool = False):
    return clang.clamp(a, 0.0, 6.0)


@torchsymbol("torch.nn.functional.hardsigmoid")
def hardsigmoid(a, inplace: bool = False):
    return clang.true_divide(clang.clamp(clang.add(a, 3.0), 0.0, 6.0), 6.0)


@torchsymbol("torch.nn.functional.logsigmoid")
def logsigmoid(a):
    # -softplus(-x), stable.
    return clang.neg(softplus(clang.neg(a)))


@torchsymbol("torch.nn.functional.selu")
def selu(a, inplace: bool = False):
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    return clang.mul(scale, clang.where(clang.gt(a, 0), a, clang.mul(alpha, clang.expm1(a))))


@torchsymbol("torch.nn.functional.celu")
def celu(a, alpha: float = 1.0, inplace: bool = False):
    return clang.where(clang.gt(a, 0), a, clang.mul(alpha, clang.expm1(clang.true_divide(a, alpha))))


@torchsymbol("torch.nn.functional.prelu")
def prelu(a, weight):
    if weight.numel > 1:
        wshape = [1] * a.ndim
        if a.ndim >= 2:
            wshape[1] = weight.numel
        weight = clang.reshape(weight, tuple(wshape))
    return clang.where(clang.gt(a, 0), a, clang.mul(a, weight))


@torchsymbol("torch.nn.functional.softmin")
def softmin(a, dim: int, dtype=None):
    return softmax(clang.neg(a), dim, dtype)


@torchsymbol("torch.nn.functional.softsign")
def softsign(a):
    return clang.true_divide(a, clang.add(clang.abs(a), 1.0))


@torchsymbol("torch.nn.functional.tanhshrink")
def tanhshrink(a):
    return clang.sub(a, clang.tanh(a))


@torchsymbol("torch.nn.functional.hardshrink")
def hardshrink(a, lambd: float = 0.5):
    keep = clang.gt(clang.abs(a), lambd)
    return clang.where(keep, a, clang.zeros_like(a))


@torchsymbol("torch.nn.functional.softshrink")
def softshrink(a, lambd: float = 0.5):
    mag = clang.sub(clang.abs(a), lambd)
    return clang.where(clang.gt(clang.abs(a), lambd), clang.mul(clang.sign(a), mag), clang.zeros_like(a))


@torchsymbol("torch.nn.functional.threshold")
def threshold(a, threshold_: float, value: float, inplace: bool = False):
    return clang.where(clang.gt(a, threshold_), a, clang.full_like(a, value))


# =============================================================================
# Additional losses
# =============================================================================


def _reduce_loss(l, reduction: str):
    if reduction == "none":
        return l
    if reduction == "sum":
        return clang.sum(l, None)
    check(reduction == "mean", lambda: f"Unknown reduction {reduction}")
    return clang.mean(l, None)


@torchsymbol("torch.nn.functional.l1_loss")
def l1_loss(input, target, reduction: str = "mean"):
    return _reduce_loss(clang.abs(clang.sub(input, target)), reduction)


@torchsymbol("torch.nn.functional.smooth_l1_loss")
def smooth_l1_loss(input, target, reduction: str = "mean", beta: float = 1.0):
    d = clang.abs(clang.sub(input, target))
    quad = clang.true_divide(clang.mul(clang.mul(d, d), 0.5), beta)
    lin = clang.sub(d, 0.5 * beta)
    return _reduce_loss(clang.where(clang.lt(d, beta), quad, lin), reduction)


@torchsymbol("torch.nn.functional.huber_loss")
def huber_loss(input, target, reduction: str = "mean", delta: float = 1.0):
    d = clang.abs(clang.sub(input, target))
    quad = clang.mul(clang.mul(d, d), 0.5)
    lin = clang.mul(delta, clang.sub(d, 0.5 * delta))
    return _reduce_loss(clang.where(clang.lt(d, delta), quad, lin), reduction)


@torchsymbol("torch.nn.functional.binary_cross_entropy")
def binary_cross_entropy(input, target, weight=None, reduction: str = "mean"):
    eps = 1e-12
    l = clang.neg(clang.add(
        clang.mul(target, clang.log(clang.clamp(input, eps, None))),
        clang.mul(clang.sub(1.0, target), clang.log(clang.clamp(clang.sub(1.0, input), eps, None))),
    ))
    if weight is not None:
        l = clang.mul(l, weight)
    return _reduce_loss(l, reduction)


@torchsymbol("torch.nn.functional.binary_cross_entropy_with_logits")
def binary_cross_entropy_with_logits(input, target, weight=None, pos_weight=None,
                                     reduction: str = "mean"):
    # max(x,0) - x*t + log(1+exp(-|x|)) — the numerically stable form.
    neg_abs = clang.neg(clang.abs(input))
    if pos_weight is None:
        base = clang.add(clang.sub(clang.maximum(input, 0), clang.mul(input, target)),
                         clang.log1p(clang.exp(neg_abs)))
    else:
        # loss = (1-t)*x + (1+(pw-1)*t) * softplus(-x), with
        # softplus(-x) = log1p(exp(-|x|)) - min(x, 0)  (stable).
        lw = clang.add(1.0, clang.mul(clang.sub(pos_weight, 1.0), target))
        softplus_neg = clang.sub(clang.log1p(clang.exp(neg_abs)), clang.minimum(input, 0))
        base = clang.add(clang.mul(clang.sub(1.0, target), input), clang.mul(lw, softplus_neg))
    l = base
    if weight is not None:
        l = clang.mul(l, weight)
    return _reduce_loss(l, reduction)


@torchsymbol("torch.nn.functional.kl_div")
def kl_div(input, target, reduction: str = "mean", log_target: bool = False):
    if log_target:
        l = clang.mul(clang.exp(target), clang.sub(target, input))
    else:
        l = clang.sub(xlogy(target, target), clang.mul(target, input))
    if reduction == "batchmean":
        return clang.true_divide(clang.sum(l, None), input.shape[0])
    return _reduce_loss(l, reduction)


# =============================================================================
# In-place ops (functionalized: compute out-of-place, forward the stale proxy)
# =============================================================================


def _mark_inplace(old, new):
    """Functionalize an in-place update: cast the result back to the target's
    dtype (torch in-place ops keep self's dtype), register forwarding so every
    later consumer of ``old`` sees ``new``, and flag the trace so
    Symbol.__call__ resolves proxies (reference analogue: thunder's implicit
    functionalization of in-place torch ops)."""
    from thunder_tpu_torch.core.trace import get_tracectx

    check(isinstance(old, TensorProxy), "in-place op target must be a traced tensor")
    if isinstance(new, TensorProxy) and new.dtype != old.dtype:
        new = clang.maybe_convert_to_dtype(new, old.dtype)
    if isinstance(new, TensorProxy) and tuple(new.shape) != tuple(old.shape):
        new = clang.expand_to(new, tuple(old.shape))
    trc = get_tracectx()
    if trc is not None:
        trc._inplace_seen = True
        targets = getattr(trc, "_inplace_targets", None)
        if targets is None:
            targets = trc._inplace_targets = {}
        # Keyed by the ORIGINAL proxy so module epilogues can map a
        # param/buffer to its final value after any number of updates.
        targets[old.name] = old
    old._inplace_forward = new
    return new


def _inplace(name: str, functional: Callable):
    def impl(a, *args, **kwargs):
        return _mark_inplace(a, functional(a, *args, **kwargs))

    impl.__name__ = name
    obj = _resolve_torch_attr(f"torch.Tensor.{name}")
    if obj is not None:
        _torch_to_thunder_function_map[obj] = impl
    _torch_ctx.register_method(name, impl)
    return impl


add_ = _inplace("add_", add)
sub_ = _inplace("sub_", sub)
mul_ = _inplace("mul_", mul)
div_ = _inplace("div_", div_sym)
pow_ = _inplace("pow_", pow)
neg_ = _inplace("neg_", clang.neg)
abs_ = _inplace("abs_", clang.abs)
exp_ = _inplace("exp_", clang.exp)
log_ = _inplace("log_", clang.log)
sqrt_ = _inplace("sqrt_", clang.sqrt)
rsqrt_ = _inplace("rsqrt_", clang.rsqrt)
sigmoid_ = _inplace("sigmoid_", lambda a: sigmoid(a))
tanh_ = _inplace("tanh_", clang.tanh)
relu_ = _inplace("relu_", lambda a: clang.maximum(a, 0))
floor_ = _inplace("floor_", clang.floor)
ceil_ = _inplace("ceil_", clang.ceil)
round_ = _inplace("round_", clang.round)
trunc_ = _inplace("trunc_", clang.trunc)
erf_ = _inplace("erf_", clang.erf)
zero_ = _inplace("zero_", lambda a: clang.zeros_like(a))
fill_ = _inplace("fill_", lambda a, v: clang.full_like(a, v))
masked_fill_ = _inplace("masked_fill_", masked_fill)
setitem_ = _inplace("setitem_", setitem)
clamp_ = _inplace("clamp_", clang.clamp)
clamp_min_ = _inplace("clamp_min_", lambda a, m: clang.clamp(a, m, None))
clamp_max_ = _inplace("clamp_max_", lambda a, m: clang.clamp(a, None, m))
copy_ = _inplace("copy_", lambda a, src, non_blocking=False: src)
addcmul_ = _inplace("addcmul_", addcmul)
addcdiv_ = _inplace("addcdiv_", addcdiv)
lerp_ = _inplace("lerp_", lerp)
tril_ = _inplace("tril_", tril)
triu_ = _inplace("triu_", triu)
scatter_add_ = _inplace("scatter_add_", scatter_add)
index_add_ = _inplace("index_add_", index_add)
index_copy_ = _inplace("index_copy_", index_copy)
uniform_ = _inplace(
    "uniform_",
    lambda a, from_=0.0, to=1.0, generator=None: clang.uniform(
        tuple(a.shape), float(pyval(from_)), float(pyval(to)), device=a.device,
        dtype=a.dtype if dtypes.is_float_dtype(a.dtype) else dtypes.float32,
    ),
)
normal_ = _inplace(
    "normal_",
    lambda a, mean=0.0, std=1.0, generator=None: clang.add(
        clang.mul(
            clang.randn(tuple(a.shape), device=a.device,
                        dtype=a.dtype if dtypes.is_float_dtype(a.dtype) else dtypes.float32),
            std,
        ),
        mean,
    ),
)


def _requires_grad_(a, requires_grad: bool = True):
    a._requires_grad = bool(requires_grad) and dtypes.is_inexact_dtype(a.dtype)
    return a


def _detach_(a):
    return _mark_inplace(a, prims.stop_gradient(a))


_torch_ctx.register_method("requires_grad_", _requires_grad_)
_torch_ctx.register_method("detach_", _detach_)
for _nm, _fn in (("requires_grad_", _requires_grad_), ("detach_", _detach_)):
    _obj = _resolve_torch_attr(f"torch.Tensor.{_nm}")
    if _obj is not None:
        _torch_to_thunder_function_map[_obj] = _fn


# =============================================================================
# Misc tensor methods
# =============================================================================


def _size(a, dim: Optional[int] = None):
    if dim is None:
        return tuple(a.shape)
    return a.shape[canonicalize_dim(a.ndim, int(pyval(dim)))]


_torch_ctx.register_method("size", _size)
_torch_ctx.register_method("dim", lambda a: a.ndim)
_torch_ctx.register_method("numel", lambda a: a.numel)
_torch_ctx.register_method("float", lambda a: clang.maybe_convert_to_dtype(a, dtypes.float32))
_torch_ctx.register_method("type", lambda a, dt=None: a.dtype if dt is None else clang.maybe_convert_to_dtype(a, dtypes.to_dtype(dt)))


# Generated code prints ltorch symbols qualified as ``ltorch.<name>``.
register_module("ltorch", __import__("sys").modules[__name__])


def torch_function_map() -> dict:
    return _torch_to_thunder_function_map
