"""The primitive operation set: the trace IR's reduced instruction set.

Reference parity: thunder/core/prims.py (`PrimIDs:94-249`, `OpTags:252`,
`make_prim:267`) — ~125 primitives spanning unpack/check guards, utility ops,
data movement, tensor creation, shape ops, elementwise unary/binary/ternary,
reductions, scatter/gather, and linear algebra. Each prim has a *meta*
function performing shape/dtype inference over proxies; concrete semantics
live in executors (thunder_tpu_torch/executors/torchex.py maps the prims
the port runs to torch operators).

Prims are deliberately strict: elementwise prims require same-shape,
same-dtype inputs. Broadcasting and type promotion happen one level up, in
the clang layer — keeping prims trivially lowerable to single torch ops
with no hidden semantics.

RNG prims are functional: a trace containing them is given an explicit
``rng_key`` input by the RNG transform, a later part of the port.
"""

from __future__ import annotations

import enum
from numbers import Number
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.core import codeutils, dtypes, devices, utils
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.langctxs import LanguageContext, Languages, register_langctx
from thunder_tpu_torch.core.proxies import (
    AnyProxy,
    CollectionProxy,
    FutureTensorProxy,
    NumberProxy,
    Proxy,
    StringProxy,
    TensorProxy,
    proxy,
    pyval,
)
from thunder_tpu_torch.core.symbol import Symbol
from thunder_tpu_torch.core.utils import (
    ELEMENTWISE_TYPE_PROMOTION_KIND,
    canonicalize_dim,
    canonicalize_dims,
    compute_broadcast_shape,
)


class OpTags(enum.Enum):
    """Reference parity: thunder/core/prims.py `OpTags:252`."""

    REDUCTION_OP = enum.auto()
    SHAPE_OP = enum.auto()
    ELEMENTWISE_UNARY_OP = enum.auto()
    ELEMENTWISE_BINARY_OP = enum.auto()
    MATMUL_OP = enum.auto()
    RANDOM_OP = enum.auto()
    DEVICE_SYNC_OP = enum.auto()
    DONT_DCE = enum.auto()
    UNPACK_OP = enum.auto()
    GUARD_OP = enum.auto()
    COMM_OP = enum.auto()
    # Observable-effect tags: the single source of truth shared by DCE
    # (transforms/common.py), del_last_used, and the analysis/ verifier's
    # dce.dead-symbol and alias.inplace-hazard rules.
    SIDE_EFFECT = enum.auto()  # op does I/O or otherwise acts beyond its outputs
    IN_PLACE = enum.auto()  # op mutates an operand (see analysis.rules.INPLACE_MUTATED_ARG)


class PrimIDs(enum.Enum):
    # Unpacking and checking (prologue guards)
    UNPACK_TRIVIAL = enum.auto()
    TENSOR_CONSTANT = enum.auto()
    UNPACK_SEQUENCE = enum.auto()
    UNPACK_KEY = enum.auto()
    UNPACK_ATTR = enum.auto()
    CHECK_TENSOR_SHAPE_AND_METADATA = enum.auto()
    CHECK_NUMBER_TYPE_AND_VALUE = enum.auto()
    CHECK_STRING_VALUE = enum.auto()
    CHECK_LEN = enum.auto()
    CHECK_KEYS = enum.auto()
    CHECK_NONE = enum.auto()
    # Symbolic-values caching (cache="symbolic values"): a marked tensor dim
    # is lifted into a NumberProxy by UNPACK_DIM and constrained by
    # CHECK_DIM_BUCKET instead of the exact-extent metadata check.
    UNPACK_DIM = enum.auto()
    CHECK_DIM_BUCKET = enum.auto()
    # Utility
    DEL = enum.auto()
    RETURN = enum.auto()
    COMMENT = enum.auto()
    PRINT = enum.auto()
    # Data movement and host sync
    CONVERT_ELEMENT_TYPE = enum.auto()
    DEVICE_PUT = enum.auto()
    ITEM = enum.auto()
    COPY_ = enum.auto()
    SHALLOW_COPY = enum.auto()
    STOP_GRADIENT = enum.auto()
    # Tensor creation
    FULL = enum.auto()
    IOTA = enum.auto()
    UNIFORM = enum.auto()
    RANDN = enum.auto()
    UNIFORM_KEYED = enum.auto()
    RANDN_KEYED = enum.auto()
    UNIFORM_PHILOX = enum.auto()
    TENSOR_FROM_SEQUENCE = enum.auto()
    # Shape ops
    BROADCAST_IN_DIM = enum.auto()
    CAT = enum.auto()
    FLIP = enum.auto()
    PAD = enum.auto()
    RESHAPE = enum.auto()
    SLICE = enum.auto()
    SQUEEZE = enum.auto()
    TRANSPOSE = enum.auto()
    TAKE = enum.auto()
    SETITEM = enum.auto()
    TAKE_ALONG_AXIS = enum.auto()
    GATHER = enum.auto()
    SCATTER_ADD = enum.auto()
    INDEX_PUT = enum.auto()
    ARGSORT = enum.auto()
    SORT = enum.auto()
    TOPK = enum.auto()
    CUMSUM = enum.auto()
    CUMPROD = enum.auto()
    # Elementwise unary
    ABS = enum.auto()
    ACOS = enum.auto()
    ACOSH = enum.auto()
    ASIN = enum.auto()
    ASINH = enum.auto()
    ATAN = enum.auto()
    ATANH = enum.auto()
    BITWISE_NOT = enum.auto()
    CEIL = enum.auto()
    COS = enum.auto()
    COSH = enum.auto()
    DIGAMMA = enum.auto()
    ERF = enum.auto()
    ERFC = enum.auto()
    ERFINV = enum.auto()
    EXP = enum.auto()
    EXP2 = enum.auto()
    EXPM1 = enum.auto()
    FLOOR = enum.auto()
    ISFINITE = enum.auto()
    ISINF = enum.auto()
    ISNAN = enum.auto()
    LGAMMA = enum.auto()
    LOG = enum.auto()
    LOG10 = enum.auto()
    LOG1P = enum.auto()
    LOG2 = enum.auto()
    NEG = enum.auto()
    RECIPROCAL = enum.auto()
    ROUND = enum.auto()
    RSQRT = enum.auto()
    SIGN = enum.auto()
    SIGNBIT = enum.auto()
    SIN = enum.auto()
    SINH = enum.auto()
    SQRT = enum.auto()
    TAN = enum.auto()
    TANH = enum.auto()
    TRUNC = enum.auto()
    REAL = enum.auto()
    IMAG = enum.auto()
    # Elementwise binary
    ADD = enum.auto()
    ATAN2 = enum.auto()
    BITWISE_AND = enum.auto()
    BITWISE_OR = enum.auto()
    BITWISE_XOR = enum.auto()
    BITWISE_LEFT_SHIFT = enum.auto()
    BITWISE_RIGHT_SHIFT = enum.auto()
    DIV = enum.auto()
    EQ = enum.auto()
    FMOD = enum.auto()
    GE = enum.auto()
    GT = enum.auto()
    LE = enum.auto()
    LT = enum.auto()
    MAXIMUM = enum.auto()
    MINIMUM = enum.auto()
    MUL = enum.auto()
    NE = enum.auto()
    NEXTAFTER = enum.auto()
    POW = enum.auto()
    REMAINDER = enum.auto()
    SUB = enum.auto()
    COPYSIGN = enum.auto()
    ZETA = enum.auto()
    POLYGAMMA = enum.auto()
    # Conditional
    WHERE = enum.auto()
    # Reductions
    AMAX = enum.auto()
    AMIN = enum.auto()
    PROD = enum.auto()
    SUM = enum.auto()
    VAR = enum.auto()
    VAR_MEAN = enum.auto()
    ARGMAX = enum.auto()
    ARGMIN = enum.auto()
    # Linear algebra / NN
    MATMUL = enum.auto()
    LINEAR = enum.auto()
    CONVOLUTION = enum.auto()
    CONVOLUTION_BWD = enum.auto()
    EMBEDDING = enum.auto()
    EMBEDDING_BACKWARD = enum.auto()
    POOL = enum.auto()
    POOL_BWD = enum.auto()


_prims_by_id: dict[PrimIDs, Symbol] = {}


def make_prim(
    id: PrimIDs,
    name: str,
    meta: Callable,
    *,
    tags: Sequence[OpTags] = (),
    python_printer: Optional[Callable] = None,
    python_impl: Optional[Callable] = None,
) -> Symbol:
    """Reference parity: thunder/core/prims.py `make_prim:267`."""
    sym = Symbol(
        name,
        meta,
        id=id,
        is_prim=True,
        tags=tags,
        python_printer=python_printer,
        python_impl=python_impl,
        module="prims",
    )
    _prims_by_id[id] = sym
    return sym


def get_prim(id: PrimIDs) -> Symbol:
    return _prims_by_id[id]


# =============================================================================
# Unpacking and checking prims (prologue)
# =============================================================================


def _unpack_trivial_meta(x: Any, *, name: str) -> Any:
    return x


def _unpack_trivial_printer(bsym) -> str:
    out = bsym.output
    nm = out.name if isinstance(out, Proxy) else codeutils.prettyprint(out)
    return f"# {nm} bound by the signature"


unpack_trivial = make_prim(
    PrimIDs.UNPACK_TRIVIAL,
    "unpack_trivial",
    _unpack_trivial_meta,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
    python_printer=_unpack_trivial_printer,
)


class _ConstHandle:
    """Identity-hashable wrapper keeping a concrete array OFF the bound
    symbol's printable/hashable surface (CSE keys, repr) while remaining in
    its args for liveness."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __repr__(self) -> str:
        return f"<const {getattr(self.value, 'shape', ())}>"


def _tensor_constant_meta(handle: _ConstHandle):
    from thunder_tpu_torch.core.proxies import tensorproxy_from_concrete

    return tensorproxy_from_concrete(handle.value)


def _tensor_constant_printer(bsym) -> str:
    key = next(iter(bsym._call_ctx))
    return f"{bsym.output.name} = {key}"


def _tensor_constant_bind(bsym) -> None:
    handle = bsym.args[0]
    bsym._call_ctx[f"_tconst_{id(handle)}"] = handle.value
    # Provenance comment in the generated program (the VM records where
    # every value was loaded from — interpreter.py provenance; here the
    # trace documents what was captured).
    v = handle.value
    bsym.header = (
        f"captured tensor constant: shape {tuple(getattr(v, 'shape', ()))} "
        f"dtype {getattr(v, 'dtype', '?')} (baked; not a guarded input)"
    )


tensor_constant_sym = make_prim(
    PrimIDs.TENSOR_CONSTANT,
    "tensor_constant",
    _tensor_constant_meta,
    python_printer=_tensor_constant_printer,
)
tensor_constant_sym._bind_postprocess = _tensor_constant_bind


def tensor_constant(value):
    """Lift a concrete array (numpy/torch) captured from the enclosing
    Python scope into the trace as a BAKED constant.

    Reference analogue: the bytecode VM proxies tensors wherever it loads
    them (closures, globals, defaults — interpreter.py provenance records);
    the dispatch frontend lifts them at the op boundary instead. The value
    is bound into the generated program's exec namespace via the bound
    symbol's call ctx — it is part of the compiled program, NOT a guarded
    input (mutating the captured array later is invisible, exactly like a
    baked Python-number constant).

    Per-trace memo: the same captured object used by N ops bakes ONE
    constant (one device buffer, one bound symbol) — identity-hashed
    handles would otherwise defeat CSE and pin N copies."""
    from thunder_tpu_torch.core.trace import get_tracectx
    from thunder_tpu_torch.executors import bridge

    trc = get_tracectx()
    memo = getattr(trc, "_tconst_memo", None)
    if memo is None:
        memo = trc._tconst_memo = {}
    hit = memo.get(id(value))
    if hit is not None:
        return hit[1]
    # A captured tensor is baked into the trace as a constant: the prologue
    # does not guard it, so a later mutation of it is not seen. Reported per
    # the sharp-edges policy, once per captured object.
    from thunder_tpu_torch.common import sharp_edge

    sharp_edge(
        f"captured concrete tensor (shape {tuple(getattr(value, 'shape', ()))}) "
        "baked into the trace as a constant — it is not a guarded input; "
        "later mutation of the captured array will NOT be seen. Pass it as "
        "an argument to make it an input"
    )
    proxy = tensor_constant_sym(_ConstHandle(bridge.to_torch(value, devices.Device().torch_device())))
    # Keep the source object alive for the trace's lifetime so its id can't
    # be reused by a different array.
    memo[id(value)] = (value, proxy)
    return proxy


def _unpack_sequence_meta(seq: Any, length: int) -> list:
    coll = seq.coll if isinstance(seq, CollectionProxy) else seq
    check(len(coll) == length, lambda: f"Expected sequence of length {length}")

    def elem_proxy(x):
        if isinstance(x, Proxy):
            return x
        if isinstance(x, (tuple, list, dict)):
            return CollectionProxy(x)
        return proxy(x)

    return [elem_proxy(x) for x in coll]


def _unpack_sequence_printer(bsym) -> str:
    src = bsym.args[0]
    src_s = src.name if isinstance(src, Proxy) else codeutils.prettyprint(src)
    if not bsym.output:  # empty sequence: nothing to bind (check_len guards it)
        return f"_ = {src_s}"
    outs = ", ".join(
        o.name if isinstance(o, Proxy) else codeutils.prettyprint(o) for o in bsym.output
    )
    return f"{outs}, = {src_s}" if len(bsym.output) == 1 else f"{outs} = {src_s}"


unpack_sequence = make_prim(
    PrimIDs.UNPACK_SEQUENCE,
    "unpack_sequence",
    _unpack_sequence_meta,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
    python_printer=_unpack_sequence_printer,
)


def _unpack_key_meta(d: Any, key: str) -> Any:
    coll = d.coll if isinstance(d, CollectionProxy) else d
    v = coll[key]
    return proxy(v) if not isinstance(v, Proxy) else v


def _unpack_key_printer(bsym) -> str:
    out = bsym.output
    d, key = bsym.args
    d_s = d.name if isinstance(d, Proxy) else codeutils.prettyprint(d)
    return f"{out.name} = {d_s}[{key!r}]"


unpack_key = make_prim(
    PrimIDs.UNPACK_KEY,
    "unpack_key",
    _unpack_key_meta,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
    python_printer=_unpack_key_printer,
)


def _unpack_attr_meta(obj: Any, name: str) -> Any:
    v = getattr(obj, name)
    return proxy(v) if not isinstance(v, Proxy) else v


def _unpack_attr_printer(bsym) -> str:
    obj, name = bsym.args
    obj_s = obj.name if isinstance(obj, Proxy) else codeutils.prettyprint(obj)
    return f"{bsym.output.name} = getattr({obj_s}, {name!r})"


unpack_attr = make_prim(
    PrimIDs.UNPACK_ATTR,
    "unpack_attr",
    _unpack_attr_meta,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
    python_printer=_unpack_attr_printer,
)


def _check_tensor_metadata_meta(
    t: TensorProxy, shape: tuple, device: str, dtype: dtypes.dtype, requires_grad: bool, framework: str = "any"
) -> None:
    return None


def _check_tensor_metadata_impl(t, shape, device, dtype, requires_grad, framework="any") -> None:
    from thunder_tpu_torch.core.baseutils import GuardFailure
    from thunder_tpu_torch.executors.bridge import framework_of, is_concrete_tensor, tensor_metadata

    if not is_concrete_tensor(t):
        raise GuardFailure(f"Expected a tensor, got {type(t).__name__}")
    actual_shape, actual_device, actual_dtype, actual_rg = tensor_metadata(t)
    # A None extent is a symbolic (wildcard) dim: only the rank is enforced
    # here — the dim's value is unpacked by unpack_dim and constrained by
    # check_dim_bucket (cache="symbolic values").
    if (
        len(actual_shape) != len(shape)
        or any(s is not None and int(a) != int(s) for a, s in zip(actual_shape, shape))
        or actual_dtype != dtype
        or actual_rg != requires_grad
        or actual_device.split(":")[0] != str(device).split(":")[0]
        or (framework != "any" and framework_of(t) != framework)
    ):
        raise GuardFailure(
            f"Tensor metadata changed: expected {tuple(shape)}/{dtype}/{device}/rg={requires_grad}/{framework}, "
            f"got {tuple(actual_shape)}/{actual_dtype}/{actual_device}/rg={actual_rg}/{framework_of(t)}"
        )


check_tensor_shape_and_metadata = make_prim(
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA,
    "check_tensor_shape_and_metadata",
    _check_tensor_metadata_meta,
    tags=(OpTags.GUARD_OP, OpTags.DONT_DCE),
    python_impl=_check_tensor_metadata_impl,
)


def _check_number_meta(n: Any, value: Number) -> None:
    return None


def _check_number_impl(n, value) -> None:
    from thunder_tpu_torch.core.baseutils import GuardFailure

    if isinstance(n, NumberProxy):
        n = n.value
    if type(n) is not type(value):
        raise GuardFailure(f"Number type changed: expected {type(value).__name__}, got {type(n).__name__}")
    if not (n == value or (n != n and value != value)):
        raise GuardFailure(f"Number value changed: expected {value}, got {n}")


check_number_type_and_value = make_prim(
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    "check_number_type_and_value",
    _check_number_meta,
    tags=(OpTags.GUARD_OP, OpTags.DONT_DCE),
    python_impl=_check_number_impl,
)


def _check_string_meta(s: Any, value: str) -> None:
    return None


def _check_string_impl(s, value) -> None:
    from thunder_tpu_torch.core.baseutils import GuardFailure

    if s != value:
        raise GuardFailure(f"String value changed: expected {value!r}, got {s!r}")


check_string_value = make_prim(
    PrimIDs.CHECK_STRING_VALUE,
    "check_string_value",
    _check_string_meta,
    tags=(OpTags.GUARD_OP, OpTags.DONT_DCE),
    python_impl=_check_string_impl,
)


def _check_len_meta(seq: Any, length: int) -> None:
    return None


def _check_len_impl(seq, length) -> None:
    from thunder_tpu_torch.core.baseutils import GuardFailure

    try:
        n = len(seq)
    except TypeError:
        raise GuardFailure(f"Expected a sized collection, got {type(seq).__name__}")
    if n != length:
        raise GuardFailure(f"Length changed: expected {length}, got {n}")


def _check_keys_meta(d: Any, keys: tuple) -> None:
    return None


def _check_keys_impl(d, keys) -> None:
    from thunder_tpu_torch.core.baseutils import GuardFailure

    try:
        actual = tuple(d.keys())
    except AttributeError:
        raise GuardFailure(f"Expected a mapping, got {type(d).__name__}")
    # Order-insensitive: unpacking is key-based and leaf order sorts keys,
    # so {'a':..,'b':..} and {'b':..,'a':..} share a cache entry.
    if len(actual) != len(keys) or set(actual) != set(keys):
        raise GuardFailure(f"Dict keys changed: expected {tuple(keys)}, got {actual}")


check_keys = make_prim(
    PrimIDs.CHECK_KEYS,
    "check_keys",
    _check_keys_meta,
    tags=(OpTags.GUARD_OP, OpTags.DONT_DCE),
    python_impl=_check_keys_impl,
)


check_len = make_prim(
    PrimIDs.CHECK_LEN,
    "check_len",
    _check_len_meta,
    tags=(OpTags.GUARD_OP, OpTags.DONT_DCE),
    python_impl=_check_len_impl,
)


def _check_none_meta(x: Any) -> None:
    return None


def _check_none_impl(x) -> None:
    from thunder_tpu_torch.core.baseutils import GuardFailure

    if x is not None:
        raise GuardFailure(f"Expected None, got {type(x)}")


check_none = make_prim(
    PrimIDs.CHECK_NONE,
    "check_none",
    _check_none_meta,
    tags=(OpTags.GUARD_OP, OpTags.DONT_DCE),
    python_impl=_check_none_impl,
)


def _unpack_dim_meta(t: TensorProxy, dim: int) -> NumberProxy:
    # The observed (bucket-padded) extent is the known value; the proxy IS
    # the symbolic dim — the "lifted NumberProxy" of symbolic-values caching.
    from thunder_tpu_torch.core.proxies import IntegerProxy

    return IntegerProxy(int(t.shape[dim]))


def _unpack_dim_impl(t, dim: int) -> int:
    return int(t.shape[dim])


def _unpack_dim_printer(bsym) -> str:
    t, dim = bsym.args
    t_s = t.name if isinstance(t, Proxy) else codeutils.prettyprint(t)
    return f"{bsym.output.name} = {t_s}.shape[{dim}]"


unpack_dim = make_prim(
    PrimIDs.UNPACK_DIM,
    "unpack_dim",
    _unpack_dim_meta,
    tags=(OpTags.UNPACK_OP, OpTags.DONT_DCE),
    python_impl=_unpack_dim_impl,
    python_printer=_unpack_dim_printer,
)


def _check_dim_bucket_meta(d: Any, lo: int, hi: int) -> None:
    return None


def _check_dim_bucket_impl(d, lo: int, hi: int) -> None:
    from thunder_tpu_torch.core.baseutils import GuardFailure

    if isinstance(d, NumberProxy):
        d = d.value
    if not (lo < d <= hi):
        raise GuardFailure(f"Dim bucket changed: expected extent in ({lo}, {hi}], got {d}")


check_dim_bucket = make_prim(
    PrimIDs.CHECK_DIM_BUCKET,
    "check_dim_bucket",
    _check_dim_bucket_meta,
    tags=(OpTags.GUARD_OP, OpTags.DONT_DCE),
    python_impl=_check_dim_bucket_impl,
)


# =============================================================================
# Utility prims
# =============================================================================


def _del_meta(*args) -> None:
    return None


def _del_printer(bsym) -> str:
    names = ", ".join(a.name for a in bsym.args)
    return f"del {names}"


python_del = make_prim(
    PrimIDs.DEL,
    "python_del",
    _del_meta,
    tags=(OpTags.DONT_DCE,),
    python_printer=_del_printer,
)


def _return_meta(*args) -> None:
    return None


def _return_printer(bsym) -> str:
    if len(bsym.args) == 1:
        return f"return {codeutils.prettyprint(bsym.args[0])}"
    return f"return {codeutils.prettyprint(tuple(bsym.args))}"


python_return = make_prim(
    PrimIDs.RETURN,
    "python_return",
    _return_meta,
    tags=(OpTags.DONT_DCE,),
    python_printer=_return_printer,
)


def _comment_meta(s: str) -> None:
    return None


def _comment_printer(bsym) -> str:
    return f"# {bsym.args[0]}"


comment = make_prim(
    PrimIDs.COMMENT,
    "comment",
    _comment_meta,
    tags=(OpTags.DONT_DCE,),
    python_printer=_comment_printer,
)


def _print_meta(s: Any) -> None:
    return None


python_print = make_prim(
    PrimIDs.PRINT,
    "python_print",
    _print_meta,
    tags=(OpTags.DONT_DCE, OpTags.SIDE_EFFECT),
    python_impl=print,
)


# =============================================================================
# Data movement
# =============================================================================


def _convert_element_type_meta(a: TensorProxy | Number, dtype: dtypes.dtype) -> TensorProxy | Number:
    if isinstance(a, TensorProxy):
        return TensorProxy(like=a, dtype=dtype)
    # number conversion
    typ = dtypes.dtype_to_numbertype(dtype)
    v = pyval(a)
    return proxy(typ(v)) if v is not None else NumberProxy(None, python_type=typ)


convert_element_type = make_prim(
    PrimIDs.CONVERT_ELEMENT_TYPE,
    "convert_element_type",
    _convert_element_type_meta,
)


def _device_put_meta(a: TensorProxy, device: devices.Device) -> TensorProxy:
    return TensorProxy(like=a, device=devices.to_device(device))


device_put = make_prim(PrimIDs.DEVICE_PUT, "device_put", _device_put_meta)


def _item_meta(a: TensorProxy) -> NumberProxy:
    check(a.numel == 1, lambda: f"item() requires a single-element tensor, got shape {a.shape}")
    typ = dtypes.dtype_to_numbertype(a.dtype)
    return NumberProxy(None, python_type=typ)


item = make_prim(PrimIDs.ITEM, "item", _item_meta, tags=(OpTags.DEVICE_SYNC_OP,))


def _shallow_copy_meta(a: TensorProxy) -> TensorProxy:
    return TensorProxy(like=a)


shallow_copy = make_prim(PrimIDs.SHALLOW_COPY, "shallow_copy", _shallow_copy_meta)


def _stop_gradient_meta(a: TensorProxy) -> TensorProxy:
    return TensorProxy(like=a, requires_grad=False)


stop_gradient = make_prim(PrimIDs.STOP_GRADIENT, "stop_gradient", _stop_gradient_meta)


def _copy__meta(src: TensorProxy, dst: TensorProxy) -> TensorProxy:
    utils.check_same_device(src, dst, op="copy_")
    return TensorProxy(like=dst)


# IN_PLACE: writes into ``dst`` — the verifier flags any later consumer of the
# pre-mutation value; SIDE_EFFECT: the write is observable beyond the output,
# so DCE must keep it even when the returned proxy goes unused.
copy_ = make_prim(
    PrimIDs.COPY_, "copy_", _copy__meta, tags=(OpTags.IN_PLACE, OpTags.SIDE_EFFECT)
)


# =============================================================================
# Tensor creation
# =============================================================================


def _full_meta(shape: Sequence[int], fill_value: Number, *, device: devices.Device, dtype: dtypes.dtype) -> TensorProxy:
    return TensorProxy(shape=tuple(shape), device=devices.to_device(device), dtype=dtype)


full = make_prim(PrimIDs.FULL, "full", _full_meta)


def _iota_meta(length: Number, *, start: Number, step: Number, device: devices.Device, dtype: dtypes.dtype) -> TensorProxy:
    check(dtypes.is_exact_dtype(dtype) or dtypes.is_float_dtype(dtype), "iota requires a numeric dtype")
    return TensorProxy(shape=(int(pyval(length)),), device=devices.to_device(device), dtype=dtype)


iota = make_prim(PrimIDs.IOTA, "iota", _iota_meta)


def _uniform_meta(shape: Sequence[int], minval: Number, maxval: Number, *, device: devices.Device, dtype: dtypes.dtype) -> TensorProxy:
    check(dtypes.is_float_dtype(dtype), "uniform requires a float dtype")
    return TensorProxy(shape=tuple(shape), device=devices.to_device(device), dtype=dtype)


uniform = make_prim(PrimIDs.UNIFORM, "uniform", _uniform_meta, tags=(OpTags.RANDOM_OP,))


def _randn_meta(shape: Sequence[int], *, device: devices.Device, dtype: dtypes.dtype) -> TensorProxy:
    check(dtypes.is_float_dtype(dtype), "randn requires a float dtype")
    return TensorProxy(shape=tuple(shape), device=devices.to_device(device), dtype=dtype)


randn = make_prim(PrimIDs.RANDN, "randn", _randn_meta, tags=(OpTags.RANDOM_OP,))


# Keyed (functional) RNG prims: the rng functionalization pass rewrites
# UNIFORM/RANDN into these, threading an explicit key input through the
# trace, so the whole program stays a pure function of its inputs.


def _uniform_keyed_meta(shape, minval, maxval, key: TensorProxy, salt: int, *, device, dtype) -> TensorProxy:
    check(dtypes.is_float_dtype(dtype), "uniform requires a float dtype")
    return TensorProxy(shape=tuple(shape), device=devices.to_device(device), dtype=dtype)


uniform_keyed = make_prim(PrimIDs.UNIFORM_KEYED, "uniform_keyed", _uniform_keyed_meta)


def _randn_keyed_meta(shape, key: TensorProxy, salt: int, *, device, dtype) -> TensorProxy:
    check(dtypes.is_float_dtype(dtype), "randn requires a float dtype")
    return TensorProxy(shape=tuple(shape), device=devices.to_device(device), dtype=dtype)


randn_keyed = make_prim(PrimIDs.RANDN_KEYED, "randn_keyed", _randn_keyed_meta)


def _tensor_from_sequence_meta(seq: Any, *, device: devices.Device, dtype: Optional[dtypes.dtype]) -> TensorProxy:
    # Infer shape/dtype from the (nested) sequence of numbers.
    def shape_of(s):
        if isinstance(s, (list, tuple)):
            if len(s) == 0:
                return (0,)
            inner = shape_of(s[0])
            return (len(s),) + inner
        return ()

    def leaf(s):
        while isinstance(s, (list, tuple)):
            s = s[0]
        return s

    shape = shape_of(seq)
    if dtype is None:
        lv = leaf(seq)
        if isinstance(lv, (list, tuple)):  # fully empty sequence
            dtype = dtypes.float32
        else:
            dtype = dtypes.to_strong(
                dtypes.numbertype_to_dtype(type(pyval(lv)) if isinstance(lv, NumberProxy) else type(lv))
            )
        if dtype == dtypes.float64:
            dtype = dtypes.float32
    return TensorProxy(shape=shape, device=devices.to_device(device), dtype=dtype)


tensor_from_sequence = make_prim(PrimIDs.TENSOR_FROM_SEQUENCE, "tensor_from_sequence", _tensor_from_sequence_meta)


# =============================================================================
# Shape ops
# =============================================================================


def _broadcast_in_dim_meta(a: TensorProxy, shape: Sequence[int], broadcast_dimensions: Sequence[int]) -> TensorProxy:
    check(len(broadcast_dimensions) == a.ndim, "broadcast_dimensions must match input rank")
    for i, d in enumerate(broadcast_dimensions):
        check(a.shape[i] == 1 or a.shape[i] == shape[d], lambda: f"Cannot broadcast {a.shape} into {shape}")
    return TensorProxy(like=a, shape=tuple(shape))


broadcast_in_dim = make_prim(
    PrimIDs.BROADCAST_IN_DIM, "broadcast_in_dim", _broadcast_in_dim_meta, tags=(OpTags.SHAPE_OP,)
)


def _cat_meta(tensors: Sequence[TensorProxy], dim: int) -> TensorProxy:
    check(len(tensors) > 0, "cat of zero tensors")
    first = tensors[0]
    dim = canonicalize_dim(first.ndim, dim)
    total = 0
    for t in tensors:
        check(t.ndim == first.ndim, "cat rank mismatch")
        for i in range(first.ndim):
            if i != dim:
                check(t.shape[i] == first.shape[i], lambda: f"cat shape mismatch at dim {i}")
        total += t.shape[dim]
    shape = list(first.shape)
    shape[dim] = total
    return TensorProxy(like=first, shape=tuple(shape))


cat = make_prim(PrimIDs.CAT, "cat", _cat_meta, tags=(OpTags.SHAPE_OP,))


def _flip_meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
    canonicalize_dims(a.ndim, tuple(dims))
    return TensorProxy(like=a)


flip = make_prim(PrimIDs.FLIP, "flip", _flip_meta, tags=(OpTags.SHAPE_OP,))


def _pad_meta(a: TensorProxy, padding_value: Number, padding_config: Sequence[tuple]) -> TensorProxy:
    check(len(padding_config) == a.ndim, "padding_config must have one (lo, hi, dilation) per dim")
    shape = []
    for s, (lo, hi, dil) in zip(a.shape, padding_config):
        out = s + lo + hi + max(0, s - 1) * dil
        check(out >= 0, "negative padded dimension")
        shape.append(out)
    return TensorProxy(like=a, shape=tuple(shape))


pad = make_prim(PrimIDs.PAD, "pad", _pad_meta, tags=(OpTags.SHAPE_OP,))


def _reshape_meta(a: TensorProxy, shape: Sequence[int]) -> TensorProxy:
    numel = 1
    for s in shape:
        numel *= int(s)
    check(numel == a.numel, lambda: f"reshape {a.shape} -> {tuple(shape)} changes element count")
    return TensorProxy(like=a, shape=tuple(int(s) for s in shape))


reshape = make_prim(PrimIDs.RESHAPE, "reshape", _reshape_meta, tags=(OpTags.SHAPE_OP,))


def _slice_meta(a: TensorProxy, start_indices: Sequence[int], end_indices: Sequence[int], strides: Optional[Sequence[int]] = None) -> TensorProxy:
    strides = strides if strides is not None else [1] * a.ndim
    shape = []
    for s, lo, hi, st in zip(a.shape, start_indices, end_indices, strides):
        check(0 <= lo <= hi <= s, lambda: f"invalid slice [{lo}:{hi}] for dim of size {s}")
        check(st > 0, "slice stride must be positive")
        shape.append((hi - lo + st - 1) // st)
    return TensorProxy(like=a, shape=tuple(shape))


slice_prim = make_prim(PrimIDs.SLICE, "slice_prim", _slice_meta, tags=(OpTags.SHAPE_OP,))


def _squeeze_meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
    dims = canonicalize_dims(a.ndim, tuple(dims))
    for d in dims:
        check(a.shape[d] == 1, lambda: f"Cannot squeeze dim {d} of size {a.shape[d]}")
    shape = [s for i, s in enumerate(a.shape) if i not in dims]
    return TensorProxy(like=a, shape=tuple(shape))


squeeze = make_prim(PrimIDs.SQUEEZE, "squeeze", _squeeze_meta, tags=(OpTags.SHAPE_OP,))


def _transpose_meta(a: TensorProxy, permutation: Sequence[int]) -> TensorProxy:
    utils.check_valid_permutation(a.ndim, permutation)
    shape = tuple(a.shape[i] for i in permutation)
    return TensorProxy(like=a, shape=shape)


transpose = make_prim(PrimIDs.TRANSPOSE, "transpose", _transpose_meta, tags=(OpTags.SHAPE_OP,))


def _setitem_meta(a: TensorProxy, key, value) -> TensorProxy:
    """Out-of-place indexed update: a copy of ``a`` with ``a[key] = value``
    applied (numpy basic+advanced indexing semantics)."""
    return TensorProxy(like=a)


setitem = make_prim(PrimIDs.SETITEM, "setitem", _setitem_meta)


def _take_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    dim = canonicalize_dim(a.ndim, dim)
    check(dtypes.is_nonboolean_integer_dtype(indices.dtype), "take requires integer indices")
    check(indices.ndim <= 1, "take requires a 0/1-D index tensor")
    n = indices.numel if indices.ndim == 1 else 1
    shape = list(a.shape)
    if indices.ndim == 1:
        shape[dim] = n
    else:
        del shape[dim]
    return TensorProxy(like=a, shape=tuple(shape))


take = make_prim(PrimIDs.TAKE, "take", _take_meta)


def _take_along_axis_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    dim = canonicalize_dim(a.ndim, dim)
    check(indices.ndim == a.ndim, "take_along_axis requires same-rank indices")
    return TensorProxy(like=a, shape=indices.shape)


take_along_axis = make_prim(PrimIDs.TAKE_ALONG_AXIS, "take_along_axis", _take_along_axis_meta)


def _gather_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    dim = canonicalize_dim(a.ndim, dim)
    check(indices.ndim == a.ndim, "gather requires same-rank indices")
    return TensorProxy(like=a, shape=indices.shape)


gather = make_prim(PrimIDs.GATHER, "gather", _gather_meta)


def _scatter_add_meta(a: TensorProxy, indices: TensorProxy, value: TensorProxy, dim: int) -> TensorProxy:
    canonicalize_dim(a.ndim, dim)
    return TensorProxy(like=a)


scatter_add = make_prim(PrimIDs.SCATTER_ADD, "scatter_add", _scatter_add_meta)


def _index_put_meta(a: TensorProxy, indices: Sequence[TensorProxy], values: TensorProxy, accumulate: bool) -> TensorProxy:
    return TensorProxy(like=a)


index_put = make_prim(PrimIDs.INDEX_PUT, "index_put", _index_put_meta)


def _argsort_meta(a: TensorProxy, dim: int, descending: bool) -> TensorProxy:
    canonicalize_dim(a.ndim, dim)
    return TensorProxy(like=a, dtype=dtypes.int64)


argsort = make_prim(PrimIDs.ARGSORT, "argsort", _argsort_meta)


def _sort_meta(a: TensorProxy, dim: int, descending: bool) -> tuple:
    canonicalize_dim(a.ndim, dim)
    return TensorProxy(like=a), TensorProxy(like=a, dtype=dtypes.int64)


sort = make_prim(PrimIDs.SORT, "sort", _sort_meta)


def _cumsum_meta(a: TensorProxy, dim: int) -> TensorProxy:
    canonicalize_dim(a.ndim, dim)
    out_dtype = dtypes.int64 if dtypes.is_exact_dtype(a.dtype) else a.dtype
    return TensorProxy(like=a, dtype=out_dtype)


cumsum = make_prim(PrimIDs.CUMSUM, "cumsum", _cumsum_meta)


def _cumprod_meta(a: TensorProxy, dim: int) -> TensorProxy:
    canonicalize_dim(a.ndim, dim)
    out_dtype = dtypes.int64 if dtypes.is_exact_dtype(a.dtype) else a.dtype
    return TensorProxy(like=a, dtype=out_dtype)


cumprod = make_prim(PrimIDs.CUMPROD, "cumprod", _cumprod_meta)


def _topk_meta(a: TensorProxy, k: int, dim: int, largest: bool, sorted: bool) -> tuple:
    dim = canonicalize_dim(a.ndim, dim)
    check(0 <= k <= a.shape[dim], lambda: f"topk k={k} out of range for dim of size {a.shape[dim]}")
    shape = list(a.shape)
    shape[dim] = k
    return (
        TensorProxy(like=a, shape=tuple(shape)),
        TensorProxy(like=a, shape=tuple(shape), dtype=dtypes.int64),
    )


topk = make_prim(PrimIDs.TOPK, "topk", _topk_meta)


# =============================================================================
# Elementwise prims
# =============================================================================


def _number_fold(op_name: str, *args):
    """Constant-fold a number-only prim application at trace time."""
    import math

    vals = [pyval(a) for a in args]
    if any(v is None for v in vals):
        typ = args[0].python_type if isinstance(args[0], NumberProxy) else type(vals[0])
        return NumberProxy(None, python_type=typ)
    table = {
        "abs": abs,
        "ceil": math.ceil,
        "floor": math.floor,
        "neg": lambda a: -a,
        "add": lambda a, b: a + b,
        "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b,
        "div": lambda a, b: a / b,
        "pow": lambda a, b: a**b,
        "maximum": max,
        "minimum": min,
        "eq": lambda a, b: a == b,
        "ne": lambda a, b: a != b,
        "lt": lambda a, b: a < b,
        "le": lambda a, b: a <= b,
        "gt": lambda a, b: a > b,
        "ge": lambda a, b: a >= b,
        "exp": math.exp,
        "log": math.log,
        "sqrt": math.sqrt,
        "sin": math.sin,
        "cos": math.cos,
        "tanh": math.tanh,
    }
    fn = table.get(op_name)
    if fn is None:
        return NumberProxy(None, python_type=type(vals[0]))
    return proxy(fn(*vals))


def _elementwise_unary_meta_factory(name: str, *, type_promotion_kind, supported=None):
    def meta(a):
        if isinstance(a, (Number, NumberProxy)):
            return _number_fold(name, a)
        check(isinstance(a, TensorProxy), lambda: f"{name} expects a tensor or number, got {type(a)}")
        if supported is not None:
            check(a.dtype.kind in supported, lambda: f"{name} does not support dtype {a.dtype}")
        _, result_dtype = utils.elementwise_type_promotion(a, type_promotion_kind=type_promotion_kind)
        return TensorProxy(like=a, dtype=result_dtype)

    return meta


_K = ELEMENTWISE_TYPE_PROMOTION_KIND


def _make_elementwise_unary(id: PrimIDs, name: str, *, tpk=_K.PRESERVE, supported=None) -> Symbol:
    return make_prim(
        id,
        name,
        _elementwise_unary_meta_factory(name, type_promotion_kind=tpk, supported=supported),
        tags=(OpTags.ELEMENTWISE_UNARY_OP,),
    )


_float_kinds = ("float", "complex")

abs_prim = _make_elementwise_unary(PrimIDs.ABS, "abs", tpk=_K.COMPLEX_TO_FLOAT)
acos = _make_elementwise_unary(PrimIDs.ACOS, "acos", supported=_float_kinds)
acosh = _make_elementwise_unary(PrimIDs.ACOSH, "acosh", supported=_float_kinds)
asin = _make_elementwise_unary(PrimIDs.ASIN, "asin", supported=_float_kinds)
asinh = _make_elementwise_unary(PrimIDs.ASINH, "asinh", supported=_float_kinds)
atan = _make_elementwise_unary(PrimIDs.ATAN, "atan", supported=_float_kinds)
atanh = _make_elementwise_unary(PrimIDs.ATANH, "atanh", supported=_float_kinds)
bitwise_not = _make_elementwise_unary(PrimIDs.BITWISE_NOT, "bitwise_not", supported=("bool", "int", "uint"))
ceil = _make_elementwise_unary(PrimIDs.CEIL, "ceil", supported=("float",))
cos = _make_elementwise_unary(PrimIDs.COS, "cos", supported=_float_kinds)
cosh = _make_elementwise_unary(PrimIDs.COSH, "cosh", supported=_float_kinds)
digamma = _make_elementwise_unary(PrimIDs.DIGAMMA, "digamma", supported=("float",))
erf = _make_elementwise_unary(PrimIDs.ERF, "erf", supported=("float",))
erfc = _make_elementwise_unary(PrimIDs.ERFC, "erfc", supported=("float",))
erfinv = _make_elementwise_unary(PrimIDs.ERFINV, "erfinv", supported=("float",))
exp = _make_elementwise_unary(PrimIDs.EXP, "exp", supported=_float_kinds)
exp2 = _make_elementwise_unary(PrimIDs.EXP2, "exp2", supported=("float",))
expm1 = _make_elementwise_unary(PrimIDs.EXPM1, "expm1", supported=("float",))
floor = _make_elementwise_unary(PrimIDs.FLOOR, "floor", supported=("float",))
isfinite = _make_elementwise_unary(PrimIDs.ISFINITE, "isfinite", tpk=_K.ALWAYS_BOOL)
isinf = _make_elementwise_unary(PrimIDs.ISINF, "isinf", tpk=_K.ALWAYS_BOOL)
isnan = _make_elementwise_unary(PrimIDs.ISNAN, "isnan", tpk=_K.ALWAYS_BOOL)
lgamma = _make_elementwise_unary(PrimIDs.LGAMMA, "lgamma", supported=("float",))
log = _make_elementwise_unary(PrimIDs.LOG, "log", supported=_float_kinds)
log10 = _make_elementwise_unary(PrimIDs.LOG10, "log10", supported=("float",))
log1p = _make_elementwise_unary(PrimIDs.LOG1P, "log1p", supported=("float",))
log2 = _make_elementwise_unary(PrimIDs.LOG2, "log2", supported=("float",))
neg = _make_elementwise_unary(PrimIDs.NEG, "neg")
reciprocal = _make_elementwise_unary(PrimIDs.RECIPROCAL, "reciprocal", supported=_float_kinds)
round_prim = _make_elementwise_unary(PrimIDs.ROUND, "round", supported=("float",))
rsqrt = _make_elementwise_unary(PrimIDs.RSQRT, "rsqrt", supported=_float_kinds)
sign = _make_elementwise_unary(PrimIDs.SIGN, "sign")
signbit = _make_elementwise_unary(PrimIDs.SIGNBIT, "signbit", tpk=_K.ALWAYS_BOOL)
sin = _make_elementwise_unary(PrimIDs.SIN, "sin", supported=_float_kinds)
sinh = _make_elementwise_unary(PrimIDs.SINH, "sinh", supported=_float_kinds)
sqrt = _make_elementwise_unary(PrimIDs.SQRT, "sqrt", supported=_float_kinds)
tan = _make_elementwise_unary(PrimIDs.TAN, "tan", supported=_float_kinds)
tanh = _make_elementwise_unary(PrimIDs.TANH, "tanh", supported=_float_kinds)
trunc = _make_elementwise_unary(PrimIDs.TRUNC, "trunc", supported=("float",))
real = _make_elementwise_unary(PrimIDs.REAL, "real", tpk=_K.COMPLEX_TO_FLOAT, supported=_float_kinds)
imag = _make_elementwise_unary(PrimIDs.IMAG, "imag", tpk=_K.COMPLEX_TO_FLOAT, supported=("complex",))


def _elementwise_binary_meta_factory(name: str, *, type_promotion_kind):
    def meta(a, b):
        if isinstance(a, (Number, NumberProxy)) and isinstance(b, (Number, NumberProxy)):
            return _number_fold(name, a, b)
        check(
            isinstance(a, (TensorProxy, Number, NumberProxy)) and isinstance(b, (TensorProxy, Number, NumberProxy)),
            lambda: f"{name} expects tensors/numbers",
        )
        ta = a if isinstance(a, TensorProxy) else b
        if isinstance(a, TensorProxy) and isinstance(b, TensorProxy):
            utils.check_same_shape(a, b, op=name)
            utils.check_same_device(a, b, op=name)
            check(
                a.dtype == b.dtype,
                lambda: f"{name} prim requires same dtypes, got {a.dtype} and {b.dtype} (promote in clang)",
            )
        _, result_dtype = utils.elementwise_type_promotion(a, b, type_promotion_kind=type_promotion_kind)
        return TensorProxy(like=ta, dtype=result_dtype)

    return meta


def _make_elementwise_binary(id: PrimIDs, name: str, *, tpk=_K.PRESERVE) -> Symbol:
    return make_prim(
        id,
        name,
        _elementwise_binary_meta_factory(name, type_promotion_kind=tpk),
        tags=(OpTags.ELEMENTWISE_BINARY_OP,),
    )


add = _make_elementwise_binary(PrimIDs.ADD, "add")
atan2 = _make_elementwise_binary(PrimIDs.ATAN2, "atan2")
bitwise_and = _make_elementwise_binary(PrimIDs.BITWISE_AND, "bitwise_and")
bitwise_or = _make_elementwise_binary(PrimIDs.BITWISE_OR, "bitwise_or")
bitwise_xor = _make_elementwise_binary(PrimIDs.BITWISE_XOR, "bitwise_xor")
bitwise_left_shift = _make_elementwise_binary(PrimIDs.BITWISE_LEFT_SHIFT, "bitwise_left_shift")
bitwise_right_shift = _make_elementwise_binary(PrimIDs.BITWISE_RIGHT_SHIFT, "bitwise_right_shift")
div = _make_elementwise_binary(PrimIDs.DIV, "div")
eq = _make_elementwise_binary(PrimIDs.EQ, "eq", tpk=_K.ALWAYS_BOOL)
fmod = _make_elementwise_binary(PrimIDs.FMOD, "fmod")
ge = _make_elementwise_binary(PrimIDs.GE, "ge", tpk=_K.ALWAYS_BOOL)
gt = _make_elementwise_binary(PrimIDs.GT, "gt", tpk=_K.ALWAYS_BOOL)
le = _make_elementwise_binary(PrimIDs.LE, "le", tpk=_K.ALWAYS_BOOL)
lt = _make_elementwise_binary(PrimIDs.LT, "lt", tpk=_K.ALWAYS_BOOL)
maximum = _make_elementwise_binary(PrimIDs.MAXIMUM, "maximum")
minimum = _make_elementwise_binary(PrimIDs.MINIMUM, "minimum")
mul = _make_elementwise_binary(PrimIDs.MUL, "mul")
ne = _make_elementwise_binary(PrimIDs.NE, "ne", tpk=_K.ALWAYS_BOOL)
nextafter = _make_elementwise_binary(PrimIDs.NEXTAFTER, "nextafter")
pow_prim = _make_elementwise_binary(PrimIDs.POW, "pow")
remainder = _make_elementwise_binary(PrimIDs.REMAINDER, "remainder")
sub = _make_elementwise_binary(PrimIDs.SUB, "sub")
copysign = _make_elementwise_binary(PrimIDs.COPYSIGN, "copysign")
zeta = _make_elementwise_binary(PrimIDs.ZETA, "zeta")


def _polygamma_meta(n: int, a: TensorProxy) -> TensorProxy:
    check(isinstance(a, TensorProxy), "polygamma expects a tensor")
    check(dtypes.is_float_dtype(a.dtype), "polygamma requires a float tensor")
    return TensorProxy(like=a)


# No ELEMENTWISE_UNARY_OP tag: args[0] is an int order (not a tensor), and the
# op is expensive — remat's cheap-to-recompute heuristic must not claim it.
polygamma = make_prim(PrimIDs.POLYGAMMA, "polygamma", _polygamma_meta)


def _where_meta(pred, a, b):
    if isinstance(pred, TensorProxy):
        check(dtypes.is_boolean_dtype(pred.dtype), "where predicate must be boolean")
    ta = a if isinstance(a, TensorProxy) else (b if isinstance(b, TensorProxy) else pred)
    check(isinstance(ta, TensorProxy), "where prim requires at least one tensor input")
    shapes = [x.shape for x in (pred, a, b) if isinstance(x, TensorProxy)]
    first = shapes[0]
    check(all(tuple(s) == tuple(first) for s in shapes), "where prim requires same shapes (broadcast in clang)")
    _, result_dtype = utils.elementwise_type_promotion(a, b, type_promotion_kind=_K.PRESERVE)
    return TensorProxy(like=ta, shape=first, dtype=result_dtype)


where = make_prim(PrimIDs.WHERE, "where", _where_meta)


# =============================================================================
# Reductions
# =============================================================================


def _reduction_output_shape(shape: tuple, dims: tuple) -> tuple:
    return tuple(s for i, s in enumerate(shape) if i not in dims)


def _reduction_meta_factory(name: str, *, output_dtype_fn=None):
    def meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
        check(isinstance(a, TensorProxy), lambda: f"{name} expects a tensor")
        dims = canonicalize_dims(a.ndim, tuple(dims))
        utils.check_no_duplicates(dims)
        shape = _reduction_output_shape(a.shape, dims)
        out_dtype = output_dtype_fn(a) if output_dtype_fn is not None else a.dtype
        return TensorProxy(like=a, shape=shape, dtype=out_dtype)

    return meta


def _sum_dtype(a: TensorProxy) -> dtypes.dtype:
    # torch semantics: bool/int sums accumulate in int64
    if dtypes.is_exact_dtype(a.dtype):
        return dtypes.int64
    return a.dtype


amax = make_prim(PrimIDs.AMAX, "amax", _reduction_meta_factory("amax"), tags=(OpTags.REDUCTION_OP,))
amin = make_prim(PrimIDs.AMIN, "amin", _reduction_meta_factory("amin"), tags=(OpTags.REDUCTION_OP,))
prod = make_prim(PrimIDs.PROD, "prod", _reduction_meta_factory("prod", output_dtype_fn=_sum_dtype), tags=(OpTags.REDUCTION_OP,))
sum_prim = make_prim(PrimIDs.SUM, "sum", _reduction_meta_factory("sum", output_dtype_fn=_sum_dtype), tags=(OpTags.REDUCTION_OP,))


def _var_meta(a: TensorProxy, dims: Sequence[int], *, correction: Number) -> TensorProxy:
    check(dtypes.is_inexact_dtype(a.dtype), "var requires float/complex input")
    dims = canonicalize_dims(a.ndim, tuple(dims))
    shape = _reduction_output_shape(a.shape, dims)
    out_dtype = dtypes.corresponding_real_dtype(a.dtype)
    return TensorProxy(like=a, shape=shape, dtype=out_dtype)


var = make_prim(PrimIDs.VAR, "var", _var_meta, tags=(OpTags.REDUCTION_OP,))


def _var_mean_meta(a: TensorProxy, dims: Sequence[int], *, correction: Number) -> tuple:
    v = _var_meta(a, dims, correction=correction)
    dims_c = canonicalize_dims(a.ndim, tuple(dims))
    shape = _reduction_output_shape(a.shape, dims_c)
    m = TensorProxy(like=a, shape=shape)
    return v, m


var_mean = make_prim(PrimIDs.VAR_MEAN, "var_mean", _var_mean_meta, tags=(OpTags.REDUCTION_OP,))


def _argminmax_meta(a: TensorProxy, dim: Optional[int]) -> TensorProxy:
    if dim is None:
        return TensorProxy(like=a, shape=(), dtype=dtypes.int64)
    dim = canonicalize_dim(a.ndim, dim)
    shape = _reduction_output_shape(a.shape, (dim,))
    return TensorProxy(like=a, shape=shape, dtype=dtypes.int64)


argmax = make_prim(PrimIDs.ARGMAX, "argmax", _argminmax_meta, tags=(OpTags.REDUCTION_OP,))
argmin = make_prim(PrimIDs.ARGMIN, "argmin", _argminmax_meta, tags=(OpTags.REDUCTION_OP,))


# =============================================================================
# Linear algebra / NN prims
# =============================================================================


def _matmul_meta(a: TensorProxy, b: TensorProxy) -> TensorProxy:
    check(isinstance(a, TensorProxy) and isinstance(b, TensorProxy), "matmul expects tensors")
    check(a.ndim >= 1 and b.ndim >= 1, "matmul requires rank >= 1")
    check(a.dtype == b.dtype, lambda: f"matmul dtype mismatch {a.dtype} vs {b.dtype}")
    if a.ndim == 1 and b.ndim == 1:
        check(a.shape[0] == b.shape[0], "matmul contraction mismatch")
        return TensorProxy(like=a, shape=())
    if a.ndim == 1:
        check(a.shape[0] == b.shape[-2], "matmul contraction mismatch")
        return TensorProxy(like=b, shape=b.shape[:-2] + (b.shape[-1],))
    if b.ndim == 1:
        check(a.shape[-1] == b.shape[0], "matmul contraction mismatch")
        return TensorProxy(like=a, shape=a.shape[:-1])
    check(a.shape[-1] == b.shape[-2], lambda: f"matmul contraction mismatch {a.shape} @ {b.shape}")
    batch = compute_broadcast_shape(a.shape[:-2], b.shape[:-2])
    return TensorProxy(like=a, shape=batch + (a.shape[-2], b.shape[-1]))


matmul = make_prim(PrimIDs.MATMUL, "matmul", _matmul_meta, tags=(OpTags.MATMUL_OP,))


def _linear_meta(a: TensorProxy, w: TensorProxy, bias: Optional[TensorProxy]) -> TensorProxy:
    check(w.ndim == 2, "linear weight must be 2D (out_features, in_features)")
    check(a.shape[-1] == w.shape[1], lambda: f"linear: input {a.shape} vs weight {w.shape}")
    if bias is not None:
        check(bias.ndim == 1 and bias.shape[0] == w.shape[0], "linear bias shape mismatch")
    return TensorProxy(like=a, shape=a.shape[:-1] + (w.shape[0],))


linear = make_prim(PrimIDs.LINEAR, "linear", _linear_meta, tags=(OpTags.MATMUL_OP,))


def _convolution_meta(
    a: TensorProxy,
    weight: TensorProxy,
    bias: Optional[TensorProxy],
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    groups: int,
) -> TensorProxy:
    # a: (N, C_in, *spatial); weight: (C_out, C_in/groups, *kernel)
    check(a.ndim == weight.ndim, "convolution input/weight rank mismatch")
    spatial = a.ndim - 2
    check(spatial >= 1, "convolution requires at least one spatial dim")
    check(a.shape[1] == weight.shape[1] * groups, "convolution channel mismatch")
    out_spatial = []
    for i in range(spatial):
        s_in = a.shape[2 + i]
        k = weight.shape[2 + i]
        st = stride[i] if i < len(stride) else stride[-1]
        p = padding[i] if i < len(padding) else padding[-1]
        d = dilation[i] if i < len(dilation) else dilation[-1]
        out = (s_in + 2 * p - d * (k - 1) - 1) // st + 1
        out_spatial.append(out)
    return TensorProxy(like=a, shape=(a.shape[0], weight.shape[0], *out_spatial))


convolution = make_prim(PrimIDs.CONVOLUTION, "convolution", _convolution_meta, tags=(OpTags.MATMUL_OP,))


def _convolution_bwd_meta(
    g: TensorProxy,
    a: TensorProxy,
    weight: TensorProxy,
    stride: Sequence[int],
    padding: Sequence[int],
    dilation: Sequence[int],
    groups: int,
) -> tuple:
    """(d_input, d_weight) of `convolution` (reference seat: the torch conv
    backward ATen kernels)."""
    return TensorProxy(like=a), TensorProxy(like=weight)


convolution_bwd = make_prim(
    PrimIDs.CONVOLUTION_BWD, "convolution_bwd", _convolution_bwd_meta, tags=(OpTags.MATMUL_OP,)
)


def _embedding_meta(indices: TensorProxy, weight: TensorProxy) -> TensorProxy:
    check(weight.ndim == 2, "embedding weight must be 2D")
    check(dtypes.is_nonboolean_integer_dtype(indices.dtype), "embedding indices must be integer")
    return TensorProxy(like=weight, shape=indices.shape + (weight.shape[1],))


embedding = make_prim(PrimIDs.EMBEDDING, "embedding", _embedding_meta)


def _embedding_backward_meta(grad: TensorProxy, indices: TensorProxy, num_weights: int, embed_dim: int) -> TensorProxy:
    return TensorProxy(like=grad, shape=(num_weights, embed_dim))


embedding_backward = make_prim(PrimIDs.EMBEDDING_BACKWARD, "embedding_backward", _embedding_backward_meta)


def _pool_out_spatial(in_sizes, window, strides, padding):
    out = []
    for s, w, st, (lo, hi) in zip(in_sizes, window, strides, padding):
        out.append((s + lo + hi - w) // st + 1)
    return tuple(out)


def _pool_meta(
    a: TensorProxy, kind: str, window: Sequence[int], strides: Sequence[int],
    padding: Sequence[tuple],
) -> TensorProxy:
    """Window reduction over the trailing len(window) dims of (N, C, *spatial)
    input (reference seat: the torch max/avg_poolNd ATen calls,
    thunder/torch/__init__.py max_pool1d..avg_pool3d)."""
    check(kind in ("max", "avg"), lambda: f"Unknown pool kind {kind}")
    k = len(window)
    check(a.ndim >= k + 1, "pool input rank too small for window")
    spatial = _pool_out_spatial(a.shape[-k:], window, strides, padding)
    return TensorProxy(like=a, shape=tuple(a.shape[:-k]) + spatial)


pool = make_prim(PrimIDs.POOL, "pool", _pool_meta, tags=(OpTags.REDUCTION_OP,))


def _pool_bwd_meta(g: TensorProxy, a: TensorProxy, kind: str, window, strides, padding) -> TensorProxy:
    return TensorProxy(like=a)


pool_bwd = make_prim(PrimIDs.POOL_BWD, "pool_bwd", _pool_bwd_meta)


def _uniform_philox_meta(
    shape: Sequence[int], minval: Number, maxval: Number, *, seed, offset,
    device: devices.Device, dtype: dtypes.dtype,
) -> TensorProxy:
    """Counter-based (stateless) uniform: same (seed, offset) → same bits
    (reference: thunder/core/prims.py `uniform_philox:142`). Pure given its
    args, so it stages under jit without the RNG functionalization pass."""
    check(dtypes.is_float_dtype(dtype), "uniform_philox requires a float dtype")
    return TensorProxy(shape=tuple(shape), device=devices.to_device(device), dtype=dtype)


uniform_philox = make_prim(PrimIDs.UNIFORM_PHILOX, "uniform_philox", _uniform_philox_meta)


# Generated code prints prims qualified as ``prims.<name>``.
from thunder_tpu_torch.core.symbol import register_module as _register_module  # noqa: E402

_register_module("prims", __import__("sys").modules[__name__])
