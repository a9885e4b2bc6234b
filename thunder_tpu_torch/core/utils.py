"""Meta-function utilities: type promotion, broadcasting, shape checks.

Reference parity: thunder/core/utils.py (type-promotion helpers `:351-483`,
`check_same_device`, canonicalize helpers). Promotion implements torch's
number/tensor semantics — weak (Python-number) dtypes only bump the kind,
never the width — because the port must reproduce torch numerics.
"""

from __future__ import annotations

import enum
from numbers import Number
from typing import Any, Optional, Sequence

from thunder_tpu_torch.core import dtypes, devices
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.proxies import NumberProxy, TensorProxy, pyval, pytype


# -- dtype promotion ---------------------------------------------------------


class ELEMENTWISE_TYPE_PROMOTION_KIND(enum.Enum):
    DEFAULT = enum.auto()
    PRESERVE = enum.auto()
    INT_TO_FLOAT = enum.auto()
    ALWAYS_BOOL = enum.auto()
    COMPLEX_TO_FLOAT = enum.auto()
    BOOL_TO_LONG = enum.auto()


_KIND_ORDER = {"bool": 0, "uint": 1, "int": 1, "float": 2, "complex": 3}

_int_widths = [dtypes.uint8, dtypes.int8, dtypes.int16, dtypes.int32, dtypes.int64]
_float_widths = [dtypes.float8_e4m3, dtypes.float8_e5m2, dtypes.float16, dtypes.bfloat16, dtypes.float32, dtypes.float64]


def _wider(a: dtypes.dtype, b: dtypes.dtype) -> dtypes.dtype:
    """Widest of two same-kind dtypes, with torch pairing rules for mixed
    sub-byte/half types (f16+bf16 → f32; u8+i8 → i16)."""
    if a == b:
        return a
    ka, kb = a.kind, b.kind
    if ka in ("int", "uint") and kb in ("int", "uint"):
        if {a, b} == {dtypes.uint8, dtypes.int8}:
            return dtypes.int16
        return a if a.bytes >= b.bytes else b
    if ka == "float" and kb == "float":
        pair = {a, b}
        if pair == {dtypes.float16, dtypes.bfloat16}:
            return dtypes.float32
        if dtypes.float8_e4m3 in pair or dtypes.float8_e5m2 in pair:
            if pair == {dtypes.float8_e4m3, dtypes.float8_e5m2}:
                return dtypes.float16
            other = (pair - {dtypes.float8_e4m3, dtypes.float8_e5m2}).pop()
            return other
        return a if a.bytes >= b.bytes else b
    if ka == "complex" and kb == "complex":
        return a if a.bytes >= b.bytes else b
    raise AssertionError(f"_wider on mixed kinds {a} {b}")


_default_for_kind = {
    "bool": dtypes.bool8,
    "int": dtypes.int64,
    "uint": dtypes.int64,
    "float": dtypes.float32,
    "complex": dtypes.complex64,
}


def dtype_of(x: Any) -> dtypes.dtype:
    """True (possibly weak) dtype of a tensor proxy, number proxy, or number."""
    if isinstance(x, TensorProxy):
        return x.true_dtype
    if isinstance(x, NumberProxy):
        return dtypes.numbertype_to_dtype(x.python_type)
    if isinstance(x, Number):
        return dtypes.numbertype_to_dtype(type(x) if not isinstance(x, bool) else bool)
    raise ValueError(f"No dtype for {x!r}")


def elementwise_type_promotion(
    *args: Any, type_promotion_kind: ELEMENTWISE_TYPE_PROMOTION_KIND = ELEMENTWISE_TYPE_PROMOTION_KIND.DEFAULT
) -> tuple[dtypes.dtype, dtypes.dtype]:
    """(computation_dtype, result_dtype) for an elementwise op over ``args``.

    Reference parity: thunder/core/utils.py:351-483. Tensor (strong) dtypes
    dominate number (weak) dtypes of lower-or-equal kind; a number of a
    strictly higher kind bumps the result to the default dtype of that kind.
    """
    check(len(args) > 0, "Type promotion needs at least one argument")

    strong: Optional[dtypes.dtype] = None
    weak: Optional[dtypes.dtype] = None
    for a in args:
        d = dtype_of(a)
        if isinstance(a, TensorProxy):
            s = dtypes.to_strong(d)
            if strong is None:
                strong = s
            else:
                if _KIND_ORDER[s.kind] > _KIND_ORDER[strong.kind]:
                    strong = s
                elif _KIND_ORDER[s.kind] == _KIND_ORDER[strong.kind]:
                    strong = _wider(strong, s)
        else:
            s = dtypes.to_strong(d)
            if weak is None or _KIND_ORDER[s.kind] > _KIND_ORDER[weak.kind]:
                weak = s

    if strong is not None:
        if weak is not None and _KIND_ORDER[weak.kind] > _KIND_ORDER[strong.kind]:
            result = _default_for_kind[weak.kind]
        else:
            result = strong
    else:
        result = _default_for_kind[weak.kind]

    k = type_promotion_kind
    K = ELEMENTWISE_TYPE_PROMOTION_KIND
    if k is K.ALWAYS_BOOL:
        return result, dtypes.bool8
    if k is K.INT_TO_FLOAT and dtypes.is_exact_dtype(result):
        return dtypes.float32, dtypes.float32
    if k is K.COMPLEX_TO_FLOAT and dtypes.is_complex_dtype(result):
        return result, dtypes.corresponding_real_dtype(result)
    if k is K.BOOL_TO_LONG and dtypes.is_boolean_dtype(result):
        return dtypes.int64, dtypes.int64
    # Low-precision floats compute in themselves: torch's bf16/f16 kernels
    # upcast internally and round once.
    return result, result


def get_numberlike_value(x: Any) -> Any:
    return pyval(x)


# -- shapes ------------------------------------------------------------------


def same_shape(a: Sequence[int], b: Sequence[int]) -> bool:
    return tuple(a) == tuple(b)


def check_same_shape(*args, op: str = "op") -> None:
    shapes = [tuple(a.shape) for a in args if isinstance(a, TensorProxy)]
    if shapes:
        first = shapes[0]
        check(all(s == first for s in shapes), lambda: f"{op}: mismatched shapes {shapes}")


def compute_broadcast_shape(*shapes: Optional[Sequence[int]]) -> tuple:
    """NumPy/torch broadcast rule over any number of shapes."""
    real = [tuple(s) for s in shapes if s is not None]
    if not real:
        return ()
    ndim = max(len(s) for s in real)
    out = []
    for i in range(ndim):
        dim = 1
        for s in real:
            idx = len(s) - ndim + i
            if idx < 0:
                continue
            d = s[idx]
            if d == 1:
                continue
            check(dim == 1 or dim == d, lambda: f"Cannot broadcast shapes {real}")
            dim = d
        out.append(dim)
    return tuple(out)


def canonicalize_dim(ndim: int, dim: int, wrap_scalar: bool = True) -> int:
    rng = ndim if ndim > 0 else (1 if wrap_scalar else 0)
    check(-rng <= dim < rng, lambda: f"Dimension {dim} out of range for rank {ndim}")
    return dim if dim >= 0 else dim + rng


def canonicalize_dims(ndim: int, dims: Sequence[int] | int) -> tuple:
    if isinstance(dims, int):
        return (canonicalize_dim(ndim, dims),)
    return tuple(canonicalize_dim(ndim, d) for d in dims)


def check_valid_permutation(ndim: int, perm: Sequence[int]) -> None:
    check(sorted(perm) == list(range(ndim)), lambda: f"Invalid permutation {perm} for rank {ndim}")


def check_no_duplicates(dims: Sequence[int]) -> None:
    check(len(set(dims)) == len(dims), lambda: f"Duplicate dims in {dims}")


# -- devices -----------------------------------------------------------------


def check_same_device(*args, op: str = "op") -> None:
    devs = [a.device for a in args if isinstance(a, TensorProxy)]
    if devs:
        first = devs[0]
        check(
            all(d == first for d in devs),
            lambda: f"{op}: tensors on different devices {devs}",
        )


def common_device(*args) -> devices.Device:
    for a in args:
        if isinstance(a, TensorProxy):
            return a.device
    return devices.cpu


# -- misc --------------------------------------------------------------------


class OrderedSet:
    """Insertion-ordered set (dict-backed)."""

    def __init__(self, items=()):
        self._d = dict.fromkeys(items)

    def add(self, x):
        self._d[x] = None

    def update(self, items):
        for x in items:
            self.add(x)

    def discard(self, x):
        self._d.pop(x, None)

    def remove(self, x):
        del self._d[x]

    def __contains__(self, x):
        return x in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __bool__(self):
        return bool(self._d)


class ProxyDict:
    """Dict keyed by proxy name (reference: thunder/core/utils.py ProxyDict)."""

    def __init__(self):
        self._d: dict[str, Any] = {}

    def __setitem__(self, p, v):
        self._d[p.name] = v

    def __getitem__(self, p):
        return self._d[p.name]

    def __contains__(self, p):
        return p.name in self._d

    def get(self, p, default=None):
        return self._d.get(p.name, default)

    def setdefault(self, p, default):
        return self._d.setdefault(p.name, default)


def producers(bsyms) -> dict:
    """Variable → producing BoundSymbol."""
    from thunder_tpu_torch.core.proxies import variableify

    out = {}
    for bsym in bsyms:
        for o in bsym.flat_proxy_outs:
            out.setdefault(variableify(o), bsym)
    return out


def consumers(bsyms) -> dict:
    """Variable → list of consuming BoundSymbols."""
    from thunder_tpu_torch.core.proxies import variableify

    out = {}
    for bsym in bsyms:
        for a in bsym.flat_proxy_args:
            out.setdefault(variableify(a), []).append(bsym)
    return out
