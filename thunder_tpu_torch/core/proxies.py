"""Proxies: the abstract values that flow through traces.

Reference parity: thunder/core/proxies.py (`Proxy:91`, `NumberProxy:567`,
`TensorProxy:1147`, `FutureTensorProxy:1064`, `Variable`, `variableify:47`,
`DistParallelType` a.k.a. `DDPType:995`).

Differences from the reference:
- ``TensorProxy`` carries an optional ``sharding`` — a named-axis partition
  spec (tuple of mesh-axis names or None per dim) — kept for the layout of
  the IR; no pass of this package reads it yet.
- Devices are CPU/CUDA.
"""

from __future__ import annotations

from numbers import Number
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.core import baseutils, devices, dtypes
from thunder_tpu_torch.core.baseutils import ProxyInterface, check
from thunder_tpu_torch.core.langctxs import resolve_method


import enum


class DistParallelType(enum.Enum):
    """How a parameter is laid out across the data-parallel mesh axis.

    Reference parity: thunder/core/proxies.py `DDPType:995` (NONE / REPLICATED
    / FULLY_SHARDED), extended with COLUMN_WISE/ROW_WISE used by tensor
    parallelism (absent from the reference; first-class here).
    """

    NONE = enum.auto()
    REPLICATED = enum.auto()
    FULLY_SHARDED = enum.auto()
    COLUMN_WISE = enum.auto()
    ROW_WISE = enum.auto()


def _get_tracectx():
    from thunder_tpu_torch.core.trace import get_tracectx

    return get_tracectx()


class Proxy(ProxyInterface):
    """Base class for all abstract trace values."""

    _counter_prefix = "p"

    def __init__(self, name: Optional[str] = None, *, prefix: Optional[str] = None):
        trace = _get_tracectx()
        if name is None:
            prefix = prefix if prefix is not None else self._counter_prefix
            if trace is not None:
                name = trace.make_name(prefix=prefix)
            else:
                name = f"{prefix}?"
        else:
            if trace is not None:
                trace.add_name(name)
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def replace_name(self, name: str) -> "Proxy":
        """Return a copy of this proxy with a different name."""
        return self.__class__(name=name)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self._name}>"

    def type_string(self) -> str:
        return "Any"

    # Proxies are hashable by identity; Variable wraps them for by-name keys.
    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other: Any) -> Any:
        return self is other


class Variable:
    """Hashable by-name wrapper over a proxy (reference: proxies.py:27)."""

    __slots__ = ("proxy",)

    def __init__(self, proxy: Proxy):
        self.proxy = proxy

    def __hash__(self) -> int:
        return hash(self.proxy._name)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Variable) and self.proxy._name == other.proxy._name

    def __repr__(self) -> str:
        return f"Variable({self.proxy._name})"


def variableify(x: Any) -> Any:
    return Variable(x) if isinstance(x, Proxy) else x


def unvariableify(x: Any) -> Any:
    return x.proxy if isinstance(x, Variable) else x


class AnyProxy(Proxy):
    """Wraps an opaque Python value observed during tracing."""

    _counter_prefix = "any"

    def __init__(self, value: Any = None, name: Optional[str] = None, prefix: Optional[str] = None):
        super().__init__(name, prefix=prefix)
        self.value = value

    def replace_name(self, name: str) -> "AnyProxy":
        return AnyProxy(self.value, name=name)


class StringProxy(Proxy):
    """A string input observed during tracing. Behaves like its value for
    comparison/containment so mode/reduction flags (``reduction == "mean"``,
    ``"->" in equation``) take the right branch instead of silently failing
    an identity comparison."""

    _counter_prefix = "s"

    def __init__(self, value: str, name: Optional[str] = None):
        super().__init__(name)
        self.value = value

    def replace_name(self, name: str) -> "StringProxy":
        return StringProxy(self.value, name=name)

    def __eq__(self, other) -> bool:
        return self.value == (other.value if isinstance(other, StringProxy) else other)

    def __hash__(self) -> int:
        return hash(self.value)

    def __str__(self) -> str:
        return self.value

    def __contains__(self, item) -> bool:
        return item in self.value

    def __iter__(self):
        return iter(self.value)

    def __len__(self) -> int:
        return len(self.value)


class CollectionProxy(Proxy):
    _counter_prefix = "C"

    def __init__(self, coll: Any, name: Optional[str] = None):
        super().__init__(name)
        self.coll = coll

    def replace_name(self, name: str) -> "CollectionProxy":
        return CollectionProxy(self.coll, name=name)


class NumberProxy(Proxy):
    """A Python number flowing through the trace.

    ``value`` is the concrete value observed while tracing (used for constant
    folding and CONSTANT_VALUES caching); ``python_type`` is bool/int/float/
    complex. Static by default — the cache guards on the value — matching the
    reference's default CONSTANT_VALUES cache mode.
    """

    _counter_prefix = "n"

    def __init__(
        self,
        value: Optional[Number] = None,
        name: Optional[str] = None,
        python_type: Optional[type] = None,
        prefix: Optional[str] = None,
    ):
        super().__init__(name, prefix=prefix or self._prefix_for(python_type))
        self.value = value
        self.python_type = python_type if python_type is not None else type(value)

    @staticmethod
    def _prefix_for(python_type: Optional[type]) -> str:
        return {bool: "b", int: "i", float: "f", complex: "c"}.get(python_type, "n")

    def replace_name(self, name: str) -> "NumberProxy":
        return NumberProxy(self.value, name=name, python_type=self.python_type)

    def type_string(self) -> str:
        return self.python_type.__name__

    @property
    def dtype(self) -> dtypes.dtype:
        return dtypes.numbertype_to_dtype(self.python_type)

    def known_value(self) -> bool:
        return self.value is not None

    def __index__(self) -> int:
        check(self.value is not None, "Cannot use an unknown NumberProxy as an index")
        return int(self.value)

    def __bool__(self) -> bool:
        check(
            self.value is not None,
            "Cannot branch on an unknown NumberProxy (data-dependent control flow)",
        )
        return bool(self.value)

    def __int__(self) -> int:
        check(self.value is not None, "Cannot concretize an unknown NumberProxy")
        return int(self.value)

    def __float__(self) -> float:
        check(self.value is not None, "Cannot concretize an unknown NumberProxy")
        return float(self.value)

    # Arithmetic dunders route through the active language so the ops are
    # recorded when symbolic-values mode arrives; with known values they
    # constant-fold at trace time.
    def _number_binop(self, other, op: Callable, name: str, *, reflected: bool = False):
        ovalue = other.value if isinstance(other, NumberProxy) else other
        if self.value is not None and ovalue is not None:
            return op(self.value, ovalue)
        method = resolve_method(name, self, other)
        if method is not None:
            # Reflected dunders (__radd__ etc.) mean `other OP self` — the
            # recorded op's operand order must match.
            return method(other, self) if reflected else method(self, other)
        raise RuntimeError(f"Cannot compute {name} on unknown numbers without a language method")

    def __add__(self, other):
        return self._number_binop(other, lambda a, b: a + b, "add")

    def __radd__(self, other):
        return self._number_binop(other, lambda a, b: b + a, "add", reflected=True)

    def __sub__(self, other):
        return self._number_binop(other, lambda a, b: a - b, "sub")

    def __rsub__(self, other):
        return self._number_binop(other, lambda a, b: b - a, "sub", reflected=True)

    def __mul__(self, other):
        return self._number_binop(other, lambda a, b: a * b, "mul")

    def __rmul__(self, other):
        return self._number_binop(other, lambda a, b: b * a, "mul", reflected=True)

    def __truediv__(self, other):
        return self._number_binop(other, lambda a, b: a / b, "true_divide")

    def __rtruediv__(self, other):
        return self._number_binop(other, lambda a, b: b / a, "true_divide", reflected=True)

    def __floordiv__(self, other):
        return self._number_binop(other, lambda a, b: a // b, "floor_divide")

    def __rfloordiv__(self, other):
        return self._number_binop(other, lambda a, b: b // a, "floor_divide", reflected=True)

    def __mod__(self, other):
        return self._number_binop(other, lambda a, b: a % b, "remainder")

    def __rmod__(self, other):
        return self._number_binop(other, lambda a, b: b % a, "remainder", reflected=True)

    def __pow__(self, other):
        return self._number_binop(other, lambda a, b: a**b, "pow")

    def __rpow__(self, other):
        return self._number_binop(other, lambda a, b: b**a, "pow", reflected=True)

    def __neg__(self):
        if self.value is not None:
            return -self.value
        return resolve_method("neg", self)(self)

    def __eq__(self, other):
        ovalue = other.value if isinstance(other, NumberProxy) else other
        if self.value is not None and (not isinstance(other, Proxy) or ovalue is not None):
            return self.value == ovalue
        return NotImplemented

    def __hash__(self) -> int:
        return id(self)

    def __lt__(self, other):
        return self._number_binop(other, lambda a, b: a < b, "lt")

    def __le__(self, other):
        return self._number_binop(other, lambda a, b: a <= b, "le")

    def __gt__(self, other):
        return self._number_binop(other, lambda a, b: a > b, "gt")

    def __ge__(self, other):
        return self._number_binop(other, lambda a, b: a >= b, "ge")


class IntegerProxy(NumberProxy):
    def __init__(self, value=None, name=None):
        super().__init__(value, name=name, python_type=int)


class FloatProxy(NumberProxy):
    def __init__(self, value=None, name=None):
        super().__init__(value, name=name, python_type=float)


class ComplexProxy(NumberProxy):
    def __init__(self, value=None, name=None):
        super().__init__(value, name=name, python_type=complex)


def pyval(x: Any) -> Any:
    """Concrete Python value of a (number/string) proxy or passthrough."""
    if isinstance(x, (NumberProxy, StringProxy, AnyProxy)):
        return x.value
    return x


def pytype(x: Any) -> type:
    if isinstance(x, NumberProxy):
        return x.python_type
    return type(x)


ShapeLike = Sequence[int]


def _lift_operand(x):
    """Concrete array operand of a proxy op -> baked tensor constant (only
    meaningful inside a trace; passthrough otherwise).

    NOT redundant with Symbol.__call__'s lifting: clang language methods are
    plain wrapper FUNCTIONS that run dtype promotion/broadcast logic before
    any Symbol is called (clang/__init__._elementwise_binary_wrapper), so a
    raw array must be lifted before dispatch reaches them; the torch
    language's methods are Symbols and simply see an already-lifted proxy.
    Both layers memoize through prims.tensor_constant's per-trace memo."""
    from thunder_tpu_torch.executors import bridge

    if bridge.is_concrete_tensor(x):
        from thunder_tpu_torch.core.trace import get_tracectx

        if get_tracectx() is not None:
            from thunder_tpu_torch.core import prims

            return prims.tensor_constant(x)
    return x


class TensorProxy(Proxy):
    """The abstract tensor: shape, dtype, device, requires_grad, distributed
    layout, and an optional named-axis sharding spec.

    Reference parity: thunder/core/proxies.py `TensorProxy:1147`.
    """

    _counter_prefix = "t"

    def __init__(
        self,
        name: Optional[str] = None,
        *,
        shape: Optional[ShapeLike] = None,
        device: Optional[devices.Device] = None,
        dtype: Optional[dtypes.dtype] = None,
        requires_grad: bool = False,
        dist_parallel_type: DistParallelType = DistParallelType.NONE,
        sharding: Optional[tuple] = None,
        like: Optional["TensorProxy"] = None,
        prefix: Optional[str] = None,
    ):
        super().__init__(name, prefix=prefix)
        if like is not None:
            shape = shape if shape is not None else like.shape
            device = device if device is not None else like.device
            dtype = dtype if dtype is not None else like.dtype
            requires_grad = like.requires_grad if requires_grad is False else requires_grad
            if sharding is None:
                sharding = like.sharding
        check(shape is not None, "TensorProxy requires a shape")
        self._shape = tuple(int(s) if isinstance(s, Number) else s for s in shape)
        self._device = devices.to_device(device) if device is not None else devices.cpu
        self._dtype = dtypes.to_dtype(dtype, true_dtype=True) if dtype is not None else dtypes.float32
        self._requires_grad = requires_grad and dtypes.is_inexact_dtype(self._dtype)
        self.dist_parallel_type = dist_parallel_type
        self.sharding = tuple(sharding) if sharding is not None else None
        # The unsharded ("logical") shape when this proxy is a dim-0 shard of
        # a distributed parameter (reference: proxies.py thunder_fsdp_padding_size etc.)
        self.unsharded_shape: Optional[tuple] = None
        # Symbolic-values caching: {dim: (lo, hi, class_id)} for input dims
        # lifted to bucket guards — the extents in _shape are the bucket's
        # padded extents, and the prologue guards membership, not equality
        # (core/bucketing.py; set during acquisition by trace_program).
        self._symbolic_dims: Optional[dict] = None

    # -- metadata ------------------------------------------------------------

    @property
    def shape(self) -> tuple:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def device(self) -> devices.Device:
        return self._device

    @property
    def dtype(self) -> dtypes.dtype:
        return dtypes.to_strong(self._dtype)

    @property
    def true_dtype(self) -> dtypes.dtype:
        return self._dtype

    @property
    def requires_grad(self) -> bool:
        return self._requires_grad

    @property
    def numel(self) -> int:
        n = 1
        for s in self._shape:
            n *= int(s)
        return n

    @property
    def size_bytes(self) -> int:
        return self.numel * self.dtype.bytes

    def replace_name(self, name: str) -> "TensorProxy":
        return self.replace(name=name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """torch-dispatch hook: makes torch's C++ argument parsers accept
        proxies in Tensor positions and routes the call to the ltorch mirror
        (the frontend seat of the reference's interpreter lookasides,
        thunder/core/jit_ext.py `general_jit_lookaside:871`)."""
        from thunder_tpu_torch.frontend.dispatch import torch_dispatch

        return torch_dispatch(func, types, args, kwargs)

    def replace(self, name: Optional[str] = None, **changes) -> "TensorProxy":
        p = TensorProxy(
            name=name,
            shape=changes.get("shape", self._shape),
            device=changes.get("device", self._device),
            dtype=changes.get("dtype", self._dtype),
            requires_grad=changes.get("requires_grad", self._requires_grad),
            dist_parallel_type=changes.get("dist_parallel_type", self.dist_parallel_type),
            sharding=changes.get("sharding", self.sharding),
        )
        p.unsharded_shape = changes.get("unsharded_shape", self.unsharded_shape)
        p._symbolic_dims = changes.get("_symbolic_dims", self._symbolic_dims)
        return p

    def type_string(self) -> str:
        shard = "" if self.sharding is None else f" @{self.sharding}"
        return f'"{self.device}" {self.dtype.shortname}{list(self.shape)}{shard}'

    def __repr__(self) -> str:
        return f"<TensorProxy {self._name}: {self.type_string()}>"

    # -- python object protocol ---------------------------------------------

    def __len__(self) -> int:
        check(self.ndim > 0, "len() of a 0-d tensor")
        return int(self._shape[0])

    def size(self, dim: Optional[int] = None):
        if dim is None:
            return self.shape
        return self.shape[dim]

    def dim(self) -> int:
        return self.ndim

    def numel_(self) -> int:
        return self.numel

    def is_floating_point(self) -> bool:
        # torch.Tensor API used by HF's ModuleUtilsMixin.dtype (iterates
        # parameters — TensorProxies while swapped in during tracing).
        return dtypes.is_inexact_dtype(dtypes.to_dtype(self.dtype)) and not dtypes.is_complex_dtype(
            dtypes.to_dtype(self.dtype)
        )

    def is_complex(self) -> bool:
        return dtypes.is_complex_dtype(dtypes.to_dtype(self.dtype))

    def __bool__(self):
        return self._concretize("bool")

    def __int__(self):
        return self._concretize("int")

    def __float__(self):
        return self._concretize("float")

    def __index__(self):
        return self._concretize("int")

    def _concretize(self, kind: str):
        """Python-scalar coercion of a traced tensor: evaluated eagerly on
        the trace's concrete example inputs and protected by a cache value
        guard (core/concrete.py). Reference parity: the interpreter frontend
        runs such branches on real tensors (jit_ext.py) and constrains the
        cache via prologue guards."""
        from thunder_tpu_torch.core.concrete import concretize_scalar

        val = concretize_scalar(self, kind)
        if val is not None:
            return val
        raise RuntimeError(
            f"Cannot {kind}() a traced tensor with no concrete value (data-dependent "
            "control flow in a detached trace); use lax-style control flow or mark "
            "the value static"
        )

    # -- method / operator dispatch via the active language ------------------

    def _dispatch(self, name: str, *args, **kwargs):
        # proxy <op> captured-concrete-array: lift the array to a baked
        # trace constant before language methods inspect dtypes (the
        # closure/global/default capture cases; prims.tensor_constant).
        args = tuple(_lift_operand(a) for a in args)
        method = resolve_method(name, self, *args, **kwargs)
        if method is None:
            raise AttributeError(f"No language method {name!r} for TensorProxy")
        return method(self, *args, **kwargs)

    def __getattr__(self, name: str):
        # Only called when normal lookup fails: resolve tensor methods
        # through the language context (reference: TensorProxy.__getattr__).
        if name.startswith("_"):
            raise AttributeError(name)
        method = resolve_method(name)
        if method is None:
            raise AttributeError(f"TensorProxy has no attribute or language method {name!r}")
        import functools

        return functools.partial(method, self)

    # arithmetic
    def __add__(self, other):
        return self._dispatch("add", other)

    def __radd__(self, other):
        other = _lift_operand(other)
        return resolve_method("add", other, self)(other, self)

    def __sub__(self, other):
        return self._dispatch("sub", other)

    def __rsub__(self, other):
        other = _lift_operand(other)
        return resolve_method("sub", other, self)(other, self)

    def __mul__(self, other):
        return self._dispatch("mul", other)

    def __rmul__(self, other):
        other = _lift_operand(other)
        return resolve_method("mul", other, self)(other, self)

    def __truediv__(self, other):
        return self._dispatch("true_divide", other)

    def __rtruediv__(self, other):
        other = _lift_operand(other)
        return resolve_method("true_divide", other, self)(other, self)

    def __floordiv__(self, other):
        return self._dispatch("floor_divide", other)

    def __mod__(self, other):
        return self._dispatch("remainder", other)

    def __pow__(self, other):
        return self._dispatch("pow", other)

    def __rpow__(self, other):
        other = _lift_operand(other)
        return resolve_method("pow", other, self)(other, self)

    def __matmul__(self, other):
        return self._dispatch("matmul", other)

    def __rmatmul__(self, other):
        other = _lift_operand(other)
        return resolve_method("matmul", other, self)(other, self)

    def __neg__(self):
        return self._dispatch("neg")

    def __abs__(self):
        return self._dispatch("abs")

    # comparisons
    def __eq__(self, other):
        return self._dispatch("eq", other)

    def __ne__(self, other):
        return self._dispatch("ne", other)

    def __lt__(self, other):
        return self._dispatch("lt", other)

    def __le__(self, other):
        return self._dispatch("le", other)

    def __gt__(self, other):
        return self._dispatch("gt", other)

    def __ge__(self, other):
        return self._dispatch("ge", other)

    def __hash__(self) -> int:
        return id(self)

    # logical
    def __and__(self, other):
        return self._dispatch("bitwise_and", other)

    def __or__(self, other):
        return self._dispatch("bitwise_or", other)

    def __xor__(self, other):
        return self._dispatch("bitwise_xor", other)

    def __invert__(self):
        return self._dispatch("bitwise_not")

    # indexing
    def __getitem__(self, key):
        return self._dispatch("getitem", key)

    def __setitem__(self, key, value):
        # In-place indexed write: functionalizes via the setitem_ language
        # method (out-of-place update + proxy forwarding).
        self._dispatch("setitem_", key, value)


class FutureTensorProxy(TensorProxy):
    """Result of an async collective; must be resolved by a ``wait`` prim.

    Reference parity: thunder/core/proxies.py `FutureTensorProxy:1064`. The
    IR keeps the future/wait structure of the distribution layer's async
    collectives (``distributed/prims.py``).
    """

    _counter_prefix = "fut"

    def replace_name(self, name: str) -> "FutureTensorProxy":
        p = FutureTensorProxy(
            name=name,
            shape=self._shape,
            device=self._device,
            dtype=self._dtype,
        )
        p.sharding = self.sharding
        return p


def is_proxy(x: Any) -> bool:
    return isinstance(x, Proxy)


def is_proxyable(x: Any) -> bool:
    return isinstance(x, Number) or _is_concrete_tensor(x)


def _is_concrete_tensor(x: Any) -> bool:
    import numpy as np
    import torch

    return isinstance(x, (np.ndarray, torch.Tensor))


def proxy(x: Any, *, name: Optional[str] = None) -> Any:
    """Wrap a concrete value in the appropriate proxy (reference: proxies.py `proxy`)."""
    if isinstance(x, Proxy):
        return x
    if isinstance(x, bool):
        return NumberProxy(x, name=name, python_type=bool)
    if isinstance(x, int):
        return IntegerProxy(x, name=name)
    if isinstance(x, float):
        return FloatProxy(x, name=name)
    if isinstance(x, complex):
        return ComplexProxy(x, name=name)
    if isinstance(x, str):
        return StringProxy(x, name=name)
    tp = tensorproxy_from_concrete(x, name=name)
    if tp is not None:
        return tp
    return AnyProxy(x, name=name)


def tensorproxy_from_concrete(x: Any, *, name: Optional[str] = None) -> Optional[TensorProxy]:
    """Build a TensorProxy describing a concrete numpy array or torch tensor
    (reference: proxies.py `tensorproxy:1496`)."""
    import numpy as np
    import torch

    if isinstance(x, np.ndarray):
        # Host data becomes a tensor on the trace's device at execution.
        return TensorProxy(name=name, shape=x.shape, device=devices.Device(), dtype=dtypes.from_numpy_dtype(x.dtype))
    if isinstance(x, torch.Tensor):
        return TensorProxy(
            name=name,
            shape=tuple(x.shape),
            device=devices.to_device(x.device),
            dtype=dtypes.from_torch_dtype(x.dtype),
            requires_grad=bool(x.requires_grad),
        )
    return None
