"""Dtype lattice for the trace IR.

Capability parity with the reference's dtype system (reference:
thunder/core/dtypes.py — `dtype:53`, `to_dtype:274`): a framework-owned set of
dtypes with weak/strong number variants used for Python-number type promotion,
plus mappings to/from ``torch.dtype`` (the execution substrate) and numpy
dtypes (host inputs). bfloat16 is a first-class compute dtype and the fp8
types (e4m3fn / e5m2) are included.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class dtype:
    """A framework dtype.

    ``weak`` marks dtypes arising from Python numbers; they lose to any
    strong (tensor) dtype of the same kind during promotion, mirroring
    torch's number-promotion semantics.
    """

    def __init__(self, name: str, *, kind: str, bytes: int, weak: bool = False):
        self._name = name
        self.kind = kind  # 'bool' | 'int' | 'uint' | 'float' | 'complex'
        self.bytes = bytes
        self.weak = weak

    @property
    def is_weak(self) -> bool:
        return self.weak

    @property
    def name(self) -> str:
        return self._name

    @property
    def shortname(self) -> str:
        return _SHORTNAMES.get(self._name, self._name)

    def __repr__(self) -> str:
        return f"dtypes.{self._name}" + ("_" if self.weak else "")

    def __str__(self) -> str:
        return self.__repr__()

    def __hash__(self) -> int:
        return hash((self._name, self.weak))

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, dtype):
            return NotImplemented
        return self._name == other._name and self.weak == other.weak


_SHORTNAMES = {
    "bool8": "b8",
    "uint8": "u8",
    "int8": "i8",
    "int16": "i16",
    "int32": "i32",
    "int64": "i64",
    "bfloat16": "bf16",
    "float16": "f16",
    "float32": "f32",
    "float64": "f64",
    "float8_e4m3": "f8_e4m3",
    "float8_e5m2": "f8_e5m2",
    "complex64": "c64",
    "complex128": "c128",
}

# Strong dtypes
bool8 = dtype("bool8", kind="bool", bytes=1)
uint8 = dtype("uint8", kind="uint", bytes=1)
uint16 = dtype("uint16", kind="uint", bytes=2)
uint32 = dtype("uint32", kind="uint", bytes=4)
uint64 = dtype("uint64", kind="uint", bytes=8)
int8 = dtype("int8", kind="int", bytes=1)
int16 = dtype("int16", kind="int", bytes=2)
int32 = dtype("int32", kind="int", bytes=4)
int64 = dtype("int64", kind="int", bytes=8)
float8_e4m3 = dtype("float8_e4m3", kind="float", bytes=1)
float8_e5m2 = dtype("float8_e5m2", kind="float", bytes=1)
bfloat16 = dtype("bfloat16", kind="float", bytes=2)
float16 = dtype("float16", kind="float", bytes=2)
float32 = dtype("float32", kind="float", bytes=4)
float64 = dtype("float64", kind="float", bytes=8)
complex64 = dtype("complex64", kind="complex", bytes=8)
complex128 = dtype("complex128", kind="complex", bytes=16)

# Weak variants (Python-number provenance)
bool8_ = dtype("bool8", kind="bool", bytes=1, weak=True)
int64_ = dtype("int64", kind="int", bytes=8, weak=True)
float32_ = dtype("float32", kind="float", bytes=4, weak=True)
float64_ = dtype("float64", kind="float", bytes=8, weak=True)
complex64_ = dtype("complex64", kind="complex", bytes=8, weak=True)

all_dtypes = (
    bool8,
    uint8,
    uint16,
    uint32,
    uint64,
    int8,
    int16,
    int32,
    int64,
    float8_e4m3,
    float8_e5m2,
    bfloat16,
    float16,
    float32,
    float64,
    complex64,
    complex128,
)

boolean_dtypes = (bool8, bool8_)
integer_dtypes = (uint8, int8, int16, int32, int64, bool8)
low_precision_dtypes = (bfloat16, float16, float8_e4m3, float8_e5m2)
float_dtypes = (float8_e4m3, float8_e5m2, bfloat16, float16, float32, float64)
complex_dtypes = (complex64, complex128)
inexact_dtypes = float_dtypes + complex_dtypes
exact_dtypes = (bool8, uint8, int8, int16, int32, int64)


def is_boolean_dtype(d: dtype) -> bool:
    return d.kind == "bool"


def is_integer_dtype(d: dtype) -> bool:
    return d.kind in ("int", "uint", "bool")


def is_nonboolean_integer_dtype(d: dtype) -> bool:
    return d.kind in ("int", "uint")


def is_float_dtype(d: dtype) -> bool:
    return d.kind == "float"


def is_complex_dtype(d: dtype) -> bool:
    return d.kind == "complex"


def is_inexact_dtype(d: dtype) -> bool:
    return d.kind in ("float", "complex")


def is_exact_dtype(d: dtype) -> bool:
    return d.kind in ("bool", "int", "uint")


def is_signed_integer_dtype(d: dtype) -> bool:
    return d.kind == "int"


def to_strong(d: dtype) -> dtype:
    if not d.weak:
        return d
    return _BY_NAME[d._name]


def weak_variant(d: dtype) -> dtype:
    return _WEAK_BY_NAME.get(d._name, d)


_BY_NAME = {d._name: d for d in all_dtypes}
_WEAK_BY_NAME = {d._name: d for d in (bool8_, int64_, float32_, float64_, complex64_)}


def corresponding_real_dtype(d: dtype) -> dtype:
    if d == complex64:
        return float32
    if d == complex128:
        return float64
    return d


def corresponding_complex_dtype(d: dtype) -> dtype:
    if d in (float64,):
        return complex128
    return complex64


# -- Python number types ------------------------------------------------------

_number_type_to_dtype = {
    bool: bool8_,
    int: int64_,
    float: float64_,
    complex: complex64_,
}

dtype_to_number_type = {
    "bool": bool,
    "int": int,
    "uint": int,
    "float": float,
    "complex": complex,
}


def numbertype_to_dtype(typ: type) -> dtype:
    return _number_type_to_dtype[typ]


def dtype_to_numbertype(d: dtype) -> type:
    return dtype_to_number_type[d.kind]


# -- torch mapping ------------------------------------------------------------

_TORCH_NAMES = {
    "bool8": "bool",
    "float8_e4m3": "float8_e4m3fn",
    "float8_e5m2": "float8_e5m2",
}


def to_torch_dtype(d: dtype) -> Any:
    """The ``torch.dtype`` of a framework dtype (weak dtypes map to their
    strong variant)."""
    import torch

    d = to_strong(d)
    return getattr(torch, _TORCH_NAMES.get(d._name, d._name))


def finfo_max(d: dtype) -> float:
    """Largest finite value of a float dtype (torch.finfo(d).max parity)."""
    import torch

    return float(torch.finfo(to_torch_dtype(d)).max)


def from_torch_dtype(td: Any) -> dtype:
    name = str(td).removeprefix("torch.")
    rev = {"bool": "bool8", "float8_e4m3fn": "float8_e4m3"}
    name = rev.get(name, name)
    d = _BY_NAME.get(name)
    if d is None:
        raise ValueError(f"Unsupported torch dtype {td}")
    return d


def from_numpy_dtype(nd: Any) -> dtype:
    name = np.dtype(nd).name
    d = _BY_NAME.get({"bool": "bool8"}.get(name, name))
    if d is None:
        raise ValueError(f"Unsupported numpy dtype {nd}")
    return d


def to_dtype(x: Any, *, true_dtype: bool = False) -> dtype:
    """Canonicalize any dtype-like (framework dtype, torch or numpy dtype,
    Python number type, or a value) to a framework dtype.

    Reference parity: thunder/core/dtypes.py `to_dtype:274`.
    """
    if x is None:
        return None
    if isinstance(x, dtype):
        return x if true_dtype else to_strong(x)
    if isinstance(x, type) and issubclass(x, (bool, int, float, complex)):
        d = _number_type_to_dtype[x]
        return d if true_dtype else to_strong(d)
    if isinstance(x, (bool, int, float, complex)):
        d = _number_type_to_dtype[type(x)]
        return d if true_dtype else to_strong(d)
    if type(x).__module__.startswith("torch"):
        return from_torch_dtype(x)
    try:
        return from_numpy_dtype(x)
    except (TypeError, ValueError):
        pass
    raise ValueError(f"Cannot convert {x!r} (type {type(x)}) to a dtype")
