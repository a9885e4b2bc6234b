"""NumPy demo language layer.

The port's copy of ``thunder_tpu/numpy/__init__.py`` over its own
``core/langctxs.py``. Reference parity: thunder/numpy/__init__.py +
thunder/numpy/langctx.py —
deliberately small, existing to prove the language-context machinery is
actually multi-language: a function written against numpy-style signatures
(ufunc ``where=`` kwarg, ``axis=`` reductions) traces through the SAME prim
vocabulary and executor pipeline as the torch mirror, and numpy-style
methods resolve on TensorProxy while the numpy context is active.
"""

from __future__ import annotations

from typing import Callable, Optional

import thunder_tpu_torch.clang as clang
from thunder_tpu_torch.core.langctxs import (
    LanguageContext,
    Languages,
    langctx,
    register_langctx,
)
from thunder_tpu_torch.core.symbol import Symbol

_numpy_ctx = LanguageContext(Languages.NUMPY)
register_langctx(Languages.NUMPY, _numpy_ctx)


def npsymbol(*, method_name: Optional[str] = None):
    """Decorator mirroring the reference's ``npsymbol`` (thunder/numpy/
    __init__.py:22): the body runs under the numpy language context and the
    op becomes a trace Symbol; ``method_name`` also exposes it as a proxy
    method while the numpy context is active."""

    def deco(fn: Callable) -> Symbol:
        wrapped = langctx(Languages.NUMPY)(fn)
        sym = Symbol(name=fn.__name__, meta=wrapped)
        if method_name is not None:
            _numpy_ctx.register_method(method_name, wrapped)
        return sym

    return deco


def _masked(result, a, where):
    """numpy ufunc ``where=`` semantics: unselected lanes keep ``a``."""
    if where is None:
        return result
    return clang.where(where, result, a)


@npsymbol(method_name="add")
def add(a, b, *, where=None):
    return _masked(clang.add(a, b), a, where)


@npsymbol(method_name="subtract")
def subtract(a, b, *, where=None):
    return _masked(clang.sub(a, b), a, where)


@npsymbol(method_name="multiply")
def multiply(a, b, *, where=None):
    return _masked(clang.mul(a, b), a, where)


@npsymbol(method_name="divide")
def divide(a, b, *, where=None):
    return _masked(clang.true_divide(a, b), a, where)


@npsymbol(method_name="exp")
def exp(a, *, where=None):
    return _masked(clang.exp(a), a, where)


@npsymbol(method_name="sum")
def sum(a, axis=None, keepdims: bool = False):  # noqa: A001 — numpy surface
    dims = (axis,) if isinstance(axis, int) else axis
    return clang.sum(a, dims, keepdims)


@npsymbol(method_name="mean")
def mean(a, axis=None, keepdims: bool = False):
    dims = (axis,) if isinstance(axis, int) else axis
    return clang.mean(a, dims, keepdims)


@npsymbol(method_name="matmul")
def matmul(a, b):
    return clang.matmul(a, b)


@npsymbol(method_name="transpose")
def transpose(a, axes=None):
    perm = tuple(axes) if axes is not None else tuple(reversed(range(a.ndim)))
    return clang.permute(a, perm)


@npsymbol(method_name="reshape")
def reshape(a, newshape):
    return clang.reshape(a, tuple(newshape))


def compute_len(a) -> int:
    return int(a.shape[0])


_numpy_ctx.register_method("len", compute_len)


def size(a) -> int:
    return int(a.numel)


_numpy_ctx.register_method("size", size)
