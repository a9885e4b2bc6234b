"""Shared low-level utilities (reference parity: thunder/core/baseutils.py).

Holds the check helpers used by meta functions, the interface tags used by
codegen, and ``compile_and_exec`` used to turn generated Python source into a
callable.
"""

from __future__ import annotations

import linecache
from numbers import Number
from typing import Any, Callable, Hashable, Sequence, Type


class BoundSymbolInterface:
    pass


class ProxyInterface:
    pass


class SymbolInterface:
    pass


class TraceInterface:
    pass


class TagBase:
    pass


class GuardFailure(AssertionError):
    """Raised by prologue CHECK_* prims when a cached entry's guards do not
    match the current inputs. The cache probe loop catches exactly this type
    (reference parity: thunder/__init__.py:409-447 treats guard failure as the
    controlled cache-miss signal); any other exception from a prologue is a
    genuine bug and propagates."""


def check(pred: bool, msg: Callable[[], str] | str, exception_type: Type[Exception] = RuntimeError) -> None:
    """Raise ``exception_type`` with ``msg`` if ``pred`` is falsy. ``msg`` may
    be a thunk so message construction is free on the happy path."""
    if not pred:
        raise exception_type(msg() if callable(msg) else msg)


def check_type(x: Any, types: type | tuple[type, ...], name: str = "value") -> None:
    check(
        isinstance(x, types),
        lambda: f"Expected {name} to be of type {types}, got {type(x)}",
        ValueError,
    )


def check_types(xs: Sequence[Any], types: type | tuple[type, ...]) -> None:
    for x in xs:
        check_type(x, types)


def is_base_printable(x: Any) -> bool:
    from thunder_tpu_torch.core import dtypes, devices

    if isinstance(x, (str, type(None), Number, slice, type(Ellipsis), dtypes.dtype, devices.Device)):
        return True
    if isinstance(x, (tuple, list)):
        return all(is_base_printable(v) for v in x)
    if isinstance(x, dict):
        return all(isinstance(k, (str, int)) and is_base_printable(v) for k, v in x.items())
    return False


def is_collection(x: Any) -> bool:
    return isinstance(x, (tuple, list, dict, set))


def sequencify(x: Any) -> Sequence:
    if x is None:
        return ()
    if isinstance(x, (tuple, list)):
        return x
    return (x,)


_exec_counter = 0


def compile_and_exec(name: str, source: str, ctx: dict[str, Any]) -> Callable:
    """Compile generated Python source and return the named function.

    Reference parity: thunder/core/baseutils.py's build-and-exec used by
    TraceCtx.python_callable (thunder/core/trace.py:400). The source is
    registered with ``linecache`` so tracebacks and ``inspect.getsource``
    resolve into the generated program — the generated trace being readable
    and debuggable is a core product feature.
    """
    global _exec_counter
    _exec_counter += 1
    filename = f"<thunder_tpu_torch.gen {name}_{_exec_counter}>"
    lines = source.splitlines(keepends=True)
    linecache.cache[filename] = (len(source), None, lines, filename)
    code = compile(source, filename, "exec")
    namespace = dict(ctx)
    exec(code, namespace)
    fn = namespace[name]
    fn.__thunder_source__ = source
    return fn


def indent(level: int) -> str:
    return "  " * level


class NamedCounter:
    """Monotonic counters keyed by prefix, for name generation."""

    def __init__(self):
        self._counts: dict[str, int] = {}

    def next(self, prefix: str) -> int:
        n = self._counts.get(prefix, 0)
        self._counts[prefix] = n + 1
        return n


def make_hashable(x: Any) -> Hashable:
    if isinstance(x, (tuple, list)):
        return tuple(make_hashable(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, make_hashable(v)) for k, v in x.items()))
    if isinstance(x, set):
        return frozenset(make_hashable(v) for v in x)
    return x
