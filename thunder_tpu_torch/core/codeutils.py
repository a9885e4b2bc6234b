"""Rendering trace values as Python source (reference: thunder/core/codeutils.py).

The product invariant inherited from the reference: every trace prints as
*valid, executable, readable Python*. These helpers render arguments —
proxies print as their names; dtypes/devices print as constructor calls that
resolve against the modules bound into the execution context.
"""

from __future__ import annotations

from numbers import Number
from typing import Any, Sequence

from thunder_tpu_torch.core import dtypes, devices
from thunder_tpu_torch.core.proxies import Proxy, NumberProxy, StringProxy, CollectionProxy, AnyProxy


class SigInfo:
    """Signature of a generated function: ordered parameter names plus
    optional varargs/varkwargs names."""

    def __init__(self, name: str, params: Sequence[str] = (), varargs: str | None = None, varkwargs: str | None = None):
        self.name = name
        self.params = list(params)
        self.varargs = varargs
        self.varkwargs = varkwargs

    def prettyprint(self) -> str:
        parts = list(self.params)
        if self.varargs:
            parts.append(f"*{self.varargs}")
        if self.varkwargs:
            parts.append(f"**{self.varkwargs}")
        return f"def {self.name}({', '.join(parts)}):"


def prettyprint(x: Any) -> str:
    """Render a trace value as a Python expression."""
    if isinstance(x, NumberProxy):
        # Static numbers print as literals; the prologue guards their values.
        return x.name
    if isinstance(x, (StringProxy, CollectionProxy, AnyProxy)):
        return x.name
    if isinstance(x, Proxy):
        return x.name
    if isinstance(x, str):
        return repr(x)
    if x is None or x is Ellipsis:
        return repr(x)
    if isinstance(x, float):
        # repr(float) round-trips (incl. inf/nan via float('...'))
        if x != x:
            return "float('nan')"
        if x == float("inf"):
            return "float('inf')"
        if x == float("-inf"):
            return "float('-inf')"
        return repr(x)
    if isinstance(x, (bool, int, complex)):
        return repr(x)
    if isinstance(x, Number):
        return repr(x)
    if isinstance(x, slice):
        return f"slice({prettyprint(x.start)}, {prettyprint(x.stop)}, {prettyprint(x.step)})"
    if isinstance(x, dtypes.dtype):
        return f"dtypes.{x.name}" + ("_" if x.weak else "")
    if isinstance(x, devices.Device):
        return f'devices.Device("{x}")'
    if isinstance(x, tuple):
        inner = ", ".join(prettyprint(v) for v in x)
        if len(x) == 1:
            inner += ","
        return f"({inner})"
    if isinstance(x, list):
        return f"[{', '.join(prettyprint(v) for v in x)}]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{prettyprint(k)}: {prettyprint(v)}" for k, v in x.items()) + "}"
    if isinstance(x, type):
        return x.__name__
    raise NotImplementedError(f"Cannot render {x!r} (type {type(x)}) as Python source")


def is_printable(x: Any) -> bool:
    try:
        prettyprint(x)
        return True
    except NotImplementedError:
        return False


def module_shortname(module_name: str) -> str:
    return module_name.rsplit(".", 1)[-1]


def to_printable_collection_str(out: Any) -> str:
    """Render a (possibly nested) output structure for a return statement."""
    return prettyprint(out)
