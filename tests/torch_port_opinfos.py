"""The OpInfo matrix of ``tests/opinfos.py`` rebound to the port.

Each OpInfo's op is a ``thunder_tpu.torch`` symbol or a function over the
``ltorch``/``clang`` globals of the JAX package. The port's ``torch`` and
``clang`` modules define the same names, so an op is rebound by name: a
symbol to the port's symbol of that name, a function to a copy whose globals
(and closure cells) name the port's modules and symbols instead. The JAX
executor lists of ``tests/framework.py`` map to the port's: ``jax`` (the
operator executor alone) to ``torch``, ``kernels`` to the default stack,
``quant`` (the int8 linear) to ``quant`` then ``torch``.
"""

from __future__ import annotations

import functools
import types

import thunder_tpu.clang as jclang
import thunder_tpu.torch as jtorch
from thunder_tpu.core.symbol import Symbol as JSymbol

import thunder_tpu_torch as tt
import thunder_tpu_torch.clang as tclang
import thunder_tpu_torch.torch as ttorch

_MODULES = {id(jtorch): ttorch, id(jclang): tclang}
_NAMES = {}
for _mod, _port in ((jclang, tclang), (jtorch, ttorch)):
    for _name, _val in vars(_mod).items():
        if isinstance(_val, JSymbol) or callable(_val):
            _NAMES[id(_val)] = (_port, _name)

PORT_EXECUTORS = {"jax": ["torch"], "kernels": None, "quant": ["quant", "torch"]}


def _rebind_value(v):
    if isinstance(v, types.ModuleType):
        return _MODULES.get(id(v), v)
    hit = _NAMES.get(id(v))
    if hit is not None:
        port, name = hit
        return getattr(port, name)
    if isinstance(v, functools.partial):
        return functools.partial(_rebind_value(v.func), *map(_rebind_value, v.args),
                                 **{k: _rebind_value(x) for k, x in v.keywords.items()})
    if isinstance(v, types.FunctionType) and v.__module__ in ("opinfos", "tests.opinfos"):
        return port_op(v)
    return v


def port_op(op):
    """``op`` with every JAX-package module or symbol it names replaced by
    the port's of the same name."""
    if not isinstance(op, types.FunctionType) or id(op) in _NAMES:
        return _rebind_value(op)
    glb = dict(op.__globals__)
    for name in op.__code__.co_names:
        if name in glb:
            glb[name] = _rebind_value(glb[name])
    closure = None
    if op.__closure__:
        closure = tuple(types.CellType(_rebind_value(c.cell_contents)) for c in op.__closure__)
    fn = types.FunctionType(op.__code__, glb, op.__name__, op.__defaults__, closure)
    fn.__kwdefaults__ = op.__kwdefaults__
    return fn


def port_jit(op, executor, **kwargs):
    return tt.jit(port_op(op), executors=PORT_EXECUTORS[executor.name], device="cpu", **kwargs)


def port_grad(fn, executor):
    return tt.grad(fn, executors=PORT_EXECUTORS[executor.name], device="cpu")
