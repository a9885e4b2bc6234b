"""The executor framework: pluggable backends claiming trace symbols.

Reference parity: thunder/extend/__init__.py (`Executor:47`,
`OperatorExecutor:190`, `FusionExecutor:132`, `ImplInfo:32`,
`register_executor:275`, the default and always registries `:268-388`,
optimization fuel `:136-155`); the port's copy of
``thunder_tpu/extend/__init__.py:37-235``.

Executors are priority-ordered: the claiming pass
(thunder_tpu_torch/executors/passes.py) hands each bound symbol to the first
executor whose checker accepts it, descending into subsymbols when no
executor claims a composite op, then lets each fusion executor rewrite the
claimed trace. The terminal executor is the torch operator executor
(executors/torchex.py); the kernel executors (executors/flashex.py,
executors/fusedex.py) come before it and claim composite ops whole. The
defaults are ``[flash, fused, torch]`` (``get_default_executors``); the
``norm`` and ``quant`` executors are registered but opt-in, by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol


@dataclass
class ImplInfo:
    """Reference parity: thunder/extend/__init__.py `ImplInfo:32`."""

    symbol: Optional[Symbol] = None  # executor-specific op symbol, if any
    fn: Optional[Callable] = None  # concrete implementation
    checker: Optional[Callable] = None  # (*args, **kwargs) -> bool
    execution_transform: Optional[Callable] = None  # (*args, **kwargs) -> result, records ops
    grad_transform: Optional[Callable] = None  # custom VJP rule
    # (*args, **kwargs) -> bool: the implementation reads a device value on
    # the host when it runs, which a CUDA graph cannot hold
    # (executors/staging.py leaves such a program unstaged).
    reads_host: Optional[Callable] = None


class Executor:
    def __init__(self, name: str, *, version: str = "0.1"):
        self.name = name
        self.version = version
        self.implmap: dict[Any, ImplInfo] = {}
        # Optimization fuel for bisecting claiming and fusion bugs
        # (reference: extend/__init__.py:136-155): None is unlimited.
        self._fuel: Optional[int] = None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"

    # -- fuel ----------------------------------------------------------------

    def set_fuel(self, n: Optional[int]) -> None:
        self._fuel = n

    def get_fuel(self, amount: int = 1) -> bool:
        if self._fuel is None:
            return True
        if self._fuel >= amount:
            self._fuel -= amount
            return True
        return False

    # -- claiming ------------------------------------------------------------

    def can_execute(self, bsym: BoundSymbol) -> bool:
        info = self.implmap.get(bsym.sym.id)
        if info is None:
            return False
        if info.checker is not None:
            try:
                if not info.checker(*bsym.args, **bsym.kwargs):
                    return False
            except Exception:
                return False
        # With fuel set, each claim spends one unit; an executor out of fuel
        # stops claiming.
        return self.get_fuel(1)

    def get_impl(self, sym_id: Any) -> Optional[Callable]:
        info = self.implmap.get(sym_id)
        if info is None:
            return None
        if info.fn is not None:
            return info.fn
        if info.symbol is not None and info.symbol.python_impl is not None:
            return info.symbol.python_impl
        return None

    def get_execution_transform(self, sym_id: Any) -> Optional[Callable]:
        info = self.implmap.get(sym_id)
        return info.execution_transform if info is not None else None

    def get_grad_transform(self, sym_id: Any) -> Optional[Callable]:
        info = self.implmap.get(sym_id)
        return info.grad_transform if info is not None else None

    def reads_host(self, bsym: BoundSymbol) -> bool:
        """Whether this executor's implementation of ``bsym`` reads the host."""
        info = self.implmap.get(bsym.sym.id)
        return info is not None and info.reads_host is not None and bool(info.reads_host(*bsym.args, **bsym.kwargs))


class OperatorExecutor(Executor):
    """Reference parity: thunder/extend/__init__.py `OperatorExecutor:190`."""

    def register_operator(self, name: str, *, meta: Callable, fn: Callable, tags: Sequence[Any] = (),
                          replaces: Optional[Any] = None) -> Symbol:
        """An executor-owned symbol with a concrete implementation
        (reference: `register_operator:203`); with ``replaces``, it also
        claims that symbol id."""
        sym = Symbol(name, meta, id=f"{self.name}.{name}", is_prim=True, tags=tags, executor=self,
                     python_impl=fn, module=self.name)
        self.implmap[sym.id] = ImplInfo(symbol=sym, fn=fn)
        if replaces is not None:
            self.implmap[replaces] = ImplInfo(symbol=sym, fn=fn)
        return sym

    def register_implementation(
        self, sym_or_id: Symbol | Any, *, op: Optional[Symbol] = None, fn: Optional[Callable] = None,
        checker: Optional[Callable] = None, execution_transform: Optional[Callable] = None,
        grad_transform: Optional[Callable] = None, reads_host: Optional[Callable] = None,
    ) -> None:
        """Map an IR symbol to this executor (reference: `register_implementation:247`)."""
        sym_id = sym_or_id.id if isinstance(sym_or_id, Symbol) else sym_or_id
        impl_fn = fn if fn is not None else (op.python_impl if op is not None else None)
        self.implmap[sym_id] = ImplInfo(symbol=op, fn=impl_fn, checker=checker,
                                        execution_transform=execution_transform, grad_transform=grad_transform,
                                        reads_host=reads_host)


class FusionExecutor(Executor):
    """An executor that rewrites whole regions of a claimed trace
    (reference: `FusionExecutor:132`): ``fusion_pass`` runs after claiming
    (executors/passes.py), in the order the executors are listed."""

    def fusion_pass(self, trace):
        raise NotImplementedError

    def register_temporary_operation(self, name: str, fn: Callable) -> Symbol:
        sym = Symbol(name, None, id=f"{self.name}.{name}", executor=self, python_impl=fn, module=self.name)
        self.implmap[sym.id] = ImplInfo(symbol=sym, fn=fn)
        return sym


# -- global registry ----------------------------------------------------------

_executor_map: dict[str, Executor] = {}
_default_executors: list[Executor] = []
_always_executors: list[Executor] = []


def register_executor(ex: Executor) -> Executor:
    _executor_map[ex.name] = ex
    return ex


def get_executor(name: str) -> Optional[Executor]:
    return _executor_map.get(name)


def get_all_executors() -> tuple[Executor, ...]:
    return tuple(_executor_map.values())


def get_default_executors() -> tuple[Executor, ...]:
    return tuple(_default_executors)


def get_always_executors() -> tuple[Executor, ...]:
    return tuple(_always_executors)


def add_default_executor(ex: Executor, *, front: bool = True) -> None:
    if ex in _default_executors:
        _default_executors.remove(ex)
    if front:
        _default_executors.insert(0, ex)
    else:
        _default_executors.append(ex)


def add_always_executor(ex: Executor) -> None:
    if ex not in _always_executors:
        _always_executors.append(ex)


def resolve_executors(executors: Optional[Sequence[Executor | str]]) -> tuple[Executor, ...]:
    """Executors or their registered names, in priority order; None is the
    defaults."""
    if executors is None:
        return get_default_executors()
    out: list[Executor] = []
    for e in executors:
        if isinstance(e, Executor):
            out.append(e)
        else:
            ex = get_executor(e)
            check(ex is not None, lambda: f"Unknown executor {e!r}")
            out.append(ex)
    return tuple(out)


# -- lookasides ---------------------------------------------------------------

_lookasides: dict[Callable, Callable] = {}


def register_lookaside(fn: Callable, replacement: Callable) -> None:
    """Map an external callable to a traceable replacement
    (reference: extend/__init__.py `register_lookaside:391`)."""
    _lookasides[fn] = replacement


def get_lookaside(fn: Callable) -> Optional[Callable]:
    return _lookasides.get(fn)
