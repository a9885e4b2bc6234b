"""The executor framework: pluggable backends claiming trace symbols.

Reference parity: thunder/extend/__init__.py (`Executor:47`,
`OperatorExecutor:190`, `ImplInfo:32`, `register_executor:275`, the always
registry `:268-388`). The default list lives in ``api.DEFAULT_EXECUTORS``.

Executors are priority-ordered: the claiming pass
(thunder_tpu_torch/executors/passes.py) hands each bound symbol to the first
executor whose checker accepts it, descending into subsymbols when no
executor claims a composite op. The terminal executor is the torch operator
executor (executors/torchex.py); the kernel executors (executors/flashex.py,
executors/fusedex.py) come before it and claim composite ops whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol


@dataclass
class ImplInfo:
    """Reference parity: thunder/extend/__init__.py `ImplInfo:32`."""

    fn: Optional[Callable] = None  # concrete implementation
    checker: Optional[Callable] = None  # (*args, **kwargs) -> bool
    # (*args, **kwargs) -> bool: the implementation reads a device value on
    # the host when it runs, which a CUDA graph cannot hold
    # (executors/staging.py leaves such a program unstaged).
    reads_host: Optional[Callable] = None


class OperatorExecutor:
    """Reference parity: thunder/extend/__init__.py `OperatorExecutor:190`."""

    def __init__(self, name: str):
        self.name = name
        self.implmap: dict[Any, ImplInfo] = {}

    def __repr__(self) -> str:
        return f"OperatorExecutor({self.name!r})"

    def can_execute(self, bsym: BoundSymbol) -> bool:
        info = self.implmap.get(bsym.sym.id)
        if info is None:
            return False
        if info.checker is not None:
            try:
                return bool(info.checker(*bsym.args, **bsym.kwargs))
            except Exception:
                return False
        return True

    def get_impl(self, sym_id: Any) -> Optional[Callable]:
        info = self.implmap.get(sym_id)
        return info.fn if info is not None else None

    def register_implementation(
        self, sym_or_id: Symbol | Any, *, fn: Callable, checker: Optional[Callable] = None,
        reads_host: Optional[Callable] = None,
    ) -> None:
        """Map an IR symbol to this executor (reference: `register_implementation:247`)."""
        sym_id = sym_or_id.id if isinstance(sym_or_id, Symbol) else sym_or_id
        self.implmap[sym_id] = ImplInfo(fn=fn, checker=checker, reads_host=reads_host)

    def reads_host(self, bsym: BoundSymbol) -> bool:
        """Whether this executor's implementation of ``bsym`` reads the host."""
        info = self.implmap.get(bsym.sym.id)
        return info is not None and info.reads_host is not None and bool(info.reads_host(*bsym.args, **bsym.kwargs))


# -- global registry ----------------------------------------------------------

_executor_map: dict[str, OperatorExecutor] = {}
_always_executors: list[OperatorExecutor] = []


def register_executor(ex: OperatorExecutor) -> OperatorExecutor:
    _executor_map[ex.name] = ex
    return ex


def get_executor(name: str) -> Optional[OperatorExecutor]:
    return _executor_map.get(name)


def get_always_executors() -> tuple[OperatorExecutor, ...]:
    return tuple(_always_executors)


def add_always_executor(ex: OperatorExecutor) -> None:
    if ex not in _always_executors:
        _always_executors.append(ex)


def resolve_executors(executors: Sequence[OperatorExecutor | str]) -> tuple[OperatorExecutor, ...]:
    """Executors or their registered names, in priority order."""
    out: list[OperatorExecutor] = []
    for e in executors:
        if isinstance(e, OperatorExecutor):
            out.append(e)
        else:
            ex = get_executor(e)
            check(ex is not None, lambda: f"Unknown executor {e!r}")
            out.append(ex)
    return tuple(out)
