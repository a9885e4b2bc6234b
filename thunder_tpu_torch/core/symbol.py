"""Symbols and bound symbols: the instructions of the trace IR.

Reference parity: thunder/core/symbol.py (`Symbol:127`, `Symbol.__call__:226`,
`BoundSymbol:280`, `from_bsym_swap_proxies:345`, `rhs:506`,
`BoundSymbolRHS:631`).

A ``Symbol`` is a traceable operation: calling it while a trace is active
records a ``BoundSymbol``. Non-primitive symbols record their decomposition as
nested ``subsymbols`` — the multi-level IR that lets executors claim ops at
any level (the flash executor claims ``torch.scaled_dot_product_attention``
whole; the torch executor claims the prims it decomposes into).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Optional, Sequence

from thunder_tpu_torch.core import baseutils, codeutils
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten


# Display-module registry: maps a symbol's short module label (e.g. "prims",
# "ltorch") to the module object bound into generated-code namespaces.
MODULE_REGISTRY: dict[str, Any] = {}


def register_module(label: str, module: Any) -> None:
    MODULE_REGISTRY[label] = module


def resolve_inplace(x: Any) -> Any:
    """Follow a proxy's in-place forwarding chain to its latest functional
    value. In-place torch ops (``x.add_(y)``) functionalize by computing the
    out-of-place result and pointing the stale proxy at it; every later
    consumer resolves through this (reference analogue: thunder's implicit
    functionalization — generated traces are SSA)."""
    nxt = getattr(x, "_inplace_forward", None)
    while nxt is not None:
        x = nxt
        nxt = getattr(x, "_inplace_forward", None)
    return x


def resolve_inplace_tree(tree: Any) -> Any:
    flat, spec = tree_flatten(tree)
    return tree_unflatten(spec, [resolve_inplace(x) for x in flat])


def _detach_tree(result):
    """stop_gradient over every tensor proxy in an op result (no_grad)."""
    from thunder_tpu_torch.core import prims
    from thunder_tpu_torch.core.baseutils import ProxyInterface

    def detach(x):
        if isinstance(x, ProxyInterface) and hasattr(x, "dtype") and hasattr(x, "shape"):
            return prims.stop_gradient(x)
        return x

    flat, spec = tree_flatten(result)
    return tree_unflatten(spec, [detach(x) for x in flat])


_is_concrete_tensor = None  # bound lazily: importing bridge at module load cycles


def _lift_captured_tensors(args: tuple, kwargs: dict):
    """Replace concrete arrays (numpy/torch) in a traced op's operands
    with baked tensor-constant proxies (prims.tensor_constant). Shallow +
    one list/tuple level; single pass, no-op (no allocation) when nothing
    concrete is present — this sits on the tracing hot path."""
    global _is_concrete_tensor

    ict = _is_concrete_tensor
    if ict is None:
        from thunder_tpu_torch.executors.bridge import is_concrete_tensor as ict

        _is_concrete_tensor = ict

    def lift(x):
        if ict(x):
            from thunder_tpu_torch.core import prims

            return prims.tensor_constant(x)
        if isinstance(x, (list, tuple)) and any(ict(v) for v in x):
            from thunder_tpu_torch.core import prims

            return type(x)(
                prims.tensor_constant(v) if ict(v) else v for v in x
            )
        return x

    new_args = None
    for i, a in enumerate(args):
        if ict(a) or (isinstance(a, (list, tuple)) and any(ict(v) for v in a)):
            if new_args is None:
                new_args = list(args)
            new_args[i] = lift(a)
    new_kwargs = None
    for k, v in kwargs.items():
        if ict(v) or (isinstance(v, (list, tuple)) and any(ict(u) for u in v)):
            if new_kwargs is None:
                new_kwargs = dict(kwargs)
            new_kwargs[k] = lift(v)
    if new_args is None and new_kwargs is None:
        return args, kwargs
    return (tuple(new_args) if new_args is not None else args,
            new_kwargs if new_kwargs is not None else kwargs)


class Symbol:
    def __init__(
        self,
        name: str,
        meta: Optional[Callable] = None,
        *,
        id: Optional[Any] = None,
        is_prim: bool = False,
        is_fusion: bool = False,
        tags: Optional[Sequence[Any]] = None,
        executor: Optional[Any] = None,
        python_impl: Optional[Callable] = None,
        python_printer: Optional[Callable] = None,
        module: Optional[str] = None,
        _bind_postprocess: Optional[Callable] = None,
    ):
        self.name = name
        self.meta = meta
        self.id = id if id is not None else name
        self.is_prim = is_prim
        self.is_fusion = is_fusion
        self.tags = tuple(tags) if tags else ()
        self.executor = executor
        self.python_impl = python_impl
        self.python_printer = python_printer
        self.module = module  # dotted module path for display, e.g. "prims", "ttorch"
        self._bind_postprocess = _bind_postprocess

    def __repr__(self) -> str:
        return f"[Symbol {self.qualname}]"

    @property
    def qualname(self) -> str:
        return f"{self.module}.{self.name}" if self.module else self.name

    def __call__(self, *args, **kwargs):
        from thunder_tpu_torch.core.trace import get_tracectx

        trace = get_tracectx()
        if trace is None:
            # Eager escape hatch: outside tracing, run the concrete impl.
            if self.python_impl is not None:
                return self.python_impl(*args, **kwargs)
            if self.executor is not None:
                impl = self.executor.get_impl(self.id)
                if impl is not None:
                    return impl(*args, **kwargs)
            raise RuntimeError(
                f"Symbol {self.qualname} called outside a trace and has no concrete implementation"
            )

        check(self.meta is not None, lambda: f"Symbol {self.qualname} has no meta function")

        # Cheap flag check: only traces that saw an in-place op pay for the
        # per-call proxy remap (tracing latency is a product metric).
        if getattr(trace, "_inplace_seen", False):
            args, kwargs = resolve_inplace_tree((args, kwargs))

        # Concrete arrays reaching an op during tracing are CAPTURED
        # constants (closures, globals, defaults — the VM's provenance
        # cases, reference interpreter.py): lift them into the trace as
        # baked tensor constants. Shallow + one container level covers the
        # real call shapes (cat/stack lists); deeper nesting reaches a meta
        # and fails loudly there.
        args, kwargs = _lift_captured_tensors(args, kwargs)

        if self.is_prim:
            result = self.meta(*args, **kwargs)
            subsymbols = ()
        else:
            subsymbols = []
            trace.push_scope(subsymbols)
            try:
                result = self.meta(*args, **kwargs)
            finally:
                trace.pop_scope()

        bsym = self.bind(*args, output=result, subsymbols=tuple(subsymbols), **kwargs)
        trace.add_bound_symbol(bsym)

        # torch.no_grad during acquisition (frontend/sharp.py toggles the
        # flag): detach this op's tensor outputs so nothing computed under
        # the block contributes gradients — applied at the TOP scope only
        # (composites wrap once, their subsymbols don't).
        from thunder_tpu_torch.core.trace import _grad_mode_ctx

        if (
            not _grad_mode_ctx.get()
            and self.name != "stop_gradient"
            and len(trace._scopes) == 1
        ):
            result = _detach_tree(result)
        return result

    def bind(self, *args, output: Any, subsymbols: tuple = (), **kwargs) -> "BoundSymbol":
        bsym = BoundSymbol(self, args=args, kwargs=kwargs, output=output, subsymbols=subsymbols)
        if self._bind_postprocess is not None:
            self._bind_postprocess(bsym)
        return bsym


@dataclass(frozen=True)
class BoundSymbolRHS:
    """Hashable (symbol, args-with-variables) key for CSE (reference: symbol.py:631)."""

    sym_id: Hashable
    args: tuple
    kwargs: tuple

    def __hash__(self) -> int:
        try:
            return hash((self.sym_id, self.args, self.kwargs))
        except TypeError:
            return hash(self.sym_id)


class BoundSymbol(baseutils.BoundSymbolInterface):
    def __init__(
        self,
        sym: Symbol,
        args: tuple,
        kwargs: dict,
        output: Any,
        subsymbols: tuple = (),
    ):
        self.sym = sym
        self.args = tuple(args)
        self.kwargs = dict(kwargs)
        self.output = output
        self.subsymbols = tuple(subsymbols)
        # Objects the generated line needs bound into the exec namespace,
        # e.g. a baked tensor constant (reference: _call_ctx).
        self._call_ctx: dict[str, Any] = {}
        self.header: str = ""

    # -- tags ----------------------------------------------------------------

    def has_tag(self, tag: Any) -> bool:
        return tag in self.sym.tags

    # -- flattening ----------------------------------------------------------

    @property
    def flat_args(self) -> list:
        flat, _ = tree_flatten((self.args, self.kwargs))
        return flat

    @property
    def flat_proxy_args(self) -> list:
        return [a for a in self.flat_args if isinstance(a, Proxy)]

    @property
    def flat_outs(self) -> list:
        flat, _ = tree_flatten(self.output)
        return flat

    @property
    def flat_proxy_outs(self) -> list:
        return [o for o in self.flat_outs if isinstance(o, Proxy)]

    def _var_set(self, proxies) -> set:
        return {variableify(p) for p in proxies}

    # -- identity / CSE ------------------------------------------------------

    @property
    def rhs(self) -> BoundSymbolRHS:
        def keyify(x):
            if isinstance(x, Proxy):
                return Variable(x)
            return baseutils.make_hashable(x) if baseutils.is_collection(x) else x

        # The tree structure must be part of the key: None is an EMPTY
        # subtree to pytrees, so flattening alone maps e.g. the index
        # keys (None, None, :, None) and (None, None, None, :) to the same
        # leaves — and CSE would silently merge different ops.
        flat_args, spec_a = tree_flatten(self.args)
        flat_kwargs, spec_k = tree_flatten(tuple(sorted(self.kwargs.items())))
        return BoundSymbolRHS(
            self.sym.id,
            (str(spec_a),) + tuple(keyify(a) for a in flat_args),
            (str(spec_k),) + tuple(keyify(a) for a in flat_kwargs),
        )

    # -- rewriting -----------------------------------------------------------

    def from_bsym(self, *, sym=None, args=None, kwargs=None, output=None, subsymbols=None) -> "BoundSymbol":
        new = BoundSymbol(
            sym if sym is not None else self.sym,
            args=args if args is not None else self.args,
            kwargs=kwargs if kwargs is not None else self.kwargs,
            output=output if output is not None else self.output,
            subsymbols=subsymbols if subsymbols is not None else self.subsymbols,
        )
        new._call_ctx = dict(self._call_ctx)
        new.header = self.header
        return new

    def from_bsym_swap_proxies(self, swap_map: dict, skip_output: bool = False) -> "BoundSymbol":
        """Replace proxies by name per ``swap_map`` (Variable → proxy).

        Reference parity: symbol.py `from_bsym_swap_proxies:345` — load-bearing
        for the fw/bw split and remat passes.
        """
        if not swap_map:
            return self

        def swap(x):
            if isinstance(x, Proxy):
                return swap_map.get(variableify(x), x)
            return x

        def swap_tree(tree):
            flat, spec = tree_flatten(tree)
            return tree_unflatten(spec, [swap(x) for x in flat])

        new_args = swap_tree(self.args)
        new_kwargs = swap_tree(self.kwargs)
        new_output = self.output if skip_output else swap_tree(self.output)
        new_subsymbols = tuple(
            sub.from_bsym_swap_proxies(swap_map, skip_output=skip_output) for sub in self.subsymbols
        )
        return self.from_bsym(args=new_args, kwargs=new_kwargs, output=new_output, subsymbols=new_subsymbols)

    # -- codegen -------------------------------------------------------------

    def gen_call_target(self) -> tuple[str, Any]:
        """(name, callable) to bind in the exec namespace for this line.

        Claimed symbols print as ``<executor>_<name>`` bound to the executor
        impl; unclaimed symbols print qualified by their module
        (``prims.add``), with the module object bound in the namespace —
        matching the reference's generated-code style.
        """
        if self.sym.executor is not None:
            impl = self.sym.executor.get_impl(self.sym.id)
            if impl is not None:
                return f"{self.sym.executor.name}_{self.sym.name}", impl
        if self.sym.module is not None:
            mod = MODULE_REGISTRY.get(self.sym.module)
            if mod is not None:
                return f"{self.sym.module}.{self.sym.name}", (self.sym.module, mod)
        if self.sym.python_impl is not None:
            return self.sym.name, self.sym.python_impl
        return self.sym.name, self.sym

    def python(self, indent: int = 0, print_depth: int = 1) -> list[str]:
        lines = []
        pad = baseutils.indent(indent)
        if self.header:
            for hline in self.header.splitlines():
                lines.append(f"{pad}# {hline}")

        if self.sym.python_printer is not None:
            printed = self.sym.python_printer(self)
            for pline in printed if isinstance(printed, (list, tuple)) else [printed]:
                lines.append(f"{pad}{pline}")
            return lines

        ctx_name, _ = self.gen_call_target()
        arg_strs = [codeutils.prettyprint(a) for a in self.args]
        kwarg_strs = [f"{k}={codeutils.prettyprint(v)}" for k, v in self.kwargs.items()]
        call = f"{ctx_name}({', '.join(arg_strs + kwarg_strs)})"

        outs = self.flat_proxy_outs
        if self.output is None or not outs:
            line = f"{pad}{call}"
        else:
            out_str = codeutils.prettyprint(self.output)
            line = f"{pad}{out_str} = {call}"
        lines.append(line)

        if print_depth > 1 or (print_depth == -1):
            next_depth = -1 if print_depth == -1 else print_depth - 1
            for sub in self.subsymbols:
                for sline in sub.python(indent + 1, next_depth):
                    lines.append("# " + sline if False else sline)
        return lines

    def one_line(self) -> str:
        """The generated line(s) of this bound symbol collapsed to one
        string — the canonical "offending trace line" rendering shared by
        verifier diagnostics (analysis/diagnostics.py) and instrumentation
        attribution (observability/instrument.py)."""
        return "; ".join(s.strip() for s in self.python(indent=0))

    def __repr__(self) -> str:
        return "\n".join(self.python(0, print_depth=1))
