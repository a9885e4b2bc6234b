"""Trace-time concretization of input-derived scalars, with value guards.

Reference parity: the reference's bytecode interpreter executes Python
branches on real tensor values natively (thunder/core/jit_ext.py — the VM
runs `if mask.all():` with a real torch tensor, and the resulting constraint
lands in the prologue via `unpack_inputs:1098`). This frontend's dispatch
interception has no VM, so the same capability is met with *guarded
concretization*: when traced Python coerces a TensorProxy to a Python scalar
(``bool()``/``int()``/``float()``), the proxy's producing subgraph is staged
and executed eagerly on the trace's concrete example inputs, the resulting
value is baked into the trace, and a VALUE GUARD — that same staged
subgraph plus an equality check — is attached to the cache entry. A later
call where the subgraph evaluates differently is a controlled cache miss
(retrace), never a silent reuse of a wrong specialization.

This is what lets unmodified HF models that branch on mask contents
(``transformers.masking_utils`` calls ``padding_mask.all()``) trace and
cache correctly.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def _item(raw):
    """A staged scalar program's result (a 0-d tensor or a number) as a
    Python scalar."""
    return raw.item() if hasattr(raw, "item") else raw


class ValueGuard:
    """A staged scalar subprogram + the value it must reproduce."""

    __slots__ = ("fn", "kind", "expected", "description")

    def __init__(self, fn, kind: str, expected, description: str = ""):
        self.fn = fn
        self.kind = kind
        self.expected = expected
        self.description = description

    def holds(self, tensor_inputs):
        """Whether the subprogram reproduces the value on ``tensor_inputs``:
        a bool, or a 0-d bool tensor where the value lies, not yet read."""
        raw = self.fn(*tensor_inputs)
        if raw is None:
            raise RuntimeError(f"value guard produced no value: {self.description}")
        if self.kind == "bool":
            raw = raw != 0 if isinstance(raw, torch.Tensor) else bool(raw)
        return raw == self.expected

    def __repr__(self) -> str:
        return f"<ValueGuard {self.kind} == {self.expected!r} ({self.description})>"


def concretize_scalar(proxy, kind: str) -> Optional[Any]:
    """Evaluate ``proxy`` on the active trace's concrete example inputs.

    Returns the Python scalar and records a ValueGuard on the trace, or
    returns None when the active trace has no concrete inputs (detached
    traces, meta-only tracing) — the caller then raises its usual
    data-dependent-control-flow error.
    """
    from thunder_tpu_torch.core import prims
    from thunder_tpu_torch.core.trace import TraceCtx, get_tracectx, tracectx

    trc = get_tracectx()
    if trc is None:
        return None
    leaves = getattr(trc, "_concrete_leaves", None)
    if leaves is None:
        return None

    from thunder_tpu_torch.common import suppress_sharp_edges

    with suppress_sharp_edges():
        return _concretize_scalar(proxy, kind, trc, leaves)


def _concretize_scalar(proxy, kind: str, trc, leaves):
    from thunder_tpu_torch.core import prims
    from thunder_tpu_torch.core.trace import TraceCtx, tracectx
    from thunder_tpu_torch.transforms.common import dce

    sub = TraceCtx()
    sub.name = "value_guard"
    sub.args = trc.args
    sub._names = set(trc._names)
    # extend in place — the trace's scope stack aliases this exact list
    sub.bound_symbols.extend(trc.bound_symbols)
    with tracectx(sub):
        prims.python_return(proxy)
    sub.output = proxy
    sub = dce(sub)

    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors

    # torch lowers the compute; python lowers python_return (without it the
    # staged callable silently returns None).
    ex = transform_for_execution(sub, resolve_executors(["torch", "python"]))
    fn = ex.python_callable()

    from thunder_tpu_torch.core import devices
    from thunder_tpu_torch.executors import bridge

    dev = devices.Device().torch_device()
    vals = [bridge.to_torch(c, dev) if bridge.is_concrete_tensor(c) else c for c in leaves]

    from thunder_tpu_torch.frontend.module import suspended_tracing_patches

    with suspended_tracing_patches():
        raw = fn(*vals)
        if raw is None:
            raise RuntimeError(f"concretization of {proxy.name} produced no value")
        value = {"bool": bool, "int": int, "float": float}[kind](_item(raw))

    guards = getattr(trc, "_value_guards", None)
    if guards is None:
        guards = trc._value_guards = []
    guards.append(ValueGuard(fn, kind, value, f"{kind}({proxy.name})"))
    return value


def value_guards_of(trc) -> tuple:
    return tuple(getattr(trc, "_value_guards", ()) or ())


def first_holding(guard_sets, tensor_inputs) -> Optional[int]:
    """The index of the first of ``guard_sets`` whose guards all hold on
    ``tensor_inputs``, or None. Each guard is compared where its value lies,
    and every comparison is read on the host together: one read a call
    (counted in ``check_value_guards.host_reads``), however many sets are
    tried."""
    sets = []  # per set: the comparisons still to read, or None when it fails
    for guards in guard_sets:
        pending = []
        for g in guards:
            try:
                ok = g.holds(tensor_inputs)
            except Exception:
                pending = None
                break
            if isinstance(ok, torch.Tensor):
                pending.append(ok.reshape(()))
            elif not ok:
                pending = None
                break
        sets.append(pending)
        if pending == []:
            break  # holds with nothing to read: no later set is needed
    flat = [t for pending in sets if pending for t in pending]
    if flat:
        check_value_guards.host_reads += 1
        flags = iter(torch.stack([t.to(flat[0].device) for t in flat]).tolist())
        sets = [None if pending is None else [next(flags) for _ in pending] for pending in sets]
    return next((i for i, got in enumerate(sets) if got is not None and all(got)), None)


def check_value_guards(guards, tensor_inputs) -> bool:
    """Whether every guard holds on ``tensor_inputs``, read as
    :func:`first_holding` reads them."""
    return first_holding([guards], tensor_inputs) == 0


check_value_guards.host_reads = 0
