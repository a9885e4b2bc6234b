"""Shared torch→ltorch dispatch used by both TensorProxy.__torch_function__
and the tracing TorchFunctionMode.

The counterpart of ``thunder_tpu/frontend/dispatch.py``. Two hooks are needed
because torch's dispatcher engages them at different points: a type defining
``__torch_function__`` makes the C++ argument parsers accept proxies in
Tensor positions (``F.linear(proxy, w)``), while the mode intercepts calls
with *no* tensor-like argument at all (``torch.ones(...)`` factories inside a
traced forward).
"""

from __future__ import annotations

import torch


# torch's loss functions hand their deprecated reduction arguments on to
# __torch_function__ as keywords, set to None unless the caller set them; the
# ltorch mirror has only ``reduction``. (The JAX package's dispatch passes
# them on, so ``F.cross_entropy`` inside a traced module raises TypeError
# there.)
_LEGACY_REDUCTION = ("size_average", "reduce")


def _modern_kwargs(func, kwargs: dict) -> dict:
    if not any(k in kwargs for k in _LEGACY_REDUCTION):
        return kwargs
    if any(kwargs.get(k) is not None for k in _LEGACY_REDUCTION):
        raise NotImplementedError(f"{getattr(func, '__name__', func)}: the deprecated size_average/reduce "
                                  "arguments are not supported; pass reduction=")
    return {k: v for k, v in kwargs.items() if k not in _LEGACY_REDUCTION}


def torch_dispatch(func, types, args=(), kwargs=None):
    from thunder_tpu_torch.core.langctxs import Languages, resolve_language
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.torch import torch_function_map

    kwargs = kwargs or {}
    flat, _ = tree_flatten((args, kwargs))
    has_proxy = any(isinstance(a, TensorProxy) for a in flat)

    if not has_proxy and any(isinstance(a, torch.Tensor) for a in flat):
        # An op over concrete tensors only (e.g. mask bookkeeping on a real
        # aux tensor inside a traced forward): run it for real — mapping it
        # to ltorch would hand a torch.Tensor to proxy-only meta functions.
        return func(*args, **kwargs)

    target = torch_function_map().get(func)
    if target is not None:
        return target(*args, **_modern_kwargs(func, kwargs))

    if not has_proxy:
        # Pure-torch call over concrete values (dtype queries, flag checks):
        # run it for real.
        return func(*args, **kwargs)

    name = getattr(func, "__name__", None)
    ctx = resolve_language(Languages.TORCH)
    if name and ctx.has_method(name):
        return ctx.get_method(name)(*args, **kwargs)
    raise NotImplementedError(
        f"torch function {func} is not mapped to the ltorch language "
        f"(reference analogue: a thunder 'sharp edge')"
    )
