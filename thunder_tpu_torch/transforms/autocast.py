"""Autocast: mixed-precision trace transform.

Reference parity: thunder/core/transforms.py autocast rules + transform
(`:3998-4046`) — matmul-class ops run in the low-precision dtype; everything
else keeps its dtype (norms/softmax already compute in f32 inside their
ltorch decompositions). The counterpart of
``thunder_tpu/transforms/autocast.py``, unchanged.

On the card, bf16 products run on the tensor cores (989 TFLOP/s against 67
for f32 outside them), and attention cast to bf16 can be claimed by the
flash executor, which takes half precision only. No GradScaler is needed
(bf16 has f32's exponent range).
"""

from __future__ import annotations

import time
from typing import Optional

import thunder_tpu_torch.clang as clang
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx, wrap_in_trace_provenance

# Ops whose *inputs* are downcast (reference: autocast_impls keyed on
# matmul/linear/convolution). Listed at both the composite (ltorch) and prim
# level so the transform works before or after flattening.
_AUTOCAST_IDS = {
    PrimIDs.MATMUL,
    PrimIDs.LINEAR,
    PrimIDs.CONVOLUTION,
    "torch.matmul",
    "torch.bmm",
    "torch.linear",
    "torch.conv1d",
    "torch.conv2d",
    "torch.conv3d",
    "torch.scaled_dot_product_attention",
}


def autocast(trace: TraceCtx, dtype=dtypes.bfloat16) -> TraceCtx:
    """Downcast matmul-class op inputs to ``dtype`` (default bf16)."""
    start = time.perf_counter_ns()
    dtype = dtypes.to_dtype(dtype)
    ntrace = from_trace(trace)
    swap: dict = {}

    def cast(x):
        if isinstance(x, TensorProxy) and dtypes.is_float_dtype(x.dtype) and x.dtype != dtype:
            return clang.maybe_convert_to_dtype(x, dtype)
        return x

    with tracectx(ntrace):
        for bsym in trace.bound_symbols:
            b = bsym.from_bsym_swap_proxies(swap)
            if b.sym.id in _AUTOCAST_IDS:
                flat_args, spec = tree_flatten((b.args, b.kwargs))
                new_flat = [cast(a) for a in flat_args]
                new_args, new_kwargs = tree_unflatten(spec, new_flat)
                out = b.sym(*new_args, **new_kwargs)
                old_outs = b.flat_proxy_outs
                new_outs, _ = tree_flatten(out)
                for o, n in zip(old_outs, [x for x in new_outs if isinstance(x, TensorProxy)]):
                    # Cast the low-precision result back to the op's original
                    # output dtype: consumers were recorded against that
                    # metadata, and swapping a bf16 proxy into them would make
                    # every downstream bsym's recorded dtype a lie. The matmul
                    # itself still runs in ``dtype``; the widening convert is
                    # one more elementwise kernel.
                    if isinstance(o, TensorProxy) and n.dtype != o.dtype:
                        n = clang.maybe_convert_to_dtype(n, o.dtype)
                    swap[variableify(o)] = n
            else:
                ntrace.bound_symbols.append(b)

    flat_out, spec = tree_flatten(ntrace.output)
    ntrace.output = tree_unflatten(
        spec, [swap.get(variableify(p), p) if isinstance(p, TensorProxy) else p for p in flat_out]
    )
    return wrap_in_trace_provenance(ntrace, f"Autocast to {dtype}", start)
