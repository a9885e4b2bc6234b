"""RNG functionalization: make randomness an explicit trace input.

The counterpart of ``thunder_tpu/transforms/rng.py``: a trace that holds a
random prim is rewritten so that a key tensor (two uint32 words, held as a
(2,) int64 tensor) becomes its last input, and each random op draws from
``fold_in(key, salt)`` with its own salt, the op's index in the trace. The
program stays a pure function of its inputs; the caller passes a fresh key
each call (``api._next_key``), so a CUDA-graph replay draws afresh, and a
recompute of a draw gives the same bits.

Unlike the JAX package's pass, which looks at top-level bound symbols only,
this one keys a random prim at any depth: a composite that holds one
(``ltorch.dropout`` records its ``uniform`` inside) is replaced by its
subsymbols, down to the random prim. The JAX package leaves such a nested
draw unkeyed, and its eager ``uniform`` then takes one key while ``jax.jit``
traces, so its dropout draws the same mask on every call (ROADMAP C).
"""

from __future__ import annotations

import time

from thunder_tpu_torch.core import devices, dtypes, prims
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx, wrap_in_trace_provenance
from thunder_tpu_torch.transforms.common import has_random_op

RNG_TAG = "rng_functionalized"


def _flatten_random(bsyms):
    """The bound symbols, each composite that holds a random prim replaced
    by its subsymbols, recursively."""
    for b in bsyms:
        if OpTags.RANDOM_OP in b.sym.tags or not has_random_op(b):
            yield b
        else:
            yield from _flatten_random(b.subsymbols)


def functionalize_rng_ops(trace: TraceCtx) -> TraceCtx:
    if not any(has_random_op(b) for b in trace.bound_symbols):
        return trace

    start = time.perf_counter_ns()
    ntrace = from_trace(trace)
    key = TensorProxy(name=ntrace.make_name("rng_key"), shape=(2,), dtype=dtypes.int64, device=devices.Device())
    swap_map = {}
    salt = 0

    with tracectx(ntrace):
        for bsym in _flatten_random(trace.bound_symbols):
            bsym = bsym.from_bsym_swap_proxies(swap_map, skip_output=True)
            if OpTags.RANDOM_OP not in bsym.sym.tags:
                ntrace.bound_symbols.append(bsym)
                continue
            if bsym.sym.id == PrimIDs.UNIFORM:
                shape, minval, maxval = bsym.args
                new_out = prims.uniform_keyed(shape, minval, maxval, key, salt, **bsym.kwargs)
            elif bsym.sym.id == PrimIDs.RANDN:
                (shape,) = bsym.args
                new_out = prims.randn_keyed(shape, key, salt, **bsym.kwargs)
            else:
                raise NotImplementedError(f"RNG prim {bsym.sym.qualname} not functionalized")
            salt += 1
            swap_map[variableify(bsym.output)] = new_out

    ntrace.args = tuple(trace.args) + (key,)
    flat_out, spec = tree_flatten(ntrace.output)
    ntrace.output = tree_unflatten(spec, [swap_map.get(variableify(p), p) if hasattr(p, "name") else p for p in flat_out])
    ntrace.tags[RNG_TAG] = True
    return wrap_in_trace_provenance(ntrace, "Functionalize RNG", start)
