"""Which values still carry the batch as their leading dim.

The counterpart of ``thunder_tpu/frontend/batchdim.py``. When the module
frontend splits the data inputs over a data-parallel axis
(``frontend/module.py``), an output whose dim 0 is still the batch joins
by an all-gather of the ranks' blocks along dim 0; any other output that
depends on the split data (a reduction over the batch, a transposed
layout, a gather along the batch dim) cannot, and the compile falls back
to replicated data.

"Lead" means: dim 0 is a multiple of the local batch and the elements are
batch-major with equal contiguous blocks a batch element, the invariant
that makes a dim-0 join equal the full-batch computation. The walk is over
prims and conservative: a prim it does not know drops the property (the
replicated fall-back keeps the result right; only speed is at stake).
"""

from __future__ import annotations

from typing import Iterable

from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy


def iter_prim_level(bound_symbols) -> Iterable:
    """Flatten the multi-level IR to its prim-level bound symbols."""
    for b in bound_symbols:
        if b.sym.is_prim or not b.subsymbols:
            yield b
        else:
            yield from iter_prim_level(b.subsymbols)


_SAMESHAPE = {
    PrimIDs.CONVERT_ELEMENT_TYPE, PrimIDs.SHALLOW_COPY, PrimIDs.STOP_GRADIENT,
    PrimIDs.DEVICE_PUT, PrimIDs.COPY_, PrimIDs.WHERE,
    # elementwise unary
    PrimIDs.ABS, PrimIDs.ACOS, PrimIDs.ACOSH, PrimIDs.ASIN, PrimIDs.ASINH,
    PrimIDs.ATAN, PrimIDs.ATANH, PrimIDs.BITWISE_NOT, PrimIDs.CEIL, PrimIDs.COS,
    PrimIDs.COSH, PrimIDs.DIGAMMA, PrimIDs.ERF, PrimIDs.ERFC, PrimIDs.ERFINV,
    PrimIDs.EXP, PrimIDs.EXP2, PrimIDs.EXPM1, PrimIDs.FLOOR, PrimIDs.ISFINITE,
    PrimIDs.ISINF, PrimIDs.ISNAN, PrimIDs.LGAMMA, PrimIDs.LOG, PrimIDs.LOG10,
    PrimIDs.LOG1P, PrimIDs.LOG2, PrimIDs.NEG, PrimIDs.RECIPROCAL, PrimIDs.ROUND,
    PrimIDs.RSQRT, PrimIDs.SIGN, PrimIDs.SIGNBIT, PrimIDs.SIN, PrimIDs.SINH,
    PrimIDs.SQRT, PrimIDs.TAN, PrimIDs.TANH, PrimIDs.TRUNC, PrimIDs.REAL,
    PrimIDs.IMAG, PrimIDs.POLYGAMMA,
    # elementwise binary (strict same-shape at the prim level)
    PrimIDs.ADD, PrimIDs.ATAN2, PrimIDs.BITWISE_AND, PrimIDs.BITWISE_OR,
    PrimIDs.BITWISE_XOR, PrimIDs.BITWISE_LEFT_SHIFT, PrimIDs.BITWISE_RIGHT_SHIFT,
    PrimIDs.DIV, PrimIDs.EQ, PrimIDs.FMOD, PrimIDs.GE, PrimIDs.GT, PrimIDs.LE,
    PrimIDs.LT, PrimIDs.MAXIMUM, PrimIDs.MINIMUM, PrimIDs.MUL, PrimIDs.NE,
    PrimIDs.NEXTAFTER, PrimIDs.POW, PrimIDs.REMAINDER, PrimIDs.SUB,
    PrimIDs.COPYSIGN, PrimIDs.ZETA,
}

_REDUCTIONS = {PrimIDs.SUM, PrimIDs.AMAX, PrimIDs.AMIN, PrimIDs.PROD, PrimIDs.VAR, PrimIDs.VAR_MEAN}

_DIM_OPS = {PrimIDs.CUMSUM, PrimIDs.CUMPROD, PrimIDs.ARGSORT, PrimIDs.SORT}


def propagate_batch_lead(bound_symbols, seed_lead: set, local_batch: int) -> tuple[set, set]:
    """Returns (tainted, lead): names of proxies whose value depends on
    batch-sharded inputs, and the subset whose dim 0 is still batch-leading
    (safe to reassemble by dim-0 concat)."""
    tainted: set = set(seed_lead)
    lead: set = set(seed_lead)

    def is_lead(x) -> bool:
        return isinstance(x, TensorProxy) and x.name in lead

    def is_tainted(x) -> bool:
        return isinstance(x, TensorProxy) and x.name in tainted

    def tensor_args(b):
        return [a for a in b.flat_proxy_args if isinstance(a, TensorProxy)]

    for b in iter_prim_level(bound_symbols):
        t_args = tensor_args(b)
        any_taint = any(is_tainted(a) for a in t_args)
        if not any_taint:
            continue
        for o in b.flat_proxy_outs:
            tainted.add(o.name)

        sid = b.sym.id
        out = b.flat_proxy_outs
        tensor_outs = [o for o in out if isinstance(o, TensorProxy)]
        if not tensor_outs:
            continue

        def mark(ok: bool):
            if ok:
                for o in tensor_outs:
                    if o.ndim >= 1 and o.shape[0] % local_batch == 0 and o.shape[0] > 0:
                        lead.add(o.name)

        if sid in _SAMESHAPE:
            mark(all(is_lead(a) or not is_tainted(a) for a in t_args) and any(is_lead(a) for a in t_args))
        elif sid is PrimIDs.BROADCAST_IN_DIM:
            a, shape, bdims = b.args[0], b.args[1], b.args[2]
            mark(is_lead(a) and len(bdims) > 0 and tuple(bdims)[0] == 0 and shape[0] == a.shape[0])
        elif sid is PrimIDs.RESHAPE:
            a = b.args[0]
            mark(is_lead(a))  # out dim0 % local_batch checked in mark()
        elif sid is PrimIDs.TRANSPOSE:
            a, perm = b.args[0], b.args[1]
            mark(is_lead(a) and tuple(perm)[0] == 0)
        elif sid is PrimIDs.SLICE:
            a, starts, ends = b.args[0], b.args[1], b.args[2]
            strides = b.args[3] if len(b.args) > 3 and b.args[3] is not None else [1] * a.ndim
            full0 = starts[0] == 0 and ends[0] == a.shape[0] and strides[0] == 1
            mark(is_lead(a) and full0)
        elif sid is PrimIDs.SQUEEZE:
            a, dims = b.args[0], b.args[1]
            mark(is_lead(a) and 0 not in tuple(dims))
        elif sid is PrimIDs.PAD:
            a, _, cfg = b.args[0], b.args[1], b.args[2]
            mark(is_lead(a) and tuple(cfg[0]) == (0, 0, 0))
        elif sid is PrimIDs.CAT:
            tensors, dim = b.args[0], b.args[1]
            mark(dim != 0 and all(is_lead(t) or not is_tainted(t) for t in tensors)
                 and any(is_lead(t) for t in tensors))
        elif sid is PrimIDs.FLIP:
            a, dims = b.args[0], b.args[1]
            mark(is_lead(a) and 0 not in tuple(dims))
        elif sid is PrimIDs.TAKE:
            a, idx, dim = b.args[0], b.args[1], b.args[2]
            mark(dim != 0 and is_lead(a) and not is_tainted(idx))
        elif sid in (PrimIDs.TAKE_ALONG_AXIS, PrimIDs.GATHER):
            a, idx, dim = b.args[0], b.args[1], b.args[2]
            ok = (
                dim not in (0, -a.ndim)
                and idx.shape[0] == a.shape[0]
                and (is_lead(a) or not is_tainted(a))
                and (is_lead(idx) or not is_tainted(idx))
            )
            mark(ok)
        elif sid is PrimIDs.SCATTER_ADD:
            a, idx, val, dim = b.args[0], b.args[1], b.args[2], b.args[3]
            ok = (
                dim not in (0, -a.ndim)
                and idx.shape[0] == a.shape[0] and val.shape[0] == a.shape[0]
                and all(is_lead(x) or not is_tainted(x) for x in (a, idx, val))
            )
            mark(ok)
        elif sid in _REDUCTIONS:
            a, dims = b.args[0], b.args[1]
            dims_c = tuple(d % a.ndim for d in tuple(dims))
            mark(is_lead(a) and 0 not in dims_c and len(dims_c) < a.ndim)
        elif sid in (PrimIDs.ARGMAX, PrimIDs.ARGMIN):
            a, dim = b.args[0], b.args[1]
            mark(is_lead(a) and dim is not None and dim % a.ndim != 0)
        elif sid in _DIM_OPS:
            a, dim = b.args[0], b.args[1]
            mark(is_lead(a) and dim % a.ndim != 0)
        elif sid is PrimIDs.TOPK:
            a, dim = b.args[0], b.args[2]
            mark(is_lead(a) and dim % a.ndim != 0)
        elif sid is PrimIDs.MATMUL:
            a, bb = b.args[0], b.args[1]
            if bb.ndim <= 2:
                # (…, m, k) @ (k, n): rows follow a's leading dims.
                mark(a.ndim >= 2 and is_lead(a) and not is_tainted(bb))
            else:
                # Batched matmul: valid when BOTH operands are batch-lead
                # (e.g. q @ k^T in attention — batch dims stay aligned).
                mark(a.ndim >= 3 and is_lead(a) and is_lead(bb))
        elif sid is PrimIDs.LINEAR:
            a, w = b.args[0], b.args[1]
            bias = b.args[2] if len(b.args) > 2 else None
            mark(is_lead(a) and not is_tainted(w) and (bias is None or not is_tainted(bias)))
        elif sid is PrimIDs.CONVOLUTION:
            a, w = b.args[0], b.args[1]
            bias = b.args[2]
            mark(is_lead(a) and not is_tainted(w) and (bias is None or not is_tainted(bias)))
        elif sid is PrimIDs.EMBEDDING:
            idx, w = b.args[0], b.args[1]
            mark(is_lead(idx) and not is_tainted(w))
        elif sid is PrimIDs.POOL:
            a = b.args[0]
            window = b.args[2]
            mark(is_lead(a) and a.ndim > len(window))
        # default: lead is killed (tainted already propagated)

    return tainted, lead
